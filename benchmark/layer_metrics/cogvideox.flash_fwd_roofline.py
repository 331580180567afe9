"""Kernel A (``csrc/flash_fwd.cu``) at CogVideoX's joint attention (2,
17776, 3072) with 48 heads 64 wide: its launches' least time (by shape,
heads = c / 64, ``counts/svd.py``) over the device time of its 64-wide
instance."""

from benchmark.counts import svd
from benchmark.readers import roofline


def read(t):
    return roofline(t, {"flash_fwd": svd.flash_fwd_d64}, ("flash_fwd_kernel<64>",))
