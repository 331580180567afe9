"""Kernel A (``csrc/flash_fwd.cu``): its launches' least time (by shape,
``counts/kernels.py::flash_fwd``) over its device time."""

from benchmark.counts import kernels
from benchmark.readers import roofline


def read(t):
    heads = int(t.counts.get("heads", 0))
    if not heads:
        return None
    return roofline(t, {"flash_fwd": lambda key: kernels.flash_fwd(key, heads)},
                    ("flash_fwd_kernel",))
