"""Kernel B (``csrc/packed_attn.cu``) on the 25-frame temporal attention,
its sequences padded to 32: the launches' least time by bytes
(``counts/svd.py``) over the device time of its padded instance."""

from benchmark.counts import svd
from benchmark.readers import roofline


def read(t):
    padded = {k: n for k, n in t.launches.items() if k[0] == "packed_attn" and k[1][1] == 25}
    if not padded:
        return None
    view = type(t)(**{**t.__dict__, "launches": padded})
    return roofline(view, {"packed_attn": svd.packed_padded},
                    ("packed_attn_kernel<32, 64, 2, 3, true>",))
