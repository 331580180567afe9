"""Kernel H (``csrc/composite_coarse.cu``), forward and backward: their
launches' least time (by shape, bytes only: ``counts/kernels.py``) over
their device time."""

from benchmark.counts import kernels
from benchmark.readers import roofline


def read(t):
    return roofline(t, {"composite_coarse_fwd": kernels.composite_coarse_fwd,
                        "composite_coarse_bwd": kernels.composite_coarse_bwd},
                    ("composite_coarse_fwd_kernel", "composite_coarse_bwd_kernel"))
