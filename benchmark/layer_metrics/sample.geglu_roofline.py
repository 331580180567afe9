"""Kernel C (``csrc/geglu.cu``): its launches' least time (by shape,
``counts/kernels.py::geglu``) over its device time."""

from benchmark.counts import kernels
from benchmark.readers import roofline


def read(t):
    return roofline(t, {"geglu": kernels.geglu}, ("geglu_gemm_kernel",))
