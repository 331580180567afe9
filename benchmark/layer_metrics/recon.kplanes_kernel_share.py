"""Share of the device's busy time in kernel I, the port's K-planes
sampler (``animate3d_tpu_torch/csrc/kplanes.cu``: its pack, forward,
backward and unpack kernels), by kernel name; None where no such kernel
ran in the window."""

from benchmark.readers import share

NEEDLES = ("kplanes_",)


def read(t):
    return share(t, NEEDLES)
