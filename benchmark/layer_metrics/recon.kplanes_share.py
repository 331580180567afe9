"""Share of the device's busy time in the K-planes sampler
(``gaussians/kplanes.py``): its forward's indexing kernels and its
backward's index-put accumulation, by kernel name."""

from benchmark.readers import share

NEEDLES = ("index_elementwise", "indexing_backward", "index_put")


def read(t):
    return share(t, NEEDLES)
