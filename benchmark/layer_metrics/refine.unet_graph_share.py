"""Share of the window's guidance UNet forwards that replayed from a CUDA
graph, in %: ``sample.unet_graph_share``'s reading of the same counters."""

from benchmark.harness import read_layer_metric


def read(t):
    return read_layer_metric("sample.unet_graph_share", t)
