"""Share of rank 0's busy device time in the collectives' kernels (NCCL's:
the gradient all-reduce, ZeRO-1's all-gathers, the window's one-element
broadcast) during the traced window of the dp-4 trainer."""

from benchmark.readers import share


def read(t):
    return share(t, ("nccl",))
