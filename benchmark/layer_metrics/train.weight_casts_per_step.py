"""Weight casts a training step launches: ``models/layers.py``'s layers and
the feed-forwards casting a stored weight to the input's dtype
(``utils/trace.py``'s ``weight_cast`` counter, every pair of dtypes)."""

from benchmark.program_counters import per_unit


def read(t):
    return per_unit(t, "weight_cast")
