"""Milliseconds a training step waits for its batch: the port's
``prefetcher.wait`` span (the consumer's queue get in
``data/video_dataset.py::Prefetcher``), its host time over the steps."""

from benchmark.program_counters import per_unit


def read(t):
    return per_unit(t, "span_ns", lambda key: key == "prefetcher.wait", scale=1e-6)
