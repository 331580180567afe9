"""The training step's share of the bf16 peak: the UNet's forward, input
and weight gradients (three forwards), the posterior encode of the clip
and the vision tower, recompute not counted
(``drivers/train.py::trace_counts``)."""

from benchmark.readers import mfu as read  # noqa: F401
