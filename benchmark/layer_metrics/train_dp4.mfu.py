"""Rank 0's share of one card's bf16 peak at dp 4: its video's UNet
forward, input and weight gradients (three forwards), posterior encode and
vision tower a global step, recompute not counted
(``drivers/train_dp4.py::trace_counts``)."""

from benchmark.readers import mfu as read  # noqa: F401
