"""Rank 0's device idle share of the traced window of the dp-4 trainer
(profiler: the union of device activity against the window's length)."""

from benchmark.readers import idle_share as read  # noqa: F401
