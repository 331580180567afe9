"""Arithmetic shared by the per-layer readers (``layer_metrics/*.py``). A
reader that finds nothing to read returns None and its metric is left out
of the result line; no share is ever made up as 0."""

from __future__ import annotations

from typing import Callable, Dict, Optional

from benchmark.counts.peaks import PEAK_BF16_FLOPS


def idle_share(t) -> Optional[float]:
    """Per cent of the traced window in which no operation ran on the device."""
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(t) -> Optional[float]:
    """Per cent of the bf16 dense peak that the driver's counted operations
    of the traced window make over the window's length."""
    flops = t.counts.get("flops")
    if not flops or t.window_s <= 0:
        return None
    return 100.0 * flops / (t.window_s * PEAK_BF16_FLOPS)


def roofline(t, bounds: Dict[str, Callable[[tuple], float]], kernel_needles) -> Optional[float]:
    """Per cent: the least time of every launch in the window counted under
    a counter of ``bounds`` (``bounds[counter](key)`` seconds a launch) over
    the device time of the kernels whose names hold ``kernel_needles``."""
    least = sum(bounds[name](key) * n for (name, key), n in t.launches.items() if name in bounds)
    spent = t.kernel_seconds(*kernel_needles)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent


def share(t, kernel_needles) -> Optional[float]:
    """Per cent of the device's busy time in the kernels named by
    ``kernel_needles``."""
    spent = t.kernel_seconds(*kernel_needles)
    if spent <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * spent / t.busy_s
