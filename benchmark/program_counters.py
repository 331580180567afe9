"""Arithmetic of the readers of the port's own counters
(``animate3d_tpu_torch/utils/trace.py``), which the harness carries in
``TraceSummary.launches`` beside the kernel launch counts: ``(name, key)``
pairs changed over the traced window. A program without those counters, or
whose tracer never turned on in the window, recorded no span: the readers
then return None, never 0."""

from __future__ import annotations

from typing import Callable, Optional


def spans_recorded(t) -> bool:
    """True where the program closed a span of its own in the window."""
    return any(n > 0 for (name, _), n in t.launches.items() if name == "span_calls")


def per_unit(t, counter: str, keep: Callable[[object], bool] = lambda key: True,
             scale: float = 1.0) -> Optional[float]:
    """Σ over keys ``keep(key)`` of ``counter``'s change in the window, times
    ``scale``, over the units of work done in it; None without spans."""
    if not spans_recorded(t) or t.units <= 0:
        return None
    total = sum(n for (name, key), n in t.launches.items() if name == counter and keep(key))
    return scale * total / t.units


def host_syncs_per_unit(t) -> Optional[float]:
    """Waits of the host on the card inside a program span, per unit (the
    syncs of the benchmark's own code, outside every program span, left
    out)."""
    return per_unit(t, "host_sync", lambda key: key != "outside")
