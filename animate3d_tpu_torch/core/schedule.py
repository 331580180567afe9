"""Time-varying scalar schedules (the port's copy of
``animate3d_tpu/core/schedule.py``, threestudio's ``C``).

A config scalar is a number or a schedule list: ``[start, end, end_step]``,
``[start_step, start, end, end_step]``, or multi-segment
``[s0, v0, v1, e0, v2, e1, ...]``. A float ``end_step`` switches the clock
to the epoch. Interpolation is ``linear`` or ``exp`` (linear in log space).
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np


def C(value: Any, epoch: int, global_step: int, interpolation: str = "linear") -> float:
    if isinstance(value, (int, float)):
        return value
    value = list(value)
    if len(value) == 3:
        value = [0] + value
    if len(value) >= 6:
        select_i = 3
        for i in range(3, len(value) - 2, 2):
            if global_step >= value[i]:
                select_i = i + 2
        if select_i != 3:
            start_value, start_step = value[select_i - 3], value[select_i - 2]
        else:
            start_step, start_value = value[:2]
        end_value, end_step = value[select_i - 1], value[select_i]
        value = [start_step, start_value, end_value, end_step]
    if len(value) != 4:
        raise ValueError(f"Cannot interpret schedule spec {value}")
    start_step, start_value, end_value, end_step = value
    current = epoch if isinstance(end_step, float) else global_step
    t = max(min(1.0, (current - start_step) / (end_step - start_step)), 0.0)
    if interpolation == "linear":
        return start_value + (end_value - start_value) * t
    if interpolation == "exp":
        return math.exp(math.log(start_value) * (1 - t) + math.log(end_value) * t)
    raise ValueError(f"Unknown interpolation {interpolation!r} (linear|exp)")


def c_schedule(value: Any, interpolation: str = "linear") -> Callable[[int], float]:
    """step → scalar, :func:`C`'s semantics on the step clock for numbers and
    single-segment specs; evaluated in float32, as the optax schedule the
    JAX optimizer takes."""
    f32 = np.float32
    if isinstance(value, (int, float)):
        return lambda step: float(f32(value))
    spec = list(value)
    if len(spec) == 3:
        spec = [0] + spec
    if len(spec) != 4:
        raise ValueError(f"c_schedule supports single-segment specs, got {spec}")
    start_step, start_value, end_value, end_step = (float(v) for v in spec)

    def fn(step):
        t = np.clip((f32(step) - f32(start_step)) / f32(end_step - start_step), f32(0), f32(1))
        if interpolation == "linear":
            return float(f32(start_value) + f32(end_value - start_value) * t)
        return float(np.exp(f32(math.log(start_value)) * (f32(1) - t)
                            + f32(math.log(end_value)) * t))

    return fn
