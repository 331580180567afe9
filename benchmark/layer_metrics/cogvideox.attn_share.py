"""Share of the device's busy time spent inside the program's joint
attention (qk-norm, RoPE and kernel A): the card's time between the start
and the end of each ``cogvideox.attn`` span (CUDA events
``drivers/cogvideox_i2v.py`` records around the program's span while the
profiler runs) over the traced window's busy time."""


def read(t):
    spent = t.counts.get("attn_device_s")
    if not spent or t.busy_s <= 0:
        return None
    return 100.0 * spent / t.busy_s
