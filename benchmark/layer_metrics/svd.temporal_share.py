"""Share of the device's busy time spent inside the program's temporal
layers: the card's time between the start and the end of each
``unet.temporal_res`` / ``unet.temporal_transformer`` span (CUDA events
``drivers/svd_i2v.py`` records around the program's spans while the
profiler runs) over the traced window's busy time."""


def read(t):
    spent = t.counts.get("temporal_device_s")
    if not spent or t.busy_s <= 0:
        return None
    return 100.0 * spent / t.busy_s
