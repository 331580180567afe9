"""Device idle share of the traced window of CogVideoX image-to-video
sampling (profiler: the union of device activity against the window's
length)."""

from benchmark.readers import idle_share as read  # noqa: F401
