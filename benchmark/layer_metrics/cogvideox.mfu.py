"""CogVideoX image-to-video sampling's share of the bf16 peak: the
products of the DDIM steps (CFG transformer calls, batch 2) and of each
started request's conditioning (T5, the image encode) done in the traced
window, counted on the reference over meta tensors (``counts/cogvideox.py``)."""

from benchmark.readers import mfu as read  # noqa: F401
