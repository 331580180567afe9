"""Sampling's share of the bf16 peak: the products and convolutions of the
denoise steps (CFG UNet forwards) and of each request's conditioning and
decode done in the traced window, counted by ``drivers/sample.py``."""

from benchmark.readers import mfu as read  # noqa: F401
