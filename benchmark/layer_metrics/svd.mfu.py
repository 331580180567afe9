"""Image-to-video sampling's share of the bf16 peak: the products and
convolutions of the Euler steps (CFG UNet calls, 50 frames each) and of
each request's conditioning and decode done in the traced window, counted
on the reference over meta tensors by ``drivers/svd_i2v.py``."""

from benchmark.readers import mfu as read  # noqa: F401
