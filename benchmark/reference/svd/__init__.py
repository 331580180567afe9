"""Stable Video Diffusion XT as plain code (``svd_xt.py``)."""
