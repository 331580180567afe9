"""The refine step's share of the bf16 peak: the CFG UNet forward, the VAE
encode of the SDS batch with its backward, the vision tower and the recon
and SDS renders' counted work (``drivers/refine.py::trace_counts``)."""

from benchmark.readers import mfu as read  # noqa: F401
