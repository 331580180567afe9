"""The recon step's share of the bf16 peak: the K-planes interpolation,
the MLPs and the projection of the traced window's steps, counted by
``drivers/recon.py::step_flops`` (the compositor's data-dependent work is
not counted)."""

from benchmark.readers import mfu as read  # noqa: F401
