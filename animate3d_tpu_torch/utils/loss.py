"""Loss helpers (the port's copy of ``animate3d_tpu/utils/loss.py``)."""

from __future__ import annotations

import torch


def tv_loss(img: torch.Tensor) -> torch.Tensor:
    """Total variation of (B, H, W, C) images: mean squared neighbour
    differences along H plus along W."""
    h_diff = img[:, 1:] - img[:, :-1]
    w_diff = img[:, :, 1:] - img[:, :, :-1]
    return (h_diff ** 2).mean() + (w_diff ** 2).mean()
