"""Gaussian-splat state: the port of ``animate3d_tpu/gaussians/state.py``.

Raw (pre-activation) attributes: xyz (N, 3), features_dc (N, 1, 3),
features_rest (N, K-1, 3), opacity (N, 1) pre-sigmoid, scaling (N, 3) log,
rotation (N, 4) unnormalised wxyz. Activations as the reference: sigmoid,
exp, normalise, concat.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class GaussianState:
    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    opacity: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    sh_degree: int = 0
    active_sh_degree: Optional[int] = None

    def __post_init__(self):
        if self.active_sh_degree is None:
            self.active_sh_degree = self.sh_degree

    @property
    def num_points(self) -> int:
        return self.xyz.shape[0]

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_rotation(self) -> torch.Tensor:
        return self.rotation / (torch.linalg.norm(self.rotation, dim=-1, keepdim=True) + 1e-12)

    def get_features(self) -> torch.Tensor:
        """(N, K, 3) concatenated SH coefficients."""
        return torch.cat([self.features_dc, self.features_rest], dim=1)
