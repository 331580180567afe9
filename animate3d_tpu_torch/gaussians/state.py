"""Gaussian-splat state: the port of ``animate3d_tpu/gaussians/state.py``.

Raw (pre-activation) attributes: xyz (N, 3), features_dc (N, 1, 3),
features_rest (N, K-1, 3), opacity (N, 1) pre-sigmoid, scaling (N, 3) log,
rotation (N, 4) unnormalised wxyz. Activations as the reference: sigmoid,
exp, normalise, concat.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from animate3d_tpu_torch.utils.sh import rgb_to_sh


class BasicPointCloud(NamedTuple):
    points: np.ndarray  # (N, 3)
    colors: np.ndarray  # (N, 3) in [0, 1]
    normals: np.ndarray  # (N, 3)


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

    def to(self, device) -> "GaussianState":
        tensors = {f.name: getattr(self, f.name).to(device) for f in fields(self)
                   if isinstance(getattr(self, f.name), torch.Tensor)}
        return replace(self, **tensors)

    @classmethod
    def from_numpy(cls, xyz, features_dc, features_rest, opacity, scaling, rotation,
                   sh_degree: int = 0, device="cpu") -> "GaussianState":
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        return cls(t(xyz), t(features_dc), t(features_rest), t(opacity), t(scaling),
                   t(rotation), sh_degree=sh_degree)


def inverse_sigmoid(x):
    x = np.asarray(x, dtype=np.float64)
    return np.log(x / (1 - x))


def from_point_cloud(pcd: BasicPointCloud, sh_degree: int = 0,
                     initial_scale: Optional[np.ndarray] = None,
                     opacity_init: float = 0.1, device="cpu") -> GaussianState:
    """``create_from_pcd`` parity: scales default to the square root of the
    mean squared distance to the 3 nearest neighbours (simple-knn's
    distCUDA2), colours to SH degree 0, identity rotations."""
    n = pcd.points.shape[0]
    if initial_scale is None:
        from animate3d_tpu_torch.ops.knn import mean_sq_dist_to_knn

        d2 = mean_sq_dist_to_knn(torch.as_tensor(np.asarray(pcd.points, np.float32),
                                                 device=device), k=3).cpu().numpy()
        initial_scale = np.sqrt(np.clip(d2, 1e-7, None))
    initial_scale = np.asarray(initial_scale, dtype=np.float32)
    if initial_scale.ndim == 1:
        initial_scale = np.repeat(initial_scale[:, None], 3, axis=1)
    k = (sh_degree + 1) ** 2
    rotation = np.zeros((n, 4), np.float32)
    rotation[:, 0] = 1.0
    return GaussianState.from_numpy(
        xyz=pcd.points,
        features_dc=rgb_to_sh(np.asarray(pcd.colors, np.float32))[:, None, :],
        features_rest=np.zeros((n, k - 1, 3), np.float32),
        opacity=inverse_sigmoid(opacity_init * np.ones((n, 1))),
        scaling=np.log(initial_scale),
        rotation=rotation, sh_degree=sh_degree, device=device)


def random_state(n: int, radius: float = 0.5, sh_degree: int = 0,
                 opacity_init: float = 0.1, generator: Optional[torch.Generator] = None,
                 device="cpu") -> GaussianState:
    """Random points inside a sphere (``init_num_pts`` / ``pc_init_radius``
    parity), drawn from ``generator`` (the JAX package draws from a key:
    the same seed gives other points)."""
    pts = torch.randn((n, 3), generator=generator, dtype=torch.float32)
    pts = pts / (torch.linalg.norm(pts, dim=-1, keepdim=True) + 1e-9)
    pts = pts * radius * torch.rand((n, 1), generator=generator) ** (1.0 / 3.0)
    colors = np.full((n, 3), 0.5, np.float32)
    pcd = BasicPointCloud(pts.numpy(), colors, np.zeros((n, 3), np.float32))
    return from_point_cloud(pcd, sh_degree=sh_degree, opacity_init=opacity_init, device=device)
