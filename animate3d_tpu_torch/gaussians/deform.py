"""4D deformation field: K-planes features → Δxyz / Δrotation / Δscale MLPs.

The port of ``animate3d_tpu/gaussians/deform.py`` as an ``nn.Module``:
two multiscale 4D grids (16 features each) concatenated into 32-d
features; bias-free one-hidden-layer ReLU MLPs of width 32 whose output
layer starts at zero; time planes start at 1, space planes U(0.1, 0.5);
with ``use_global_trans``, a global rigid rotation (sigmoid → [-π, π]
Euler) and translation (sigmoid → [-1, 1]) from the mean feature.

``deform_frames`` computes :meth:`deform` for every frame at once, its
features from ``kplanes.sample_frames`` (kernel I on the card), with or
without ``use_global_trans``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from animate3d_tpu_torch.gaussians.kplanes import COO_COMBS, plane_shapes, sample_frames
from animate3d_tpu_torch.gaussians.state import GaussianState
from animate3d_tpu_torch.utils import trace
from animate3d_tpu_torch.utils.rotation import euler_to_matrix, matrix_to_quat, quat_to_matrix


@dataclass(frozen=True)
class DeformConfig:
    grid_sizes: Tuple[Tuple[int, int, int, int], ...] = ((50, 50, 50, 8), (100, 100, 100, 16))
    grid_feature_dim: int = 16
    mlp_width: int = 32
    use_global_trans: bool = False


def _lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax's default Dense init: truncated normal (±2σ) of variance 1/fan_in."""
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        w.copy_(torch.nn.init.trunc_normal_(torch.empty(w.shape), std=std, a=-2 * std,
                                            b=2 * std, generator=generator))


class ZeroOutMLP(nn.Module):
    """Bias-free ReLU MLP, one hidden layer, output layer initialised to zero."""

    def __init__(self, dim_in: int, width: int, dim_out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden = nn.Linear(dim_in, width, bias=False)
        self.out = nn.Linear(width, dim_out, bias=False)
        _lecun_normal_(self.hidden.weight, generator)
        nn.init.zeros_(self.out.weight)

    def forward(self, x):
        return self.out(torch.relu(self.hidden(x)))


class DeformationField(nn.Module):
    def __init__(self, config: DeformConfig = DeformConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        for s, shapes in enumerate(plane_shapes(cfg.grid_sizes, cfg.grid_feature_dim)):
            for p, (shape, combo) in enumerate(zip(shapes, COO_COMBS)):
                if 3 in combo:  # time planes start at 1
                    init = torch.ones(shape)
                else:
                    init = 0.1 + 0.4 * torch.rand(shape, generator=generator)
                self.register_parameter(f"grid_{s}_{p}", nn.Parameter(init))
        feat = cfg.grid_feature_dim * len(cfg.grid_sizes)
        mlp = lambda n: ZeroOutMLP(feat, cfg.mlp_width, n, generator)
        self.delta_xyz_network = mlp(3)
        self.delta_rot_network = mlp(4)
        self.delta_scaling_network = mlp(3)
        if cfg.use_global_trans:
            self.global_rot_network = mlp(3)
            self.global_trans_network = mlp(3)

    @property
    def grids(self):
        n = len(COO_COMBS)
        return [[getattr(self, f"grid_{s}_{p}") for p in range(n)]
                for s in range(len(self.config.grid_sizes))]

    def features(self, xyz: torch.Tensor, timestamp) -> torch.Tensor:
        """(N, 3) positions + scalar t in [-1, 1] → (N, F) features."""
        t = torch.as_tensor(timestamp, dtype=xyz.dtype, device=xyz.device)
        return sample_frames(xyz, t.reshape(1), self.grids)[0]

    def _displace(self, xyz, rot, scaling, feats, deform_scales):
        """The deformation from features; leading frame axis optional."""
        if self.config.use_global_trans:
            g = feats.mean(dim=-2, keepdim=True)
            angles = torch.sigmoid(self.global_rot_network(g))[..., 0, :] * 2 * math.pi - math.pi
            trans = torch.sigmoid(self.global_trans_network(g)) * 2.0 - 1.0
            R = euler_to_matrix(angles)
            xyz = xyz @ R.transpose(-1, -2) + trans
            rot = matrix_to_quat(R[..., None, :, :] @ quat_to_matrix(rot))
        xyz = xyz + self.delta_xyz_network(feats)
        rot = rot + self.delta_rot_network(feats)
        rot = rot / (torch.linalg.norm(rot, dim=-1, keepdim=True) + 1e-12)
        if deform_scales:
            scaling = scaling + self.delta_scaling_network(feats)
        return xyz, rot, torch.exp(scaling.expand(xyz.shape))

    def deform(self, state: GaussianState, timestamp, deform_scales: bool = False):
        """→ (means3d, normalised rotations, linear scales, features) at one time."""
        feats = self.features(state.xyz, timestamp)
        return self._displace(state.xyz, state.rotation, state.scaling, feats,
                              deform_scales) + (feats,)

    @trace.spanned("deform.frames")
    def deform_frames(self, state: GaussianState, ts: torch.Tensor,
                      deform_scales: bool = False):
        """:meth:`deform` at each of the F times ``ts``, with a frame axis
        written out: (means (F, N, 3), rotations (F, N, 4), scales (F, N, 3))."""
        feats = sample_frames(state.xyz, ts, self.grids)
        return self._displace(state.xyz, state.rotation, state.scaling, feats, deform_scales)
