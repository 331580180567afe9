"""Densification / pruning for static gaussian splats: the port of
``animate3d_tpu/gaussians/densify.py`` (numpy on the host, as there).

Parity target: the threestudio-3dgs ``GaussianBaseModel`` mechanism the 4D
stage inherits (SURVEY.md §2.4): clone small high-gradient gaussians, split
large ones (sampling inside the parent's covariance), prune by opacity /
screen radius / world scale, and periodic opacity reset. Animate3D's configs
effectively disable it (intervals 1e5+, thresholds 100+,
motion_recon_frame_16.yaml:81-92), so this exists for static-GS parity and
future pipelines.

Host-level functions: point counts change, so a densify step returns a
new state (on the device of the one given) and fresh stats. No path of the
port calls them, as none of the JAX package does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np

import torch

from animate3d_tpu_torch.gaussians.state import GaussianState, inverse_sigmoid
from animate3d_tpu_torch.utils.rotation import quat_to_matrix_np


@dataclass
class DensifyConfig:
    densify_grad_threshold: float = 2e-4
    percent_dense: float = 0.01  # relative to scene extent
    min_opacity: float = 0.005
    max_screen_radius: float = 20.0
    max_world_scale_rel: float = 0.1
    split_n: int = 2


class DensifyStats(NamedTuple):
    """Accumulated over steps between densify calls."""

    grad_accum: np.ndarray  # (N,) sum of screenspace grad norms
    denom: np.ndarray  # (N,) number of times visible
    max_radii: np.ndarray  # (N,)

    @classmethod
    def zero(cls, n: int) -> "DensifyStats":
        return cls(np.zeros(n), np.zeros(n), np.zeros(n))

    def update(self, mean2d_grad: np.ndarray, radii: np.ndarray) -> "DensifyStats":
        visible = np.asarray(radii) > 0
        g = np.linalg.norm(np.asarray(mean2d_grad), axis=-1)
        return DensifyStats(
            grad_accum=self.grad_accum + np.where(visible, g, 0.0),
            denom=self.denom + visible.astype(np.float64),
            max_radii=np.maximum(self.max_radii, np.asarray(radii)),
        )


def _np_state(state: GaussianState):
    return {k: getattr(state, k).detach().cpu().numpy() for k in
            ("xyz", "features_dc", "features_rest", "opacity", "scaling", "rotation")}


def _select(d, mask):
    return {k: v[mask] for k, v in d.items()}


def _concat(a, b):
    return {k: np.concatenate([a[k], b[k]], axis=0) for k in a}


def densify_and_prune(
    state: GaussianState,
    stats: DensifyStats,
    cfg: DensifyConfig,
    scene_extent: float,
    rng: np.random.Generator,
) -> Tuple[GaussianState, DensifyStats]:
    d = _np_state(state)
    n = d["xyz"].shape[0]
    grads = stats.grad_accum / np.maximum(stats.denom, 1.0)
    scales = np.exp(d["scaling"]).max(axis=-1)
    high_grad = grads >= cfg.densify_grad_threshold

    # clone: small gaussians move toward their gradient (duplicated in place)
    clone_mask = high_grad & (scales <= cfg.percent_dense * scene_extent)
    clones = _select(d, clone_mask)

    # split: large gaussians → split_n children sampled from the parent
    split_mask = high_grad & (scales > cfg.percent_dense * scene_extent)
    parents = _select(d, split_mask)
    children = {k: np.repeat(v, cfg.split_n, axis=0) for k, v in parents.items()}
    if parents["xyz"].shape[0] > 0:
        stds = np.exp(children["scaling"])
        samples = rng.normal(size=children["xyz"].shape) * stds
        rot = quat_to_matrix_np(children["rotation"])
        children["xyz"] = children["xyz"] + np.einsum("nij,nj->ni", rot, samples)
        children["scaling"] = np.log(np.exp(children["scaling"]) / (0.8 * cfg.split_n))

    keep_mask = ~split_mask  # split parents are replaced by children
    kept = _select(d, keep_mask)
    merged = _concat(_concat(kept, clones), children)

    # prune
    opacity = 1.0 / (1.0 + np.exp(-merged["opacity"][:, 0]))
    world_scale = np.exp(merged["scaling"]).max(axis=-1)
    prune = (opacity < cfg.min_opacity) | (
        world_scale > cfg.max_world_scale_rel * scene_extent)
    merged = _select(merged, ~prune)

    dev = state.xyz.device
    new_state = GaussianState(
        **{k: torch.as_tensor(v.astype(np.float32), device=dev) for k, v in merged.items()},
        sh_degree=state.sh_degree, active_sh_degree=state.active_sh_degree)
    return new_state, DensifyStats.zero(new_state.num_points)


def reset_opacity(state: GaussianState, value: float = 0.01) -> GaussianState:
    """Clamp opacities to ≤ value (periodic opacity reset)."""
    op = state.opacity.detach().cpu().numpy()
    new = np.minimum(op, inverse_sigmoid(np.full_like(op, value)))
    return dataclasses.replace(
        state, opacity=torch.as_tensor(new.astype(np.float32), device=state.opacity.device))
