"""As-rigid-as-possible regularisation over gaussian trajectories: the port
of ``animate3d_tpu/gaussians/arap.py`` (the reference's systems/util.py).

Edges are a fixed (Nv, K) neighbour matrix with -1 for an invalid slot;
connectivity comes from the first frame's KNN, a neighbour survives only if
it stays within ``radius`` over the later frames, the first
``least_edge_num`` slots are always kept, and edge weights are
exp(-d² / mean d²), normalised per row. Rotations come from a batched 3x3
SVD of the weighted edge covariance with the det <= 0 column flip, under
no gradient.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .knn import knn, knn_gather


class Connectivity(NamedTuple):
    nn_idx: torch.Tensor  # (Nv, K) int64, -1 = invalid
    weight: torch.Tensor  # (Nv, K) f32, row-normalised over valid slots


@torch.no_grad()
def connectivity_from_points(points: torch.Tensor, radius: float, K: int = 10,
                             least_edge_num: int = 3,
                             adaptive_weighting: bool = True) -> Connectivity:
    """points (F, Nv, 3): frame 0 defines the graph (the ``nn`` mode)."""
    first = points[0]
    nn_dist, nn_idx = knn(first, first, k=K, exclude_self=True)
    if points.shape[0] > 1:
        rest_nn = torch.stack([knn_gather(p, nn_idx) for p in points[1:]])
        rest_d2 = ((rest_nn - first[None, :, None, :]) ** 2).sum(-1)
        stays = (rest_d2 < radius ** 2).all(0)
        nn_dist = torch.where(stays, nn_dist, torch.full_like(nn_dist, float("inf")))
    return _finalize_connectivity(nn_dist, nn_idx, radius, least_edge_num, adaptive_weighting)


def _finalize_connectivity(nn_dist, nn_idx, radius, least_edge_num,
                           adaptive_weighting=True) -> Connectivity:
    """Radius gate (keeping the first ``least_edge_num`` slots), exp
    weights, row normalisation."""
    K = nn_idx.shape[1]
    keep = torch.arange(K, device=nn_idx.device)[None, :] < least_edge_num
    valid = keep | (nn_dist < radius ** 2)
    nn_idx = torch.where(valid, nn_idx, torch.full_like(nn_idx, -1))
    inf = torch.full_like(nn_dist, float("inf"))
    masked = torch.where(valid, nn_dist, inf)
    if adaptive_weighting:
        finite = torch.where(torch.isfinite(masked), masked, torch.zeros_like(masked))
        denom = finite.sum() / torch.clamp(valid.sum(), min=1)
        w = torch.exp(-masked / torch.clamp(denom, min=1e-12))
    else:
        w = torch.exp(-masked)
    w = torch.where(valid, w, torch.zeros_like(w))
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
    return Connectivity(nn_idx=nn_idx, weight=w)


def connectivity_from_mesh_edges(connected_vertices: Dict[str, Dict[str, float]],
                                 max_neighbors: Optional[int] = None
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Mesh-edge JSON → padded (Nv, Kmax) neighbour matrix + valid mask."""
    nv = len(connected_vertices)
    kmax = max(len(v) for v in connected_vertices.values())
    if max_neighbors is not None:
        kmax = max(kmax, max_neighbors)
    nn_idx = -np.ones((nv, kmax), dtype=np.int64)
    for key, val in connected_vertices.items():
        ids = [int(k) for k in val.keys()]
        nn_idx[int(key), :len(ids)] = ids
    return nn_idx, nn_idx != -1


def sample_neighbor_subset(nn_idx: torch.Tensor, valid: torch.Tensor, P: int,
                           scores: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A random P-subset of each row's valid neighbours (-1 padded); the
    uniform ``scores`` (Nv, K) may be given (the tests feed JAX's)."""
    if scores is None:
        gdev = generator.device if generator is not None else nn_idx.device
        scores = torch.rand(nn_idx.shape, generator=generator, device=gdev).to(nn_idx.device)
    scores = scores + torch.where(valid, 0.0, 1000.0)
    order = torch.argsort(scores, dim=1, stable=True)[:, :P]
    picked = torch.gather(nn_idx, 1, order)
    return torch.where(torch.gather(valid, 1, order), picked, torch.full_like(picked, -1))


@torch.no_grad()
def estimate_rotations(source: torch.Tensor, target: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """Per-node best-fit rotations (Nv', 3, 3) from (Nv', K, 3) edges: SVD of
    the weighted covariance, the column of the smallest singular value
    flipped where det <= 0. An undeformed node (source == target) gets the
    identity, what the reference's zero covariance means."""
    S = torch.einsum("nki,nk,nkj->nij", source, weight, target)
    unchanged = (source == target).all(-1).all(-1)
    U, sig, Vt = torch.linalg.svd(S)
    W = Vt.transpose(-1, -2)
    R = W @ U.transpose(-1, -2)
    flip = torch.nn.functional.one_hot(sig.argmin(-1), 3).to(U.dtype)
    R_flipped = W @ (U * (1.0 - 2.0 * flip[:, None, :])).transpose(-1, -2)
    R = torch.where((torch.linalg.det(R) <= 0)[:, None, None], R_flipped, R)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand_as(R)
    return torch.where(unchanged[:, None, None], eye, R)


def arap_error(nodes_sequence: torch.Tensor, conn: Connectivity,
               sample_idx: Optional[torch.Tensor] = None, sample_num: int = 512,
               frame_weights: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Σ_t fw_t Σ_edges w ||e_t - R_t e_0||² over <= ``sample_num`` nodes,
    drawn with replacement (``sample_idx`` may be given: the tests feed
    JAX's draw). nodes_sequence (Nt, Nv, 3)."""
    nt, nv, _ = nodes_sequence.shape
    dev = nodes_sequence.device
    if sample_idx is None:
        if nv > sample_num:
            gdev = generator.device if generator is not None else dev
            sample_idx = torch.randint(0, nv, (sample_num,), generator=generator,
                                       device=gdev).to(dev)
        else:
            sample_idx = torch.arange(nv, device=dev)
    nn_idx = conn.nn_idx[sample_idx]
    weight = conn.weight[sample_idx]
    s, k = nn_idx.shape
    # (Nt, S, K, 3) edges p_i - p_j of every frame, invalid slots zero
    e = nodes_sequence[:, sample_idx, None, :] - nodes_sequence[:, torch.clamp(nn_idx, min=0)]
    e = torch.where((nn_idx >= 0)[None, ..., None], e, torch.zeros_like(e))
    src, tgt = e[0], e[1:]
    if frame_weights is None:
        frame_weights = torch.ones(nt - 1, device=dev)
    R = estimate_rotations(src.detach().repeat(nt - 1, 1, 1), tgt.detach().reshape(-1, k, 3),
                           weight.repeat(nt - 1, 1)).reshape(nt - 1, s, 3, 3)
    rigid = torch.einsum("tnij,nkj->tnki", R, src)
    stretch = ((tgt - rigid) ** 2).sum(-1)
    return (frame_weights[:, None, None] * weight * stretch).sum()
