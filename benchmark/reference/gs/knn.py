"""Brute-force k nearest neighbours (the port of ``animate3d_tpu/ops/knn.py``):
squared distances by one matmul per chunk of queries, so N = 20,000 points
fit (the pytorch3d ``knn_points`` / simple-knn ``distCUDA2`` contracts)."""

from __future__ import annotations

from typing import Tuple

import torch


def _pairwise_sq_dists(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    q2 = (q * q).sum(-1, keepdim=True)
    p2 = (p * p).sum(-1, keepdim=True).T
    return torch.clamp(q2 + p2 - 2.0 * (q @ p.T), min=0.0)


@torch.no_grad()
def knn(query: torch.Tensor, points: torch.Tensor, k: int, exclude_self: bool = False,
        chunk: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """(squared distances, indices), each (Nq, k), ascending. ``exclude_self``
    drops the nearest match (the point itself when query is points)."""
    kk = k + 1 if exclude_self else k
    d2, idx = [], []
    for q0 in range(0, query.shape[0], chunk):
        neg, i = torch.topk(-_pairwise_sq_dists(query[q0:q0 + chunk], points), kk, dim=-1)
        d2.append(-neg)
        idx.append(i)
    d2, idx = torch.cat(d2), torch.cat(idx)
    if exclude_self:
        d2, idx = d2[:, 1:], idx[:, 1:]
    return d2, idx


def knn_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (Np, C), idx (Nq, K) → (Nq, K, C)."""
    return x[idx]
