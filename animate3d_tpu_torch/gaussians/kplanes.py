"""K-planes 4D factorised feature grid: the port of
``animate3d_tpu/gaussians/kplanes.py``.

Per scale, one (C, H, W) plane for each of the six 2-combinations of
(x, y, z, t) in itertools order; features are bilinearly sampled per plane
(align_corners=True, border clamp), multiplied across planes and
concatenated across scales. :func:`grid_sample_2d` reproduces the JAX
package's bilinear gather (not ``F.grid_sample``);
:func:`interpolate_ms_features_frames` is its time-factorised form over all
frames at once (dense axis-weight contractions). :func:`sample_frames` is
:func:`interpolate_ms_features` at every frame: on the card, kernel I
(``ops/kplanes.py``).
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import torch

from animate3d_tpu_torch.ops import kplanes as kernel_i
from animate3d_tpu_torch.ops import routing
from animate3d_tpu_torch.utils import trace

COO_COMBS: Tuple[Tuple[int, int], ...] = tuple(itertools.combinations(range(4), 2))


def grid_sample_2d(plane: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """plane (C, H, W), coords (N, 2) in [-1, 1] as (x, y) → (N, C)."""
    _, h, w = plane.shape
    x = torch.clamp((coords[:, 0] + 1.0) * 0.5 * (w - 1), 0.0, w - 1)
    y = torch.clamp((coords[:, 1] + 1.0) * 0.5 * (h - 1), 0.0, h - 1)
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    p = plane.permute(1, 2, 0)  # (H, W, C)
    c00, c01, c10, c11 = p[y0, x0], p[y0, x1], p[y1, x0], p[y1, x1]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


@trace.spanned("kplanes.sample")
def interpolate_ms_features(pts: torch.Tensor,
                            grids: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """pts (N, 4) in [-1, 1] → (N, C · n_scales)."""
    outs = []
    for planes in grids:
        interp = None
        for ci, combo in enumerate(COO_COMBS):
            feat = grid_sample_2d(planes[ci], pts[:, list(combo)])
            interp = feat if interp is None else interp * feat
        outs.append(interp)
    return torch.cat(outs, dim=-1)


def sample_frames(xyz: torch.Tensor, ts: torch.Tensor,
                  grids: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """(F, N, C · n_scales): :func:`interpolate_ms_features` at the points
    ``cat(xyz, t)`` for each of the F times ``ts``. CPU tensors (and the
    card inside ``routing.plain_ops``) take that gather; CUDA tensors take
    kernel I, which gives no gradient to ``xyz`` or ``ts``."""
    ts = ts.to(xyz.dtype)
    if routing.kernels_enabled(xyz.device):
        with trace.span("kplanes.sample"):
            return kernel_i.sample_frames(xyz, ts, grids)
    f, n = ts.shape[0], xyz.shape[0]
    pts = torch.cat([xyz.expand(f, n, 3), ts[:, None, None].expand(f, n, 1)], dim=-1)
    return interpolate_ms_features(pts.reshape(f * n, 4), grids).reshape(f, n, -1)


def axis_weights(coord: torch.Tensor, reso: int) -> torch.Tensor:
    """coord (M,) in [-1, 1] → (M, reso) bilinear weights, <= 2 nonzeros a row."""
    x = torch.clamp((coord + 1.0) * 0.5 * (reso - 1), 0.0, reso - 1)
    x0 = torch.clamp(torch.floor(x).long(), 0, reso - 1)
    x1 = torch.clamp(x0 + 1, max=reso - 1)
    fx = (x - x0)[:, None]
    cells = torch.arange(reso, device=coord.device)
    zero = torch.zeros((), dtype=coord.dtype, device=coord.device)
    return (torch.where(cells == x0[:, None], 1.0 - fx, zero)
            + torch.where(cells == x1[:, None], fx, zero))


@trace.spanned("kplanes.sample")
def interpolate_ms_features_frames(xyz: torch.Tensor, ts: torch.Tensor,
                                   grids: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """(F, N, C · n_scales) features of all N points at all F frames: the
    three spatial planes are sampled once, the three time planes per frame."""
    outs = []
    for planes in grids:
        reso = {}
        for ci, (c0, c1) in enumerate(COO_COMBS):
            _, h, w = planes[ci].shape
            reso[c0], reso[c1] = w, h
        waxes = {a: axis_weights(xyz[:, a], reso[a]) for a in range(3)}
        wt = axis_weights(ts, reso[3])
        spatial = temporal = None
        for ci, (c0, c1) in enumerate(COO_COMBS):
            if c1 != 3:
                feat = torch.einsum("chw,nw,nh->nc", planes[ci], waxes[c0], waxes[c1])
                spatial = feat if spatial is None else spatial * feat
            else:
                feat = torch.einsum("ctw,nw->nct", planes[ci], waxes[c0])
                feat = torch.einsum("nct,ft->fnc", feat, wt)
                temporal = feat if temporal is None else temporal * feat
        outs.append(spatial[None] * temporal)
    return torch.cat(outs, dim=-1)


def plane_shapes(grid_sizes: Sequence[Sequence[int]], dim: int) -> List[List[tuple]]:
    """[[(C, reso[c1], reso[c0]) per combo] per scale]."""
    return [[(dim, reso[c1], reso[c0]) for c0, c1 in COO_COMBS] for reso in grid_sizes]
