"""Differentiable 3D gaussian-splat rasterizer: the port of
``animate3d_tpu/ops/rasterize.py`` and of the compositing kernels of
``animate3d_tpu/ops/rasterize_pallas.py``.

Every route first projects the gaussians (EWA splatting: view transform,
perspective Jacobian, 2D covariance + 0.3 px dilation, 3-sigma radius).
Binning is an exact ``torch.topk`` (the TPU's ``approx_max_k`` is a fitting
choice: parity is held against the JAX package with
``approx_binning=False``). Then, as the JAX package routes (``:593-650``):

* **coarse-direct** (more than ``coarse``² fine tiles): per coarse tile of
  ``coarse`` x ``coarse`` fine 16x16 tiles, the ``coarse_k`` depth-nearest
  overlapping gaussians front to back; their fields ``(n_ct, 12, kc)`` (10
  differentiable rows, the stop-grad ``ok`` and 3-sigma radius rows, kc
  padded to a multiple of 128) composited by kernel H
  (``csrc/composite_coarse.cu``, :class:`CompositeCoarseFn`);
* **fields** (``coarse``² fine tiles or fewer, or ``coarse == 0``): per fine
  tile, the ``max_per_tile`` depth-nearest overlapping gaussians
  (:func:`_tile_select`), packed as ``(T, 12, K)`` fields
  (:func:`pack_fields`, row 11 zero) and composited by kernel G
  (``csrc/composite_fields.cu``, :class:`CompositeFieldsFn`): every
  candidate, no early stop, no tile gate.

The JAX package's XLA route (``backend="xla"``: hierarchical binning and a
compositor in XLA ops, the route it takes off the TPU) is not ported: no
entry point of the port selects it.

The views are a batch dimension: one kernel launch per direction covers
every tile of every view in the call. CPU tensors take the kernels' plain
versions; CUDA tensors take the kernels, or the plain versions inside
:func:`routing.plain_ops`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from animate3d_tpu_torch.ops import _build, routing
from animate3d_tpu_torch.utils import trace
from animate3d_tpu_torch.utils.rotation import quat_to_matrix
from animate3d_tpu_torch.utils.sh import sh_color

NFIELD = 12
_KB = 128  # candidate block of the early stop
_T_STOP = 1e-4
_SELECT_ELEMS = 1 << 25  # (view, coarse tile, gaussian) scores per top-k call
_PLAIN_ELEMS = 1 << 24  # (pixel, candidate) elements per chunk of the plain versions


class RasterConfig(NamedTuple):
    """The rasterizer's parameters (``animate3d_tpu``'s values)."""

    height: int
    width: int
    tile: int = 16
    max_per_tile: int = 256  # K of the fields route's per-fine-tile lists
    znear_cull: float = 0.2
    dilate: float = 0.3
    alpha_min: float = 1.0 / 255.0
    alpha_max: float = 0.99
    coarse: int = 4
    coarse_k: int = 512

    @property
    def tiles_x(self) -> int:
        return (self.width + self.tile - 1) // self.tile

    @property
    def tiles_y(self) -> int:
        return (self.height + self.tile - 1) // self.tile


class GSCameraArrays(NamedTuple):
    """Per-view camera tensors, row-vector layout, views leading:
    world_view (B, 4, 4), full_proj (B, 4, 4), camera_center (B, 3),
    tanfovx (B,), tanfovy (B,)."""

    world_view: torch.Tensor
    full_proj: torch.Tensor
    camera_center: torch.Tensor
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor

    def index(self, idx) -> "GSCameraArrays":
        return GSCameraArrays(*(t[idx] for t in self))


def build_cov3d(scales: torch.Tensor, rotations: torch.Tensor,
                modifier: float = 1.0) -> torch.Tensor:
    """(..., 3, 3) world covariance R S S^T R^T from linear scales + wxyz quats."""
    R = quat_to_matrix(rotations)
    RS = R * (scales * modifier)[..., None, :]
    return RS @ RS.transpose(-1, -2)


class Projected(NamedTuple):
    mean2d: torch.Tensor  # (B, N, 2) pixel coords
    depth: torch.Tensor  # (B, N)
    conic: torch.Tensor  # (B, N, 3)
    radius: torch.Tensor  # (B, N), 0 for culled
    valid: torch.Tensor  # (B, N) bool


def project_gaussians(means3d: torch.Tensor, cov3d: torch.Tensor,
                      camera: GSCameraArrays, cfg: RasterConfig) -> Projected:
    """EWA projection of (B, N) gaussians through (B,) cameras."""
    hom = torch.cat([means3d, torch.ones_like(means3d[..., :1])], dim=-1)
    p_view = hom @ camera.world_view
    p_hom = hom @ camera.full_proj
    w = 1.0 / (p_hom[..., 3] + 1e-7)
    p_ndc = p_hom[..., :3] * w[..., None]

    depth = p_view[..., 2]
    in_front = depth > cfg.znear_cull
    tanx, tany = camera.tanfovx[:, None], camera.tanfovy[:, None]
    fx = cfg.width / (2.0 * tanx)
    fy = cfg.height / (2.0 * tany)
    tz = torch.where(in_front, depth, torch.ones_like(depth))
    lim_x, lim_y = 1.3 * tanx, 1.3 * tany
    txtz = torch.minimum(torch.maximum(p_view[..., 0] / tz, -lim_x), lim_x)
    tytz = torch.minimum(torch.maximum(p_view[..., 1] / tz, -lim_y), lim_y)
    tx, ty = txtz * tz, tytz * tz

    Wm = camera.world_view[:, None, :3, :3]  # (B, 1, 3, 3): x_view = x_world @ Wm
    j00 = fx / tz
    j02 = -fx * tx / (tz * tz)
    j11 = fy / tz
    j12 = -fy * ty / (tz * tz)
    A = torch.stack([Wm[..., 0] * j00[..., None] + Wm[..., 2] * j02[..., None],
                     Wm[..., 1] * j11[..., None] + Wm[..., 2] * j12[..., None]],
                    dim=-1)  # (B, N, 3, 2)
    cov2d = A.transpose(-1, -2) @ cov3d @ A
    c00 = cov2d[..., 0, 0] + cfg.dilate
    c01 = cov2d[..., 0, 1]
    c11 = cov2d[..., 1, 1] + cfg.dilate

    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c11 / det_safe, -c01 / det_safe, c00 / det_safe], dim=-1)

    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    mean2d = torch.stack([((p_ndc[..., 0] + 1.0) * cfg.width - 1.0) * 0.5,
                          ((p_ndc[..., 1] + 1.0) * cfg.height - 1.0) * 0.5], dim=-1)
    valid = in_front & det_ok & (radius > 0)
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return Projected(mean2d, depth, conic, radius, valid)


def _coarse_grid(cfg: RasterConfig):
    cs = cfg.coarse
    cty = -(-cfg.tiles_y // cs)
    ctx = -(-cfg.tiles_x // cs)
    return cs, cty, ctx


@torch.no_grad()
@trace.spanned("rasterize.select")
def _coarse_select(proj: Projected, cfg: RasterConfig):
    """Per view and coarse tile, the kc depth-nearest overlapping gaussians
    front to back (exact top-k; ties keep ``torch.topk``'s order, which only
    moves the non-overlapping tail whose ``ok`` is 0).
    → (cidx (B, n_ct, kc) int64, cok (B, n_ct, kc) bool, c_count (B, n_ct),
    coarse origins (n_ct, 2) f32)."""
    cs, cty, ctx = _coarse_grid(cfg)
    b, n = proj.depth.shape
    big = 1e10
    depth = torch.where(proj.valid, proj.depth, torch.full_like(proj.depth, big))
    x, y = proj.mean2d[..., 0], proj.mean2d[..., 1]
    r = proj.radius
    kc = min(cfg.coarse_k, n)
    dev = depth.device
    ids = torch.arange(cty * ctx, device=dev)
    ext = cs * cfg.tile
    c_x0 = ((ids % ctx) * ext).float()
    c_y0 = ((ids // ctx) * ext).float()
    step = max(1, _SELECT_ELEMS // max(cty * ctx * n, 1))
    cidx, cok, count = [], [], []
    for v0 in range(0, b, step):
        sl = slice(v0, v0 + step)
        ov = ((x[sl, None, :] + r[sl, None, :] >= c_x0[None, :, None])
              & (x[sl, None, :] - r[sl, None, :] < c_x0[None, :, None] + ext)
              & (y[sl, None, :] + r[sl, None, :] >= c_y0[None, :, None])
              & (y[sl, None, :] - r[sl, None, :] < c_y0[None, :, None] + ext)
              & proj.valid[sl, None, :])
        score = torch.where(ov, depth[sl, None, :], torch.full_like(depth[sl, None, :], big))
        neg, idx = torch.topk(-score, kc, dim=-1)
        cidx.append(idx)
        cok.append((-neg) < big)
        count.append(ov.sum(-1))
    return (torch.cat(cidx), torch.cat(cok), torch.cat(count),
            torch.stack([c_x0, c_y0], dim=-1))


def _tile_origins(cfg: RasterConfig, device) -> torch.Tensor:
    """(tiles_y · tiles_x, 2) f32 pixel origins of the fine tiles, row-major."""
    ids = torch.arange(cfg.tiles_y * cfg.tiles_x, device=device)
    return torch.stack([((ids % cfg.tiles_x) * cfg.tile).float(),
                        ((ids // cfg.tiles_x) * cfg.tile).float()], dim=-1)


def _pad_k(idx: torch.Tensor, ok: torch.Tensor, k: int):
    """Pads (B, T, kk) lists to k candidates (index 0, ``ok`` False)."""
    pad = k - idx.shape[-1]
    if pad:
        idx = torch.nn.functional.pad(idx, (0, pad))
        ok = torch.nn.functional.pad(ok, (0, pad))
    return idx, ok


@torch.no_grad()
@trace.spanned("rasterize.select")
def _tile_select(proj: Projected, cfg: RasterConfig):
    """Per view and fine tile, the ``max_per_tile`` depth-nearest overlapping
    gaussians front to back, one exact top-k over all N (``:385-436``).
    → (idx (B, T, K) int64, ok (B, T, K) bool, overflow () int: gaussian x
    tile pairs past the K cap)."""
    b, n = proj.depth.shape
    big = 1e10
    depth = torch.where(proj.valid, proj.depth, torch.full_like(proj.depth, big))
    x, y, r = proj.mean2d[..., 0], proj.mean2d[..., 1], proj.radius
    org = _tile_origins(cfg, depth.device)
    tx0, ty0, t = org[None, :, 0, None], org[None, :, 1, None], cfg.tile
    kk = min(cfg.max_per_tile, n)
    step = max(1, _SELECT_ELEMS // max(org.shape[0] * n, 1))
    idx, ok, count = [], [], []
    for v0 in range(0, b, step):
        sl = slice(v0, v0 + step)
        xv, yv, rv = x[sl, None, :], y[sl, None, :], r[sl, None, :]
        ov = ((xv + rv >= tx0) & (xv - rv < tx0 + t) & (yv + rv >= ty0) & (yv - rv < ty0 + t)
              & proj.valid[sl, None, :])
        score = torch.where(ov, depth[sl, None, :], torch.full_like(depth[sl, None, :], big))
        neg, i = torch.topk(-score, kk, dim=-1)
        idx.append(i)
        ok.append((-neg) < big)
        count.append(ov.sum(-1))
    count = torch.cat(count)
    idx, ok = _pad_k(torch.cat(idx), torch.cat(ok), cfg.max_per_tile)
    return idx, ok, torch.clamp(count - kk, min=0).sum()


# ---------------------------------------------------------------------------
# Kernels H and G: plain versions (the CPU path and the card's reference)


def _tile_hit(rows: torch.Tensor, tx0: torch.Tensor, ty0: torch.Tensor, tile: int):
    """rows (C, 12, kb), tx0/ty0 (C, L) → (C, L, kb) AABB-overlaps-fine-tile."""
    xb, yb, rb = rows[:, None, 0], rows[:, None, 1], rows[:, None, 11]
    tx, ty = tx0[..., None], ty0[..., None]
    return (xb + rb >= tx) & (xb - rb < tx + tile) & (yb + rb >= ty) & (yb - rb < ty + tile)


def _block_alpha(rows, gx, gy, alpha_min, alpha_max):
    """(C, L, PX, kb) gated alpha of one candidate block (+ the backward's
    intermediates); gx/gy (C, L, PX)."""
    r = lambda i: rows[:, None, None, i]  # (C, 1, 1, kb)
    dx = r(0) - gx[..., None]
    dy = r(1) - gy[..., None]
    ca, cb, cc = r(2), r(3), r(4)
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    e = torch.exp(power)
    raw = r(5) * e
    alpha = torch.clamp(raw, max=alpha_max)
    live = (power <= 0.0) & (alpha >= alpha_min) & (r(10) > 0.0)
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    return alpha, (dx, dy, ca, cb, cc, e, raw, live)


def _pixel_grid(corig: torch.Tensor, tile: int, cs: int):
    """Fine-tile origins (C, L) and pixel centres (C, L, PX) of coarse tiles."""
    dev = corig.device
    local = torch.arange(cs * cs, device=dev)
    tx0 = corig[:, None, 0] + (local % cs).float() * tile
    ty0 = corig[:, None, 1] + (local // cs).float() * tile
    lin = torch.arange(tile * tile, device=dev)
    gx = (lin % tile).float() + tx0[..., None]
    gy = (lin // tile).float() + ty0[..., None]
    return tx0, ty0, gx, gy


def _chunk(cs: int, tile: int, kb: int) -> int:
    """Coarse tiles per chunk of the plain versions."""
    return max(1, _PLAIN_ELEMS // (cs * cs * tile * tile * kb))


def _excl_prod(alpha: torch.Tensor):
    """Exclusive prefix product of (1 - alpha) over the last axis, and the total."""
    incl = torch.cumprod(1.0 - alpha, dim=-1)
    excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], dim=-1)
    return excl, incl[..., -1]


def _composite_coarse_plain(fields: torch.Tensor, corig: torch.Tensor, cs: int = 4,
                            tile: int = 16, alpha_min: float = 1.0 / 255.0,
                            alpha_max: float = 0.99, count_pairs: bool = False):
    """Kernel H's forward in torch ops, chunked over coarse tiles:
    fields (n_ct, 12, kc), corig (n_ct, 2) → planes (n_ct, cs², 8, tile²).
    With ``count_pairs``, also (pairs, live pairs): the (pixel, candidate)
    pairs the kernel evaluates (256 per candidate that hits a fine tile in a
    block that runs there) and those of them with a live alpha."""
    n_ct, _, kc = fields.shape
    kb = min(kc, _KB)
    px = tile * tile
    out = fields.new_zeros((n_ct, cs * cs, 8, px))
    pairs = live_pairs = 0
    step = _chunk(cs, tile, kb)
    for c0 in range(0, n_ct, step):
        f = fields[c0:c0 + step]
        tx0, ty0, gx, gy = _pixel_grid(corig[c0:c0 + step], tile, cs)
        t = torch.ones_like(gx)
        rgbd = gx.new_zeros(gx.shape + (4,))
        acc = torch.zeros_like(gx)
        for b0 in range(0, kc, kb):
            rows = f[:, :, b0:b0 + kb]
            hit = _tile_hit(rows, tx0, ty0, tile)
            live = hit.any(-1) & (t.amax(-1) > _T_STOP)  # (C, L): the block runs
            if count_pairs:
                pairs += int((hit & live[..., None]).sum()) * px
            alpha, _ = _block_alpha(rows, gx, gy, alpha_min, alpha_max)
            alpha = torch.where((hit & live[..., None])[:, :, None, :], alpha,
                                torch.zeros_like(alpha))
            if count_pairs:
                live_pairs += int((alpha > 0).sum())
            excl, tot = _excl_prod(alpha)
            w = alpha * excl * t[..., None]
            rgbd = rgbd + torch.einsum("clpk,cfk->clpf", w, rows[:, 6:10])
            acc = acc + w.sum(-1)
            t = t * tot
        o = out[c0:c0 + step]
        o[:, :, 0:3] = rgbd[..., 0:3].transpose(-1, -2)
        o[:, :, 3] = acc
        o[:, :, 4] = rgbd[..., 3]
        o[:, :, 5] = t
    return (out, pairs, live_pairs) if count_pairs else out


def _composite_coarse_bwd_plain(fields: torch.Tensor, corig: torch.Tensor,
                                cot: torch.Tensor, cs: int = 4, tile: int = 16,
                                alpha_min: float = 1.0 / 255.0,
                                alpha_max: float = 0.99) -> torch.Tensor:
    """Kernel H's backward in torch ops (the JAX kernel's hand-derived
    formulas): → grad fields (n_ct, 12, kc), rows 10-11 zero."""
    n_ct, _, kc = fields.shape
    kb = min(kc, _KB)
    grad = torch.zeros_like(fields)
    step = _chunk(cs, tile, kb)
    for c0 in range(0, n_ct, step):
        f = fields[c0:c0 + step]
        tx0, ty0, gx, gy = _pixel_grid(corig[c0:c0 + step], tile, cs)
        # pass 1: forward recompute of alpha and T before each candidate
        t = torch.ones_like(gx)
        alphas, tks = [], []
        for b0 in range(0, kc, kb):
            rows = f[:, :, b0:b0 + kb]
            hit = _tile_hit(rows, tx0, ty0, tile)
            can = hit.any(-1) & (t.amax(-1) > _T_STOP)
            alpha, _ = _block_alpha(rows, gx, gy, alpha_min, alpha_max)
            alpha = torch.where((hit & can[..., None])[:, :, None, :], alpha,
                                torch.zeros_like(alpha))
            excl, tot = _excl_prod(alpha)
            alphas.append(alpha)
            tks.append(excl * t[..., None])
            t = t * tot
        c = cot[c0:c0 + step]
        gr, gg, gb, ga, gd, g_t = (c[:, :, i, :, None] for i in range(6))
        g_t_tf = g_t * t[..., None]
        # pass 2: blocks back to front, suffix sums of dw * w
        s = torch.zeros_like(gx)[..., None]
        for bi in reversed(range(len(alphas))):
            b0 = bi * kb
            rows = f[:, :, b0:b0 + kb]
            alpha, t_k = alphas[bi], tks[bi]
            ran = (alpha.amax(dim=(-1, -2)) > 0.0)[:, :, None]  # (C, L, 1)
            w = alpha * t_k
            r = lambda i: rows[:, None, None, i]
            dw = gr * r(6) + gg * r(7) + gb * r(8) + gd * r(9) + ga
            dww = dw * w
            suffix = torch.flip(torch.cumsum(torch.flip(dww, (-1,)), -1), (-1,))
            s_k = suffix - dww + s
            dalpha = dw * t_k - (s_k + g_t_tf) / (1.0 - alpha)
            _, (dx, dy, ca, cb, cc, e, raw, live) = _block_alpha(rows, gx, gy, alpha_min,
                                                                 alpha_max)
            hit = _tile_hit(rows, tx0, ty0, tile)[:, :, None, :]
            pass_th = (live & (raw <= alpha_max) & hit).to(alpha.dtype)
            dop = dalpha * e * pass_th
            dpow = dalpha * raw * pass_th
            red = lambda v: (v.sum(2) * ran).sum(1)  # over pixels, then fine tiles
            grad[c0:c0 + step, 0:10, b0:b0 + kb] = torch.stack([
                red(dpow * (-ca * dx - cb * dy)), red(dpow * (-cc * dy - cb * dx)),
                red(dpow * (-0.5 * dx * dx)), red(dpow * (-dx * dy)),
                red(dpow * (-0.5 * dy * dy)), red(dop),
                red(w * gr), red(w * gg), red(w * gb), red(w * gd)], dim=1)
            s = s + suffix[..., :1]  # zero where the block did not run
    return grad


# ---------------------------------------------------------------------------
# Kernel H: CUDA wrappers


@functools.lru_cache(maxsize=None)
def _h_fns():
    lib = _build.library("composite_coarse")
    fwd, bwd = lib.composite_coarse_fwd, lib.composite_coarse_bwd
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_f32(name: str, tensors, tile: int, kernel: str) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: need contiguous float32 tensors on one device, got "
                             f"{t.dtype} on {t.device} (contiguous {t.is_contiguous()})")
    if tile != 16:
        raise ValueError(f"{name}: kernel {kernel} composites 16x16 fine tiles, got tile={tile}")


def _check_h(name: str, tensors, kc: int, tile: int) -> None:
    _check_f32(name, tensors, tile, "H")
    if kc > 4 * _KB or (kc > _KB and kc % _KB):
        raise ValueError(f"{name}: kc={kc} must be <= 128, or a multiple of 128 up to 512")


def composite_coarse(fields: torch.Tensor, corig: torch.Tensor, cs: int = 4,
                     tile: int = 16, alpha_min: float = 1.0 / 255.0,
                     alpha_max: float = 0.99) -> torch.Tensor:
    """Kernel H forward: planes (n_ct, cs², 8, 256). CPU tensors take the
    plain version."""
    if fields.device.type == "cpu":
        return _composite_coarse_plain(fields, corig, cs, tile, alpha_min, alpha_max)
    n_ct, nf, kc = fields.shape
    if nf != NFIELD or corig.shape != (n_ct, 2):
        raise ValueError(f"composite_coarse: fields {tuple(fields.shape)} corig "
                         f"{tuple(corig.shape)}")
    _check_h("composite_coarse", (fields, corig), kc, tile)
    out = torch.empty((n_ct, cs * cs, 8, tile * tile), dtype=torch.float32,
                      device=fields.device)
    fwd, _ = _h_fns()
    _build.check("composite_coarse", fwd(corig.data_ptr(), fields.data_ptr(), out.data_ptr(),
                                         n_ct, kc, cs, alpha_min, alpha_max,
                                         _build.stream_ptr(fields.device)))
    _build.LAUNCHES["composite_coarse_fwd", (n_ct, kc, cs)] += 1
    return out


_H_BWD_CTAS = 512  # two waves of kernel H backward's CTA slots on an H100 (132 SMs x 2)


def coarse_bwd_ranks(n_ct: int, cs: int) -> int:
    """CTAs of the thread-block cluster that serves one coarse tile in
    kernel H's backward (each takes every ranks-th fine tile): the fewest,
    a power of two, that give the grid at least ``_H_BWD_CTAS`` CTAs, and
    at most cs² and 16 (the non-portable cluster size). More ranks than
    that cost more than they gain: each waits at the cluster barrier for
    its slowest fine tile (PERF.md §6)."""
    ranks = 1
    while n_ct * ranks < _H_BWD_CTAS and 2 * ranks <= min(cs * cs, 16):
        ranks *= 2
    return ranks


def composite_coarse_bwd(fields: torch.Tensor, corig: torch.Tensor, cot: torch.Tensor,
                         cs: int = 4, tile: int = 16, alpha_min: float = 1.0 / 255.0,
                         alpha_max: float = 0.99) -> torch.Tensor:
    """Kernel H backward: grad fields (n_ct, 12, kc), rows 10-11 zero. CPU
    tensors take the plain version."""
    if fields.device.type == "cpu":
        return _composite_coarse_bwd_plain(fields, corig, cot, cs, tile, alpha_min, alpha_max)
    n_ct, nf, kc = fields.shape
    if nf != NFIELD or corig.shape != (n_ct, 2) or \
            cot.shape != (n_ct, cs * cs, 8, tile * tile):
        raise ValueError(f"composite_coarse_bwd: fields {tuple(fields.shape)} corig "
                         f"{tuple(corig.shape)} cot {tuple(cot.shape)}")
    _check_h("composite_coarse_bwd", (fields, corig, cot), kc, tile)
    grad = torch.empty_like(fields)
    _, bwd = _h_fns()
    _build.check("composite_coarse", bwd(corig.data_ptr(), fields.data_ptr(), cot.data_ptr(),
                                         grad.data_ptr(), n_ct, kc, cs, coarse_bwd_ranks(n_ct, cs),
                                         alpha_min, alpha_max, _build.stream_ptr(fields.device)))
    _build.LAUNCHES["composite_coarse_bwd", (n_ct, kc, cs)] += 1
    return grad


class CompositeCoarseFn(torch.autograd.Function):
    """Kernel H forward and backward around the field layout. Whether the
    kernel or the plain version runs is fixed at forward time (autograd runs
    a CUDA backward in its own thread, outside a ``plain_ops`` scope). The
    origins get no gradient, nor do the ``ok`` and radius rows."""

    @staticmethod
    def forward(ctx, fields, corig, cs, tile, alpha_min, alpha_max):
        ctx.kernel = routing.kernels_enabled(fields.device)
        ctx.args = (cs, tile, alpha_min, alpha_max)
        ctx.save_for_backward(fields, corig)
        if ctx.kernel:
            return composite_coarse(fields, corig, *ctx.args)
        return _composite_coarse_plain(fields, corig, *ctx.args)

    @staticmethod
    @trace.spanned("rasterize.composite_bwd")
    def backward(ctx, g):
        fields, corig = ctx.saved_tensors
        g = g.contiguous()
        if ctx.kernel:
            grad = composite_coarse_bwd(fields, corig, g, *ctx.args)
        else:
            grad = _composite_coarse_bwd_plain(fields, corig, g, *ctx.args)
        return grad, None, None, None, None, None


# ---------------------------------------------------------------------------
# Kernel G: the fields route's compositor (plain versions and CUDA wrappers)

_G_MAX_K = 1024  # the kernel's shared-memory budget


def _composite_fields_plain(fields: torch.Tensor, origins: torch.Tensor, tile: int = 16,
                            alpha_min: float = 1.0 / 255.0, alpha_max: float = 0.99,
                            count_pairs: bool = False):
    """Kernel G's forward in torch ops (``composite_fields_pallas``), chunked
    over tiles: fields (T, 12, K), origins (T, 2) → planes (T, 8, tile²)
    ``[r, g, b, alpha, depth, T_final, 0, 0]``; every candidate composited
    front to back, no early stop and no tile gate. With ``count_pairs``,
    also (pairs, live pairs): every (pixel, candidate) pair, and those with
    a live alpha."""
    n, _, k = fields.shape
    kb = min(k, _KB)
    px = tile * tile
    out = fields.new_zeros((n, 8, px))
    live_pairs = 0
    step = _chunk(1, tile, kb)
    for c0 in range(0, n, step):
        f = fields[c0:c0 + step]
        _, _, gx, gy = _pixel_grid(origins[c0:c0 + step], tile, 1)  # (C, 1, PX)
        t = torch.ones_like(gx)
        rgbd = gx.new_zeros(gx.shape + (4,))
        acc = torch.zeros_like(gx)
        for b0 in range(0, k, kb):
            rows = f[:, :, b0:b0 + kb]
            alpha, _ = _block_alpha(rows, gx, gy, alpha_min, alpha_max)
            if count_pairs:
                live_pairs += int((alpha > 0).sum())
            excl, tot = _excl_prod(alpha)
            w = alpha * excl * t[..., None]
            rgbd = rgbd + torch.einsum("clpk,cfk->clpf", w, rows[:, 6:10])
            acc = acc + w.sum(-1)
            t = t * tot
        o = out[c0:c0 + step]
        o[:, 0:3] = rgbd[:, 0, :, 0:3].transpose(-1, -2)
        o[:, 3] = acc[:, 0]
        o[:, 4] = rgbd[:, 0, :, 3]
        o[:, 5] = t[:, 0]
    return (out, n * px * k, live_pairs) if count_pairs else out


def _composite_fields_bwd_plain(fields: torch.Tensor, origins: torch.Tensor,
                                cot: torch.Tensor, tile: int = 16,
                                alpha_min: float = 1.0 / 255.0,
                                alpha_max: float = 0.99) -> torch.Tensor:
    """Kernel G's backward in torch ops (``composite_fields_pallas_bwd``'s
    hand-derived formulas): cot (T, 8, tile²) → grad fields (T, 12, K),
    rows 10-11 zero. ``dalpha = dw·T_k − (S_k + g_T·T_final) / (1 − alpha)``
    with S_k the suffix sum of dw·w behind candidate k; the gradient passes
    the 0.99 clamp only where ``raw ≤ 0.99``."""
    n, _, k = fields.shape
    kb = min(k, _KB)
    grad = torch.zeros_like(fields)
    step = _chunk(1, tile, kb)
    for c0 in range(0, n, step):
        f = fields[c0:c0 + step]
        _, _, gx, gy = _pixel_grid(origins[c0:c0 + step], tile, 1)  # (C, 1, PX)
        # pass 1: forward recompute of alpha and T before each candidate
        t = torch.ones_like(gx)
        alphas, tks = [], []
        for b0 in range(0, k, kb):
            alpha, _ = _block_alpha(f[:, :, b0:b0 + kb], gx, gy, alpha_min, alpha_max)
            excl, tot = _excl_prod(alpha)
            alphas.append(alpha)
            tks.append(excl * t[..., None])
            t = t * tot
        c = cot[c0:c0 + step, None]
        gr, gg, gb, ga, gd, g_t = (c[:, :, i, :, None] for i in range(6))
        g_t_tf = g_t * t[..., None]
        # pass 2: blocks back to front, suffix sums of dw * w
        s = torch.zeros_like(gx)[..., None]
        for bi in reversed(range(len(alphas))):
            b0 = bi * kb
            rows = f[:, :, b0:b0 + kb]
            alpha, t_k = alphas[bi], tks[bi]
            w = alpha * t_k
            r = lambda i: rows[:, None, None, i]
            dw = gr * r(6) + gg * r(7) + gb * r(8) + gd * r(9) + ga
            dww = dw * w
            suffix = torch.flip(torch.cumsum(torch.flip(dww, (-1,)), -1), (-1,))
            s_k = suffix - dww + s
            dalpha = dw * t_k - (s_k + g_t_tf) / (1.0 - alpha)
            _, (dx, dy, ca, cb, cc, e, raw, live) = _block_alpha(rows, gx, gy, alpha_min,
                                                                 alpha_max)
            pass_th = (live & (raw <= alpha_max)).to(alpha.dtype)
            dop = dalpha * e * pass_th
            dpow = dalpha * raw * pass_th
            red = lambda v: v.sum(2).sum(1)  # over pixels (one tile)
            grad[c0:c0 + step, 0:10, b0:b0 + kb] = torch.stack([
                red(dpow * (-ca * dx - cb * dy)), red(dpow * (-cc * dy - cb * dx)),
                red(dpow * (-0.5 * dx * dx)), red(dpow * (-dx * dy)),
                red(dpow * (-0.5 * dy * dy)), red(dop),
                red(w * gr), red(w * gg), red(w * gb), red(w * gd)], dim=1)
            s = s + suffix[..., :1]
    return grad


_SKIP_MARGIN = 1e-3  # composite_common.cuh's SKIP_MARGIN


def _fields_tile_dead(fields: torch.Tensor, origins: torch.Tensor, tile: int = 16,
                      alpha_min: float = 1.0 / 255.0, strip: Optional[int] = None,
                      block: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The cull of kernel G (``rect_dead`` in ``csrc/composite_common.cuh``)
    in torch ops: True where the candidate's alpha is provably under
    ``alpha_min`` at every pixel centre of its tile, (T, K), or with
    ``block`` (bw, bh) of each bw x bh pixel block of it, blocks in
    row-major order, (T, tile² // (bw bh), K); ``strip`` s is the block
    (tile, s): at 2 the 16 x 2 pixels of each warp of both directions. Not
    ok; opacity under alpha_min; or a positive-definite conic whose power
    bound -1/2 lambda_min dist² over the rectangle, plus 1e-5 of the terms'
    magnitudes for rounding, lies under log(alpha_min / opacity) less the
    margin. The kernels walk only the others. Used by the tests and to
    report the culled shares; the kernels do not call it."""
    if strip is not None:
        block = (tile, strip)
    bw, bh = (tile, tile) if block is None else block
    nx, nb = tile // bw, (tile // bw) * (tile // bh)
    f = fields.double()[:, :, None, :]  # (T, 12, 1, K)
    x, y, a, b, c = (f[:, i] for i in range(5))
    o = fields[:, None, 5]
    ok = fields[:, None, 10] > 0
    if not alpha_min > 0:
        dead = ~ok.expand(-1, nb, -1)
        return dead[:, 0] if block is None else dead
    det = a * c - b * b
    pd = (a > 0) & (c > 0) & (det > 0)
    lmax = 0.5 * (a + c) + torch.sqrt(0.25 * (a - c) ** 2 + b * b)
    lmin = det / lmax * (1.0 - 1e-9)
    blk = torch.arange(nb, dtype=torch.float64, device=fields.device)[:, None]
    x0 = origins[:, 0, None, None].double() + bw * torch.remainder(blk, nx)
    y0 = origins[:, 1, None, None].double() + bh * torch.div(blk, nx, rounding_mode="floor")
    dx0, dx1 = x - (x0 + bw - 1), x - x0
    dy0, dy1 = y - (y0 + bh - 1), y - y0
    zero = torch.zeros_like(dy0)
    ex = torch.where(dx0 > 0, dx0, torch.where(dx1 < 0, -dx1, zero))
    ey = torch.where(dy0 > 0, dy0, torch.where(dy1 < 0, -dy1, zero))
    mx, my = torch.maximum(dx0.abs(), dx1.abs()), torch.maximum(dy0.abs(), dy1.abs())
    err = 1e-5 * (a * mx * mx + c * my * my + 2.0 * b.abs() * mx * my)
    pmax = -0.5 * lmin * (ex * ex + ey * ey) + err
    thr = torch.log(alpha_min / o).double() - _SKIP_MARGIN
    dead = ~ok | (o < alpha_min) | (pd & (pmax < thr))
    return dead[:, 0] if block is None else dead


@functools.lru_cache(maxsize=None)
def _g_fns():
    lib = _build.library("composite_fields")
    fwd, bwd = lib.composite_fields_fwd, lib.composite_fields_bwd
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check_g(name: str, tensors, k: int, tile: int) -> None:
    _check_f32(name, tensors, tile, "G")
    if k > _G_MAX_K or (k > _KB and k % _KB):
        raise ValueError(f"{name}: K={k} must be <= 128, or a multiple of 128 up to "
                         f"{_G_MAX_K}")


def composite_fields(fields: torch.Tensor, origins: torch.Tensor, tile: int = 16,
                     alpha_min: float = 1.0 / 255.0, alpha_max: float = 0.99) -> torch.Tensor:
    """Kernel G forward: planes (T, 8, 256). CPU tensors take the plain
    version."""
    if fields.device.type == "cpu":
        return _composite_fields_plain(fields, origins, tile, alpha_min, alpha_max)
    t, nf, k = fields.shape
    if nf != NFIELD or origins.shape != (t, 2):
        raise ValueError(f"composite_fields: fields {tuple(fields.shape)} origins "
                         f"{tuple(origins.shape)}")
    _check_g("composite_fields", (fields, origins), k, tile)
    out = torch.empty((t, 8, tile * tile), dtype=torch.float32, device=fields.device)
    fwd, _ = _g_fns()
    _build.check("composite_fields", fwd(origins.data_ptr(), fields.data_ptr(), out.data_ptr(),
                                         t, k, alpha_min, alpha_max,
                                         _build.stream_ptr(fields.device)))
    _build.LAUNCHES["composite_fields_fwd", (t, k)] += 1
    return out


def composite_fields_bwd(fields: torch.Tensor, origins: torch.Tensor, cot: torch.Tensor,
                         tile: int = 16, alpha_min: float = 1.0 / 255.0,
                         alpha_max: float = 0.99) -> torch.Tensor:
    """Kernel G backward: grad fields (T, 12, K), rows 10-11 zero. CPU
    tensors take the plain version."""
    if fields.device.type == "cpu":
        return _composite_fields_bwd_plain(fields, origins, cot, tile, alpha_min, alpha_max)
    t, nf, k = fields.shape
    if nf != NFIELD or origins.shape != (t, 2) or cot.shape != (t, 8, tile * tile):
        raise ValueError(f"composite_fields_bwd: fields {tuple(fields.shape)} origins "
                         f"{tuple(origins.shape)} cot {tuple(cot.shape)}")
    _check_g("composite_fields_bwd", (fields, origins, cot), k, tile)
    grad = torch.empty_like(fields)
    _, bwd = _g_fns()
    _build.check("composite_fields", bwd(origins.data_ptr(), fields.data_ptr(), cot.data_ptr(),
                                         grad.data_ptr(), t, k, alpha_min, alpha_max,
                                         _build.stream_ptr(fields.device)))
    _build.LAUNCHES["composite_fields_bwd", (t, k)] += 1
    return grad


class CompositeFieldsFn(torch.autograd.Function):
    """Kernel G forward and backward around the (T, 12, K) field layout, the
    kernel or the plain versions fixed at forward time as in
    :class:`CompositeCoarseFn`. The origins get no gradient, nor do the
    ``ok`` and zero rows."""

    @staticmethod
    def forward(ctx, fields, origins, tile, alpha_min, alpha_max):
        ctx.kernel = routing.kernels_enabled(fields.device)
        ctx.args = (tile, alpha_min, alpha_max)
        ctx.save_for_backward(fields, origins)
        if ctx.kernel:
            return composite_fields(fields, origins, *ctx.args)
        return _composite_fields_plain(fields, origins, *ctx.args)

    @staticmethod
    @trace.spanned("rasterize.composite_bwd")
    def backward(ctx, g):
        fields, origins = ctx.saved_tensors
        g = g.contiguous()
        if ctx.kernel:
            grad = composite_fields_bwd(fields, origins, g, *ctx.args)
        else:
            grad = _composite_fields_bwd_plain(fields, origins, g, *ctx.args)
        return grad, None, None, None, None


# ---------------------------------------------------------------------------


class RenderOutput(NamedTuple):
    rgb: torch.Tensor  # (B, H, W, 3)
    depth: torch.Tensor  # (B, H, W)
    alpha: torch.Tensor  # (B, H, W)
    overflow: torch.Tensor  # () int: gaussian x tile pairs past the route's caps


def _colors(means3d, camera, shs, colors_precomp, active_sh_degree):
    b, n = means3d.shape[:2]
    if colors_precomp is not None:
        return colors_precomp.expand(b, n, 3)
    if shs is None:
        raise ValueError("need shs or colors_precomp")
    dirs = means3d - camera.camera_center[:, None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-9)
    return sh_color(active_sh_degree, shs, dirs)


@trace.spanned("rasterize.project")
def _project(means3d, scales, rotations, opacity, camera, cfg, shs, colors_precomp,
             scale_modifier, active_sh_degree):
    """→ (projection, colors (B, N, 3), opacity (B, N)) of B views."""
    b, n = means3d.shape[:2]
    proj = project_gaussians(means3d, build_cov3d(scales, rotations, scale_modifier), camera,
                             cfg)
    colors = _colors(means3d, camera, shs, colors_precomp, active_sh_degree)
    return proj, colors, opacity.reshape(-1, n).expand(b, n)


def _gather_fields(proj: Projected, colors, opacity, idx, ok, row11=None) -> torch.Tensor:
    """Candidate fields (B, M, 12, K) of the (B, M, K) lists ``idx``: rows 0-9
    gathered (x, y, conic a b c, opacity, rgb, depth; differentiable), row 10
    ``ok``, row 11 gathered from ``row11`` (B, N) or zero."""
    b, m, k = idx.shape
    rows10 = torch.stack([proj.mean2d[..., 0], proj.mean2d[..., 1], proj.conic[..., 0],
                          proj.conic[..., 1], proj.conic[..., 2], opacity, colors[..., 0],
                          colors[..., 1], colors[..., 2], proj.depth], dim=1)  # (B, 10, N)
    flat = idx.reshape(b, 1, m * k)
    cand = torch.gather(rows10, 2, flat.expand(b, 10, -1)).reshape(b, 10, m, k)
    last = (torch.zeros_like(cand[:, :1]) if row11 is None
            else torch.gather(row11, 1, flat[:, 0]).reshape(b, 1, m, k))
    fields = torch.cat([cand, ok.to(cand.dtype)[:, None], last], dim=1)  # (B, 12, M, K)
    return fields.permute(0, 2, 1, 3)


def pack_fields(proj: Projected, colors: torch.Tensor, opacity: torch.Tensor,
                idx: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """The fields route's per-tile candidate fields (``rasterize_pallas.py:
    543-560``): (B, T, K) lists → (B·T, 12, K), rows 0-9 differentiable, row
    10 ``ok``, row 11 zero (G has no AABB gate)."""
    b, t, k = idx.shape
    return _gather_fields(proj, colors, opacity, idx, ok).reshape(b * t, NFIELD, k).contiguous()


def coarse_fields(means3d: torch.Tensor, scales: torch.Tensor, rotations: torch.Tensor,
                  opacity: torch.Tensor, camera: GSCameraArrays, cfg: RasterConfig,
                  shs: Optional[torch.Tensor] = None,
                  colors_precomp: Optional[torch.Tensor] = None, scale_modifier: float = 1.0,
                  active_sh_degree: int = 0):
    """Projection, binning and field assembly of B views on the
    coarse-direct route (``:595-623``): → (fields (B·n_ct, 12, kc) with kc
    padded to a multiple of 128, coarse origins (B·n_ct, 2), projection,
    overflow count). Rows 0-9 are differentiable (gathered by the binning's
    indices); ``ok`` and the 3-sigma radius are not."""
    b = means3d.shape[0]
    proj, colors, opacity = _project(means3d, scales, rotations, opacity, camera, cfg, shs,
                                     colors_precomp, scale_modifier, active_sh_degree)
    cidx, cok, c_count, corig = _coarse_select(proj, cfg)
    n_ctv, kc = cidx.shape[1:]
    fields = _gather_fields(proj, colors, opacity, cidx, cok, proj.radius.detach())
    pad = (-kc) % _KB
    if pad:
        fields = torch.nn.functional.pad(fields, (0, pad))
    fields = fields.reshape(b * n_ctv, NFIELD, kc + pad).contiguous()
    overflow = torch.clamp(c_count - kc, min=0).sum()
    return fields, corig.repeat(b, 1).contiguous(), proj, overflow


def tile_fields(means3d: torch.Tensor, scales: torch.Tensor, rotations: torch.Tensor,
                opacity: torch.Tensor, camera: GSCameraArrays, cfg: RasterConfig,
                shs: Optional[torch.Tensor] = None,
                colors_precomp: Optional[torch.Tensor] = None, scale_modifier: float = 1.0,
                active_sh_degree: int = 0):
    """Projection, binning and field assembly of B views on the fields
    route (``:636-650``): → (fields (B·T, 12, K = max_per_tile), tile
    origins (B·T, 2), projection, overflow count)."""
    b = means3d.shape[0]
    proj, colors, opacity = _project(means3d, scales, rotations, opacity, camera, cfg, shs,
                                     colors_precomp, scale_modifier, active_sh_degree)
    idx, ok, overflow = _tile_select(proj, cfg)
    fields = pack_fields(proj, colors, opacity, idx, ok)
    return fields, _tile_origins(cfg, idx.device).repeat(b, 1), proj, overflow


def _untile(p: torch.Tensor, cfg: RasterConfig, bg: torch.Tensor):
    """Per-tile planes (B, tiles_y, tiles_x, >= 6, tile, tile) → (rgb (B, H, W,
    3) with T_final times the background added, depth, alpha)."""
    b, t = p.shape[0], cfg.tile

    def plane(ch):  # (B, ty, tx, t, t) → (B, H, W)
        a = p[:, :, :, ch].permute(0, 1, 3, 2, 4)
        a = a.reshape(b, cfg.tiles_y * t, cfg.tiles_x * t)
        return a[:, :cfg.height, :cfg.width]

    t_final = plane(5)
    rgb = torch.stack([plane(i) for i in range(3)], dim=-1) + t_final[..., None] * bg
    return rgb, plane(4), plane(3)


def rasterize(means3d: torch.Tensor, scales: torch.Tensor, rotations: torch.Tensor,
              opacity: torch.Tensor, camera: GSCameraArrays, cfg: RasterConfig,
              shs: Optional[torch.Tensor] = None,
              colors_precomp: Optional[torch.Tensor] = None,
              bg: Optional[torch.Tensor] = None, scale_modifier: float = 1.0,
              active_sh_degree: int = 0) -> RenderOutput:
    """Render B views: means3d / scales (B, N, 3), rotations (B, N, 4),
    opacity (N,) or (B, N), cameras with B leading; ``shs`` (N, K, 3) or
    ``colors_precomp`` (N, 3) / (B, N, 3). Differentiable in every gaussian
    input. The JAX package's ``rasterize(..., backend="pallas")`` of each
    view: kernel G on an image of at most ``coarse``² tiles (or with
    ``coarse`` 0), kernel H on any other."""
    b = means3d.shape[0]
    if bg is None:
        bg = torch.ones(3, device=means3d.device)
    fields_route = cfg.coarse <= 0 or cfg.tiles_x * cfg.tiles_y <= cfg.coarse ** 2
    args = (means3d, scales, rotations, opacity, camera, cfg, shs, colors_precomp,
            scale_modifier, active_sh_degree)
    t = cfg.tile
    if fields_route:
        fields, origins, _, overflow = tile_fields(*args)
        with trace.span("rasterize.composite"):
            planes = CompositeFieldsFn.apply(fields, origins, t, cfg.alpha_min, cfg.alpha_max)
        p = planes.reshape(b, cfg.tiles_y, cfg.tiles_x, 8, t, t)
    else:
        fields, corig, _, overflow = coarse_fields(*args)
        with trace.span("rasterize.composite"):
            planes = CompositeCoarseFn.apply(fields, corig, cfg.coarse, t, cfg.alpha_min,
                                             cfg.alpha_max)
        cs, cty, ctx = _coarse_grid(cfg)
        p = planes.reshape(b, cty, ctx, cs, cs, 8, t, t).permute(0, 1, 3, 2, 4, 5, 6, 7)
        p = p.reshape(b, cty * cs, ctx * cs, 8, t, t)[:, :cfg.tiles_y, :cfg.tiles_x]
    rgb, depth, alpha = _untile(p, cfg, bg)
    return RenderOutput(rgb=rgb, depth=depth, alpha=alpha, overflow=overflow)
