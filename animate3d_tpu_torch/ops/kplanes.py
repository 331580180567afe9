"""Kernel I: the K-planes sampler on the card (``csrc/kplanes.cu``), bound
by ctypes, forward and backward.

:func:`sample_frames` computes, for every point ``xyz`` (N, 3) at every time
``ts`` (F,), what ``gaussians/kplanes.py::interpolate_ms_features`` gives at
``cat(xyz, t)``: (F, N, C · scales), bitwise equal to it. The backward gives
the planes' gradients (f32 atomics, in an order that changes from run to
run); the points and times get none, and the call raises where one would be
asked. The plain version is the gather in ``gaussians/kplanes.py``; the JAX
package has no kernel here (the source's note says why this one exists).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from animate3d_tpu_torch.ops import _build

MAX_SCALES = 4  # the kernel's plane table
# a backward block's shared memory (SMEM_MAX in csrc/kplanes.cu), which holds
# a scale's three time planes' rows at 20 bytes a cell (4 channels + 1 of padding)
SHARED_MAX, CELL_BYTES = 232448, 20
# the kernel's plane order (kC0, kC1 in csrc/kplanes.cu): gaussians/kplanes.py's COO_COMBS
_AXES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _fns():
    lib = _build.library("kplanes")
    fwd, bwd = lib.kplanes_fwd, lib.kplanes_bwd
    vp, i, ints = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fwd.argtypes = [ctypes.POINTER(ctypes.c_longlong), ints, i, i, vp, vp, i, i, vp, vp, vp]
    bwd.argtypes = [vp, ints, i, i, vp, vp, vp, i, i, vp, vp, vp]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _geometry(grids: Sequence[Sequence[torch.Tensor]]) -> Tuple[int, List[int], List[tuple]]:
    """(C, reso as scales x (x, y, z, t), each plane's (C, H, W)), checking
    that the planes are the K-planes layout the kernel reads."""
    c = grids[0][0].shape[0]
    reso, shapes = [], []
    for planes in grids:
        if len(planes) != len(_AXES):
            raise ValueError(f"kplanes: {len(planes)} planes a scale, need {len(_AXES)}")
        r = [0] * 4
        for (c0, c1), p in zip(_AXES, planes):
            r[c0], r[c1] = p.shape[2], p.shape[1]
        for (c0, c1), p in zip(_AXES, planes):
            if tuple(p.shape) != (c, r[c1], r[c0]):
                raise ValueError(f"kplanes: plane {tuple(p.shape)} does not fit the scale's "
                                 f"resolution {r} at {c} channels")
            shapes.append(tuple(p.shape))
        reso += r
    return c, reso, shapes


def _check(name: str, tensors, align: int = 4) -> None:
    """Contiguous f32 on one device, each ``align``-byte aligned (the kernel
    reads the planes and the gradient 16 bytes at a time)."""
    dev = tensors[0].device
    for t in tensors:
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != dev
                or t.data_ptr() % align):
            raise ValueError(f"{name}: need contiguous {align}-byte aligned float32 tensors on "
                             f"one device, got {t.dtype} on {t.device} (contiguous "
                             f"{t.is_contiguous()})")


class SampleFramesFn(torch.autograd.Function):
    """Kernel I forward and backward. ``planes`` are the scales' six planes
    each, flattened scale-major; the forward keeps its channels-last copy
    of them for the backward."""

    @staticmethod
    def forward(ctx, xyz, ts, c, reso, shapes, *planes):
        n, f = xyz.shape[0], ts.shape[0]
        scales = len(planes) // len(_AXES)
        packed = torch.empty(sum(p.numel() for p in planes), dtype=torch.float32,
                             device=xyz.device)
        out = torch.empty((f, n, c * scales), dtype=torch.float32, device=xyz.device)
        fwd, _ = _fns()
        ptrs = (ctypes.c_longlong * len(planes))(*[p.data_ptr() for p in planes])
        _build.check("kplanes", fwd(ptrs, (ctypes.c_int * len(reso))(*reso), scales, c,
                                    xyz.data_ptr(), ts.data_ptr(), n, f, packed.data_ptr(),
                                    out.data_ptr(), _build.stream_ptr(xyz.device)))
        _build.LAUNCHES["kplanes_fwd", (f, n, scales)] += 1
        ctx.save_for_backward(xyz, ts, packed)
        ctx.geom = (c, reso, shapes)
        return out

    @staticmethod
    def backward(ctx, gout):
        xyz, ts, packed = ctx.saved_tensors
        c, reso, shapes = ctx.geom
        gout = gout.contiguous()
        _check("kplanes_bwd", (gout,), 16)
        n, f, scales = xyz.shape[0], ts.shape[0], len(shapes) // len(_AXES)
        scratch, grad = torch.empty_like(packed), torch.empty_like(packed)
        _, bwd = _fns()
        _build.check("kplanes", bwd(packed.data_ptr(), (ctypes.c_int * len(reso))(*reso),
                                    scales, c, xyz.data_ptr(), ts.data_ptr(), gout.data_ptr(),
                                    n, f, scratch.data_ptr(), grad.data_ptr(),
                                    _build.stream_ptr(xyz.device)))
        _build.LAUNCHES["kplanes_bwd", (f, n, scales)] += 1
        sizes = [a * b * d for a, b, d in shapes]
        grads = [g.view(shape) for g, shape in zip(grad.split(sizes), shapes)]
        return (None, None, None, None, None, *grads)


def sample_frames(xyz: torch.Tensor, ts: torch.Tensor,
                  grids: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """Kernel I: (F, N, C · scales) features of the points ``xyz`` (N, 3) at
    the times ``ts`` (F,) from ``grids`` (per scale, the six (C, H, W)
    planes in ``COO_COMBS`` order), all f32 on one CUDA device; C a multiple
    of 4, at most 4 scales, each scale's time rows T (R_x + R_y + R_z)
    within a block's shared memory. Raises where a gradient of ``xyz`` or
    ``ts`` would be asked: the kernel gives none."""
    if torch.is_grad_enabled() and (xyz.requires_grad or ts.requires_grad):
        raise ValueError("kplanes: kernel I gives no gradient to the points or times; "
                         "xyz and ts must not require grad")
    planes = [p for scale in grids for p in scale]
    if not 1 <= len(grids) <= MAX_SCALES:
        raise ValueError(f"kplanes: {len(grids)} scales, kernel I takes 1 to {MAX_SCALES}")
    c, reso, shapes = _geometry(grids)
    if c % 4:
        raise ValueError(f"kplanes: {c} channels, kernel I takes a multiple of 4")
    rows = max(reso[i + 3] * sum(reso[i:i + 3]) for i in range(0, len(reso), 4))
    if rows * CELL_BYTES > SHARED_MAX:
        raise ValueError(f"kplanes: the time planes' rows need {rows * CELL_BYTES} bytes of a "
                         f"block's shared memory, kernel I has {SHARED_MAX}")
    if xyz.dim() != 2 or xyz.shape[1] != 3 or ts.dim() != 1:
        raise ValueError(f"kplanes: xyz {tuple(xyz.shape)} must be (N, 3), ts "
                         f"{tuple(ts.shape)} (F,)")
    xyz, ts = xyz.contiguous(), ts.contiguous()
    _check("kplanes", (xyz, ts, *planes))
    _check("kplanes", planes, 16)
    return SampleFramesFn.apply(xyz, ts, c, reso, shapes, *planes)
