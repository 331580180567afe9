"""GEGLU feed-forward: CUDA kernel C (``csrc/geglu.cu``) + plain torch path.

Kernel C is two launches of one persistent, warp-specialised TMA + wgmma
GEMM for Hopper: the gated launch writes the (M, I) bf16 hidden, the second
adds b2. It takes any M >= 1 and C, I that are multiples of 64
(:func:`check_kernel_shape`); it raises elsewhere.

Port of ``animate3d_tpu/ops/geglu.py``. Weights are in torch Linear layout:
``w1`` (2I, C) whose first I rows are the hidden half and last I rows the
gate half, ``w2`` (C, I). ``y = ((x w1h^T + b1h) * gelu(x w1g^T + b1g))
w2^T + b2`` with the exact (erf) GELU.

:class:`GegluFn` runs kernel C forward; its backward is the autograd of
:func:`_geglu_reference` (all math in the model dtype), as the JAX
package's VJP is the XLA autograd of its reference expression: there is no
backward kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from animate3d_tpu_torch.ops import _build, routing

_BI = 640  # the TPU route's inner-dim block; inner % 640 == 0 takes the kernel
_BM = 256  # ... and at least one row block of rows


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * (2.0 ** -0.5)))


def _geglu_plain(x, w1, b1, w2, b2):
    """Plain version of kernel C with its rounding points: f32 products and
    gate, the hidden rounded once to the input dtype, f32 second product."""
    f32 = torch.float32
    p = torch.nn.functional.linear(x.to(f32), w1.to(f32), b1.to(f32))
    h, g = p.chunk(2, dim=-1)
    hidden = (h * gelu_exact(g)).to(x.dtype)
    y = torch.nn.functional.linear(hidden.to(f32), w2.to(f32), b2.to(f32))
    return y.to(x.dtype)


def _geglu_reference(x, w1, b1, w2, b2):
    """The JAX package's ``_geglu_reference``: every product, bias add and
    the gate in the input dtype (no f32 rounding points)."""
    p = torch.matmul(x, w1.t()) + b1
    h, g = p.chunk(2, dim=-1)
    return torch.matmul(h * gelu_exact(g), w2.t()) + b2


@functools.lru_cache(maxsize=None)
def _geglu_fns():
    lib = _build.library("geglu")
    fns = (lib.geglu_hidden, lib.geglu_out)
    for fn in fns:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def check_kernel_shape(channels: int, inner: int) -> None:
    """Raise unless kernel C takes (C, I): both multiples of 64, the depth of
    one 128-byte swizzled TMA box and the width of its output tiles' 16-byte
    stores."""
    if channels % 64 or inner % 64 or channels <= 0 or inner <= 0:
        raise ValueError(f"geglu: C={channels} and I={inner} must be positive multiples of 64")


def geglu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
          w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Kernel C on x (M, C): the gated launch writes the (M, I) bf16 hidden,
    the second adds b2. CPU tensors take the plain version."""
    m, c = x.shape
    inner = w2.shape[1]
    if w1.shape != (2 * inner, c) or b1.shape != (2 * inner,) or \
            w2.shape != (c, inner) or b2.shape != (c,):
        raise ValueError(f"geglu: shapes x {tuple(x.shape)} w1 {tuple(w1.shape)} "
                         f"b1 {tuple(b1.shape)} w2 {tuple(w2.shape)} b2 {tuple(b2.shape)}")
    if x.device.type == "cpu":
        return _geglu_plain(x, w1, b1, w2, b2)
    for name, t in (("x", x), ("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"geglu {name}: need contiguous bfloat16 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    check_kernel_shape(c, inner)
    hidden = torch.empty((m, inner), dtype=x.dtype, device=x.device)
    y = torch.empty((m, c), dtype=x.dtype, device=x.device)
    stream = _build.stream_ptr(x.device)
    for fn, args in zip(_geglu_fns(), ((x, w1, b1, hidden), (hidden, w2, b2, y))):
        _build.check("geglu", fn(*(t.data_ptr() for t in args), m, c, inner, stream))
    _build.LAUNCHES["geglu", (m, c, inner)] += 1
    return y


class GegluFn(torch.autograd.Function):
    """Kernel C forward (its plain version for CPU tensors); the backward
    is the autograd of :func:`_geglu_reference` on the saved inputs, with
    the cotangent cast to the model dtype first."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return geglu(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            y = _geglu_reference(*inputs)
            wrt = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g.to(y.dtype)))
        return tuple(next(grads) if need else None for need in needs)


def geglu_plan(rows: int, channels: int, inner: int) -> bool:
    """Shape predicate of the TPU's ``geglu_ff`` route (inner % 640 == 0 and
    at least 256 rows), restricted to what kernel C takes (C % 64 == 0)."""
    return inner % _BI == 0 and rows >= _BM and channels % 64 == 0


def geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """GEGLU feed-forward over the last axis of ``x``: kernel C (through
    :class:`GegluFn`) on CUDA where :func:`geglu_plan` holds, the plain
    path, differentiated by autograd, elsewhere."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if routing.kernels_enabled(x.device) and geglu_plan(
            x2.shape[0], x2.shape[1], w2.shape[1]):
        y = GegluFn.apply(x2.contiguous(), w1, b1, w2, b2)
    else:
        y = _geglu_plain(x2, w1, b1, w2, b2)
    return y.reshape(lead + (w2.shape[0],))
