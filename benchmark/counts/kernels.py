"""Least device seconds of one launch of a port kernel, from the shape key
its launch counter records (``animate3d_tpu_torch/ops/_build.py``'s
``LAUNCHES``): the largest of tensor operations at the bf16 peak (f32
operations at the f32 peak for the compositor), ex2 at the SFU's rate and
bytes at the HBM rate. Each input byte is counted read once and each
output byte written once."""

from __future__ import annotations

from benchmark.counts.peaks import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_EX2, PEAK_F32_FLOPS


def bound_s(flops: float = 0.0, nbytes: float = 0.0, ex2: float = 0.0,
            f32_ops: float = 0.0) -> float:
    return max(flops / PEAK_BF16_FLOPS, ex2 / PEAK_EX2, nbytes / PEAK_BYTES,
               f32_ops / PEAK_F32_FLOPS)


def flash_fwd(key, heads: int) -> float:
    """Kernel A at ``(b, sq, sk, c, kv_group)``: S = QKᵀ and PV (4·b·sq·sk·c),
    one ex2 a score, bf16 q / out and k / v (shared by ``kv_group``
    batches), f32 lse."""
    b, sq, sk, c, kvg = key
    flops = 4.0 * b * sq * sk * c
    nbytes = 2.0 * (2 * b * sq * c + 2 * (b // kvg) * sk * c) + 4.0 * b * heads * sq
    return bound_s(flops, nbytes, ex2=1.0 * b * heads * sq * sk)


def flash_bwd(key, heads: int, dq: bool = True, dkv: bool = True) -> float:
    """Kernel D at ``(b, sq, sk, c, kv_group)``, one launch (its Delta, pass
    and casts) writing dq and / or dk, dv: the products it needs (S and dP
    always, dQ for dq, dV and dK for dk / dv; 2·b·sq·sk·c each), one ex2 a
    score; q, out, dout and k, v read and the gradients written in bf16,
    lse read in f32."""
    b, sq, sk, c, kvg = key
    products = 2 + int(dq) + 2 * int(dkv)
    flops = 2.0 * products * b * sq * sk * c
    kv = (b // kvg) * sk * c
    nbytes = (2.0 * (3 * b * sq * c + 2 * kv + (b * sq * c if dq else 0) + (2 * kv if dkv else 0))
              + 4.0 * b * heads * sq)
    return bound_s(flops, nbytes, ex2=1.0 * b * heads * sq * sk)


def geglu(key) -> float:
    """Kernel C at ``(m, c, inner)``: x·W1 (2·m·c·2I) and h·W2 (2·m·I·c);
    bf16 x, both weights and biases read, y written."""
    m, c, inner = key
    nbytes = 2.0 * (2 * m * c + 3 * inner * c + 2 * inner + c)
    return bound_s(6.0 * m * c * inner, nbytes)


def composite_coarse_fwd(key, tile: int = 16) -> float:
    """Kernel H forward at ``(n_ct, kc, cs)``: the 12 field rows of every
    candidate and the origins read, 8 planes of every pixel written, f32.
    Its operations depend on the data (the pairs its hit lists keep), so
    the bound counts bytes only: it is no larger than the kernel's true
    least time."""
    n, kc, cs = key
    return bound_s(nbytes=4.0 * (n * 12 * kc + 2 * n) + 4.0 * n * cs * cs * 8 * tile * tile)


def composite_coarse_bwd(key, tile: int = 16) -> float:
    """Kernel H backward at ``(n_ct, kc, cs)``: the field rows, origins and
    planes 0-5 of the cotangent read, the field gradient written (bytes
    only, as the forward)."""
    n, kc, cs = key
    nbytes = 4.0 * (n * 12 * kc + 2 * n) + 4.0 * (n * cs * cs * 6 * tile * tile + n * 12 * kc)
    return bound_s(nbytes=nbytes)
