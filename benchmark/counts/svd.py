"""Least device seconds of one launch of the port's kernels at the Stable
Video Diffusion UNet's shapes, from the shape keys their launch counters
record (``ops/_build.py``'s ``LAUNCHES``), on the peaks of ``peaks.py``.
Kernel A's heads are 64 wide at every level (5, 10, 20 of them), so the
head count comes from the key's channels."""

from __future__ import annotations

from benchmark.counts.kernels import bound_s

HEAD_DIM = 64


def flash_fwd_d64(key) -> float:
    """Kernel A at ``(b, sq, sk, c, kv_group)`` with c / 64 heads: S = QKᵀ
    and PV (4·b·sq·sk·c), one ex2 a score, bf16 q / out and k / v, f32 lse."""
    b, sq, sk, c, kvg = key
    heads = c // HEAD_DIM
    nbytes = 2.0 * (2 * b * sq * c + 2 * (b // kvg) * sk * c) + 4.0 * b * heads * sq
    return bound_s(4.0 * b * sq * sk * c, nbytes, ex2=1.0 * b * heads * sq * sk)


def packed_padded(key) -> float:
    """Kernel B at ``(b, s, c)``, sequences of s tokens padded to 32 in
    shared memory: bytes only (q, k, v read and out written once, bf16; the
    padded rows are never read), 4·b·s·c·2 bytes."""
    b, s, c = key
    return bound_s(nbytes=8.0 * b * s * c)
