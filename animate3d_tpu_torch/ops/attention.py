"""Multi-head attention for the MV-VDM: two CUDA kernels + plain torch paths.

Port of ``animate3d_tpu/ops/attention.py``. Public functions take merged
heads, q ``(B, Sq, H*D)`` and k/v ``(B', Sk, H*D)``, like the JAX module.

* :func:`flash_attention` — kernel A (``csrc/flash_fwd.cu``), the TPU's
  ``flash_attention_padded`` route (and its unpadded ``_flash_attention`` at
  160-wide heads). Returns ``(out, lse)``.
* :func:`packed_attention` — kernel B (``csrc/packed_attn.cu``), the TPU's
  ``packed_temporal_flash_padded`` route over many short sequences.
* :func:`flash_attention_bwd` — kernel D (``csrc/flash_bwd.cu``), the
  TPU's ``_flash_bwd_dq_kernel`` / ``_flash_bwd_dkv_kernel``.
* :func:`packed_attention_bwd` — kernel E (``csrc/packed_attn_bwd.cu``),
  the TPU's ``_packed_padded_bwd_kernel``.
* :func:`attention_xla` / :func:`packed_small_attention` — the plain
  versions (einsum + f32 softmax), kept under the JAX names; the plain
  backward versions are ``_flash_bwd_plain`` and ``_packed_bwd_plain``.

:func:`multi_head_attention` routes with the TPU's shape predicates, with
"on TPU" read as "on CUDA": see :func:`attention_plan`. A flash or packed
site runs through :class:`FlashAttentionFn` (A forward, D backward) or
:class:`PackedAttentionFn` (B forward, E backward); under
``routing.plain_ops()`` both directions take the kernels' plain versions.
:func:`attention_backend` forces a backend for the calls in its scope, as
the JAX package's does (:func:`forced_plan`); under ``"packed_flash"`` kernel
B computes the function of the TPU's ``packed_temporal_flash`` (kernel F,
the unpadded-layout packed forward), counted as ``packed_temporal``.
:func:`sp_ring` routes the long self-attention sites of its scope through
the sequence-parallel ring (``parallel/sp_attention.py``, plain torch).
The wrappers take their plain version only for CPU tensors; a CUDA tensor
goes to the kernel or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from animate3d_tpu_torch.ops import _build, routing

_LOGITS_FLASH_BYTES = 512 * 1024 * 1024  # flash above this many f32 logits
_FLASH_BLOCK_K = 512  # the TPU route's K block; Sk must divide by it


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, c = x.shape
    return x.reshape(b, s, num_heads, c // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """(B, H, S, D) attention with f32 softmax; probabilities are normalised
    before the cast back to the input dtype (plain path)."""
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def packed_small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, scale: float) -> torch.Tensor:
    """Plain version of kernel B: self-attention within each of the B short
    sequences of q/k/v ``(B, S, H*D)``, with the kernel's numerics (f32
    scores, scale after the dot, P normalised before its cast for PV). The
    TPU packed sequences to its matrix-unit width; torch needs no packing."""
    qh, kh, vh = (_split_heads(x, num_heads) for x in (q, k, v))
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _merge_heads(torch.matmul(probs, vh))


def _flash_plain(q, k, v, num_heads: int, scale: float, kv_group: int):
    """Plain version of kernel A with its numerics: f32 scores, bf16 (input
    dtype) unnormalised P in the PV product, division by the f32 row sum
    after PV with a 1e-30 floor, natural-log lse (B, H, Sq). Batches are
    taken in slices to bound the f32 logits held at once."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    f32 = torch.float32
    step = max(1, (1 << 28) // max(1, num_heads * sq * sk))
    outs, lses = [], []
    for b0 in range(0, b, step):
        b1 = min(b, b0 + step)
        kv0, kv1 = b0 // kv_group, (b1 - 1) // kv_group + 1
        qh = _split_heads(q[b0:b1], num_heads).to(f32)
        kh = _split_heads(k[kv0:kv1], num_heads).to(f32)
        vh = _split_heads(v[kv0:kv1], num_heads)
        if kv_group > 1:
            idx = torch.arange(b0, b1, device=q.device) // kv_group - kv0
            kh, vh = kh[idx], vh[idx]
        s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        acc = torch.matmul(p.to(v.dtype).to(f32), vh.to(f32))
        outs.append(_merge_heads((acc / l_safe).to(q.dtype)))
        lses.append((m + torch.log(l_safe))[..., 0])
    return torch.cat(outs), torch.cat(lses)


def _flash_delta(do: torch.Tensor, out: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Delta = rowsum(dO * O) in f32 per (batch, head, query): (B, H, Sq)."""
    b, sq, c = out.shape
    prod = (do.float() * out.float()).reshape(b, sq, num_heads, c // num_heads).sum(-1)
    return prod.transpose(1, 2).contiguous()


def _flash_bwd_plain(q, k, v, out, lse, do, num_heads: int, scale: float, kv_group: int):
    """Plain version of kernel D with its rounding points: P = exp(s - lse)
    rebuilt in f32 from the forward's lse (scale after the dot, no clamp),
    Delta = rowsum(dO O) in f32, bf16 (input dtype) P and dS in the
    products, f32 sums; dk/dv summed over the kv_group query batches of each
    K/V batch in f32, then rounded once. Returns (dq, dk, dv). Batches are
    taken in slices to bound the f32 score-sized tensors held at once."""
    b, sq, c = q.shape
    sk = k.shape[1]
    f32, dt = torch.float32, q.dtype
    do = do.to(dt)
    delta = _flash_delta(do, out, num_heads)
    step = max(1, (1 << 28) // max(1, num_heads * sq * sk))
    dqs = []
    dk = torch.zeros((k.shape[0], num_heads, sk, c // num_heads), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    kh_all, vh_all = _split_heads(k, num_heads), _split_heads(v, num_heads)
    for b0 in range(0, b, step):
        b1 = min(b, b0 + step)
        idx = torch.arange(b0, b1, device=q.device) // kv_group
        qh = _split_heads(q[b0:b1], num_heads).to(f32)
        doh = _split_heads(do[b0:b1], num_heads).to(f32)
        kh, vh = kh_all[idx].to(f32), vh_all[idx].to(f32)
        p = torch.exp(torch.matmul(qh, kh.transpose(-1, -2)) * scale
                      - lse[b0:b1, :, :, None])
        ds = p * (torch.matmul(doh, vh.transpose(-1, -2)) - delta[b0:b1, :, :, None])
        ds = ds.to(dt).to(f32)
        dqs.append(_merge_heads(torch.matmul(ds, kh) * scale).to(dt))
        dk.index_add_(0, idx, torch.matmul(ds.transpose(-1, -2), qh))
        dv.index_add_(0, idx, torch.matmul(p.to(dt).to(f32).transpose(-1, -2), doh))
    return (torch.cat(dqs), _merge_heads(dk * scale).to(k.dtype),
            _merge_heads(dv).to(v.dtype))


def _packed_bwd_plain(q, k, v, g, num_heads: int, scale: float):
    """Plain version of kernel E with its rounding points: normalised P in
    f32, P_bf16 = P in the input dtype, o = P_bf16 v recomputed in f32,
    Delta = rowsum(g o) from that o, dS rounded to the input dtype (exactly
    0 at S 1, where dP - Delta holds only the rounding of one sum taken in
    two orders); dq = dS k * scale, dk = dS^T q * scale, dv = P_bf16^T g.
    The cotangent is first cast to q's dtype. The f32 score-sized tensors are B*H*S^2 (S <=
    32), far smaller than q, so batches are not sliced."""
    f32, dt = torch.float32, q.dtype
    qh, kh, vh, gh = (_split_heads(x.to(dt), num_heads).to(f32) for x in (q, k, v, g))
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
    pc = p.to(dt).to(f32)
    o = torch.matmul(pc, vh)
    delta = (gh * o).sum(-1, keepdim=True)
    ds = (p * (torch.matmul(gh, vh.transpose(-1, -2)) - delta)).to(dt).to(f32)
    if q.shape[1] == 1:  # a one-token softmax is the constant 1: dS is exactly 0
        ds = torch.zeros_like(ds)
    dq = _merge_heads(torch.matmul(ds, kh) * scale).to(dt)
    dk = _merge_heads(torch.matmul(ds.transpose(-1, -2), qh) * scale).to(dt)
    dv = _merge_heads(torch.matmul(pc.transpose(-1, -2), gh)).to(dt)
    return dq, dk, dv


FLASH_HEAD_DIMS = (40, 80, 160)  # SD1.5's head widths at 320, 640, 1280 channels
FLASH_FWD_HEAD_DIMS = FLASH_HEAD_DIMS + (64,)  # kernel A alone: SVD's 64-wide heads


def flash_kernel_takes(head_dim: int) -> bool:
    """Whether kernels A and D take heads ``head_dim`` wide: the three SD1.5
    widths, the only ones a flash site of the MV-VDM UNet has."""
    return head_dim in FLASH_HEAD_DIMS


def flash_fwd_takes(head_dim: int) -> bool:
    """Whether kernel A (the forward alone) takes heads ``head_dim`` wide:
    the SD1.5 widths and the 64-wide heads of the SVD UNet, which only
    samples (no backward kernel D at 64)."""
    return head_dim in FLASH_FWD_HEAD_DIMS


def _check_merged(name: str, x: torch.Tensor, head_dim: int, device) -> None:
    if x.device != device or x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: kernel takes bfloat16 on {device}, "
                        f"got {x.dtype} on {x.device}")
    if x.dim() != 3 or x.stride(2) != 1:
        raise ValueError(f"{name}: need (B, S, H*D) with unit channel stride, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")
    if head_dim % 8 or any(s % 8 for s in x.stride()[:2]) or x.data_ptr() % 16:
        raise ValueError(f"{name}: head dim, strides and base must allow "
                         f"16-byte loads (D={head_dim}, strides {x.stride()})")


@functools.lru_cache(maxsize=None)
def _flash_fn():
    fn = _build.library("flash_fwd").flash_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 8
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _packed_fn():
    fn = _build.library("packed_attn").packed_attn
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _flash_bwd_fn():
    fn = _build.library("flash_bwd").flash_bwd
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 10
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def flash_bwd_split(kv_batches: int, sk: int, num_heads: int, kv_group: int,
                    sms: int = 132) -> int:
    """Over how many CTAs kernel D splits the kv_group query batches of each
    K/V key tile: doubling (while it divides kv_group) until the grid has
    four CTAs an SM, so the I2V shapes (one K/V batch for 16 query batches)
    fill the card. Their dk / dv then meet in f32 scratch."""
    ctas = -(-sk // 128) * num_heads * kv_batches
    split = 1
    while kv_group % (2 * split) == 0 and ctas * split < 4 * sms:
        split *= 2
    return split


@functools.lru_cache(maxsize=None)
def _packed_bwd_fn():
    fn = _build.library("packed_attn_bwd").packed_attn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, scale: float, kv_group: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A: q (B, Sq, H*D), k/v (B // kv_group, Sk, H*D) → out
    (B, Sq, H*D) and lse (B, H, Sq) f32. Query batch b attends to K/V batch
    b // kv_group (the I2V branches' frame-0 K/V, never broadcast in
    memory). q/k/v may be strided views with unit channel stride."""
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // num_heads
    if k.shape != v.shape or k.shape[0] * kv_group != b or k.shape[2] != c:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} kv_group {kv_group}")
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, num_heads, scale, kv_group)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_merged(f"flash_attention {name}", x, d, q.device)
    if not (flash_fwd_takes(d) and sk > 0) or c != num_heads * d:
        raise ValueError(f"flash_attention: unsupported D={d}, Sk={sk}")
    out = torch.empty((b, sq, c), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, sq), dtype=torch.float32, device=q.device)
    rc = _flash_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), b, num_heads, sq, sk, d,
                     q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                     v.stride(0), v.stride(1), out.stride(0), out.stride(1),
                     kv_group, scale, _build.stream_ptr(q.device))
    _build.check("flash_fwd", rc)
    _build.LAUNCHES["flash_fwd", (b, sq, sk, c, kv_group)] += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        num_heads: int, scale: float, kv_group: int = 1,
                        need_dq: bool = True, need_dkv: bool = True):
    """Kernel D: the gradients (dq, dk, dv) of :func:`flash_attention` from
    its inputs, its ``out`` and ``lse`` and the cotangent ``do`` (B, Sq,
    H*D). dk/dv (B // kv_group, Sk, H*D) sum over the kv_group query
    batches of each K/V batch. On CUDA, ``need_dq`` / ``need_dkv`` False
    skip that gradient's products in the pass and return None in its place;
    CPU tensors take the plain version, which returns all three."""
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // num_heads
    if (k.shape != v.shape or k.shape[0] * kv_group != b or k.shape[2] != c
            or out.shape != q.shape or do.shape != q.shape):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} out {tuple(out.shape)} do {tuple(do.shape)} "
                         f"kv_group {kv_group}")
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, out, lse, do, num_heads, scale, kv_group)
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out), ("do", do)):
        _check_merged(f"flash_attention_bwd {name}", x, d, q.device)
    if not (flash_kernel_takes(d) and sk > 0) or c != num_heads * d:
        raise ValueError(f"flash_attention_bwd: unsupported D={d}, Sk={sk}")
    if (lse.shape != (b, num_heads, sq) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous float32 "
                         f"{(b, num_heads, sq)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    dev, f32 = q.device, torch.float32
    split = flash_bwd_split(k.shape[0], sk, num_heads, kv_group, _sm_count(dev))
    delta = torch.empty((b, num_heads, sq), dtype=f32, device=dev)
    dq = dk = dv = None
    dq_acc = dk_acc = dv_acc = None
    if need_dq:
        dq_acc = torch.zeros((b, num_heads, sq, d), dtype=f32, device=dev)
        dq = torch.empty((b, sq, c), dtype=q.dtype, device=dev)
    if need_dkv:
        dk = torch.empty((k.shape[0], sk, c), dtype=k.dtype, device=dev)
        dv = torch.empty((k.shape[0], sk, c), dtype=v.dtype, device=dev)
        if split > 1:
            dk_acc, dv_acc = torch.zeros_like(dk, dtype=f32), torch.zeros_like(dv, dtype=f32)
    ptr = lambda x: 0 if x is None else x.data_ptr()
    rc = _flash_bwd_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), ptr(dq_acc), ptr(dq), ptr(dk), ptr(dv),
        ptr(dk_acc), ptr(dv_acc), b, num_heads, sq, sk, d, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        do.stride(0), do.stride(1), kv_group, split, int(need_dq), int(need_dkv), scale,
        _build.stream_ptr(dev))
    _build.check("flash_bwd", rc)
    # one launch of the pass; it counts under each gradient it writes
    key = (b, sq, sk, c, kv_group)
    if need_dq:
        _build.LAUNCHES["flash_bwd_dq", key] += 1
    if need_dkv:
        _build.LAUNCHES["flash_bwd_dkv", key] += 1
    return dq, dk, dv


PACKED_SEQ = (1, 2, 4, 8, 16, 32)  # S dividing 128 up to 32, as padded_packed_plan
PACKED_HEAD_DIMS = (40, 80)  # the auto route's packed head widths


def packed_kernel_takes(seq: int, head_dim: int) -> bool:
    """Whether kernel B and its backward E take sequences of ``seq`` tokens
    with heads ``head_dim`` wide: D 40, 80 or 160 (kernel F's route at the
    1280-channel motion modules) at every S of ``PACKED_SEQ``."""
    return seq in PACKED_SEQ and head_dim in PACKED_HEAD_DIMS + (160,)


PADDED_SEQ_HEAD_DIMS = (64,)  # kernel B's padded sequences: SVD's 64-wide heads


def padded_seq(seq: int, head_dim: int) -> bool:
    """Whether kernel B (forward only) takes sequences of ``seq`` tokens by
    padding each to one 32-row tile with its keys past ``seq`` masked: the
    lengths 17-31 at 64-wide heads (SVD's 25 frames)."""
    return 16 < seq < 32 and head_dim in PADDED_SEQ_HEAD_DIMS


def check_packed_shape(name: str, seq: int, channels: int, num_heads: int) -> None:
    """Raise where kernels B and E do not take (S, D): the (S, D) of
    :func:`packed_kernel_takes`, channels a whole number of heads."""
    d = channels // num_heads
    if not packed_kernel_takes(seq, d) or channels != num_heads * d:
        raise ValueError(f"{name}: unsupported S={seq}, D={d}")


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int, scale: float, counter: str = "packed_attn") -> torch.Tensor:
    """Kernel B: self-attention within each of the B sequences of q/k/v
    ``(B, S, H*D)`` at the (S, D) of :func:`packed_kernel_takes`; token rows may be
    strided but each batch must hold its S rows at one stride. The launch
    counts under ``counter``: ``packed_attn`` (the TPU's padded packed
    kernel) or ``packed_temporal`` (its unpadded ``packed_temporal_flash``)."""
    b, s, c = q.shape
    d = c // num_heads
    if not (q.shape == k.shape == v.shape):
        raise ValueError("packed_attention: q/k/v shapes differ")
    if q.device.type == "cpu":
        if padded_seq(s, d):
            return packed_padded_attention(q, k, v, num_heads, scale)
        return packed_small_attention(q, k, v, num_heads, scale)
    if not padded_seq(s, d):
        check_packed_shape("packed_attention", s, c, num_heads)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_merged(f"packed_attention {name}", x, d, q.device)
        if x.stride(0) != s * x.stride(1):
            raise ValueError(f"packed_attention {name}: batches must be "
                             f"evenly spaced rows, strides {x.stride()}")
    out = torch.empty((b, s, c), dtype=q.dtype, device=q.device)
    rc = _packed_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      b, s, num_heads, d, q.stride(1), k.stride(1), v.stride(1),
                      out.stride(1), scale, _build.stream_ptr(q.device))
    _build.check("packed_attn", rc)
    _build.LAUNCHES[counter, (b, s, c)] += 1
    if padded_seq(s, d):
        _build.LAUNCHES["packed_seq_padded", f"{s}->32"] += 1
    return out


def packed_padded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            num_heads: int, scale: float) -> torch.Tensor:
    """Plain version of kernel B's padded sequences, with its layout and
    numerics: each (B, S, H*D) sequence zero-padded to 32 rows, f32 scores
    scaled after the dot, keys S..31 at -1e30 (exactly 0 after the exp), P
    normalised before its cast, PV, the S query rows kept."""
    b, s, c = q.shape
    pad = 32 - s
    qh, kh, vh = (_split_heads(torch.nn.functional.pad(x, (0, 0, 0, pad)), num_heads)
                  for x in (q, k, v))
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    keep = torch.arange(32, device=q.device) < s
    logits = logits + torch.where(keep, 0.0, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _merge_heads(torch.matmul(probs, vh))[:, :s]


def packed_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         g: torch.Tensor, num_heads: int, scale: float):
    """Kernel E: (dq, dk, dv) of :func:`packed_attention` for the cotangent
    ``g`` (B, S, H*D), which is first cast to q's dtype, as the TPU route
    does; at the (S, D) of :func:`packed_kernel_takes`, strides as
    :func:`packed_attention` takes them. No atomics: two launches on the
    same inputs are bitwise equal."""
    b, s, c = q.shape
    d = c // num_heads
    if not (q.shape == k.shape == v.shape == g.shape):
        raise ValueError("packed_attention_bwd: q/k/v/g shapes differ")
    g = g.to(q.dtype)
    if q.device.type == "cpu":
        return _packed_bwd_plain(q, k, v, g, num_heads, scale)
    check_packed_shape("packed_attention_bwd", s, c, num_heads)
    for name, x in (("q", q), ("k", k), ("v", v), ("g", g)):
        _check_merged(f"packed_attention_bwd {name}", x, d, q.device)
        if x.stride(0) != s * x.stride(1):
            raise ValueError(f"packed_attention_bwd {name}: batches must be "
                             f"evenly spaced rows, strides {x.stride()}")
    dq, dk, dv = (torch.empty((b, s, c), dtype=q.dtype, device=q.device) for _ in range(3))
    rc = _packed_bwd_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, num_heads, d,
                          q.stride(1), k.stride(1), v.stride(1), g.stride(1), dq.stride(1),
                          scale, _build.stream_ptr(q.device))
    _build.check("packed_attn_bwd", rc)
    _build.LAUNCHES["packed_attn_bwd", (b, s, c)] += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Kernel A forward, kernel D backward; with ``kernels`` False (plain
    ops, CPU tensors) their plain versions. Saves q, k, v, out and the f32
    lse, never the logits. The backward skips dq or dk/dv where no input
    needs it (``ctx.needs_input_grad``)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float, kv_group: int, kernels: bool):
        fwd = flash_attention if kernels else _flash_plain
        out, lse = fwd(q, k, v, num_heads, scale, kv_group)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (num_heads, scale, kv_group, kernels)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        num_heads, scale, kv_group, kernels = ctx.args
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        do = do.to(q.dtype).contiguous()
        if kernels:
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, num_heads, scale,
                                             kv_group, need_q, need_k or need_v)
        else:
            dq, dk, dv = _flash_bwd_plain(q, k, v, out, lse, do, num_heads, scale, kv_group)
        return (dq if need_q else None, dk if need_k else None, dv if need_v else None,
                None, None, None, None)


class PackedAttentionFn(torch.autograd.Function):
    """Kernel B forward, kernel E backward (their plain versions when
    ``kernels`` is False); saves q, k, v. B's launch counts under
    ``counter``: ``packed_attn``, or ``packed_temporal`` on kernel F's route."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float, kernels: bool,
                counter: str = "packed_attn"):
        ctx.save_for_backward(q, k, v)
        ctx.args = (num_heads, scale, kernels)
        if kernels:
            return packed_attention(q, k, v, num_heads, scale, counter)
        return packed_small_attention(q, k, v, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        num_heads, scale, kernels = ctx.args
        bwd = packed_attention_bwd if kernels else _packed_bwd_plain
        grads = bwd(q, k, v, g.to(q.dtype).contiguous(), num_heads, scale)
        return tuple(x if need else None
                     for x, need in zip(grads, ctx.needs_input_grad[:3])) + (None,) * 4


def packed_plan(batch: int, seq: int, channels: int, num_heads: int) -> bool:
    """Shape predicate of the TPU's ``padded_packed_plan`` (and of kernel
    B's support): short self-attention sequences dividing 128, enough of
    them to pack twice, head dim below 128 — restricted to D in {40, 80},
    the widths of the motion modules below 128."""
    d = channels // num_heads
    return (d < 128 and seq <= 32 and 128 % seq == 0
            and batch >= 2 * (128 // seq)
            and seq in PACKED_SEQ and d in PACKED_HEAD_DIMS)


def flash_plan(batch: int, sq: int, sk: int, channels: int,
               num_heads: int) -> bool:
    """The TPU's flash rule as a whole: Sk a multiple of 512 and more than
    512 MiB of f32 logits. Below 128-wide heads that is ``padded_flash_plan``
    (the layers' lane-padded route); at 128 and wider the layers fall through
    to ``multi_head_attention``, whose auto rule on the TPU takes the unpadded
    ``_flash_attention`` on the same condition (the 160-wide L2 sites at 512^2
    and up)."""
    logits_bytes = batch * num_heads * sq * sk * 4
    return sk % _FLASH_BLOCK_K == 0 and logits_bytes > _LOGITS_FLASH_BYTES


def attention_plan(batch: int, sq: int, sk: int, channels: int,
                   num_heads: int, self_attention: bool,
                   on_cuda: bool) -> str:
    """"packed", "flash" or "plain" for one attention site; the kernels are
    taken only on CUDA, as the TPU took its kernels only on the TPU."""
    if not on_cuda:
        return "plain"
    if self_attention and packed_plan(batch, sq, channels, num_heads):
        return "packed"
    if flash_plan(batch, sq, sk, channels, num_heads):
        return "flash"
    return "plain"


BACKENDS = ("auto", "xla", "flash", "packed", "packed_flash")
_override = threading.local()


@contextlib.contextmanager
def attention_backend(name: str):
    """Force a backend for every :func:`multi_head_attention` call in this
    scope (this thread): the JAX package's ``attention_backend``. The route
    is fixed at forward time, so the backward follows it."""
    if name not in BACKENDS:
        raise ValueError(f"attention_backend: {name!r} is not one of {BACKENDS}")
    prev = getattr(_override, "name", None)
    _override.name = name
    try:
        yield
    finally:
        _override.name = prev


def backend_in_scope() -> str:
    """The backend :func:`attention_backend` forces in this scope (this
    thread), or "auto"."""
    return getattr(_override, "name", None) or "auto"


def ring_in_scope() -> bool:
    """Whether :func:`sp_ring` routes this scope's (this thread's)
    self-attention through ring attention."""
    return getattr(_override, "sp", None) is not None


# the shortest sequence the sp ring takes (the JAX package's SP_MIN_SEQ):
# shorter ones, such as the 16-token temporal sites, would spend more on the
# ring's hops than on their whole local attention
SP_MIN_SEQ = 512


@contextlib.contextmanager
def sp_ring(mesh, min_seq: Optional[int] = None):
    """Route the self-attention calls of this scope (this thread) through
    ring attention over ``mesh``'s sp group (``parallel/sp_attention.py``),
    with the JAX package's gate: q and k of one shape, S divisible by the sp
    size and at least max(2 x sp, ``min_seq``) (default :data:`SP_MIN_SEQ`).
    Other calls run locally as routed."""
    prev = getattr(_override, "sp", None)
    _override.sp = (mesh, SP_MIN_SEQ if min_seq is None else min_seq)
    try:
        yield
    finally:
        _override.sp = prev


def forced_plan(batch: int, sq: int, sk: int, channels: int, num_heads: int,
                self_attention: bool, same_shapes: bool, on_cuda: bool, backend: str) -> str:
    """A site's route under a forced backend, as the JAX package routes it
    (``padded_packed_plan`` / ``padded_flash_plan`` under the override, then
    ``multi_head_attention(backend=...)``; "on TPU" read as "on CUDA"):

    * ``flash``: kernel B's route for the padded packed plan's temporal
      shapes (the pinned quirk: a forced flash still packs them), else
      "flash" (kernels A and D, at every head width of ``flash_kernel_takes``)
      where Sk is a multiple of 512, else "plain";
    * ``packed``: "packed_plain" (B's plain version, the XLA packed path) on
      packable shapes (equal q/k/v, S <= 32, at least two packs), else
      "plain";
    * ``packed_flash``: "packed_flash" (kernel B as F, backward kernel E,
      whose wrappers raise on an (S, D) that :func:`packed_kernel_takes`
      refuses) on packable shapes on CUDA with ``128 % S == 0``,
      "packed_plain" on other packable shapes, else "plain";
    * ``xla``: "plain".

    Where the JAX package runs a kernel, so does the port on CUDA, or it
    raises: it never takes a plain version there."""
    if backend == "flash":
        if on_cuda and self_attention and packed_plan(batch, sq, channels, num_heads):
            return "packed"
        return "flash" if sk % _FLASH_BLOCK_K == 0 else "plain"
    packable = same_shapes and sq <= 32 and batch >= 2 * (128 // sq)
    if backend in ("packed", "packed_flash") and packable:
        if backend == "packed_flash" and on_cuda and 128 % sq == 0:
            return "packed_flash"
        return "packed_plain"
    return "plain"


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, scale: Optional[float] = None,
                         kv_group: int = 1,
                         self_attention: bool = False) -> torch.Tensor:
    """Merged-head attention: q (B, Sq, C), k/v (B // kv_group, Sk, C) →
    (B, Sq, C). ``self_attention`` marks sites whose q/k/v come from the
    same tokens (only those may take the packed kernel)."""
    d = q.shape[-1] // num_heads
    if scale is None:
        scale = d ** -0.5
    sp = getattr(_override, "sp", None)
    if sp is not None:
        mesh, min_seq = sp
        if (q.shape == k.shape and q.shape[1] % mesh.sp == 0
                and q.shape[1] >= max(2 * mesh.sp, min_seq)):
            from animate3d_tpu_torch.parallel import sp_attention

            return sp_attention.ring_attention_sharded(mesh, q, k, v, num_heads, scale)
    backend = backend_in_scope()
    on_cuda = q.device.type == "cuda"
    if backend == "auto":
        plan = attention_plan(q.shape[0], q.shape[1], k.shape[1], q.shape[-1],
                              num_heads, self_attention, on_cuda)
    else:
        plan = forced_plan(q.shape[0], q.shape[1], k.shape[1], q.shape[-1], num_heads,
                           self_attention, q.shape == k.shape == v.shape, on_cuda, backend)
    kernels = routing.kernels_enabled(q.device)
    if plan == "packed":
        return PackedAttentionFn.apply(q, k, v, num_heads, scale, kernels)
    if plan == "packed_flash":
        return PackedAttentionFn.apply(q, k, v, num_heads, scale, kernels, "packed_temporal")
    if plan == "packed_plain":
        return PackedAttentionFn.apply(q, k, v, num_heads, scale, False)
    if plan == "flash":
        return FlashAttentionFn.apply(q, k, v, num_heads, scale, kv_group, kernels)
    if kv_group > 1:
        k = k.repeat_interleave(kv_group, dim=0)
        v = v.repeat_interleave(kv_group, dim=0)
    qh, kh, vh = (_split_heads(x, num_heads) for x in (q, k, v))
    return _merge_heads(attention_xla(qh, kh, vh, scale))


def one_key_attention(v: torch.Tensor) -> torch.Tensor:
    """Attention of any number of queries to a single key, v (B, 1, C) →
    (B, 1, C): the softmax over one key is exactly 1, so every query's
    output is v, bit for bit what the full attention computes; returned
    once a batch, for the caller to broadcast over its queries. q and k do
    not enter."""
    return v


def video_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """The Stable Video Diffusion UNet's route for merged-head attention, q
    (B, S, C), k / v (B, Sk, C); the JAX package has no such model, so this
    is not the TPU's rule:

    * self-attention over a short sequence (the temporal blocks' 25
      frames): kernel B, which pads sequences of 17-31 tokens to 32 and
      masks the padded keys;
    * any other (the spatial blocks' 9,216 / 2,304 / 576 / 144 tokens a
      frame): kernel A at the widths of :func:`flash_fwd_takes`.

    CPU tensors and ``routing.plain_ops()`` take the kernels' plain
    versions (A's in batch slices that bound its f32 scores); with the
    kernels on, a head width A does not take raises."""
    b, s, c = q.shape
    d = c // num_heads
    scale = d ** -0.5
    kernels = routing.kernels_enabled(q.device)
    if s <= 32 and q.shape == k.shape:
        if kernels:
            return packed_attention(q, k, v, num_heads, scale)
        if padded_seq(s, d):
            return packed_padded_attention(q, k, v, num_heads, scale)
        return packed_small_attention(q, k, v, num_heads, scale)
    if kernels:
        return flash_attention(q, k, v, num_heads, scale)[0]
    if q.device.type == "cuda":
        return _flash_plain(q, k, v, num_heads, scale, 1)[0]
    qh, kh, vh = (_split_heads(x, num_heads) for x in (q, k, v))
    return _merge_heads(attention_xla(qh, kh, vh, scale))
