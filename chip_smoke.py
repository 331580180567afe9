#!/usr/bin/env python3
"""Drive the PyTorch port (``animate3d_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the ``ok`` line:

1. environment: card name and power limit, torch/CUDA versions, and the
   parallel ``nvcc`` build of every kernel in ``animate3d_tpu_torch/csrc``;
2. kernels: each hand-written kernel at the main paths' shapes against its
   plain PyTorch version on the same inputs (max |diff| within the stated
   tolerance), with kernel / plain / library times and the card's bound for
   the same work (the largest of tensor-core flops, ex2 at the SFU's rate,
   and bytes): A-E at the sampling (256^2 and 512^2) and training shapes
   and D at the 160-wide L2 shape (F: kernel B
   under ``attention_backend("packed_flash")`` at L0 and L2), H at every
   stage-1 shape (recon steps, four-view test, validation orbit, testset
   grid), G at the 64^2 recon shapes and on dense synthetic tiles; then
   edge shapes off the main path (G against float64 among them);
3. end to end: the sampling CLI at full width (SD1.5 widths, 256x256,
   4 views x 16 frames, 2 DDIM steps, random weights from a seed) with every
   launch counter set to 0 just before and read just after; then again at
   512x512 (the 160-wide L2 sites on kernel A too), its launch counts
   asserted exactly, with its step seconds and peak memory;
4. profile and reference: one full-width UNet forward on the CFG batch
   under torch.profiler (device time by kernel family), and one forward
   through the kernels against the same forward through the plain versions;
5. train: the trainer CLI at full width (4 views x 16 frames, 256x256,
   batch 1, gradient checkpointing, random weights from a seed) for 3 steps
   on a synthetic manifest, launch counters zeroed just before and read just
   after, then one loss + backward through the kernels against the same
   step through the plain versions;
6. packed_flash: one L0 and one L2 temporal attention (40- and 160-wide
   heads) forward and backward under ``attention_backend("packed_flash")``
   (kernel B as F's route, E) against the plain versions, counters zeroed
   before and read after;
7. recon: stage-1 motion reconstruction through its CLI with
   configs/animate3d/motion_recon_frame_16.yaml as it is (4 views x 16
   frames at 256^2, 20,000 gaussians of a seeded random asset, frames
   rendered by the port under a seeded per-frame translation) for 3 steps
   plus its four-view test pass at 512^2 (pngs, videos, PSNR / SSIM
   report), launch counters zeroed just before and read just after; then
   timed steps at the full schedule and at the frame buckets 2 / 4 / 8, one
   profiled step, and one full-size loss + backward through kernel H
   against the same step on the plain versions;
8. evaluation on that trial: ``--test`` with
   configs/animate3d/visualize_testset_frame_16.yaml (12 views x 16 frames
   at 1024^2) and its render alone under torch.profiler, ``--validate``
   (the 120-frame orbit at 512^2) and ``--export`` (16 trajectories and the
   report);
9. fields: the recon CLI again at 64^2 (kernel G's route), its timed
   full-schedule step and one loss + backward through G against plain ops.

The line before the last is a JSON object with one row per kernel and
path shape; the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
PEAK_EX2 = 3.9e12  # H100 SXM SFU: 16 ex2 a clock an SM x 132 SMs x 1.83 GHz

COUNTERS = ("flash_fwd", "packed_attn", "geglu", "flash_bwd_dq", "flash_bwd_dkv",
            "packed_attn_bwd", "composite_coarse_fwd", "composite_coarse_bwd",
            "composite_fields_fwd", "composite_fields_bwd", "packed_temporal")


def _per(**counts) -> dict:
    return {k: counts.get(k, 0) for k in COUNTERS}


# per UNet forward at full width (SD1.5 topology, 4 views x 16 frames, 256^2)
# on the CFG batch of sampling; no backward kernel runs there
PER_FORWARD = _per(flash_fwd=40, packed_attn=20, geglu=37)
# the same at 512^2 (64x64 latents): the 1280-channel L2 sites (S 1024, 160-wide
# heads, 1.07 GB of f32 logits) cross the 512 MiB line too, so the cross-view
# attn1 and I2V branch of its 5 transformers and the spatial branch of its 10
# motion-module blocks take kernel A as well: 20 more
PER_FORWARD_512 = _per(flash_fwd=60, packed_attn=20, geglu=37)
# per train step (one video: batch 16 frames per view-major UNet call) with
# gradient checkpointing: every kernel site's forward runs twice (forward and
# the block's recompute in backward); L1 flash sites fall under the 512 MiB
# logits line at batch 16 and take the plain path. D: the first L0 attn1 of
# down_blocks.0.attentions.0 needs no gradient at all (its q/k/v come from
# frozen weights and the latents), and its I2V branch needs dq only (k/v are
# frame 0's frozen projections), so 20 L0 sites give 19 dq and 18 dk/dv
# counts; E runs at all 20 temporal sites. D is one pass a site that writes
# the gradients its inputs need: it counts one flash_bwd_dq where it writes
# dq and one flash_bwd_dkv where it writes dk / dv (19 launches a step).
PER_TRAIN_STEP = _per(flash_fwd=40, packed_attn=40, geglu=74, flash_bwd_dq=19,
                      flash_bwd_dkv=18, packed_attn_bwd=20)
# per recon step: the step's renders (all views x its frames) are one batch
# of the rasterizer, so kernel H (above 64^2) or G (64^2 and below) runs
# once forward and once backward
PER_RECON_STEP = _per(composite_coarse_fwd=1, composite_coarse_bwd=1)
PER_FIELDS_STEP = _per(composite_fields_fwd=1, composite_fields_bwd=1)
# one motion-module temporal attention at L0 (40-wide heads) and one at L2
# (160-wide) under attention_backend("packed_flash"), forward and backward:
# kernel B as F's route, then E, at each
PER_PACKED_FLASH = _per(packed_temporal=2, packed_attn_bwd=2)
SOURCES = {
    "flash_fwd": ("animate3d_tpu_torch/csrc/flash_fwd.cu",
                  "animate3d_tpu/ops/attention.py:234"),
    "packed_attn": ("animate3d_tpu_torch/csrc/packed_attn.cu",
                    "animate3d_tpu/ops/attention.py:755"),
    "geglu": ("animate3d_tpu_torch/csrc/geglu.cu",
              "animate3d_tpu/ops/geglu.py:64"),
    "flash_bwd": ("animate3d_tpu_torch/csrc/flash_bwd.cu",
                  "animate3d_tpu/ops/attention.py:400,436"),
    "packed_attn_bwd": ("animate3d_tpu_torch/csrc/packed_attn_bwd.cu",
                        "animate3d_tpu/ops/attention.py:788"),
    "composite_coarse_fwd": ("animate3d_tpu_torch/csrc/composite_coarse.cu",
                             "animate3d_tpu/ops/rasterize_pallas.py:298"),
    "composite_coarse_bwd": ("animate3d_tpu_torch/csrc/composite_coarse.cu",
                             "animate3d_tpu/ops/rasterize_pallas.py:392"),
    "composite_fields_fwd": ("animate3d_tpu_torch/csrc/composite_fields.cu",
                             "animate3d_tpu/ops/rasterize_pallas.py:83"),
    "composite_fields_bwd": ("animate3d_tpu_torch/csrc/composite_fields.cu",
                             "animate3d_tpu/ops/rasterize_pallas.py:161"),
    "packed_temporal": ("animate3d_tpu_torch/csrc/packed_attn.cu",
                        "animate3d_tpu/ops/attention.py:84"),
}


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(flops: float, nbytes: float, ex2: float = 0.0):
    """(least ms, "operations" or "bytes", the binding term): the largest of
    the tensor-core flops at the bf16 peak, the ex2 at the SFU's rate (one
    a score for the attention kernels) and the bytes at the HBM rate."""
    terms = {"tensor": flops / PEAK_BF16_FLOPS, "ex2": ex2 / PEAK_EX2,
             "bytes": nbytes / PEAK_BYTES}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, ("bytes" if term == "bytes" else "operations"), term


REL_L2_TOL = 1e-2


def _agree(out: torch.Tensor, ref: torch.Tensor):
    """(max |diff|, its limit, relative L2, ok). The limit is 2^-6 of the
    output's largest magnitude (2 to 4 bf16 ulps there: one for the
    output's own rounding, the rest for a flipped rounding of a bf16
    intermediate and f32 sums in another order); the relative L2 must also
    stay within ``REL_L2_TOL``, so an error spread over many small outputs
    (a dropped or misaddressed V tile) fails too."""
    out, ref = out.float(), ref.float()
    err = float((out - ref).abs().max())
    tol = 2.0 ** -6 * float(ref.abs().max())
    rel = float((out - ref).norm() / ref.norm().clamp_min(1e-30))
    ok = err <= tol and rel <= REL_L2_TOL and bool(torch.isfinite(out).all())
    return err, tol, rel, ok


def env_phase() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    from animate3d_tpu_torch.ops import _build

    if tuple(_build.COUNTERS) != COUNTERS:
        raise RuntimeError(f"launch counters {_build.COUNTERS} differ from {COUNTERS}")
    t0 = time.perf_counter()
    took = _build.build()
    wall = time.perf_counter() - t0
    print(f"[build] {len(took)} kernel libraries built in {wall:.1f} s wall "
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(took.items())))
    for name in _build.KERNELS:
        log = _build._lib_path(name).with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    return {"smi": smi, "build_s": wall}


def _flash_case(label, b, s, c, heads, kv_group, gen):
    from animate3d_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    q = torch.randn((b, s, c), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b // kv_group, s, c), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b // kv_group, s, c), generator=gen, device=dev).to(torch.bfloat16)
    d = c // heads
    scale = d ** -0.5
    out, lse = A.flash_attention(q, k, v, heads, scale, kv_group)
    ref, ref_lse = A._flash_plain(q, k, v, heads, scale, kv_group)
    torch.cuda.synchronize()
    err, tol, rel, ok = _agree(out, ref)
    lse_err = float((lse - ref_lse).abs().max())
    ok = ok and lse_err <= 1e-3
    ms = _time_ms(lambda: A.flash_attention(q, k, v, heads, scale, kv_group), 10)
    plain_ms = _time_ms(lambda: A._flash_plain(q, k, v, heads, scale, kv_group), 2)
    qh, kh, vh = (x.reshape(x.shape[0], s, heads, d).transpose(1, 2).contiguous()
                  for x in (q, k, v))
    if kv_group > 1:
        kh, vh = (x.repeat_interleave(kv_group, 0) for x in (kh, vh))
    lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, scale=scale), 10)
    flops = 4.0 * b * heads * s * s * d
    nbytes = 2.0 * (2 * b * s * c + 2 * (b // kv_group) * s * c) + 4.0 * b * heads * s
    bound, by, term = _bound_ms(flops, nbytes, ex2=1.0 * b * heads * s * s)
    return dict(name="flash_fwd", shape=label, keys=[("flash_fwd", (b, s, s, c, kv_group))],
                max_abs_err=err, tol=tol, rel=rel, lse_err=lse_err, ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                term=term)


def _packed_case(label, b, s, c, heads, gen, backend=None):
    """Kernel B against its plain version. With ``backend="packed_flash"``
    kernel F's route: ``multi_head_attention`` on a temporal site under
    ``attention_backend("packed_flash")`` launches B, counted as
    ``packed_temporal``, against the same plain version (the function of
    the TPU's ``packed_temporal_flash``)."""
    import contextlib

    from animate3d_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    q, k, v = (torch.randn((b, s, c), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    d = c // heads
    scale = d ** -0.5
    name = "packed_temporal" if backend else "packed_attn"
    with A.attention_backend(backend) if backend else contextlib.nullcontext():
        if backend:
            route = lambda: A.multi_head_attention(q, k, v, heads, self_attention=True)
        else:
            route = lambda: A.packed_attention(q, k, v, heads, scale)
        out = route()
        ref = A.packed_small_attention(q, k, v, heads, scale)
        torch.cuda.synchronize()
        ms = _time_ms(route, 20)
    err, tol, rel, ok = _agree(out, ref)
    plain_ms = _time_ms(lambda: A.packed_small_attention(q, k, v, heads, scale), 5)
    qh, kh, vh = (x.reshape(b, s, heads, d).transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, scale=scale), 20)
    bound, by, term = _bound_ms(4.0 * b * heads * s * s * d, 2.0 * 4 * b * s * c)
    return dict(name=name, shape=label, keys=[(name, (b, s, c))],
                max_abs_err=err, tol=tol, rel=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by, term=term)


def _geglu_case(label, m, c, inner, gen):
    from animate3d_tpu_torch.ops import geglu as G

    dev = torch.device("cuda")

    def rnd(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    x = rnd((m, c), 1.0)
    w1, b1 = rnd((2 * inner, c), c ** -0.5), rnd((2 * inner,), 0.1)
    w2, b2 = rnd((c, inner), inner ** -0.5), rnd((c,), 0.1)
    out = G.geglu(x, w1, b1, w2, b2)
    ref = G._geglu_plain(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    err, tol, rel, ok = _agree(out, ref)
    ms = _time_ms(lambda: G.geglu(x, w1, b1, w2, b2), 10)
    plain_ms = _time_ms(lambda: G._geglu_plain(x, w1, b1, w2, b2), 3)
    F = torch.nn.functional

    def library():
        h, g = F.linear(x, w1, b1).chunk(2, dim=-1)
        return F.linear(h * F.gelu(g), w2, b2)

    lib_ms = _time_ms(library, 10)
    nbytes = 2.0 * (2 * m * c + 3 * inner * c + 2 * inner + c)
    bound, by, term = _bound_ms(6.0 * m * c * inner, nbytes)
    return dict(name="geglu", shape=label, keys=[("geglu", (m, c, inner))],
                max_abs_err=err, tol=tol, rel=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by, term=term)


def _sdpa_bwd_ms(q, k, v, do, heads, scale, kv_group, iters):
    """The backward alone of scaled_dot_product_attention on the same
    inputs (K/V repeated over the kv_group), timed as a yardstick."""
    F = torch.nn.functional

    def split(x, reps=1):
        b, s, c = x.shape
        x = x.reshape(b, s, heads, c // heads).transpose(1, 2)
        return x.repeat_interleave(reps, 0).contiguous().requires_grad_()

    qh, kh, vh = split(q), split(k, kv_group), split(v, kv_group)
    out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    doh = split(do).detach()
    return _time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
                    iters)


def _agree_all(outs, refs):
    """_agree over several outputs: (worst max |diff|, its limit, worst
    relative L2, all ok)."""
    res = [_agree(o, r) for o, r in zip(outs, refs)]
    worst = max(res, key=lambda x: x[0] / max(x[1], 1e-30))
    return worst[0], worst[1], max(x[2] for x in res), all(x[3] for x in res)


def _flash_bwd_case(label, b, s, c, heads, kv_group, gen):
    """Kernel D (dq and dk/dv kernels together) on the forward's own out
    and lse against the plain backward on the same bf16 inputs."""
    from animate3d_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    q = torch.randn((b, s, c), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b // kv_group, s, c), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b // kv_group, s, c), generator=gen, device=dev).to(torch.bfloat16)
    do = torch.randn((b, s, c), generator=gen, device=dev).to(torch.bfloat16)
    d = c // heads
    scale = d ** -0.5
    out, lse = A.flash_attention(q, k, v, heads, scale, kv_group)
    args = (q, k, v, out, lse, do, heads, scale, kv_group)
    grads = A.flash_attention_bwd(*args)
    refs = A._flash_bwd_plain(*args)
    torch.cuda.synchronize()
    err, tol, rel, ok = _agree_all(grads, refs)
    ms = _time_ms(lambda: A.flash_attention_bwd(*args), 5)
    plain_ms = _time_ms(lambda: A._flash_bwd_plain(*args), 2)
    lib_ms = _sdpa_bwd_ms(q, k, v, do, heads, scale, kv_group, 5)
    flops = 10.0 * b * heads * s * s * d  # S, dP, dV, dK, dQ
    nbytes = 2.0 * (4 * b * s * c + 4 * (b // kv_group) * s * c) + 4.0 * b * heads * s
    bound, by, term = _bound_ms(flops, nbytes, ex2=1.0 * b * heads * s * s)
    key = (b, s, s, c, kv_group)
    return dict(name="flash_bwd", shape=label,
                keys=[("flash_bwd_dq", key), ("flash_bwd_dkv", key)],
                max_abs_err=err, tol=tol, rel=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by, term=term)


def _packed_bwd_case(label, b, s, c, heads, gen):
    from animate3d_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    q, k, v, g = (torch.randn((b, s, c), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    d = c // heads
    scale = d ** -0.5
    args = (q, k, v, g, heads, scale)
    grads = A.packed_attention_bwd(*args)
    refs = A._packed_bwd_plain(*args)
    torch.cuda.synchronize()
    err, tol, rel, ok = _agree_all(grads, refs)
    ms = _time_ms(lambda: A.packed_attention_bwd(*args), 20)
    plain_ms = _time_ms(lambda: A._packed_bwd_plain(*args), 5)
    lib_ms = _sdpa_bwd_ms(q, k, v, g, heads, scale, 1, 20)
    bound, by, term = _bound_ms(10.0 * b * heads * s * s * d, 2.0 * 7 * b * s * c)
    return dict(name="packed_attn_bwd", shape=label, keys=[("packed_attn_bwd", (b, s, c))],
                max_abs_err=err, tol=tol, rel=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by, term=term)


def kernel_phase() -> list:
    """Each kernel at the full-width main path's shapes (CFG batch: 2 x 4
    views x 16 frames = 128 frames of a 32x32 latent) against its plain
    version on the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [
        _flash_case("L0 cross-view (32, 4096, 320) h8", 32, 4096, 320, 8, 1, gen),
        _flash_case("L0 i2v frame-0 K/V (32, 4096, 320) h8 kv_group 16",
                    32, 4096, 320, 8, 16, gen),
        _flash_case("L1 cross-view (32, 1024, 640) h8", 32, 1024, 640, 8, 1, gen),
        _flash_case("L1 i2v frame-0 K/V (32, 1024, 640) h8 kv_group 16",
                    32, 1024, 640, 8, 16, gen),
        # the 512^2 sampling path (phase 3b): L0 and L1 at four times the
        # tokens, and the 160-wide L2 cross-view / spatial and i2v sites
        _flash_case("512 L0 cross-view (32, 16384, 320) h8", 32, 16384, 320, 8, 1, gen),
        _flash_case("512 L0 i2v frame-0 K/V (32, 16384, 320) h8 kv_group 16",
                    32, 16384, 320, 8, 16, gen),
        _flash_case("512 L1 cross-view (32, 4096, 640) h8", 32, 4096, 640, 8, 1, gen),
        _flash_case("512 L1 i2v frame-0 K/V (32, 4096, 640) h8 kv_group 16",
                    32, 4096, 640, 8, 16, gen),
        _flash_case("512 L2 cross-view (32, 1024, 1280) h8", 32, 1024, 1280, 8, 1, gen),
        _flash_case("512 L2 i2v frame-0 K/V (32, 1024, 1280) h8 kv_group 16",
                    32, 1024, 1280, 8, 16, gen),
        _packed_case("L0 temporal (8192, 16, 320) h8", 8192, 16, 320, 8, gen),
        _packed_case("L1 temporal (2048, 16, 640) h8", 2048, 16, 640, 8, gen),
        _packed_case("512 L0 temporal (32768, 16, 320) h8", 32768, 16, 320, 8, gen),
        _packed_case("512 L1 temporal (8192, 16, 640) h8", 8192, 16, 640, 8, gen),
        _packed_case("L0 temporal (8192, 16, 320) h8, backend packed_flash",
                     8192, 16, 320, 8, gen, backend="packed_flash"),
        _packed_case("L2 temporal (512, 16, 1280) h8, backend packed_flash",
                     512, 16, 1280, 8, gen, backend="packed_flash"),
        _geglu_case("L0 M=131072 C=320 I=1280", 131072, 320, 1280, gen),
        _geglu_case("L1 M=32768 C=640 I=2560", 32768, 640, 2560, gen),
        _geglu_case("L2 M=8192 C=1280 I=5120", 8192, 1280, 5120, gen),
        _geglu_case("L3 M=2048 C=1280 I=5120", 2048, 1280, 5120, gen),
        _geglu_case("512 L0 M=524288 C=320 I=1280", 524288, 320, 1280, gen),
        _geglu_case("512 L1 M=131072 C=640 I=2560", 131072, 640, 2560, gen),
        _geglu_case("512 L2 M=32768 C=1280 I=5120", 32768, 1280, 5120, gen),
    ]
    # the trainer's shapes: one video, 4 views x 16 frames = 64 frames
    rows += [
        _flash_case("train L0 cross-view (16, 4096, 320) h8", 16, 4096, 320, 8, 1, gen),
        _flash_case("train L0 i2v frame-0 K/V (16, 4096, 320) h8 kv_group 16",
                    16, 4096, 320, 8, 16, gen),
        _packed_case("train L0 temporal (4096, 16, 320) h8", 4096, 16, 320, 8, gen),
        _packed_case("train L1 temporal (1024, 16, 640) h8", 1024, 16, 640, 8, gen),
        _geglu_case("train L0 M=65536 C=320 I=1280", 65536, 320, 1280, gen),
        _geglu_case("train L1 M=16384 C=640 I=2560", 16384, 640, 2560, gen),
        _geglu_case("train L2 M=4096 C=1280 I=5120", 4096, 1280, 5120, gen),
        _geglu_case("train L3 M=1024 C=1280 I=5120", 1024, 1280, 5120, gen),
        _flash_bwd_case("train L0 cross-view (16, 4096, 320) h8", 16, 4096, 320, 8, 1, gen),
        _flash_bwd_case("train L0 i2v frame-0 K/V (16, 4096, 320) h8 kv_group 16",
                        16, 4096, 320, 8, 16, gen),
        # D at 160-wide heads (the L2 sites' backward at a batch over the
        # 512 MiB line; the trainer's 256^2 L2 sites sit exactly on it)
        _flash_bwd_case("L2 cross-view (16, 1024, 1280) h8", 16, 1024, 1280, 8, 1, gen),
        _flash_bwd_case("L2 i2v frame-0 K/V (16, 1024, 1280) h8 kv_group 16",
                        16, 1024, 1280, 8, 16, gen),
        _packed_bwd_case("train L0 temporal (4096, 16, 320) h8", 4096, 16, 320, 8, gen),
        _packed_bwd_case("train L1 temporal (1024, 16, 640) h8", 1024, 16, 640, 8, gen),
        # F's route's backward (phase 6, under packed_flash) at the sampling L0 and
        # L2 shapes
        _packed_bwd_case("L0 temporal (8192, 16, 320) h8, backend packed_flash",
                         8192, 16, 320, 8, gen),
        _packed_bwd_case("L2 temporal (512, 16, 1280) h8, backend packed_flash",
                         512, 16, 1280, 8, gen),
    ]
    for r in rows:
        extra = f" lse_err {r['lse_err']:.3e}" if "lse_err" in r else ""
        print(f"[kernel] {r['name']:<15} {r['shape']:<58} max|d| {r['max_abs_err']:.3e} "
              f"(tol {r['tol']:.3e}) rel L2 {r['rel']:.3e} (tol {REL_L2_TOL:.0e}){extra} ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"library_ms {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}: {r['term']}) {'ok' if r['ok'] else 'FAIL'}")
    return rows


def e2e_phase(tmp: str, res: int = 256, per_forward: dict = PER_FORWARD,
              tag: str = "e2e") -> dict:
    """The sampling CLI at full width and ``res`` x ``res``, launch counters
    zeroed just before and read just after: at least ``per_forward`` a UNet
    forward at 256^2 (phase 3), exactly that at 512^2 (phase 3b)."""
    from PIL import Image

    from animate3d_tpu_torch.cli.inference import main as cli_main
    from animate3d_tpu_torch.ops import _build

    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (res, res, 3), dtype=np.uint8)).save(
            os.path.join(tmp, f"{i}.png"))
    steps, iters = 2, 1
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = cli_main(["--model_size", "full", "-W", str(res), "-H", str(res), "-N", "4",
                    "-L", "16", "--steps", str(steps), "--freeinit_iters", str(iters),
                    "--seed", "0", "--ip_image_root", tmp,
                    "--output_dir", os.path.join(tmp, f"out{res}")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = _build.launch_totals()
    per_shape = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    lat = out["latents"]
    with Image.open(out["gif"]) as gif:
        gif_frames = gif.n_frames
    unet_calls = steps * iters
    counts_ok = all((totals[k] == n * unet_calls) if res != 256 else (totals[k] >= n * unet_calls)
                    for k, n in per_forward.items())
    ok = (tuple(lat.shape) == (4, 16, res // 8, res // 8, 4)
          and bool(torch.isfinite(lat).all()) and gif_frames == 16 and counts_ok)
    print(f"[{tag}] full width {res}x{res}, 4 views x 16 frames, {steps} steps x {iters} "
          f"FreeInit iteration(s): wall {wall:.2f} s, step seconds "
          + ", ".join(f"{t:.4f}" for t in out["step_seconds"])
          + f"; peak memory {peak_gb:.2f} GiB; gif frames {gif_frames}; latents "
          f"{tuple(lat.shape)} finite {bool(torch.isfinite(lat).all())}")
    for k, n in per_forward.items():
        print(f"[{tag}] launches {k}: {totals[k]} (expected {n} per UNet forward x "
              f"{unet_calls} forwards = {n * unet_calls})")
    return dict(ok=ok, per_shape=per_shape, step_s=out["step_seconds"][1],
                wall_s=wall, peak_gb=peak_gb)


def _family(name: str) -> str:
    n = name.lower()
    for key, fam in (("composite_coarse_fwd_kernel", "kernel H fwd"),
                     ("composite_coarse_bwd_kernel", "kernel H bwd"),
                     ("composite_fields_fwd_kernel", "kernel G fwd"),
                     ("composite_fields_bwd_kernel", "kernel G bwd"),
                     ("topk", "top-k binning"), ("sort", "top-k binning"),
                     ("gesvd", "SVD (ARAP)"), ("svd", "SVD (ARAP)"),
                     ("scatter", "gather / scatter"), ("gather", "gather / scatter"),
                     ("index", "gather / scatter"),
                     ("flash_fwd_kernel", "kernel A flash_fwd"),
                     ("packed_attn_kernel", "kernel B packed_attn"),
                     ("geglu_gemm_kernel", "kernel C geglu"),
                     ("flash_bwd_delta_kernel", "kernel D flash_bwd Delta"),
                     ("flash_bwd_kernel", "kernel D flash_bwd pass"),
                     ("cast_scaled_kernel", "kernel D flash_bwd cast"),
                     ("cast_heads_kernel", "kernel D flash_bwd cast"),
                     ("packed_attn_bwd_kernel", "kernel E packed_attn_bwd"),
                     ("softmax", "plain attention softmax"),
                     ("conv", "convolution (cuDNN)"), ("xmma_fprop", "convolution (cuDNN)"),
                     ("implicit", "convolution (cuDNN)"),
                     ("norm", "group/layer norm"),
                     ("gemm", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
                     ("cutlass", "matmul (cuBLAS)"), ("gemv", "matmul (cuBLAS)")):
        if key in n:
            return fam
    return "elementwise / copy / other"


def _print_profile(tag: str, what: str, prof, wall_ms: float) -> None:
    """Device time by kernel family, the idle share of the host-clock wall
    and the top kernels of one profiled window."""
    fams: dict = {}
    kernels = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            fams[_family(e.key)] = fams.get(_family(e.key), 0.0) + dev_us / 1e3
            kernels.append((dev_us / 1e3, e.count, e.key))
    busy = sum(fams.values())
    if not busy:
        print(f"{tag} the profiler recorded no device time: not measured")
        return
    print(f"{tag} {what}: wall {wall_ms:.2f} ms (profiler on), device busy {busy:.2f} ms, "
          f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for fam, ms in sorted(fams.items(), key=lambda x: -x[1]):
        print(f"{tag} {fam:<28} {ms:9.3f} ms  {ms / busy:6.1%}")
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        print(f"{tag} top kernel {ms:9.3f} ms x{count:<4} {name[:90]}")


def reference_phase() -> dict:
    """One full-width UNet forward on the CFG batch (2 x 4 views x 16
    frames) profiled by kernel family, then one forward on the same batch
    through the kernels (each launched exactly its per-forward count)
    against the same forward with every op on its plain version. Tolerance:
    5e-2 relative L2, the bf16 noise of the kernels' f32 sums taken in
    another order (and so a flipped rounding of a bf16 P or GEGLU hidden
    here and there) carried through 53 blocks."""
    from torch.profiler import ProfilerActivity, profile

    from animate3d_tpu_torch.models.factory import build_models
    from animate3d_tpu_torch.ops import _build, routing
    from animate3d_tpu_torch.utils.camera import get_camera

    unet, _ = build_models("full", 4, "cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    lat = torch.randn((8, 16, 32, 32, 4), generator=gen, device="cuda")
    text = 0.5 * torch.randn((8, 77, 768), generator=gen, device="cuda")
    img = torch.randn((8, 1024), generator=gen, device="cuda")
    cam = torch.as_tensor(get_camera(4), device="cuda").repeat(2, 1)
    t = torch.tensor(501, device="cuda")
    with torch.inference_mode():
        unet(lat, t, text, cam, img)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            unet(lat, t, text, cam, img)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    _print_profile("[profile]", "one UNet forward, CFG batch 128 frames", prof, wall_ms)

    with torch.inference_mode():
        _build.reset_launches()
        out_k = unet(lat, t, text, cam, img).float()
        torch.cuda.synchronize()
        kernel_counts = _build.launch_totals()
        _build.reset_launches()
        with routing.plain_ops():
            out_p = unet(lat, t, text, cam, img).float()
        torch.cuda.synchronize()
        plain_counts = _build.launch_totals()
    rel = float((out_k - out_p).norm() / out_p.norm())
    counts_ok = kernel_counts == PER_FORWARD and not any(plain_counts.values())
    ok = rel <= 5e-2 and bool(torch.isfinite(out_k).all()) and counts_ok
    print(f"[reference] full-width UNet forward on the CFG batch, kernels vs plain ops: "
          f"relative L2 {rel:.3e} (tol 5e-2), max|d| "
          f"{float((out_k - out_p).abs().max()):.3e}, max|plain| {float(out_p.abs().max()):.3e}; "
          f"launches through the kernels {kernel_counts} (expected {PER_FORWARD}), "
          f"through the plain ops {plain_counts}")
    del unet
    torch.cuda.empty_cache()
    return dict(ok=ok, rel=rel)


def edge_phase() -> bool:
    """Shapes off the main path that exercise each kernel's edges: ragged
    q/k lengths (masked keys, partial tiles), strided views, kv_group, short
    and long sequences, a GEGLU output width that leaves a half-empty block.
    Checked against the plain versions only (not timed)."""
    from animate3d_tpu_torch.ops import attention as A
    from animate3d_tpu_torch.ops import geglu as G

    gen = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(torch.bfloat16)

    cases = []
    q, k, v = rnd(3, 1000, 80), rnd(3, 777, 80), rnd(3, 777, 80)
    cases.append(("flash ragged Sq=1000 Sk=777 h2 d40",
                  A.flash_attention(q, k, v, 2, 0.2)[0], A._flash_plain(q, k, v, 2, 0.2, 1)[0]))
    big = rnd(4, 130, 160)
    q, k, v = big[:, :, :80], rnd(2, 197, 80), rnd(2, 197, 80)
    cases.append(("flash strided q, Sk=197 h1 d80 kv_group 2",
                  A.flash_attention(q, k, v, 1, 0.1, 2)[0], A._flash_plain(q, k, v, 1, 0.1, 2)[0]))
    for b, s_, c, h in ((13, 8, 80, 2), (7, 32, 640, 8), (13, 8, 320, 2),
                         (37, 4, 80, 2), (70, 2, 640, 8)):
        q, k, v = rnd(b, s_, c), rnd(b, s_, c), rnd(b, s_, c)
        cases.append((f"packed B={b} S={s_} C={c} h{h}", A.packed_attention(q, k, v, h, 0.15),
                      A.packed_small_attention(q, k, v, h, 0.15)))
    for m, c, inner in ((300, 320, 1280), (1, 64, 64)):
        args = (rnd(m, c), rnd(2 * inner, c, std=c ** -0.5), rnd(2 * inner, std=0.1),
                rnd(c, inner, std=inner ** -0.5), rnd(c, std=0.1))
        cases.append((f"geglu M={m} C={c} I={inner}", G.geglu(*args), G._geglu_plain(*args)))

    def flash_bwd(label, q, k, v, heads, scale, kv_group):
        out, lse = A.flash_attention(q, k, v, heads, scale, kv_group)
        args = (q, k, v, out, lse, rnd(*q.shape), heads, scale, kv_group)
        cases.append((label, A.flash_attention_bwd(*args), A._flash_bwd_plain(*args)))

    flash_bwd("flash bwd d80 (2, 1024, 640) h8", rnd(2, 1024, 640), rnd(2, 1024, 640),
              rnd(2, 1024, 640), 8, 80 ** -0.5, 1)
    flash_bwd("flash bwd ragged Sq=1000 Sk=777 h2 d40", rnd(3, 1000, 80), rnd(3, 777, 80),
              rnd(3, 777, 80), 2, 0.2, 1)
    big = rnd(4, 130, 160)
    flash_bwd("flash bwd strided q, Sk=197 h1 d80 kv_group 2", big[:, :, :80],
              rnd(2, 197, 80), rnd(2, 197, 80), 1, 0.1, 2)
    flash_bwd("flash bwd kv_group 2 (4, 512, 320) h8", rnd(4, 512, 320), rnd(2, 512, 320),
              rnd(2, 512, 320), 8, 40 ** -0.5, 2)
    for b, s_, c, h in ((13, 8, 80, 2), (7, 32, 640, 8), (13, 8, 320, 2),
                         (37, 4, 80, 2), (70, 2, 640, 8)):
        args = (rnd(b, s_, c), rnd(b, s_, c), rnd(b, s_, c), rnd(b, s_, c), h, 0.15)
        cases.append((f"packed bwd B={b} S={s_} C={c} h{h}", A.packed_attention_bwd(*args),
                      A._packed_bwd_plain(*args)))
    torch.cuda.synchronize()
    ok = True
    for label, out, ref in cases:
        if isinstance(out, tuple):
            err, tol, rel, good = _agree_all(out, ref)
        else:
            err, tol, rel, good = _agree(out, ref)
        ok &= good
        print(f"[edge] {label:<48} max|d| {err:.3e} (tol {tol:.3e}) rel L2 {rel:.3e} "
              f"{'ok' if good else 'FAIL'}")
    return ok and _g_front_clamp_edge()


def _g_front_clamp_edge() -> bool:
    """Kernel G on tiles whose lists open with clamp-binding candidates
    (each divides its pixels' suffix term by 1 - alpha ~ 0.01) against G's
    plain versions in float64: planes within 1e-5, each gradient row within
    1e-4 of that row's largest magnitude."""
    from animate3d_tpu_torch.ops import rasterize as R

    ok = True
    for k in (32, 256):
        org, f = (torch.from_numpy(a).cuda() for a in _g_tiles(8, k, 20 + k, clamp_front=True))
        cot = torch.randn((8, 8, 256), generator=torch.Generator(device="cuda").manual_seed(k),
                          device="cuda") * 1e-2
        out = R.composite_fields(f, org)
        out64 = R._composite_fields_plain(f.double(), org.double())
        g = R.composite_fields_bwd(f, org, cot).double()
        g64 = R._composite_fields_bwd_plain(f.double(), org.double(), cot.double())
        torch.cuda.synchronize()
        perr = float((out.double() - out64).abs().max())
        gerr = max(float((g[:, r] - g64[:, r]).abs().max() / g64[:, r].abs().max())
                   for r in range(10))
        good = perr <= 1e-5 and gerr <= 1e-4
        ok &= good
        print(f"[edge] G front clamp (8, 12, {k}) vs float64: planes max|d| {perr:.3e} (tol "
              f"1e-05), worst gradient row max|d| / row max {gerr:.3e} (tol 1e-04) "
              f"{'ok' if good else 'FAIL'}")
    return ok


TRAIN_STEPS = 3


def _train_workspace(tmp: str) -> str:
    """A synthetic manifest (4 per-view directories of 16 PNG frames at
    256^2) and the trainer config: configs/training/train.yaml's values
    with gradient checkpointing, 3 steps, random weights from seed 0."""
    from PIL import Image

    rng = np.random.default_rng(3)
    views = []
    for v in range(4):
        d = os.path.join(tmp, "vids", f"view{v}")
        os.makedirs(d)
        for fi in range(16):
            Image.fromarray(rng.integers(0, 255, (256, 256, 3), dtype=np.uint8)).save(
                os.path.join(d, f"{fi:02d}.png"))
        views.append(f"view{v}")
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump([{"videos": views, "caption": "a toy"}], fh)
    cfg = os.path.join(tmp, "train.yaml")
    with open(cfg, "w") as fh:
        fh.write(f"""output_dir: {tmp}/out
model_size: full
num_views: 4
video_length: 16
sample_size: 256
cfg_random_null_text_ratio: 0.1
train_data:
  manifest_path: {tmp}/manifest.json
  video_root: {tmp}/vids
  total_frames: 16
learning_rate: 1.0e-4
train_batch_size: 1
max_grad_norm: 1.0
max_train_steps: {TRAIN_STEPS}
checkpointing_steps: 1000
gradient_checkpointing: true
log_every_n_steps: 1
global_seed: 0
""")
    return cfg


def train_phase(tmp: str) -> dict:
    """The trainer CLI at full width for TRAIN_STEPS steps, launch counters
    zeroed just before and read just after; then the trained module against
    a fresh build from the same seed: frozen parameters bit-identical,
    trainable masters moved."""
    from animate3d_tpu_torch.cli.train_mvvdm import main as train_main
    from animate3d_tpu_torch.models.factory import build_models
    from animate3d_tpu_torch.ops import _build

    cfg = _train_workspace(tmp)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = train_main(["--config", cfg])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = _build.launch_totals()
    per_shape = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["loss"] for m in res["metrics"]]
    step_seconds = res["step_seconds"][1:]  # after the first (warm-up) step
    expected = {k: n * TRAIN_STEPS for k, n in PER_TRAIN_STEP.items()}

    unet, masters = res["unet"], res["optimizer"].masters
    fresh, _ = build_models("full", 4, "cuda", seed=0, train=True)
    params = dict(unet.named_parameters())
    frozen_same = moved = 0
    for name, p0 in fresh.named_parameters():
        if name in masters:
            moved += int(not torch.equal(masters[name], p0.detach()))
        else:
            frozen_same += int(torch.equal(params[name], p0.detach().to(params[name].dtype)))
    n_frozen = len(params) - len(masters)
    del fresh, unet, res
    torch.cuda.empty_cache()
    out = os.path.join(tmp, "out")
    written = all(os.path.exists(os.path.join(out, d, f"step_{TRAIN_STEPS}", "checkpoint.pt"))
                  for d in ("checkpoints", "motion_modules"))
    step_s = float(np.mean(step_seconds))
    ok = (len(losses) == TRAIN_STEPS and all(np.isfinite(losses)) and totals == expected
          and frozen_same == n_frozen and moved >= 0.9 * len(masters) and written)
    print(f"[train] full width 256x256, 4 views x 16 frames, batch 1, gradient checkpointing, "
          f"{TRAIN_STEPS} steps: wall {wall:.2f} s, step seconds "
          + ", ".join(f"{t:.4f}" for t in step_seconds)
          + f"; peak memory {peak_gb:.2f} GiB; losses "
          + ", ".join(f"{x:.5f}" for x in losses))
    print(f"[train] launches {totals} (expected {expected}: {PER_TRAIN_STEP} per step)")
    print(f"[train] frozen parameters bit-identical {frozen_same}/{n_frozen}; trainable "
          f"masters moved {moved}/{len(masters)}; checkpoints/step_{TRAIN_STEPS} and "
          f"motion_modules/step_{TRAIN_STEPS} written {written}")
    return dict(ok=ok, per_shape=per_shape, step_s=step_s, wall_s=wall, peak_gb=peak_gb)


def train_reference_phase() -> dict:
    """One full-width loss + backward on a fixed batch with fixed draws
    through the kernels (after one warm-up step, under torch.profiler:
    device time by kernel family), against the same step with every op on
    its plain version. Tolerances: the loss within 1e-2 relative, the concatenated
    trainable gradient within 5e-2 relative L2: the kernels' bf16 rounding
    (f32 sums in another order, so a flipped rounding of a bf16 P, dS or
    GEGLU hidden here and there) carried through the 53 blocks forward and
    back again, as for the forward reference."""
    from torch.profiler import ProfilerActivity, profile

    from animate3d_tpu_torch.models.diffusion import DDIMScheduler
    from animate3d_tpu_torch.models.factory import build_models
    from animate3d_tpu_torch.ops import _build, routing
    from animate3d_tpu_torch.pipelines.train_mvvdm import (
        MVVDMTrainConfig,
        TrainBatch,
        cast_frozen_bf16,
        loss_fn,
    )
    from animate3d_tpu_torch.utils.camera import get_camera

    unet, _ = build_models("full", 4, "cuda", seed=0, train=True, gradient_checkpointing=True)
    masters = cast_frozen_bf16(unet)
    gen = torch.Generator(device="cuda").manual_seed(4)
    batch = TrainBatch(
        latents=torch.randn((4, 16, 32, 32, 4), generator=gen, device="cuda"),
        text_ctx=0.5 * torch.randn((4, 77, 768), generator=gen, device="cuda"),
        null_text_ctx=torch.zeros((4, 77, 768), device="cuda"),
        camera=torch.as_tensor(get_camera(4), device="cuda"),
        image_embeds=torch.randn((4, 1024), generator=gen, device="cuda"))
    t = torch.tensor([501], device="cuda")
    noise = torch.randn((4, 15, 32, 32, 4), generator=gen, device="cuda")
    drop = torch.tensor([False], device="cuda")
    tcfg, sched = MVVDMTrainConfig(), DDIMScheduler(device="cuda")
    params = dict(unet.named_parameters())

    def step():
        _build.reset_launches()
        loss = loss_fn(unet, batch, t, noise, drop, tcfg, sched)
        loss.backward()
        torch.cuda.synchronize()
        grads = torch.cat([params[n].grad.float().reshape(-1) for n in masters])
        for n in masters:
            params[n].grad = None
        return float(loss.detach()), grads, _build.launch_totals()

    step()  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss_k, grad_k, counts_k = step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _print_profile("[train-profile]", "one loss + backward at full width (64 frames, "
                   "gradient checkpointing)", prof, wall_ms)
    with routing.plain_ops():
        loss_p, grad_p, counts_p = step()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    rel = float((grad_k - grad_p).norm() / grad_p.norm())
    ok = (loss_rel <= 1e-2 and rel <= 5e-2 and bool(torch.isfinite(grad_k).all())
          and counts_k == PER_TRAIN_STEP and not any(counts_p.values()))
    print(f"[train-reference] full-width loss + backward, kernels vs plain ops: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (relative {loss_rel:.3e}, tol 1e-2); trainable "
          f"gradient ({grad_k.numel()} values) relative L2 {rel:.3e} (tol 5e-2), norms "
          f"{float(grad_k.norm()):.4e} vs {float(grad_p.norm()):.4e}; launches through the "
          f"kernels {counts_k} (expected {PER_TRAIN_STEP}), through the plain ops {counts_p}")
    del unet, grad_k, grad_p
    torch.cuda.empty_cache()
    return dict(ok=ok, rel=rel, loss_rel=loss_rel)


RECON_YAML = "configs/animate3d/motion_recon_frame_16.yaml"
EVAL_YAML = "configs/animate3d/visualize_testset_frame_16.yaml"
RECON_N, RECON_VIEWS, RECON_FRAMES, RECON_RES, RECON_EVAL = 20000, 4, 16, 256, 512
FIELDS_RES = 64  # the largest image of kernel G's route: 16 tiles of 16^2
TESTSET_RES, TESTSET_VIEWS, ORBIT_FRAMES = 1024, 12, 120
RECON_STEPS = 3
# f32 operations per (pixel, candidate) pair that H's and G's functions
# need: evaluating a candidate's alpha (offsets, conic form, exp, gates)
# takes 14; a live alpha adds 12 in the forward (weight, 4 channel sums,
# alpha sum, transmittance) and 40 in the backward (transmittance, weight,
# dw, dalpha, suffix, the 10 gradient terms). The backward's function needs
# alpha once a pair: the kernels' second and third evaluations (block
# recompute, reverse walk) are their own strategy and are not counted. H
# evaluates the pairs its AABB gate and early stop leave; G every pair.
H_FWD_OPS = (14, 12)
H_BWD_OPS = (14, 40)
H_PLANE_TOL, H_PLANE_REL, H_GRAD_REL = 2.0 ** -6, 1e-4, 1e-3


def _g_tiles(n_t: int, k: int, seed: int, clamp_front: bool = False):
    """Synthetic kernel-G fields on a grid of 16x16 tiles, 32 tiles a row:
    per tile K depth-sorted candidates centred within 6 px around it, 1-6
    px wide, opacity U(0.05, 1), 10% not ``ok``, and 4 wide candidates of
    opacity 1 where the 0.99 clamp binds, at the back of each list (with
    ``clamp_front``, at the front). The layout of
    tests/test_torch_fields.py::make_fields: an asset that covers its
    tiles, where the recon asset is faint. → (origins (T, 2), fields (T, 12,
    K)) as numpy float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_t)
    org = np.stack([t % 32 * 16, t // 32 * 16], 1).astype(np.float32)
    f = np.zeros((n_t, 12, k), np.float32)
    f[:, 0] = rng.uniform(org[:, :1] - 6, org[:, :1] + 22, (n_t, k))
    f[:, 1] = rng.uniform(org[:, 1:] - 6, org[:, 1:] + 22, (n_t, k))
    sx, sy = rng.uniform(1.0, 6, (n_t, k)), rng.uniform(1.0, 6, (n_t, k))
    rho = rng.uniform(-0.5, 0.5, (n_t, k))
    c00, c11, c01 = sx ** 2, sy ** 2, rho * sx * sy
    det = c00 * c11 - c01 ** 2
    f[:, 2], f[:, 3], f[:, 4] = c11 / det, -c01 / det, c00 / det
    f[:, 5] = rng.uniform(0.05, 1.0, (n_t, k))
    cl = slice(0, 4) if clamp_front else slice(-4, None)
    f[:, 2, cl], f[:, 3, cl], f[:, 4, cl], f[:, 5, cl] = 1 / 64, 0.0, 1 / 64, 1.0
    f[:, 6:9] = rng.uniform(0, 1, (n_t, 3, k))
    f[:, 9] = np.sort(rng.uniform(1, 5, (n_t, k)), axis=-1)
    f[:, 10] = rng.uniform(size=(n_t, k)) > 0.1
    return org, f


def _recon_state(device):
    """The recon asset: ``random_state(n=20000, radius=0.4)`` from seed 0."""
    from animate3d_tpu_torch.gaussians.state import random_state

    return random_state(RECON_N, radius=0.4, generator=torch.Generator().manual_seed(0),
                        device=device)


def _raster_fields(route: str, cams: dict, n_renders: int):
    """Kernel H's (``route`` "coarse") or G's ("tile") inputs as the path
    builds them: the recon asset projected and binned by the port through
    the first ``n_renders`` cameras of the batch ``cams``, at its size."""
    from animate3d_tpu_torch.data.cameras import gs_cameras_from_batch
    from animate3d_tpu_torch.ops import rasterize as R

    st = _recon_state("cuda")
    idx = torch.arange(n_renders, device="cuda")
    b, n = n_renders, st.num_points
    fn = R.coarse_fields if route == "coarse" else R.tile_fields
    with torch.no_grad():
        fields, orig, _, _ = fn(
            st.xyz.expand(b, n, 3), st.get_scaling().expand(b, n, 3),
            st.get_rotation().expand(b, n, 4), st.get_opacity().reshape(-1),
            gs_cameras_from_batch(cams, device="cuda").index(idx),
            R.RasterConfig(height=cams["height"], width=cams["width"]), shs=st.get_features())
    return fields, orig


def _composite_rows(kernel: str, label, fields, orig, gen, backward=True) -> list:
    """Kernel H or G forward (and backward) on path fields against the
    plain versions. Limits: planes max |diff| <= 2^-6 (one flipped 1/255
    gate or 0.99 clamp moves a pixel by at most 1/255 T) and relative L2 <=
    1e-4; field gradients relative L2 <= 1e-3 (sums over a tile's pixels in
    another order, amplified by 1 / (1 - alpha) <= 100). The bound counts
    the rows each kernel reads (H: 12, G: rows 0-10) and 6 cotangent planes."""
    from animate3d_tpu_torch.ops import rasterize as R

    n, _, k = fields.shape
    if kernel == "H":
        name, key, rows = "composite_coarse", (n, k, 4), 12
        fwd, bwd = R.composite_coarse, R.composite_coarse_bwd
        fwd_plain, bwd_plain = R._composite_coarse_plain, R._composite_coarse_bwd_plain
    else:
        name, key, rows = "composite_fields", (n, k), 11
        fwd, bwd = R.composite_fields, R.composite_fields_bwd
        fwd_plain, bwd_plain = R._composite_fields_plain, R._composite_fields_bwd_plain
    shape = f"{label} fields ({n}, 12, {k})"
    in_bytes = 4.0 * (n * rows * k + orig.numel())
    out = fwd(fields, orig)
    ref, pairs, live = fwd_plain(fields, orig, count_pairs=True)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = float((out - ref).norm() / ref.norm())
    ok = err <= H_PLANE_TOL and rel <= H_PLANE_REL and bool(torch.isfinite(out).all())
    bound, by = _bound_f32(H_FWD_OPS[0] * pairs + H_FWD_OPS[1] * live,
                           in_bytes + 4.0 * out.numel())
    res = [dict(name=f"{name}_fwd", shape=shape, keys=[(f"{name}_fwd", key)],
                max_abs_err=err, tol=H_PLANE_TOL, rel=rel, rel_tol=H_PLANE_REL, ok=ok,
                pairs=pairs, live=live, ms=_time_ms(lambda: fwd(fields, orig), 10),
                plain_ms=_time_ms(lambda: fwd_plain(fields, orig), 1),
                library_ms=None, bound_ms=bound, bound_by=by)]
    if backward:
        cot = torch.randn(out.shape, generator=gen, device="cuda") * 1e-3
        g = bwd(fields, orig, cot)
        gref = bwd_plain(fields, orig, cot)
        torch.cuda.synchronize()
        rel = float((g - gref).norm() / gref.norm())
        ok = (rel <= H_GRAD_REL and bool(torch.isfinite(g).all())
              and float(g[:, 10:].abs().max()) == 0)
        # planes 0-5 of the cotangent (r, g, b, alpha, depth, T_final)
        bound, by = _bound_f32(H_BWD_OPS[0] * pairs + H_BWD_OPS[1] * live,
                               in_bytes + 4.0 * (cot.numel() * 6 // 8 + g.numel()))
        res.append(dict(
            name=f"{name}_bwd", shape=shape, keys=[(f"{name}_bwd", key)],
            max_abs_err=float((g - gref).abs().max()), tol=None, rel=rel, rel_tol=H_GRAD_REL,
            ok=ok, pairs=pairs, live=live, ms=_time_ms(lambda: bwd(fields, orig, cot), 5),
            plain_ms=_time_ms(lambda: bwd_plain(fields, orig, cot), 1),
            library_ms=None, bound_ms=bound, bound_by=by))
    return res


def _bound_f32(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def composite_kernel_phase() -> list:
    """Kernels H and G at every shape the stage-1 paths give them. H: the
    step's renders at 256^2 (64 at the full schedule, 32 / 16 / 8 at the
    frame buckets 8 / 4 / 2), forward and backward; forward only for the
    four-view test's 64 renders at 512^2, the validation orbit's 120 at
    512^2 and one 32-render call of the testset grid at 1024^2. G: the
    fields route's step at 64^2 (64 and 8 renders), forward and backward,
    and the step's shape on dense synthetic tiles (:func:`_g_tiles`).
    No PyTorch call computes H or G: library_ms is null."""
    from animate3d_tpu_torch.data.cameras import (
        fixed_view_cameras,
        testset_grid_cameras,
        val_orbit_cameras,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    fixed = lambda res: fixed_view_cameras(height=res, width=res, total_frame=RECON_FRAMES)
    fields, corig = _raster_fields("coarse", fixed(RECON_RES), RECON_VIEWS * RECON_FRAMES)
    rows = []
    for renders, label in ((64, "recon step, 64 renders at 256^2"),
                           (32, "bucket 8, 32 renders at 256^2"),
                           (16, "bucket 4, 16 renders at 256^2"),
                           (8, "bucket 2, 8 renders at 256^2")):
        n_ct = renders * 16
        rows += _composite_rows("H", label, fields[:n_ct].contiguous(),
                                corig[:n_ct].contiguous(), gen)
    for route, cams, renders, label in (
            ("coarse", fixed(RECON_EVAL), 64, "test pass, 64 renders at 512^2"),
            ("coarse", val_orbit_cameras(ORBIT_FRAMES, height=RECON_EVAL, width=RECON_EVAL,
                                         total_frame=RECON_FRAMES),
             ORBIT_FRAMES, "validate orbit, 120 renders at 512^2"),
            ("coarse", testset_grid_cameras(height=TESTSET_RES, width=TESTSET_RES,
                                            total_frame=RECON_FRAMES),
             32, "testset, one 32-render call at 1024^2")):
        del fields, corig
        fields, corig = _raster_fields(route, cams, renders)
        rows += _composite_rows("H", label, fields, corig, gen, backward=False)
    del fields, corig
    fields, orig = _raster_fields("tile", fixed(FIELDS_RES), RECON_VIEWS * RECON_FRAMES)
    for renders, label in ((64, "fields step, 64 renders at 64^2"),
                           (8, "fields bucket 2, 8 renders at 64^2")):
        n_t = renders * 16
        rows += _composite_rows("G", label, fields[:n_t].contiguous(), orig[:n_t].contiguous(),
                                gen)
    # the step's shape on an asset that covers its tiles (the recon asset is faint)
    d_org, d_f = (torch.from_numpy(a).cuda() for a in _g_tiles(1024, 256, 3))
    rows += _composite_rows("G", "dense synthetic tiles, 1024 of", d_f, d_org, gen)
    for r in rows:
        tol = f"(tol {r['tol']:.3e}) " if r["tol"] is not None else ""
        print(f"[kernel] {r['name']:<20} {r['shape']:<64} max|d| {r['max_abs_err']:.3e} {tol}"
              f"rel L2 {r['rel']:.3e} (tol {r['rel_tol']:.0e}) ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms none bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}; {r['pairs']} pairs, {r['live']} live, share "
              f"{r['live'] / r['pairs']:.4f}) "
              f"{'ok' if r['ok'] else 'FAIL'}")
    return rows


def packed_flash_phase() -> dict:
    """Kernel F's route on the main path's widths: two motion-module
    temporal attentions, L0 (8192 sequences of 16 frames, 320 channels, 8
    heads of 40) and L2 (512 sequences, 1280 channels, 8 heads of 160),
    bf16, each forward and backward under attention_backend
    ("packed_flash"), counters zeroed just before and read just after
    (kernel B as F forward, E backward), against the same layers on the
    plain versions."""
    from animate3d_tpu_torch.models.attention_layers import TemporalSelfAttention
    from animate3d_tpu_torch.ops import _build, routing
    from animate3d_tpu_torch.ops.attention import attention_backend

    torch.manual_seed(7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    sites = []
    for b, c in ((8192, 320), (512, 1280)):
        layer = TemporalSelfAttention(c, 8).to("cuda", torch.bfloat16)
        sites.append((layer, torch.randn((b, 16, c), generator=gen, device="cuda")
                      .to(torch.bfloat16)))

    def run():
        xgs = [x.clone().requires_grad_() for _, x in sites]
        _build.reset_launches()
        with attention_backend("packed_flash"):
            outs = [layer(xg) for (layer, _), xg in zip(sites, xgs)]
            sum(o.float().square().mean() for o in outs).backward()
        torch.cuda.synchronize()
        return ([o.detach() for o in outs], [xg.grad for xg in xgs], _build.launch_totals(),
                dict(_build.LAUNCHES))

    outs_k, grads_k, counts_k, per_shape = run()
    with routing.plain_ops():
        outs_p, grads_p, counts_p, _ = run()
    ok = counts_k == PER_PACKED_FLASH and not any(counts_p.values())
    for (_, x), out_k, out_p, gk, gp in zip(sites, outs_k, outs_p, grads_k, grads_p):
        err, tol, rel, good = _agree(out_k, out_p)
        gerr, gtol, grel, ggood = _agree(gk, gp)
        ok = ok and good and ggood
        print(f"[packed-flash] temporal attention {tuple(x.shape)} h8 under attention_backend"
              f"('packed_flash'), kernels vs plain: out max|d| {err:.3e} (tol {tol:.3e}) rel "
              f"L2 {rel:.3e}; input gradient max|d| {gerr:.3e} (tol {gtol:.3e}) rel L2 "
              f"{grel:.3e}")
    print(f"[packed-flash] launches {counts_k} (expected {PER_PACKED_FLASH}), plain {counts_p}, "
          f"by shape {per_shape}")
    return dict(ok=ok, per_shape=per_shape)


def _recon_workspace(tmp: str):
    """The recon config's inputs, made from seed 0: the asset written as a
    .ply by the port, and 64 RGBA frames (4 views x 16, view-major
    ``{i}.png``) rendered by the port from the same asset, each frame under
    its own translation (frame 0 static)."""
    from PIL import Image

    from animate3d_tpu_torch.data.cameras import fixed_view_cameras, gs_cameras_from_batch
    from animate3d_tpu_torch.gaussians.ply import write_gaussian_ply
    from animate3d_tpu_torch.rendering.renderer4d import Renderer4DConfig, render_batch

    st = _recon_state("cuda")
    ply = os.path.join(tmp, "asset.ply")
    write_gaussian_ply(ply, st)
    shift = 0.03 * torch.randn((RECON_FRAMES, 3), generator=torch.Generator().manual_seed(1))
    shift = shift.cuda()
    cams = fixed_view_cameras(height=RECON_RES, width=RECON_RES, total_frame=RECON_FRAMES)
    b, n = RECON_VIEWS * RECON_FRAMES, st.num_points
    frame = torch.arange(b, device="cuda") % RECON_FRAMES

    def deform(_):
        return (st.xyz + shift[frame][:, None], st.get_rotation().expand(b, n, 4),
                st.get_scaling().expand(b, n, 3))

    with torch.no_grad():
        out = render_batch(st, deform, gs_cameras_from_batch(cams, device="cuda"),
                           torch.as_tensor(cams["timestamps"], device="cuda"),
                           Renderer4DConfig(back_ground_color=(0.5, 0.5, 0.5)),
                           do_reconstruction=False)
    rgba = torch.cat([out.rgb, out.alpha[..., None]], -1).clamp(0, 1).mul(255).byte().cpu()
    frames = os.path.join(tmp, "frames")
    os.makedirs(frames)
    for i in range(b):
        Image.fromarray(rgba[i].numpy(), "RGBA").save(os.path.join(frames, f"{i}.png"))
    print(f"[recon] workspace: {n} gaussians, {b} frames of {RECON_RES}^2, mean alpha "
          f"{float(out.alpha.mean()):.3f}")
    return ply, frames


def _recon_args(tmp: str, ply: str, frames: str, res: int, eval_res: int) -> list:
    """The dotted overrides of the recon config: the prompt (the yaml's ???),
    the data paths, the output root, the render and test sizes."""
    return ["system.prompt_processor.prompt=a toy", f"data.image_root={frames}",
            f"system.geometry.geometry_convert_from={ply}", f"exp_root_dir={tmp}/out{res}",
            f"data.height={res}", f"data.width={res}", f"data.eval_height={eval_res}",
            f"data.eval_width={eval_res}"]


def recon_phase(tmp: str, ply: str, frames: str, res: int, eval_res: int,
                per_step: dict, tag: str) -> dict:
    """The recon CLI with the shipped config for RECON_STEPS steps plus its
    four-view test pass at ``eval_res``^2, launch counters zeroed just
    before and read just after. The only changes are dotted overrides
    (:func:`_recon_args`), the step count and trajectories on. The test
    pass composites its 64 renders in one forward launch and writes the
    PSNR / SSIM report against the frames."""
    from PIL import Image

    from animate3d_tpu_torch.cli.launch import main as launch_main
    from animate3d_tpu_torch.ops import _build

    args = ["--config", RECON_YAML, "--train", *_recon_args(tmp, ply, frames, res, eval_res),
            f"trainer.max_steps={RECON_STEPS}", "system.save_gaussian_trajectory=true"]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res_ = launch_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals, per_shape = _build.launch_totals(), dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {k: n * RECON_STEPS for k, n in per_step.items()}
    fwd_key = next(k for k, n in per_step.items() if n and k.endswith("_fwd"))
    expected[fwd_key] += 1  # the test pass: 64 renders in one launch
    trial = res_["trial_dir"]
    metrics = res_["metrics"]
    images = sorted(os.listdir(os.path.join(trial, "save", "images")))
    with Image.open(os.path.join(trial, "save", "images", images[0])) as im:
        size, mode = im.size, im.mode
    trajs = os.listdir(os.path.join(trial, "save", "gaussian_trajectory"))
    ckpt = os.path.exists(os.path.join(trial, "ckpts", f"step_{RECON_STEPS}", "checkpoint.pt"))
    losses = [m["loss"] for m in metrics]
    report = res_["report"]
    ok = (totals == expected and len(losses) == RECON_STEPS and all(np.isfinite(losses))
          and ckpt and len(images) == RECON_VIEWS * RECON_FRAMES
          and size == (eval_res, eval_res) and mode == "RGBA"
          and len(trajs) == RECON_FRAMES and np.isfinite(res_["rgb"]).all()
          and len(res_["videos"]) == RECON_VIEWS and all(map(os.path.exists, res_["videos"]))
          and np.isfinite([report["psnr"], report["ssim"]]).all())
    print(f"[{tag}] CLI --train at {res}^2, {RECON_STEPS} steps + four-view test at "
          f"{eval_res}^2: wall {wall:.2f} s; peak memory {peak_gb:.2f} GiB; losses "
          + ", ".join(f"{x:.5f}" for x in losses)
          + "; metrics.jsonl keys " + ",".join(sorted(metrics[-1])))
    print(f"[{tag}] launches {totals} (expected {expected}: {per_step} per step, one "
          f"forward for the test pass); per shape {per_shape}")
    print(f"[{tag}] ckpts/step_{RECON_STEPS} written {ckpt}; {len(images)} test images "
          f"{size} {mode}; {len(res_['videos'])} videos ({os.path.basename(res_['videos'][0])}); "
          f"{len(trajs)} trajectories; test report PSNR {report['psnr']} SSIM "
          f"{report['ssim']}; raster overflow in the test pass {res_['overflow']}")
    return dict(ok=ok, per_shape=per_shape, system=res_["system"], trial=trial, wall_s=wall,
                peak_gb=peak_gb)


def _recon_batch(system, frames: str) -> dict:
    from animate3d_tpu_torch.data.cameras import gs_cameras_from_batch
    from animate3d_tpu_torch.data.multi_image import MultiImageConfig, MultiImageDataset

    res = system.cfg.renderer.height
    raw = MultiImageDataset(MultiImageConfig(image_root=frames, height=res, width=res)).batch(0)
    return {"gs_cameras": gs_cameras_from_batch(raw, device="cuda"),
            "timestamps": raw["timestamps"], "rgb": torch.as_tensor(raw["rgb"], device="cuda"),
            "mask": torch.as_tensor(raw["mask"].astype(np.float32), device="cuda")}


def recon_timing_phase(system, frames: str, per_step: dict, tag: str,
                       buckets: bool = True) -> dict:
    """Seconds per recon step (host clock, ended by a synchronize; one
    warm-up step, then the mean of 3) at the full schedule
    (global_step = 50 x 16 + 1: all 64 renders) and, with ``buckets``, at
    the frame buckets 2 / 4 / 8, with their schedule-weighted average over
    the 800-step run (steps 0-99 bucket 2, 100-199 bucket 4, 200-399
    bucket 8, 400-799 all 16 frames: the JAX package's bench.py
    definition). Launch counters zeroed just before, read just after; then
    one full-schedule step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from animate3d_tpu_torch.ops import _build

    batch = _recon_batch(system, frames)
    ipf = system.cfg.progressive_iter_per_frame
    iters = 3

    def measure(gstep: int) -> float:
        system.global_step = gstep
        system.step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            system.step(batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    full = measure(ipf * RECON_FRAMES + 1)
    t2 = t4 = t8 = avg = float("nan")
    measured = 1
    if buckets:
        t2, t4, t8 = measure(ipf + 10), measure(3 * ipf + 10), measure(7 * ipf + 10)
        avg = (100 * t2 + 100 * t4 + 200 * t8 + 400 * full) / 800.0
        measured = 4
    totals, per_shape = _build.launch_totals(), dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = measured * (iters + 1)
    expected = {k: n * steps for k, n in per_step.items()}
    res = system.cfg.renderer.height
    print(f"[{tag}-time] seconds per recon step at {res}^2: full schedule (64 renders) "
          f"{full:.4f}" + (f"; buckets 2 / 4 / 8 (8 / 16 / 32 renders) {t2:.4f} / {t4:.4f} / "
                           f"{t8:.4f}; schedule average {avg:.4f}" if buckets else "")
          + f"; peak memory {peak_gb:.2f} GiB")
    print(f"[{tag}-time] launches {totals} over {steps} steps (expected {expected})")

    system.global_step = ipf * RECON_FRAMES + 1
    system.step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _print_profile(f"[{tag}-profile]", f"one recon step at the full schedule (64 renders at "
                   f"{res}^2, 20,000 gaussians)", prof, wall_ms)
    return dict(ok=totals == expected and np.isfinite(full), per_shape=per_shape, step_s=full,
                buckets=(t2, t4, t8), avg_s=avg, peak_gb=peak_gb, batch=batch)


def recon_reference_phase(system, batch, per_step: dict, tag: str) -> dict:
    """One full-schedule recon loss + backward (all 64 renders, fixed draws)
    through the compositing kernel against the same step on its plain
    versions. Limits: the loss within 1e-4 relative, the concatenated
    parameter gradient within 1e-3 relative L2 (the kernel's f32 sums in
    another order, carried through the gathers of the K-planes and the
    deformation MLPs)."""
    from animate3d_tpu_torch.ops import _build, routing
    from animate3d_tpu_torch.rendering.renderer4d import make_draws
    from animate3d_tpu_torch.systems.animate3d import StepDraws

    system.global_step = system.cfg.progressive_iter_per_frame * RECON_FRAMES + 1
    cams, ts, rgb, mask, fw = system.step_batch(batch)
    gen = torch.Generator(device="cuda").manual_seed(6)
    n = system.state.num_points
    draws = StepDraws(render=make_draws(system.cfg.renderer, len(ts), n, gen, "cuda"),
                      arap_idx=torch.randint(0, n, (system.cfg.loss.arap_sample_num,),
                                             generator=gen, device="cuda"))
    params = [p for _, p in system.field.named_parameters()]
    ts, fw = torch.as_tensor(ts, device="cuda"), torch.as_tensor(fw, device="cuda")

    def run():
        _build.reset_launches()
        loss, _ = system.loss(cams, ts, rgb, mask, fw, system.lambdas(system.global_step),
                              draws)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        flat = torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                          for g, p in zip(grads, params)])
        return float(loss.detach()), flat, _build.launch_totals()

    loss_k, g_k, counts_k = run()
    with routing.plain_ops():
        loss_p, g_p, counts_p = run()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    rel = float((g_k - g_p).norm() / g_p.norm())
    ok = (loss_rel <= 1e-4 and rel <= 1e-3 and bool(torch.isfinite(g_k).all())
          and counts_k == per_step and not any(counts_p.values()))
    res = system.cfg.renderer.height
    print(f"[{tag}-reference] recon loss + backward at {res}^2 (64 renders), kernels vs plain: "
          f"loss {loss_k:.7f} vs {loss_p:.7f} (relative {loss_rel:.3e}, tol 1e-4); parameter "
          f"gradient ({g_k.numel()} values) relative L2 {rel:.3e} (tol 1e-3), norms "
          f"{float(g_k.norm()):.4e} vs {float(g_p.norm()):.4e}; launches through the kernels "
          f"{counts_k} (expected {per_step}), through the plain ops {counts_p}")
    return dict(ok=ok, rel=rel, loss_rel=loss_rel)


def _cli_launches(args: list):
    """One run of the 4D-stage CLI with the launch counters zeroed just
    before and read just after: (result, wall s, totals, per shape)."""
    from animate3d_tpu_torch.cli.launch import main as launch_main
    from animate3d_tpu_torch.ops import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    res = launch_main(args)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, _build.launch_totals(), dict(_build.LAUNCHES)


def eval_phase(tmp: str, ply: str, frames: str, trial: str) -> dict:
    """The evaluation entry points on the 256^2 recon trial: ``--test`` with
    the testset config (12 views x 16 frames at 1024^2, resumed from the
    trial's checkpoint; kernel H forward in 32-render calls), then the same
    render under torch.profiler (wall, device busy, peak), ``--validate``
    (the 120-frame orbit at 512^2) and ``--export`` (the four-view test with
    trajectories and the PSNR / SSIM report)."""
    from torch.profiler import ProfilerActivity, profile
    from PIL import Image

    from animate3d_tpu_torch.cli.launch import _eval_renderer_cfg
    from animate3d_tpu_torch.data.cameras import gs_cameras_from_batch, testset_grid_cameras
    from animate3d_tpu_torch.rendering.renderer4d import _PLANE_ELEMS

    ckpt = os.path.join(trial, "ckpts", f"step_{RECON_STEPS}")
    args = ["--config", EVAL_YAML, "--test", f"resume={ckpt}",
            f"system.geometry.geometry_convert_from={ply}", f"exp_root_dir={tmp}/eval"]
    torch.cuda.reset_peak_memory_stats()
    res, wall, totals, per_shape = _cli_launches(args)
    peak_cli = torch.cuda.max_memory_allocated() / 2 ** 30
    renders = TESTSET_VIEWS * RECON_FRAMES
    per_call = _PLANE_ELEMS // ((TESTSET_RES // 16) ** 2 * 8 * 256)
    expected = _per(composite_coarse_fwd=-(-renders // per_call))
    save = os.path.join(res["trial_dir"], "save")
    images = os.listdir(os.path.join(save, "images"))
    with Image.open(os.path.join(save, "images", "0.png")) as im:
        size = im.size
    ok_test = (totals == expected and len(images) == renders
               and size == (TESTSET_RES, TESTSET_RES) and len(res["videos"]) == TESTSET_VIEWS
               and all(map(os.path.exists, res["videos"])) and np.isfinite(res["rgb"]).all())
    print(f"[eval] --test testset ({TESTSET_VIEWS} views x {RECON_FRAMES} frames at "
          f"{TESTSET_RES}^2): wall {wall:.2f} s (pngs and videos included); peak memory "
          f"{peak_cli:.2f} GiB; {len(images)} images {size}; {len(res['videos'])} videos "
          f"({os.path.basename(res['videos'][0])}); launches {totals} (expected {expected}: "
          f"{per_call} renders a call); raster overflow {res['overflow']}")

    system = res["system"]
    cams = testset_grid_cameras(height=TESTSET_RES, width=TESTSET_RES, total_frame=RECON_FRAMES)
    gcams = gs_cameras_from_batch(cams, device="cuda")
    rcfg = _eval_renderer_cfg(system, TESTSET_RES, TESTSET_RES)
    system.render(gcams, cams["timestamps"], renderer_cfg=rcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = system.render(gcams, cams["timestamps"], renderer_cfg=rcfg)
        torch.cuda.synchronize()
        render_ms = (time.perf_counter() - t0) * 1e3
    peak_render = torch.cuda.max_memory_allocated() / 2 ** 30
    del out, system, res
    torch.cuda.empty_cache()
    _print_profile("[eval-profile]", f"the testset render alone ({renders} renders at "
                   f"{TESTSET_RES}^2)", prof, render_ms)
    print(f"[eval] testset render alone: wall {render_ms:.2f} ms (profiler on), peak memory "
          f"{peak_render:.2f} GiB")

    base = ["--config", RECON_YAML, *_recon_args(tmp, ply, frames, RECON_RES, RECON_EVAL)]
    res, wall_v, totals_v, shape_v = _cli_launches(base[:2] + ["--validate"] + base[2:])
    ok_val = (totals_v == _per(composite_coarse_fwd=1) and res["rgb"].shape ==
              (ORBIT_FRAMES, RECON_EVAL, RECON_EVAL, 3) and os.path.exists(res["video"])
              and os.path.exists(res["gif"]) and np.isfinite(res["rgb"]).all())
    print(f"[eval] --validate: {res['rgb'].shape[0]}-frame orbit at {RECON_EVAL}^2 in "
          f"{wall_v:.2f} s; {os.path.basename(res['video'])}, {os.path.basename(res['gif'])}; "
          f"launches {totals_v}")
    del res
    res, wall_e, totals_e, shape_e = _cli_launches(base[:2] + ["--export"] + base[2:])
    trajs = os.listdir(os.path.join(res["trial_dir"], "save", "gaussian_trajectory"))
    report = res["report"]
    ok_exp = (totals_e == _per(composite_coarse_fwd=1) and len(trajs) == RECON_FRAMES
              and report is not None and np.isfinite([report["psnr"], report["ssim"]]).all())
    print(f"[eval] --export: {len(trajs)} trajectory files, four-view test in {wall_e:.2f} s, "
          f"report PSNR {report['psnr']} dB SSIM {report['ssim']} (LPIPS "
          f"{report.get('lpips', 'not computed: no weights')}); launches {totals_e}")
    del res
    per_shape = collections.Counter(per_shape) + collections.Counter(shape_v) + \
        collections.Counter(shape_e)
    return dict(ok=ok_test and ok_val and ok_exp, per_shape=dict(per_shape), wall_s=wall,
                render_ms=render_ms, peak_gb=peak_render)


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def main() -> int:
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False")
    env = env_phase()
    rows = kernel_phase()
    c_rows = composite_kernel_phase()
    if not all(r["ok"] for r in rows + c_rows) or not edge_phase():
        return _fail("a kernel disagrees with its plain version")
    rows += c_rows
    checked = {key for r in rows for key in r["keys"]}
    runs = {}

    def unchecked(name: str, run: dict) -> bool:
        runs[name] = run
        missing = set(run["per_shape"]) - checked
        if missing:
            print(f"chip_smoke: {name}-path kernel shapes not checked: {missing}",
                  file=sys.stderr)
        return bool(missing)

    with tempfile.TemporaryDirectory() as tmp:
        e2e = e2e_phase(tmp)
    if not e2e["ok"]:
        return _fail("the end-to-end run failed its checks")
    if unchecked("sampling", e2e):
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        e2e512 = e2e_phase(tmp, 512, PER_FORWARD_512, "e2e-512")
    if not e2e512["ok"]:
        return _fail("the 512x512 sampling run failed its checks")
    if unchecked("sampling-512", e2e512):
        return 1
    if not reference_phase()["ok"]:
        return _fail("kernels disagree with plain ops end to end")
    with tempfile.TemporaryDirectory() as tmp:
        train = train_phase(tmp)
    if not train["ok"]:
        return _fail("the full-width train run failed its checks")
    if unchecked("train", train):
        return 1
    if not train_reference_phase()["ok"]:
        return _fail("the train step through the kernels disagrees with plain ops")
    pf = packed_flash_phase()
    if not pf["ok"]:
        return _fail("F's route (packed_flash) failed its checks")
    if unchecked("packed-flash", pf):
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        ply, frames = _recon_workspace(tmp)
        recon = recon_phase(tmp, ply, frames, RECON_RES, RECON_EVAL, PER_RECON_STEP, "recon")
        if not recon["ok"]:
            return _fail("the recon CLI run failed its checks")
        timing = recon_timing_phase(recon["system"], frames, PER_RECON_STEP, "recon")
        if not timing["ok"]:
            return _fail("the timed recon steps failed their checks")
        recon_ref = recon_reference_phase(recon.pop("system"), timing.pop("batch"),
                                          PER_RECON_STEP, "recon")
        if not recon_ref["ok"]:
            return _fail("the recon step through kernel H disagrees with plain ops")
        if unchecked("recon", recon) or unchecked("recon-timing", timing):
            return 1
        ev = eval_phase(tmp, ply, frames, recon["trial"])
        if not ev["ok"]:
            return _fail("the evaluation entry points failed their checks")
        if unchecked("eval", ev):
            return 1
        fields = recon_phase(tmp, ply, frames, FIELDS_RES, FIELDS_RES, PER_FIELDS_STEP, "fields")
        if not fields["ok"]:
            return _fail("the 64^2 recon CLI run (kernel G) failed its checks")
        f_timing = recon_timing_phase(fields["system"], frames, PER_FIELDS_STEP, "fields",
                                      buckets=False)
        if not f_timing["ok"]:
            return _fail("the timed 64^2 recon steps failed their checks")
        f_ref = recon_reference_phase(fields.pop("system"), f_timing.pop("batch"),
                                      PER_FIELDS_STEP, "fields")
        if not f_ref["ok"]:
            return _fail("the 64^2 recon step through kernel G disagrees with plain ops")
        if unchecked("fields", fields) or unchecked("fields-timing", f_timing):
            return 1
    print(f"[summary] seconds per denoise step (CFG pair, after one warm-up step): "
          f"{e2e['step_s']:.4f}; peak memory {e2e['peak_gb']:.2f} GiB; card {env['smi']}")
    print(f"[summary] seconds per denoise step at 512x512: {e2e512['step_s']:.4f}; peak "
          f"memory {e2e512['peak_gb']:.2f} GiB; card {env['smi']}")
    print(f"[summary] seconds per train step (full width, gradient checkpointing, mean of "
          f"the steps after the first): {train['step_s']:.4f}; peak memory "
          f"{train['peak_gb']:.2f} GiB; card {env['smi']}")
    print(f"[summary] seconds per recon step (20,000 gaussians, 4 views x 16 frames at "
          f"256^2): full schedule {timing['step_s']:.4f}, buckets 2 / 4 / 8 "
          + " / ".join(f"{t:.4f}" for t in timing["buckets"])
          + f", schedule average {timing['avg_s']:.4f}; kernel H launches per step "
          f"{PER_RECON_STEP['composite_coarse_fwd']} forward + "
          f"{PER_RECON_STEP['composite_coarse_bwd']} backward; peak memory "
          f"{timing['peak_gb']:.2f} GiB; card {env['smi']}")
    print(f"[summary] seconds per recon step at {FIELDS_RES}^2 (kernel G, 64 renders): "
          f"{f_timing['step_s']:.4f}; peak memory {f_timing['peak_gb']:.2f} GiB; testset "
          f"--test at {TESTSET_RES}^2 {ev['wall_s']:.2f} s, its render alone "
          f"{ev['render_ms']:.2f} ms, peak {ev['peak_gb']:.2f} GiB; card {env['smi']}")
    launches = sum((collections.Counter(r["per_shape"]) for r in runs.values()),
                   collections.Counter())
    kernels = [dict(name=f"{r['name']} {r['shape']}", route="cuda",
                    source=SOURCES[r["name"]][0], replaces=SOURCES[r["name"]][1],
                    launches=sum(launches[key] for key in r["keys"]),
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"]) for r in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
