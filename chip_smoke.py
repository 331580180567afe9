#!/usr/bin/env python3
"""Drive the PyTorch port (``animate3d_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the ``ok`` line:

1. environment: card name and power limit, torch/CUDA versions, and the
   parallel ``nvcc`` build of every kernel in ``animate3d_tpu_torch/csrc``;
2. kernels: each hand-written kernel at the main path's shapes against its
   plain PyTorch version on the same bf16 inputs (max |diff| within the
   stated tolerance), with kernel / plain / library times and the card's
   bound for the same work; then at edge shapes off the main path;
3. end to end: the sampling CLI at full width (SD1.5 widths, 256x256,
   4 views x 16 frames, 2 DDIM steps, random weights from a seed) with every
   launch counter set to 0 just before and read just after;
4. profile and reference: one full-width UNet forward on the CFG batch
   under torch.profiler (device time by kernel family), and one forward
   through the kernels against the same forward through the plain versions;
5. train: the trainer CLI at full width (4 views x 16 frames, 256x256,
   batch 1, gradient checkpointing, random weights from a seed) for 3 steps
   on a synthetic manifest, launch counters zeroed just before and read just
   after, then one loss + backward through the kernels against the same
   step through the plain versions;
6. recon: stage-1 motion reconstruction through its CLI with
   configs/animate3d/motion_recon_frame_16.yaml as it is (4 views x 16
   frames at 256^2, 20,000 gaussians of a seeded random asset, frames
   rendered by the port under a seeded per-frame translation) for 3 steps
   plus its four-view test pass at 512^2, launch counters zeroed just
   before and read just after; then timed steps at the full schedule and at
   the frame buckets 2 / 4 / 8, one profiled step, and one full-size loss +
   backward through kernel H against the same step on the plain versions.

Phase 2 also checks the forward kernels at the trainer's shapes, the
backward kernels (D, E) against their plain backward versions, and kernel H
(forward and backward, f32) at the recon shapes. The line
before the last is a JSON object with one row per kernel and main-path
shape; the last line is ``{"ok": true, "device": {...}}``. Imports nothing
of JAX.
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

# per UNet forward at full width (SD1.5 topology, 4 views x 16 frames, 256^2)
# on the CFG batch of sampling; no backward kernel runs there
PER_FORWARD = {"flash_fwd": 40, "packed_attn": 20, "geglu": 37, "flash_bwd_dq": 0,
               "flash_bwd_dkv": 0, "packed_attn_bwd": 0, "composite_coarse_fwd": 0,
               "composite_coarse_bwd": 0}
# per train step (one video: batch 16 frames per view-major UNet call) with
# gradient checkpointing: every kernel site's forward runs twice (forward and
# the block's recompute in backward); L1 flash sites fall under the 512 MiB
# logits line at batch 16 and take the plain path. D: the first L0 attn1 of
# down_blocks.0.attentions.0 needs no gradient at all (its q/k/v come from
# frozen weights and the latents), and its I2V branch needs dq only (k/v are
# frame 0's frozen projections), so 20 L0 sites give 19 dq and 18 dk/dv
# launches; E runs at all 20 temporal sites.
PER_TRAIN_STEP = {"flash_fwd": 40, "packed_attn": 40, "geglu": 74, "flash_bwd_dq": 19,
                  "flash_bwd_dkv": 18, "packed_attn_bwd": 20, "composite_coarse_fwd": 0,
                  "composite_coarse_bwd": 0}
# per recon step: the step's renders (all views x its frames) are one batch
# of the rasterizer, so kernel H runs once forward and once backward
PER_RECON_STEP = {k: 0 for k in PER_FORWARD} | {"composite_coarse_fwd": 1,
                                                "composite_coarse_bwd": 1}
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


def _bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    bound, by = _bound_ms(flops, nbytes)
    return dict(name="flash_fwd", shape=label, keys=[("flash_fwd", (b, s, s, c, kv_group))],
                max_abs_err=err, tol=tol, rel=rel, lse_err=lse_err, ok=ok, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)


def _packed_case(label, b, s, c, heads, gen):
    from animate3d_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    q, k, v = (torch.randn((b, s, c), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    d = c // heads
    scale = d ** -0.5
    out = A.packed_attention(q, k, v, heads, scale)
    ref = A.packed_small_attention(q, k, v, heads, scale)
    torch.cuda.synchronize()
    err, tol, rel, ok = _agree(out, ref)
    ms = _time_ms(lambda: A.packed_attention(q, k, v, heads, scale), 20)
    plain_ms = _time_ms(lambda: A.packed_small_attention(q, k, v, heads, scale), 5)
    qh, kh, vh = (x.reshape(b, s, heads, d).transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, scale=scale), 20)
    bound, by = _bound_ms(4.0 * b * heads * s * s * d, 2.0 * 4 * b * s * c)
    return dict(name="packed_attn", shape=label, keys=[("packed_attn", (b, s, c))],
                max_abs_err=err, tol=tol, rel=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by)


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
    bound, by = _bound_ms(6.0 * m * c * inner, nbytes)
    return dict(name="geglu", shape=label, keys=[("geglu", (m, c, inner))],
                max_abs_err=err, tol=tol, rel=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by)


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
    bound, by = _bound_ms(flops, nbytes)
    key = (b, s, s, c, kv_group)
    return dict(name="flash_bwd", shape=label,
                keys=[("flash_bwd_dq", key), ("flash_bwd_dkv", key)],
                max_abs_err=err, tol=tol, rel=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by)


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
    bound, by = _bound_ms(10.0 * b * heads * s * s * d, 2.0 * 7 * b * s * c)
    return dict(name="packed_attn_bwd", shape=label, keys=[("packed_attn_bwd", (b, s, c))],
                max_abs_err=err, tol=tol, rel=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by)


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
        _packed_case("L0 temporal (8192, 16, 320) h8", 8192, 16, 320, 8, gen),
        _packed_case("L1 temporal (2048, 16, 640) h8", 2048, 16, 640, 8, gen),
        _geglu_case("L0 M=131072 C=320 I=1280", 131072, 320, 1280, gen),
        _geglu_case("L1 M=32768 C=640 I=2560", 32768, 640, 2560, gen),
        _geglu_case("L2 M=8192 C=1280 I=5120", 8192, 1280, 5120, gen),
        _geglu_case("L3 M=2048 C=1280 I=5120", 2048, 1280, 5120, gen),
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
        _packed_bwd_case("train L0 temporal (4096, 16, 320) h8", 4096, 16, 320, 8, gen),
        _packed_bwd_case("train L1 temporal (1024, 16, 640) h8", 1024, 16, 640, 8, gen),
    ]
    for r in rows:
        extra = f" lse_err {r['lse_err']:.3e}" if "lse_err" in r else ""
        print(f"[kernel] {r['name']:<15} {r['shape']:<58} max|d| {r['max_abs_err']:.3e} "
              f"(tol {r['tol']:.3e}) rel L2 {r['rel']:.3e} (tol {REL_L2_TOL:.0e}){extra} ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"library_ms {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}) {'ok' if r['ok'] else 'FAIL'}")
    return rows


def e2e_phase(tmp: str) -> dict:
    """The sampling CLI at full width, launch counters zeroed just before
    and read just after."""
    from PIL import Image

    from animate3d_tpu_torch.cli.inference import main as cli_main
    from animate3d_tpu_torch.ops import _build

    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (256, 256, 3), dtype=np.uint8)).save(
            os.path.join(tmp, f"{i}.png"))
    steps, iters = 2, 1
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = cli_main(["--model_size", "full", "-W", "256", "-H", "256", "-N", "4", "-L", "16",
                    "--steps", str(steps), "--freeinit_iters", str(iters), "--seed", "0",
                    "--ip_image_root", tmp, "--output_dir", os.path.join(tmp, "out")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals = _build.launch_totals()
    per_shape = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    lat = res["latents"]
    with Image.open(res["gif"]) as gif:
        gif_frames = gif.n_frames
    unet_calls = steps * iters
    ok = (tuple(lat.shape) == (4, 16, 32, 32, 4) and bool(torch.isfinite(lat).all())
          and gif_frames == 16
          and all(totals[k] >= n * unet_calls for k, n in PER_FORWARD.items()))
    print(f"[e2e] full width 256x256, 4 views x 16 frames, {steps} steps x {iters} FreeInit "
          f"iteration(s): wall {wall:.2f} s, step seconds "
          + ", ".join(f"{t:.4f}" for t in res["step_seconds"])
          + f"; peak memory {peak_gb:.2f} GiB; gif frames {gif_frames}; latents "
          f"{tuple(lat.shape)} finite {bool(torch.isfinite(lat).all())}")
    for k, n in PER_FORWARD.items():
        print(f"[e2e] launches {k}: {totals[k]} (expected {n} per UNet forward x "
              f"{unet_calls} forwards = {n * unet_calls})")
    return dict(ok=ok, per_shape=per_shape, step_s=res["step_seconds"][1],
                wall_s=wall, peak_gb=peak_gb)


def _family(name: str) -> str:
    n = name.lower()
    for key, fam in (("composite_coarse_fwd_kernel", "kernel H fwd"),
                     ("composite_coarse_bwd_kernel", "kernel H bwd"),
                     ("topk", "top-k binning"), ("sort", "top-k binning"),
                     ("gesvd", "SVD (ARAP)"), ("svd", "SVD (ARAP)"),
                     ("scatter", "gather / scatter"), ("gather", "gather / scatter"),
                     ("index", "gather / scatter"),
                     ("flash_fwd_kernel", "kernel A flash_fwd"),
                     ("packed_attn_kernel", "kernel B packed_attn"),
                     ("geglu_gemm_kernel", "kernel C geglu"),
                     ("flash_bwd_dq_kernel", "kernel D flash_bwd dq"),
                     ("flash_bwd_dkv_kernel", "kernel D flash_bwd dk/dv"),
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
    for b, s_, c, h in ((13, 8, 80, 2), (7, 32, 640, 8)):
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
    for b, s_, c, h in ((13, 8, 80, 2), (7, 32, 640, 8)):
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
RECON_N, RECON_VIEWS, RECON_FRAMES, RECON_RES, RECON_EVAL = 20000, 4, 16, 256, 512
RECON_STEPS = 3
# f32 operations per (pixel, candidate) pair that H's function needs:
# evaluating a candidate's alpha (offsets, conic form, exp, gates) takes 14;
# a live alpha adds 12 in the forward (weight, 4 channel sums, alpha sum,
# transmittance) and 40 in the backward (transmittance, weight, dw, dalpha,
# suffix, the 10 gradient terms). The backward's function needs alpha once
# a pair: the kernel's second and third evaluations (block recompute,
# reverse walk) are its own strategy and are not counted.
H_FWD_OPS = (14, 12)
H_BWD_OPS = (14, 40)
H_PLANE_TOL, H_PLANE_REL, H_GRAD_REL = 2.0 ** -6, 1e-4, 1e-3


def _recon_state(device):
    """The recon asset: ``random_state(n=20000, radius=0.4)`` from seed 0."""
    from animate3d_tpu_torch.gaussians.state import random_state

    return random_state(RECON_N, radius=0.4, generator=torch.Generator().manual_seed(0),
                        device=device)


def _h_fields(n_renders: int, res: int):
    """Kernel H's inputs as the recon path builds them: the asset projected
    and binned by the port through the first ``n_renders`` of the 4 x 16
    fixed cameras at ``res``^2 (kc = coarse_k = 512)."""
    from animate3d_tpu_torch.data.cameras import fixed_view_cameras, gs_cameras_from_batch
    from animate3d_tpu_torch.ops import rasterize as R

    st = _recon_state("cuda")
    cams = gs_cameras_from_batch(fixed_view_cameras(height=res, width=res,
                                                    total_frame=RECON_FRAMES), device="cuda")
    idx = torch.arange(n_renders, device="cuda")
    b, n = n_renders, st.num_points
    with torch.no_grad():
        fields, corig, _, _ = R.coarse_fields(
            st.xyz.expand(b, n, 3), st.get_scaling().expand(b, n, 3),
            st.get_rotation().expand(b, n, 4), st.get_opacity().reshape(-1), cams.index(idx),
            R.RasterConfig(height=res, width=res), shs=st.get_features())
    return fields, corig


def _h_rows(label, fields, corig, gen, backward=True) -> list:
    """Kernel H forward (and backward) on recon fields against the plain
    versions. Limits: planes max |diff| <= 2^-6 (one flipped 1/255 gate or
    0.99 clamp moves a pixel by at most 1/255 T) and relative L2 <= 1e-4;
    field gradients relative L2 <= 1e-3 (sums over 4096 pixels in another
    order, amplified by 1 / (1 - alpha) <= 100)."""
    from animate3d_tpu_torch.ops import rasterize as R

    n_ct, _, kc = fields.shape
    key = (n_ct, kc, 4)
    out = R.composite_coarse(fields, corig)
    ref, pairs, live = R._composite_coarse_plain(fields, corig, count_pairs=True)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    rel = float((out - ref).norm() / ref.norm())
    ok = err <= H_PLANE_TOL and rel <= H_PLANE_REL and bool(torch.isfinite(out).all())
    bound, by = _bound_f32(H_FWD_OPS[0] * pairs + H_FWD_OPS[1] * live,
                           4.0 * (fields.numel() + corig.numel() + out.numel()))
    rows = [dict(name="composite_coarse_fwd", shape=f"{label} fields ({n_ct}, 12, {kc})",
                 keys=[("composite_coarse_fwd", key)], max_abs_err=err, tol=H_PLANE_TOL,
                 rel=rel, rel_tol=H_PLANE_REL, ok=ok, pairs=pairs, live=live,
                 ms=_time_ms(lambda: R.composite_coarse(fields, corig), 10),
                 plain_ms=_time_ms(lambda: R._composite_coarse_plain(fields, corig), 1),
                 library_ms=None, bound_ms=bound, bound_by=by)]
    if backward:
        cot = torch.randn(out.shape, generator=gen, device="cuda") * 1e-3
        g = R.composite_coarse_bwd(fields, corig, cot)
        gref = R._composite_coarse_bwd_plain(fields, corig, cot)
        torch.cuda.synchronize()
        rel = float((g - gref).norm() / gref.norm())
        ok = rel <= H_GRAD_REL and bool(torch.isfinite(g).all()) and float(g[:, 10:].abs().max()) == 0
        # the backward reads planes 0-5 of the cotangent (r, g, b, alpha,
        # depth, T_final): 6 of its 8
        bound, by = _bound_f32(H_BWD_OPS[0] * pairs + H_BWD_OPS[1] * live,
                               4.0 * (fields.numel() + corig.numel() + cot[:, :, :6].numel()
                                      + g.numel()))
        rows.append(dict(
            name="composite_coarse_bwd", shape=f"{label} fields ({n_ct}, 12, {kc})",
            keys=[("composite_coarse_bwd", key)], max_abs_err=float((g - gref).abs().max()),
            tol=None, rel=rel, rel_tol=H_GRAD_REL, ok=ok, pairs=pairs, live=live,
            ms=_time_ms(lambda: R.composite_coarse_bwd(fields, corig, cot), 5),
            plain_ms=_time_ms(lambda: R._composite_coarse_bwd_plain(fields, corig, cot), 1),
            library_ms=None, bound_ms=bound, bound_by=by))
    return rows


def _bound_f32(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def h_kernel_phase() -> list:
    """Kernel H at every shape the recon path gives it: the step's renders
    at 256^2 (64 at the full schedule, 32 / 16 / 8 at the frame buckets 8 /
    4 / 2), forward and backward; the four-view test's 64 renders at 512^2,
    forward only. No PyTorch call computes H: library_ms is null."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    fields, corig = _h_fields(RECON_VIEWS * RECON_FRAMES, RECON_RES)
    rows = []
    for renders, label in ((64, "recon step, 64 renders at 256^2"),
                           (32, "bucket 8, 32 renders at 256^2"),
                           (16, "bucket 4, 16 renders at 256^2"),
                           (8, "bucket 2, 8 renders at 256^2")):
        n_ct = renders * 16
        rows += _h_rows(label, fields[:n_ct].contiguous(), corig[:n_ct].contiguous(), gen)
    del fields, corig
    fields, corig = _h_fields(RECON_VIEWS * RECON_FRAMES, RECON_EVAL)
    rows += _h_rows("test pass, 64 renders at 512^2", fields, corig, gen, backward=False)
    for r in rows:
        tol = f"(tol {r['tol']:.3e}) " if r["tol"] is not None else ""
        print(f"[kernel] {r['name']:<20} {r['shape']:<58} max|d| {r['max_abs_err']:.3e} {tol}"
              f"rel L2 {r['rel']:.3e} (tol {r['rel_tol']:.0e}) ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms none bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}; {r['pairs']} pairs, {r['live']} live) "
              f"{'ok' if r['ok'] else 'FAIL'}")
    return rows


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


def recon_phase(tmp: str) -> dict:
    """The recon CLI with the shipped config for RECON_STEPS steps plus its
    test pass, launch counters zeroed just before and read just after. The
    only changes are dotted overrides: the prompt (the yaml's ???), the data
    paths, the output root, the step count, trajectories on, and the test
    size 512^2 (the yaml's four-view test reads data.eval_height/width,
    which it leaves unset)."""
    from PIL import Image

    from animate3d_tpu_torch.cli.launch import main as launch_main
    from animate3d_tpu_torch.ops import _build

    ply, frames = _recon_workspace(tmp)
    args = ["--config", RECON_YAML, "--train", "system.prompt_processor.prompt=a toy",
            f"data.image_root={frames}", f"system.geometry.geometry_convert_from={ply}",
            f"exp_root_dir={tmp}/out", f"trainer.max_steps={RECON_STEPS}",
            f"data.eval_height={RECON_EVAL}", f"data.eval_width={RECON_EVAL}",
            "system.save_gaussian_trajectory=true"]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = launch_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals, per_shape = _build.launch_totals(), dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {k: n * RECON_STEPS for k, n in PER_RECON_STEP.items()}
    expected["composite_coarse_fwd"] += 1  # the test pass: 64 renders in one launch
    trial = res["trial_dir"]
    metrics = res["metrics"]
    images = sorted(os.listdir(os.path.join(trial, "save", "images")))
    with Image.open(os.path.join(trial, "save", "images", images[0])) as im:
        size, mode = im.size, im.mode
    trajs = os.listdir(os.path.join(trial, "save", "gaussian_trajectory"))
    ckpt = os.path.exists(os.path.join(trial, "ckpts", f"step_{RECON_STEPS}", "checkpoint.pt"))
    losses = [m["loss"] for m in metrics]
    ok = (totals == expected and len(losses) == RECON_STEPS and all(np.isfinite(losses))
          and ckpt and len(images) == RECON_VIEWS * RECON_FRAMES
          and size == (RECON_EVAL, RECON_EVAL) and mode == "RGBA"
          and len(trajs) == RECON_FRAMES and np.isfinite(res["rgb"]).all())
    print(f"[recon] CLI --train, {RECON_STEPS} steps + four-view test: wall {wall:.2f} s; "
          f"peak memory {peak_gb:.2f} GiB; losses " + ", ".join(f"{x:.5f}" for x in losses)
          + "; metrics.jsonl keys " + ",".join(sorted(metrics[-1])))
    print(f"[recon] launches {totals} (expected {expected}: {PER_RECON_STEP} per step, one "
          f"forward for the test pass); per shape {per_shape}")
    print(f"[recon] ckpts/step_{RECON_STEPS} written {ckpt}; {len(images)} test images "
          f"{size} {mode}; {len(trajs)} trajectories; raster overflow in the test pass "
          f"{res['overflow']}")
    return dict(ok=ok, per_shape=per_shape, system=res["system"], frames=frames,
                wall_s=wall, peak_gb=peak_gb)


def _recon_batch(system, frames: str) -> dict:
    from animate3d_tpu_torch.data.cameras import gs_cameras_from_batch
    from animate3d_tpu_torch.data.multi_image import MultiImageConfig, MultiImageDataset

    raw = MultiImageDataset(MultiImageConfig(image_root=frames)).batch(0)
    return {"gs_cameras": gs_cameras_from_batch(raw, device="cuda"),
            "timestamps": raw["timestamps"], "rgb": torch.as_tensor(raw["rgb"], device="cuda"),
            "mask": torch.as_tensor(raw["mask"].astype(np.float32), device="cuda")}


def recon_timing_phase(system, frames: str) -> dict:
    """Seconds per recon step (host clock, ended by a synchronize; one
    warm-up step, then the mean of 3) at the full schedule
    (global_step = 50 x 16 + 1: all 64 renders) and at the frame buckets
    2 / 4 / 8, with their schedule-weighted average over the 800-step run
    (steps 0-99 bucket 2, 100-199 bucket 4, 200-399 bucket 8, 400-799 all
    16 frames: the JAX package's bench.py definition). Launch counters
    zeroed just before, read just after; then one step under torch.profiler."""
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
    t2, t4, t8 = measure(ipf + 10), measure(3 * ipf + 10), measure(7 * ipf + 10)
    totals, per_shape = _build.launch_totals(), dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    avg = (100 * t2 + 100 * t4 + 200 * t8 + 400 * full) / 800.0
    steps = 4 * (iters + 1)
    expected = {k: n * steps for k, n in PER_RECON_STEP.items()}
    print(f"[recon-time] seconds per recon step: full schedule (64 renders) {full:.4f}; "
          f"buckets 2 / 4 / 8 (8 / 16 / 32 renders) {t2:.4f} / {t4:.4f} / {t8:.4f}; "
          f"schedule average {avg:.4f}; peak memory {peak_gb:.2f} GiB")
    print(f"[recon-time] launches {totals} over {steps} steps (expected {expected})")

    system.global_step = ipf * RECON_FRAMES + 1
    system.step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _print_profile("[recon-profile]", "one recon step at the full schedule (64 renders at "
                   "256^2, 20,000 gaussians)", prof, wall_ms)
    return dict(ok=totals == expected and np.isfinite(full), per_shape=per_shape, step_s=full,
                buckets=(t2, t4, t8), avg_s=avg, peak_gb=peak_gb, batch=batch)


def recon_reference_phase(system, batch) -> dict:
    """One full-size recon loss + backward (all 64 renders, fixed draws)
    through kernel H against the same step with H on its plain versions.
    Limits: the loss within 1e-4 relative, the concatenated parameter
    gradient within 1e-3 relative L2 (kernel H's f32 sums in another order,
    carried through the gathers of the K-planes and the deformation MLPs)."""
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
          and counts_k == PER_RECON_STEP and not any(counts_p.values()))
    print(f"[recon-reference] full-size recon loss + backward, kernel H vs plain: loss "
          f"{loss_k:.7f} vs {loss_p:.7f} (relative {loss_rel:.3e}, tol 1e-4); parameter "
          f"gradient ({g_k.numel()} values) relative L2 {rel:.3e} (tol 1e-3), norms "
          f"{float(g_k.norm()):.4e} vs {float(g_p.norm()):.4e}; launches through the kernels "
          f"{counts_k} (expected {PER_RECON_STEP}), through the plain ops {counts_p}")
    return dict(ok=ok, rel=rel, loss_rel=loss_rel)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    env = env_phase()
    rows = kernel_phase()
    h_rows = h_kernel_phase()
    if not all(r["ok"] for r in rows + h_rows) or not edge_phase():
        print("chip_smoke: a kernel disagrees with its plain version", file=sys.stderr)
        return 1
    rows += h_rows
    with tempfile.TemporaryDirectory() as tmp:
        e2e = e2e_phase(tmp)
    if not e2e["ok"]:
        print("chip_smoke: the end-to-end run failed its checks", file=sys.stderr)
        return 1
    checked = {key for r in rows for key in r["keys"]}
    missing = set(e2e["per_shape"]) - checked
    if missing:
        print(f"chip_smoke: main-path kernel shapes not checked: {missing}", file=sys.stderr)
        return 1
    ref = reference_phase()
    if not ref["ok"]:
        print("chip_smoke: kernels disagree with plain ops end to end", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        train = train_phase(tmp)
    if not train["ok"]:
        print("chip_smoke: the full-width train run failed its checks", file=sys.stderr)
        return 1
    missing = set(train["per_shape"]) - checked
    if missing:
        print(f"chip_smoke: train-path kernel shapes not checked: {missing}", file=sys.stderr)
        return 1
    train_ref = train_reference_phase()
    if not train_ref["ok"]:
        print("chip_smoke: the train step through the kernels disagrees with plain ops",
              file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        recon = recon_phase(tmp)
        if not recon["ok"]:
            print("chip_smoke: the recon CLI run failed its checks", file=sys.stderr)
            return 1
        timing = recon_timing_phase(recon["system"], recon["frames"])
        if not timing["ok"]:
            print("chip_smoke: the timed recon steps failed their checks", file=sys.stderr)
            return 1
        recon_ref = recon_reference_phase(recon["system"], timing.pop("batch"))
    del recon["system"]
    if not recon_ref["ok"]:
        print("chip_smoke: the recon step through kernel H disagrees with plain ops",
              file=sys.stderr)
        return 1
    missing = (set(recon["per_shape"]) | set(timing["per_shape"])) - checked
    if missing:
        print(f"chip_smoke: recon-path kernel shapes not checked: {missing}", file=sys.stderr)
        return 1
    print(f"[summary] seconds per denoise step (CFG pair, after one warm-up step): "
          f"{e2e['step_s']:.4f}; peak memory {e2e['peak_gb']:.2f} GiB; card {env['smi']}")
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
    launches = (collections.Counter(e2e["per_shape"]) + collections.Counter(train["per_shape"])
                + collections.Counter(recon["per_shape"])
                + collections.Counter(timing["per_shape"]))
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
