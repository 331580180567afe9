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
   step through the plain versions.

Phase 2 also checks the forward kernels at the trainer's shapes and the
backward kernels (D, E) against their plain backward versions. The line
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
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate

# per UNet forward at full width (SD1.5 topology, 4 views x 16 frames, 256^2)
# on the CFG batch of sampling; no backward kernel runs there
PER_FORWARD = {"flash_fwd": 40, "packed_attn": 20, "geglu": 37, "flash_bwd_dq": 0,
               "flash_bwd_dkv": 0, "packed_attn_bwd": 0}
# per train step (one video: batch 16 frames per view-major UNet call) with
# gradient checkpointing: every kernel site's forward runs twice (forward and
# the block's recompute in backward); L1 flash sites fall under the 512 MiB
# logits line at batch 16 and take the plain path. D: the first L0 attn1 of
# down_blocks.0.attentions.0 needs no gradient at all (its q/k/v come from
# frozen weights and the latents), and its I2V branch needs dq only (k/v are
# frame 0's frozen projections), so 20 L0 sites give 19 dq and 18 dk/dv
# launches; E runs at all 20 temporal sites.
PER_TRAIN_STEP = {"flash_fwd": 40, "packed_attn": 40, "geglu": 74, "flash_bwd_dq": 19,
                  "flash_bwd_dkv": 18, "packed_attn_bwd": 20}
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
    for key, fam in (("flash_fwd_kernel", "kernel A flash_fwd"),
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    env = env_phase()
    rows = kernel_phase()
    if not all(r["ok"] for r in rows) or not edge_phase():
        print("chip_smoke: a kernel disagrees with its plain version", file=sys.stderr)
        return 1
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
    print(f"[summary] seconds per denoise step (CFG pair, after one warm-up step): "
          f"{e2e['step_s']:.4f}; peak memory {e2e['peak_gb']:.2f} GiB; card {env['smi']}")
    print(f"[summary] seconds per train step (full width, gradient checkpointing, mean of "
          f"the steps after the first): {train['step_s']:.4f}; peak memory "
          f"{train['peak_gb']:.2f} GiB; card {env['smi']}")
    launches = collections.Counter(e2e["per_shape"]) + collections.Counter(train["per_shape"])
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
