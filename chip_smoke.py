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
   under ``attention_backend("packed_flash")`` at L0 and L2, and at a
   32-frame clip of 160-wide heads), B also at S 32 and S 8 with 40-wide
   heads and at S 1 (a one-frame clip), C also at a
   ragged M at each width, H at every stage-1 shape (recon steps, four-view
   test, validation orbit, testset grid) and on dense synthetic coarse tiles
   at the recon step's shape (the 0.99 clamp at the back and at the front
   of the lists) and at bucket 2's (a cluster of ranks a coarse tile), and
   its forward on tiles where T falls under 1e-4 inside a block (T_final
   gated), G at the 64^2 recon shapes and on dense synthetic tiles (T_final
   gated, with the shares of candidates its cull drops and the densest
   warp's marks), E also at S 32 with 160- and 40-wide heads, at S 8, at
   S 1 and on a ragged S 2 batch, each backward of E, H and G also
   launched twice to show it bitwise deterministic, B, E and G also timed
   from a CUDA graph (the device's time without the host's launch path);
   then edge shapes off the main path (G against float64 among them);
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
   heads) and one of a 32-frame clip at the 160-wide heads, forward and
   backward under ``attention_backend("packed_flash")`` (kernel B as F's
   route, E) against the plain versions, counters zeroed before and read
   after;
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
   full-schedule step and one loss + backward through G against plain ops;
10. refine: a seeded artifact root (the full-width CLIP text and vision
   towers in bf16, the byte-level tokenizer), then the refine CLI with
   configs/animate3d/refine_frame_16.yaml as it is (recon renders at
   1024^2, an SDS batch of 64 renders at 256^2, guidance UNet and VAE
   seeded, both towers from the root) chained from phase 7's trial, 200
   steps cut to 3, plus its testset pass, launch counters zeroed just
   before and read just after (A, B, C and H exactly); timed refine steps
   with the peak memory, one profiled step with the shares of A, B, C, H,
   the VAE and CLIP; one refine loss + backward through the kernels against
   the same step on the plain versions (same draws); then phase 3's
   sampling CLI with the root, the prompt and the conditioning renders
   through the towers;
11. train with weights: the full-width UNet and VAE as diffusers files
   (``pretrained_model_path``, f32) in the artifact root, then the trainer
   CLI on configs/training/train.yaml as it is (paths, 3 steps and the
   phase-5 workspace overridden; two captions) with ``cast_frozen_bf16``
   true and false, launch counts exactly PER_TRAIN_STEP a step, the frozen
   weights equal to the files, one loss + backward at the loaded weights
   with the run's caption and image conditioning through the kernels
   against the plain versions; then ``cli/validate_weights.py --smoke`` on
   the root;
12. mesh: the mesh-animation flow on a seeded 20,000-vertex textured OBJ —
   ``mesh2gaussian``, the static four-view render
   (visualize_four_view_static.yaml), a motion video rendered by the port
   and written as a 4-view GIF, ``split_gif``, ``tracking`` (propagation,
   on the card; coverage of the rendered alpha checked), the recon CLI on
   configs/animate3d/mesh_animation_frame_16.yaml (3 steps + test, timed
   steps, one loss + backward through H against plain ops), ``--export``
   and ``export_animated_mesh`` to a GLB (vertex count, 16 morph targets);
   kernel H at the static render's shape against its plain version;
13. the JAX package's last modules: the trainer on configs/training/train.yaml
   (paths, 3 steps, ``zero_sharded_optimizer=true``) under
   ``python -m torch.distributed.run --nproc_per_node 1`` (NCCL at world size
   1; this script's ``--train-rank`` mode is the rank's body), on 48-frame
   clips of 4 views at 256^2, launches exactly PER_TRAIN_STEP a step, with
   the dataset's read time for one item; one recon step of phase 7's config
   with ``--typecheck --gradio`` (contracts at full size; progress file,
   ``cmd.txt``, ``code_snapshot.zip``, TB events read back); and
   ``profile_trace`` around one full-width sampling denoise step. Data and
   sequence parallelism at more than one rank are held by the CPU tests
   (``tests/test_torch_parallel.py``): this script needs one card;
14. Stable Video Diffusion XT: ``video_attention`` (the SVD UNet's route)
   at the SVD shapes on the CFG batch (2 x 25 frames at 72x128 latents)
   against the kernels' plain versions — kernel A at 64-wide heads over
   9,216 / 2,304 / 576 / 144 tokens against ``_flash_plain``, kernel B on
   25-frame sequences padded to 32 against ``packed_padded_attention`` and
   unpadded attention (and the padded keys left unmasked shown to move
   it), kernel C at the SVD M's — with kernel / plain / library times and
   the bound; then one seeded full-size SVD UNet call with the launch
   counters zeroed just before and read just after (exactly
   PER_SVD_FORWARD, each of B's launches padded), against the same call
   on the plain versions.

    python3 chip_smoke.py --svd

runs phases 1 and 14 alone;

15. K-planes: kernel I (``csrc/kplanes.cu``) forward and backward against
   the plain gather at every shape the recon, refine, eval and mesh paths
   give it (20,000 points, both scales, 16 channels, F 1 to 16), with
   kernel / plain times and the bound; the recon field's ``deform_many``
   forward and backward under torch.profiler (no indexing kernel left); a
   gradient of the points and time rows beyond a block's shared memory
   refused.

    python3 chip_smoke.py --kplanes

runs phases 1 and 15 alone (phase 15 also runs in the full order, after
phase 2).

The summary lines give the step times (refine's too) with kernel B's,
C's, E's, G's and H's share of the profiled device time, each beside the
card's name and power limit. The line before the last is a JSON object with one row per
kernel and path shape; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores
PEAK_F64_FLOPS = 34e12  # H100 SXM f64 rate outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
PEAK_EX2 = 3.9e12  # H100 SXM SFU: 16 ex2 a clock an SM x 132 SMs x 1.83 GHz

COUNTERS = ("flash_fwd", "packed_attn", "geglu", "flash_bwd_dq", "flash_bwd_dkv",
            "packed_attn_bwd", "composite_coarse_fwd", "composite_coarse_bwd",
            "composite_fields_fwd", "composite_fields_bwd", "packed_temporal",
            "kplanes_fwd", "kplanes_bwd")


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
# once forward and once backward; the deformation of the step's frames is
# one call of kernel I each way. Every render call outside the steps (the
# test passes) deforms its frames once: one more kplanes_fwd
PER_RECON_STEP = _per(composite_coarse_fwd=1, composite_coarse_bwd=1, kplanes_fwd=1,
                      kplanes_bwd=1)
PER_FIELDS_STEP = _per(composite_fields_fwd=1, composite_fields_bwd=1, kplanes_fwd=1,
                       kplanes_bwd=1)
# one motion-module temporal attention at L0 (40-wide heads), one at L2
# (160-wide) and one of a 32-frame clip at L2 under
# attention_backend("packed_flash"), forward and backward: kernel B as F's
# route, then E, at each
PER_PACKED_FLASH = _per(packed_temporal=3, packed_attn_bwd=3)
# per SVD-XT UNet call on the CFG batch (2 x 25 frames of a 72x128 latent):
# 16 transformers (5 a level at L0-L2 over the down and up blocks, the mid
# block's 1), each one spatial self-attention on kernel A at 64-wide heads,
# one temporal self-attention on kernel B (25 frames padded to 32) and three
# GEGLU feed-forwards (spatial ff, temporal ff_in and ff); the one-token
# cross-attentions are the value projection and launch nothing
PER_SVD_FORWARD = _per(flash_fwd=16, packed_attn=16, geglu=48)
SVD_PADDED = ("packed_seq_padded", "25->32")
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
    # kernel I replaces no Pallas kernel: the JAX package gathers with jnp
    "kplanes_fwd": ("animate3d_tpu_torch/csrc/kplanes.cu",
                    "none (animate3d_tpu/gaussians/kplanes.py: jnp gathers)"),
    "kplanes_bwd": ("animate3d_tpu_torch/csrc/kplanes.cu",
                    "none (animate3d_tpu/gaussians/kplanes.py: jnp gathers)"),
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


def _smi() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def env_phase() -> dict:
    smi = _smi()
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
    the TPU's ``packed_temporal_flash``). ``graph_ms``: the call replayed
    from a CUDA graph (:func:`_graph_ms`)."""
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
        ms = _time_ms(route, 100)  # enough launches that host dispatch does not set the time
        graph_ms = _graph_ms(route)  # where it still does (S 1, small batches)
    err, tol, rel, ok = _agree(out, ref)
    plain_ms = _time_ms(lambda: A.packed_small_attention(q, k, v, heads, scale), 5)
    qh, kh, vh = (x.reshape(b, s, heads, d).transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, scale=scale), 20)
    bound, by, term = _bound_ms(4.0 * b * heads * s * s * d, 2.0 * 4 * b * s * c)
    return dict(name=name, shape=label, keys=[(name, (b, s, c))],
                max_abs_err=err, tol=tol, rel=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by, term=term, graph_ms=graph_ms)


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
    """Kernel E against its plain version, and launched twice: bitwise
    equal (no atomics)."""
    from animate3d_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    q, k, v, g = (torch.randn((b, s, c), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    d = c // heads
    scale = d ** -0.5
    args = (q, k, v, g, heads, scale)
    grads = A.packed_attention_bwd(*args)
    refs = A._packed_bwd_plain(*args)
    same = all(torch.equal(x, y) for x, y in zip(grads, A.packed_attention_bwd(*args)))
    torch.cuda.synchronize()
    err, tol, rel, ok = _agree_all(grads, refs)
    ok = ok and same
    ms = _time_ms(lambda: A.packed_attention_bwd(*args), 100)
    graph_ms = _graph_ms(lambda: A.packed_attention_bwd(*args))
    plain_ms = _time_ms(lambda: A._packed_bwd_plain(*args), 5)
    lib_ms = _sdpa_bwd_ms(q, k, v, g, heads, scale, 1, 20)
    bound, by, term = _bound_ms(10.0 * b * heads * s * s * d, 2.0 * 7 * b * s * c)
    return dict(name="packed_attn_bwd", shape=label, keys=[("packed_attn_bwd", (b, s, c))],
                max_abs_err=err, tol=tol, rel=rel, ok=ok, same=same, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by, term=term, graph_ms=graph_ms)


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
        # off the shipped paths: a 32-frame clip at the 160-wide L2 heads under
        # packed_flash (the L2 row's 8192 tokens), 32 frames at 40-wide heads,
        # and 8-frame sequences (the block-diagonal mask inside a 16-token tile)
        _packed_case("L2 S32 temporal (256, 32, 1280) h8, backend packed_flash",
                     256, 32, 1280, 8, gen, backend="packed_flash"),
        _packed_case("S32 temporal (4096, 32, 320) h8", 4096, 32, 320, 8, gen),
        _packed_case("S8 temporal (16384, 8, 320) h8", 16384, 8, 320, 8, gen),
        # a one-frame clip, which the TPU's padded_packed_plan sends to its
        # kernel: out is v's bits
        _packed_case("S1 temporal (8192, 1, 320) h8", 8192, 1, 320, 8, gen),
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
        # a ragged M at each width (TMA's zero fill, stores clipped at row M)
        _geglu_case("ragged M=8264 C=320 I=1280", 8264, 320, 1280, gen),
        _geglu_case("ragged M=8264 C=640 I=2560", 8264, 640, 2560, gen),
        _geglu_case("ragged M=8264 C=1280 I=5120", 8264, 1280, 5120, gen),
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
        # and at B's rows off the shipped paths: the 32-frame clip at the
        # 160-wide heads (phase 6's third site), 32 frames at 40-wide heads,
        # 8-frame sequences, and a ragged batch of 2-frame sequences whose
        # last 16-token tile is partial
        _packed_bwd_case("L2 S32 temporal (256, 32, 1280) h8, backend packed_flash",
                         256, 32, 1280, 8, gen),
        _packed_bwd_case("S32 temporal (4096, 32, 320) h8", 4096, 32, 320, 8, gen),
        _packed_bwd_case("S8 temporal (16384, 8, 320) h8", 16384, 8, 320, 8, gen),
        _packed_bwd_case("ragged S2 temporal (4099, 2, 320) h8", 4099, 2, 320, 8, gen),
        # a one-frame clip: dq = dk = 0 exactly, dv = g
        _packed_bwd_case("S1 temporal (8192, 1, 320) h8", 8192, 1, 320, 8, gen),
    ]
    print(f"[kernel] card {_smi()}")
    for r in rows:
        extra = f" lse_err {r['lse_err']:.3e}" if "lse_err" in r else ""
        if "same" in r:
            extra += f" two launches bitwise equal {r['same']}"
        if "graph_ms" in r:
            extra += f" graph_ms {r['graph_ms']:.4f}"
        print(f"[kernel] {r['name']:<15} {r['shape']:<58} max|d| {r['max_abs_err']:.3e} "
              f"(tol {r['tol']:.3e}) rel L2 {r['rel']:.3e} (tol {REL_L2_TOL:.0e}){extra} ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
              f"library_ms {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}: {r['term']}) {'ok' if r['ok'] else 'FAIL'}")
    return rows


def e2e_phase(tmp: str, res: int = 256, per_forward: dict = PER_FORWARD,
              tag: str = "e2e", root=None) -> dict:
    """The sampling CLI at full width and ``res`` x ``res``, launch counters
    zeroed just before and read just after: at least ``per_forward`` a UNet
    forward at 256^2 (phase 3), exactly that at 512^2 (phase 3b). With an
    artifact ``root`` (phase 10b), the prompt goes through the tokenizer and
    the text tower and the conditioning renders through the vision tower."""
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
    towers = ["--flax_params", root, "--prompt", "a toy"] if root else []
    out = cli_main(["--model_size", "full", "-W", str(res), "-H", str(res), "-N", "4",
                    "-L", "16", "--steps", str(steps), "--freeinit_iters", str(iters),
                    "--seed", "0", "--ip_image_root", tmp,
                    "--output_dir", os.path.join(tmp, f"out{res}{tag}"), *towers])
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
    if root:
        ok = (ok and {"text_encoder", "image_encoder"} <= out["loaded"]
              and float(out["text_cond"].abs().sum()) > 0
              and float(out["image_embeds"].abs().sum()) > 0)
        print(f"[{tag}] towers loaded {sorted(out['loaded'])}; text_cond "
              f"{tuple(out['text_cond'].shape)}, image_embeds {tuple(out['image_embeds'].shape)}; "
              f"conditioning + sampling + decode {out['run_seconds']:.2f} s")
    print(f"[{tag}] full width {res}x{res}, 4 views x 16 frames, {steps} steps x {iters} "
          f"FreeInit iteration(s): wall {wall:.2f} s, step seconds "
          + ", ".join(f"{t:.4f}" for t in out["step_seconds"])
          + f"; peak memory {peak_gb:.2f} GiB; gif frames {gif_frames}; latents "
          f"{tuple(lat.shape)} finite {bool(torch.isfinite(lat).all())}")
    for k, n in per_forward.items():
        print(f"[{tag}] launches {k}: {totals[k]} (expected {n} per UNet forward x "
              f"{unet_calls} forwards = {n * unet_calls})")
    return dict(ok=ok, per_shape=per_shape, step_s=out["step_seconds"][1],
                wall_s=wall, peak_gb=peak_gb, run_s=out["run_seconds"])


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


def _print_profile(tag: str, what: str, prof, wall_ms: float) -> dict:
    """Device time by kernel family, the idle share of the host-clock wall
    and the top kernels of one profiled window; returns the ms of each
    family and the busy total ("busy"), empty where nothing was recorded."""
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
        return {}
    print(f"{tag} {what}: wall {wall_ms:.2f} ms (profiler on), device busy {busy:.2f} ms, "
          f"idle share {max(0.0, 1 - busy / wall_ms):.3f}")
    for fam, ms in sorted(fams.items(), key=lambda x: -x[1]):
        print(f"{tag} {fam:<28} {ms:9.3f} ms  {ms / busy:6.1%}")
    for ms, count, name in sorted(kernels, reverse=True)[:8]:
        print(f"{tag} top kernel {ms:9.3f} ms x{count:<4} {name[:90]}")
    return dict(fams, busy=busy)


def _share(prof: dict, *families: str) -> str:
    """'x ms (y% of the profiled device time)' of the named kernel families,
    or 'not measured' where the profiler recorded no device time."""
    if not prof:
        return "not measured"
    ms = sum(prof.get(f, 0.0) for f in families)
    return f"{ms:.3f} ms ({ms / prof['busy']:.1%} of {prof['busy']:.2f} ms busy)"


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

    unet, *_ = build_models("full", 4, "cuda", seed=0, clip=False)
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
    fams = _print_profile("[profile]", "one UNet forward, CFG batch 128 frames", prof, wall_ms)

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
    return dict(ok=ok, rel=rel, c_share=_share(fams, "kernel C geglu"),
                b_share=_share(fams, "kernel B packed_attn"))


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
                         (37, 4, 80, 2), (70, 2, 640, 8), (5, 32, 1280, 8)):
        q, k, v = rnd(b, s_, c), rnd(b, s_, c), rnd(b, s_, c)
        cases.append((f"packed B={b} S={s_} C={c} h{h}", A.packed_attention(q, k, v, h, 0.15),
                      A.packed_small_attention(q, k, v, h, 0.15)))
    for m, c, inner in ((300, 320, 1280), (1, 64, 64), (77, 64, 192), (130, 384, 1536)):
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
                         (37, 4, 80, 2), (70, 2, 640, 8), (5, 32, 1280, 8)):
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
    plain versions in float64: planes within 1e-5, T_final within
    ``H_T_REL`` relative, each gradient row within 1e-4 of that row's
    largest magnitude."""
    from animate3d_tpu_torch.ops import rasterize as R

    ok = True
    for k in (32, 37, 256):  # 37: K not a multiple of 4 (the backward's scalar field loads)
        org, f = (torch.from_numpy(a).cuda() for a in _g_tiles(8, k, 20 + k, clamp_front=True))
        cot = torch.randn((8, 8, 256), generator=torch.Generator(device="cuda").manual_seed(k),
                          device="cuda") * 1e-2
        out = R.composite_fields(f, org)
        out64 = R._composite_fields_plain(f.double(), org.double())
        g = R.composite_fields_bwd(f, org, cot).double()
        g64 = R._composite_fields_bwd_plain(f.double(), org.double(), cot.double())
        torch.cuda.synchronize()
        perr = float((out.double() - out64).abs().max())
        t_rel = _t_final_rel(out.double(), out64)
        gerr = max(float((g[:, r] - g64[:, r]).abs().max() / g64[:, r].abs().max())
                   for r in range(10))
        good = perr <= 1e-5 and t_rel <= H_T_REL and gerr <= 1e-4
        ok &= good
        print(f"[edge] G front clamp (8, 12, {k}) vs float64: planes max|d| {perr:.3e} (tol "
              f"1e-05), T_final rel {t_rel:.3e} (tol {H_T_REL:.0e}), worst gradient row "
              f"max|d| / row max {gerr:.3e} (tol 1e-04) {'ok' if good else 'FAIL'}")
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
    fresh, *_ = build_models("full", 4, "cuda", seed=0, train=True, clip=False)
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


def train_reference_phase(unet=None, masters=None, cond=None, tag: str = "train") -> dict:
    """One full-width loss + backward on a fixed batch with fixed draws
    through the kernels (after one warm-up step, under torch.profiler:
    device time by kernel family), against the same step with every op on
    its plain version: on a seeded UNet with random conditioning, or on
    ``unet`` (its trainable ``masters``) with the text, null and image
    conditioning ``cond`` (phase 11). Tolerances: the loss within 1e-2
    relative, the concatenated trainable gradient within 5e-2 relative L2:
    the kernels' bf16 rounding (f32 sums in another order, so a flipped
    rounding of a bf16 P, dS or GEGLU hidden here and there) carried through
    the 53 blocks forward and back again, as for the forward reference."""
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

    if unet is None:
        unet, *_ = build_models("full", 4, "cuda", seed=0, train=True,
                                gradient_checkpointing=True, clip=False)
        masters = cast_frozen_bf16(unet)
    gen = torch.Generator(device="cuda").manual_seed(4)
    latents = torch.randn((4, 16, 32, 32, 4), generator=gen, device="cuda")
    if cond is None:
        cond = {"text_ctx": 0.5 * torch.randn((4, 77, 768), generator=gen, device="cuda"),
                "null_text_ctx": torch.zeros((4, 77, 768), device="cuda"),
                "image_embeds": torch.randn((4, 1024), generator=gen, device="cuda")}
    batch = TrainBatch(latents=latents, text_ctx=cond["text_ctx"],
                       null_text_ctx=cond["null_text_ctx"],
                       camera=torch.as_tensor(get_camera(4), device="cuda"),
                       image_embeds=cond["image_embeds"])
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
    fams = _print_profile(f"[{tag}-profile]", "one loss + backward at full width (64 frames, "
                          "gradient checkpointing)", prof, wall_ms)
    with routing.plain_ops():
        loss_p, grad_p, counts_p = step()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    rel = float((grad_k - grad_p).norm() / grad_p.norm())
    ok = (loss_rel <= 1e-2 and rel <= 5e-2 and bool(torch.isfinite(grad_k).all())
          and counts_k == PER_TRAIN_STEP and not any(counts_p.values()))
    print(f"[{tag}-reference] full-width loss + backward, kernels vs plain ops: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (relative {loss_rel:.3e}, tol 1e-2); trainable "
          f"gradient ({grad_k.numel()} values) relative L2 {rel:.3e} (tol 5e-2), norms "
          f"{float(grad_k.norm()):.4e} vs {float(grad_p.norm()):.4e}; launches through the "
          f"kernels {counts_k} (expected {PER_TRAIN_STEP}), through the plain ops {counts_p}")
    del unet, grad_k, grad_p
    torch.cuda.empty_cache()
    return dict(ok=ok, rel=rel, loss_rel=loss_rel, c_share=_share(fams, "kernel C geglu"),
                b_share=_share(fams, "kernel B packed_attn"),
                e_share=_share(fams, "kernel E packed_attn_bwd"), busy_ms=fams.get("busy"))


RECON_YAML = "configs/animate3d/motion_recon_frame_16.yaml"
EVAL_YAML = "configs/animate3d/visualize_testset_frame_16.yaml"
RECON_N, RECON_VIEWS, RECON_FRAMES, RECON_RES, RECON_EVAL = 20000, 4, 16, 256, 512
FIELDS_RES = 64  # the largest image of kernel G's route: 16 tiles of 16^2
TESTSET_RES, TESTSET_VIEWS, ORBIT_FRAMES = 1024, 12, 120
RECON_STEPS = 3
REFINE_YAML = "configs/animate3d/refine_frame_16.yaml"
REFINE_RES, REFINE_STEPS = 1024, 3
# per refine step at the shipped sizes, in its first 100 steps (one or two
# unlocked frames: bucket 2): the SDS batch's CFG UNet forward at 256^2 under
# attention_backend("flash") runs A, B and C as a sampling forward does (the
# forced flash takes the sites whose Sk is a multiple of 512, the ones auto
# takes at this batch, and still packs the temporal ones); kernel H runs one
# launch each way for the 8 recon renders at 1024^2 and one each way for the
# 64 SDS renders at 256^2, and kernel I one each way for the deformation of
# each of the two batches
PER_REFINE_STEP = _per(flash_fwd=40, packed_attn=20, geglu=37, composite_coarse_fwd=2,
                       composite_coarse_bwd=2, kplanes_fwd=2, kplanes_bwd=2)
# f32 operations per (pixel, candidate) pair that H's and G's functions
# need: evaluating a candidate's alpha (offsets, conic form, exp, gates)
# takes 14; a live alpha adds 12 in the forward (weight, 4 channel sums,
# alpha sum, transmittance) and 40 in the backward (transmittance, weight,
# dw, dalpha, suffix, the 10 gradient terms). The backward's function needs
# alpha once a pair: the kernels' second and third evaluations (block
# recompute, reverse walk) are their own strategy and are not counted. H
# evaluates the pairs its AABB gate and early stop leave; G (both
# directions) the pairs its exact cull keeps (a warp's 32 pixels times the
# candidates the warp marks), after one cull test for each
# (tile, candidate) and one for each (warp, listed candidate), each about
# G_CULL_F64_OPS f64 operations (rect_dead: the conic's determinant and
# eigenvalue, the distance to the rectangle, the rounding term, the log).
H_FWD_OPS = (14, 12)
H_BWD_OPS = (14, 40)
G_CULL_F64_OPS = 60
H_PLANE_TOL, H_PLANE_REL, H_GRAD_REL, H_T_REL = 2.0 ** -6, 1e-4, 1e-3, 1e-3


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


def _h_tiles(n_ct: int, kc: int, seed: int, cs: int = 4, clamp_front: bool = False):
    """Synthetic kernel-H fields: ``n_ct`` coarse tiles of cs x cs fine
    16x16 tiles, 8 coarse tiles a row; per tile kc depth-sorted candidates
    centred within 8 px around it, 1-8 px wide, opacity U(0.05, 1), 10% not
    ``ok``, a 3-sigma radius row, and 4 wide candidates of opacity 1 where
    the 0.99 clamp binds at the back of each list (with ``clamp_front``, at
    the front). :func:`_g_tiles`' layout at the coarse tile's size: an asset
    that covers its tiles, where the recon asset is faint. → (corig (n_ct,
    2), fields (n_ct, 12, kc)) as numpy float32."""
    rng = np.random.default_rng(seed)
    span = 16 * cs
    t = np.arange(n_ct)
    org = np.stack([t % 8 * span, t // 8 * span], 1).astype(np.float32)
    f = np.zeros((n_ct, 12, kc), np.float32)
    f[:, 0] = rng.uniform(org[:, :1] - 8, org[:, :1] + span + 8, (n_ct, kc))
    f[:, 1] = rng.uniform(org[:, 1:] - 8, org[:, 1:] + span + 8, (n_ct, kc))
    sx, sy = rng.uniform(1.0, 8, (n_ct, kc)), rng.uniform(1.0, 8, (n_ct, kc))
    rho = rng.uniform(-0.5, 0.5, (n_ct, kc))
    c00, c11, c01 = sx ** 2, sy ** 2, rho * sx * sy
    det = c00 * c11 - c01 ** 2
    f[:, 2], f[:, 3], f[:, 4] = c11 / det, -c01 / det, c00 / det
    f[:, 5] = rng.uniform(0.05, 1.0, (n_ct, kc))
    f[:, 11] = 3 * np.maximum(sx, sy)
    cl = slice(0, 4) if clamp_front else slice(-4, None)
    f[:, 2, cl], f[:, 3, cl], f[:, 4, cl], f[:, 5, cl], f[:, 11, cl] = 1 / 64, 0.0, 1 / 64, 1.0, 24
    f[:, 6:9] = rng.uniform(0, 1, (n_ct, 3, kc))
    f[:, 9] = np.sort(rng.uniform(1, 5, (n_ct, kc)), axis=-1)
    f[:, 10] = rng.uniform(size=(n_ct, kc)) > 0.1
    return org, f


def _h_t_fall_tiles(n_ct: int, kc: int, seed: int, cs: int = 4):
    """Kernel-H coarse tiles on which T falls under 1e-4 in the middle of
    block 1 while later candidates of that block still hit
    (tests/test_torch_raster.py::make_t_fall_fields, 8 coarse tiles a row):
    30 wide candidates of alpha ~0.5 over the whole tile, then faint ones
    (opacity 0.05) inside it, then from candidate 128 on opaque ones that
    the early stop skips. T_final ends near 1e-9: far under 1e-4, far above
    f32 underflow. → (corig, fields) as numpy float32."""
    rng = np.random.default_rng(seed)
    span = 16 * cs
    t = np.arange(n_ct)
    org = np.stack([t % 8 * span, t // 8 * span], 1).astype(np.float32)
    f = np.zeros((n_ct, 12, kc), np.float32)
    f[:, 0] = rng.uniform(org[:, :1] + 4, org[:, :1] + span - 4, (n_ct, kc))
    f[:, 1] = rng.uniform(org[:, 1:] + 4, org[:, 1:] + span - 4, (n_ct, kc))
    f[:, 2], f[:, 3], f[:, 4] = 0.2, 0.0, 0.2
    f[:, 5] = rng.uniform(0.5, 1.0, (n_ct, kc))
    f[:, 5, 30:128] = 0.05
    f[:, 2, :30], f[:, 4, :30], f[:, 5, :30] = 1e-6, 1e-6, 0.5
    f[:, 6:9] = rng.uniform(0, 1, (n_ct, 3, kc))
    f[:, 9] = np.sort(rng.uniform(1, 5, (n_ct, kc)), axis=-1)
    f[:, 10] = 1.0
    f[:, 11] = 6.0
    f[:, 11, :30] = 200.0
    return org, f


def _recon_state(device):
    """The recon asset: ``random_state(n=20000, radius=0.4)`` from seed 0."""
    from animate3d_tpu_torch.gaussians.state import random_state

    return random_state(RECON_N, radius=0.4, generator=torch.Generator().manual_seed(0),
                        device=device)


def _raster_fields(route: str, cams: dict, n_renders: int, st=None):
    """Kernel H's (``route`` "coarse") or G's ("tile") inputs as the path
    builds them: the recon asset (or ``st``) projected and binned by the
    port through the first ``n_renders`` cameras of the batch ``cams``, at
    its size."""
    from animate3d_tpu_torch.data.cameras import gs_cameras_from_batch
    from animate3d_tpu_torch.ops import rasterize as R

    st = _recon_state("cuda") if st is None else st
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


def _composite_rows(kernel: str, label, fields, orig, gen, backward=True,
                    t_gate=False) -> list:
    """Kernel H or G forward (and backward) on path fields against the
    plain versions. Limits: planes max |diff| <= 2^-6 (one flipped 1/255
    gate or 0.99 clamp moves a pixel by at most 1/255 T) and relative L2 <=
    1e-4; for G, and for H with ``t_gate``, also T_final (plane 5) within
    relative error ``H_T_REL`` wherever the plain T is above 1e-30 (products
    in another order; a live candidate (alpha >= 1/255) that G's cull
    dropped moves T by 0.39% or more), and with ``t_gate`` T under 1e-4
    (H's T-fall tiles); field gradients relative L2 <= 1e-3 (sums over a
    tile's pixels in another order, amplified by 1 / (1 - alpha) <= 100).
    The bound counts the rows each kernel reads (H: 12, G: rows 0-10) and 6
    cotangent planes. G counts the work its function needs on the pairs
    its exact cull keeps (``H_FWD_OPS`` / ``H_BWD_OPS``, ``G_CULL_F64_OPS``
    a cull test: :func:`_g_cull`); ``tpu_bound_ms`` keeps the earlier count
    (14 operations on every pair the TPU kernel evaluates) for comparison.
    G's rows also give ``graph_ms``, the device time of a call replayed
    from a CUDA graph, and its gradient rows are gated on their zeros: a
    (tile, candidate) row of the kernel's gradient is zero exactly where
    the plain version's is, so a live candidate that the kernel's cull
    dropped fails the row even where its share of the relative L2 is
    small."""
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
    t_rel = None
    if t_gate or kernel == "G":
        t_rel = _t_final_rel(out, ref)
        ok = ok and t_rel <= H_T_REL
    if t_gate:
        ok = ok and float(ref[..., 5, :].max()) < 1e-4
    fwd_bytes = in_bytes + 4.0 * out.numel()
    bound, by = _bound_f32(H_FWD_OPS[0] * pairs + H_FWD_OPS[1] * live, fwd_bytes)
    cull = tpu_bound = graph_ms = None
    if kernel == "G":
        cull = _g_cull(fields, orig)
        tpu_bound = bound
        bound, by = _bound_f32(H_FWD_OPS[0] * cull["kept"] + H_FWD_OPS[1] * live, fwd_bytes,
                               f64_ops=G_CULL_F64_OPS * cull["tests"])
        graph_ms = _graph_ms(lambda: fwd(fields, orig))
    res = [dict(name=f"{name}_fwd", shape=shape, keys=[(f"{name}_fwd", key)],
                max_abs_err=err, tol=H_PLANE_TOL, rel=rel, rel_tol=H_PLANE_REL, ok=ok,
                t_rel=t_rel, cull=cull, tpu_bound_ms=tpu_bound, graph_ms=graph_ms,
                pairs=pairs, live=live, ms=_time_ms(lambda: fwd(fields, orig), 10),
                plain_ms=_time_ms(lambda: fwd_plain(fields, orig), 1),
                library_ms=None, bound_ms=bound, bound_by=by)]
    if backward:
        cot = torch.randn(out.shape, generator=gen, device="cuda") * 1e-3
        g = bwd(fields, orig, cot)
        gref = bwd_plain(fields, orig, cot)
        same = bool(torch.equal(g, bwd(fields, orig, cot)))  # deterministic: no atomics
        torch.cuda.synchronize()
        rel = float((g - gref).norm() / gref.norm())
        ok = (rel <= H_GRAD_REL and bool(torch.isfinite(g).all()) and same
              and float(g[:, 10:].abs().max()) == 0)
        # planes 0-5 of the cotangent (r, g, b, alpha, depth, T_final)
        bwd_bytes = in_bytes + 4.0 * (cot.numel() * 6 // 8 + g.numel())
        bound, by = _bound_f32(H_BWD_OPS[0] * pairs + H_BWD_OPS[1] * live, bwd_bytes)
        tpu_bound = zeros_same = graph_ms = None
        if kernel == "G":
            tpu_bound = bound
            bound, by = _bound_f32(H_BWD_OPS[0] * cull["kept"] + H_BWD_OPS[1] * live,
                                   bwd_bytes, f64_ops=G_CULL_F64_OPS * cull["tests"])
            zeros_same = bool(torch.equal(g[:, :10].ne(0).any(1), gref[:, :10].ne(0).any(1)))
            ok = ok and zeros_same
            graph_ms = _graph_ms(lambda: bwd(fields, orig, cot))
        res.append(dict(
            name=f"{name}_bwd", shape=shape, keys=[(f"{name}_bwd", key)],
            max_abs_err=float((g - gref).abs().max()), tol=None, rel=rel, rel_tol=H_GRAD_REL,
            ok=ok, same=same, pairs=pairs, live=live, cull=cull, zeros_same=zeros_same,
            tpu_bound_ms=tpu_bound, graph_ms=graph_ms,
            ms=_time_ms(lambda: bwd(fields, orig, cot), 20),
            plain_ms=_time_ms(lambda: bwd_plain(fields, orig, cot), 1),
            library_ms=None, bound_ms=bound, bound_by=by))
    return res


def _t_final_rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest relative error of T_final (plane 5 of the planes ``(..., 8,
    256)``) wherever the reference's is above 1e-30."""
    t_out, t_ref = out[..., 5, :], ref[..., 5, :]
    keep = t_ref > 1e-30
    return float(((t_out - t_ref).abs() / t_ref)[keep].max())


def _g_cull(fields: torch.Tensor, orig: torch.Tensor) -> dict:
    """Kernel G's exact cull on these fields, by its torch mirror
    (``_fields_tile_dead``; both directions walk a warp's 16 x 2 pixels):
    the shares of (tile, candidate) and (warp, candidate) pairs culled, the
    (pixel, candidate) pairs kept (a warp's 32 pixels a marked candidate),
    the cull tests (one a (tile, candidate), one a (warp, listed
    candidate)), and the marks of the densest warp, which set a small
    grid's time, and of the mean warp, beside those of squarer 8 x 4
    blocks."""
    from animate3d_tpu_torch.ops import rasterize as R

    listed = ~R._fields_tile_dead(fields, orig)  # (T, K)
    marked = listed[:, None] & ~R._fields_tile_dead(fields, orig, strip=2)  # (T, 8, K)
    squarer = listed[:, None] & ~R._fields_tile_dead(fields, orig, block=(8, 4))
    return dict(culled=(1.0 - float(listed.float().mean()), 1.0 - float(marked.float().mean())),
                kept=32 * int(marked.sum()),
                tests=listed.numel() + marked.shape[1] * int(listed.sum()),
                densest=int(marked.sum(-1).max()), mean=float(marked.sum(-1).float().mean()),
                densest_8x4=int(squarer.sum(-1).max()),
                mean_8x4=float(squarer.sum(-1).float().mean()))


def _graph_ms(fn, iters: int = 20) -> float:
    """ms a call of ``fn`` takes replayed from one CUDA graph of ``iters``
    calls: the device's time without the host's launch path, which a
    small grid's kernel outruns."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = _time_ms(graph.replay, 3) / iters
    del graph
    return ms


def _bound_f32(ops: float, nbytes: float, f64_ops: float = 0.0):
    t_ops, t_bytes = ops / PEAK_F32_FLOPS + f64_ops / PEAK_F64_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def composite_kernel_phase() -> list:
    """Kernels H and G at every shape the stage-1 and refine paths give them.
    H: the step's renders at 256^2 (64 at the full schedule, 32 / 16 / 8 at
    the frame buckets 8 / 4 / 2; refine's 64 SDS renders), and refine's 8
    recon renders at 1024^2, forward and backward; forward only for the
    four-view test's 64 renders at 512^2 (and refine's testset pass: calls
    of 128 and 64 renders at 512^2), the validation orbit's 120 at 512^2
    and one 32-render call of the testset grid at 1024^2. G: the
    fields route's step at 64^2 (64 and 8 renders), forward and backward,
    and the step's shape on dense synthetic tiles (:func:`_g_tiles`); H
    also on dense synthetic coarse tiles (:func:`_h_tiles`) at the recon
    step's and bucket 2's shapes. No PyTorch call computes H or G:
    library_ms is null."""
    from animate3d_tpu_torch.data.cameras import (
        fixed_view_cameras,
        testset_grid_cameras,
        val_orbit_cameras,
    )
    from animate3d_tpu_torch.ops import rasterize as R

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
    # refine (phase 10): the recon renders at 1024^2 (bucket 2: 8 renders),
    # forward and backward; its 64 SDS renders at 256^2 are the recon step's
    del fields, corig
    fields, corig = _raster_fields("coarse", fixed(REFINE_RES), 8)
    rows += _composite_rows("H", "refine bucket 2, 8 renders at 1024^2", fields, corig, gen)
    for route, cams, renders, label in (
            ("coarse", testset_grid_cameras(height=RECON_EVAL, width=RECON_EVAL,
                                            total_frame=RECON_FRAMES),
             128, "refine testset, one 128-render call at 512^2"),
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
    # H at the recon step's shape on dense synthetic coarse tiles, the 0.99
    # clamp binding at the back of each list, then at its front
    for front in (False, True):
        d_org, d_f = (torch.from_numpy(a).cuda() for a in _h_tiles(1024, 512, 4 + front,
                                                                   clamp_front=front))
        rows += _composite_rows("H", "dense synthetic coarse tiles, clamp at the "
                                + ("front" if front else "back"), d_f, d_org, gen)
    # and at bucket 2's 128 coarse tiles, where a cluster of several ranks
    # serves each coarse tile and sums their blocks over distributed shared memory
    d_org, d_f = (torch.from_numpy(a).cuda() for a in _h_tiles(128, 512, 6))
    rows += _composite_rows("H", f"dense synthetic coarse tiles, {R.coarse_bwd_ranks(128, 4)} "
                            "ranks a cluster", d_f, d_org, gen)
    # T under 1e-4 inside a block with later hits in it: the early stop acts
    # only at block boundaries, so T_final keeps falling (plane 5 gated)
    t_org, t_f = (torch.from_numpy(a).cuda() for a in _h_t_fall_tiles(1024, 256, 7))
    rows += _composite_rows("H", "T under 1e-4 inside a block", t_f, t_org, gen,
                            backward=False, t_gate=True)
    print(f"[kernel] card {_smi()}")
    for r in rows:
        tol = f"(tol {r['tol']:.3e}) " if r["tol"] is not None else ""
        if "same" in r:
            tol += f"rows 10-11 zero, two launches bitwise equal {r['same']}; "
        if r.get("t_rel") is not None:
            tol += f"T_final rel {r['t_rel']:.3e} (tol {H_T_REL:.0e}); "
        if r.get("zeros_same") is not None:
            tol += f"zero rows as plain {r['zeros_same']}; "
        if r.get("cull") is not None:
            c = r["cull"]
            tol += (f"candidates culled (by the cull's torch mirror) a tile "
                    f"{c['culled'][0]:.4f}, a warp {c['culled'][1]:.4f}, {c['kept']} pairs "
                    f"kept, warp marks densest {c['densest']} mean {c['mean']:.2f} (8 x 4 "
                    f"blocks: {c['densest_8x4']}, {c['mean_8x4']:.2f}); bound at the TPU "
                    f"kernel's count {r['tpu_bound_ms']:.4f}; graph_ms {r['graph_ms']:.4f}; ")
        print(f"[kernel] {r['name']:<20} {r['shape']:<64} max|d| {r['max_abs_err']:.3e} {tol}"
              f"rel L2 {r['rel']:.3e} (tol {r['rel_tol']:.0e}) ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms none bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}; {r['pairs']} pairs, {r['live']} live, share "
              f"{r['live'] / r['pairs']:.4f}) "
              f"{'ok' if r['ok'] else 'FAIL'}")
    return rows


def packed_flash_phase() -> dict:
    """Kernel F's route on the main path's widths: three motion-module
    temporal attentions, L0 (8192 sequences of 16 frames, 320 channels, 8
    heads of 40), L2 (512 sequences, 1280 channels, 8 heads of 160) and a
    32-frame clip at L2 (256 sequences of 32 frames), bf16, each forward
    and backward under attention_backend("packed_flash"), counters zeroed
    just before and read just after (kernel B as F forward, E backward),
    against the same layers on the plain versions."""
    from animate3d_tpu_torch.models.attention_layers import TemporalSelfAttention
    from animate3d_tpu_torch.ops import _build, routing
    from animate3d_tpu_torch.ops.attention import attention_backend

    torch.manual_seed(7)
    gen = torch.Generator(device="cuda").manual_seed(7)
    sites = []
    for b, s, c in ((8192, 16, 320), (512, 16, 1280), (256, 32, 1280)):
        layer = TemporalSelfAttention(c, 8).to("cuda", torch.bfloat16)
        sites.append((layer, torch.randn((b, s, c), generator=gen, device="cuda")
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


def _recon_workspace(tmp: str, colour_seed=None):
    """The recon config's inputs, made from seed 0: the asset written as a
    .ply by the port, and 64 RGBA frames (4 views x 16, view-major
    ``{i}.png``) rendered by the port from the same asset, each frame under
    its own translation (frame 0 static). With ``colour_seed`` (refine,
    phase 10), the same gaussians with SH colours drawn from that seed, as
    ``asset_colour.ply`` and ``frames_colour/``: the recon asset's colour
    is the background's gray, so its renders are nearly constant images,
    on which the guidance VAE's GroupNorm (eps 1e-6) is degenerate (the
    pixel gradient reaches 1e7 and the SDS gradient differs 80% between two
    identical runs)."""
    from PIL import Image

    from animate3d_tpu_torch.data.cameras import fixed_view_cameras, gs_cameras_from_batch
    from animate3d_tpu_torch.gaussians.ply import write_gaussian_ply
    from animate3d_tpu_torch.rendering.renderer4d import Renderer4DConfig, render_batch

    st = _recon_state("cuda")
    tag = ""
    if colour_seed is not None:
        gen = torch.Generator(device="cuda").manual_seed(colour_seed)
        st.features_dc.copy_(torch.randn(st.features_dc.shape, generator=gen, device="cuda"))
        tag = "_colour"
    ply = os.path.join(tmp, f"asset{tag}.ply")
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
    frames = os.path.join(tmp, f"frames{tag}")
    os.makedirs(frames)
    for i in range(b):
        Image.fromarray(rgba[i].numpy(), "RGBA").save(os.path.join(frames, f"{i}.png"))
    print(f"[recon] workspace{tag}: {n} gaussians, {b} frames of {RECON_RES}^2, mean alpha "
          f"{float(out.alpha.mean()):.3f}, rgb std {float(out.rgb.std()):.4f}")
    return ply, frames


def _recon_args(tmp: str, ply: str, frames: str, res: int, eval_res: int) -> list:
    """The dotted overrides of the recon config: the prompt (the yaml's ???),
    the data paths, the output root, the render and test sizes."""
    return ["system.prompt_processor.prompt=a toy", f"data.image_root={frames}",
            f"system.geometry.geometry_convert_from={ply}", f"exp_root_dir={tmp}/out{res}",
            f"data.height={res}", f"data.width={res}", f"data.eval_height={eval_res}",
            f"data.eval_width={eval_res}"]


def recon_phase(tmp: str, ply: str, frames: str, res: int, eval_res: int,
                per_step: dict, tag: str, yaml: str = RECON_YAML, extra=()) -> dict:
    """The recon CLI with the shipped config for RECON_STEPS steps plus its
    four-view test pass at ``eval_res``^2, launch counters zeroed just
    before and read just after. The only changes are dotted overrides
    (:func:`_recon_args`), the step count and trajectories on. The test
    pass composites its 64 renders in one forward launch and writes the
    PSNR / SSIM report against the frames."""
    from PIL import Image

    from animate3d_tpu_torch.cli.launch import main as launch_main
    from animate3d_tpu_torch.ops import _build

    args = ["--config", yaml, "--train", *_recon_args(tmp, ply, frames, res, eval_res),
            f"trainer.max_steps={RECON_STEPS}", "system.save_gaussian_trajectory=true", *extra]
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
    expected["kplanes_fwd"] += 1  # and their deformation
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
                       buckets: bool = True, light: bool = False) -> dict:
    """Seconds per recon step (host clock, ended by a synchronize; one
    warm-up step, then the mean of 3) at the full schedule
    (global_step = 50 x 16 + 1: all 64 renders) and, with ``buckets``, at
    the frame buckets 2 / 4 / 8, with their schedule-weighted average over
    the 800-step run (steps 0-99 bucket 2, 100-199 bucket 4, 200-399
    bucket 8, 400-799 all 16 frames: the JAX package's bench.py
    definition); with ``light`` ('light' sampling), at a step of two frames
    (8 renders), the schedule average then being 750 such steps and 50 at
    all frames. Launch counters zeroed just before, read just after; then
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
    elif light:
        t2 = measure(ipf + 10)
        avg = (750 * t2 + 50 * full) / 800.0
        measured = 2
    totals, per_shape = _build.launch_totals(), dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = measured * (iters + 1)
    expected = {k: n * steps for k, n in per_step.items()}
    res = system.cfg.renderer.height
    print(f"[{tag}-time] seconds per recon step at {res}^2: full schedule (64 renders) "
          f"{full:.4f}" + (f"; buckets 2 / 4 / 8 (8 / 16 / 32 renders) {t2:.4f} / {t4:.4f} / "
                           f"{t8:.4f}; schedule average {avg:.4f}" if buckets else "")
          + (f"; a light step (8 renders) {t2:.4f}; schedule average {avg:.4f}"
             if light else "")
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
    fams = _print_profile(f"[{tag}-profile]", f"one recon step at the full schedule (64 renders "
                          f"at {res}^2, 20,000 gaussians)", prof, wall_ms)
    return dict(ok=totals == expected and np.isfinite(full), per_shape=per_shape, step_s=full,
                buckets=(t2, t4, t8), avg_s=avg, peak_gb=peak_gb, batch=batch,
                h_bwd_share=_share(fams, "kernel H bwd"), h_fwd_share=_share(fams, "kernel H fwd"),
                h_share=_share(fams, "kernel H fwd", "kernel H bwd"),
                g_bwd_share=_share(fams, "kernel G bwd"),
                g_share=_share(fams, "kernel G fwd", "kernel G bwd"))


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
    n_r = len(ts)
    ts, fw = torch.as_tensor(ts, device="cuda"), torch.as_tensor(fw, device="cuda")

    gen_state = system.generator.get_state()

    def run():
        _build.reset_launches()
        # the mesh-edge ARAP draws each node's neighbour subset from the
        # system's generator: both runs get the same draw
        system.generator.set_state(gen_state)
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
    print(f"[{tag}-reference] recon loss + backward at {res}^2 ({n_r} renders), kernels vs plain: "
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
    expected = _per(composite_coarse_fwd=-(-renders // per_call), kplanes_fwd=1)
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
    fams = _print_profile("[eval-profile]", f"the testset render alone ({renders} renders "
                          f"at {TESTSET_RES}^2)", prof, render_ms)
    print(f"[eval] testset render alone: wall {render_ms:.2f} ms (profiler on), peak memory "
          f"{peak_render:.2f} GiB")

    base = ["--config", RECON_YAML, *_recon_args(tmp, ply, frames, RECON_RES, RECON_EVAL)]
    res, wall_v, totals_v, shape_v = _cli_launches(base[:2] + ["--validate"] + base[2:])
    ok_val = (totals_v == _per(composite_coarse_fwd=1, kplanes_fwd=1) and res["rgb"].shape ==
              (ORBIT_FRAMES, RECON_EVAL, RECON_EVAL, 3) and os.path.exists(res["video"])
              and os.path.exists(res["gif"]) and np.isfinite(res["rgb"]).all())
    print(f"[eval] --validate: {res['rgb'].shape[0]}-frame orbit at {RECON_EVAL}^2 in "
          f"{wall_v:.2f} s; {os.path.basename(res['video'])}, {os.path.basename(res['gif'])}; "
          f"launches {totals_v}")
    del res
    res, wall_e, totals_e, shape_e = _cli_launches(base[:2] + ["--export"] + base[2:])
    trajs = os.listdir(os.path.join(res["trial_dir"], "save", "gaussian_trajectory"))
    report = res["report"]
    ok_exp = (totals_e == _per(composite_coarse_fwd=1, kplanes_fwd=1)
              and len(trajs) == RECON_FRAMES
              and report is not None and np.isfinite([report["psnr"], report["ssim"]]).all())
    print(f"[eval] --export: {len(trajs)} trajectory files, four-view test in {wall_e:.2f} s, "
          f"report PSNR {report['psnr']} dB SSIM {report['ssim']} (LPIPS "
          f"{report.get('lpips', 'not computed: no weights')}); launches {totals_e}")
    del res
    per_shape = collections.Counter(per_shape) + collections.Counter(shape_v) + \
        collections.Counter(shape_e)
    return dict(ok=ok_test and ok_val and ok_exp, per_shape=dict(per_shape), wall_s=wall,
                render_ms=render_ms, peak_gb=peak_render,
                h_fwd_share=_share(fams, "kernel H fwd"))


def _write_artifact_root(tmp: str) -> str:
    """A seeded artifact root in the released layout: the full-width CLIP
    text tower (SD1.5's: 12 layers, width 768) as
    ``sd15/text_encoder/model.safetensors`` with the byte-level tokenizer
    beside it, and the IP-Adapter's vision tower (ViT-H/14: 32 layers,
    width 1280, projection 1024) as ``IP-Adapter/models/image_encoder/
    model.safetensors``, both in bf16 (1.5 GB together). The UNet and the
    VAE stay seeded: their loaders are held on the CPU."""
    from animate3d_tpu_torch.convert.weights import write_safetensors
    from animate3d_tpu_torch.models.clip import (
        CLIPTextModel,
        CLIPVisionModelWithProjection,
    )
    from animate3d_tpu_torch.models.factory import init_params
    from animate3d_tpu_torch.utils.tokenizer import write_char_level_tokenizer

    root = os.path.join(tmp, "weights")
    t0 = time.perf_counter()
    for i, (cls, sub) in enumerate(((CLIPTextModel, "sd15/text_encoder"),
                                    (CLIPVisionModelWithProjection,
                                     "IP-Adapter/models/image_encoder"))):
        with torch.device("cuda"):
            tower = cls()
        init_params(tower, 30 + i)
        os.makedirs(os.path.join(root, sub))
        write_safetensors(os.path.join(root, sub, "model.safetensors"),
                          {k: v.to(torch.bfloat16) for k, v in tower.state_dict().items()})
        del tower
    write_char_level_tokenizer(os.path.join(root, "sd15", "tokenizer"))
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    print(f"[refine] artifact root: text and vision towers at full width, bf16, "
          f"{size / 2 ** 30:.2f} GiB written in {time.perf_counter() - t0:.1f} s")
    return root


def _refine_args(tmp: str, ply: str, frames: str, trial: str, root: str) -> list:
    """The refine config's overrides: the prompt (the yaml's ???), the data
    and output paths, ``system.weights`` (the recon trial's ckpts), the
    artifact root."""
    return ["system.prompt_processor.prompt=a toy", f"data.image_root={frames}",
            f"system.geometry.geometry_convert_from={ply}", f"exp_root_dir={tmp}/refine",
            f"system.weights={trial}/ckpts", f"system.guidance.flax_params_dir={root}"]


def refine_phase(tmp: str, ply: str, frames: str, trial: str, root: str) -> dict:
    """The refine CLI with configs/animate3d/refine_frame_16.yaml as it is
    (recon renders at 1024^2, an SDS batch of 64 renders at 256^2, guidance
    scale 5, t in [20, 200], the guidance UNet and VAE seeded, both CLIP
    towers read from the artifact root) chained from the recon trial, 200
    steps cut to REFINE_STEPS, then its testset pass (12 views x 16 frames
    at 512^2, in calls of 128 and 64 renders), on the coloured copy of the
    recon asset and its frames (``_recon_workspace(colour_seed=...)``);
    launch counters zeroed just before and read just after, asserted
    exactly."""
    from animate3d_tpu_torch.cli.launch import main as launch_main
    from animate3d_tpu_torch.ops import _build

    args = ["--config", REFINE_YAML, "--train", *_refine_args(tmp, ply, frames, trial, root),
            f"trainer.max_steps={REFINE_STEPS}"]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = launch_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    totals, per_shape = _build.launch_totals(), dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {k: n * REFINE_STEPS for k, n in PER_REFINE_STEP.items()}
    expected["composite_coarse_fwd"] += 2  # the testset pass: 192 renders in 2 calls
    expected["kplanes_fwd"] += 1  # and their deformation, once
    system = res["system"]
    _, _, text, vision = system.guidance.modules
    trial_r = res["trial_dir"]
    metrics = res["metrics"]
    losses = [(m["loss"], m["loss_sds"]) for m in metrics]
    images = os.listdir(os.path.join(trial_r, "save", "images"))
    ckpt = os.path.exists(os.path.join(trial_r, "ckpts", f"step_{REFINE_STEPS}",
                                       "checkpoint.pt"))
    ok = (totals == expected and len(losses) == REFINE_STEPS and np.isfinite(losses).all()
          and text is not None and vision is not None and ckpt
          and float(system.guidance_inputs["text_cond"].abs().sum()) > 0
          and len(images) == 12 * RECON_FRAMES and np.isfinite(res["rgb"]).all())
    print(f"[refine] CLI --train refine_frame_16.yaml ({REFINE_STEPS} steps, chained from "
          f"{os.path.basename(trial)}) + testset at 512^2: wall {wall:.2f} s; peak memory "
          f"{peak_gb:.2f} GiB; (loss, loss_sds) "
          + ", ".join(f"({a:.5f}, {b:.5f})" for a, b in losses)
          + f"; towers loaded text {text is not None} vision {vision is not None}; "
          f"{len(images)} test images; ckpt {ckpt}")
    print(f"[refine] launches {totals} (expected {expected}: {PER_REFINE_STEP} per step, two "
          f"forwards for the testset pass); per shape {per_shape}")
    return dict(ok=ok, per_shape=per_shape, system=system, wall_s=wall, peak_gb=peak_gb,
                args=args)


def _refine_batches(system, args: list, n: int):
    """The refine config's whole-video batch at 1024^2 on the card and ``n``
    SDS batches of the random-camera sampler."""
    from animate3d_tpu_torch.cli.launch import _guidance_batch
    from animate3d_tpu_torch.core.config import load_config
    from animate3d_tpu_torch.data.cameras import gs_cameras_from_batch
    from animate3d_tpu_torch.data.multi_image import MultiImageDataset

    cfg = load_config(REFINE_YAML, cli_args=args[3:], makedirs=False)
    ds = MultiImageDataset.from_config(cfg.data, seed=cfg.seed)
    raw = ds.batch(0)
    batch = {"gs_cameras": gs_cameras_from_batch(raw, device="cuda"),
             "timestamps": raw["timestamps"], "rgb": torch.as_tensor(raw["rgb"], device="cuda"),
             "mask": torch.as_tensor(raw["mask"].astype(np.float32), device="cuda")}
    return batch, [_guidance_batch(system, ds.batch(i + 1)["random_camera"]) for i in range(n)]


def refine_timing_phase(system, args: list) -> dict:
    """Seconds per refine step (host clock, ended by a synchronize; one
    warm-up, then the mean of 3) in the first 100 steps' schedule (bucket
    2), with the peak memory (the 1024^2 render keeps its gradients) and
    the launch counters zeroed just before, read just after; one step under
    torch.profiler (device time by kernel family), then the VAE encode
    (forward + backward of the 64 SDS renders) and the vision tower (4
    frames) alone, on CUDA events, as shares of the step's device time."""
    from torch.profiler import ProfilerActivity, profile

    from animate3d_tpu_torch.ops import _build

    batch, gbs = _refine_batches(system, args, 5)
    iters = 3
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    system.global_step = REFINE_STEPS
    system.step(batch, guidance_batch=gbs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        system.step(batch, guidance_batch=gbs[1 + i])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / iters
    totals, per_shape = _build.launch_totals(), dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = {k: n * (iters + 1) for k, n in PER_REFINE_STEP.items()}
    print(f"[refine-time] seconds per refine step (8 recon renders at 1024^2 + 64 SDS renders "
          f"at 256^2, CFG UNet forward, VAE encode of 64 frames with its backward, vision "
          f"tower on 4 frames): {step_s:.4f}; peak memory {peak_gb:.2f} GiB; launches "
          f"{totals} over {iters + 1} steps (expected {expected})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        system.step(batch, guidance_batch=gbs[4])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams = _print_profile("[refine-profile]", "one refine step", prof, wall_ms)

    g = system.guidance
    rgb = system._render_guidance_rgb(gbs[4]).detach()

    def vae():
        x = rgb.clone().requires_grad_(True)
        mean, logvar = g._chunked_vae_encode(x * 2.0 - 1.0)
        (mean.sum() + logvar.sum()).backward()

    def clip():
        with torch.no_grad():
            g.image_encode(rgb.reshape(-1, system.cfg.n_frame, *rgb.shape[1:])[:, 0])

    parts = {}
    for name, fn in (("VAE encode fwd + bwd", vae), ("CLIP vision", clip)):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        parts[name] = start.elapsed_time(end)
    busy = fams.get("busy")
    share = lambda ms: f"{ms:.3f} ms" + (f" ({ms / busy:.1%} of {busy:.2f} ms busy)"
                                         if busy else " (step device time not measured)")
    shares = {"A": _share(fams, "kernel A flash_fwd"), "B": _share(fams, "kernel B packed_attn"),
              "C": _share(fams, "kernel C geglu"),
              "H": _share(fams, "kernel H fwd", "kernel H bwd"),
              "VAE": share(parts["VAE encode fwd + bwd"]), "CLIP": share(parts["CLIP vision"])}
    print("[refine-profile] shares of one refine step: " + "; ".join(
        f"{k} {v}" for k, v in shares.items()))
    return dict(ok=totals == expected and np.isfinite(step_s), per_shape=per_shape,
                step_s=step_s, peak_gb=peak_gb, shares=shares, batch=batch, gb=gbs[4])


def refine_reference_phase(system, batch, gb) -> dict:
    """One refine step's loss and backward (recon renders at 1024^2, the SDS
    batch) through the kernels against the same step on the plain versions,
    with the same draws (render masks, ARAP sample, t, the posterior ε and
    the frames' noise). Limits, the MV-VDM gates (the guidance UNet is
    bf16): loss_sds and the total loss within 1e-2 relative, the
    deformation gradient within 5e-2 relative L2. Then, reported only, the
    SDS gradient's spread between two runs of the kernels, and on the blank
    asset."""
    from animate3d_tpu_torch.ops import _build, routing
    from animate3d_tpu_torch.pipelines.guidance import GuidanceDraws
    from animate3d_tpu_torch.rendering.renderer4d import make_draws
    from animate3d_tpu_torch.systems.animate3d import StepDraws

    system.global_step = REFINE_STEPS
    cams, ts, rgb, mask, fw = system.step_batch(batch)
    gen = torch.Generator(device="cuda").manual_seed(8)
    n = system.state.num_points
    lat = system.guidance.cfg.image_size // 8
    bn, f = system.cfg.n_view, system.cfg.n_frame
    draws = StepDraws(
        render=make_draws(system.cfg.renderer, len(ts), n, gen, "cuda"),
        arap_idx=torch.randint(0, n, (system.cfg.loss.arap_sample_num,), generator=gen,
                               device="cuda"),
        guidance=GuidanceDraws(
            t_video=torch.tensor([117], device="cuda"),
            posterior=torch.randn((bn * f, lat, lat, 4), generator=gen, device="cuda"),
            noise=torch.randn((bn, f - 1, lat, lat, 4), generator=gen, device="cuda")))
    params = [p for _, p in system.field.named_parameters()]
    n_r = len(ts)
    ts, fw = torch.as_tensor(ts, device="cuda"), torch.as_tensor(fw, device="cuda")
    lambdas = system.lambdas(system.global_step)

    def run():
        _build.reset_launches()
        loss, _ = system.loss(cams, ts, rgb, mask, fw, lambdas, draws)
        loss_sds = system.sds_loss(gb, lambdas, draws.guidance)
        flat = lambda gs: torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                                     for g, p in zip(gs, params)])
        g_rec = flat(torch.autograd.grad(loss, params, allow_unused=True))
        g_sds = flat(torch.autograd.grad(loss_sds, params, allow_unused=True))
        torch.cuda.synchronize()
        total = loss + lambdas["lambda_sds"] * loss_sds
        return (float(loss_sds.detach()), float(total.detach()),
                g_rec + lambdas["lambda_sds"] * g_sds, g_rec, g_sds, _build.launch_totals())

    sds_k, tot_k, g_k, gr_k, gs_k, counts_k = run()
    with routing.plain_ops():
        sds_p, tot_p, g_p, gr_p, gs_p, counts_p = run()
    sds_rel, tot_rel = abs(sds_k - sds_p) / abs(sds_p), abs(tot_k - tot_p) / abs(tot_p)
    rel_l2 = lambda a, b: float((a - b).norm() / b.norm())
    rel, rel_rec, rel_sds = rel_l2(g_k, g_p), rel_l2(gr_k, gr_p), rel_l2(gs_k, gs_p)
    ok = (sds_rel <= 1e-2 and tot_rel <= 1e-2 and rel <= 5e-2
          and bool(torch.isfinite(g_k).all()) and counts_k == PER_REFINE_STEP
          and not any(counts_p.values()))
    print(f"[refine-reference] refine loss + backward, kernels vs plain: loss_sds {sds_k:.7f} "
          f"vs {sds_p:.7f} (relative {sds_rel:.3e}, tol 1e-2); total {tot_k:.7f} vs "
          f"{tot_p:.7f} (relative {tot_rel:.3e}, tol 1e-2); deformation gradient "
          f"({g_k.numel()} values) relative L2 {rel:.3e} (tol 5e-2), norms "
          f"{float(g_k.norm()):.4e} vs {float(g_p.norm()):.4e}; its recon part {rel_rec:.3e}, "
          f"its SDS part {rel_sds:.3e} (norm {float(gs_p.norm()):.4e} x lambda_sds "
          f"{lambdas['lambda_sds']}); launches through the kernels {counts_k} (expected "
          f"{PER_REFINE_STEP}), through the plain ops {counts_p}")
    # reported, not gated: the SDS gradient's own spread (the kernels twice),
    # then on a blank asset (SH colour 0: the background's gray, as the recon
    # asset's), whose constant renders the VAE's GroupNorm scales without bound
    gs_k2 = run()[4]
    dc = system.state.features_dc.clone()
    system.state.features_dc.zero_()
    blank_1, blank_2 = run()[4], run()[4]
    with routing.plain_ops():
        blank_p = run()[4]
    system.state.features_dc.copy_(dc)
    print(f"[refine-reference] the SDS part's spread (reported): the kernels twice "
          f"{rel_l2(gs_k2, gs_k):.3e}; on the blank asset (SH colour 0) its norm "
          f"{float(blank_1.norm()):.4e} (coloured {float(gs_k.norm()):.4e}), the kernels twice "
          f"{rel_l2(blank_2, blank_1):.3e}, kernels vs plain {rel_l2(blank_1, blank_p):.3e}")
    return dict(ok=ok, rel=rel, sds_rel=sds_rel, tot_rel=tot_rel, rel_sds=rel_sds,
                rel_rec=rel_rec)


TRAIN_YAML = "configs/training/train.yaml"


def _write_pretrained_tree(root: str) -> str:
    """The MVDream stack's diffusers ``unet/`` (the SD1.5 base of the MV UNet
    at full width: every frozen tensor, without the motion modules, their
    adapters and the IP-Adapter's keys) and ``vae/``, as f32 safetensors in
    the artifact root's ``sd15/`` (beside phase 10's text tower): the
    seeded init (seed 40) with every tensor nudged (x (1 + 0.01 N(0, 1)), or
    + 0.01 N(0, 1) for 1-d ones), so that bf16 rounding moves the norms."""
    from animate3d_tpu_torch.convert.weights import write_safetensors
    from animate3d_tpu_torch.models.factory import build_models
    from animate3d_tpu_torch.pipelines.train_mvvdm import is_trainable

    t0 = time.perf_counter()
    unet, vae, *_ = build_models("full", 4, "cuda", seed=40, train=True, clip=False)
    gen = torch.Generator(device="cuda").manual_seed(41)
    base = os.path.join(root, "sd15")
    for sub, module in (("unet", unet), ("vae", vae)):
        sd = {}
        with torch.no_grad():
            for k, v in module.state_dict().items():
                if sub == "unet" and (is_trainable(k) or "_ip." in k
                                      or k.startswith("encoder_hid_proj")):
                    continue
                r = torch.randn(v.shape, generator=gen, device="cuda")
                sd[k] = (v + 0.01 * r) if v.dim() < 2 else v * (1 + 0.01 * r)
        os.makedirs(os.path.join(base, sub), exist_ok=True)
        write_safetensors(os.path.join(base, sub, "diffusion_pytorch_model.safetensors"), sd)
        del sd
    del unet, vae
    torch.cuda.empty_cache()
    size = sum(os.path.getsize(os.path.join(base, s, "diffusion_pytorch_model.safetensors"))
               for s in ("unet", "vae"))
    print(f"[train-weights] pretrained_model_path {base}: unet/ and vae/ at full width, f32, "
          f"{size / 2 ** 30:.2f} GiB written in {time.perf_counter() - t0:.1f} s")
    return base


def train_weights_phase(tmp: str, root: str, pretrained: str) -> dict:
    """Phase 11: the trainer CLI on configs/training/train.yaml as it is,
    overridden only in the paths (output, ``flax_params_dir`` = the artifact
    root, ``pretrained_model_path``, the phase-5 workspace's manifest and
    frames, whose two items carry distinct captions), ``max_train_steps`` 3
    and the workspace's settings (``gradient_checkpointing``, 16 frames a
    clip, log every step), once with ``cast_frozen_bf16`` true and once
    false, launch counters zeroed just before and read just after each run.
    Checks: launches exactly PER_TRAIN_STEP a step; every family loaded; the
    frozen weights equal the files (rounded to bf16, or f32 bit for bit);
    the masters moved from their seeded init; captions and image embeds
    live. Then one loss + backward at the loaded weights with the run's
    conditioning, through the kernels against the plain versions."""
    from animate3d_tpu_torch.cli.train_mvvdm import main as train_main
    from animate3d_tpu_torch.convert.weights import read_safetensors
    from animate3d_tpu_torch.models.factory import build_models
    from animate3d_tpu_torch.ops import _build

    _train_workspace(tmp)
    manifest = os.path.join(tmp, "manifest.json")
    with open(manifest) as fh:
        item = json.load(fh)[0]
    with open(manifest, "w") as fh:
        json.dump([dict(item, caption="a toy robot walking"),
                   dict(item, caption="a red dragon flying")], fh)
    files = read_safetensors(os.path.join(pretrained, "unet",
                                          "diffusion_pytorch_model.safetensors"))
    fresh, *_ = build_models("full", 4, "cuda", seed=42, train=True, clip=False)
    init = {k: v.detach().clone() for k, v in fresh.named_parameters() if v.requires_grad}
    del fresh
    out = {}
    for cast in (True, False):
        args = ["--config", TRAIN_YAML, f"output_dir={tmp}/out_weights_{cast}",
                f"flax_params_dir={root}", f"pretrained_model_path={pretrained}",
                f"train_data.manifest_path={manifest}", f"train_data.video_root={tmp}/vids",
                "train_data.total_frames=16", f"max_train_steps={TRAIN_STEPS}",
                "gradient_checkpointing=true", "log_every_n_steps=1",
                f"cast_frozen_bf16={str(cast).lower()}"]
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = train_main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        totals, per_shape = _build.launch_totals(), dict(_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        expected = {k: n * TRAIN_STEPS for k, n in PER_TRAIN_STEP.items()}
        unet, masters = res["unet"], res["optimizer"].masters
        params = dict(unet.named_parameters())
        want = torch.bfloat16 if cast else torch.float32
        frozen_ok = sum(int(params[k].dtype == want and torch.equal(
            params[k].detach(), v.to("cuda", want))) for k, v in files.items())
        moved = sum(int(not torch.equal(m.detach(), init[k])) for k, m in masters.items())
        cond = res["conditioning"]
        losses = [m["loss"] for m in res["metrics"]]
        live = (float((cond["text_ctx"] - cond["null_text_ctx"]).abs().max()) > 0
                and float(cond["image_embeds"].abs().sum()) > 0)
        step_s = float(np.mean(res["step_seconds"][1:]))
        ok = (totals == expected and frozen_ok == len(files) and moved >= 0.9 * len(masters)
              and {"unet", "vae", "text_encoder", "image_encoder"} <= res["loaded"]
              and len(losses) == TRAIN_STEPS and all(np.isfinite(losses)) and live)
        print(f"[train-weights] cast_frozen_bf16={cast}: wall {wall:.2f} s, step seconds "
              + ", ".join(f"{t:.4f}" for t in res["step_seconds"])
              + f"; peak memory {peak_gb:.2f} GiB; losses "
              + ", ".join(f"{x:.5f}" for x in losses) + f"; loaded {sorted(res['loaded'])}")
        print(f"[train-weights] cast_frozen_bf16={cast}: launches {totals} (expected "
              f"{expected}); frozen weights equal to the files ({want}) {frozen_ok}/"
              f"{len(files)}; masters moved {moved}/{len(masters)}; caption and image "
              f"conditioning live {live}; card {_smi()}")
        out[cast] = dict(ok=ok, per_shape=per_shape, step_s=step_s, peak_gb=peak_gb, wall_s=wall)
        if not cast:
            out["ref"] = train_reference_phase(unet, masters, cond, tag="train-weights")
        del unet, masters, params, res, cond
        shutil.rmtree(f"{tmp}/out_weights_{cast}")  # checkpoints of 10+ GB
        torch.cuda.empty_cache()
    ok = out[True]["ok"] and out[False]["ok"] and out["ref"]["ok"]
    per_shape = collections.Counter(out[True]["per_shape"]) + \
        collections.Counter(out[False]["per_shape"])
    return dict(ok=ok, per_shape=dict(per_shape), bf16=out[True], f32=out[False],
                ref=out["ref"])


def validate_weights_phase(tmp: str, root: str) -> dict:
    """``cli/validate_weights.py --smoke`` on the artifact root: the key
    audit, the golden denoise step at full width and a 2-step sample
    through the sampling CLI with every family from the root."""
    from animate3d_tpu_torch.cli.validate_weights import main as validate_main

    t0 = time.perf_counter()
    rep = validate_main(["--all", root, "--output", os.path.join(tmp, "validate"), "--smoke"])
    wall = time.perf_counter() - t0
    ok = (rep["ok"] and rep["smoke"]["ok"] and set(rep["loaded_families"]) ==
          {"unet", "vae", "text_encoder", "image_encoder"}
          and rep["golden_denoise"]["shape"] == [8, 16, 32, 32, 4])
    print(f"[validate-weights] --smoke on the root: wall {wall:.2f} s; audit {rep['audit']}; "
          f"golden denoise {rep['golden_denoise']}; smoke {rep['smoke']}; ok {rep['ok']}")
    return dict(ok=ok, wall_s=wall)


MESH_YAML = "configs/animate3d/mesh_animation_frame_16.yaml"
STATIC_YAML = "configs/animate3d/visualize_four_view_static.yaml"
MESH_ROWS, MESH_COLS = 100, 200  # a UV sphere of 20,000 vertices, as phase 7's asset


def _write_mesh_asset(d: str) -> str:
    """A seeded textured OBJ: a UV sphere of radius 0.4 (MESH_ROWS x
    MESH_COLS vertices, the seam duplicated) with ``vt`` coordinates, an MTL
    and a 256² PNG texture (a seeded 16² pattern, bilinearly enlarged)."""
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    i, j = np.meshgrid(np.arange(MESH_ROWS), np.arange(MESH_COLS), indexing="ij")
    theta, phi = np.pi * (i + 0.5) / MESH_ROWS, 2 * np.pi * j / (MESH_COLS - 1)
    v = 0.4 * np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi),
                        np.cos(theta)], -1).reshape(-1, 3)
    uv = np.stack([j / (MESH_COLS - 1), 1 - (i + 0.5) / MESH_ROWS], -1).reshape(-1, 2)
    q = (i * MESH_COLS + j)[:-1, :-1].reshape(-1)
    faces = np.concatenate([np.stack([q, q + MESH_COLS, q + 1], 1),
                            np.stack([q + 1, q + MESH_COLS, q + MESH_COLS + 1], 1)])
    tex = np.random.default_rng(7).integers(0, 255, (16, 16, 3), dtype=np.uint8)
    Image.fromarray(tex).resize((256, 256), Image.BILINEAR).save(os.path.join(d, "tex.png"))
    with open(os.path.join(d, "asset.mtl"), "w") as f:
        f.write("newmtl m0\nmap_Kd tex.png\n")
    path = os.path.join(d, "asset.obj")
    with open(path, "w") as f:
        f.write("mtllib asset.mtl\nusemtl m0\n")
        f.writelines(f"v {a:.6f} {b:.6f} {c:.6f}\n" for a, b, c in v)
        f.writelines(f"vt {a:.6f} {b:.6f}\n" for a, b in uv)
        f.writelines(f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}\n" for a, b, c in faces)
    return path


def mesh_phase(tmp: str) -> dict:
    """Phase 12: the mesh-animation flow at mesh_animation_frame_16.yaml's
    sizes (4 views x 16 frames at 256^2, a 20,000-vertex textured mesh):
    ``mesh2gaussian``; the static four-view render with
    visualize_four_view_static.yaml (the tracking templates); a motion
    video rendered by the port under a seeded smooth per-vertex motion,
    written as a 4-view GIF by ``export_to_gif_mv`` (random-weight
    sampling gives noise, on which tracking says nothing); ``split_gif``;
    ``tracking`` with the propagation backend on the card; the recon CLI
    with the mesh yaml as it is (800 steps cut to 3, then timed steps,
    'light' sampling, mesh-edge ARAP); ``--export``; ``export_animated_mesh``
    to a GLB. Launch counters zeroed before and read after the static
    render, the recon run and the export, each asserted exactly."""
    from PIL import Image

    from animate3d_tpu_torch.data.cameras import fixed_view_cameras, gs_cameras_from_batch
    from animate3d_tpu_torch.gaussians.ply import load_gaussians
    from animate3d_tpu_torch.rendering.renderer4d import Renderer4DConfig, render_batch
    from animate3d_tpu_torch.tools import export_animated_mesh, mesh2gaussian, split_gif, tracking
    from animate3d_tpu_torch.utils.saving import export_to_gif_mv

    t_all = time.perf_counter()
    res, nf = RECON_RES, RECON_FRAMES
    obj = _write_mesh_asset(os.path.join(tmp, "mesh"))
    t0 = time.perf_counter()
    mesh2gaussian.main(["--input_obj", obj, "--output_dir", f"{tmp}/mesh_data",
                        "--output_name", "asset"])
    ply, conn = f"{tmp}/mesh_data/asset.ply", f"{tmp}/mesh_data/asset.json"
    t_m2g = time.perf_counter() - t0
    static, wall_s, totals_s, shape_s = _cli_launches([
        "--config", STATIC_YAML, "--test", f"system.geometry.geometry_convert_from={ply}",
        f"exp_root_dir={tmp}/mesh_out"])
    templates = os.path.join(static["trial_dir"], "save", "images")
    ok_static = (totals_s == _per(composite_coarse_fwd=1, kplanes_fwd=1)
                 and sorted(os.listdir(templates)) == [f"{v}.png" for v in range(4)])
    del static

    g = load_gaussians(ply, 90.0, 0.0, 1.0, device="cuda")
    amp = 0.03 * torch.randn((3, 3), generator=torch.Generator().manual_seed(1))
    disp = (torch.linspace(0, 1, nf)[:, None, None]
            * torch.sin(g.xyz.cpu() @ (6.0 * amp))).cuda()
    cams = fixed_view_cameras(height=res, width=res, total_frame=nf)
    b, n = RECON_VIEWS * nf, g.num_points
    frame = torch.arange(b, device="cuda") % nf
    with torch.no_grad():
        out = render_batch(g, lambda _: (g.xyz + disp[frame], g.get_rotation().expand(b, n, 4),
                                         g.get_scaling().expand(b, n, 3)),
                           gs_cameras_from_batch(cams, device="cuda"),
                           torch.as_tensor(cams["timestamps"], device="cuda"),
                           Renderer4DConfig(height=res, width=res, back_ground_color=(1, 1, 1)),
                           do_reconstruction=False)
    alpha = out.alpha.cpu().numpy() > 0.5
    gif = export_to_gif_mv(out.rgb.reshape(RECON_VIEWS, nf, res, res, 3).cpu().numpy(),
                           f"{tmp}/mesh_video.gif")
    del out
    split_gif.main(["--gif_path", gif, "--output_dir", f"{tmp}/mesh_frames"])
    t0 = time.perf_counter()
    tracking.main(["--frames_dir", f"{tmp}/mesh_frames", "--template_dir", templates,
                   "--output_dir", f"{tmp}/mesh_tracked"])
    torch.cuda.synchronize()
    t_track = time.perf_counter() - t0
    tracked = np.stack([np.asarray(Image.open(f"{tmp}/mesh_tracked/{k}.png"))[..., 3]
                        for k in range(b)]) > 127
    cover, spill = float(tracked[alpha].mean()), float(tracked[~alpha].mean())
    print(f"[mesh] {n} vertices; mesh2gaussian {t_m2g:.2f} s; static render (4 views at "
          f"{res}^2) {wall_s:.2f} s, launches {totals_s}; tracking (propagation, "
          f"{RECON_VIEWS} x {nf} frames at {res}^2) {t_track:.2f} s: tracked masks cover "
          f"{cover:.4f} of the object's rendered alpha, {spill:.4f} of the rest")

    extra = [f"system.connected_vertices_info_path={conn}"]
    rec = recon_phase(tmp, ply, f"{tmp}/mesh_tracked", res, res, PER_RECON_STEP, "mesh",
                      yaml=MESH_YAML, extra=extra)
    system = rec.pop("system")
    ok_mesh_arap = system.mesh_nn_idx is not None and system.cfg.sample_strategy == "light"
    timing = recon_timing_phase(system, f"{tmp}/mesh_tracked", PER_RECON_STEP, "mesh",
                                buckets=False, light=True)
    ref = recon_reference_phase(system, timing.pop("batch"), PER_RECON_STEP, "mesh")
    del system
    base = ["--config", MESH_YAML, *_recon_args(tmp, ply, f"{tmp}/mesh_tracked", res, res),
            *extra]
    exp, wall_e, totals_e, shape_e = _cli_launches(base[:2] + ["--export"] + base[2:])
    traj = os.path.join(exp["trial_dir"], "save", "gaussian_trajectory")
    del exp
    t0 = time.perf_counter()
    export_animated_mesh.main(["--base_obj", obj, "--trajectory_dir", traj,
                               "--output", f"{tmp}/mesh_anim.glb"])
    t_glb = time.perf_counter() - t0
    with open(f"{tmp}/mesh_anim.glb", "rb") as f:
        raw = f.read()
    json_len = int.from_bytes(raw[12:16], "little")
    gltf = json.loads(raw[20:20 + json_len])
    prim = gltf["meshes"][0]["primitives"][0]
    n_verts = gltf["accessors"][prim["attributes"]["POSITION"]]["count"]
    n_targets = len(prim["targets"])
    ok_glb = (int.from_bytes(raw[:4], "little") == 0x46546C67 and n_verts == n
              and n_targets == nf and totals_e == _per(composite_coarse_fwd=1, kplanes_fwd=1))
    wall = time.perf_counter() - t_all
    print(f"[mesh] --export {wall_e:.2f} s, launches {totals_e}; GLB {len(raw) / 2 ** 20:.2f} MiB "
          f"in {t_glb:.2f} s: {n_verts} vertices, {n_targets} morph targets; mesh-edge ARAP and "
          f"light sampling {ok_mesh_arap}; the chain's wall {wall:.2f} s; card {_smi()}")
    per_shape = collections.Counter(shape_s) + collections.Counter(rec["per_shape"]) + \
        collections.Counter(timing["per_shape"]) + collections.Counter(shape_e)
    ok = (ok_static and cover >= 0.95 and spill <= 0.01 and rec["ok"] and timing["ok"]
          and ref["ok"] and ok_glb and ok_mesh_arap)
    return dict(ok=ok, per_shape=dict(per_shape), wall_s=wall, step_s=timing["step_s"],
                light_s=timing["buckets"][0], avg_s=timing["avg_s"], track_s=t_track,
                cover=cover, ply=ply, recon_wall_s=rec["wall_s"], h_share=timing["h_share"],
                ref_rel=ref["rel"], ref_loss_rel=ref["loss_rel"])


def mesh_kernel_rows(ply: str) -> list:
    """Kernel H at the mesh flow's shapes that the recon rows do not cover,
    on the mesh asset, against its plain version: the static render (4
    renders at 256^2: 64 coarse tiles, forward) and a step of the last 50
    of 'light' sampling (all 15 unlocked frames: 60 renders, both ways).
    Its 'light' steps of 8 renders take bucket 2's shape."""
    from animate3d_tpu_torch.data.cameras import fixed_view_cameras
    from animate3d_tpu_torch.gaussians.ply import load_gaussians

    st = load_gaussians(ply, 90.0, 0.0, 1.0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    fields, orig = _raster_fields("coarse", fixed_view_cameras(
        height=RECON_RES, width=RECON_RES, total_frame=1), RECON_VIEWS, st=st)
    rows = _composite_rows("H", "mesh static render, 4 renders at 256^2", fields, orig, gen,
                           backward=False)
    n_ct = (RECON_FRAMES - 1) * RECON_VIEWS * 16
    fields, orig = _raster_fields("coarse", fixed_view_cameras(
        height=RECON_RES, width=RECON_RES, total_frame=RECON_FRAMES - 1),
        RECON_VIEWS * (RECON_FRAMES - 1), st=st)
    rows += _composite_rows("H", "mesh light step at all frames, 60 renders at 256^2",
                            fields[:n_ct].contiguous(), orig[:n_ct].contiguous(), gen)
    for r in rows:
        same = f"two launches bitwise equal {r['same']} " if "same" in r else ""
        print(f"[kernel] {r['name']:<20} {r['shape']:<64} max|d| {r['max_abs_err']:.3e} "
              f"{same}rel L2 {r['rel']:.3e} (tol {r['rel_tol']:.0e}) ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms none bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}; {r['pairs']} pairs, {r['live']} live) "
              f"{'ok' if r['ok'] else 'FAIL'}; card {_smi()}")
    return rows


CLIP_FRAMES = 48  # train.yaml's clips: total_frames 48, 16 sampled at a stride of 3


def _clip_workspace(tmp: str) -> str:
    """Phase 13's manifest: the phase-5 workspace's kind of item (4 views of
    seeded 256^2 frames, one caption) with 48 frames a view, as frame
    directories. The H100 machine has no libavcodec, libpng or libjpeg
    headers, so the native loader (``data/native_loader.py``) does not build
    there and the dataset reads PNG frames through its PIL fallback, as the
    JAX package's does without the library; mp4 items and the native decode
    are held by the CPU tests (``tests/test_torch_loader.py``)."""
    from PIL import Image

    rng = np.random.default_rng(3)
    d = os.path.join(tmp, "clips")
    views = []
    for v in range(4):
        os.makedirs(os.path.join(d, f"view{v}"))
        for fi in range(CLIP_FRAMES):
            Image.fromarray(rng.integers(0, 255, (256, 256, 3), dtype=np.uint8)).save(
                os.path.join(d, f"view{v}", f"{fi:02d}.png"))
        views.append(f"view{v}")
    with open(os.path.join(tmp, "manifest_clips.json"), "w") as fh:
        json.dump([{"videos": views, "caption": "a toy"}], fh)
    return d


def _train_rank(args_path: str, out_path: str) -> int:
    """Phase 13 (a) inside ``torch.distributed.run``: the trainer CLI with the
    launch counters zeroed just before and read just after."""
    from animate3d_tpu_torch.cli.train_mvvdm import main as train_main
    from animate3d_tpu_torch.ops import _build

    with open(args_path) as fh:
        args = json.load(fh)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = train_main(args)
    torch.cuda.synchronize()
    torch.save({"wall_s": time.perf_counter() - t0, "totals": _build.launch_totals(),
                "per_shape": dict(_build.LAUNCHES),
                "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                "step_seconds": res["step_seconds"],
                "losses": [m["loss"] for m in res["metrics"]], "dp": res["dp"],
                "backend": res["backend"], "sharded": res["optimizer"].sharded,
                "rank_env": {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}},
               out_path)
    return 0


def dist_phase(tmp: str, ply: str, frames: str) -> dict:
    """Phase 13: the paths of the JAX package's last modules.

    (a) the trainer on configs/training/train.yaml under
    ``python -m torch.distributed.run --nproc_per_node 1`` (NCCL at world
    size 1), overridden in the paths, 3 steps and ``zero_sharded_optimizer``
    (plus the phase-5 workspace's gradient checkpointing and log cadence),
    on 48-frame clips (:func:`_clip_workspace` says why frame directories);
    launches exactly PER_TRAIN_STEP a step; the dataset's read time for one
    item (4 views x 16 frames) and one read clip against its source frames;
    (b) one recon step of phase 7's config with ``--typecheck --gradio``:
    the contracts pass at full size, and the progress file, ``cmd.txt``,
    ``code_snapshot.zip`` and the TB event file exist and read back;
    (c) ``profile_trace`` around one sampling denoise step at full width:
    the chrome trace exists and holds the kernels' launches."""
    from animate3d_tpu_torch.cli.launch import main as launch_main
    from animate3d_tpu_torch.data import native_loader
    from animate3d_tpu_torch.data.video_dataset import MVideoConfig, MVideoDataset
    from animate3d_tpu_torch.models.diffusion import DDIMScheduler, SchedulerConfig
    from animate3d_tpu_torch.models.factory import build_models
    from animate3d_tpu_torch.ops import _build
    from animate3d_tpu_torch.pipelines.mv_sampler import MVSampler, MVSamplerConfig
    from animate3d_tpu_torch.utils.camera import get_camera
    from animate3d_tpu_torch.utils.logging import profile_trace
    from animate3d_tpu_torch.utils.tb_writer import read_events
    from PIL import Image

    t0 = time.perf_counter()
    vids = _clip_workspace(tmp)
    manifest = os.path.join(tmp, "manifest_clips.json")
    write_s = time.perf_counter() - t0
    native = native_loader.available()
    why = native_loader.build_error().strip().splitlines()
    ds = MVideoDataset(MVideoConfig(manifest_path=manifest, video_root=vids, sample_size=256,
                                    sample_n_frames=16, total_frames=CLIP_FRAMES), seed=0)
    ds[0]  # warm the file cache
    indices = ds._indices()
    t0 = time.perf_counter()
    item = ds._item(0, indices)
    decode_ms = (time.perf_counter() - t0) * 1e3
    src = np.stack([np.asarray(Image.open(os.path.join(vids, "view2", f"{i:02d}.png")),
                               np.float32) for i in indices]) / 127.5 - 1.0
    clip_err = float(np.abs(item["pixel_values"][2] - src).max())
    item_ok = (item["pixel_values"].shape == (4, 16, 256, 256, 3)
               and bool(np.isfinite(item["pixel_values"]).all()) and clip_err == 0.0)
    print(f"[dist] clip workspace: 4 views x {CLIP_FRAMES} PNG frames at 256^2 in "
          f"{write_s:.2f} s; native loader available {native}"
          + (f" (build: {why[0][:100]} ... {why[-1][:160]})" if why else "")
          + f"; one item (4 views x 16 frames at 256^2, frames {indices.tolist()}) read in "
          f"{decode_ms:.2f} ms by the {'native decoder' if native else 'PIL fallback'}; view "
          f"2's clip against its source frames max|d| {clip_err:.3e} (PNG: exact); card "
          f"{_smi()}")

    args = ["--config", TRAIN_YAML, f"output_dir={tmp}/out_dist",
            f"flax_params_dir={tmp}/no_root", f"pretrained_model_path={tmp}/no_tree",
            f"train_data.manifest_path={manifest}", f"train_data.video_root={vids}",
            f"max_train_steps={TRAIN_STEPS}", "zero_sharded_optimizer=true",
            "gradient_checkpointing=true", "log_every_n_steps=1"]
    args_path, out_path = os.path.join(tmp, "dist_args.json"), os.path.join(tmp, "dist_out.pt")
    with open(args_path, "w") as fh:
        json.dump(args, fh)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", os.path.abspath(__file__), "--train-rank", args_path, out_path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    launcher_wall = time.perf_counter() - t0
    for line in (proc.stdout + proc.stderr).splitlines()[-12:]:
        print(f"[dist-rank] {line}")
    if proc.returncode != 0:
        print(f"[dist] torch.distributed.run exited {proc.returncode}")
        return dict(ok=False, per_shape={})
    r = torch.load(out_path, weights_only=False)
    shutil.rmtree(f"{tmp}/out_dist")  # a full checkpoint
    expected = {k: n * TRAIN_STEPS for k, n in PER_TRAIN_STEP.items()}
    step_s = float(np.mean(r["step_seconds"][1:]))
    a_ok = (r["totals"] == expected and r["dp"] == 1 and r["backend"] == "nccl"
            and not r["sharded"] and len(r["losses"]) == TRAIN_STEPS
            and all(np.isfinite(r["losses"])) and item_ok)
    print(f"[dist] (a) train.yaml under torch.distributed.run --nproc_per_node 1 "
          f"({r['backend']}, world {r['dp']}, env {r['rank_env']}), 48-frame PNG clips, "
          f"zero_sharded_optimizer=true (sharded {r['sharded']}: a no-op at dp 1): launcher wall "
          f"{launcher_wall:.2f} s, CLI wall {r['wall_s']:.2f} s, step seconds "
          + ", ".join(f"{t:.4f}" for t in r["step_seconds"])
          + f"; peak memory {r['peak_gb']:.2f} GiB; losses "
          + ", ".join(f"{x:.5f}" for x in r["losses"]) + f"; card {_smi()}")
    print(f"[dist] (a) launches {r['totals']} (expected {expected}: {PER_TRAIN_STEP} per step)")

    # (b) one recon step with --typecheck --gradio
    rargs = ["--config", RECON_YAML, "--train", "--typecheck", "--gradio",
             *_recon_args(tmp, ply, frames, RECON_RES, RECON_EVAL), "name=typecheck",
             "trainer.max_steps=1"]
    t0 = time.perf_counter()
    res = launch_main(rargs)
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    from animate3d_tpu_torch.core.typecheck import disable_typecheck

    disable_typecheck()
    trial = res["trial_dir"]
    import zipfile

    with open(os.path.join(trial, "progress")) as fh:
        progress = fh.read()
    with open(os.path.join(trial, "cmd.txt")) as fh:
        cmd_txt = fh.read()
    with zipfile.ZipFile(os.path.join(trial, "code_snapshot.zip")) as z:
        n_src = len(z.namelist())
        has_cu = "animate3d_tpu_torch/csrc/flash_fwd.cu" in z.namelist()
    tb = [os.path.join(trial, "tb", n) for n in os.listdir(os.path.join(trial, "tb"))]
    events = read_events(tb[0]) if tb else []
    tags = sorted({t for _, t, _ in events})
    b_ok = (progress == "Rendering video ..." and "--typecheck --gradio" in cmd_txt
            and n_src > 50 and has_cu and "loss" in tags
            and np.isfinite([m["loss"] for m in res["metrics"]]).all())
    print(f"[dist] (b) recon CLI --typecheck --gradio, 1 step at {RECON_RES}^2 + four-view "
          f"test: wall {b_wall:.2f} s; contracts passed; progress {progress!r}; cmd.txt "
          f"{cmd_txt.strip()[:60]!r}...; code_snapshot.zip {n_src} files (.cu {has_cu}); TB "
          f"events {len(events)} ({','.join(tags)})")

    # (c) profile_trace around one sampling denoise step
    unet, *_ = build_models("full", 4, "cuda", seed=0, clip=False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    scfg = MVSamplerConfig(num_inference_steps=25, num_views=4, num_frames=16, height=256,
                           width=256, freeinit_enabled=False)
    sampler = MVSampler(unet, scfg, DDIMScheduler(SchedulerConfig(), device="cuda"))
    lat = torch.randn((4, 16, 32, 32, 4), generator=gen, device="cuda")
    ctx = 0.5 * torch.randn((8, 77, 768), generator=gen, device="cuda")
    img = torch.randn((8, 1024), generator=gen, device="cuda")
    cam = torch.as_tensor(get_camera(4), device="cuda")
    ts = sampler.active_timesteps()[:1]
    with torch.inference_mode():
        sampler.denoise(lat, lat[:, :1], ctx, cam, img, ts)  # warm-up
        _build.reset_launches()
        with profile_trace(os.path.join(tmp, "trace")) as prof:
            sampler.denoise(lat, lat[:, :1], ctx, cam, img, ts)
    c_totals = _build.launch_totals()
    with open(prof.trace_path) as fh:
        trace = json.load(fh)
    names = [e.get("name", "") for e in trace.get("traceEvents", [])]
    n_kernel = sum("flash_fwd" in n or "packed_attn" in n or "geglu" in n for n in names)
    c_ok = (os.path.getsize(prof.trace_path) > 0 and n_kernel > 0
            and all(c_totals[k] == n for k, n in PER_FORWARD.items()))
    print(f"[dist] (c) profile_trace around one denoise step (CFG pair, full width 256^2): "
          f"{os.path.basename(prof.trace_path)} {os.path.getsize(prof.trace_path) / 2 ** 20:.2f} "
          f"MiB, {len(names)} events, {n_kernel} of kernels A-C; denoise step "
          f"{sampler.step_seconds[-1]:.4f} s under the profiler; launches {c_totals}")
    del unet, sampler
    torch.cuda.empty_cache()
    ok = a_ok and b_ok and c_ok
    print(f"[dist] (a) {a_ok}, (b) {b_ok}, (c) {c_ok}")
    return dict(ok=ok, per_shape=r["per_shape"], step_s=step_s, peak_gb=r["peak_gb"],
                decode_ms=decode_ms, launcher_s=launcher_wall, b_wall_s=b_wall)


def _svd_flash_case(label, b, s, c, heads, gen):
    """Kernel A at 64-wide heads through ``video_attention`` against
    ``_flash_plain`` (:func:`_agree`'s tolerance)."""
    from animate3d_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    q, k, v = (torch.randn((b, s, c), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    d = c // heads
    scale = d ** -0.5
    route = lambda: A.video_attention(q, k, v, heads)
    out = route()
    ref = A._flash_plain(q, k, v, heads, scale, 1)[0]
    torch.cuda.synchronize()
    err, tol, rel, ok = _agree(out, ref)
    ms = _time_ms(route, 10)
    plain_ms = _time_ms(lambda: A._flash_plain(q, k, v, heads, scale, 1), 2)
    qh, kh, vh = (x.reshape(b, s, heads, d).transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, scale=scale), 10)
    nbytes = 2.0 * 4 * b * s * c + 4.0 * b * heads * s
    bound, by, term = _bound_ms(4.0 * b * heads * s * s * d, nbytes, ex2=1.0 * b * heads * s * s)
    return dict(name="flash_fwd", shape=label, keys=[("flash_fwd", (b, s, s, c, 1))],
                max_abs_err=err, tol=tol, rel=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by, term=term)


def _svd_packed_case(label, b, c, heads, gen, s: int = 25):
    """Kernel B on ``s``-frame sequences padded to 32 through
    ``video_attention`` against ``packed_padded_attention`` (its layout and
    numerics) and unpadded attention, both at :func:`_agree`'s tolerance;
    the padded keys left in the softmax (zero keys and values) must move
    the output by more than 5% relative L2, or the check could not see a
    missing mask."""
    from animate3d_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    q, k, v = (torch.randn((b, s, c), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    d = c // heads
    scale = d ** -0.5
    route = lambda: A.video_attention(q, k, v, heads)
    out = route()
    ref = A.packed_padded_attention(q, k, v, heads, scale)
    unpadded = A.packed_small_attention(q, k, v, heads, scale)
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 32 - s))
    unmasked = A._merge_heads(A.attention_xla(
        *(A._split_heads(x, heads) for x in (q, pad(k), pad(v))), scale))
    torch.cuda.synchronize()
    err, tol, rel, ok = _agree(out, ref)
    ok_unpadded = _agree(out, unpadded)[3]
    unmasked_rel = float((unmasked.float() - ref.float()).norm() / ref.float().norm())
    ok = ok and ok_unpadded and unmasked_rel > 0.05
    ms = _time_ms(route, 100)
    graph_ms = _graph_ms(route)
    plain_ms = _time_ms(lambda: A.packed_padded_attention(q, k, v, heads, scale), 5)
    qh, kh, vh = (x.reshape(b, s, heads, d).transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, scale=scale), 20)
    bound, by, term = _bound_ms(4.0 * b * heads * s * s * d, 2.0 * 4 * b * s * c)
    return dict(name="packed_attn", shape=label, keys=[("packed_attn", (b, s, c))],
                max_abs_err=err, tol=tol, rel=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=bound, bound_by=by, term=term, graph_ms=graph_ms,
                unpadded_ok=ok_unpadded, unmasked_rel=unmasked_rel)


def svd_phase() -> dict:
    """Phase 14: the SVD-XT shapes of kernels A, B and C against their plain
    versions, then one full-size SVD UNet call on the CFG batch through the
    kernels (exactly PER_SVD_FORWARD launches, each of B's padded) against
    the same call on the plain versions. Tolerance of the call: 5e-2
    relative L2, as :func:`reference_phase`'s (bf16 sums in another order
    over 16 transformers and 22 spatio-temporal ResNet blocks)."""
    from animate3d_tpu_torch.models.factory import build_svd_models
    from animate3d_tpu_torch.ops import _build, routing
    from animate3d_tpu_torch.pipelines.svd_sampler import SVDSampler, SVDSamplerConfig

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [
        _svd_flash_case("SVD L0 (50, 9216, 320) h5", 50, 9216, 320, 5, gen),
        _svd_flash_case("SVD L1 (50, 2304, 640) h10", 50, 2304, 640, 10, gen),
        _svd_flash_case("SVD L2 (50, 576, 1280) h20", 50, 576, 1280, 20, gen),
        _svd_flash_case("SVD L3 (50, 144, 1280) h20", 50, 144, 1280, 20, gen),
        _svd_packed_case("SVD L0 S25 (18432, 25, 320) h5", 18432, 320, 5, gen),
        _svd_packed_case("SVD L1 S25 (4608, 25, 640) h10", 4608, 640, 10, gen),
        _svd_packed_case("SVD L2 S25 (1152, 25, 1280) h20", 1152, 1280, 20, gen),
        _svd_packed_case("SVD L3 S25 (288, 25, 1280) h20", 288, 1280, 20, gen),
        _geglu_case("SVD L0 M=460800 C=320 I=1280", 460800, 320, 1280, gen),
        _geglu_case("SVD L1 M=115200 C=640 I=2560", 115200, 640, 2560, gen),
        _geglu_case("SVD L2 M=28800 C=1280 I=5120", 28800, 1280, 5120, gen),
        _geglu_case("SVD L3 M=7200 C=1280 I=5120", 7200, 1280, 5120, gen),
    ]
    print(f"[svd-kernel] card {_smi()}")
    for r in rows:
        extra = f" graph_ms {r['graph_ms']:.4f}" if "graph_ms" in r else ""
        if "unmasked_rel" in r:
            extra += (f" unpadded ok {r['unpadded_ok']} unmasked rel L2 "
                      f"{r['unmasked_rel']:.3e} (must exceed 5e-2)")
        print(f"[svd-kernel] {r['name']:<12} {r['shape']:<34} max|d| {r['max_abs_err']:.3e} "
              f"(tol {r['tol']:.3e}) rel L2 {r['rel']:.3e} (tol {REL_L2_TOL:.0e}){extra} "
              f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
              f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}: "
              f"{r['term']}) {'ok' if r['ok'] else 'FAIL'}")
    torch.cuda.empty_cache()

    unet, vae, vision = build_svd_models("full", "cuda", seed=0)
    sampler = SVDSampler(unet, vae, vision, SVDSamplerConfig())
    x = torch.randn((2, 25, 8, 72, 128), generator=gen, device="cuda")
    emb = torch.randn((2, 1, 1024), generator=gen, device="cuda")
    ids = sampler.added_time_ids(1)
    with torch.inference_mode():
        unet(x, 0.5, emb, ids)  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out_k = unet(x, 0.5, emb, ids).float()
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        kernel_counts = _build.launch_totals()
        per_shape = {k: n for k, n in _build.LAUNCHES.items() if k[0] in COUNTERS}
        padded = _build.LAUNCHES[SVD_PADDED]
        _build.reset_launches()
        with routing.plain_ops():
            out_p = unet(x, 0.5, emb, ids).float()
        torch.cuda.synchronize()
        plain_counts = _build.launch_totals()
    rel = float((out_k - out_p).norm() / out_p.norm())
    counts_ok = (kernel_counts == PER_SVD_FORWARD and padded == PER_SVD_FORWARD["packed_attn"]
                 and not any(plain_counts.values()))
    ok = (all(r["ok"] for r in rows) and rel <= 5e-2 and bool(torch.isfinite(out_k).all())
          and counts_ok)
    print(f"[svd] full-size SVD UNet call on the CFG batch (2 x 25 frames, 72x128), kernels "
          f"vs plain ops: relative L2 {rel:.3e} (tol 5e-2); {call_s:.4f} s through the "
          f"kernels; launches {kernel_counts} (expected {PER_SVD_FORWARD}), "
          f"{SVD_PADDED} {padded} (expected {PER_SVD_FORWARD['packed_attn']}), through the "
          f"plain ops {plain_counts}; card {_smi()}")
    del unet, vae, vision, sampler, out_k, out_p
    torch.cuda.empty_cache()
    return dict(ok=ok, rows=rows, per_shape=per_shape, rel=rel, call_s=call_s)

KPLANES_GRID = ((50, 50, 50, 8), (100, 100, 100, 16))  # motion_recon_frame_16.yaml
KPLANES_N = 20000  # the recon asset and the mesh's vertices
# every frame count a path deforms at once: the recon buckets 2 / 4 / 8 / 16,
# the mesh's 15 active frames, the 16 of the test passes, 1 for the static
# render, and whatever else a schedule unlocks
KPLANES_FRAMES = tuple(range(1, RECON_FRAMES + 1))


def _kplanes_inputs(grid, dim: int, n: int, f: int, seed: int):
    """Seeded planes (time planes about 1, space planes in [0.1, 0.5]),
    points in [-1.2, 1.2]^3 with corners at and beyond +-1, times from -1
    to 1 (one frame: 0.37) and a cotangent, on the card."""
    from animate3d_tpu_torch.gaussians.kplanes import COO_COMBS

    gen = torch.Generator(device="cuda").manual_seed(seed)
    grids = []
    for reso in grid:
        planes = []
        for c0, c1 in COO_COMBS:
            lo, hi = (0.5, 1.5) if c1 == 3 else (0.1, 0.5)
            u = torch.rand((dim, reso[c1], reso[c0]), generator=gen, device="cuda")
            planes.append((lo + (hi - lo) * u).requires_grad_())
        grids.append(planes)
    xyz = 2.4 * torch.rand((n, 3), generator=gen, device="cuda") - 1.2
    xyz[:4] = torch.tensor([[-1, -1, -1], [1, 1, 1], [1.0, -1.0, 1.2], [-1.5, 1.5, 0.0]])
    ts = (torch.linspace(-1, 1, f, device="cuda") if f > 1
          else torch.full((1,), 0.37, device="cuda"))
    cot = torch.randn((f, n, dim * len(grid)), generator=gen, device="cuda")
    return grids, xyz, ts, cot


def _kplanes_rows(label: str, grid, dim: int, n: int, f: int, seed: int) -> list:
    """Kernel I forward and backward against the plain gather at one shape:
    features relative L2 <= 1e-6 (the plain version's float operations in
    its order: 0 expected), the planes' gradients relative L2 <= 1e-5 each
    (f32 sums by atomics in another order); one launch each way. Times by
    CUDA events: the forward, and forward + backward less the forward; the
    plain gather the same way. Bound: the features written (and in the
    backward their gradient read) and the planes read once, at the HBM
    rate."""
    from animate3d_tpu_torch.gaussians.kplanes import sample_frames
    from animate3d_tpu_torch.ops import _build, routing

    grids, xyz, ts, cot = _kplanes_inputs(grid, dim, n, f, seed)
    planes = [p for scale in grids for p in scale]
    key = (f, n, len(grid))
    _build.reset_launches()
    out = sample_frames(xyz, ts, grids)
    g_k = torch.autograd.grad(out, planes, cot)
    torch.cuda.synchronize()
    counts = (_build.LAUNCHES["kplanes_fwd", key], _build.LAUNCHES["kplanes_bwd", key])
    with routing.plain_ops():
        ref = sample_frames(xyz, ts, grids)
        g_p = torch.autograd.grad(ref, planes, cot)
    fwd_rel = float((out - ref).norm() / ref.norm())
    fwd_err = float((out - ref).abs().max())
    bwd_rel = max(float((a - b).norm() / b.norm()) for a, b in zip(g_k, g_p))
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(g_k, g_p))

    def fwd():
        with torch.no_grad():
            sample_frames(xyz, ts, grids)

    def both():
        torch.autograd.grad(sample_frames(xyz, ts, grids), planes, cot)

    iters = 20
    ms_f, ms_b = _time_ms(fwd, iters), _time_ms(both, iters)
    with routing.plain_ops():
        pl_f, pl_b = _time_ms(fwd, 3), _time_ms(both, 3)
    feat_bytes = out.numel() * 4
    plane_bytes = sum(p.numel() for p in planes) * 4
    bound_f = (feat_bytes + plane_bytes) / PEAK_BYTES * 1e3
    bound_b = (feat_bytes + 2 * plane_bytes) / PEAK_BYTES * 1e3
    ok = (fwd_rel <= 1e-6 and bwd_rel <= 1e-5 and counts == (1, 1)
          and bool(torch.isfinite(out).all()))
    rows = [dict(name="kplanes_fwd", shape=label, keys=[("kplanes_fwd", key)],
                 max_abs_err=fwd_err, rel=fwd_rel, rel_tol=1e-6, ms=ms_f, plain_ms=pl_f,
                 bound_ms=bound_f, bound_by="bytes", library_ms=None, ok=ok),
            dict(name="kplanes_bwd", shape=label, keys=[("kplanes_bwd", key)],
                 max_abs_err=bwd_err, rel=bwd_rel, rel_tol=1e-5, ms=ms_b - ms_f,
                 plain_ms=pl_b - pl_f, bound_ms=bound_b, bound_by="bytes", library_ms=None,
                 ok=ok)]
    for r in rows:
        print(f"[kplanes] {r['name']:<12} {r['shape']:<44} max|d| {r['max_abs_err']:.3e} rel L2 "
              f"{r['rel']:.3e} (tol {r['rel_tol']:.0e}) ms {r['ms']:.4f} plain_ms "
              f"{r['plain_ms']:.4f} library_ms none bound_ms {r['bound_ms']:.4f} (bytes) "
              f"launches {counts} {'ok' if r['ok'] else 'FAIL'}")
    del grids, planes, out, ref, g_k, g_p
    torch.cuda.empty_cache()
    return rows


def kplanes_phase() -> dict:
    """Phase 15: kernel I (the K-planes sampler) against the plain gather at
    the paths' shapes (20,000 points, both scales, 16 channels, F 1 to 16:
    the main paths' launch keys must each be one of these rows'); then the
    recon field's ``deform_many`` forward and backward at 16 frames under
    torch.profiler (kernel I's kernels by name, no indexing kernel left),
    and the refusal of a gradient of the points and of time rows beyond a
    block's shared memory."""
    from torch.profiler import ProfilerActivity, profile

    from animate3d_tpu_torch.gaussians.deform import DeformationField, DeformConfig
    from animate3d_tpu_torch.gaussians.kplanes import sample_frames
    from animate3d_tpu_torch.gaussians.state import GaussianState

    smi = _smi()
    rows = []
    for f in KPLANES_FRAMES:
        rows += _kplanes_rows(f"recon F {f} x N {KPLANES_N}, 2 scales, C 16", KPLANES_GRID, 16,
                              KPLANES_N, f, seed=f)
    field = DeformationField(DeformConfig(grid_sizes=KPLANES_GRID, use_global_trans=True),
                             generator=torch.Generator().manual_seed(0)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    n = KPLANES_N
    q = torch.randn((n, 4), generator=gen, device="cuda")
    st = GaussianState(xyz=0.4 * torch.randn((n, 3), generator=gen, device="cuda"),
                       features_dc=torch.zeros((n, 1, 3), device="cuda"),
                       features_rest=torch.zeros((n, 0, 3), device="cuda"),
                       opacity=torch.zeros((n, 1), device="cuda"),
                       scaling=torch.full((n, 3), -4.0, device="cuda"),
                       rotation=q / q.norm(dim=-1, keepdim=True))
    ts = torch.linspace(-1, 1, 16, device="cuda")

    def deform():
        out = field.deform_many(st, ts, False)
        (out[0].sum() + out[1].sum()).backward()

    deform()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        deform()
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.self_device_time_total > 0}
    mine = {k: v for k, v in kernels.items() if "kplanes_" in k}
    indexing = {k: v for k, v in kernels.items()
                if "index_elementwise" in k or "indexing_backward" in k}

    def refuses(*args) -> bool:
        try:
            sample_frames(*args)
        except ValueError:
            return True
        return False

    refused = refuses(st.xyz.clone().requires_grad_(), ts, field.grids)
    big, _, _, _ = _kplanes_inputs(((300, 300, 300, 64),), 16, 4, 2, seed=99)
    refused_rows = refuses(st.xyz[:4], ts[:2], big)
    del big
    ok_trace = len(mine) >= 4 and not indexing and refused and refused_rows
    print(f"[kplanes-profile] deform_many forward + backward at 16 frames x {n} points: kernel "
          f"I's kernels (ms) " + "; ".join(f"{k[:60]} {v:.4f}" for k, v in sorted(mine.items()))
          + f"; indexing kernels {indexing or 'none'}; all kernels "
          + "; ".join(f"{k[:50]} {v:.4f}"
                      for k, v in sorted(kernels.items(), key=lambda kv: -kv[1]))
          + f"; a gradient of the points refused {refused}; time rows of 300^3 x 64 (1,152,000 "
          f"bytes) refused {refused_rows}; card {smi}")
    del field
    torch.cuda.empty_cache()
    return dict(ok=all(r["ok"] for r in rows) and ok_trace, rows=rows)



def _kernel_json(rows: list, launches) -> str:
    return json.dumps({"kernels": [
        dict(name=f"{r['name']} {r['shape']}", route="cuda", source=SOURCES[r["name"]][0],
             replaces=SOURCES[r["name"]][1],
             launches=sum(launches[key] for key in r["keys"]),
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"])
        for r in rows]})


def svd_main() -> int:
    """Phases 1 and 14 alone (``--svd``)."""
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False")
    env_phase()
    svd = svd_phase()
    checked = {key for r in svd["rows"] for key in r["keys"]}
    missing = set(svd["per_shape"]) - checked
    if missing:
        return _fail(f"svd-path kernel shapes not checked: {missing}")
    if not svd["ok"]:
        return _fail("the SVD shapes or the SVD UNet call failed their checks")
    print(_kernel_json(svd["rows"], collections.Counter(svd["per_shape"])))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def kplanes_main() -> int:
    """Phases 1 and 15 alone (``--kplanes``)."""
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False")
    env_phase()
    kp = kplanes_phase()
    if not kp["ok"]:
        return _fail("kernel I disagrees with the plain gather or left an indexing kernel")
    launches = collections.Counter({key: 1 for r in kp["rows"] for key in r["keys"]})
    print(_kernel_json(kp["rows"], launches))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


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
    kp = kplanes_phase()
    if not kp["ok"]:
        return _fail("kernel I disagrees with the plain gather or left an indexing kernel")
    rows += c_rows + kp["rows"]
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
    ref = reference_phase()
    if not ref["ok"]:
        return _fail("kernels disagree with plain ops end to end")
    with tempfile.TemporaryDirectory() as tmp:
        train = train_phase(tmp)
    if not train["ok"]:
        return _fail("the full-width train run failed its checks")
    if unchecked("train", train):
        return 1
    train_ref = train_reference_phase()
    if not train_ref["ok"]:
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
        root = _write_artifact_root(tmp)
        ply_c, frames_c = _recon_workspace(tmp, colour_seed=4)
        refine = refine_phase(tmp, ply_c, frames_c, recon["trial"], root)
        if not refine["ok"]:
            return _fail("the refine CLI run failed its checks")
        system = refine.pop("system")
        r_timing = refine_timing_phase(system, refine["args"])
        if not r_timing["ok"]:
            return _fail("the timed refine steps failed their checks")
        r_ref = refine_reference_phase(system, r_timing.pop("batch"), r_timing.pop("gb"))
        if not r_ref["ok"]:
            return _fail("the refine step through the kernels disagrees with plain ops")
        del system
        torch.cuda.empty_cache()
        if unchecked("refine", refine) or unchecked("refine-timing", r_timing):
            return 1
        e2e_clip = e2e_phase(tmp, tag="e2e-clip", root=root)
        if not e2e_clip["ok"]:
            return _fail("the sampling run with both CLIP towers failed its checks")
        if unchecked("sampling-clip", e2e_clip):
            return 1
        pretrained = _write_pretrained_tree(root)
        tw = train_weights_phase(tmp, root, pretrained)
        if not tw["ok"]:
            return _fail("the trainer with weights failed its checks")
        if unchecked("train-weights", tw):
            return 1
        vw = validate_weights_phase(tmp, root)
        if not vw["ok"]:
            return _fail("validate_weights on the artifact root failed its checks")
        shutil.rmtree(root)
        mesh = mesh_phase(tmp)
        m_rows = mesh_kernel_rows(mesh["ply"])
        if not mesh["ok"] or not all(r["ok"] for r in m_rows):
            return _fail("the mesh-animation flow failed its checks")
        rows += m_rows
        checked |= {key for r in m_rows for key in r["keys"]}
        if unchecked("mesh", mesh):
            return 1
        dist = dist_phase(tmp, ply, frames)
        if not dist["ok"]:
            return _fail("phase 13 (the trainer under torch.distributed.run, --typecheck "
                         "--gradio, profile_trace) failed its checks")
        if unchecked("dist-train", dist):
            return 1
    svd = svd_phase()
    rows += svd["rows"]
    checked |= {key for r in svd["rows"] for key in r["keys"]}
    if not svd["ok"]:
        return _fail("the SVD shapes or the SVD UNet call failed their checks")
    if unchecked("svd", svd):
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
    print(f"[summary] kernel C (GEGLU) in one full-width UNet forward at 256^2: "
          f"{ref['c_share']}; in one train loss + backward: {train_ref['c_share']}; kernel H "
          f"in one full-schedule recon step: {timing['h_share']}, its backward "
          f"{timing['h_bwd_share']}; card {env['smi']}")
    print(f"[summary] kernel B (packed attention) in one full-width UNet forward at 256^2: "
          f"{ref['b_share']}; in one train loss + backward: {train_ref['b_share']}; kernel H "
          f"forward in one full-schedule recon step: {timing['h_fwd_share']}, in the testset "
          f"render: {ev['h_fwd_share']}; card {env['smi']}")
    print(f"[summary] kernel E (packed attention backward) in one train loss + backward: "
          f"{train_ref['e_share']}; kernel G in one {FIELDS_RES}^2 recon step: "
          f"{f_timing['g_share']}, its backward {f_timing['g_bwd_share']}; card {env['smi']}")
    print(f"[summary] seconds per refine step (refine_frame_16.yaml: 8 recon renders at "
          f"1024^2 with gradients, 64 SDS renders at 256^2, guidance UNet and VAE at full "
          f"width, both CLIP towers at full width): {r_timing['step_s']:.4f}; peak memory "
          f"{r_timing['peak_gb']:.2f} GiB; the refine CLI ({REFINE_STEPS} steps + testset at "
          f"512^2) {refine['wall_s']:.2f} s; sampling with both towers in the loop: denoise "
          f"step {e2e_clip['step_s']:.4f} s, conditioning + sampling + decode "
          f"{e2e_clip['run_s']:.2f} s (2 steps), CLI wall {e2e_clip['wall_s']:.2f} s; card "
          f"{env['smi']}")
    print("[summary] shares of one refine step: " + "; ".join(
        f"{k} {v}" for k, v in r_timing["shares"].items()) + f"; card {env['smi']}")
    print(f"[summary] seconds per train step with weights (train.yaml, artifact root + "
          f"pretrained_model_path, captions and image embeds through the towers): "
          f"cast_frozen_bf16 true {tw['bf16']['step_s']:.4f} (peak {tw['bf16']['peak_gb']:.2f} "
          f"GiB), false {tw['f32']['step_s']:.4f} (peak {tw['f32']['peak_gb']:.2f} GiB); "
          f"kernels vs plain at the loaded weights: loss {tw['ref']['loss_rel']:.3e}, gradient "
          f"{tw['ref']['rel']:.3e}; validate_weights --smoke {vw['wall_s']:.2f} s; card "
          f"{env['smi']}")
    print(f"[summary] mesh flow (20,000-vertex mesh, mesh_animation_frame_16.yaml): seconds "
          f"per mesh recon step: light (8 renders) {mesh['light_s']:.4f}, all frames (60 "
          f"renders) {mesh['step_s']:.4f}, schedule average {mesh['avg_s']:.4f}; kernel H in "
          f"the 60-render step {mesh['h_share']}; kernels vs plain: loss {mesh['ref_loss_rel']:.3e}, "
          f"gradient {mesh['ref_rel']:.3e}; "
          f"tracking {mesh['track_s']:.2f} s (coverage {mesh['cover']:.4f}); recon CLI "
          f"({RECON_STEPS} steps + four-view test) {mesh['recon_wall_s']:.2f} s; the chain's "
          f"wall {mesh['wall_s']:.2f} s; card {env['smi']}")
    print(f"[summary] phase 13: seconds per train step under torch.distributed.run (NCCL, "
          f"world 1, train.yaml on 48-frame clips, zero_sharded_optimizer): "
          f"{dist['step_s']:.4f}; peak memory {dist['peak_gb']:.2f} GiB; one item's read (4 "
          f"views x 16 frames at 256^2) {dist['decode_ms']:.2f} ms; card {env['smi']}")
    print(f"[summary] SVD-XT UNet call on the CFG batch (2 x 25 frames at 576x1024): "
          f"{svd['call_s']:.4f} s; kernels vs plain ops {svd['rel']:.3e}; card {env['smi']}")
    launches = sum((collections.Counter(r["per_shape"]) for r in runs.values()),
                   collections.Counter())
    print(_kernel_json(rows, launches))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-rank"]:
        sys.exit(_train_rank(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--svd"]:
        sys.exit(svd_main())
    if sys.argv[1:2] == ["--kplanes"]:
        sys.exit(kplanes_main())
    sys.exit(main())
