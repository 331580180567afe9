"""Driver of the ``refine`` traffic: stage-2 4D-SDS refine steps,
``Animate3DSystem.step`` with the MV-VDM guidance, driven as
``cli/launch.py::run_train`` drives them (a fresh SDS batch of random
cameras a step through ``_guidance_batch``, the metrics read every
``log_every`` steps), one job in flight.

The recon renders are at the traffic's ``size``; the guidance (UNet in
bf16 under ``attention_backend("flash")``, the VAE with bf16-rounded
weights computing in float32, the text and vision towers) is the traffic's
``guidance_config``, built and weighted from the seed as the sampling cell
builds it. The asset, the video (rendered by the reference at the recon
size) and the starting field (a seeded perturbation of a recon field) are
``drivers/recon.py``'s. Every step's draws (the renderer's, ARAP's, the
SDS timestep, posterior and noise draws, and the random cameras) come from
the seed. The check is recon's training check over the three first steps,
the reference's step carrying the SDS term (``reference/gs/sds.py``)."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import harness
from benchmark.drivers import recon, sample
from benchmark.harness import span
from benchmark.reference import precision
from benchmark.reference.gs import cameras as ref_cameras
from benchmark.reference.gs import sds as ref_sds
from benchmark.reference.sd import pipeline as ref_sd

CHECKED = recon.CHECKED


def stage_config(cfg: dict, traffic: dict) -> dict:
    """The recon configuration with the refine stage's settings of the
    traffic (render size, loss weights)."""
    out = dict(cfg, size=traffic["size"])
    out["loss"] = dict(cfg["loss"], **traffic["loss"])
    return out


def guidance_config(traffic: dict) -> dict:
    """The guidance's MV-VDM configuration: the file the traffic names,
    relative to the benchmark's folder."""
    return json.loads((harness.BENCH_DIR / traffic["guidance_config"]).read_text())


def _draws(cfg: dict, traffic: dict, mv: dict, seed: int, k: int, idx: int, device):
    """(recon draws, SDS draws, raw random cameras) of the k-th step."""
    base = recon.draws_for(cfg, seed, k, recon.n_items(cfg, idx), device)
    g, rc = traffic["guidance"], traffic["random_camera"]
    gen = torch.Generator(device=device).manual_seed(harness.seed_for(seed, "sds", k))
    videos = rc["batch_size"] // (rc["n_view"] * rc["total_frame"])
    mn, mx = int(1000 * g["min_step_percent"]), int(1000 * g["max_step_percent"])
    lat = g["image_size"] // 2 ** (len(mv["vae"]["block_out_channels"]) - 1)
    t = torch.randint(mn, mx + 1, (videos,), generator=gen, device=device, dtype=torch.int32)
    post = torch.randn((rc["batch_size"], lat, lat, 4), generator=gen, device=device)
    noise = torch.randn((videos * rc["n_view"], rc["total_frame"] - 1, lat, lat, 4),
                        generator=gen, device=device)
    raw = ref_cameras.random_cameras(rc, np.random.default_rng(
        harness.seed_for(seed, "cams", k) % (1 << 63)), idx)
    return base, ref_sds.SDSDraws(t, post, noise), raw


@dataclass
class State(recon.State):
    mv: dict = field(default_factory=dict)
    prompt: str = ""


def _guidance(mv: dict, traffic: dict, seed: int, prompt: str, tok_dir: str, device):
    """The port's guidance as ``build_guidance_from_config`` builds it, on
    the benchmark's weights."""
    from animate3d_tpu_torch.models.clip import encode_ip_adapter_images
    from animate3d_tpu_torch.models.factory import encode_text
    from animate3d_tpu_torch.ops.attention import attention_backend
    from animate3d_tpu_torch.pipelines.guidance import AnimateMVGuidance, GuidanceConfig

    mods = sample._program_modules(mv, device)
    sample.load_weights(mods, mv, seed, device, vae_dtype=torch.bfloat16)
    unet, vae, vision = mods["unet"], mods["vae"], mods["vision"]
    g, rc = traffic["guidance"], traffic["random_camera"]

    def unet_apply(lat, t, ctx, cam, ie, i2v_cond_time_zero=False):
        with torch.no_grad(), attention_backend("flash"), span("guidance.unet"):
            return unet(lat, t, ctx, cam, ie, i2v_cond_time_zero=i2v_cond_time_zero)

    def vae_encode(x):
        with span("vae.encode"):
            return vae.encode(x)

    def image_encode(imgs):
        with span("clip.encode"):
            return encode_ip_adapter_images(vision, imgs)

    gcfg = GuidanceConfig(guidance_scale=g["guidance_scale"], n_view=rc["n_view"],
                          n_frame=rc["total_frame"], image_size=g["image_size"],
                          recon_std_rescale=g["recon_std_rescale"],
                          vae_encode_chunk=g["vae_encode_chunk"],
                          min_step_percent=g["min_step_percent"],
                          max_step_percent=g["max_step_percent"],
                          i2v_cond_time_zero=g["i2v_cond_time_zero"])
    guidance = AnimateMVGuidance(unet_apply, vae_encode, gcfg, image_encode=image_encode,
                                 device=device)
    cond, uncond = encode_text(prompt, "", rc["n_view"], mods["text"], tok_dir)
    inputs = {"text_cond": cond, "text_uncond": uncond,
              "image_embeds": torch.zeros((rc["n_view"], mv["unet"]["image_embed_dim"]),
                                          device=device),
              "vae_decode": vae.decode}
    return guidance, inputs


def run_step(state: State) -> dict:
    from animate3d_tpu_torch.cli.launch import _guidance_batch
    from animate3d_tpu_torch.pipelines.guidance import GuidanceDraws
    from animate3d_tpu_torch.rendering.renderer4d import RenderDraws
    from animate3d_tpu_torch.systems.animate3d import StepDraws

    cycle = state.traffic["cycle"]
    idx = cycle[state.k % len(cycle)]
    d, sd_draws, raw = _draws(state.cfg, state.traffic, state.mv, state.ctx.seed, state.k,
                              idx, state.ctx.device)
    state.system.global_step = idx
    with span("system.step"):
        gb = _guidance_batch(state.system, raw)
        metrics = state.system.step(state.batch, draws=StepDraws(
            render=RenderDraws(d.st_mask, d.bg_uniform), arap_idx=d.arap_idx,
            guidance=GuidanceDraws(*sd_draws)), guidance_batch=gb)
    state.k += 1
    state.pending.append(metrics)
    if len(state.pending) >= state.traffic["log_every"]:
        recon.flush(state)
    return metrics


def setup(ctx: harness.Ctx) -> State:
    from animate3d_tpu_torch.core.device import resolve_device
    from animate3d_tpu_torch.utils.tokenizer import write_char_level_tokenizer

    traffic = ctx.spec.traffic
    cfg = stage_config(ctx.spec.config, traffic)
    mv = guidance_config(traffic)
    dev = resolve_device(ctx.device)
    asset = recon.make_asset(cfg, ctx.seed, dev)
    shapes = {k: v.shape for k, v in recon.ref_system.DeformationField(
        recon.ref_system.deform_config(cfg)).state_dict().items()}
    video = recon.make_video(cfg, ctx.seed, asset, shapes, dev)
    tok_dir = os.path.join(ctx.tmp, "tokenizer")
    write_char_level_tokenizer(tok_dir)
    prompt = traffic["prompt"]
    guidance, inputs = _guidance(mv, traffic, ctx.seed, prompt, tok_dir, dev)
    system = recon._program_system(cfg, asset, dev, guidance=guidance, guidance_inputs=inputs)
    start = recon.field_weights(shapes, ctx.seed, "start", cfg["start_out_scale"], dev)
    system.field.load_state_dict(start)
    state = State(ctx=ctx, cfg=cfg, traffic=traffic, system=system,
                  batch=recon._program_batch(cfg, video, dev), video=video, mv=mv,
                  prompt=prompt)
    recon.first_steps(state, run_step, max(CHECKED, len(traffic["cycle"])),
                      lambda: system.opt.mu, lambda: dict(system.field.named_parameters()))
    return state


def window(state: State, win) -> None:
    while True:
        run_step(state)
        win.tick()


def trace_counts(state: State, win) -> Dict[str, float]:
    fl = sample.request_flops(state.mv, {})
    rc = state.traffic["random_camera"]
    frames = rc["batch_size"] // rc["n_view"]
    per_image = fl["vae_encode"] / state.mv["sampling"]["num_views"]
    sds = (fl["unet_step"] + 3.0 * per_image * rc["batch_size"] + fl["vision"]
           + 3.0 * rc["batch_size"] * state.cfg["n_gaussians"] * 250)
    cycle = state.traffic["cycle"]
    first = state.k - win.units
    flops = sum(recon.step_flops(state.cfg, cycle[k % len(cycle)]) + sds
                for k in range(first, state.k))
    return {"flops": flops, "frames": float(frames)}


# -- the check ---------------------------------------------------------------------

def follow(state: State, mode: str = "f32", fault: Optional[str] = None):
    cfg, dev, seed = state.cfg, state.ctx.device, state.ctx.seed
    mv, traffic = state.mv, state.traffic
    recon.release(dev)
    mods = ref_sd.build(mv, dev)
    sample.load_weights(mods, mv, seed, dev, upcast=True, vae_dtype=torch.bfloat16)
    asset = recon.make_asset(cfg, seed, dev)
    rec = recon._reference(cfg, asset, {k: v.clone() for k, v in state.start.items()},
                           state.video, dev)
    rec.fault = fault
    rc = traffic["random_camera"]
    cycle = traffic["cycle"]
    losses, first = [], None
    with precision.mode(mode):
        rec.sds = ref_sds.SDS(mods, mv, traffic["guidance"], state.prompt, rc["n_view"],
                              rc["total_frame"])
        rec.sds.fault = fault
        for k in range(CHECKED):
            idx = cycle[k % len(cycle)]
            d, sd_draws, raw = _draws(cfg, traffic, mv, seed, k, idx, dev)
            gb = {"cameras": ref_sds.cameras_of(raw, dev),
                  "timestamps": torch.as_tensor(raw["timestamps"], device=dev),
                  "c2w": torch.as_tensor(raw["c2w"], device=dev)}
            loss, grads = rec.step(idx, d._replace(guidance=gb, sds=sd_draws))
            losses.append(float(loss))
            if k == 0:
                first = grads
    return losses, first, {k: p.detach().clone() for k, p in rec.params.items()}


def check(state: State) -> Dict[str, dict]:
    return recon.check(state, follow)


def calibrate(ctx: harness.Ctx, control: bool) -> Dict[str, Dict[str, float]]:
    """As ``recon.calibrate``, the control being the reference one step
    below the configuration's precisions (float8 UNet, TF32 elsewhere)."""
    return recon.readings(setup(ctx), control, follow, "fp8")
