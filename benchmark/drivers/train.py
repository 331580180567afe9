"""Driver of the ``train`` traffic: MV-VDM fine-tuning steps, one job in
flight, each the per-step body of ``animate3d_tpu_torch/cli/train_mvvdm.py``
(the next batch from ``MVideoDataset`` through its ``Prefetcher``, the
VAE posterior sample of the clip, captions through the text tower, frame 0
through the vision tower) and ``pipelines/train_mvvdm.py::train_step``.

The training data are PNG clips (``videos`` items, each ``n_views`` views of
``clip_frames`` frames at the sample size, a caption drawn from the
traffic's list) written from the seed in set-up under the run's scratch
directory; the card's machine reads them through PIL, as the port does
there. The UNet's weights are made from the seed in float32; the port keeps
the trainable leaves (motion modules, I2V and spatial adapters, blenders)
as float32 masters and rounds the frozen ones to bf16
(``cast_frozen_bf16``). The check is a training check over the first three
steps, as the recon cell's: each step's loss, each leaf's first gradient
(clipped, read back from AdamW's first moment) and each leaf's change."""

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
from benchmark.reference.sd import pipeline as ref
from benchmark.reference.sd import train as ref_train

CHECKED = recon.CHECKED


def write_clips(traffic: dict, config: dict, seed: int, root: str) -> str:
    """PNG clips from the seed (smooth colour fields drifting over the
    frames) and their manifest; returns the manifest's path."""
    from PIL import Image

    s = config["sampling"]
    size, nv, nf = s["size"], s["num_views"], traffic["clip_frames"]
    rng = np.random.default_rng(harness.seed_for(seed, "clips") % (1 << 63))
    items = []
    coarse = traffic["image_coarse"]
    for v in range(traffic["videos"]):
        views = []
        for w in range(nv):
            base = rng.random((coarse + nf // 4 + 2, coarse + 2, 3)).astype(np.float32)
            rel = f"video{v}/view{w}"
            os.makedirs(os.path.join(root, rel), exist_ok=True)
            for i in range(nf):
                # a window of the field that slides a quarter cell a frame
                y0 = i / 4.0
                grid = torch.as_tensor(base).permute(2, 0, 1)[None]
                ys = torch.linspace(y0, y0 + coarse, size)
                xs = torch.linspace(0, coarse, size)
                gy = 2 * ys / (grid.shape[2] - 1) - 1
                gx = 2 * xs / (grid.shape[3] - 1) - 1
                g = torch.stack(torch.meshgrid(gx, gy, indexing="xy"), -1)[None]
                img = torch.nn.functional.grid_sample(grid, g, align_corners=True)[0]
                a = (img.permute(1, 2, 0).numpy() * 255).round().clip(0, 255).astype(np.uint8)
                Image.fromarray(a).save(os.path.join(root, rel, f"{i}.png"))
            views.append(rel)
        items.append({"videos": views,
                      "caption": traffic["captions"][int(rng.integers(len(traffic["captions"])))]})
    path = os.path.join(root, "manifest.json")
    with open(path, "w") as f:
        json.dump(items, f)
    return path


def _program(config: dict, traffic: dict, seed: int, device):
    """The port's UNet in train mode (trainable leaves float32, frozen ones
    bf16), VAE and towers, on the benchmark's float32 weights."""
    from animate3d_tpu_torch.pipelines.train_mvvdm import cast_frozen_bf16, trainable_mask

    mods = sample._program_modules(config, device)
    mods["unet"].float()
    sample.load_weights(mods, dict(config, unet_dtype="float32"), seed, device)
    unet = mods["unet"]
    unet.train()
    mask = trainable_mask(unet)
    for name, p in unet.named_parameters():
        p.requires_grad_(mask[name])
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    masters = cast_frozen_bf16(unet, dtype, cast_frozen=traffic["cast_frozen_bf16"])
    return mods, masters


@dataclass
class State(recon.State):
    mods: dict = field(default_factory=dict)
    opt: object = None
    tcfg: object = None
    sched: object = None
    gen: object = None
    it: object = None
    prefetch: object = None
    text_pair: object = None
    masters: dict = field(default_factory=dict)
    manifest: str = ""


def setup(ctx: harness.Ctx) -> State:
    from animate3d_tpu_torch.core.device import resolve_device
    from animate3d_tpu_torch.data.video_dataset import MVideoConfig, MVideoDataset, Prefetcher
    from animate3d_tpu_torch.models.diffusion import DDIMScheduler, SchedulerConfig
    from animate3d_tpu_torch.pipelines.train_mvvdm import MVVDMTrainConfig, make_optimizer
    from animate3d_tpu_torch.utils.tokenizer import (ClipTokenizer, find_tokenizer_files,
                                                     write_char_level_tokenizer)

    config, traffic = ctx.spec.config, ctx.spec.traffic
    dev = resolve_device(ctx.device)
    s, tr = config["sampling"], traffic["train"]
    manifest = write_clips(traffic, config, ctx.seed, os.path.join(ctx.tmp, "clips"))
    mods, masters = _program(config, traffic, ctx.seed, dev)
    tcfg = MVVDMTrainConfig(learning_rate=tr["learning_rate"], weight_decay=tr["weight_decay"],
                            adam_b1=tr["adam_b1"], adam_b2=tr["adam_b2"],
                            adam_eps=tr["adam_eps"], max_grad_norm=tr["max_grad_norm"],
                            cfg_dropout_prob=tr["cfg_dropout_prob"], num_views=s["num_views"],
                            i2v_cond_time_zero=s["i2v_cond_time_zero"])
    opt = make_optimizer(masters, tcfg)
    dataset = MVideoDataset(MVideoConfig(
        manifest_path=manifest, video_root=os.path.dirname(manifest), sample_size=s["size"],
        sample_n_frames=s["num_frames"], num_views=s["num_views"],
        total_frames=traffic["clip_frames"], elevation=s["camera_elevation"]),
        seed=harness.seed_for(ctx.seed, "dataset") % (1 << 63))
    prefetch = Prefetcher(dataset.iterate(batch_size=traffic["batch_size"]),
                          depth=traffic["prefetch_depth"])
    tok_dir = os.path.join(ctx.tmp, "tokenizer")
    write_char_level_tokenizer(tok_dir)
    tokenizer = ClipTokenizer(*find_tokenizer_files(tok_dir), max_length=77)
    cache = {}

    @torch.no_grad()
    def encode_captions(texts):
        missing = sorted({t for t in texts if t not in cache})
        if missing:
            ids = torch.as_tensor(tokenizer(missing), dtype=torch.long, device=dev)
            cache.update(zip(missing, mods["text"](ids).float()))
        return torch.stack([cache[t] for t in texts])

    null_row = encode_captions([""])[0]

    def text_pair(captions, n: int):
        c = encode_captions(list(captions)).repeat_interleave(n, dim=0)
        return c, null_row.expand(c.shape).clone()

    state = State(ctx=ctx, cfg=config, traffic=traffic, system=None, batch=None, video=(),
                  mods=mods, opt=opt, tcfg=tcfg,
                  sched=DDIMScheduler(SchedulerConfig(), device=dev),
                  gen=torch.Generator(device=dev).manual_seed(harness.seed_for(ctx.seed, "gen")),
                  it=prefetch, prefetch=prefetch, text_pair=text_pair, masters=masters,
                  manifest=manifest)
    adam = opt.adamw.state
    # the first moment of each master (zero where AdamW never stepped)
    moments = lambda: {k: adam.get(p, {}).get("exp_avg", torch.zeros_like(p))
                       for k, p in zip(masters, opt._params)}
    recon.first_steps(state, run_step, max(CHECKED, traffic["warm_steps"]), moments,
                      lambda: masters)
    return state


def run_step(state: State) -> dict:
    """One step of ``cli/train_mvvdm.py``'s loop."""
    from animate3d_tpu_torch.models.clip import encode_ip_adapter_images
    from animate3d_tpu_torch.pipelines.train_mvvdm import TrainBatch, train_step

    mods, dev = state.mods, state.ctx.device
    s = state.cfg["sampling"]
    size = s["size"]
    lat = size // 2 ** (len(state.cfg["vae"]["block_out_channels"]) - 1)
    c = state.cfg["vae"]["latent_channels"]
    with span("loader.next"):
        raw = next(state.it)
    b, n, f = raw["pixel_values"].shape[:3]
    pixels = torch.as_tensor(raw["pixel_values"], device=dev)
    imgs = pixels.reshape(b * n * f, size, size, 3)
    with span("vae.encode"), torch.no_grad():
        m, chunk = imgs.shape[0], 16
        eps = torch.cat([torch.randn((min(chunk, m - i), lat, lat, c), generator=state.gen,
                                     device=dev) for i in range(0, m, chunk)])
        mean, logvar = (torch.cat(p) for p in zip(*(mods["vae"].encode(imgs[i:i + chunk])
                                                     for i in range(0, m, chunk))))
        latents = ((mean + torch.exp(0.5 * logvar) * eps)
                   * state.cfg["vae"]["scaling_factor"]).reshape(b * n, f, lat, lat, c)
    with span("clip.encode"), torch.no_grad():
        text_ctx, null_ctx = state.text_pair(raw["text"], n)
        image_embeds = encode_ip_adapter_images(
            mods["vision"], (pixels[:, :, 0].reshape(b * n, size, size, 3) + 1.0) / 2.0).float()
    batch = TrainBatch(latents=latents, text_ctx=text_ctx, null_text_ctx=null_ctx,
                       camera=torch.as_tensor(raw["cameras"].reshape(b * n, 16), device=dev),
                       image_embeds=image_embeds)
    with span("train_step"):
        metrics = train_step(mods["unet"], state.opt, batch, state.tcfg, state.sched, state.gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    metrics = {k: float(v) for k, v in metrics.items()}
    state.k += 1
    return {k: torch.tensor(v) for k, v in metrics.items()}


def window(state: State, win) -> None:
    while True:
        run_step(state)
        win.tick()


def trace_counts(state: State, win) -> Dict[str, float]:
    """The forward's products and convolutions counted on the reference
    UNet over meta tensors at the training batch, taken three times (input
    and weight gradients), plus the posterior encode of the clip and the
    towers; recompute not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = state.cfg
    s, u = cfg["sampling"], cfg["unet"]
    n, f, size = s["num_views"], s["num_frames"], s["size"]
    lat = size // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    meta = dict(device="meta")
    mods = ref.build(cfg, "meta")
    with FlopCounterMode(display=False) as fc:
        mods["unet"](torch.zeros((n, f, lat, lat, 4), **meta), torch.zeros((n,), **meta),
                     torch.zeros((n, 77, u["cross_attention_dim"]), **meta),
                     torch.zeros((n, 16), **meta), torch.zeros((n, u["image_embed_dim"]), **meta))
    fwd = float(fc.get_total_flops())
    fl = sample.request_flops(cfg, {})
    per_step = 3.0 * fwd + fl["vae_encode"] / n * n * f + fl["vision"]
    return {"flops": per_step * win.units, "heads": float(u["num_heads"])}


# -- the check ------------------------------------------------------------------------

def follow(state: State, mode: str = "f32", fault: Optional[str] = None):
    cfg, traffic, dev, seed = state.cfg, state.traffic, state.ctx.device, state.ctx.seed
    s = cfg["sampling"]
    recon.release(dev)
    mods = ref.build(dict(cfg, unet=dict(cfg["unet"], gradient_checkpointing=True)), dev)
    sample.load_weights(mods, dict(cfg, unet_dtype="float32"), seed, dev, upcast=True)
    markers = traffic["train"]["trainable_markers"]
    if traffic["cast_frozen_bf16"]:
        with torch.no_grad():
            for name, p in mods["unet"].named_parameters():
                if not ref_train.is_trainable(name, markers):
                    p.copy_(p.to(torch.bfloat16).float())
    trainer = ref_train.Trainer(mods, cfg, markers, traffic["train"])
    trainer.fault = fault
    with open(state.manifest) as fh:
        items = json.load(fh)
    data = ref_train.batches(items, harness.seed_for(seed, "dataset") % (1 << 63),
                             traffic["clip_frames"], s["num_frames"])
    gen = torch.Generator(device=dev).manual_seed(harness.seed_for(seed, "gen"))
    root = os.path.dirname(state.manifest)
    losses, first = [], None
    with precision.mode(mode):
        for k in range(CHECKED):
            item, idx = next(data)
            pixels = torch.as_tensor(ref_train.read_clip(root, item, idx, s["num_views"]),
                                     device=dev)[None]
            cams = ref.cameras(s["num_views"], s["camera_elevation"], dev)[None]
            loss, grads = trainer.step(pixels, [item["caption"]], cams, gen)
            losses.append(float(loss))
            if k == 0:
                first = grads
    return losses, first, {k: p.detach().clone() for k, p in trainer.params.items()}


def free_program(state: State) -> None:
    if state.prefetch is not None:
        state.prefetch.close()
    state.mods.clear()
    state.opt = state.it = state.prefetch = None
    state.masters = {}
    recon.free_program(state)


def check(state: State) -> Dict[str, dict]:
    free_program(state)
    return recon.with_limits(recon.gaps(state, recon.program_readings(state), follow(state)),
                             state.traffic["limits"])


def calibrate(ctx: harness.Ctx, control: bool) -> Dict[str, Dict[str, float]]:
    state = setup(ctx)
    free_program(state)
    want = follow(state)
    out = {"program": recon.gaps(state, recon.program_readings(state), want)}
    if control:
        out["control"] = recon.gaps(state, follow(state, "fp8"), want)
        for fault in ("half_batch", "altered"):
            out[fault] = recon.gaps(state, follow(state, fault=fault), want)
    return out
