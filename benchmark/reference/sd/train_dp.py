"""The MV-VDM training step at data parallelism, as plain code: the global
batch of ``dp`` videos (one a rank), its draws taken as the port's trainer
takes them at dp (``cli/train_mvvdm.py``: the dataset's global batch with
every item's stride phase, the posterior noise of every rank's frames a
chunk at a time, then ``pipelines/train_mvvdm.py::draw``'s t, noise and CFG
drop for the whole batch), and the gradient the ranks' all-reduce makes:
the mean over the videos of each video's epsilon-MSE gradient. The videos
run one at a time (so that a float32 UNet with one video's activations fits
one card) and their gradients are summed in float32; then global-norm
clipping and AdamW as :class:`~benchmark.reference.sd.train.Trainer` does."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import pipeline
from .train import Trainer


def global_batches(items: List[dict], seed: int, total_frames: int, n_frames: int,
                   batch: int):
    """Each step's [(item, frame indices)] of the global batch: epochs over a
    shuffled order in whole batches, one stride phase drawn an item in the
    batch's order (the port's ``MVideoDataset.iterate`` at ``batch``)."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(items))
    stride = total_frames // n_frames
    while True:
        rng.shuffle(order)
        for start in range(0, len(order) - batch + 1, batch):
            out = []
            for i in order[start:start + batch]:
                phase = int(rng.integers(0, max(stride, 1)))
                out.append((items[int(i)], phase + stride * np.arange(n_frames)))
            yield out


def dp_step(trainer: Trainer, pixels: List[torch.Tensor], captions: List[str],
            cameras: torch.Tensor, gen: torch.Generator, chunk: int = 16,
            fault: Optional[str] = None):
    """(mean loss, {leaf: clipped gradient}) of one global step over the
    videos ``pixels`` (each (1, N, F, H, W, 3)), then AdamW. ``fault``
    "own_rank": the first video's gradient alone (no all-reduce)."""
    tr, mods, cfg = trainer.train, trainer.mods, trainer.config
    dp = len(pixels)
    _, n, f, h, w, _ = pixels[0].shape
    dev = pixels[0].device
    lat = h // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    c = cfg["vae"]["latent_channels"]
    m = n * f
    total = dp * m
    with torch.no_grad():
        eps = torch.cat([torch.randn((min(chunk, total - i), lat, lat, c), generator=gen,
                                     device=dev) for i in range(0, total, chunk)])
        latents = []
        for r, px in enumerate(pixels):
            imgs = px.reshape(m, h, w, 3)
            mean, logvar = (torch.cat(p) for p in zip(*(mods["vae"].encode(imgs[i:i + chunk])
                                                         for i in range(0, m, chunk))))
            z = (mean + torch.exp(0.5 * logvar) * eps[r * m:(r + 1) * m])
            latents.append((z * cfg["vae"]["scaling_factor"]).reshape(n, f, lat, lat, c))
        text = mods["text"]
        max_len = text.config.max_position_embeddings
        ctx = text(pipeline.char_tokens(list(captions), max_len).to(dev)).float()
        null = text(pipeline.char_tokens([""], max_len).to(dev)).float()[0]
        embeds = [pipeline.image_conditioning(mods["vision"], (px[0, :, 0] + 1) / 2)
                  for px in pixels]
    t = torch.randint(0, trainer.sched.config.num_train_timesteps, (dp,), generator=gen,
                      device=dev)
    noise = torch.randn((dp * n, f - 1, lat, lat, c), generator=gen, device=dev)
    drop = torch.rand((dp,), generator=gen, device=dev) < tr["cfg_dropout_prob"]
    for p in trainer.params.values():
        p.grad = None
    losses = []
    used = 1 if fault == "own_rank" else dp
    for r in range(used):
        lt = latents[r]
        tv = t[r:r + 1].repeat_interleave(n)
        nz = noise[r * n:(r + 1) * n]
        noisy = torch.cat([lt[:, :1], trainer.sched.add_noise(lt[:, 1:], nz, tv)], 1)
        text_ctx = (null if bool(drop[r]) else ctx[r]).expand(n, *null.shape)
        out = mods["unet"](noisy, tv, text_ctx, cameras.reshape(n, 16), embeds[r])
        loss = ((out[:, 1:].float() - nz) ** 2).mean()
        (loss / used).backward()
        losses.append(float(loss))
    grads = {k: p.grad.detach().clone() for k, p in trainer.params.items()}
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
    if not bool(norm < tr["max_grad_norm"]):
        grads = {k: g / norm * tr["max_grad_norm"] for k, g in grads.items()}
    _adamw(trainer, grads)
    return float(np.mean(losses)), grads


def _adamw(trainer: Trainer, grads: Dict[str, torch.Tensor]) -> None:
    tr = trainer.train
    trainer.count += 1
    b1, b2, lr, wd, e = (tr["adam_b1"], tr["adam_b2"], tr["learning_rate"],
                         tr["weight_decay"], tr["adam_eps"])
    with torch.no_grad():
        for k, p in trainer.params.items():
            g = grads[k]
            p.mul_(1 - lr * wd)
            trainer.m[k] = b1 * trainer.m[k] + (1 - b1) * g
            trainer.v[k] = b2 * trainer.v[k] + (1 - b2) * g * g
            mh = trainer.m[k] / (1 - b1 ** trainer.count)
            vh = trainer.v[k] / (1 - b2 ** trainer.count)
            p.add_(-lr * mh / (torch.sqrt(vh) + e))
