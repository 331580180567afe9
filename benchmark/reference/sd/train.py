"""The MV-VDM training step as plain code: the port's
``cli/train_mvvdm.py`` per-step body (posterior sample of the clip's
frames, captions and frame 0 through the towers) and
``pipelines/train_mvvdm.py::train_step`` (the draws, epsilon-MSE on frames
1.., global-norm clipping, AdamW on the trainable leaves), written out
again over the reference modules, float32, every draw taken from the
caller's generator in the port's order."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import pipeline


def is_trainable(name: str, markers: Sequence[str]) -> bool:
    return any(m in name for m in markers)


def read_clip(video_root: str, item: dict, indices: np.ndarray, n_views: int) -> np.ndarray:
    """(N, F, H, W, 3) float32 in [-1, 1] of an item's image-sequence
    directories (frames sorted by name length, then name)."""
    import os

    from PIL import Image

    views = []
    for rel in item["videos"][:n_views]:
        d = os.path.join(video_root, rel)
        names = sorted((x for x in os.listdir(d) if x.lower().endswith(".png")),
                       key=lambda x: (len(x), x))
        frames = []
        for i in indices:
            with Image.open(os.path.join(d, names[min(int(i), len(names) - 1)])) as im:
                frames.append(np.asarray(im.convert("RGB")))
        views.append(np.stack(frames))
    return np.stack(views).astype(np.float32) / 127.5 - 1.0


def batches(items: List[dict], seed: int, total_frames: int, n_frames: int):
    """(item, frame indices) of each step: epochs over a shuffled order, a
    random stride phase an item (the port's ``MVideoDataset.iterate`` at
    batch 1, from the same numpy generator)."""
    rng = np.random.default_rng(seed)
    order = np.arange(len(items))
    stride = total_frames // n_frames
    while True:
        rng.shuffle(order)
        for i in order:
            phase = int(rng.integers(0, max(stride, 1)))
            yield items[int(i)], phase + stride * np.arange(n_frames)


class Trainer:
    """The UNet's trainable leaves (``markers``) with AdamW state; the VAE
    and towers frozen."""

    def __init__(self, mods: Dict[str, torch.nn.Module], config: dict, markers: Sequence[str],
                 train: dict):
        self.mods, self.config, self.train = mods, config, train
        unet = mods["unet"]
        unet.train()
        self.params = {}
        for name, p in unet.named_parameters():
            p.requires_grad_(is_trainable(name, markers))
            if p.requires_grad:
                self.params[name] = p
        self.m = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0
        self.sched = pipeline.scheduler(config, next(unet.parameters()).device)
        self.fault = None  # "half_batch" or "altered": a planted fault

    @torch.no_grad()
    def _latents(self, pixels: torch.Tensor, gen: torch.Generator, chunk: int = 16):
        b, n, f, h, w, _ = pixels.shape
        vae = self.mods["vae"]
        lat = h // 2 ** (len(self.config["vae"]["block_out_channels"]) - 1)
        c = self.config["vae"]["latent_channels"]
        imgs = pixels.reshape(b * n * f, h, w, 3)
        m = imgs.shape[0]
        eps = torch.cat([torch.randn((min(chunk, m - i), lat, lat, c), generator=gen,
                                     device=imgs.device) for i in range(0, m, chunk)])
        mean, logvar = (torch.cat(p) for p in zip(*(vae.encode(imgs[i:i + chunk])
                                                     for i in range(0, m, chunk))))
        z = (mean + torch.exp(0.5 * logvar) * eps) * self.config["vae"]["scaling_factor"]
        return z.reshape(b * n, f, lat, lat, c)

    def step(self, pixels: torch.Tensor, captions: List[str], cameras: torch.Tensor,
             gen: torch.Generator):
        """(loss, {leaf: clipped gradient}) of one step, then AdamW."""
        tr = self.train
        b, n = pixels.shape[:2]
        latents = self._latents(pixels, gen)
        with torch.no_grad():
            text = self.mods["text"]
            max_len = text.config.max_position_embeddings
            dev = pixels.device
            ctx = text(pipeline.char_tokens(list(captions), max_len).to(dev)).float()
            ctx = ctx.repeat_interleave(n, dim=0)
            null = text(pipeline.char_tokens([""], max_len).to(dev)).float()[0].expand(ctx.shape)
            embeds = pipeline.image_conditioning(
                self.mods["vision"], (pixels[:, :, 0].reshape(b * n, *pixels.shape[3:]) + 1) / 2)
        t = torch.randint(0, self.sched.config.num_train_timesteps, (b,), generator=gen,
                          device=dev)
        noise = torch.randn((b * n, latents.shape[1] - 1) + tuple(latents.shape[2:]),
                            generator=gen, device=dev)
        drop = torch.rand((b,), generator=gen, device=dev) < tr["cfg_dropout_prob"]
        tv = t.repeat_interleave(n)
        noisy = torch.cat([latents[:, :1], self.sched.add_noise(latents[:, 1:], noise, tv)], 1)
        text_ctx = torch.where(drop.repeat_interleave(n)[:, None, None], null, ctx)
        for p in self.params.values():
            p.grad = None
        eps = self.mods["unet"](noisy, tv, text_ctx, cameras.reshape(b * n, 16), embeds)
        err = (eps[:, 1:].float() - noise) ** 2
        if self.fault == "half_batch":
            err = err[: err.shape[0] // 2]
        elif self.fault == "altered":
            err = (eps[:, 1:].float() * 0.98 - noise) ** 2
        loss = err.mean()
        loss.backward()
        grads = {k: p.grad.detach().clone() for k, p in self.params.items()}
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
        if not bool(norm < tr["max_grad_norm"]):
            grads = {k: g / norm * tr["max_grad_norm"] for k, g in grads.items()}
        self.count += 1
        b1, b2, lr, wd, e = (tr["adam_b1"], tr["adam_b2"], tr["learning_rate"],
                             tr["weight_decay"], tr["adam_eps"])
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k]
                p.mul_(1 - lr * wd)
                self.m[k] = b1 * self.m[k] + (1 - b1) * g
                self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
                mh = self.m[k] / (1 - b1 ** self.count)
                vh = self.v[k] / (1 - b2 ** self.count)
                p.add_(-lr * mh / (torch.sqrt(vh) + e))
        return loss.detach(), grads
