"""The stage-2 4D-SDS loss as plain code: the port's
``pipelines/guidance.py::AnimateMVGuidance.loss`` (one card, the vision
tower on each view's first render) and
``systems/animate3d.py::_render_guidance_rgb``, over the reference MV-VDM
modules in ``benchmark/reference/sd``."""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference.sd import pipeline as sd

from .rasterize import GSCameraArrays
from .renderer4d import render_batch


class SDSDraws(NamedTuple):
    t_video: torch.Tensor  # (B,) int
    posterior: torch.Tensor  # (B·N·F, h, w, C)
    noise: torch.Tensor  # (B·N, F-1, h, w, C)


def camera16(c2w: torch.Tensor, bn: int, n_frame: int) -> torch.Tensor:
    """Each view's frame-0 c2w, translation on the unit sphere, flattened."""
    c = c2w.reshape(bn, n_frame, 4, 4)[:, 0].float().clone()
    t = c[:, :3, 3]
    c[:, :3, 3] = t / (torch.linalg.norm(t, dim=1, keepdim=True) + 1e-8)
    return c.reshape(bn, 16)


class SDS:
    """The frozen guidance: UNet, VAE and vision tower (reference modules),
    the scheduler, and the prompt's text conditioning."""

    def __init__(self, mods: Dict[str, torch.nn.Module], mv_config: dict, g: dict, prompt: str,
                 n_view: int, n_frame: int):
        self.mods, self.g, self.n, self.f = mods, g, n_view, n_frame
        dev = next(mods["unet"].parameters()).device
        self.sched = sd.scheduler(mv_config, dev)
        self.scaling = mv_config["vae"]["scaling_factor"]
        self.cond, self.uncond = sd.text_conditioning(mods["text"], prompt, n_view)
        self.fault = None  # a planted fault: "half_batch" or "altered" (``system.Recon``)

    def _encode(self, x: torch.Tensor):
        vae, chunk = self.mods["vae"], self.g["vae_encode_chunk"]
        if x.shape[0] <= chunk or x.shape[0] % chunk:
            return vae.encode(x)
        parts = [checkpoint(vae.encode, x[i:i + chunk], use_reentrant=False)
                 for i in range(0, x.shape[0], chunk)]
        return tuple(torch.cat([p[j] for p in parts]) for j in range(2))

    def render(self, field, state, batch: dict, rcfg) -> torch.Tensor:
        """The SDS batch's renders at the guidance's size, each item
        deformed at its frame, scales too, no draws."""
        import dataclasses

        ts = batch["timestamps"]
        frame_ts = ts[:self.f]
        deformed = field.deform_frames(state, frame_ts, True)

        def deform_fn(items):
            fi = torch.argmin(torch.abs(frame_ts[None, :] - items[:, None]), dim=1)
            return tuple(d[fi] for d in deformed)

        size = self.g["image_size"]
        cfg = dataclasses.replace(rcfg, height=size, width=size)
        rgb = render_batch(state, deform_fn, batch["cameras"], ts, cfg).rgb
        return rgb * 0.98 if self.fault == "altered" else rgb

    def loss(self, rgb: torch.Tensor, c2w: torch.Tensor, draws: SDSDraws) -> torch.Tensor:
        g, n, f = self.g, self.n, self.f
        b = draws.t_video.shape[0]
        bn = b * n
        mods = self.mods
        with torch.no_grad():
            firsts = rgb.detach().reshape(bn, f, *rgb.shape[1:])[:, 0]
            embeds = sd.image_conditioning(mods["vision"], firsts)
        mean, logvar = self._encode(rgb * 2.0 - 1.0)
        latents = (mean + torch.exp(0.5 * logvar) * draws.posterior) * self.scaling
        lh, lw, lc = latents.shape[1:]
        latents = latents.reshape(bn, f, lh, lw, lc)
        t = draws.t_video.long().repeat_interleave(n)
        cam = camera16(c2w, bn, f)
        with torch.no_grad():
            rest = latents[:, 1:].detach()
            noisy = torch.cat([latents[:, :1].detach(),
                               self.sched.add_noise(rest, draws.noise, t)], dim=1)
            eps = mods["unet"](torch.cat([noisy, noisy]), torch.cat([t, t]),
                               torch.cat([self.cond, self.uncond]), torch.cat([cam, cam]),
                               torch.cat([embeds, torch.zeros_like(embeds)])).float()
            e_t, e_u = eps.chunk(2)
            e_cfg = e_t + g["guidance_scale"] * (e_t - e_u)
            flat = lambda x: x.reshape(bn * f, lh, lw, lc)
            tf = t.repeat_interleave(f)
            recon = self.sched.pred_original(flat(noisy), flat(e_cfg), tf).reshape(
                bn, f, lh, lw, lc)
            if g["recon_std_rescale"] > 0:
                nocfg = self.sched.pred_original(flat(noisy), flat(e_t), tf).reshape(
                    b, n, f, lh, lw, lc)
                r = recon.reshape(b, n, f, lh, lw, lc)
                dims = (1, 2, 3, 4, 5)
                factor = ((torch.std(nocfg[:, :, 1:], dim=dims, correction=0) + 1e-8)
                          / (torch.std(r[:, :, 1:], dim=dims, correction=0) + 1e-8))
                adjust = (r * factor.reshape(b, 1, 1, 1, 1, 1)).reshape(bn, f, lh, lw, lc)
                recon = g["recon_std_rescale"] * adjust + (1 - g["recon_std_rescale"]) * recon
            recon = torch.cat([latents[:, :1].detach(), recon[:, 1:]], dim=1)
        err = (latents - recon) ** 2
        if self.fault == "half_batch":  # the second half of the videos' views left out
            return 0.5 * torch.sum(err[: bn // 2]) / (bn // 2 * f) * f / (f - 1)
        return 0.5 * torch.sum(err) / (bn * f) * f / (f - 1)


def cameras_of(batch_raw: dict, device) -> GSCameraArrays:
    from .cameras import gs_cameras

    return gs_cameras(batch_raw["c2w"], batch_raw["fovy"], batch_raw["height"],
                      batch_raw["width"], device)
