"""The MV-VDM sampling request as plain code: the byte-level tokenizer, the
text and vision towers' conditioning, the VAE encode of the conditioning
renders, one CFG + DDIM step with frame 0 re-injected, the FreeInit
re-noise and the VAE decode (the port's ``cli/inference.py`` and
``pipelines/mv_sampler.py``, written out again)."""

from __future__ import annotations

import re
from dataclasses import fields
from typing import Dict, List

import torch

from .clip import (CLIPTextConfig, CLIPTextModel, CLIPVisionConfig,
                   CLIPVisionModelWithProjection, encode_ip_adapter_images)
from .camera import get_camera
from .diffusion import DDIMScheduler, SchedulerConfig, freeinit_blend
from .unet_blocks import MotionAttnConfig
from .unet_mv import MVMotionUNet, MVUNetConfig
from .vae import AutoencoderKL, VAEConfig

_PAT = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|"
                  r"[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)


def _byte_chars() -> List[str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def char_tokens(texts: List[str], max_length: int = 77) -> torch.Tensor:
    """Token ids of the byte-level vocabulary (each byte's character, then
    each with ``</w>``, then start and end of text), no merges: a word's
    bytes, its last byte in the ``</w>`` form; start, at most
    ``max_length - 2`` ids, end, padded with end."""
    table = _byte_chars()
    order = list(table.values())
    index = {c: i for i, c in enumerate(order)}
    bos, eos = 2 * len(order), 2 * len(order) + 1
    out = torch.full((len(texts), max_length), eos, dtype=torch.long)
    for i, text in enumerate(texts):
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids = []
        for tok in _PAT.findall(text):
            chars = [table[b] for b in tok.encode("utf-8")]
            ids += [index[c] for c in chars[:-1]] + [len(order) + index[chars[-1]]]
        ids = [bos] + ids[:max_length - 2] + [eos]
        out[i, :len(ids)] = torch.tensor(ids)
    return out


def _dataclass(cls, d: dict):
    names = {f.name for f in fields(cls)}
    return cls(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()
                  if k in names})


def unet_config(d: dict) -> MVUNetConfig:
    d = dict(d)
    motion = _dataclass(MotionAttnConfig, d.pop("motion_attn", {}))
    return _dataclass(MVUNetConfig, dict(d, motion_attn=motion))


def build(config: dict, device, unet: bool = True) -> Dict[str, torch.nn.Module]:
    """The reference modules of an ``mvvdm`` configuration file, float32,
    frozen, weights uninitialised (the caller loads the benchmark's)."""
    with torch.device(device):
        mods = {"vae": AutoencoderKL(_dataclass(VAEConfig, config["vae"])),
                "text": CLIPTextModel(_dataclass(CLIPTextConfig, config["text"])),
                "vision": CLIPVisionModelWithProjection(
                    _dataclass(CLIPVisionConfig, config["vision"]))}
        if unet:
            mods["unet"] = MVMotionUNet(unet_config(config["unet"]))
    for m in mods.values():
        m.eval().requires_grad_(False)
    return mods


def scheduler(config: dict, device) -> DDIMScheduler:
    return DDIMScheduler(_dataclass(SchedulerConfig, config["scheduler"]), device=device)


def text_conditioning(text_model, prompt: str, n_views: int):
    """(cond, uncond), each (n_views, 77, D), of the prompt and ""."""
    dev = next(text_model.parameters()).device
    max_len = text_model.config.max_position_embeddings
    out = text_model(char_tokens([prompt, ""], max_len).to(dev)).float()
    return out[0:1].repeat(n_views, 1, 1), out[1:2].repeat(n_views, 1, 1)


def image_conditioning(vision_model, images: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) renders in [0, 1] → (N, D) IP-Adapter image embeds."""
    return encode_ip_adapter_images(vision_model, images).float()


def first_frame_latents(vae, images: torch.Tensor, scaling: float) -> torch.Tensor:
    """(N, H, W, 3) renders in [0, 1] → (N, 1, h, w, 4) scaled mode latents."""
    return (vae.encode_mode(images * 2.0 - 1.0) * scaling)[:, None]


def cameras(n_views: int, elevation: float, device) -> torch.Tensor:
    return torch.as_tensor(get_camera(n_views, elevation=elevation), device=device)


def cfg_ddim_step(unet, sched, x: torch.Tensor, t, text_ctx, camera, img2,
                  guidance: float, num_steps: int) -> torch.Tensor:
    """One denoise step of latents ``x`` (B·N, F, h, w, C) at ``t``: the CFG
    pair through the UNet, the guided epsilon, the DDIM step, frame 0 of
    ``x`` kept."""
    eps = unet(torch.cat([x, x]), t, text_ctx, torch.cat([camera, camera]), img2)
    eps_u, eps_c = eps.float().chunk(2)
    prev, _ = sched.step(eps_u + guidance * (eps_c - eps_u), t, x.float(), num_steps)
    return torch.cat([x[:, :1].float(), prev[:, 1:]], dim=1)


def renoise(sched, latents: torch.Tensor, initial_noise: torch.Tensor,
            fresh: torch.Tensor) -> torch.Tensor:
    """FreeInit: frames 1.. of ``latents`` noised to the last train step with
    the initial noise, low frequencies kept, high ones from ``fresh``."""
    t_max = sched.config.num_train_timesteps - 1
    rest = freeinit_blend(sched.add_noise(latents[:, 1:].float(), initial_noise, t_max),
                          fresh)
    return torch.cat([latents[:, :1].float(), rest], dim=1)


def decode(vae, latents: torch.Tensor, scaling: float, chunk: int = 16) -> torch.Tensor:
    """(B·N, F, h, w, C) latents → (B·N, F, H, W, 3) in [0, 1]."""
    bn, f, h, w, c = latents.shape
    flat = (latents.float() / scaling).reshape(bn * f, h, w, c)
    imgs = torch.cat([vae.decode(flat[i:i + chunk]) for i in range(0, bn * f, chunk)])
    imgs = (imgs / 2 + 0.5).clamp(0.0, 1.0)
    return imgs.reshape(bn, f, imgs.shape[1], imgs.shape[2], 3)
