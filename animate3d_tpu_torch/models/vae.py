"""SD1.5 AutoencoderKL (port of animate3d_tpu/models/vae.py).

Public layout as in the JAX module: images ``(N, H, W, 3)`` in [-1, 1],
latents ``(N, h, w, 4)`` (scaled by ``config.scaling_factor`` at the
pipeline level). Inside, NCHW. Runs in float32, as the JAX VAE does; its
mid-block attention is plain torch, as the JAX VAE's is plain XLA.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from animate3d_tpu_torch.utils import trace


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @staticmethod
    def tiny(**kw) -> "VAEConfig":
        d = dict(block_out_channels=(32, 64), norm_num_groups=8)
        d.update(kw)
        return VAEConfig(**d)


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        silu = nn.functional.silu
        h = self.conv2(silu(self.norm2(self.conv1(silu(self.norm1(x))))))
        residual = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        return h + residual


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial tokens (VAE mid block)."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = torch.matmul(q, k.transpose(1, 2)).float() * (c ** -0.5)
        y = torch.matmul(torch.softmax(logits, dim=-1).to(y.dtype), v)
        y = self.to_out[0](y)
        return y.transpose(1, 2).reshape(b, c, h, w) + x


class _Level(nn.Module):
    def __init__(self, resnets, sampler_name=None, conv=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if conv is not None:
            holder = nn.Module()
            holder.conv = conv
            setattr(self, sampler_name, nn.ModuleList([holder]))


class _Mid(nn.Module):
    def __init__(self, ch: int, g: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnet(ch, ch, g), VAEResnet(ch, ch, g)])
        self.attentions = nn.ModuleList([VAEAttention(ch, g)])

    def forward(self, h):
        return self.resnets[1](self.attentions[0](self.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = boc[0]
        for i, out in enumerate(boc):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(VAEResnet(ch, out, g))
                ch = out
            down = nn.Conv2d(ch, ch, 3, stride=2) if i < len(boc) - 1 else None
            self.down_blocks.append(_Level(resnets, "downsamplers", down))
        self.mid_block = _Mid(ch, g)
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    @trace.spanned("vae.encoder")
    def forward(self, x):
        h = self.conv_in(x)
        for lvl in self.down_blocks:
            for r in lvl.resnets:
                h = r(h)
            if hasattr(lvl, "downsamplers"):
                # diffusers pads (0, 1) on each spatial axis before the
                # stride-2 conv
                h = lvl.downsamplers[0].conv(nn.functional.pad(h, (0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(nn.functional.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _Mid(rev[0], g)
        self.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, out in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(VAEResnet(ch, out, g))
                ch = out
            up = nn.Conv2d(ch, ch, 3, padding=1) if i < len(rev) - 1 else None
            self.up_blocks.append(_Level(resnets, "upsamplers", up))
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    @trace.spanned("vae.decoder")
    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for lvl in self.up_blocks:
            for r in lvl.resnets:
                h = r(h)
            if hasattr(lvl, "upsamplers"):
                h = nn.functional.interpolate(h, scale_factor=2.0, mode="nearest")
                h = lvl.upsamplers[0].conv(h)
        return self.conv_out(nn.functional.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """encode(x) → (mean, logvar); decode(z) → image, NHWC at the surface."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                    2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)

    def encode(self, x: torch.Tensor):
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic latents: the posterior mode (its mean)."""
        return self.encode(x)[0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        out = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        return out.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode_mode(x))
