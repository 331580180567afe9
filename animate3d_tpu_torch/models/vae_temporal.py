"""Stable Video Diffusion's VAE: the SD encoder and a temporal decoder.

diffusers' ``AutoencoderKLTemporalDecoder`` as released with SVD-XT
(``vae/config.json``), with its parameter names. The encoder, ``quant_conv``
and the posterior are the SD1.5 VAE's (``models/vae.py``); there is no
``post_quant_conv``. The decoder is ``TemporalDecoder``: its ResNet blocks
are :class:`~animate3d_tpu_torch.models.unet_svd.SpatioTemporalResBlock`
pairs (the VAE's ResNet block on each frame, a temporal ResNet block over
the frames, blended with the learned strategy and the switch, mix 0), the
mid block's single-head attention is the VAE's, and a final Conv3d with
kernel (3, 1, 1) (``time_conv_out``) mixes neighbouring frames of the RGB
output. Runs in float32. Public layout: images ``(N, H, W, 3)`` in
[-1, 1], latents ``(N, h, w, 4)`` (unscaled), as ``models/vae.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from animate3d_tpu_torch.models.unet_svd import SpatioTemporalResBlock, frames_4d, frames_5d
from animate3d_tpu_torch.models.vae import Encoder, VAEAttention, VAEConfig, VAEResnet
from animate3d_tpu_torch.utils import trace


def _res(cin: int, cout: int, groups: int) -> SpatioTemporalResBlock:
    # spatial eps 1e-6 (the VAE's), temporal eps 1e-5, mix 0 (sigmoid 0.5)
    return SpatioTemporalResBlock(cin, cout, None, 1e-6, temporal_eps=1e-5, mix=0.0,
                                  spatial=VAEResnet(cin, cout, groups))


class _Mid(nn.Module):
    def __init__(self, ch: int, g: int):
        super().__init__()
        self.resnets = nn.ModuleList([_res(ch, ch, g), _res(ch, ch, g)])
        self.attentions = nn.ModuleList([VAEAttention(ch, g)])


class _Up(nn.Module):
    def __init__(self, resnets, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if up is not None:
            holder = nn.Module()
            holder.conv = up
            self.upsamplers = nn.ModuleList([holder])


class TemporalDecoder(nn.Module):
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
                resnets.append(_res(ch, out, g))
                ch = out
            up = nn.Conv2d(ch, ch, 3, padding=1) if i < len(rev) - 1 else None
            self.up_blocks.append(_Up(resnets, up))
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)
        self.time_conv_out = nn.Conv3d(cfg.out_channels, cfg.out_channels, (3, 1, 1),
                                       padding=(1, 0, 0))

    @trace.spanned("vae.temporal_decoder")
    def forward(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        """z (B·F, 4, h, w) → (B·F, 3, H, W); the blenders' image-only
        indicator is zero (the learned strategy does not read it)."""
        image_only = torch.zeros((z.shape[0] // num_frames, num_frames), device=z.device)
        mid = self.mid_block
        h = mid.resnets[0](self.conv_in(z), None, image_only)
        h = mid.resnets[1](mid.attentions[0](h), None, image_only)
        for lvl in self.up_blocks:
            for r in lvl.resnets:
                h = r(h, None, image_only)
            if hasattr(lvl, "upsamplers"):
                h = nn.functional.interpolate(h, scale_factor=2.0, mode="nearest")
                h = lvl.upsamplers[0].conv(h)
        h = self.conv_out(nn.functional.silu(self.conv_norm_out(h)))
        return frames_4d(self.time_conv_out(frames_5d(h, num_frames)))


class AutoencoderKLTemporalDecoder(nn.Module):
    """encode(x) → (mean, logvar) as the SD VAE; decode(z, num_frames) →
    frames, NHWC at the surface."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.decoder = TemporalDecoder(config)

    def encode(self, x: torch.Tensor):
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """The posterior's mode (its mean), unscaled."""
        return self.encode(x)[0]

    def decode(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        """z (B·F, h, w, 4), unscaled → (B·F, H, W, 3); the temporal layers
        see the ``num_frames`` frames of each clip together."""
        return self.decoder(z.permute(0, 3, 1, 2), num_frames).permute(0, 2, 3, 1)
