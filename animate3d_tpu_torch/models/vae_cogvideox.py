"""CogVideoX's causal 3D VAE (``AutoencoderKLCogVideoX``).

As released with ``THUDM/CogVideoX-5b-I2V`` (``vae/config.json``: latent 16
channels, ``block_out_channels`` [128, 256, 256, 512], 3 layers a block, 4x
temporal and 8x spatial compression, ``scaling_factor`` 0.7), with
diffusers' parameter names. The JAX package has no such model; no other
VAE of the port is causal in time. Video ``(B, C, F, H, W)``.

* :class:`CausalConv3d`: a 3 x 3 x 3 convolution, zero-padded in space and
  causal in time: the first frame repeated in front of a video's first
  batch of frames, the previous batch's last two (padded) frames in front
  of each later one (the ``cache`` each call returns).
* The encoder's down blocks halve the frames too at the first two levels
  (the first frame kept, the rest averaged in pairs), then pad (0, 1, 0, 1)
  and a stride-2 Conv2d a frame. The decoder's up blocks double them at the
  first two levels (nearest, the first frame alone), then a Conv2d a frame;
  its norms are ``SpatialNorm3D`` (GroupNorm, then a scale and a shift from
  the latents through 1 x 1 x 1 convolutions, the latents resized nearest,
  the first frame alone).
* Encode runs 8 frames a batch, decode 2 latent frames a batch, the first
  batch taking the remainder; GroupNorm statistics are a batch's, the
  causal caches carry over (13 latent frames decode 3, 2, 2, ... → 9, 8,
  8, ... = 49 frames).

Float32 (TF32 off on the card), as the port's other VAEs. Spans
``vae3d.encoder`` and ``vae3d.decoder``, one a batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from animate3d_tpu_torch.models.layers import Conv2d, Conv3d, GroupNorm
from animate3d_tpu_torch.utils import trace


@dataclass(frozen=True)
class VAE3DConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 3
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    temporal_compression_ratio: int = 4
    scaling_factor: float = 0.7
    encode_frame_batch: int = 8
    decode_latent_frame_batch: int = 2

    @classmethod
    def tiny(cls) -> "VAE3DConfig":
        return cls(latent_channels=4, block_out_channels=(32, 32, 32, 64), layers_per_block=1)


class CausalConv3d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        self.kernel = kernel
        self.conv = Conv3d(cin, cout, kernel)

    def forward(self, x: torch.Tensor, cache: Optional[torch.Tensor] = None):
        """(output, cache for the next batch of frames)."""
        k = self.kernel
        if k == 1:
            return self.conv(x), None
        head = cache if cache is not None else x[:, :, :1].expand(-1, -1, k - 1, -1, -1)
        x = torch.cat([head, x], dim=2)
        nxt = x[:, :, -(k - 1):].clone()
        return self.conv(F.pad(x, (k // 2,) * 4)), nxt


class SpatialNorm3D(nn.Module):
    def __init__(self, channels: int, latent: int, groups: int):
        super().__init__()
        self.norm_layer = GroupNorm(groups, channels, eps=1e-6)
        self.conv_y = CausalConv3d(latent, channels, 1)
        self.conv_b = CausalConv3d(latent, channels, 1)

    def forward(self, f: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        size = tuple(f.shape[-2:])
        if f.shape[2] > 1 and f.shape[2] % 2 == 1:
            z = torch.cat([F.interpolate(z[:, :, :1], size=(1,) + size),
                           F.interpolate(z[:, :, 1:], size=(f.shape[2] - 1,) + size)], dim=2)
        else:
            z = F.interpolate(z, size=tuple(f.shape[-3:]))
        return self.norm_layer(f) * self.conv_y(z)[0] + self.conv_b(z)[0]


class ResnetBlock3D(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, eps: float,
                 latent: Optional[int] = None):
        super().__init__()
        self.spatial = latent is not None
        if self.spatial:
            self.norm1 = SpatialNorm3D(cin, latent, groups)
            self.norm2 = SpatialNorm3D(cout, latent, groups)
        else:
            self.norm1 = GroupNorm(groups, cin, eps=eps)
            self.norm2 = GroupNorm(groups, cout, eps=eps)
        self.conv1 = CausalConv3d(cin, cout)
        self.conv2 = CausalConv3d(cout, cout)
        self.conv_shortcut = Conv3d(cin, cout, 1) if cin != cout else None

    def forward(self, x, z, cache: dict):
        nxt = {}
        h = self.norm1(x, z) if self.spatial else self.norm1(x)
        h, nxt["conv1"] = self.conv1(F.silu(h), cache.get("conv1"))
        h = self.norm2(h, z) if self.spatial else self.norm2(h)
        h, nxt["conv2"] = self.conv2(F.silu(h), cache.get("conv2"))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h, nxt


class Downsample3D(nn.Module):
    def __init__(self, channels: int, compress_time: bool):
        super().__init__()
        self.compress_time = compress_time
        self.conv = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        b, c, f, h, w = x.shape
        if self.compress_time and f > 1:
            t = x.permute(0, 3, 4, 1, 2).reshape(b * h * w, c, f)
            if f % 2:
                t = torch.cat([t[..., :1], F.avg_pool1d(t[..., 1:], 2, 2)], dim=-1)
            else:
                t = F.avg_pool1d(t, 2, 2)
            f = t.shape[-1]
            x = t.reshape(b, h, w, c, f).permute(0, 3, 4, 1, 2)
        x = F.pad(x, (0, 1, 0, 1)).transpose(1, 2).reshape(b * f, c, h + 1, w + 1)
        y = self.conv(x)
        return y.reshape(b, f, c, *y.shape[-2:]).transpose(1, 2)


class Upsample3D(nn.Module):
    def __init__(self, channels: int, compress_time: bool):
        super().__init__()
        self.compress_time = compress_time
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        b, c, f, h, w = x.shape
        if self.compress_time and f > 1:
            if f % 2:
                x = torch.cat([F.interpolate(x[:, :, 0], scale_factor=2.0)[:, :, None],
                               F.interpolate(x[:, :, 1:], scale_factor=2.0)], dim=2)
            else:
                x = F.interpolate(x, scale_factor=2.0)
            f = x.shape[2]
        else:
            x = F.interpolate(x.transpose(1, 2).reshape(b * f, c, h, w), scale_factor=2.0)
            x = x.reshape(b, f, c, 2 * h, 2 * w).transpose(1, 2)
        y = self.conv(x.transpose(1, 2).reshape(b * f, c, 2 * h, 2 * w))
        return y.reshape(b, f, c, 2 * h, 2 * w).transpose(1, 2)


class _Block(nn.Module):
    """A down / up / mid block: resnets, then its sampler (diffusers'
    ``downsamplers.0`` / ``upsamplers.0``)."""

    def __init__(self, resnets: List[nn.Module], sampler: Optional[nn.Module] = None,
                 kind: str = ""):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.kind = kind if sampler is not None else ""
        if self.kind:
            setattr(self, kind, nn.ModuleList([sampler]))

    def forward(self, x, z, cache: dict):
        nxt = {}
        for i, r in enumerate(self.resnets):
            x, nxt[i] = r(x, z, cache.get(i, {}))
        if self.kind:
            x = getattr(self, self.kind)[0](x)
        return x, nxt


class Encoder3D(nn.Module):
    def __init__(self, c: VAE3DConfig):
        super().__init__()
        ch, g, eps = c.block_out_channels, c.norm_num_groups, c.norm_eps
        timed = int(math.log2(c.temporal_compression_ratio))
        self.conv_in = CausalConv3d(c.in_channels, ch[0])
        blocks, cout = [], ch[0]
        for i, co in enumerate(ch):
            cin, cout = cout, co
            res = [ResnetBlock3D(cin if j == 0 else cout, cout, g, eps)
                   for j in range(c.layers_per_block)]
            last = i == len(ch) - 1
            blocks.append(_Block(res, None if last else Downsample3D(cout, i < timed),
                                 "downsamplers"))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _Block([ResnetBlock3D(ch[-1], ch[-1], g, eps) for _ in range(2)])
        self.norm_out = GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = CausalConv3d(ch[-1], 2 * c.latent_channels)

    @trace.spanned("vae3d.encoder")
    def forward(self, x, cache: dict):
        nxt = {}
        h, nxt["in"] = self.conv_in(x, cache.get("in"))
        for i, blk in enumerate(self.down_blocks):
            h, nxt[i] = blk(h, None, cache.get(i, {}))
        h, nxt["mid"] = self.mid_block(h, None, cache.get("mid", {}))
        h, nxt["out"] = self.conv_out(F.silu(self.norm_out(h)), cache.get("out"))
        return h, nxt


class Decoder3D(nn.Module):
    def __init__(self, c: VAE3DConfig):
        super().__init__()
        ch, g, eps = tuple(reversed(c.block_out_channels)), c.norm_num_groups, c.norm_eps
        lat = c.latent_channels
        timed = int(math.log2(c.temporal_compression_ratio))
        self.conv_in = CausalConv3d(lat, ch[0])
        self.mid_block = _Block([ResnetBlock3D(ch[0], ch[0], g, eps, lat) for _ in range(2)])
        blocks, cout = [], ch[0]
        for i, co in enumerate(ch):
            cin, cout = cout, co
            res = [ResnetBlock3D(cin if j == 0 else cout, cout, g, eps, lat)
                   for j in range(c.layers_per_block + 1)]
            last = i == len(ch) - 1
            blocks.append(_Block(res, None if last else Upsample3D(cout, i < timed),
                                 "upsamplers"))
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = SpatialNorm3D(ch[-1], lat, g)
        self.conv_out = CausalConv3d(ch[-1], c.out_channels)

    @trace.spanned("vae3d.decoder")
    def forward(self, z, cache: dict):
        nxt = {}
        h, nxt["in"] = self.conv_in(z, cache.get("in"))
        h, nxt["mid"] = self.mid_block(h, z, cache.get("mid", {}))
        for i, blk in enumerate(self.up_blocks):
            h, nxt[i] = blk(h, z, cache.get(i, {}))
        h, nxt["out"] = self.conv_out(F.silu(self.norm_out(h, z)), cache.get("out"))
        return h, nxt


def frame_batches(n: int, size: int) -> List[Tuple[int, int]]:
    """[(start, end)] of ``n`` frames in batches of ``size``; the first takes
    the remainder."""
    rem = n % size
    return [(size * i + (rem if i else 0), size * (i + 1) + rem)
            for i in range(max(n // size, 1))]


class AutoencoderKLCogVideoX(nn.Module):
    def __init__(self, config: VAE3DConfig = VAE3DConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder3D(config)
        self.decoder = Decoder3D(config)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 3, F, H, W) in [-1, 1] → the posterior's (mean, logvar)."""
        cache: Dict = {}
        out = []
        for a, b in frame_batches(x.shape[2], self.config.encode_frame_batch):
            h, cache = self.encoder(x[:, :, a:b], cache)
            out.append(h)
        mean, logvar = torch.cat(out, dim=2).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, latent, F', h, w), already divided by the scaling factor →
        (B, 3, F, H, W)."""
        cache: Dict = {}
        out = []
        for a, b in frame_batches(z.shape[2], self.config.decode_latent_frame_batch):
            h, cache = self.decoder(z[:, :, a:b], cache)
            out.append(h)
        return torch.cat(out, dim=2)
