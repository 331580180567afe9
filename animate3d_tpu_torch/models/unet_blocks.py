"""UNet building blocks (port of animate3d_tpu/models/unet_blocks.py).

Conv tensors here are NCHW, ``(B·N·F, C, H, W)``; the JAX package kept
them NHWC for the TPU. Token tensors are laid out as the JAX blocks lay
them out, per attention behaviour (see attention_layers.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from animate3d_tpu_torch.models.attention_layers import (
    CrossViewSelfAttention,
    FeedForwardGEGLU,
    SpatioTemporalAttention,
    TemporalSelfAttention,
    TextCrossAttention,
)
from animate3d_tpu_torch.models.embeddings import add_temporal_positional_embedding
from animate3d_tpu_torch.models.layers import Conv2d, GroupNorm, LayerNorm, Linear


@dataclass(frozen=True)
class MotionAttnConfig:
    """Motion-module attention behaviour (configs/inference/inference.yaml)."""

    enabled: bool = True
    spatial_attn: bool = True
    image_attn: bool = False
    use_alpha_blender: bool = True
    spatial_encoding: Optional[str] = "sinusoid"
    camera_encoding: Optional[str] = None


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D; ``eps`` is the norms' (1e-5 in the MV-VDM,
    1e-5 / 1e-6 by block in the SVD UNet)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(32, in_channels, eps=eps)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(32, out_channels, eps=eps)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        silu = nn.functional.silu
        h = self.conv1(silu(self.norm1(x)))
        h = h + self.time_emb_proj(silu(temb))[:, :, None, None]
        h = self.conv2(silu(self.norm2(h)))
        residual = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        return h + residual


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nn.functional.interpolate(x, scale_factor=2.0, mode="nearest"))


class SpatialTransformerBlock(nn.Module):
    """BasicTransformerBlock: cross-view attn1, text/IP attn2, GEGLU FF."""

    def __init__(self, channels: int, num_heads: int, num_views: int,
                 context_dim: int = 768, mv_image_attn: bool = True,
                 ip_enabled: bool = True, ip_scale: float = 1.0):
        super().__init__()
        self.norm1 = LayerNorm(channels, eps=1e-5)
        self.attn1 = CrossViewSelfAttention(channels, num_heads, num_views,
                                            image_attn=mv_image_attn)
        self.norm2 = LayerNorm(channels, eps=1e-5)
        self.attn2 = TextCrossAttention(channels, num_heads, context_dim,
                                        ip_enabled=ip_enabled, ip_scale=ip_scale)
        self.norm3 = LayerNorm(channels, eps=1e-5)
        self.ff = FeedForwardGEGLU(channels)

    def forward(self, x, context, ip_context, num_frames: int):
        x = x + self.attn1(self.norm1(x), num_frames)
        x = x + self.attn2(self.norm2(x), context, ip_context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Transformer2DModel with conv projections, on NCHW input."""

    def __init__(self, channels: int, num_heads: int, num_views: int,
                 context_dim: int = 768, mv_image_attn: bool = True,
                 ip_enabled: bool = True, ip_scale: float = 1.0):
        super().__init__()
        self.norm = GroupNorm(32, channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([SpatialTransformerBlock(
            channels, num_heads, num_views, context_dim, mv_image_attn,
            ip_enabled, ip_scale)])
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x, context, ip_context, num_frames: int):
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self.transformer_blocks[0](h, context, ip_context, num_frames)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


class MotionTransformerBlock(nn.Module):
    """Temporal BasicTransformerBlock with two self-attentions."""

    def __init__(self, channels: int, num_heads: int, num_views: int,
                 attn_cfg: MotionAttnConfig, max_seq_length: int = 32,
                 spatial_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        cfg = attn_cfg
        self.max_seq_length = max_seq_length
        self.use_st = cfg.enabled and (cfg.spatial_attn or cfg.image_attn)
        # the block-level temporal PE is nulled when the spatiotemporal
        # attention re-applies it internally (reference inference.py:177-192)
        self.extra_enc = cfg.enabled and cfg.spatial_attn and (
            cfg.spatial_encoding is not None or cfg.camera_encoding is not None)

        def attn():
            if self.use_st:
                return SpatioTemporalAttention(
                    channels, num_heads, num_views,
                    spatial_attn=cfg.spatial_attn, image_attn=cfg.image_attn,
                    use_alpha_blender=cfg.use_alpha_blender,
                    spatial_encoding=cfg.spatial_encoding if cfg.spatial_attn else None,
                    camera_encoding=cfg.camera_encoding if cfg.spatial_attn else None,
                    max_seq_length=max_seq_length, spatial_size=spatial_size)
            return TemporalSelfAttention(channels, num_heads)

        self.norm1 = LayerNorm(channels, eps=1e-5)
        self.attn1 = attn()
        self.norm2 = LayerNorm(channels, eps=1e-5)
        self.attn2 = attn()
        self.norm3 = LayerNorm(channels, eps=1e-5)
        self.ff = FeedForwardGEGLU(channels)

    def _pe(self, h: torch.Tensor) -> torch.Tensor:
        return h if self.extra_enc else add_temporal_positional_embedding(
            h, self.max_seq_length)

    def forward(self, x: torch.Tensor, height: int, width: int) -> torch.Tensor:
        for norm, attn in ((self.norm1, self.attn1), (self.norm2, self.attn2)):
            h = self._pe(norm(x))
            x = x + (attn(h, height, width) if self.use_st else attn(h))
        return x + self.ff(self.norm3(x))


class MotionModule(nn.Module):
    """TransformerTemporalModel over the frame axis: input (B·N·F, C, H, W),
    group-norm statistics over (F, H, W) per sample, tokens (B·N·H·W, F, C).
    ``spatial_size`` is the (H, W) the learnable spatial encoding's tables
    are sized for."""

    def __init__(self, channels: int, num_heads: int, num_views: int,
                 attn_cfg: MotionAttnConfig, max_seq_length: int = 32,
                 spatial_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.norm = GroupNorm(32, channels, eps=1e-6)
        self.proj_in = Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([MotionTransformerBlock(
            channels, num_heads, num_views, attn_cfg, max_seq_length, spatial_size)])
        self.proj_out = Linear(channels, channels)

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        bnf, c, hh, ww = x.shape
        f = num_frames
        bn = bnf // f
        h = self.norm(x.reshape(bn, f, c, hh, ww).transpose(1, 2))  # (bn, c, f, h, w)
        h = h.permute(0, 3, 4, 2, 1).reshape(bn * hh * ww, f, c)
        h = self.proj_in(h)
        h = self.transformer_blocks[0](h, hh, ww)
        h = self.proj_out(h)
        h = h.reshape(bn, hh, ww, f, c).permute(0, 3, 4, 1, 2).reshape(bnf, c, hh, ww)
        return h + x
