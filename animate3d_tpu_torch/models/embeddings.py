"""Embedding layers for the MV-VDM UNet (port of animate3d_tpu/models/embeddings.py)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from animate3d_tpu_torch.models.layers import LayerNorm, Linear


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0,
                           max_period: float = 10000.0) -> torch.Tensor:
    """(B,) → (B, embedding_dim) f32 sinusoidal features (diffusers Timesteps)."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if embedding_dim % 2 == 1:
        out = nn.functional.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    """linear → silu → linear (diffusers TimestepEmbedding; ``out_dim``, if
    given, is the second linear's width, else ``dim_out``)."""

    def __init__(self, in_dim: int, dim_out: int, out_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim_out)
        self.linear_2 = Linear(dim_out, out_dim or dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(nn.functional.silu(self.linear_1(x)))


def compose_frame_time_embeddings(emb: torch.Tensor,
                                  cond_emb: Optional[torch.Tensor],
                                  num_frames: int) -> torch.Tensor:
    """Per-frame embeddings, frame-minor; with ``cond_emb`` (the t=0
    i2v_cond_time_zero embedding) substituted on frame 0."""
    bn = emb.shape[0]
    out = emb.repeat_interleave(num_frames, dim=0)
    if cond_emb is not None:
        out = out.reshape(bn, num_frames, -1)
        out = torch.cat([cond_emb[:, None], out[:, 1:]], dim=1)
        out = out.reshape(bn * num_frames, -1)
    return out


def sinusoidal_positions(num_positions: int, dim: int,
                         device=None) -> torch.Tensor:
    """(num_positions, dim) transformer PE table: sin on even, cos on odd."""
    position = torch.arange(num_positions, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((num_positions, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def add_temporal_positional_embedding(x: torch.Tensor,
                                      max_seq_length: int = 32) -> torch.Tensor:
    """x (..., F, C) + PE[:F] — the temporal pos-embed of the motion blocks."""
    f, c = x.shape[-2], x.shape[-1]
    pe = sinusoidal_positions(max_seq_length, c, x.device)[:f]
    return x + pe.to(x.dtype)


def sine_positional_encoding_2d(h: int, w: int, num_feats: int,
                                temperature: float = 10000.0,
                                normalize: bool = True,
                                scale: float = 2 * math.pi,
                                eps: float = 1e-6, offset: float = 0.0,
                                device=None) -> torch.Tensor:
    """(h, w, 2*num_feats) DETR-style sine encoding, channels (y, x)."""
    f32 = torch.float32
    y_embed = torch.arange(1, h + 1, dtype=f32, device=device)[:, None].expand(h, w)
    x_embed = torch.arange(1, w + 1, dtype=f32, device=device)[None, :].expand(h, w)
    if normalize:
        y_embed = (y_embed + offset) / (y_embed[-1:, :] + eps) * scale
        x_embed = (x_embed + offset) / (x_embed[:, -1:] + eps) * scale
    dim_t = torch.arange(num_feats, dtype=f32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()],
                        dim=3).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=2)


class LearnedPositionalEncoding2D(nn.Module):
    """Row/col embedding tables → (h, w, 2*num_feats), channels (x, y)."""

    def __init__(self, num_feats: int, row_num_embed: int = 50,
                 col_num_embed: int = 50):
        super().__init__()
        self.row_embed = nn.Embedding(row_num_embed, num_feats)
        self.col_embed = nn.Embedding(col_num_embed, num_feats)

    def forward(self, h: int, w: int) -> torch.Tensor:
        col = self.col_embed.weight[:w]
        row = self.row_embed.weight[:h]
        x_embed = col[None].expand(h, w, -1)
        y_embed = row[:, None].expand(h, w, -1)
        return torch.cat([x_embed, y_embed], dim=-1)


class ImageProjection(nn.Module):
    """IP-Adapter: global image embed → num_tokens context tokens."""

    def __init__(self, image_embed_dim: int, cross_attention_dim: int = 768,
                 num_tokens: int = 4):
        super().__init__()
        self.num_tokens = num_tokens
        self.cross_attention_dim = cross_attention_dim
        self.image_embeds = Linear(image_embed_dim, num_tokens * cross_attention_dim)
        self.norm = LayerNorm(cross_attention_dim, eps=1e-5)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.image_embeds(image_embeds)
        x = x.reshape(x.shape[0], self.num_tokens, self.cross_attention_dim)
        return self.norm(x)
