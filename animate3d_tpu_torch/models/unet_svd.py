"""Stable Video Diffusion's spatio-temporal UNet (image-to-video).

diffusers' ``UNetSpatioTemporalConditionModel`` as released with
``stabilityai/stable-video-diffusion-img2vid-xt`` (``unet/config.json``),
with its parameter names, so the released state dict loads as it is
(``convert/weights.py``). The JAX package has no such model. Layout:
latents ``(B, F, C, h, w)`` as diffusers takes them; inside, NCHW
``(B·F, C, h, w)``, and ``(B, C, F, h, w)`` for the temporal convolutions.

Every block pairs a spatial layer with a temporal one, merged by a learned
:class:`~animate3d_tpu_torch.models.attention_layers.AlphaBlender`:

* :class:`SpatioTemporalResBlock`: the SD ResNet block over each frame,
  then :class:`TemporalResnetBlock` (GroupNorm over (C/G, F, h, w), SiLU,
  Conv3d with kernel (3, 1, 1) over the frames, the time embedding);
* :class:`TransformerSpatioTemporalModel`: GroupNorm, a linear
  ``proj_in``, a spatial transformer block (self-attention over the
  frame's tokens, cross-attention to the one CLIP image token, GEGLU),
  then, with a frame-index embedding added, a temporal block over the
  frames (``ff_in``, self-attention, cross-attention to the first frame's
  image token, GEGLU), a linear ``proj_out`` and the residual.

Heads are 64 wide at every level (5 / 10 / 20 / 20 of them). The routes
(``ops/attention.py``): spatial self-attention through kernel A, the
25-frame temporal self-attention through kernel B's padded sequences, the
cross-attention to a single token as the value projection itself (a
softmax over one key is exactly 1), the feed-forwards through kernel C.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from animate3d_tpu_torch.models.attention_layers import AlphaBlender, FeedForwardGEGLU
from animate3d_tpu_torch.models.embeddings import TimestepEmbedding, get_timestep_embedding
from animate3d_tpu_torch.models.layers import Conv2d, Conv3d, GroupNorm, LayerNorm, Linear
from animate3d_tpu_torch.models.unet_blocks import Downsample2D, ResnetBlock2D, Upsample2D
from animate3d_tpu_torch.ops.attention import one_key_attention, video_attention
from animate3d_tpu_torch.utils import trace


@dataclass(frozen=True)
class SVDUNetConfig:
    """``unet/config.json`` of the released SVD-XT; the first
    ``len(block_out_channels) - 1`` levels carry attention, the last not."""

    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    num_frames: int = 25
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768

    @staticmethod
    def tiny(**kw) -> "SVDUNetConfig":
        d = dict(block_out_channels=(32, 64), num_attention_heads=(2, 4),
                 cross_attention_dim=32, num_frames=5, addition_time_embed_dim=8,
                 projection_class_embeddings_input_dim=24)
        d.update(kw)
        return SVDUNetConfig(**d)


def frames_5d(x: torch.Tensor, num_frames: int) -> torch.Tensor:
    """(B·F, C, h, w) → (B, C, F, h, w), contiguous."""
    bf, c, hh, ww = x.shape
    return x.reshape(bf // num_frames, num_frames, c, hh, ww).transpose(1, 2).contiguous()


def frames_4d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, F, h, w) → (B·F, C, h, w), contiguous."""
    b, c, f, hh, ww = x.shape
    return x.transpose(1, 2).reshape(b * f, c, hh, ww)


class TemporalResnetBlock(nn.Module):
    """diffusers TemporalResnetBlock on (B, C, F, h, w): GroupNorm, SiLU,
    Conv3d (3, 1, 1), the per-frame time embedding (``temb`` (B, F, T), or
    None where the block has none), GroupNorm, SiLU, Conv3d, residual."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 eps: float):
        super().__init__()
        self.norm1 = GroupNorm(32, in_channels, eps=eps)
        self.conv1 = Conv3d(in_channels, out_channels, (3, 1, 1), padding=(1, 0, 0))
        if temb_channels is not None:
            self.time_emb_proj = Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(32, out_channels, eps=eps)
        self.conv2 = Conv3d(out_channels, out_channels, (3, 1, 1), padding=(1, 0, 0))
        if in_channels != out_channels:
            self.conv_shortcut = Conv3d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        silu = nn.functional.silu
        h = self.conv1(silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(silu(temb)).transpose(1, 2)[:, :, :, None, None]
        h = self.conv2(silu(self.norm2(h)))
        residual = self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x
        return h + residual


class SpatioTemporalResBlock(nn.Module):
    """diffusers SpatioTemporalResBlock: ``spatial_res_block`` on each frame
    (a :class:`ResnetBlock2D`, or ``spatial`` given: the VAE's), then
    ``temporal_res_block`` over the frames, merged by ``time_mixer``
    (blender with the switch: (1 - alpha) spatial + alpha temporal)."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 eps: float, temporal_eps: Optional[float] = None, mix: float = 0.5,
                 spatial: Optional[nn.Module] = None):
        super().__init__()
        self.spatial_res_block = spatial or ResnetBlock2D(in_channels, out_channels,
                                                          temb_channels, eps=eps)
        self.temporal_res_block = TemporalResnetBlock(
            out_channels, out_channels, temb_channels,
            eps if temporal_eps is None else temporal_eps)
        self.time_mixer = AlphaBlender(mix, switch=True)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                image_only: torch.Tensor) -> torch.Tensor:
        f = image_only.shape[1]
        h = self.spatial_res_block(x, temb) if temb is not None else self.spatial_res_block(x)
        hs = frames_5d(h, f)
        t5 = None if temb is None else temb.reshape(hs.shape[0], f, -1)
        with trace.span("unet.temporal_res"):
            ht = self.temporal_res_block(hs, t5)
            out = self.time_mixer(hs, ht, image_only[:, None, :, None, None])
        return frames_4d(out)


class VideoAttention(nn.Module):
    """diffusers ``Attention`` as the SVD UNet uses it: q / k / v bias-free,
    ``to_out.0`` biased, heads 64 wide; self-attention through
    :func:`~animate3d_tpu_torch.ops.attention.video_attention`. With a
    one-token ``context`` the result is ``to_out(to_v(context))`` once a
    batch (:func:`~animate3d_tpu_torch.ops.attention.one_key_attention`),
    shape (B, 1, C), for the caller to add over its queries."""

    def __init__(self, channels: int, num_heads: int, context_dim: Optional[int] = None):
        super().__init__()
        c, kv = channels, context_dim or channels
        self.num_heads = num_heads
        self.to_q = Linear(c, c, bias=False)
        self.to_k = Linear(kv, c, bias=False)
        self.to_v = Linear(kv, c, bias=False)
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        h = video_attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.num_heads)
        return self.to_out[0](h)

    def one_key(self, context: torch.Tensor) -> torch.Tensor:
        """The output for every query of each batch against its one-token
        ``context`` (B, 1, D), as (B, 1, C): ``to_out(to_v(context))``; the
        queries (and so the norm before them) do not enter."""
        return self.to_out[0](one_key_attention(self.to_v(context)))


def cross_attend(attn: VideoAttention, norm: nn.Module, x: torch.Tensor,
                 context: torch.Tensor) -> torch.Tensor:
    """``attn(norm(x), context)`` of x (B, L, C), as (B, 1, C) where the
    context is one token (each batch's queries all get the same vector)."""
    if context.shape[1] == 1:
        return attn.one_key(context)
    return attn(norm(x), context)


class BasicTransformerBlock(nn.Module):
    """The spatial block: self-attention over a frame's tokens,
    cross-attention to the frame's image token, GEGLU feed-forward, each
    after a LayerNorm and residual."""

    def __init__(self, channels: int, num_heads: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(channels, eps=1e-5)
        self.attn1 = VideoAttention(channels, num_heads)
        self.norm2 = LayerNorm(channels, eps=1e-5)
        self.attn2 = VideoAttention(channels, num_heads, context_dim)
        self.norm3 = LayerNorm(channels, eps=1e-5)
        self.ff = FeedForwardGEGLU(channels)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + cross_attend(self.attn2, self.norm2, x, context)
        return x + self.ff(self.norm3(x))


class TemporalBasicTransformerBlock(nn.Module):
    """The temporal block on (B·F, L, C) tokens, run over frames as
    (B·L, F, C): ``ff_in`` (GEGLU, residual), self-attention, cross-attention
    to the first frame's image token (``time_context`` (B, 1, D)), GEGLU."""

    def __init__(self, channels: int, num_heads: int, context_dim: int):
        super().__init__()
        self.norm_in = LayerNorm(channels, eps=1e-5)
        self.ff_in = FeedForwardGEGLU(channels)
        self.norm1 = LayerNorm(channels, eps=1e-5)
        self.attn1 = VideoAttention(channels, num_heads)
        self.norm2 = LayerNorm(channels, eps=1e-5)
        self.attn2 = VideoAttention(channels, num_heads, context_dim)
        self.norm3 = LayerNorm(channels, eps=1e-5)
        self.ff = FeedForwardGEGLU(channels)

    def forward(self, x: torch.Tensor, num_frames: int,
                time_context: torch.Tensor) -> torch.Tensor:
        bf, l, c = x.shape
        b, f = bf // num_frames, num_frames
        h = x.reshape(b, f, l, c).transpose(1, 2).reshape(b * l, f, c)
        h = self.ff_in(self.norm_in(h)) + h
        h = self.attn1(self.norm1(h)) + h
        # the first frame's token: one (B, 1, C) vector over each batch's L·F tokens
        hb = h.reshape(b, l * f, c)
        h = (hb + cross_attend(self.attn2, self.norm2, hb, time_context)).reshape(b * l, f, c)
        h = self.ff(self.norm3(h)) + h
        return h.reshape(b, l, f, c).transpose(1, 2).reshape(bf, l, c)


class TransformerSpatioTemporalModel(nn.Module):
    """GroupNorm, linear ``proj_in``, the spatial block, the frame-index
    embedding (``time_pos_embed``) and the temporal block merged by
    ``time_mixer`` (alpha spatial + (1 - alpha) temporal), ``proj_out``,
    residual."""

    def __init__(self, channels: int, num_heads: int, context_dim: int):
        super().__init__()
        c = channels
        self.norm = GroupNorm(32, c, eps=1e-6)
        self.proj_in = Linear(c, c)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(c, num_heads,
                                                                       context_dim)])
        self.temporal_transformer_blocks = nn.ModuleList([TemporalBasicTransformerBlock(
            c, num_heads, context_dim)])
        self.time_pos_embed = TimestepEmbedding(c, 4 * c, out_dim=c)
        self.time_mixer = AlphaBlender(0.5)
        self.proj_out = Linear(c, c)

    def forward(self, x: torch.Tensor, context: torch.Tensor, time_context: torch.Tensor,
                image_only: torch.Tensor) -> torch.Tensor:
        bf, c, hh, ww = x.shape
        b, f = image_only.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(bf, hh * ww, c)
        h = self.proj_in(h)
        frames = torch.arange(f, device=x.device).repeat(b)
        emb = self.time_pos_embed(get_timestep_embedding(frames, c).to(h.dtype))[:, None, :]
        h = self.transformer_blocks[0](h, context)
        with trace.span("unet.temporal_transformer"):
            hm = self.temporal_transformer_blocks[0](h + emb, f, time_context)
            h = self.time_mixer(h, hm, image_only.reshape(-1)[:, None, None])
        h = self.proj_out(h)
        return h.reshape(bf, hh, ww, c).permute(0, 3, 1, 2) + x


class _Block(nn.Module):
    def __init__(self, resnets, attentions=None, sampler_name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class SVDUNet(nn.Module):
    """``UNetSpatioTemporalConditionModel``: (B, F, 8, h, w) noisy latents ⊕
    image latents, a timestep (the EDM ``0.25 ln sigma``), the image
    embedding (B, 1, D) and the added time ids (B, 3) → (B, F, 4, h, w)."""

    def __init__(self, config: SVDUNetConfig = SVDUNetConfig()):
        super().__init__()
        self.config = cfg = config
        boc, heads, ctx = cfg.block_out_channels, cfg.num_attention_heads, cfg.cross_attention_dim
        ted = 4 * boc[0]
        n = len(boc)
        self.conv_in = Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], ted)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, ted)

        def res(cin, cout, eps):
            return SpatioTemporalResBlock(cin, cout, ted, eps)

        self.down_blocks = nn.ModuleList()
        ch = boc[0]
        for i, out in enumerate(boc):
            attn = i < n - 1  # CrossAttnDownBlockSpatioTemporal, then DownBlockSpatioTemporal
            eps = 1e-6 if attn else 1e-5
            resnets = [res(ch if j == 0 else out, out, eps) for j in range(cfg.layers_per_block)]
            attns = [TransformerSpatioTemporalModel(out, heads[i], ctx)
                     for _ in range(cfg.layers_per_block)] if attn else None
            down = Downsample2D(out) if i < n - 1 else None
            self.down_blocks.append(_Block(resnets, attns, "downsamplers", down))
            ch = out

        self.mid_block = _Block([res(ch, ch, 1e-5), res(ch, ch, 1e-5)],
                                [TransformerSpatioTemporalModel(ch, heads[-1], ctx)])

        rev, rheads = list(reversed(boc)), list(reversed(heads))
        self.up_blocks = nn.ModuleList()
        for i, out in enumerate(rev):
            prev, cin = ch, rev[min(i + 1, n - 1)]
            attn = i > 0  # UpBlockSpatioTemporal, then CrossAttnUpBlockSpatioTemporal
            resnets = []
            for j in range(cfg.layers_per_block + 1):
                skip = cin if j == cfg.layers_per_block else out
                resnets.append(res((prev if j == 0 else out) + skip, out, 1e-5))
            attns = [TransformerSpatioTemporalModel(out, rheads[i], ctx)
                     for _ in range(cfg.layers_per_block + 1)] if attn else None
            up = Upsample2D(out) if i < n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, "upsamplers", up))
            ch = out

        self.conv_norm_out = GroupNorm(32, boc[0], eps=1e-5)
        self.conv_out = Conv2d(boc[0], cfg.out_channels, 3, padding=1)

    @trace.spanned("svd_unet.forward")
    def forward(self, sample: torch.Tensor, timestep, encoder_hidden_states: torch.Tensor,
                added_time_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, f, c_in, hh, ww = sample.shape
        dtype, dev = self.conv_in.weight.dtype, self.conv_in.weight.device
        boc = cfg.block_out_channels

        # a host number fills on the card (an upload would wait on it)
        ts = (timestep.to(dev).reshape(-1).expand(b) if torch.is_tensor(timestep)
              else torch.full((b,), float(timestep), device=dev))
        emb = self.time_embedding(get_timestep_embedding(ts, boc[0]).to(dtype))
        ids = get_timestep_embedding(added_time_ids.reshape(-1), cfg.addition_time_embed_dim)
        emb = emb + self.add_embedding(ids.reshape(b, -1).to(dtype))
        emb = emb.repeat_interleave(f, dim=0)
        time_context = encoder_hidden_states.to(dtype)  # (B, 1, D): the first frame's
        context = time_context.repeat_interleave(f, dim=0)
        image_only = torch.zeros((b, f), dtype=dtype, device=dev)

        x = self.conv_in(sample.reshape(b * f, c_in, hh, ww).to(dtype))
        skips = [x]
        for blk in self.down_blocks:
            for j, resnet in enumerate(blk.resnets):
                x = resnet(x, emb, image_only)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, context, time_context, image_only)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, emb, image_only)
        x = mid.attentions[0](x, context, time_context, image_only)
        x = mid.resnets[1](x, emb, image_only)

        for blk in self.up_blocks:
            for j, resnet in enumerate(blk.resnets):
                x = resnet(torch.cat([x, skips.pop()], dim=1), emb, image_only)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, context, time_context, image_only)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = self.conv_out(nn.functional.silu(self.conv_norm_out(x)))
        return x.reshape(b, f, cfg.out_channels, hh, ww)
