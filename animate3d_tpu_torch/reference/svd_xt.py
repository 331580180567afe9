"""Plain reference of Stable Video Diffusion XT image-to-video.

Written from the published description (Blattmann et al., arXiv:2311.15127)
and the released configs of ``stabilityai/stable-video-diffusion-img2vid-xt``
(``unet/config.json``, ``vae/config.json``, ``image_encoder/config.json``,
``scheduler/scheduler_config.json``) with diffusers' module and parameter
names, in plain ``torch`` and float32. It imports nothing but ``torch``:
no module of the port, of JAX or of the JAX package. Set
``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn.allow_tf32``
False before running it on a card (:func:`full_precision`).

It covers the spatio-temporal UNet, the SD VAE encoder with the temporal
decoder, the CLIP ViT-H/14 image encoder, the Euler-EDM scheduler and the
sampling request (conditioning, CFG ramp, steps, decode).

Departures from the release, each deliberate:

* the CLIP image preprocessing resizes with an antialiased triangle
  (bilinear) filter, as the port's other image towers do, where diffusers
  blurs with a Gaussian and resizes bicubically (``_resize_with_antialiasing``);
* the GroupNorm / LayerNorm epsilons and the blenders' initial mixes are
  the diffusers defaults as best known, not read from the release's code
  (the configuration file lists them under ``assumed``);
* attention is computed whole, per head, in float32 (no fused or memory-
  efficient kernel), in slices of the batch so that the scores fit;
* everything is float32, where the release samples in float16.

``q`` is the precision hook: every operand of the UNet's products and
convolutions passes through it (the identity, in float32, here).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F


def q(x: torch.Tensor) -> torch.Tensor:
    """The UNet's product operands as computed: float32."""
    return x.float()


def full_precision() -> None:
    """Full float32 products and convolutions on a card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- configurations -----------------------------------------------------------------

@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    num_frames: int = 25
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclass(frozen=True)
class VisionConfig:
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"


# -- layers --------------------------------------------------------------------------

class Linear(nn.Linear):
    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.linear(q(x), q(self.weight), b)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return self._conv_forward(q(x), q(self.weight), b)


class Conv3d(nn.Conv3d):
    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return self._conv_forward(q(x), q(self.weight), b)


def attention(qx: torch.Tensor, kx: torch.Tensor, vx: torch.Tensor, heads: int,
              quantise: bool = True, score_bytes: int = 1 << 30) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v per head, q (B, Sq, C), k / v (B, Sk, C),
    in float32, in batch slices of at most ``score_bytes`` of scores. With
    ``quantise`` the operands pass through :func:`q` (the UNet's)."""
    b, sq, c = qx.shape
    sk, d = kx.shape[1], c // heads
    cast = q if quantise else (lambda t: t.float())
    step = max(1, score_bytes // (4 * heads * sq * sk))
    out = []
    for i in range(0, b, step):
        split = lambda t: t[i:i + step].reshape(t[i:i + step].shape[0], -1, heads, d
                                                ).transpose(1, 2)
        qh, kh, vh = (cast(split(t)) for t in (qx, kx, vx))
        p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * d ** -0.5, dim=-1)
        o = torch.matmul(cast(p), vh)
        out.append(o.transpose(1, 2).reshape(o.shape[0], sq, c))
    return torch.cat(out)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``Timesteps(dim, flip_sin_to_cos=True, downscale_freq_shift=0)``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    arg = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, hidden: int, cout: Optional[int] = None):
        super().__init__()
        self.linear_1 = Linear(cin, hidden)
        self.linear_2 = Linear(hidden, cout or hidden)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class _Proj(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = Linear(cin, cout)


class FeedForward(nn.Module):
    """GEGLU: (x W_h + b_h) * gelu(x W_g + b_g), then the output linear."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([_Proj(dim, 2 * mult * dim), nn.Identity(),
                                  Linear(mult * dim, dim)])

    def forward(self, x):
        h, g = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * F.gelu(g))


class AlphaBlender(nn.Module):
    """alpha = sigmoid(mix_factor) ("learned"), 1 on image-only frames
    ("learned_with_images"); with ``switch``, 1 - alpha; then
    alpha x_spatial + (1 - alpha) x_temporal."""

    def __init__(self, switch: bool, with_images: bool):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.zeros(1))
        self.switch, self.with_images = switch, with_images

    def forward(self, x_spatial, x_temporal, image_only):
        alpha = torch.sigmoid(self.mix_factor.float())
        if self.with_images:
            alpha = torch.where(image_only.bool(), torch.ones_like(image_only), alpha)
        if self.switch:
            alpha = 1.0 - alpha
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], eps: float,
                 conv=Conv2d):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=eps)
        self.conv1 = conv(cin, cout, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2 = nn.GroupNorm(32, cout, eps=eps)
        self.conv2 = conv(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = conv(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x)


class TemporalResnetBlock(nn.Module):
    """GroupNorm over (C / 32, F, H, W), SiLU, Conv3d (3, 1, 1), the frame's
    time embedding, GroupNorm, SiLU, Conv3d (3, 1, 1), residual; on
    (B, C, F, H, W)."""

    def __init__(self, c: int, temb: Optional[int], eps: float, conv=Conv3d):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, c, eps=eps)
        self.conv1 = conv(c, c, (3, 1, 1), padding=(1, 0, 0))
        if temb is not None:
            self.time_emb_proj = Linear(temb, c)
        self.norm2 = nn.GroupNorm(32, c, eps=eps)
        self.conv2 = conv(c, c, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb)).permute(0, 2, 1)[:, :, :, None, None]
        return self.conv2(F.silu(self.norm2(h))) + x


class SpatioTemporalResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], eps: float,
                 temporal_eps: float, with_images: bool, conv2d=Conv2d, conv3d=Conv3d):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb, eps, conv2d)
        self.temporal_res_block = TemporalResnetBlock(cout, temb, temporal_eps, conv3d)
        self.time_mixer = AlphaBlender(switch=True, with_images=with_images)

    def forward(self, x, temb, image_only):
        f = image_only.shape[1]
        h = self.spatial_res_block(x, temb)
        bf, c, hh, ww = h.shape
        h5 = h.reshape(bf // f, f, c, hh, ww).permute(0, 2, 1, 3, 4)
        t5 = None if temb is None else temb.reshape(bf // f, f, -1)
        out = self.time_mixer(h5, self.temporal_res_block(h5, t5),
                              image_only[:, None, :, None, None].float())
        return out.permute(0, 2, 1, 3, 4).reshape(bf, c, hh, ww)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None,
                 qkv_bias: bool = False, lin=Linear):
        super().__init__()
        self.heads = heads
        kv = context_dim or dim
        self.to_q = lin(dim, dim, bias=qkv_bias)
        self.to_k = lin(kv, dim, bias=qkv_bias)
        self.to_v = lin(kv, dim, bias=qkv_bias)
        self.to_out = nn.ModuleList([lin(dim, dim)])

    def forward(self, x, context=None, quantise=True):
        ctx = x if context is None else context
        h = attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads, quantise)
        return self.to_out[0](h)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class TemporalBasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, num_frames, time_context):
        """x (B·F, L, C); time_context (B·L, 1, D)."""
        bf, l, c = x.shape
        b = bf // num_frames
        h = x.reshape(b, num_frames, l, c).permute(0, 2, 1, 3).reshape(b * l, num_frames, c)
        h = self.ff_in(self.norm_in(h)) + h
        h = self.attn1(self.norm1(h)) + h
        h = self.attn2(self.norm2(h), time_context) + h
        h = self.ff(self.norm3(h)) + h
        return h.reshape(b, l, num_frames, c).permute(0, 2, 1, 3).reshape(bf, l, c)


class TransformerSpatioTemporalModel(nn.Module):
    def __init__(self, c: int, heads: int, context_dim: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, c, eps=1e-6)
        self.proj_in = Linear(c, c)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(c, heads, context_dim)])
        self.temporal_transformer_blocks = nn.ModuleList([
            TemporalBasicTransformerBlock(c, heads, context_dim)])
        self.time_pos_embed = TimestepEmbedding(c, 4 * c, c)
        self.time_mixer = AlphaBlender(switch=False, with_images=True)
        self.proj_out = Linear(c, c)

    def forward(self, x, context, image_only):
        """x (B·F, C, H, W); context (B·F, 1, D), frame-major within a batch."""
        bf, c, hh, ww = x.shape
        b, f = image_only.shape
        # the temporal cross-attention's context: each batch's first frame's,
        # for every spatial position
        tc = context.reshape(b, f, -1, context.shape[-1])[:, 0]
        tc = tc[:, None].expand(b, hh * ww, tc.shape[1], tc.shape[2]).reshape(
            b * hh * ww, tc.shape[1], tc.shape[2])
        h = self.norm(x).permute(0, 2, 3, 1).reshape(bf, hh * ww, c)
        h = self.proj_in(h)
        frames = torch.arange(f, device=x.device).repeat(b)
        emb = self.time_pos_embed(timestep_embedding(frames, c))[:, None, :]
        h = self.transformer_blocks[0](h, context)
        hm = self.temporal_transformer_blocks[0](h + emb, f, tc)
        h = self.time_mixer(h, hm, image_only.reshape(-1)[:, None, None].float())
        h = self.proj_out(h)
        return h.reshape(bf, hh, ww, c).permute(0, 3, 1, 2) + x


class _Sampler(nn.Module):
    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


class _Block(nn.Module):
    def __init__(self, resnets, attentions=None, name=None, sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if sampler is not None:
            setattr(self, name, nn.ModuleList([_Sampler(sampler)]))


class UNet(nn.Module):
    """UNetSpatioTemporalConditionModel: (B, F, 8, H, W), a timestep, the
    image embedding (B, 1, D) and the added time ids (B, 3) → (B, F, 4, H, W)."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        boc, heads, ctx = cfg.block_out_channels, cfg.num_attention_heads, cfg.cross_attention_dim
        ted, n, lpb = 4 * boc[0], len(boc), cfg.layers_per_block
        self.conv_in = Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], ted)
        self.add_embedding = TimestepEmbedding(cfg.projection_class_embeddings_input_dim, ted)

        def res(cin, cout, eps):
            return SpatioTemporalResBlock(cin, cout, ted, eps, eps, True)

        self.down_blocks = nn.ModuleList()
        ch = boc[0]
        for i, out in enumerate(boc):
            cross = i < n - 1
            eps = 1e-6 if cross else 1e-5
            self.down_blocks.append(_Block(
                [res(ch if j == 0 else out, out, eps) for j in range(lpb)],
                [TransformerSpatioTemporalModel(out, heads[i], ctx) for _ in range(lpb)]
                if cross else None,
                "downsamplers", Conv2d(out, out, 3, stride=2, padding=1) if i < n - 1 else None))
            ch = out
        self.mid_block = _Block([res(ch, ch, 1e-5), res(ch, ch, 1e-5)],
                                [TransformerSpatioTemporalModel(ch, heads[-1], ctx)])
        rev, rheads = list(reversed(boc)), list(reversed(heads))
        self.up_blocks = nn.ModuleList()
        for i, out in enumerate(rev):
            prev, skip_last = ch, rev[min(i + 1, n - 1)]
            resnets = [res((prev if j == 0 else out) + (skip_last if j == lpb else out), out, 1e-5)
                       for j in range(lpb + 1)]
            self.up_blocks.append(_Block(
                resnets,
                [TransformerSpatioTemporalModel(out, rheads[i], ctx) for _ in range(lpb + 1)]
                if i > 0 else None,
                "upsamplers", Conv2d(out, out, 3, padding=1) if i < n - 1 else None))
            ch = out
        self.conv_norm_out = nn.GroupNorm(32, boc[0], eps=1e-5)
        self.conv_out = Conv2d(boc[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample, timestep, encoder_hidden_states, added_time_ids):
        cfg = self.cfg
        b, f = sample.shape[:2]
        t = torch.as_tensor(timestep, dtype=torch.float32, device=sample.device).reshape(-1)
        emb = self.time_embedding(timestep_embedding(t.expand(b), cfg.block_out_channels[0]))
        ids = timestep_embedding(added_time_ids.flatten(), cfg.addition_time_embed_dim)
        emb = emb + self.add_embedding(ids.reshape(b, -1))
        emb = emb.repeat_interleave(f, dim=0)
        context = encoder_hidden_states.float().repeat_interleave(f, dim=0)
        image_only = torch.zeros((b, f), device=sample.device)
        x = self.conv_in(sample.flatten(0, 1).float())
        skips = [x]
        for blk in self.down_blocks:
            for j, r in enumerate(blk.resnets):
                x = r(x, emb, image_only)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, context, image_only)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0].conv(x)
                skips.append(x)
        m = self.mid_block
        x = m.resnets[1](m.attentions[0](m.resnets[0](x, emb, image_only), context, image_only),
                         emb, image_only)
        for blk in self.up_blocks:
            for j, r in enumerate(blk.resnets):
                x = r(torch.cat([x, skips.pop()], dim=1), emb, image_only)
                if hasattr(blk, "attentions"):
                    x = blk.attentions[j](x, context, image_only)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0].conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.reshape((b, f) + x.shape[1:])


# -- the VAE: SD encoder, temporal decoder ----------------------------------------------

class _VAEAttention(nn.Module):
    """The single-head attention of the VAE's mid blocks, group-normed,
    biased, residual."""

    def __init__(self, c: int, g: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(g, c, eps=1e-6)
        self.to_q, self.to_k, self.to_v = nn.Linear(c, c), nn.Linear(c, c), nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        b, c, hh, ww = x.shape
        y = self.group_norm(x).reshape(b, c, hh * ww).transpose(1, 2)
        o = attention(self.to_q(y), self.to_k(y), self.to_v(y), 1, quantise=False)
        return self.to_out[0](o).transpose(1, 2).reshape(b, c, hh, ww) + x


class _VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int, g: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(g, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = nn.GroupNorm(g, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return h + (self.conv_shortcut(x) if hasattr(self, "conv_shortcut") else x)


class _Mid(nn.Module):
    def __init__(self, resnets, attn):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList([attn])


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = boc[0]
        for i, out in enumerate(boc):
            resnets = [_VAEResnet(ch if j == 0 else out, out, g)
                       for j in range(cfg.layers_per_block)]
            ch = out
            self.down_blocks.append(_Block(resnets, None, "downsamplers",
                                           nn.Conv2d(ch, ch, 3, stride=2)
                                           if i < len(boc) - 1 else None))
        self.mid_block = _Mid([_VAEResnet(ch, ch, g), _VAEResnet(ch, ch, g)],
                              _VAEAttention(ch, g))
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, "downsamplers"):  # pad (0, 1) on each spatial axis, stride 2
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        m = self.mid_block
        h = m.resnets[1](m.attentions[0](m.resnets[0](h)))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class _DecoderRes(nn.Module):
    """SpatioTemporalResBlock of the temporal decoder: the VAE's ResNet
    block (eps 1e-6), a temporal ResNet block (eps 1e-5, no time
    embedding), the learned blend with the switch."""

    def __init__(self, cin: int, cout: int, g: int):
        super().__init__()
        self.spatial_res_block = _VAEResnet(cin, cout, g)
        self.temporal_res_block = TemporalResnetBlock(cout, None, 1e-5, nn.Conv3d)
        self.time_mixer = AlphaBlender(switch=True, with_images=False)

    def forward(self, x, num_frames):
        h = self.spatial_res_block(x)
        bf, c, hh, ww = h.shape
        h5 = h.reshape(bf // num_frames, num_frames, c, hh, ww).permute(0, 2, 1, 3, 4)
        out = self.time_mixer(h5, self.temporal_res_block(h5, None), None)
        return out.permute(0, 2, 1, 3, 4).reshape(bf, c, hh, ww)


class TemporalDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _Mid([_DecoderRes(rev[0], rev[0], g), _DecoderRes(rev[0], rev[0], g)],
                              _VAEAttention(rev[0], g))
        self.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, out in enumerate(rev):
            resnets = [_DecoderRes(ch if j == 0 else out, out, g)
                       for j in range(cfg.layers_per_block + 1)]
            ch = out
            self.up_blocks.append(_Block(resnets, None, "upsamplers",
                                         nn.Conv2d(ch, ch, 3, padding=1)
                                         if i < len(rev) - 1 else None))
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)
        self.time_conv_out = nn.Conv3d(cfg.out_channels, cfg.out_channels, (3, 1, 1),
                                       padding=(1, 0, 0))

    def forward(self, z, num_frames):
        m = self.mid_block
        h = m.resnets[0](self.conv_in(z), num_frames)
        h = m.resnets[1](m.attentions[0](h), num_frames)
        for blk in self.up_blocks:
            for r in blk.resnets:
                h = r(h, num_frames)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2.0, mode="nearest"))
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        bf, c, hh, ww = h.shape
        h5 = h.reshape(bf // num_frames, num_frames, c, hh, ww).permute(0, 2, 1, 3, 4)
        return self.time_conv_out(h5).permute(0, 2, 1, 3, 4).reshape(bf, c, hh, ww)


class AutoencoderKLTemporalDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)
        self.decoder = TemporalDecoder(cfg)

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, 3, H, W) in [-1, 1] → the posterior's mean (N, 4, h, w)."""
        return self.quant_conv(self.encoder(x)).chunk(2, dim=1)[0]

    def decode(self, z: torch.Tensor, num_frames: int) -> torch.Tensor:
        """z (N, 4, h, w), unscaled → (N, 3, H, W)."""
        return self.decoder(z, num_frames)


# -- the CLIP ViT-H/14 image encoder -------------------------------------------------------

class _CLIPAttention(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(c, c), nn.Linear(c, c)
        self.v_proj, self.out_proj = nn.Linear(c, c), nn.Linear(c, c)

    def forward(self, x):
        return self.out_proj(attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                                       self.heads, quantise=False))


class _CLIPMLP(nn.Module):
    def __init__(self, c: int, inner: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(c, inner), nn.Linear(inner, c)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _CLIPLayer(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        c = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.self_attn = _CLIPAttention(c, cfg.num_heads)
        self.layer_norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.mlp = _CLIPMLP(c, cfg.intermediate_size)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Holder(nn.Module):
    pass


class VisionModel(nn.Module):
    """CLIPVisionModelWithProjection: (B, 3, 224, 224) normalised → (B, D)."""

    def __init__(self, cfg: VisionConfig = VisionConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden_size
        vm = self.vision_model = _Holder()
        emb = vm.embeddings = _Holder()
        emb.class_embedding = nn.Parameter(torch.zeros(c))
        emb.patch_embedding = nn.Conv2d(3, c, cfg.patch_size, stride=cfg.patch_size, bias=False)
        emb.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1, c)
        vm.pre_layrnorm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        vm.encoder = _Holder()
        vm.encoder.layers = nn.ModuleList([_CLIPLayer(cfg) for _ in range(cfg.num_layers)])
        vm.post_layernorm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.visual_projection = nn.Linear(c, cfg.projection_dim, bias=False)

    def forward(self, pixels):
        vm = self.vision_model
        emb = vm.embeddings
        x = emb.patch_embedding(pixels).flatten(2).transpose(1, 2)
        x = torch.cat([emb.class_embedding.expand(x.shape[0], 1, -1), x], dim=1)
        x = vm.pre_layrnorm(x + emb.position_embedding.weight[None, :x.shape[1]])
        for layer in vm.encoder.layers:
            x = layer(x)
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _triangle_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out): an antialiased triangle (bilinear) filter, each output
    sample's weights normalised to sum to 1."""
    scale = n_out / n_in
    width = max(1.0 / scale, 1.0)
    centre = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) / scale - 0.5
    dist = (centre[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None])
    w = (1.0 - dist.abs() / width).clamp(min=0.0)
    return w / w.sum(0, keepdim=True)


def clip_pixels(image: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] → (B, 3, size, size), resized and normalised."""
    wh = _triangle_weights(image.shape[1], size, image.device)
    ww = _triangle_weights(image.shape[2], size, image.device)
    x = torch.einsum("bhwc,hy,wx->bcyx", image.float(), wh, ww)
    mean = torch.tensor(CLIP_MEAN, device=image.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=image.device)[None, :, None, None]
    return (x - mean) / std


# -- the scheduler and the request -----------------------------------------------------------

def karras_sigmas(steps: int, sigma_min: float = 0.002, sigma_max: float = 700.0,
                  rho: float = 7.0) -> List[float]:
    """Karras et al.'s sigmas from sigma_max down to sigma_min, rounded to
    float32 as diffusers keeps them, with 0 appended."""
    out = []
    for i in range(steps):
        r = i / (steps - 1) if steps > 1 else 0.0
        s = (sigma_max ** (1 / rho) + r * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
        out.append(torch.tensor(s, dtype=torch.float32).item())
    return out + [0.0]


def timestep_of(sigma: float) -> float:
    """The UNet's continuous timestep input, 0.25 ln sigma (in float32)."""
    return (0.25 * torch.log(torch.tensor(sigma, dtype=torch.float32))).item()


def init_noise_sigma(sigmas: List[float]) -> float:
    """sqrt(sigma_max^2 + 1): ``leading`` spacing."""
    return (max(sigmas) ** 2 + 1.0) ** 0.5


def denoised(model_output: torch.Tensor, x: torch.Tensor, sigma: float) -> torch.Tensor:
    """EDM preconditioning with v-prediction: c_skip x + c_out F."""
    return x / (sigma ** 2 + 1.0) - sigma / (sigma ** 2 + 1.0) ** 0.5 * model_output


def euler_step(d: torch.Tensor, x: torch.Tensor, sigma: float, sigma_next: float) -> torch.Tensor:
    return x + (x - d) / sigma * (sigma_next - sigma)


def guidance_scale(num_frames: int, lo: float = 1.0, hi: float = 3.0, device=None) -> torch.Tensor:
    """(1, F, 1, 1, 1): the scale ramped linearly over the frames."""
    return torch.linspace(lo, hi, num_frames, device=device).reshape(1, -1, 1, 1, 1)


def added_time_ids(fps: int, motion_bucket_id: int, noise_aug: float, batch: int,
                   device=None) -> torch.Tensor:
    return torch.tensor([[fps - 1, motion_bucket_id, noise_aug]], dtype=torch.float32,
                        device=device).repeat(batch, 1)


def condition(vision: VisionModel, vae: AutoencoderKLTemporalDecoder, image: torch.Tensor,
              aug_noise: torch.Tensor, noise_aug: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """image (B, H, W, 3) in [0, 1], aug_noise (B, H, W, 3) → the image
    embedding (B, 1, D) of the clean image and the posterior mode (B, 4, h,
    w) of the noise-augmented one, unscaled."""
    embeds = vision(clip_pixels(image, vision.cfg.image_size))[:, None, :]
    x = (image.float() * 2.0 - 1.0 + noise_aug * aug_noise.float()).permute(0, 3, 1, 2)
    return embeds, vae.encode_mode(x)


def cfg_model_output(unet: UNet, x: torch.Tensor, sigma: float, embeds: torch.Tensor,
                     image_latents: torch.Tensor, ids: torch.Tensor,
                     scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched-CFG UNet call at ``sigma``: [uncond, cond] with zero
    image embedding and zero image latents for uncond. Returns (both halves'
    outputs (2B, F, 4, h, w), the guided output)."""
    f = x.shape[1]
    xin = torch.cat([x, x]) / (sigma ** 2 + 1.0) ** 0.5
    lat = image_latents[:, None].expand(-1, f, -1, -1, -1)
    lat = torch.cat([torch.zeros_like(lat), lat])
    emb2 = torch.cat([torch.zeros_like(embeds), embeds])
    out = unet(torch.cat([xin, lat], dim=2), timestep_of(sigma), emb2, ids)
    uncond, cond = out.chunk(2)
    return out, uncond + scale * (cond - uncond)


def sample(unet: UNet, vae: AutoencoderKLTemporalDecoder, vision: VisionModel,
           image: torch.Tensor, aug_noise: torch.Tensor, noise: torch.Tensor, steps: int,
           fps: int = 7, motion_bucket_id: int = 127, noise_aug: float = 0.02
           ) -> torch.Tensor:
    """A whole request from given noise (``noise`` (B, F, 4, h, w) standard
    normal): conditioning, Euler steps with CFG, → final latents."""
    embeds, image_latents = condition(vision, vae, image, aug_noise, noise_aug)
    sigmas = karras_sigmas(steps)
    x = noise.float() * init_noise_sigma(sigmas)
    ids = added_time_ids(fps, motion_bucket_id, noise_aug, 2 * x.shape[0], x.device)
    scale = guidance_scale(x.shape[1], device=x.device)
    for i in range(steps):
        _, guided = cfg_model_output(unet, x, sigmas[i], embeds, image_latents, ids, scale)
        x = euler_step(denoised(guided, x, sigmas[i]), x, sigmas[i], sigmas[i + 1])
    return x


def decode(vae: AutoencoderKLTemporalDecoder, latents: torch.Tensor,
           chunk: int = 25) -> torch.Tensor:
    """(B, F, 4, h, w) → (B, F, H, W, 3) in [-1, 1]: the temporal decoder on
    ``chunk`` frames at a time."""
    b, f = latents.shape[:2]
    z = latents.flatten(0, 1).float() / vae.cfg.scaling_factor
    out = [vae.decode(z[i:i + chunk], z[i:i + chunk].shape[0]) for i in range(0, b * f, chunk)]
    return torch.cat(out).permute(0, 2, 3, 1).reshape((b, f) + (out[0].shape[2],
                                                            out[0].shape[3], 3))


def build(unet: UNetConfig, vae: VAEConfig, vision: VisionConfig,
          device="cpu") -> Dict[str, nn.Module]:
    """The three models on ``device`` (``"meta"`` for shapes and counts)."""
    with torch.device(device):
        return {"unet": UNet(unet).eval().requires_grad_(False),
                "vae": AutoencoderKLTemporalDecoder(vae).eval().requires_grad_(False),
                "vision": VisionModel(vision).eval().requires_grad_(False)}
