"""Plain reference of CogVideoX-5B image-to-video.

Written from the published description (Yang et al., arXiv:2408.06072) and
the released configs of ``THUDM/CogVideoX-5b-I2V`` (``transformer/config.json``,
``vae/config.json``, ``text_encoder/config.json``,
``scheduler/scheduler_config.json``), with diffusers' and transformers'
module and parameter names, in plain ``torch`` and float32. It imports
nothing but ``torch`` and numpy: no module of the port, of JAX or of the JAX
package. Set ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False before running it on a card
(:func:`full_precision`).

It covers the transformer (``CogVideoXTransformer3DModel``: patch embed
with the learned positional embedding, the block with its two
``LayerNormZero``s, joint attention with qk-LayerNorm and 3D RoPE on the
video tokens, the gated feed-forward, the final norm, ``AdaLayerNorm`` out
and unpatchify), the T5 v1.1 encoder, the causal 3D VAE
(``AutoencoderKLCogVideoX``: encoder, decoder with ``SpatialNorm3D``, the
frame-batched encode and decode), the DDIM scheduler of the release
(v-prediction, ``trailing`` spacing, zero terminal SNR, ``snr_shift_scale``)
and the image-to-video conditioning.

Departures from the release, each deliberate:

* attention is computed whole, per (batch, head) group, in float32, in
  slices so that the scores fit (no fused kernel);
* everything is float32, where the release samples in bfloat16;
* the T5 feed-forward's ``gelu_new`` is ``F.gelu(approximate="tanh")``, the
  same function;
* the VAE's causal padding, frame batches (8 frames an encode batch, 2
  latent frames a decode batch, the first batch taking the remainder) and
  ``SpatialNorm3D`` follow diffusers' ``autoencoder_kl_cogvideox.py`` as
  best known, not read from its source here (the configuration file lists
  them under ``assumed``); its safe-conv time splitting, which changes no
  number, is left out.

``q`` is the precision hook: every operand of the transformer's products
passes through it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from benchmark.reference.precision import q  # the control's rounding


def full_precision() -> None:
    """Full float32 products and convolutions on a card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- configurations -----------------------------------------------------------------

@dataclass(frozen=True)
class TransformerConfig:
    num_attention_heads: int = 48
    attention_head_dim: int = 64
    in_channels: int = 32
    out_channels: int = 16
    time_embed_dim: int = 512
    text_embed_dim: int = 4096
    num_layers: int = 42
    patch_size: int = 2
    sample_frames: int = 49
    sample_height: int = 60
    sample_width: int = 90
    temporal_compression_ratio: int = 4
    max_text_seq_length: int = 226
    norm_eps: float = 1e-5
    qk_norm_eps: float = 1e-6
    flip_sin_to_cos: bool = True
    freq_shift: int = 0

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


@dataclass(frozen=True)
class VAEConfig:
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


# -- the transformer ------------------------------------------------------------------

class Linear(nn.Linear):
    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.linear(q(x), q(self.weight), b)


def joint_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, scale: float,
                    score_bytes: int = 1 << 31) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over (B, H, S, D) heads in float32, in groups of
    (batch, head) rows whose scores fit ``score_bytes``; operands through
    :func:`q`."""
    b, h, sq, d = qh.shape
    sk = kh.shape[2]
    qf, kf, vf = (q(x).reshape(b * h, -1, d) for x in (qh, kh, vh))
    step = max(1, score_bytes // (4 * sq * sk))
    out = []
    for i in range(0, b * h, step):
        s = torch.matmul(qf[i:i + step], kf[i:i + step].transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1)
        out.append(torch.matmul(q(p), vf[i:i + step]))
    return torch.cat(out).reshape(b, h, sq, d)


def rotary_1d(dim: int, pos: torch.Tensor, theta: float = 10000.0):
    """(cos, sin), each (S, dim): every frequency repeated twice (interleaved
    real pairs)."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32)[: dim // 2] / dim))
    freqs = torch.outer(pos.float(), freqs)
    return freqs.cos().repeat_interleave(2, dim=1), freqs.sin().repeat_interleave(2, dim=1)


def rotary_3d(head_dim: int, grid_h: int, grid_w: int, frames: int,
              crop: Tuple[Tuple[int, int], Tuple[int, int]] = None, theta: float = 10000.0):
    """diffusers' ``get_3d_rotary_pos_embed`` (linspace grid): (cos, sin),
    each (frames·grid_h·grid_w, head_dim), frame-major; channels t
    (head_dim / 4), then h and w (3 head_dim / 8 each)."""
    (top, left), (bottom, right) = crop or ((0, 0), (grid_h, grid_w))
    gh = torch.from_numpy(np.linspace(top, bottom, grid_h, endpoint=False, dtype=np.float32))
    gw = torch.from_numpy(np.linspace(left, right, grid_w, endpoint=False, dtype=np.float32))
    gt = torch.from_numpy(np.linspace(0, frames, frames, endpoint=False, dtype=np.float32))
    dt, dh = head_dim // 4, head_dim // 8 * 3
    parts = [rotary_1d(dt, gt), rotary_1d(dh, gh), rotary_1d(dh, gw)]
    out = []
    for k in range(2):
        t = parts[0][k][:, None, None, :].expand(-1, grid_h, grid_w, -1)
        h = parts[1][k][None, :, None, :].expand(frames, -1, grid_w, -1)
        w = parts[2][k][None, None, :, :].expand(frames, grid_h, -1, -1)
        out.append(torch.cat([t, h, w], dim=-1).reshape(frames * grid_h * grid_w, -1))
    return out[0], out[1]


def crop_region(grid_h: int, grid_w: int, base_w: int, base_h: int):
    """diffusers' ``get_resize_crop_region_for_grid``."""
    r = grid_h / grid_w
    if r > base_h / base_w:
        rh, rw = base_h, int(round(base_h / grid_h * grid_w))
    else:
        rw, rh = base_w, int(round(base_w / grid_w * grid_h))
    top, left = int(round((base_h - rh) / 2.0)), int(round((base_w - rw) / 2.0))
    return (top, left), (top + rh, left + rw)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, D) rotated by interleaved real pairs: x·cos + rot(x)·sin
    with rot(x)[2i] = -x[2i+1], rot(x)[2i+1] = x[2i]."""
    xr, xi = x.reshape(*x.shape[:-1], -1, 2).unbind(-1)
    rot = torch.stack([-xi, xr], dim=-1).flatten(3)
    return x * cos[None, None] + rot * sin[None, None]


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       shift: float = 0.0) -> torch.Tensor:
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=t.device) / (half - shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None]
    emb = torch.cat([emb.sin(), emb.cos()], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1, self.linear_2 = Linear(cin, dim), Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class PatchEmbed(nn.Module):
    """Per-frame Conv2d patches (frame, row, column order), ``text_proj`` and
    the learned positional embedding over the joint sequence (text first)."""

    def __init__(self, c: TransformerConfig):
        super().__init__()
        self.c = c
        self.proj = nn.Conv2d(c.in_channels, c.inner_dim, c.patch_size, stride=c.patch_size)
        self.text_proj = Linear(c.text_embed_dim, c.inner_dim)
        frames = (c.sample_frames - 1) // c.temporal_compression_ratio + 1
        n = frames * (c.sample_height // c.patch_size) * (c.sample_width // c.patch_size)
        self.register_buffer("pos_embedding",
                             torch.zeros(1, c.max_text_seq_length + n, c.inner_dim))

    def forward(self, text: torch.Tensor, video: torch.Tensor) -> torch.Tensor:
        b, f, ch, h, w = video.shape
        x = F.conv2d(q(video.reshape(b * f, ch, h, w)), q(self.proj.weight),
                     self.proj.bias.float(), stride=self.c.patch_size)
        x = x.reshape(b, f, self.c.inner_dim, -1).transpose(2, 3).reshape(b, -1, self.c.inner_dim)
        joint = torch.cat([self.text_proj(text), x], dim=1)
        return joint + self.pos_embedding.float()


class LayerNormZero(nn.Module):
    """SiLU, Linear(time_embed_dim, 6·dim), then shift / scale / gate for the
    video and for the text stream; one LayerNorm serves both."""

    def __init__(self, cond: int, dim: int, eps: float):
        super().__init__()
        self.linear = Linear(cond, 6 * dim)
        self.norm = nn.LayerNorm(dim, eps=eps)

    def forward(self, h, e, temb):
        sh, sc, g, esh, esc, eg = self.linear(F.silu(temb)).chunk(6, dim=1)
        h = self.norm(h) * (1 + sc)[:, None] + sh[:, None]
        e = self.norm(e) * (1 + esc)[:, None] + esh[:, None]
        return h, e, g[:, None], eg[:, None]


class Attention(nn.Module):
    def __init__(self, c: TransformerConfig):
        super().__init__()
        d = c.inner_dim
        self.heads = c.num_attention_heads
        self.norm_q = nn.LayerNorm(c.attention_head_dim, eps=c.qk_norm_eps)
        self.norm_k = nn.LayerNorm(c.attention_head_dim, eps=c.qk_norm_eps)
        self.to_q, self.to_k, self.to_v = Linear(d, d), Linear(d, d), Linear(d, d)
        self.to_out = nn.ModuleList([Linear(d, d)])

    def forward(self, h: torch.Tensor, e: torch.Tensor, rope) -> Tuple[torch.Tensor, torch.Tensor]:
        """Joint attention over [text, video]; RoPE on the video tokens of q
        and k. Returns (video, text) outputs."""
        n_text = e.shape[1]
        x = torch.cat([e, h], dim=1)
        b, s, d = x.shape
        split = lambda t: t.reshape(b, s, self.heads, -1).transpose(1, 2)
        qh, kh, vh = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        qh, kh = self.norm_q(qh), self.norm_k(kh)
        if rope is not None:
            qh = torch.cat([qh[:, :, :n_text], apply_rotary(qh[:, :, n_text:], *rope)], dim=2)
            kh = torch.cat([kh[:, :, :n_text], apply_rotary(kh[:, :, n_text:], *rope)], dim=2)
        o = joint_attention(qh, kh, vh, qh.shape[-1] ** -0.5)
        o = self.to_out[0](o.transpose(1, 2).reshape(b, s, d))
        return o[:, n_text:], o[:, :n_text]


class _Proj(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = Linear(cin, cout)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.net = nn.ModuleList([_Proj(dim, inner), nn.Dropout(0.0), Linear(inner, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class Block(nn.Module):
    """``CogVideoXBlock``."""

    def __init__(self, c: TransformerConfig):
        super().__init__()
        self.norm1 = LayerNormZero(c.time_embed_dim, c.inner_dim, c.norm_eps)
        self.attn1 = Attention(c)
        self.norm2 = LayerNormZero(c.time_embed_dim, c.inner_dim, c.norm_eps)
        self.ff = FeedForward(c.inner_dim, 4 * c.inner_dim)

    def forward(self, h, e, temb, rope):
        n_text = e.shape[1]
        nh, ne, g, eg = self.norm1(h, e, temb)
        ah, ae = self.attn1(nh, ne, rope)
        h, e = h + g * ah, e + eg * ae
        nh, ne, g, eg = self.norm2(h, e, temb)
        ff = self.ff(torch.cat([ne, nh], dim=1))
        return h + g * ff[:, n_text:], e + eg * ff[:, :n_text]


class AdaLayerNorm(nn.Module):
    def __init__(self, cond: int, dim: int, eps: float):
        super().__init__()
        self.linear = Linear(cond, 2 * dim)
        self.norm = nn.LayerNorm(dim, eps=eps)

    def forward(self, x, temb):
        shift, scale = self.linear(F.silu(temb)).chunk(2, dim=1)
        return self.norm(x) * (1 + scale)[:, None] + shift[:, None]


class Transformer(nn.Module):
    """``CogVideoXTransformer3DModel`` (diffusers' names), in three parts a
    caller may run separately: :meth:`embed`, each block, :meth:`out`."""

    def __init__(self, c: TransformerConfig, blocks: bool = True):
        super().__init__()
        self.config = c
        self.patch_embed = PatchEmbed(c)
        self.time_embedding = TimestepEmbedding(c.inner_dim, c.time_embed_dim)
        self.transformer_blocks = nn.ModuleList(
            [Block(c) for _ in range(c.num_layers if blocks else 0)])
        self.norm_final = nn.LayerNorm(c.inner_dim, eps=c.norm_eps)
        self.norm_out = AdaLayerNorm(c.time_embed_dim, c.inner_dim, c.norm_eps)
        self.proj_out = Linear(c.inner_dim, c.patch_size ** 2 * c.out_channels)

    def embed(self, x: torch.Tensor, t: torch.Tensor, text: torch.Tensor):
        """x (B, F, C, h, w), t (B,), text (B, L, 4096) → (video tokens, text
        tokens, time embedding)."""
        c = self.config
        temb = self.time_embedding(timestep_embedding(t, c.inner_dim, c.flip_sin_to_cos,
                                                      c.freq_shift))
        joint = self.patch_embed(text, x)
        n = text.shape[1]
        return joint[:, n:], joint[:, :n], temb

    def out(self, h, e, temb, shape) -> torch.Tensor:
        """Final norm over the joint sequence, the video part, AdaLayerNorm,
        proj_out, unpatchify to (B, F, out_channels, h, w)."""
        c = self.config
        b, f, _, hh, ww = shape
        p = c.patch_size
        x = self.norm_final(torch.cat([e, h], dim=1))[:, e.shape[1]:]
        x = self.proj_out(self.norm_out(x, temb))
        x = x.reshape(b, f, hh // p, ww // p, -1, p, p)
        return x.permute(0, 1, 4, 2, 5, 3, 6).flatten(5, 6).flatten(3, 4)

    def rope(self, f: int, hh: int, ww: int, device):
        c = self.config
        p = c.patch_size
        gh, gw = hh // p, ww // p
        crop = crop_region(gh, gw, c.sample_width // p, c.sample_height // p)
        cos, sin = rotary_3d(c.attention_head_dim, gh, gw, f, crop)
        return cos.to(device), sin.to(device)

    def forward(self, x, t, text):
        h, e, temb = self.embed(x, t, text)
        rope = self.rope(x.shape[1], x.shape[3], x.shape[4], x.device)
        for blk in self.transformer_blocks:
            h, e = blk(h, e, temb, rope)
        return self.out(h, e, temb, x.shape)


# -- T5 v1.1 encoder --------------------------------------------------------------------

class T5LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        return self.weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps))


def relative_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bidirectional T5 buckets of ``rel`` = key position − query position."""
    num_buckets //= 2
    out = (rel > 0).long() * num_buckets
    rel = rel.abs()
    exact = num_buckets // 2
    large = exact + (torch.log(rel.float() / exact) / math.log(max_distance / exact)
                     * (num_buckets - exact)).long()
    large = large.clamp(max=num_buckets - 1)
    return out + torch.where(rel < exact, rel, large)


class T5Attention(nn.Module):
    def __init__(self, c: T5Config, bias: bool):
        super().__init__()
        inner = c.num_heads * c.d_kv
        self.c = c
        self.q = nn.Linear(c.d_model, inner, bias=False)
        self.k = nn.Linear(c.d_model, inner, bias=False)
        self.v = nn.Linear(c.d_model, inner, bias=False)
        self.o = nn.Linear(inner, c.d_model, bias=False)
        if bias:
            self.relative_attention_bias = nn.Embedding(c.relative_attention_num_buckets,
                                                        c.num_heads)

    def position_bias(self, s: int, device) -> torch.Tensor:
        pos = torch.arange(s, device=device)
        buckets = relative_bucket(pos[None, :] - pos[:, None],
                                  self.c.relative_attention_num_buckets,
                                  self.c.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]

    def forward(self, x, bias):
        b, s, _ = x.shape
        split = lambda t: t.reshape(b, s, self.c.num_heads, self.c.d_kv).transpose(1, 2)
        qh, kh, vh = split(self.q(x)), split(self.k(x)), split(self.v(x))
        p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) + bias, dim=-1)
        return self.o(torch.matmul(p, vh).transpose(1, 2).reshape(b, s, -1))


class _T5SelfAttn(nn.Module):
    def __init__(self, c: T5Config, bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(c, bias)
        self.layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon)


class _T5Dense(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(c.d_model, c.d_ff, bias=False)
        self.wi_1 = nn.Linear(c.d_model, c.d_ff, bias=False)
        self.wo = nn.Linear(c.d_ff, c.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _T5FF(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.DenseReluDense = _T5Dense(c)
        self.layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon)


class _T5Block(nn.Module):
    def __init__(self, c: T5Config, bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_T5SelfAttn(c, bias), _T5FF(c)])

    def forward(self, x, bias):
        a = self.layer[0]
        x = x + a.SelfAttention(a.layer_norm(x), bias)
        f = self.layer[1]
        return x + f.DenseReluDense(f.layer_norm(x))


class _T5Stack(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.block = nn.ModuleList([_T5Block(c, i == 0) for i in range(c.num_layers)])
        self.final_layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """transformers' ``T5EncoderModel`` (v1.1: gated-GELU, untied, no
    attention mask: every id, padding too, attends to every other, as the
    CogVideoX pipeline calls it)."""

    def __init__(self, c: T5Config):
        super().__init__()
        self.config = c
        self.shared = nn.Embedding(c.vocab_size, c.d_model)
        self.encoder = _T5Stack(c)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.shared(ids)
        bias = self.encoder.block[0].layer[0].SelfAttention.position_bias(ids.shape[1], ids.device)
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)


# -- the causal 3D VAE ------------------------------------------------------------------

class CausalConv3d(nn.Module):
    """Causal in time (the first frame repeated, or the previous batch's
    last frames from ``cache``), zero-padded in space."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.k = k
        self.conv = nn.Conv3d(cin, cout, k)

    def forward(self, x, cache=None):
        if self.k == 1:
            return self.conv(x), None
        head = cache if cache is not None else x[:, :, :1].expand(-1, -1, self.k - 1, -1, -1)
        x = torch.cat([head, x], dim=2)
        p = self.k // 2
        return self.conv(F.pad(x, (p, p, p, p))), x[:, :, -(self.k - 1):].clone()


class SpatialNorm3D(nn.Module):
    def __init__(self, c: int, zc: int, groups: int):
        super().__init__()
        self.norm_layer = nn.GroupNorm(groups, c, eps=1e-6)
        self.conv_y = CausalConv3d(zc, c, 1)
        self.conv_b = CausalConv3d(zc, c, 1)

    def forward(self, f, zq):
        if f.shape[2] > 1 and f.shape[2] % 2 == 1:
            z0 = F.interpolate(zq[:, :, :1], size=(1,) + tuple(f.shape[-2:]))
            z1 = F.interpolate(zq[:, :, 1:], size=(f.shape[2] - 1,) + tuple(f.shape[-2:]))
            zq = torch.cat([z0, z1], dim=2)
        else:
            zq = F.interpolate(zq, size=tuple(f.shape[-3:]))
        return self.norm_layer(f) * self.conv_y(zq)[0] + self.conv_b(zq)[0]


class Resnet3D(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, eps: float, zc: Optional[int] = None):
        super().__init__()
        if zc is None:
            self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
            self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        else:
            self.norm1 = SpatialNorm3D(cin, zc, groups)
            self.norm2 = SpatialNorm3D(cout, zc, groups)
        self.conv1 = CausalConv3d(cin, cout)
        self.conv2 = CausalConv3d(cout, cout)
        if cin != cout:
            self.conv_shortcut = nn.Conv3d(cin, cout, 1)
        self.spatial = zc is not None

    def forward(self, x, zq, cache: dict):
        new = {}
        h = self.norm1(x, zq) if self.spatial else self.norm1(x)
        h, new["conv1"] = self.conv1(F.silu(h), cache.get("conv1"))
        h = self.norm2(h, zq) if self.spatial else self.norm2(h)
        h, new["conv2"] = self.conv2(F.silu(h), cache.get("conv2"))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h, new


class Downsample3D(nn.Module):
    def __init__(self, c: int, compress_time: bool):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        b, c, f, h, w = x.shape
        if self.compress_time and f > 1:
            x = x.permute(0, 3, 4, 1, 2).reshape(b * h * w, c, f)
            if f % 2 == 1:
                x = torch.cat([x[..., :1], F.avg_pool1d(x[..., 1:], 2, 2)], dim=-1)
            else:
                x = F.avg_pool1d(x, 2, 2)
            f = x.shape[-1]
            x = x.reshape(b, h, w, c, f).permute(0, 3, 4, 1, 2)
        x = F.pad(x, (0, 1, 0, 1))
        y = self.conv(x.permute(0, 2, 1, 3, 4).reshape(b * f, c, h + 1, w + 1))
        return y.reshape(b, f, c, y.shape[-2], y.shape[-1]).permute(0, 2, 1, 3, 4)


class Upsample3D(nn.Module):
    def __init__(self, c: int, compress_time: bool):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        b, c, f, h, w = x.shape
        if self.compress_time and f > 1 and f % 2 == 1:
            x = torch.cat([F.interpolate(x[:, :, 0], scale_factor=2.0)[:, :, None],
                           F.interpolate(x[:, :, 1:], scale_factor=2.0)], dim=2)
        elif self.compress_time and f > 1:
            x = F.interpolate(x, scale_factor=2.0)
        else:
            x = F.interpolate(x.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, w),
                              scale_factor=2.0)
            x = x.reshape(b, f, c, 2 * h, 2 * w).permute(0, 2, 1, 3, 4)
        b, c, f, h, w = x.shape
        y = self.conv(x.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, w))
        return y.reshape(b, f, c, h, w).permute(0, 2, 1, 3, 4)


class _Level(nn.Module):
    def __init__(self, resnets, sampler=None, kind: str = "downsamplers"):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, kind, nn.ModuleList([sampler]))
        self.kind = kind if sampler is not None else None

    def forward(self, x, zq, cache: dict):
        new = {}
        for i, r in enumerate(self.resnets):
            x, new[i] = r(x, zq, cache.get(i, {}))
        if self.kind:
            x = getattr(self, self.kind)[0](x)
        return x, new


class Encoder3D(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        ch, g, eps = c.block_out_channels, c.norm_num_groups, c.norm_eps
        levels = int(math.log2(c.temporal_compression_ratio))
        self.conv_in = CausalConv3d(c.in_channels, ch[0])
        blocks, cout = [], ch[0]
        for i, co in enumerate(ch):
            cin, cout = cout, co
            last = i == len(ch) - 1
            res = [Resnet3D(cin if j == 0 else cout, cout, g, eps)
                   for j in range(c.layers_per_block)]
            blocks.append(_Level(res, None if last else Downsample3D(cout, i < levels)))
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _Level([Resnet3D(ch[-1], ch[-1], g, eps) for _ in range(2)])
        self.norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = CausalConv3d(ch[-1], 2 * c.latent_channels)

    def forward(self, x, cache: dict):
        new = {}
        h, new["conv_in"] = self.conv_in(x, cache.get("conv_in"))
        for i, blk in enumerate(self.down_blocks):
            h, new[f"down{i}"] = blk(h, None, cache.get(f"down{i}", {}))
        h, new["mid"] = self.mid_block(h, None, cache.get("mid", {}))
        h, new["conv_out"] = self.conv_out(F.silu(self.norm_out(h)), cache.get("conv_out"))
        return h, new


class Decoder3D(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        ch, g, eps, zc = tuple(reversed(c.block_out_channels)), c.norm_num_groups, c.norm_eps, \
            c.latent_channels
        levels = int(math.log2(c.temporal_compression_ratio))
        self.conv_in = CausalConv3d(zc, ch[0])
        self.mid_block = _Level([Resnet3D(ch[0], ch[0], g, eps, zc) for _ in range(2)])
        blocks, cout = [], ch[0]
        for i, co in enumerate(ch):
            cin, cout = cout, co
            last = i == len(ch) - 1
            res = [Resnet3D(cin if j == 0 else cout, cout, g, eps, zc)
                   for j in range(c.layers_per_block + 1)]
            blocks.append(_Level(res, None if last else Upsample3D(cout, i < levels),
                                 "upsamplers"))
        self.up_blocks = nn.ModuleList(blocks)
        self.norm_out = SpatialNorm3D(ch[-1], zc, g)
        self.conv_out = CausalConv3d(ch[-1], c.out_channels)

    def forward(self, z, cache: dict):
        new = {}
        h, new["conv_in"] = self.conv_in(z, cache.get("conv_in"))
        h, new["mid"] = self.mid_block(h, z, cache.get("mid", {}))
        for i, blk in enumerate(self.up_blocks):
            h, new[f"up{i}"] = blk(h, z, cache.get(f"up{i}", {}))
        h, new["conv_out"] = self.conv_out(F.silu(self.norm_out(h, z)), cache.get("conv_out"))
        return h, new


def frame_batches(n: int, size: int) -> List[Tuple[int, int]]:
    """[(start, end)] of ``n`` frames in batches of ``size``, the first batch
    taking the remainder (diffusers' CogVideoX encode / decode loops)."""
    rem = n % size
    out = []
    for i in range(max(n // size, 1)):
        out.append((size * i + (0 if i == 0 else rem), size * (i + 1) + rem))
    return out


class VAE(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        self.config = c
        self.encoder = Encoder3D(c)
        self.decoder = Decoder3D(c)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 3, F, H, W) in [-1, 1] → the posterior's (mean, logvar), each
        (B, latent, F', h, w)."""
        cache, out = {}, []
        for a, b in frame_batches(x.shape[2], self.config.encode_frame_batch):
            h, cache = self.encoder(x[:, :, a:b], cache)
            out.append(h)
        mean, logvar = torch.cat(out, dim=2).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, latent, F', h, w) (already divided by the scaling factor) →
        (B, 3, F, H, W)."""
        cache, out = {}, []
        for a, b in frame_batches(z.shape[2], self.config.decode_latent_frame_batch):
            h, cache = self.decoder(z[:, :, a:b], cache)
            out.append(h)
        return torch.cat(out, dim=2)


# -- the scheduler and the request ------------------------------------------------------

def alphas_cumprod(num_train: int = 1000, beta_start: float = 0.00085, beta_end: float = 0.012,
                   snr_shift_scale: float = 1.0, zero_snr: bool = True) -> np.ndarray:
    """float64 ᾱ of ``CogVideoXDDIMScheduler``: scaled-linear betas, the SNR
    shift, then the zero-terminal-SNR rescale of sqrt(ᾱ)."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_train, dtype=np.float64) ** 2
    a = np.cumprod(1.0 - betas)
    a = a / (snr_shift_scale + (1 - snr_shift_scale) * a)
    if zero_snr:
        s = np.sqrt(a)
        s0, st = s[0], s[-1]
        s = (s - st) * s0 / (s0 - st)
        a = s ** 2
    return a


def timesteps(steps: int, num_train: int = 1000, spacing: str = "trailing") -> List[int]:
    if spacing == "trailing":
        return [int(t) for t in np.round(np.arange(num_train, 0, -num_train / steps)) - 1]
    ratio = num_train // steps
    return [int(t) for t in (np.arange(steps) * ratio).round()[::-1]]


def ddim_coefficients(a: np.ndarray, t: int, steps: int, num_train: int = 1000):
    """(c_x, c_v): x_prev = c_x · x + c_v · v for v-prediction, eta 0, ᾱ
    of the final step 1 (``set_alpha_to_one``)."""
    prev = t - num_train // steps
    at, ap = float(a[t]), (float(a[prev]) if prev >= 0 else 1.0)
    ca = ((1 - ap) / (1 - at)) ** 0.5
    cb = ap ** 0.5 - at ** 0.5 * ca
    return ca + cb * at ** 0.5, -cb * (1 - at) ** 0.5


def image_latent(vae: VAE, image: torch.Tensor, gen: torch.Generator, frames: int) -> torch.Tensor:
    """``image`` (B, H, W, 3) in [0, 1] → (B, F', 16, h, w): the posterior
    sample of its one latent frame times the scaling factor, zero-padded
    to ``frames`` latent frames."""
    x = (image * 2.0 - 1.0).permute(0, 3, 1, 2)[:, :, None]
    mean, logvar = vae.encode(x)
    noise = torch.randn(mean.shape, generator=gen, device=mean.device)
    lat = (mean + torch.exp(0.5 * logvar) * noise) * vae.config.scaling_factor
    lat = lat.permute(0, 2, 1, 3, 4)
    pad = torch.zeros((lat.shape[0], frames - 1) + tuple(lat.shape[2:]), device=lat.device)
    return torch.cat([lat, pad], dim=1)


def decode(vae: VAE, latents: torch.Tensor) -> torch.Tensor:
    """(B, F', 16, h, w) → (B, F, H, W, 3) in [-1, 1]-ish, float32."""
    z = latents.permute(0, 2, 1, 3, 4) / vae.config.scaling_factor
    return vae.decode(z).permute(0, 2, 3, 4, 1)


def build(transformer: TransformerConfig, t5: T5Config, vae: VAEConfig, device,
          blocks: bool = True) -> Dict[str, nn.Module]:
    """The three models on ``device`` (``"meta"`` for shapes); with
    ``blocks`` False the transformer holds no blocks (a caller builds them
    one at a time with :class:`Block`)."""
    with torch.device(device):
        return {"transformer": Transformer(transformer, blocks).eval(),
                "t5": T5Encoder(t5).eval(), "vae": VAE(vae).eval()}
