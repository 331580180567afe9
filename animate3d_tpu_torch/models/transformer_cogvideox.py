"""CogVideoX's video transformer (image-to-video, 5B).

diffusers' ``CogVideoXTransformer3DModel`` as released with
``THUDM/CogVideoX-5b-I2V`` (``transformer/config.json``), with its parameter
names, so the released state dict loads as it is (``convert/weights.py``).
The JAX package has no such model. Latents ``(B, F, C, h, w)``: 16 noisy
channels and 16 of the image latent, 13 latent frames of 60 x 90 at the
published size.

The patch embed cuts each frame into 2 x 2 patches (a strided Conv2d),
flattened frame, then row, then column; the T5 states pass ``text_proj``;
the text tokens go first and the learned positional embedding is added
over the joint sequence (226 + 17,550 = 17,776 tokens). The sequence is
kept joint through the 42 blocks; each :class:`CogVideoXBlock`:

* ``norm1``, a :class:`LayerNormZero`: SiLU, Linear(512, 6·3072), one
  LayerNorm for both streams, shift / scale / gate for the video tokens and
  for the text tokens;
* joint attention (:class:`JointAttention`): q, k, v of the whole
  sequence, LayerNorm over each head's 64 channels of q and k, 3D RoPE
  (:func:`rotary_table`, real pairs interleaved) on the video tokens of q
  and k, kernel A (``ops/attention.py::video_attention``) at scale 1/8,
  ``to_out``; each stream's output gated into its residual;
* ``norm2`` and the same gating around Linear, GELU (tanh), Linear over the
  joint sequence.

Then the final LayerNorm, the video tokens, ``AdaLayerNorm`` (shift first)
and ``proj_out`` to 2·2·16, unpatchified. The model samples in its
parameters' dtype (bf16 on the card: ``models/layers.py``'s rules), the
timestep's sinusoid cast to it, as the release runs.

Spans: ``cogvideox.forward`` (the call), ``cogvideox.attn`` (qk-norm, RoPE
and A), ``cogvideox.ff`` (the feed-forward); each joint attention counts
one under ``("joint_seq", "<text>+<video>")`` while tracing.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from animate3d_tpu_torch.models.embeddings import TimestepEmbedding, get_timestep_embedding
from animate3d_tpu_torch.models.layers import Conv2d, LayerNorm, Linear
from animate3d_tpu_torch.ops.attention import video_attention
from animate3d_tpu_torch.utils import trace


@dataclass(frozen=True)
class CogVideoXConfig:
    """``transformer/config.json`` of the released CogVideoX-5B-I2V (sample
    sizes in latent pixels: 60 x 90 is 480 x 720)."""

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

    @classmethod
    def tiny(cls, text_embed_dim: int = 32) -> "CogVideoXConfig":
        """Test scale: 2 blocks of 2 heads 16 wide, 9 frames at 8 x 12."""
        return cls(num_attention_heads=2, attention_head_dim=16, in_channels=8, out_channels=4,
                   time_embed_dim=16, text_embed_dim=text_embed_dim, num_layers=2,
                   sample_frames=9, sample_height=8, sample_width=12, max_text_seq_length=6)


@functools.lru_cache(maxsize=8)
def _rotary_host(head_dim: int, frames: int, grid_h: int, grid_w: int, base_h: int,
                 base_w: int):
    r = grid_h / grid_w
    if r > base_h / base_w:
        rh, rw = base_h, int(round(base_h / grid_h * grid_w))
    else:
        rw, rh = base_w, int(round(base_w / grid_w * grid_h))
    top, left = int(round((base_h - rh) / 2.0)), int(round((base_w - rw) / 2.0))
    axes = (np.linspace(0, frames, frames, endpoint=False, dtype=np.float32),
            np.linspace(top, top + rh, grid_h, endpoint=False, dtype=np.float32),
            np.linspace(left, left + rw, grid_w, endpoint=False, dtype=np.float32))
    dims = (head_dim // 4, head_dim // 8 * 3, head_dim // 8 * 3)
    angles = []
    for pos, dim in zip(axes, dims):
        freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32)[: dim // 2]
                                   / dim))
        angles.append(torch.outer(torch.from_numpy(pos), freqs).repeat_interleave(2, dim=1))
    t = angles[0][:, None, None].expand(-1, grid_h, grid_w, -1)
    h = angles[1][None, :, None].expand(frames, -1, grid_w, -1)
    w = angles[2][None, None].expand(frames, grid_h, -1, -1)
    a = torch.cat([t, h, w], dim=-1).reshape(frames * grid_h * grid_w, head_dim)
    return a.cos(), a.sin()


def rotary_table(config: CogVideoXConfig, frames: int, height: int, width: int, device):
    """diffusers' ``get_3d_rotary_pos_embed`` for latents of ``frames`` x
    ``height`` x ``width``: (cos, sin), each (frames·gh·gw, head_dim) float32
    on ``device``, frame-major; channels t (head_dim / 4), h and w (3 head_dim
    / 8 each), theta 1e4, each frequency twice (interleaved pairs); the grid
    is the resize-crop region of the sample grid (``get_resize_crop_region_for_grid``)."""
    p = config.patch_size
    cos, sin = _rotary_host(config.attention_head_dim, frames, height // p, width // p,
                            config.sample_height // p, config.sample_width // p)
    return cos.to(device), sin.to(device)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated by interleaved real pairs in float32
    (x·cos + rot(x)·sin, rot(x)[2i] = −x[2i+1], rot(x)[2i+1] = x[2i]), cast
    back to x's dtype; cos / sin (S, D)."""
    xf = x.float()
    pairs = xf.unflatten(-1, (-1, 2))
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return (xf * cos[:, None] + rot * sin[:, None]).to(x.dtype)


class PatchEmbed(nn.Module):
    """``CogVideoXPatchEmbed`` with a learned positional embedding."""

    def __init__(self, c: CogVideoXConfig):
        super().__init__()
        self.c = c
        self.proj = Conv2d(c.in_channels, c.inner_dim, c.patch_size, stride=c.patch_size)
        self.text_proj = Linear(c.text_embed_dim, c.inner_dim)
        frames = (c.sample_frames - 1) // c.temporal_compression_ratio + 1
        n = frames * (c.sample_height // c.patch_size) * (c.sample_width // c.patch_size)
        self.register_buffer("pos_embedding",
                             torch.zeros(1, c.max_text_seq_length + n, c.inner_dim))

    def forward(self, text: torch.Tensor, video: torch.Tensor) -> torch.Tensor:
        b, f, ch, h, w = video.shape
        c = self.c
        if (h, w, text.shape[1]) != (c.sample_height, c.sample_width, c.max_text_seq_length):
            raise ValueError(f"the learned positional embedding is for {c.max_text_seq_length} "
                             f"text tokens and {c.sample_height} x {c.sample_width} latents, "
                             f"got {text.shape[1]} and {h} x {w}")
        x = self.proj(video.reshape(b * f, ch, h, w))
        x = x.reshape(b, f, c.inner_dim, -1).transpose(2, 3).reshape(b, -1, c.inner_dim)
        joint = torch.cat([self.text_proj(text), x], dim=1)
        return joint + self.pos_embedding[:, :joint.shape[1]].to(joint.dtype)


class LayerNormZero(nn.Module):
    """``CogVideoXLayerNormZero`` over the joint sequence (text first):
    returns the normalised, modulated sequence and the (B, 1, C) gates of
    the video and of the text tokens."""

    def __init__(self, cond: int, dim: int, eps: float):
        super().__init__()
        self.linear = Linear(cond, 6 * dim)
        self.norm = LayerNorm(dim, eps=eps)

    def forward(self, x: torch.Tensor, n_text: int, temb: torch.Tensor):
        sh, sc, g, esh, esc, eg = self.linear(F.silu(temb))[:, None].chunk(6, dim=2)
        y = self.norm(x)
        y[:, :n_text].mul_(1 + esc).add_(esh)
        y[:, n_text:].mul_(1 + sc).add_(sh)
        return y, g, eg


class JointAttention(nn.Module):
    """Self-attention over the joint sequence: qk-LayerNorm, RoPE on the
    video tokens, kernel A, ``to_out`` (diffusers' ``Attention`` names)."""

    def __init__(self, c: CogVideoXConfig):
        super().__init__()
        d = c.inner_dim
        self.heads = c.num_attention_heads
        self.norm_q = LayerNorm(c.attention_head_dim, eps=c.qk_norm_eps)
        self.norm_k = LayerNorm(c.attention_head_dim, eps=c.qk_norm_eps)
        self.to_q, self.to_k, self.to_v = Linear(d, d), Linear(d, d), Linear(d, d)
        self.to_out = nn.ModuleList([Linear(d, d)])

    def _qk(self, x: torch.Tensor, norm: nn.Module, n_text: int, rope) -> torch.Tensor:
        b, s, d = x.shape
        x = norm(x.view(b, s, self.heads, -1))
        out = torch.empty_like(x)
        out[:, :n_text] = x[:, :n_text]
        out[:, n_text:] = apply_rotary(x[:, n_text:], *rope)
        return out.view(b, s, d)

    def forward(self, x: torch.Tensor, n_text: int, rope) -> torch.Tensor:
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        with trace.span("cogvideox.attn"):
            q = self._qk(q, self.norm_q, n_text, rope)
            k = self._qk(k, self.norm_k, n_text, rope)
            trace.count(("joint_seq", f"{n_text}+{x.shape[1] - n_text}"), 1)
            o = video_attention(q, k, v, self.heads)
        return self.to_out[0](o)


class _Proj(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = Linear(cin, cout)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """Linear, GELU (tanh), Linear (diffusers' ``FeedForward`` names)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.net = nn.ModuleList([_Proj(dim, inner), nn.Dropout(0.0), Linear(inner, dim)])

    def forward(self, x):
        with trace.span("cogvideox.ff"):
            return self.net[2](self.net[0](x))


class CogVideoXBlock(nn.Module):
    def __init__(self, c: CogVideoXConfig):
        super().__init__()
        self.norm1 = LayerNormZero(c.time_embed_dim, c.inner_dim, c.norm_eps)
        self.attn1 = JointAttention(c)
        self.norm2 = LayerNormZero(c.time_embed_dim, c.inner_dim, c.norm_eps)
        self.ff = FeedForward(c.inner_dim, 4 * c.inner_dim)

    def forward(self, x: torch.Tensor, n_text: int, temb: torch.Tensor, rope) -> torch.Tensor:
        """x: the joint sequence (B, S, C), text first; returns the next."""
        y, g, eg = self.norm1(x, n_text, temb)
        a = self.attn1(y, n_text, rope)
        x = x.clone()
        x[:, :n_text].addcmul_(eg, a[:, :n_text])
        x[:, n_text:].addcmul_(g, a[:, n_text:])
        y, g, eg = self.norm2(x, n_text, temb)
        f = self.ff(y)
        x[:, :n_text].addcmul_(eg, f[:, :n_text])
        x[:, n_text:].addcmul_(g, f[:, n_text:])
        return x


class AdaLayerNorm(nn.Module):
    def __init__(self, cond: int, dim: int, eps: float):
        super().__init__()
        self.linear = Linear(cond, 2 * dim)
        self.norm = LayerNorm(dim, eps=eps)

    def forward(self, x, temb):
        shift, scale = self.linear(F.silu(temb))[:, None].chunk(2, dim=2)
        return self.norm(x) * (1 + scale) + shift


class CogVideoXTransformer3DModel(nn.Module):
    def __init__(self, config: CogVideoXConfig = CogVideoXConfig()):
        super().__init__()
        c = self.config = config
        self.patch_embed = PatchEmbed(c)
        self.time_embedding = TimestepEmbedding(c.inner_dim, c.time_embed_dim)
        self.transformer_blocks = nn.ModuleList(CogVideoXBlock(c) for _ in range(c.num_layers))
        self.norm_final = LayerNorm(c.inner_dim, eps=c.norm_eps)
        self.norm_out = AdaLayerNorm(c.time_embed_dim, c.inner_dim, c.norm_eps)
        self.proj_out = Linear(c.inner_dim, c.patch_size ** 2 * c.out_channels)

    @trace.spanned("cogvideox.forward")
    def forward(self, x: torch.Tensor, timestep: torch.Tensor, text: torch.Tensor,
                rope=None) -> torch.Tensor:
        """x (B, F, in_channels, h, w), timestep (B,), text (B, L,
        text_embed_dim) → (B, F, out_channels, h, w) in the model's dtype.
        ``rope``: the (cos, sin) of :func:`rotary_table` (made here when
        None)."""
        c = self.config
        b, f, _, hh, ww = x.shape
        dtype = self.proj_out.weight.dtype
        if rope is None:
            rope = rotary_table(c, f, hh, ww, x.device)
        temb = self.time_embedding(
            get_timestep_embedding(timestep, c.inner_dim, c.flip_sin_to_cos,
                                   c.freq_shift).to(dtype))
        n_text = text.shape[1]
        h = self.patch_embed(text.to(dtype), x.to(dtype))
        for blk in self.transformer_blocks:
            h = blk(h, n_text, temb, rope)
        h = self.proj_out(self.norm_out(self.norm_final(h)[:, n_text:], temb))
        p = c.patch_size
        h = h.reshape(b, f, hh // p, ww // p, -1, p, p)
        return h.permute(0, 1, 4, 2, 5, 3, 6).flatten(5, 6).flatten(3, 4)
