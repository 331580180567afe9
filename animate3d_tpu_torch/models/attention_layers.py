"""MV-VDM attention behaviours as torch modules.

Port of ``animate3d_tpu/models/attention_layers.py``: the same token layouts
(inputs ``(B·N·F, L, C)`` for the spatial attentions, ``(B·N·h·w, F, C)``
for the motion attentions), the same bias pattern (q/k/v bias-free,
out-projections biased) and diffusers parameter names. Projections are
``layers.Linear`` (weights cast to the activations' dtype at use); the
attention itself goes through
:func:`~animate3d_tpu_torch.ops.attention.multi_head_attention`, which takes
kernel A or B on CUDA where the TPU took its Pallas kernels. The TPU's
128-lane head padding of the projection weights is not carried over: the
kernels read heads from the unpadded merged layout by stride.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from animate3d_tpu_torch.models.embeddings import (
    LearnedPositionalEncoding2D,
    add_temporal_positional_embedding,
    sine_positional_encoding_2d,
    sinusoidal_positions,
)
from animate3d_tpu_torch.models.layers import Linear
from animate3d_tpu_torch.ops.attention import multi_head_attention
from animate3d_tpu_torch.ops.geglu import geglu_ff
from animate3d_tpu_torch.utils.trace import cast


def _proj(in_dim: int, out_dim: int) -> Linear:
    return Linear(in_dim, out_dim, bias=False)


class CrossViewSelfAttention(nn.Module):
    """Spatial attn1: dense attention over all views' tokens of one frame,
    ``(b n f) l c → (b f) (n l) c``, with the optional MVDream-I2V branch
    whose queries come from ``to_q_i2v`` and whose K/V are frame 0's."""

    def __init__(self, channels: int, num_heads: int, num_views: int,
                 image_attn: bool = False):
        super().__init__()
        c = channels
        self.num_heads, self.num_views, self.image_attn = num_heads, num_views, image_attn
        self.to_q, self.to_k, self.to_v = _proj(c, c), _proj(c, c), _proj(c, c)
        self.to_out = nn.ModuleList([Linear(c, c)])
        if image_attn:
            self.to_q_i2v = _proj(c, c)
            self.to_out_i2v = Linear(c, c)

    def forward(self, x: torch.Tensor, num_frames: int) -> torch.Tensor:
        bnf, l, c = x.shape
        n, f = self.num_views, num_frames
        b = bnf // (n * f)
        xr = x.reshape(b, n, f, l, c).transpose(1, 2).reshape(b * f, n * l, c)
        k, v = self.to_k(xr), self.to_v(xr)
        h = multi_head_attention(self.to_q(xr), k, v, self.num_heads,
                                 self_attention=True)
        if self.image_attn:
            # frame-0 K/V shared by the f frames of each batch: a strided
            # view, attended through kv_group (never broadcast in memory)
            k0 = k.reshape(b, f, n * l, c)[:, 0]
            v0 = v.reshape(b, f, n * l, c)[:, 0]
            hi = multi_head_attention(self.to_q_i2v(xr), k0, v0, self.num_heads,
                                      kv_group=f)
            # reference order: to_out_0(h + to_out_i2v(hi))
            h = h + self.to_out_i2v(hi)
        h = self.to_out[0](h)
        return h.reshape(b, f, n, l, c).transpose(1, 2).reshape(bnf, l, c)


class TextCrossAttention(nn.Module):
    """attn2: text cross-attention plus the IP-Adapter branch over the
    image tokens, scale-weighted sum."""

    def __init__(self, channels: int, num_heads: int, context_dim: int = 768,
                 ip_enabled: bool = True, ip_scale: float = 1.0):
        super().__init__()
        c = channels
        self.num_heads, self.ip_enabled, self.ip_scale = num_heads, ip_enabled, ip_scale
        self.to_q = _proj(c, c)
        self.to_k, self.to_v = _proj(context_dim, c), _proj(context_dim, c)
        if ip_enabled:
            self.to_k_ip, self.to_v_ip = _proj(context_dim, c), _proj(context_dim, c)
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                ip_context: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = self.to_q(x)
        h = multi_head_attention(q, self.to_k(context), self.to_v(context),
                                 self.num_heads)
        if self.ip_enabled and ip_context is not None:
            h_ip = multi_head_attention(q, self.to_k_ip(ip_context),
                                        self.to_v_ip(ip_context), self.num_heads)
            h = h + self.ip_scale * h_ip
        return self.to_out[0](h)


class AlphaBlender(nn.Module):
    """Learned sigmoid mix of two streams, alpha x_a + (1 - alpha) x_b,
    alpha = sigmoid(mix_factor) (init ``mix``: 0 → 0.5 / 0.5), in f32. As
    diffusers' video ``AlphaBlender``: where ``image_only`` (broadcast to
    the streams, 1 on frames that are still images) is set alpha is 1
    (``learned_with_images``), and ``switch``
    (``switch_spatial_to_temporal_mix``) then takes 1 - alpha."""

    def __init__(self, mix: float = 0.0, switch: bool = False):
        super().__init__()
        self.mix = float(mix)  # the published initial mix, for a seeded build
        self.mix_factor = nn.Parameter(torch.full((1,), self.mix))
        self.switch = switch

    def forward(self, x_a: torch.Tensor, x_b: torch.Tensor,
                image_only: Optional[torch.Tensor] = None) -> torch.Tensor:
        alpha = torch.sigmoid(self.mix_factor.float())[0]
        if image_only is not None:
            alpha = torch.where(image_only.bool(), 1.0, alpha)
        if self.switch:
            alpha = 1.0 - alpha
        return (alpha * x_a.float() + (1.0 - alpha) * x_b.float()).to(x_a.dtype)


class SoftmaxAlphaBlender(nn.Module):
    """3-way softmax mix of the spatial, temporal and image streams."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.zeros(3))

    def forward(self, x_sp, x_temp, x_img) -> torch.Tensor:
        a = torch.softmax(self.mix_factor.float(), dim=0)
        out = a[0] * x_sp.float() + a[1] * x_temp.float() + a[2] * x_img.float()
        return out.to(x_sp.dtype)


class SpatioTemporalAttention(nn.Module):
    """Motion-module attention over frames, ``(b n h w) f c``, with the
    optional cross-view spatial branch (``to_*_sp`` + 2D and camera
    encodings) and image branch (``to_*_i2v`` against frame-0 tokens),
    merged by plain addition or a learned alpha blender.

    ``spatial_size`` (h, w) sizes the learnable 2D encoding's tables, which
    the JAX module sizes from its first call."""

    def __init__(self, channels: int, num_heads: int, num_views: int,
                 spatial_attn: bool = True, image_attn: bool = False,
                 use_alpha_blender: bool = True,
                 spatial_encoding: Optional[str] = "sinusoid",
                 camera_encoding: Optional[str] = None,
                 max_seq_length: int = 32,
                 spatial_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        c = channels
        self.num_heads, self.num_views = num_heads, num_views
        self.spatial_attn, self.image_attn = spatial_attn, image_attn
        self.use_alpha_blender = use_alpha_blender
        self.spatial_encoding = spatial_encoding if spatial_attn else None
        self.camera_encoding = camera_encoding if spatial_attn else None
        self.max_seq_length = max_seq_length
        self.to_q, self.to_k, self.to_v = _proj(c, c), _proj(c, c), _proj(c, c)
        self.to_out = nn.ModuleList([Linear(c, c)])
        if spatial_attn:
            if self.spatial_encoding == "learnable":
                if spatial_size is None:
                    raise ValueError("learnable spatial encoding needs spatial_size")
                self.spatial_pos_embed = LearnedPositionalEncoding2D(
                    c // 2, row_num_embed=spatial_size[0],
                    col_num_embed=spatial_size[1])
            if self.camera_encoding == "learnable":
                self.camera_embed = nn.Parameter(torch.zeros(num_views, c))
            self.to_q_sp, self.to_k_sp, self.to_v_sp = _proj(c, c), _proj(c, c), _proj(c, c)
            self.to_out_sp = Linear(c, c)
        if image_attn:
            self.to_q_i2v, self.to_k_i2v, self.to_v_i2v = _proj(c, c), _proj(c, c), _proj(c, c)
            self.to_out_i2v = Linear(c, c)
        if use_alpha_blender and spatial_attn and image_attn:
            self.alpha_blender = SoftmaxAlphaBlender()
        elif use_alpha_blender and (spatial_attn or image_attn):
            self.alpha_blender = AlphaBlender()

    def forward(self, x: torch.Tensor, height: int, width: int) -> torch.Tensor:
        bl, f, c = x.shape
        n = self.num_views
        hw = height * width
        b = bl // (n * hw)
        use_extra_encoding = self.spatial_attn and (
            self.spatial_encoding is not None or self.camera_encoding is not None)

        if self.spatial_attn:
            xs = x.reshape(b, n * hw, f, c).transpose(1, 2).reshape(b * f, n * hw, c)
            if self.spatial_encoding == "sinusoid":
                pe = sine_positional_encoding_2d(height, width, c // 2, device=x.device)
                xs = xs + pe.reshape(1, hw, c).repeat(1, n, 1).to(xs.dtype)
            elif self.spatial_encoding == "learnable":
                pe = self.spatial_pos_embed(height, width)
                xs = xs + pe.reshape(1, hw, c).repeat(1, n, 1).to(xs.dtype)
            if self.camera_encoding == "sinusoid":
                cam_pe = sinusoidal_positions(n, c, x.device)
                xs = xs + cam_pe.repeat_interleave(hw, dim=0)[None].to(xs.dtype)
            elif self.camera_encoding == "learnable":
                xs = xs + self.camera_embed.repeat_interleave(hw, dim=0)[None].to(xs.dtype)

        if self.image_attn:
            xi = x.reshape(b * n, hw, f, c).transpose(1, 2).reshape(b * n * f, hw, c)

        if use_extra_encoding:
            x = add_temporal_positional_embedding(x, self.max_seq_length)

        h_t = multi_head_attention(self.to_q(x), self.to_k(x), self.to_v(x),
                                   self.num_heads, self_attention=True)
        h_t = self.to_out[0](h_t)

        h_sp = None
        if self.spatial_attn:
            hs = multi_head_attention(self.to_q_sp(xs), self.to_k_sp(xs),
                                      self.to_v_sp(xs), self.num_heads,
                                      self_attention=True)
            hs = self.to_out_sp(hs)
            h_sp = hs.reshape(b, f, n * hw, c).transpose(1, 2).reshape(bl, f, c)

        h_img = None
        if self.image_attn:
            x0 = xi.reshape(b * n, f, hw, c)[:, 0]  # first-frame tokens
            hi = multi_head_attention(self.to_q_i2v(xi), self.to_k_i2v(x0),
                                      self.to_v_i2v(x0), self.num_heads,
                                      kv_group=f)
            hi = self.to_out_i2v(hi)
            h_img = hi.reshape(b * n, f, hw, c).transpose(1, 2).reshape(bl, f, c)

        if not self.use_alpha_blender:
            h = h_t
            if h_sp is not None:
                h = h + h_sp
            if h_img is not None:
                h = h + h_img
            return h
        if h_sp is not None and h_img is not None:
            return self.alpha_blender(h_sp, h_t, h_img)
        if h_sp is not None:
            return self.alpha_blender(h_sp, h_t)
        if h_img is not None:
            return self.alpha_blender(h_img, h_t)
        return h_t


class TemporalSelfAttention(nn.Module):
    """Plain AnimateDiff temporal self-attention (no spatial/image branch)."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        c = channels
        self.num_heads = num_heads
        self.to_q, self.to_k, self.to_v = _proj(c, c), _proj(c, c), _proj(c, c)
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = multi_head_attention(self.to_q(x), self.to_k(x), self.to_v(x),
                                 self.num_heads, self_attention=True)
        return self.to_out[0](h)


class _GEGLUProj(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)


class FeedForwardGEGLU(nn.Module):
    """diffusers FeedForward with GEGLU and exact (erf) GELU; parameters at
    ``net.0.proj`` and ``net.2``. Runs as kernel C on CUDA
    (:func:`~animate3d_tpu_torch.ops.geglu.geglu_ff`)."""

    def __init__(self, channels: int, mult: int = 4):
        super().__init__()
        inner = channels * mult
        self.net = nn.ModuleList([_GEGLUProj(channels, inner), nn.Identity(),
                                  Linear(inner, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj, out = self.net[0].proj, self.net[2]
        return geglu_ff(x, *(cast(t, x.dtype) for t in (proj.weight, proj.bias, out.weight,
                                                         out.bias)))
