"""The T5 v1.1 encoder (CogVideoX's text tower).

transformers' ``T5EncoderModel`` as released in ``THUDM/CogVideoX-5b-I2V``'s
``text_encoder/`` (T5 v1.1 XXL: 24 layers, d_model 4,096, 64 heads of 64,
gated-GELU feed-forward of 10,240, RMSNorm, no biases), with its parameter
names, so the released state dict loads as it is. The JAX package has no
such model.

Each layer: RMSNorm, self-attention with the bucketed relative position
bias of layer 0 (32 buckets, bidirectional, max distance 128) added to the
unscaled scores, the residual; RMSNorm, ``wo(gelu_tanh(wi_0 x) · wi_1 x)``,
the residual; a final RMSNorm. No attention mask: the CogVideoX pipeline
calls the encoder on its 226 padded ids without one, so every id attends to
every other. Kernel A takes no additive bias, so the attention is plain
torch (once a request, 226 tokens). Float32 (TF32 off on the card), as the
port's other towers. The span ``t5.encoder`` covers a call.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from animate3d_tpu_torch.models.layers import Linear
from animate3d_tpu_torch.utils import trace


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

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4)


class T5LayerNorm(nn.Module):
    """RMSNorm (no mean, no bias), statistics in float32."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        var = x.float().pow(2).mean(-1, keepdim=True)
        return self.weight * (x * torch.rsqrt(var + self.eps)).to(self.weight.dtype)


def relative_position_bucket(rel: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional buckets of key position − query position: half the
    buckets a sign, exact below a quarter of them, logarithmic above."""
    num_buckets //= 2
    out = (rel > 0).to(torch.long) * num_buckets
    rel = rel.abs()
    exact = num_buckets // 2
    large = exact + (torch.log(rel.float().clamp_min(1) / exact) / math.log(max_distance / exact)
                     * (num_buckets - exact)).to(torch.long)
    large = large.clamp(max=num_buckets - 1)
    return out + torch.where(rel < exact, rel, large)


class T5Attention(nn.Module):
    def __init__(self, c: T5Config, has_bias: bool):
        super().__init__()
        inner = c.num_heads * c.d_kv
        self.c = c
        self.q = Linear(c.d_model, inner, bias=False)
        self.k = Linear(c.d_model, inner, bias=False)
        self.v = Linear(c.d_model, inner, bias=False)
        self.o = Linear(inner, c.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(c.relative_attention_num_buckets,
                                                        c.num_heads)

    def position_bias(self, s: int, device) -> torch.Tensor:
        """(1, heads, s, s) float32."""
        pos = torch.arange(s, device=device)
        b = relative_position_bucket(pos[None, :] - pos[:, None],
                                     self.c.relative_attention_num_buckets,
                                     self.c.relative_attention_max_distance)
        return self.relative_attention_bias(b).permute(2, 0, 1)[None].float()

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        split = lambda t: t.view(b, s, self.c.num_heads, self.c.d_kv).transpose(1, 2)
        qh, kh, vh = split(self.q(x)), split(self.k(x)), split(self.v(x))
        p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)).float() + bias, dim=-1)
        return self.o(torch.matmul(p.to(vh.dtype), vh).transpose(1, 2).reshape(b, s, -1))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, c: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(c, has_bias)
        self.layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon)

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x), bias)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.wi_0 = Linear(c.d_model, c.d_ff, bias=False)
        self.wi_1 = Linear(c.d_model, c.d_ff, bias=False)
        self.wo = Linear(c.d_ff, c.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(c)
        self.layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, c: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(c, has_bias), T5LayerFF(c)])

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class T5Stack(nn.Module):
    def __init__(self, c: T5Config):
        super().__init__()
        self.block = nn.ModuleList(T5Block(c, i == 0) for i in range(c.num_layers))
        self.final_layer_norm = T5LayerNorm(c.d_model, c.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    def __init__(self, config: T5Config = T5Config()):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = T5Stack(config)

    @trace.spanned("t5.encoder")
    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (B, L) → the last hidden states (B, L, d_model)."""
        x = self.shared(ids)
        attn = self.encoder.block[0].layer[0].SelfAttention
        bias = attn.position_bias(ids.shape[1], ids.device)
        for blk in self.encoder.block:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)
