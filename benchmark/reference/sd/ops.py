"""Plain attention and GEGLU feed-forward for the reference UNet: float32
products and softmax, no kernel, no routing. Operands pass through
``precision.q``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

from benchmark.reference.precision import q as _q

_LOGITS = 1 << 28  # float32 logits held at once


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, s, c = x.shape
    return x.reshape(b, s, h, c // h).transpose(1, 2)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, scale: Optional[float] = None,
                         kv_group: int = 1, self_attention: bool = False) -> torch.Tensor:
    """q (B, Sq, C), k / v (B // kv_group, Sk, C) → (B, Sq, C), in blocks of
    the batch."""
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // num_heads
    scale = d ** -0.5 if scale is None else scale
    step = max(1, _LOGITS // max(1, num_heads * sq * sk))

    def block(qb, kb, vb):
        qh, kh, vh = (_heads(_q(x), num_heads) for x in (qb, kb, vb))
        p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)
        return torch.matmul(_q(p), vh).transpose(1, 2).reshape(qb.shape[0], sq, c)

    outs = []
    for b0 in range(0, b, step):
        b1 = min(b, b0 + step)
        idx = torch.arange(b0, b1, device=q.device) // kv_group
        args = (q[b0:b1], k[idx], v[idx])
        # under autograd each block's probabilities are recomputed in the
        # backward rather than kept: the same function, bounded memory
        outs.append(torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else block(*args))
    return torch.cat(outs).to(q.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * (2.0 ** -0.5)))


def geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """(x W1ᵀ + b1) split into (h, g); (h · gelu(g)) W2ᵀ + b2."""
    p = torch.nn.functional.linear(_q(x), _q(w1), b1.float())
    h, g = p.chunk(2, dim=-1)
    return torch.nn.functional.linear(_q(h * gelu_exact(g)), _q(w2), b2.float()).to(x.dtype)
