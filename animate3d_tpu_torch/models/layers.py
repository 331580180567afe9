"""The UNet's parameterised layers, computing as flax computes with a
parameter dtype that may differ from the compute dtype.

The JAX trainer keeps the frozen weights in f32 storage under a bf16 model
(``cast_frozen_bf16: false``) and the trainable ones in f32 always. Flax's
rule per layer family, from its sources (``linen/linear.py``,
``linen/normalization.py::_normalize``):

  * ``nn.Dense``, ``nn.Conv`` and the explicit ``kernel.astype(dtype)``
    projections cast the kernel and bias to the compute dtype at use, so a
    f32 weight computes exactly as its bf16 rounding would;
  * ``GroupNorm`` / ``LayerNorm`` take their statistics in f32 and apply
    the scale and bias as stored, promoted to f32, before casting the output
    to the compute dtype: here f32 storage differs from bf16 storage;
  * tables added to activations (the learned position and camera tables)
    are cast to the activations' dtype before the add; the alpha blenders'
    mix factors are read in f32.

These subclasses keep torch's names and state dicts and follow that rule
with the compute dtype taken from the input: where the stored dtype is the
input's, each is the torch layer itself; elsewhere the weights are cast at
use (no second copy is kept; each cast that launches counts under
``utils/trace``'s ``weight_cast`` while a profiler records) and the norms
run in f32.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from animate3d_tpu_torch.utils.trace import cast


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, cast(self.weight, x.dtype), cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, cast(self.weight, x.dtype), cast(self.bias, x.dtype))


class Conv3d(nn.Conv3d):
    """The video models' temporal convolutions (kernel (3, 1, 1) over the
    frames of (B, C, F, H, W)), weights cast at use as :class:`Conv2d`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, cast(self.weight, x.dtype), cast(self.bias, x.dtype))


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == x.dtype:
            return super().forward(x)
        return F.group_norm(x.float(), self.num_groups, cast(self.weight, torch.float32),
                            cast(self.bias, torch.float32), self.eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.dtype == x.dtype:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, cast(self.weight, torch.float32),
                            cast(self.bias, torch.float32), self.eps).to(x.dtype)
