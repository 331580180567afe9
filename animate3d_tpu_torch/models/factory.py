"""Model factory: build the MV-VDM UNet + VAE with random weights from a seed.

Port of ``animate3d_tpu/models/factory.py``. Pretrained weights are not in
the repository, so, like the JAX CLI without a weights bundle ("smoke
mode"), the port initialises every parameter from a seed: weight matrices
and conv kernels LeCun-normal, biases zero, norms one/zero, blender mixes
zero — the JAX package's initialisers — then applies the install-time
adapter initialisation of ``adapter_init_parity``. The trainer's build
(``train=True``) is the same seeded init, left in float32 for
``pipelines.train_mvvdm.cast_frozen_bf16`` to take the f32 masters from.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from animate3d_tpu_torch.core.device import resolve_device
from animate3d_tpu_torch.models.attention_layers import (
    CrossViewSelfAttention,
    SpatioTemporalAttention,
)
from animate3d_tpu_torch.models.unet_mv import MVMotionUNet, MVUNetConfig
from animate3d_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from animate3d_tpu_torch.pipelines.train_mvvdm import trainable_mask


@torch.no_grad()
def init_params(module: torch.nn.Module, seed: int) -> None:
    """Seeded in-place init, on the module's device: every parameter with
    two or more dims ~ N(0, 1/fan_in), other ``weight``s one, everything
    else (biases, blender mixes) zero. Then, in every spatial attn1 with the
    I2V branch, ``to_q_i2v`` copies ``to_q`` and ``to_out_i2v`` is zero (the
    branch is an exact no-op at install time); a spatiotemporal attention
    without alpha blender zero-inits its branch out-projections."""
    params = list(module.parameters())
    if not params:
        return
    gen = torch.Generator(device=params[0].device).manual_seed(seed)
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    for m in module.modules():
        if isinstance(m, CrossViewSelfAttention) and m.image_attn:
            m.to_q_i2v.weight.copy_(m.to_q.weight)
            m.to_out_i2v.weight.zero_()
            m.to_out_i2v.bias.zero_()
        if isinstance(m, SpatioTemporalAttention) and not m.use_alpha_blender:
            for out in ("to_out_sp", "to_out_i2v"):
                if hasattr(m, out):
                    getattr(m, out).weight.zero_()


def build_models(model_size: str, num_views: int, device=None, seed: int = 0,
                 dtype: Optional[torch.dtype] = None, train: bool = False,
                 gradient_checkpointing: bool = False
                 ) -> Tuple[MVMotionUNet, AutoencoderKL]:
    """(unet, vae) at ``full`` or ``tiny`` scale on ``device`` (default
    ``cuda``). For sampling the UNet is in eval mode without gradients and
    runs in ``dtype`` (default bf16 on CUDA, float32 on the CPU). With
    ``train`` it stays float32, in train mode, with ``requires_grad`` only on
    the trainable parameters (the trainer casts it). The VAE is float32 and
    frozen."""
    dev = resolve_device(device)
    if model_size == "tiny":
        ucfg, vcfg = MVUNetConfig.tiny(num_views=num_views), VAEConfig.tiny()
    elif model_size == "full":
        ucfg, vcfg = MVUNetConfig(num_views=num_views), VAEConfig()
    else:
        raise ValueError(f"model_size must be 'full' or 'tiny', got {model_size!r}")
    ucfg = dataclasses.replace(ucfg, gradient_checkpointing=gradient_checkpointing)
    with dev:
        unet, vae = MVMotionUNet(ucfg), AutoencoderKL(vcfg)
    init_params(unet, seed)
    init_params(vae, seed + 1)
    vae.eval().requires_grad_(False)
    if train:
        unet.train()
        mask = trainable_mask(unet)
        for name, p in unet.named_parameters():
            p.requires_grad_(mask[name])
        return unet, vae
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    unet.to(dtype).eval().requires_grad_(False)
    return unet, vae
