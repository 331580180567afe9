"""Model factory: build the MV-VDM UNet, VAE and CLIP towers from a seed,
then load released weights where they exist.

Port of ``animate3d_tpu/models/factory.py``. :func:`build_models`
initialises every parameter from a seed: weight matrices and conv kernels
LeCun-normal, biases zero, norms one/zero, blender mixes zero — the JAX
package's initialisers — then applies the install-time adapter
initialisation of ``adapter_init_parity``. The trainer's build
(``train=True``) is the same seeded init, left in float32 for
``pipelines.train_mvvdm.cast_frozen_bf16`` to take the f32 masters from.
:func:`init_and_load` then reads the released torch artifacts under a root
(``convert/weights.py``) and a motion checkpoint or the port trainer's
motion export; without them it warns (smoke mode) and keeps the seeded
weights.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from animate3d_tpu_torch.core.device import resolve_device
from animate3d_tpu_torch.models.attention_layers import (
    CrossViewSelfAttention,
    SpatioTemporalAttention,
)
from animate3d_tpu_torch.models.clip import (
    CLIPTextConfig,
    CLIPTextModel,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
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
                 gradient_checkpointing: bool = False, clip: bool = True) -> tuple:
    """(unet, vae, text_model, vision_model) at ``full`` or ``tiny`` scale on
    ``device`` (default ``cuda``). For sampling the UNet is in eval mode
    without gradients and runs in ``dtype`` (default bf16 on CUDA, float32
    on the CPU). With ``train`` it stays float32, in train mode, with
    ``requires_grad`` only on the trainable parameters (the trainer casts
    it). The VAE and the CLIP towers are float32 and frozen; the towers are
    None without ``clip``. At ``tiny`` the towers take the JAX factory's
    sizes: text vocab 576 (a byte-level test tokenizer) at the UNet's
    cross-attention width, vision projection to its image-embed width."""
    dev = resolve_device(device)
    if model_size == "tiny":
        ucfg, vcfg = MVUNetConfig.tiny(num_views=num_views), VAEConfig.tiny()
        tcfg = CLIPTextConfig.tiny(hidden_size=ucfg.cross_attention_dim,
                                   max_position_embeddings=77, vocab_size=576,
                                   num_heads=max(ucfg.cross_attention_dim // 16, 1))
        icfg = CLIPVisionConfig.tiny(projection_dim=ucfg.image_embed_dim)
    elif model_size == "full":
        ucfg, vcfg = MVUNetConfig(num_views=num_views), VAEConfig()
        tcfg, icfg = CLIPTextConfig(), CLIPVisionConfig()
    else:
        raise ValueError(f"model_size must be 'full' or 'tiny', got {model_size!r}")
    ucfg = dataclasses.replace(ucfg, gradient_checkpointing=gradient_checkpointing)
    with dev:
        unet, vae = MVMotionUNet(ucfg), AutoencoderKL(vcfg)
        towers = (CLIPTextModel(tcfg), CLIPVisionModelWithProjection(icfg)) if clip \
            else (None, None)
    init_params(unet, seed)
    init_params(vae, seed + 1)
    vae.eval().requires_grad_(False)
    for i, tower in enumerate(towers):
        if tower is not None:
            init_params(tower, seed + 2 + i)
            tower.eval().requires_grad_(False)
    if train:
        unet.train()
        mask = trainable_mask(unet)
        for name, p in unet.named_parameters():
            p.requires_grad_(mask[name])
        return (unet, vae) + towers
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    unet.to(dtype).eval().requires_grad_(False)
    return (unet, vae) + towers


def init_and_load(unet, vae, text_model, vision_model, flax_params_dir: Optional[str],
                  pretrained_unet_path: Optional[str]) -> tuple:
    """Load released weights into the seeded modules, as the JAX package's
    ``init_and_load`` grafts its bundle: the artifacts under
    ``flax_params_dir`` (the artifact root of ``convert/weights.py``), then
    ``pretrained_unet_path``, either the port trainer's motion export (a
    directory) or the released motion checkpoint (a file).

    Returns (unet, vae, text_model or None, vision_model or None, loaded: the
    set of components that came from files); a tower whose weights are not
    on disk is None, as the JAX package's params are."""
    from animate3d_tpu_torch.convert import weights as W

    loaded = set()
    text_out = vision_out = None
    if flax_params_dir and os.path.isdir(flax_params_dir):
        dtype = next(unet.parameters()).dtype
        unet.float()  # released files are f32: round once, after loading
        audit = W.load_artifacts(flax_params_dir, unet, vae, text_model, vision_model)
        unet.to(dtype)
        loaded = set(audit)
        text_out = text_model if "text_encoder" in audit else None
        vision_out = vision_model if "image_encoder" in audit else None
        print(f"[weights] loaded {sorted(loaded)} from {flax_params_dir}: {audit}")
    if pretrained_unet_path and os.path.isdir(pretrained_unet_path):
        path, n = W.load_motion_export(unet, pretrained_unet_path)
        loaded.add("motion_ckpt")
        print(f"[weights] motion modules grafted from {path} ({n} tensors; base UNet keys "
              "keep their init/bundle values — strict=False parity)")
    elif pretrained_unet_path and os.path.exists(pretrained_unet_path):
        n_missing = W.load_animate3d_motion_checkpoint(unet, pretrained_unet_path)
        loaded.add("motion_ckpt")
        print(f"[weights] motion checkpoint loaded; missing (frozen) keys: {n_missing}")
    if "unet" not in loaded and "motion_ckpt" not in loaded:
        print("WARNING: no UNet weights given — random init (smoke mode)")
    return unet, vae, text_out, vision_out, loaded


def has_tokenizer(root: Optional[str]) -> bool:
    from animate3d_tpu_torch.convert.weights import tokenizer_root

    return tokenizer_root(root) is not None


def encode_text(prompt: str, negative_prompt: str, n_views: int, text_model,
                tokenizer_root: str, max_length: int = 77):
    """[prompt, negative] → per-view (n_views, 77, D) cond / uncond
    embeddings (float32, on the tower's device)."""
    from animate3d_tpu_torch.convert.weights import tokenizer_root as find_root
    from animate3d_tpu_torch.utils.tokenizer import ClipTokenizer, find_tokenizer_files

    tok = ClipTokenizer(*find_tokenizer_files(find_root(tokenizer_root) or tokenizer_root),
                        max_length=max_length)
    dev = next(text_model.parameters()).device
    with torch.no_grad():
        out = text_model(torch.as_tensor(tok([prompt, negative_prompt]), dtype=torch.long,
                                         device=dev)).float()
    return out[0:1].repeat(n_views, 1, 1), out[1:2].repeat(n_views, 1, 1)


def build_svd_models(model_size: str = "full", device=None, seed: int = 0,
                     dtype: Optional[torch.dtype] = None) -> tuple:
    """(unet, vae, vision_model) of Stable Video Diffusion XT at ``full``
    (the released configs) or ``tiny`` scale on ``device`` (default
    ``cuda``), seeded as :func:`build_models` seeds the MV-VDM, every
    blender's mix then at its published initial value (0.5 in the UNet, 0
    in the decoder). The UNet samples in ``dtype`` (default bf16 on CUDA,
    float32 on the CPU); the VAE and the vision tower are float32. All in
    eval mode, frozen."""
    from animate3d_tpu_torch.models.attention_layers import AlphaBlender
    from animate3d_tpu_torch.models.unet_svd import SVDUNet, SVDUNetConfig
    from animate3d_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder

    dev = resolve_device(device)
    if model_size == "tiny":
        ucfg = SVDUNetConfig.tiny()
        vcfg = VAEConfig(block_out_channels=(32, 64), norm_num_groups=32)
        icfg = CLIPVisionConfig.tiny(projection_dim=ucfg.cross_attention_dim)
    elif model_size == "full":
        ucfg, vcfg, icfg = SVDUNetConfig(), VAEConfig(), CLIPVisionConfig()
    else:
        raise ValueError(f"model_size must be 'full' or 'tiny', got {model_size!r}")
    with dev:
        unet, vae = SVDUNet(ucfg), AutoencoderKLTemporalDecoder(vcfg)
        vision = CLIPVisionModelWithProjection(icfg)
    for i, m in enumerate((unet, vae, vision)):
        init_params(m, seed + i)
        for blender in m.modules():
            if isinstance(blender, AlphaBlender):
                with torch.no_grad():
                    blender.mix_factor.fill_(blender.mix)
        m.eval().requires_grad_(False)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    unet.to(dtype)
    return unet, vae, vision


def build_cogvideox_models(model_size: str = "full", device=None, seed: int = 0,
                           dtype: Optional[torch.dtype] = None) -> tuple:
    """(transformer, vae, t5) of CogVideoX-5B-I2V at ``full`` (the released
    configs) or ``tiny`` scale on ``device`` (default ``cuda``), seeded as
    :func:`build_models` seeds the MV-VDM. The transformer samples in
    ``dtype`` (default bf16 on CUDA, float32 on the CPU); the VAE and the T5
    encoder are float32. All in eval mode, frozen."""
    from animate3d_tpu_torch.models.t5 import T5Config, T5EncoderModel
    from animate3d_tpu_torch.models.transformer_cogvideox import (
        CogVideoXConfig,
        CogVideoXTransformer3DModel,
    )
    from animate3d_tpu_torch.models.vae_cogvideox import AutoencoderKLCogVideoX, VAE3DConfig

    dev = resolve_device(device)
    if model_size == "tiny":
        tcfg = T5Config.tiny()
        ccfg, vcfg = CogVideoXConfig.tiny(tcfg.d_model), VAE3DConfig.tiny()
    elif model_size == "full":
        ccfg, vcfg, tcfg = CogVideoXConfig(), VAE3DConfig(), T5Config()
    else:
        raise ValueError(f"model_size must be 'full' or 'tiny', got {model_size!r}")
    with dev:
        mods = (CogVideoXTransformer3DModel(ccfg), AutoencoderKLCogVideoX(vcfg),
                T5EncoderModel(tcfg))
    for i, m in enumerate(mods):
        init_params(m, seed + i)
        m.eval().requires_grad_(False)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    mods[0].to(dtype)
    return mods
