"""MV-VDM denoiser: multi-view motion UNet (port of animate3d_tpu/models/unet_mv.py).

SD1.5 topology with MVDream camera conditioning, AnimateDiff motion modules
after every spatial block, cross-view / I2V / IP-Adapter attention. The
public layout is the JAX one, latents ``(B·N, F, h, w, C)``; inside, the
UNet runs on NCHW ``(B·N·F, C, h, w)``. Parameter names are the diffusers
names (``down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_q.weight``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from animate3d_tpu_torch.models.embeddings import (
    ImageProjection,
    TimestepEmbedding,
    compose_frame_time_embeddings,
    get_timestep_embedding,
)
from animate3d_tpu_torch.models.layers import Conv2d, GroupNorm
from animate3d_tpu_torch.models.unet_blocks import (
    Downsample2D,
    MotionAttnConfig,
    MotionModule,
    ResnetBlock2D,
    SpatialTransformer,
    Upsample2D,
)
from animate3d_tpu_torch.models import unet_graph
from animate3d_tpu_torch.ops import routing
from animate3d_tpu_torch.utils import trace


@dataclass(frozen=True)
class MVUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_heads: int = 8
    cross_attention_dim: int = 768
    motion_num_heads: int = 8
    motion_max_seq_length: int = 32
    camera_embedding_dim: Optional[int] = 16
    num_views: int = 4
    ip_enabled: bool = True
    ip_num_tokens: int = 4
    ip_scale: float = 1.0
    image_embed_dim: int = 1024
    mv_image_attn: bool = True
    motion_attn: MotionAttnConfig = field(default_factory=MotionAttnConfig)
    # recompute every ResnetBlock2D / SpatialTransformer / MotionModule in
    # the backward pass instead of storing its activations (the reference's
    # unet.enable_gradient_checkpointing(); the JAX package's nn.remat)
    gradient_checkpointing: bool = False
    # (h, w) of the latents the learnable spatial encoding's tables are
    # sized for (the JAX module sizes them from the input of its ``init``);
    # each level's tables take that level's size
    latent_size: Optional[Tuple[int, int]] = None

    @staticmethod
    def tiny(**kw) -> "MVUNetConfig":
        """Small config for tests and dry runs."""
        defaults = dict(block_out_channels=(32, 64), num_heads=2,
                        motion_num_heads=2, cross_attention_dim=32,
                        image_embed_dim=16)
        defaults.update(kw)
        return MVUNetConfig(**defaults)


class _Block(nn.Module):
    """Container giving a UNet level its diffusers names (resnets,
    attentions, motion_modules, down/upsamplers)."""

    def __init__(self, resnets, attentions, motion_modules, sampler_name=None,
                 sampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        self.motion_modules = nn.ModuleList(motion_modules)
        if sampler is not None:
            setattr(self, sampler_name, nn.ModuleList([sampler]))


class _EncoderHidProj(nn.Module):
    def __init__(self, proj: ImageProjection):
        super().__init__()
        self.image_projection_layers = nn.ModuleList([proj])


class MVMotionUNet(nn.Module):
    def __init__(self, config: MVUNetConfig = MVUNetConfig()):
        super().__init__()
        cfg = self.config = config
        # the dtype the UNet computes in; None: its parameters' (the trainer
        # sets it where frozen or trainable weights are stored in f32)
        self.compute_dtype: Optional[torch.dtype] = None
        # the no-grad forward's CUDA graphs, by call signature
        self._graphs = unet_graph.GraphCache()
        learnable = cfg.motion_attn.spatial_encoding == "learnable"
        if learnable and cfg.latent_size is None:
            raise ValueError("the learnable spatial encoding needs MVUNetConfig.latent_size")
        boc = cfg.block_out_channels
        temb = boc[0] * 4
        self.conv_in = Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb)
        if cfg.camera_embedding_dim is not None:
            self.camera_embedding = TimestepEmbedding(cfg.camera_embedding_dim, temb)
        if cfg.ip_enabled:
            self.encoder_hid_proj = _EncoderHidProj(ImageProjection(
                cfg.image_embed_dim, cfg.cross_attention_dim, cfg.ip_num_tokens))

        def st(ch):
            return SpatialTransformer(ch, cfg.num_heads, cfg.num_views,
                                      cfg.cross_attention_dim, cfg.mv_image_attn,
                                      cfg.ip_enabled, cfg.ip_scale)

        def mm(ch, level):
            size = None
            if learnable:  # a stride-2 conv per level down: ceil(h / 2)
                size = tuple(-(-s // 2 ** level) for s in cfg.latent_size)
            return MotionModule(ch, cfg.motion_num_heads, cfg.num_views,
                                cfg.motion_attn, cfg.motion_max_seq_length, size)

        n = len(boc)
        skip_ch = [boc[0]]
        self.down_blocks = nn.ModuleList()
        ch = boc[0]
        for i in range(n):
            resnets, attns, mms = [], [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, boc[i], temb))
                ch = boc[i]
                if i < n - 1:
                    attns.append(st(ch))
                mms.append(mm(ch, i))
                skip_ch.append(ch)
            down = Downsample2D(ch) if i < n - 1 else None
            if down is not None:
                skip_ch.append(ch)
            self.down_blocks.append(_Block(resnets, attns, mms, "downsamplers", down))

        self.mid_block = _Block([ResnetBlock2D(ch, ch, temb), ResnetBlock2D(ch, ch, temb)],
                                [st(ch)], [mm(ch, n - 1)])

        rev = list(reversed(boc))
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            resnets, attns, mms = [], [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch + skip_ch.pop(), rev[i], temb))
                ch = rev[i]
                if i > 0:
                    attns.append(st(ch))
                mms.append(mm(ch, n - 1 - i))
            up = Upsample2D(ch) if i < n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, mms, "upsamplers", up))

        self.conv_norm_out = GroupNorm(32, boc[0], eps=1e-5)
        self.conv_out = Conv2d(boc[0], cfg.out_channels, 3, padding=1)

    def _block(self, fn, *args):
        """One block call, checkpointed when gradient checkpointing is on
        and autograd is recording."""
        if self.config.gradient_checkpointing and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=routing.recompute_contexts)
        return fn(*args)

    @trace.spanned("unet.forward")
    def forward(self, latents: torch.Tensor, timesteps, encoder_hidden_states: torch.Tensor,
                camera: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None,
                i2v_cond_time_zero: bool = False) -> torch.Tensor:
        """latents (B·N, F, h, w, C), timesteps () or (B·N,), text context
        (B·N, 77, D), camera (B·N, 16), image embeds (B·N, D_img) → noise
        prediction (B·N, F, h, w, C_out) in the UNet's compute dtype.

        Without gradients, in eval mode and on CUDA, the forward replays
        from a CUDA graph per call signature (``models/unet_graph.py``);
        otherwise it runs eagerly."""
        if not unet_graph.engages(latents, self.training):
            trace.count(("unet_graph", "eager"), 1)
            return self._forward(latents, timesteps, encoder_hidden_states, camera,
                                 image_embeds, i2v_cond_time_zero)
        tensors = (latents, torch.as_tensor(timesteps, device=latents.device),
                   encoder_hidden_states, camera, image_embeds)
        key = unet_graph.call_key(tensors, i2v_cond_time_zero, self.compute_dtype)
        graphs = self._graphs
        return graphs.run(key, graphs.weights(self), functools.partial(
            self._forward, i2v_cond_time_zero=i2v_cond_time_zero), tensors)

    def _forward(self, latents, timesteps, encoder_hidden_states, camera, image_embeds,
                 i2v_cond_time_zero):
        cfg = self.config
        bn, f, hh, ww, c_in = latents.shape
        if bn % cfg.num_views:
            raise ValueError(f"batch {bn} not divisible by num_views {cfg.num_views}")
        dtype, dev = self.compute_dtype or self.conv_in.weight.dtype, self.conv_in.weight.device
        boc = cfg.block_out_channels

        ts = torch.as_tensor(timesteps, device=dev).reshape(-1).expand(bn)
        emb = self.time_embedding(get_timestep_embedding(ts, boc[0]).to(dtype))
        cond_emb = None
        if i2v_cond_time_zero:
            zeros = torch.zeros((bn,), device=dev)
            cond_emb = self.time_embedding(get_timestep_embedding(zeros, boc[0]).to(dtype))
        if camera is not None and cfg.camera_embedding_dim is not None:
            camera_emb = self.camera_embedding(camera.to(dtype))
            emb = emb + camera_emb
            if cond_emb is not None:
                cond_emb = cond_emb + camera_emb
        emb = compose_frame_time_embeddings(emb, cond_emb, f)

        context = encoder_hidden_states.to(dtype).repeat_interleave(f, dim=0)
        ip_context = None
        if cfg.ip_enabled and image_embeds is not None:
            tokens = self.encoder_hid_proj.image_projection_layers[0](image_embeds.to(dtype))
            ip_context = tokens.repeat_interleave(f, dim=0)

        x = latents.reshape(bn * f, hh, ww, c_in).permute(0, 3, 1, 2).to(dtype)
        x = self.conv_in(x)
        skips = [x]
        run = self._block
        for blk in self.down_blocks:
            for j, resnet in enumerate(blk.resnets):
                x = run(resnet, x, emb)
                if hasattr(blk, "attentions"):
                    x = run(blk.attentions[j], x, context, ip_context, f)
                x = run(blk.motion_modules[j], x, f)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)

        mid = self.mid_block
        x = run(mid.resnets[0], x, emb)
        x = run(mid.attentions[0], x, context, ip_context, f)
        x = run(mid.motion_modules[0], x, f)
        x = run(mid.resnets[1], x, emb)

        for blk in self.up_blocks:
            for j, resnet in enumerate(blk.resnets):
                x = run(resnet, torch.cat([x, skips.pop()], dim=1), emb)
                if hasattr(blk, "attentions"):
                    x = run(blk.attentions[j], x, context, ip_context, f)
                x = run(blk.motion_modules[j], x, f)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = self.conv_out(nn.functional.silu(self.conv_norm_out(x)))
        return x.permute(0, 2, 3, 1).reshape(bn, f, hh, ww, cfg.out_channels)
