"""MV-VDM sampling: DDIM loop with CFG, frame-0 re-injection and FreeInit.

Port of ``animate3d_tpu/pipelines/mv_sampler.py``. The JAX split is kept so
that tests can feed the same numpy noise to both sides (``jax.random`` and
``torch.Generator`` differ): :meth:`MVSampler.prepare_initial_latents`,
the denoise loop :meth:`MVSampler.denoise` (a Python loop where JAX ran
``lax.scan``) and the FreeInit re-noise step
:meth:`MVSampler.freeinit_renoise`. :meth:`MVSampler.sample` draws the
noise from a ``torch.Generator`` and chains them. With
``i2v_similarity_strength`` set (the reference's i2v similarity init), the
run starts from frame 0's latents noised to the step that strength
selects, each later frame kept clean with ``i2v_similarity_origin_prob``,
and only the remaining steps run.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from animate3d_tpu_torch.models.diffusion import (
    DDIMScheduler,
    SchedulerConfig,
    freeinit_blend,
)
from animate3d_tpu_torch.utils import trace
from animate3d_tpu_torch.utils.camera import get_camera


@dataclass(frozen=True)
class MVSamplerConfig:
    num_inference_steps: int = 25
    guidance_scale: float = 7.5
    num_views: int = 4
    num_frames: int = 16
    height: int = 256
    width: int = 256
    vae_scale_factor: int = 8
    latent_channels: int = 4
    latent_scaling: float = 0.18215
    freeinit_enabled: bool = True
    freeinit_num_iters: int = 3
    i2v_cond_time_zero: bool = False
    i2v_similarity_strength: Optional[float] = None  # None: pure noise start
    i2v_similarity_origin_prob: float = 0.0
    camera_elevation: float = 15.0

    @property
    def latent_height(self) -> int:
        return self.height // self.vae_scale_factor

    @property
    def latent_width(self) -> int:
        return self.width // self.vae_scale_factor


class MVSampler:
    """Sampler around an :class:`~animate3d_tpu_torch.models.unet_mv.MVMotionUNet`.

    ``step_seconds`` collects the wall time of every denoise step (the CFG
    pair through the UNet plus the scheduler step), each ended by a device
    synchronise on CUDA."""

    def __init__(self, unet: torch.nn.Module, cfg: MVSamplerConfig = MVSamplerConfig(),
                 scheduler: Optional[DDIMScheduler] = None):
        self.unet = unet
        self.cfg = cfg
        self.device = next(unet.parameters()).device
        self.scheduler = scheduler or DDIMScheduler(SchedulerConfig(), device=self.device)
        self.step_seconds: List[float] = []

    def cameras(self, batch_size: int = 1) -> torch.Tensor:
        """(B·N, 16) orbit camera embedding inputs."""
        cam = get_camera(self.cfg.num_views, elevation=self.cfg.camera_elevation)
        return torch.as_tensor(cam, device=self.device).repeat(batch_size, 1)

    def noise_shape(self, bn: int):
        cfg = self.cfg
        return (bn, cfg.num_frames - 1, cfg.latent_height, cfg.latent_width,
                cfg.latent_channels)

    def prepare_initial_latents(self, noise: torch.Tensor, first_frame_latents: torch.Tensor,
                                origin_uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Clean frame 0 followed by frames 1..F-1: the noise, or with the
        similarity init frame 0's latents noised to the start step, each
        frame replaced by them where ``origin_uniform`` (B·N, F-1, 1, 1, 1)
        in [0, 1) falls under ``i2v_similarity_origin_prob``."""
        cfg = self.cfg
        if cfg.i2v_similarity_strength is None:
            return torch.cat([first_frame_latents, noise], dim=1)
        t_start = self.scheduler.timesteps(cfg.num_inference_steps)[self._similarity_t_start()]
        cond = first_frame_latents.expand(-1, noise.shape[1], -1, -1, -1)
        blurred = self.scheduler.add_noise(cond, noise, t_start)
        mask = (origin_uniform < cfg.i2v_similarity_origin_prob).float()
        return torch.cat([first_frame_latents, mask * cond + (1.0 - mask) * blurred], dim=1)

    def _similarity_t_start(self) -> int:
        cfg = self.cfg
        init_t = min(int(cfg.num_inference_steps * cfg.i2v_similarity_strength),
                     cfg.num_inference_steps)
        return max(cfg.num_inference_steps - init_t, 0)

    def active_timesteps(self) -> torch.Tensor:
        """The DDIM timesteps the run takes (the last ones only, with the
        similarity init)."""
        ts = self.scheduler.timesteps(self.cfg.num_inference_steps)
        if self.cfg.i2v_similarity_strength is not None:
            ts = ts[self._similarity_t_start():]
        return ts

    def denoise(self, latents: torch.Tensor, first_frame_latents: torch.Tensor,
                text_ctx: torch.Tensor, camera: torch.Tensor,
                image_embeds: Optional[torch.Tensor],
                timesteps: torch.Tensor) -> torch.Tensor:
        """One DDIM pass. text_ctx and image_embeds are the CFG pair
        ``[uncond, cond]`` stacked on the batch axis; frame 0 is re-injected
        after every step."""
        cfg = self.cfg
        cam2 = torch.cat([camera, camera], dim=0)
        for t in timesteps:
            t0 = time.perf_counter()
            with trace.span("mv_sampler.step"):
                eps = self.unet(torch.cat([latents, latents], dim=0), t, text_ctx,
                                cam2, image_embeds,
                                i2v_cond_time_zero=cfg.i2v_cond_time_zero)
                eps_uncond, eps_text = eps.chunk(2, dim=0)
                eps = eps_uncond + cfg.guidance_scale * (eps_text - eps_uncond)
                prev, _ = self.scheduler.step(eps.float(), t, latents,
                                              cfg.num_inference_steps)
                latents = torch.cat([first_frame_latents, prev[:, 1:]], dim=1)
                if latents.is_cuda:
                    with trace.span("mv_sampler.step_sync"):
                        trace.synchronize(latents.device)
            self.step_seconds.append(time.perf_counter() - t0)
        return latents

    def freeinit_renoise(self, latents: torch.Tensor, first_frame_latents: torch.Tensor,
                         initial_noise: torch.Tensor,
                         fresh_noise: torch.Tensor) -> torch.Tensor:
        """Re-noise frames 1..F-1 of the previous result to t = T-1 with the
        ORIGINAL initial noise, keep their low frequencies and take the high
        ones from fresh noise."""
        t_max = self.scheduler.config.num_train_timesteps - 1
        diffused = self.scheduler.add_noise(latents[:, 1:], initial_noise, t_max)
        rest = freeinit_blend(diffused, fresh_noise)
        return torch.cat([first_frame_latents, rest], dim=1)

    @torch.inference_mode()
    def sample(self, first_frame_latents: torch.Tensor, text_cond: torch.Tensor,
               text_uncond: torch.Tensor, image_embeds: Optional[torch.Tensor] = None,
               camera: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Full sampling run → final latents (B·N, F, h, w, C)."""
        cfg = self.cfg
        bn = first_frame_latents.shape[0]
        if camera is None:
            camera = self.cameras(bn // cfg.num_views)
        text_ctx = torch.cat([text_uncond, text_cond], dim=0)
        img2 = None
        if image_embeds is not None:
            img2 = torch.cat([torch.zeros_like(image_embeds), image_embeds], dim=0)
        shape = self.noise_shape(bn)
        initial_noise = torch.randn(shape, generator=generator, device=self.device)
        origin_u = None
        if cfg.i2v_similarity_strength is not None:
            origin_u = torch.rand(shape[:2] + (1, 1, 1), generator=generator, device=self.device)
        latents = self.prepare_initial_latents(initial_noise, first_frame_latents, origin_u)
        timesteps = self.active_timesteps()
        num_iters = cfg.freeinit_num_iters if cfg.freeinit_enabled else 1
        for it in range(num_iters):
            with trace.span("mv_sampler.round"):
                if cfg.freeinit_enabled and it > 0:
                    fresh = torch.randn(shape, generator=generator, device=self.device)
                    latents = self.freeinit_renoise(latents, first_frame_latents,
                                                    initial_noise, fresh)
                latents = self.denoise(latents, first_frame_latents, text_ctx, camera,
                                       img2, timesteps)
        return latents


@torch.inference_mode()
def decode_video(vae, latents: torch.Tensor, scaling: float = 0.18215,
                 frame_chunk: int = 16) -> torch.Tensor:
    """(B·N, F, h, w, C) latents → (B·N, F, H, W, 3) images in [0, 1],
    decoded ``frame_chunk`` frames at a time."""
    bn, f, h, w, c = latents.shape
    dtype = next(vae.parameters()).dtype
    flat = (latents / scaling).reshape(bn * f, h, w, c).to(dtype)
    imgs = torch.cat([vae.decode(flat[i:i + frame_chunk])
                      for i in range(0, bn * f, frame_chunk)])
    imgs = (imgs / 2 + 0.5).clamp(0.0, 1.0)
    return imgs.reshape(bn, f, imgs.shape[1], imgs.shape[2], 3)


@torch.inference_mode()
def encode_conditioning_images(vae, images: torch.Tensor,
                               scaling: float = 0.18215) -> torch.Tensor:
    """(N, H, W, 3) images in [-1, 1] → (N, 1, h, w, 4) scaled mode latents."""
    dtype = next(vae.parameters()).dtype
    return (vae.encode_mode(images.to(dtype)) * scaling)[:, None]
