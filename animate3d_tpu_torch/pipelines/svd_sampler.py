"""Stable Video Diffusion image-to-video sampling.

diffusers' ``StableVideoDiffusionPipeline`` with the released SVD-XT
defaults: one conditioning image (B = 1 a request) through the CLIP ViT-H/14
vision tower (the image embedding, one token) and, with noise augmentation,
through the VAE encoder (the image latent, unscaled, repeated over the
frames and concatenated to the noisy latents on the channel axis); the
added time ids (fps − 1, motion bucket, noise augmentation); batched
classifier-free guidance ([uncond, cond] in one UNet call: zero image
embedding and zero image latents for the first half) with a scale ramped
linearly over the frames; Euler-EDM steps (``models/diffusion.py``); the
temporal decode in chunks of ``decode_chunk_size`` frames.

Latents are ``(B, F, 4, h, w)`` float32 between steps; the UNet computes in
its own dtype. The steps' numbers are host floats, so a step waits on the
card only where it ends (the device synchronise that times it).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from animate3d_tpu_torch.models.clip import encode_ip_adapter_images
from animate3d_tpu_torch.models.diffusion import EulerEDMConfig, EulerEDMScheduler
from animate3d_tpu_torch.utils import trace


@dataclass(frozen=True)
class SVDSamplerConfig:
    num_frames: int = 25
    height: int = 576
    width: int = 1024
    num_inference_steps: int = 25
    min_guidance_scale: float = 1.0
    max_guidance_scale: float = 3.0
    fps: int = 7  # the added time id is fps - 1
    motion_bucket_id: int = 127
    noise_aug_strength: float = 0.02
    decode_chunk_size: int = 25


@dataclass
class Conditioning:
    """A request's conditioning: the image embedding (B, 1, D) and the
    noise-augmented image latent (B, 4, h, w), unscaled, both float32."""

    embeds: torch.Tensor
    image_latents: torch.Tensor


class SVDSampler:
    """Sampler around an :class:`~animate3d_tpu_torch.models.unet_svd.SVDUNet`,
    its VAE and vision tower. ``step_seconds`` collects the wall time of each
    Euler step (the CFG batch through the UNet and the step), each ended by
    a device synchronise on CUDA."""

    def __init__(self, unet, vae, vision, cfg: SVDSamplerConfig = SVDSamplerConfig(),
                 scheduler_config: EulerEDMConfig = EulerEDMConfig()):
        self.unet, self.vae, self.vision, self.cfg = unet, vae, vision, cfg
        self.device = next(unet.parameters()).device
        self.scheduler = EulerEDMScheduler(scheduler_config, cfg.num_inference_steps)
        vc = vae.config
        down = 2 ** (len(vc.block_out_channels) - 1)
        self.latent_shape = (cfg.num_frames, vc.latent_channels, cfg.height // down,
                             cfg.width // down)
        self.scaling_factor = vc.scaling_factor
        self.step_seconds: List[float] = []

    def guidance_scale(self) -> torch.Tensor:
        """(1, F, 1, 1, 1): linspace(min, max, F), one scale a frame."""
        c = self.cfg
        g = torch.linspace(c.min_guidance_scale, c.max_guidance_scale, c.num_frames,
                           device=self.device)
        return g.reshape(1, -1, 1, 1, 1)

    def added_time_ids(self, batch: int) -> torch.Tensor:
        """(2B, 3) for the CFG batch: fps - 1, motion bucket, noise augmentation."""
        c = self.cfg
        ids = torch.tensor([[c.fps - 1, c.motion_bucket_id, c.noise_aug_strength]],
                           dtype=torch.float32, device=self.device)
        return ids.repeat(2 * batch, 1)

    @torch.no_grad()
    def condition(self, image: torch.Tensor, generator: torch.Generator) -> Conditioning:
        """``image`` (B, H, W, 3) in [0, 1] → the CLIP image embedding (of the
        clean image) and the VAE posterior's mode of ``2 image - 1 +
        noise_aug_strength * noise``, the noise drawn from ``generator``."""
        with trace.span("svd_sampler.condition"):
            embeds = encode_ip_adapter_images(self.vision, image).float()[:, None, :]
            x = image * 2.0 - 1.0
            noise = torch.randn(x.shape, generator=generator, device=x.device)
            lat = self.vae.encode_mode(x + self.cfg.noise_aug_strength * noise)
        return Conditioning(embeds=embeds, image_latents=lat.permute(0, 3, 1, 2).float())

    def initial_latents(self, batch: int, generator: torch.Generator) -> torch.Tensor:
        """(B, F, 4, h, w) noise scaled by the scheduler's initial sigma."""
        noise = torch.randn((batch,) + self.latent_shape, generator=generator,
                            device=self.device)
        return noise * self.scheduler.init_noise_sigma

    @torch.no_grad()
    def denoise(self, latents: torch.Tensor, cond: Conditioning) -> torch.Tensor:
        """The Euler loop with batched CFG: the first half of each UNet call
        has zero image embedding and zero image latents."""
        sched, f = self.scheduler, self.cfg.num_frames
        b = latents.shape[0]
        embeds = torch.cat([torch.zeros_like(cond.embeds), cond.embeds])
        image_lat = cond.image_latents[:, None].expand(-1, f, -1, -1, -1)
        image_lat = torch.cat([torch.zeros_like(image_lat), image_lat])
        ids = self.added_time_ids(b)
        scale = self.guidance_scale()
        for i, t in enumerate(sched.timesteps):
            sigma, sigma_next = sched.sigmas[i], sched.sigmas[i + 1]
            t0 = time.perf_counter()
            with trace.span("svd_sampler.step"):
                x = torch.cat([latents, latents]) * sched.c_in(sigma)
                out = self.unet(torch.cat([x, image_lat], dim=2), t, embeds, ids).float()
                uncond, cond_out = out.chunk(2)
                guided = uncond + scale * (cond_out - uncond)
                latents = sched.step(sched.denoised(guided, latents, sigma), latents, sigma,
                                     sigma_next)
                if latents.is_cuda:
                    trace.synchronize(latents.device)
            self.step_seconds.append(time.perf_counter() - t0)
        return latents

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, F, 4, h, w) → (B, F, H, W, 3) in [-1, 1], float32: the
        temporal decoder on ``decode_chunk_size`` frames at a time."""
        b, f = latents.shape[:2]
        z = (latents.flatten(0, 1) / self.scaling_factor).permute(0, 2, 3, 1)
        n = self.cfg.decode_chunk_size
        frames = [self.vae.decode(z[i:i + n], z[i:i + n].shape[0]) for i in range(0, b * f, n)]
        return torch.cat(frames).reshape((b, f) + frames[0].shape[1:])

    def sample(self, image: torch.Tensor, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """One request: conditioning, noise, the Euler loop → final latents."""
        gen = generator or torch.Generator(device=self.device)
        cond = self.condition(image, gen)
        latents = self.initial_latents(image.shape[0], gen)
        return self.denoise(latents, cond)
