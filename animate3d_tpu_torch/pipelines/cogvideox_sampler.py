"""CogVideoX image-to-video sampling.

diffusers' ``CogVideoXImageToVideoPipeline`` with the released
CogVideoX-5B-I2V defaults: the prompt and the empty negative through the
T5 encoder (226 ids each, no attention mask); the conditioning image
through the 3D VAE's encoder as one latent frame, a posterior sample times
the scaling factor (0.7), zero-padded to the 13 latent frames and
concatenated to the noisy latents on the channel axis (both CFG halves);
the starting noise (``init_noise_sigma`` 1); 50 DDIM steps (v-prediction,
``trailing`` spacing, zero terminal SNR, ``models/diffusion.py``) with
batched classifier-free guidance at 6.0 ([negative, prompt] in one
transformer call); the frame-batched decode of the 13 latent frames to 49.

Latents ``(B, F', 16, h, w)`` float32 between steps; the transformer
computes in its own dtype. The RoPE table is made once; a step's numbers
are host floats, so a step waits on the card only where it ends (the
device synchronise that times it). Spans ``cogvideox_sampler.condition``
and ``cogvideox_sampler.step``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from animate3d_tpu_torch.models.diffusion import DDIMScheduler, SchedulerConfig
from animate3d_tpu_torch.models.transformer_cogvideox import rotary_table
from animate3d_tpu_torch.utils import trace

# scheduler/scheduler_config.json of the release
COGVIDEOX_SCHEDULER = SchedulerConfig(beta_schedule="scaled_linear", steps_offset=0,
                                      prediction_type="v_prediction",
                                      timestep_spacing="trailing", snr_shift_scale=1.0,
                                      rescale_betas_zero_snr=True)


@dataclass(frozen=True)
class CogVideoXSamplerConfig:
    num_frames: int = 49
    height: int = 480
    width: int = 720
    num_inference_steps: int = 50
    guidance_scale: float = 6.0


@dataclass
class Conditioning:
    """A request's conditioning: the T5 states of [negative, prompt] (2B,
    L, D) and the padded image latents (B, F', C, h, w), both float32."""

    text: torch.Tensor
    image_latents: torch.Tensor


def stand_in_ids(prompt: str, length: int = 226, vocab: int = 32128) -> List[int]:
    """Token ids for ``prompt`` where no T5 SentencePiece model is at hand:
    its UTF-8 bytes offset past the special ids, then EOS (1), then padding
    (0) to ``length``. The empty prompt gives [1, 0, ...], as T5's tokenizer
    does."""
    ids = [3 + b for b in prompt.encode("utf-8")][: length - 1]
    ids = [i % vocab for i in ids] + [1]
    return ids + [0] * (length - len(ids))


class CogVideoXSampler:
    """Sampler around a :class:`~animate3d_tpu_torch.models.transformer_cogvideox.CogVideoXTransformer3DModel`,
    its 3D VAE and T5 encoder. ``step_seconds`` collects the wall time of
    each DDIM step (the CFG batch through the transformer and the step),
    each ended by a device synchronise on CUDA."""

    def __init__(self, transformer, vae, t5,
                 cfg: CogVideoXSamplerConfig = CogVideoXSamplerConfig(),
                 scheduler_config: SchedulerConfig = COGVIDEOX_SCHEDULER):
        self.transformer, self.vae, self.t5, self.cfg = transformer, vae, t5, cfg
        self.device = next(transformer.parameters()).device
        self.scheduler = DDIMScheduler(scheduler_config)
        self.timesteps = [int(t) for t in self.scheduler.timesteps(cfg.num_inference_steps)]
        vc = vae.config
        down = 2 ** (len(vc.block_out_channels) - 1)
        frames = (cfg.num_frames - 1) // vc.temporal_compression_ratio + 1
        self.latent_shape = (frames, vc.latent_channels, cfg.height // down, cfg.width // down)
        self.rope = rotary_table(transformer.config, frames, cfg.height // down,
                                 cfg.width // down, self.device)
        self.step_seconds: List[float] = []

    @torch.no_grad()
    def encode_text(self, ids: torch.Tensor, negative_ids: torch.Tensor) -> torch.Tensor:
        """(B, L) prompt and negative ids → T5 states (2B, L, D), negative
        first, float32."""
        return self.t5(torch.cat([negative_ids, ids])).float()

    @torch.no_grad()
    def encode_image(self, image: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """``image`` (B, H, W, 3) in [0, 1] → (B, F', C, h, w): the posterior
        sample of its one latent frame (noise from ``generator``) times the
        scaling factor, then zero frames."""
        x = (image * 2.0 - 1.0).permute(0, 3, 1, 2)[:, :, None]
        mean, logvar = self.vae.encode(x)
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        lat = ((mean + torch.exp(0.5 * logvar) * noise) * self.vae.config.scaling_factor)
        lat = lat.permute(0, 2, 1, 3, 4)
        pad = torch.zeros((lat.shape[0], self.latent_shape[0] - 1) + tuple(lat.shape[2:]),
                          device=lat.device)
        return torch.cat([lat, pad], dim=1).float()

    def condition(self, image: torch.Tensor, ids: torch.Tensor, negative_ids: torch.Tensor,
                  generator: torch.Generator) -> Conditioning:
        with trace.span("cogvideox_sampler.condition"):
            text = self.encode_text(ids, negative_ids)
            lat = self.encode_image(image, generator)
        return Conditioning(text=text, image_latents=lat)

    def initial_latents(self, batch: int, generator: torch.Generator) -> torch.Tensor:
        """(B, F', C, h, w) noise (``init_noise_sigma`` is 1)."""
        return torch.randn((batch,) + self.latent_shape, generator=generator, device=self.device)

    @torch.no_grad()
    def denoise(self, latents: torch.Tensor, cond: Conditioning) -> torch.Tensor:
        """The DDIM loop with batched CFG: [negative, prompt] in one call, the
        image latents in both halves."""
        n, g = self.cfg.num_inference_steps, self.cfg.guidance_scale
        image = torch.cat([cond.image_latents, cond.image_latents])
        for t in self.timesteps:
            c_x, c_m = self.scheduler.step_coefficients(t, n)
            t0 = time.perf_counter()
            with trace.span("cogvideox_sampler.step"):
                x = torch.cat([torch.cat([latents, latents]), image], dim=2)
                ts = torch.full((x.shape[0],), t, dtype=torch.int64, device=self.device)
                out = self.transformer(x, ts, cond.text, self.rope).float()
                uncond, text = out.chunk(2)
                v = uncond + g * (text - uncond)
                latents = c_x * latents + c_m * v
                if latents.is_cuda:
                    trace.synchronize(latents.device)
            self.step_seconds.append(time.perf_counter() - t0)
        return latents

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, F', C, h, w) → (B, F, H, W, 3), float32, about [-1, 1]."""
        z = latents.permute(0, 2, 1, 3, 4) / self.vae.config.scaling_factor
        return self.vae.decode(z).permute(0, 2, 3, 4, 1)

    def sample(self, image: torch.Tensor, ids: torch.Tensor, negative_ids: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One request: conditioning, noise, the DDIM loop → final latents."""
        gen = generator or torch.Generator(device=self.device)
        cond = self.condition(image, ids, negative_ids, gen)
        latents = self.initial_latents(image.shape[0], gen)
        return self.denoise(latents, cond)
