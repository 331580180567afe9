"""DDIM schedule and FreeInit (port of animate3d_tpu/models/diffusion.py).

diffusers DDIMScheduler with the reference config (1000 train steps, linear
betas 0.00085 → 0.012, steps_offset 1, no clipping) as table lookups, and
the FreeInit butterworth low-pass frequency mix via ``torch.fft``.
CogVideoX's ``CogVideoXDDIMScheduler`` is the same scheduler with options
the MV-VDM's config leaves off: v-prediction, ``trailing`` spacing, the
SNR shift and the zero-terminal-SNR rescale of sqrt(ᾱ); its sampler steps
on host floats (:meth:`DDIMScheduler.step_coefficients`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"  # linear | scaled_linear
    steps_offset: int = 1
    clip_sample: bool = False
    set_alpha_to_one: bool = True
    prediction_type: str = "epsilon"  # epsilon | v_prediction
    timestep_spacing: str = "leading"  # leading | trailing
    snr_shift_scale: float = 1.0
    rescale_betas_zero_snr: bool = False


class DDIMScheduler:
    """Precomputed f32 tables on ``device`` + the static config."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig(), device=None):
        t = config.num_train_timesteps
        if config.beta_schedule == "linear":
            betas = np.linspace(config.beta_start, config.beta_end, t, dtype=np.float64)
        elif config.beta_schedule == "scaled_linear":
            betas = np.linspace(config.beta_start ** 0.5, config.beta_end ** 0.5, t,
                                dtype=np.float64) ** 2
        else:
            raise ValueError(config.beta_schedule)
        alphas_cumprod = np.cumprod(1.0 - betas)
        if config.snr_shift_scale != 1.0:
            k = config.snr_shift_scale
            alphas_cumprod = alphas_cumprod / (k + (1 - k) * alphas_cumprod)
        if config.rescale_betas_zero_snr:
            root = np.sqrt(alphas_cumprod)
            first, last = root[0], root[-1]
            alphas_cumprod = ((root - last) * first / (first - last)) ** 2
        final = 1.0 if config.set_alpha_to_one else alphas_cumprod[0]
        self.config = config
        self.alphas64, self.final64 = alphas_cumprod, float(final)  # the host-float step's
        self.alphas_cumprod = torch.as_tensor(alphas_cumprod, dtype=torch.float32,
                                              device=device)
        self.final_alpha_cumprod = torch.as_tensor(final, dtype=torch.float32,
                                                   device=device)

    def timesteps(self, num_inference_steps: int) -> torch.Tensor:
        """Descending int64 timesteps: 'leading' spacing + steps_offset, or
        'trailing' (T, T - T/n, ... rounded, minus one)."""
        if self.config.timestep_spacing == "trailing":
            t = self.config.num_train_timesteps
            ts = np.round(np.arange(t, 0, -t / num_inference_steps)).astype(np.int64) - 1
            return torch.as_tensor(ts, dtype=torch.int64, device=self.alphas_cumprod.device)
        step_ratio = self.config.num_train_timesteps // num_inference_steps
        ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1].copy()
        return torch.as_tensor(ts + self.config.steps_offset, dtype=torch.int64,
                               device=self.alphas_cumprod.device)

    def _alpha(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, device=self.alphas_cumprod.device)
        return self.alphas_cumprod[t.clamp(min=0)]

    def _epsilon_only(self) -> None:
        if self.config.prediction_type != "epsilon":
            raise ValueError("the tensor step reads epsilon; a v-prediction model steps "
                             "through step_coefficients")

    def pred_original(self, sample: torch.Tensor, eps: torch.Tensor, t) -> torch.Tensor:
        """x0 prediction from epsilon."""
        self._epsilon_only()
        a_t = self._alpha(t)
        if a_t.dim():
            a_t = a_t.reshape((-1,) + (1,) * (sample.dim() - 1))
        return (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)

    def step_coefficients(self, t: int, num_inference_steps: int) -> Tuple[float, float]:
        """(c_x, c_m) of the eta-0 step from host timestep ``t``: prev_sample
        = c_x · sample + c_m · model_output, from the float64 table (no
        device read)."""
        prev = t - self.config.num_train_timesteps // num_inference_steps
        a_t = float(self.alphas64[t])
        a_prev = float(self.alphas64[prev]) if prev >= 0 else self.final64
        if self.config.prediction_type == "v_prediction":
            # x0 = sqrt(a_t) x - sqrt(1 - a_t) v, then prev = c_a x + c_b x0
            c_a = ((1 - a_prev) / (1 - a_t)) ** 0.5
            c_b = a_prev ** 0.5 - a_t ** 0.5 * c_a
            return c_a + c_b * a_t ** 0.5, -c_b * (1 - a_t) ** 0.5
        # x0 = (x - sqrt(1 - a_t) eps) / sqrt(a_t), prev = sqrt(a_prev) x0 + sqrt(1 - a_prev) eps
        r = (a_prev / a_t) ** 0.5
        return r, (1 - a_prev) ** 0.5 - r * (1 - a_t) ** 0.5

    def step(self, eps: torch.Tensor, t, sample: torch.Tensor,
             num_inference_steps: int, eta: float = 0.0,
             noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One DDIM step. Returns (prev_sample, pred_x0)."""
        self._epsilon_only()
        cfg = self.config
        t = torch.as_tensor(t, device=self.alphas_cumprod.device)
        prev_t = t - cfg.num_train_timesteps // num_inference_steps
        a_t = self._alpha(t)
        a_prev = torch.where(prev_t >= 0, self._alpha(prev_t), self.final_alpha_cumprod)
        x0 = (sample - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        if cfg.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        if eta > 0.0:
            if noise is None:
                raise ValueError("eta > 0 needs noise")
            var = (1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)
            sigma = eta * torch.sqrt(var)
            dir_coeff = torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0))
            prev = torch.sqrt(a_prev) * x0 + dir_coeff * eps + sigma * noise
        else:
            prev = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
        return prev, x0

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """Forward diffusion q(x_t | x_0)."""
        a_t = self._alpha(t)
        while a_t.dim() < x0.dim():
            a_t = a_t[..., None]
        return torch.sqrt(a_t) * x0 + torch.sqrt(1.0 - a_t) * noise


def _butterworth_lowpass_3d(shape: Tuple[int, int, int], d_s: float = 0.25,
                            d_t: float = 0.25, order: int = 4) -> np.ndarray:
    """(F, H, W) low-pass mask over centred normalised frequencies."""
    f, h, w = shape
    if d_s == 0 or d_t == 0:
        return np.zeros(shape, np.float32)
    ts = ((np.arange(f) / f) * 2 - 1)[:, None, None] / d_t
    hs = ((np.arange(h) / h) * 2 - 1)[None, :, None] / d_s
    ws = ((np.arange(w) / w) * 2 - 1)[None, None, :] / d_s
    d2 = ts ** 2 + hs ** 2 + ws ** 2
    return (1.0 / (1.0 + d2 ** order)).astype(np.float32)


def freeinit_blend(diffused_latents: torch.Tensor, fresh_noise: torch.Tensor,
                   filter_order: int = 4, cutoff_spatial: float = 0.25,
                   cutoff_temporal: float = 0.25) -> torch.Tensor:
    """Low frequencies of the diffused latents + high frequencies of fresh
    noise, over the (F, h, w) axes of (B, F, h, w, C) latents."""
    b, f, h, w, c = diffused_latents.shape
    lpf = torch.as_tensor(_butterworth_lowpass_3d((f, h, w), cutoff_spatial,
                                                  cutoff_temporal, filter_order),
                          device=diffused_latents.device)
    lpf = torch.fft.ifftshift(lpf)[None, :, :, :, None]  # mask built centred
    dims = (1, 2, 3)
    x_freq = torch.fft.fftn(diffused_latents.to(torch.complex64), dim=dims)
    n_freq = torch.fft.fftn(fresh_noise.to(torch.complex64), dim=dims)
    mixed = x_freq * lpf + n_freq * (1.0 - lpf)
    return torch.fft.ifftn(mixed, dim=dims).real.to(diffused_latents.dtype)


@dataclass(frozen=True)
class EulerEDMConfig:
    """Stable Video Diffusion's ``scheduler/scheduler_config.json``:
    diffusers' ``EulerDiscreteScheduler`` with Karras sigmas (rho 7) between
    ``sigma_max`` and ``sigma_min``, continuous timesteps, v-prediction and
    ``leading`` spacing (the only prediction and spacing the release uses)."""

    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0


class EulerEDMScheduler:
    """Euler steps under EDM preconditioning, with every per-step number a
    host float (the sigmas are fixed by the step count), so a step needs no
    host sync. ``sigmas`` are the Karras sigmas rounded to float32, as
    diffusers keeps them, with 0 appended; the UNet's timestep input is
    ``0.25 ln sigma``; the preconditioning ``c_in = 1 / sqrt(sigma^2 + 1)``,
    ``c_skip = 1 / (sigma^2 + 1)``, ``c_out = -sigma / sqrt(sigma^2 + 1)``
    (v-prediction); the step ``x + (x - D) / sigma * (sigma_next - sigma)``."""

    def __init__(self, config: EulerEDMConfig = EulerEDMConfig(), num_inference_steps: int = 25):
        self.config = config
        ramp = np.linspace(0.0, 1.0, num_inference_steps)
        lo, hi = config.sigma_min ** (1.0 / config.rho), config.sigma_max ** (1.0 / config.rho)
        karras = (hi + ramp * (lo - hi)) ** config.rho
        self.sigmas = [float(s) for s in np.float32(karras)] + [0.0]
        self.timesteps = [(0.25 * torch.log(torch.tensor(s, dtype=torch.float32))).item()
                          for s in self.sigmas[:-1]]
        self.init_noise_sigma = (max(self.sigmas) ** 2 + 1.0) ** 0.5  # "leading" spacing

    @staticmethod
    def c_in(sigma: float) -> float:
        return 1.0 / (sigma ** 2 + 1.0) ** 0.5

    @staticmethod
    def denoised(model_output: torch.Tensor, sample: torch.Tensor, sigma: float) -> torch.Tensor:
        """D = c_skip x + c_out F (v-prediction)."""
        return sample / (sigma ** 2 + 1.0) + model_output * (-sigma / (sigma ** 2 + 1.0) ** 0.5)

    @staticmethod
    def step(denoised: torch.Tensor, sample: torch.Tensor, sigma: float,
             sigma_next: float) -> torch.Tensor:
        """One Euler step from ``sigma`` to ``sigma_next``."""
        return sample + (sample - denoised) / sigma * (sigma_next - sigma)
