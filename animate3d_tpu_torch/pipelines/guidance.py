"""4D-SDS guidance: the x0-reconstruction loss from the frozen MV-VDM, the
port of ``animate3d_tpu/pipelines/guidance.py``.

  * renders → the guidance size (``resize_bilinear``, JAX's antialiased
    resample) → VAE posterior *sample* x 0.18215, encoded in chunks of
    ``vae_encode_chunk`` images. A memory plan (:func:`encode_plan`) keeps
    the first chunks' encoder activations for the backward while the card
    has room for them, :data:`ENCODE_HEADROOM_BYTES` and, where not all
    are kept, the one chunk a recompute rebuilds, and recomputes the rest
    in the backward (``torch.utils.checkpoint``, non-reentrant), as the JAX
    package recomputes every chunk to fit a 16 GB chip. A chunk's bytes are
    the allocator's growth across a kept chunk's forward or a recomputed
    chunk's recompute. Where the device has no allocator to read (the CPU),
    or before a chunk's bytes have been measured (the first call at a
    shape), every chunk is recomputed;
  * IP-Adapter image embeds from each view's first frame, recomputed every
    step without gradients when a vision tower is loaded;
  * one random t per video in [min_step, max_step], annealed by ``C()``;
  * frames 1..F-1 noised, frame 0 kept clean, one CFG UNet call on
    [cond, uncond] with ``eps_text + s·(eps_text − eps_uncond)``, under
    ``torch.no_grad`` (the JAX branch is stop-gradient);
  * x0 reconstruction, MVDream's ``recon_std_rescale`` over frames 1..F-1,
    frame 0 replaced by the clean latents;
  * loss = ½‖latents − recon‖²_sum / (B·N·F) · F/(F−1).

The random draws (t, the posterior ε, the noise of frames 1..F-1) come
from a ``torch.Generator`` or are given (:class:`GuidanceDraws`), so a test
can feed the JAX function's own. The render, the VAE encode and the loss
are one autograd graph; :meth:`AnimateMVGuidance.pixel_grad` also returns
∂loss/∂rgb on its own.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from animate3d_tpu_torch.core.registry import register
from animate3d_tpu_torch.core.schedule import C
from animate3d_tpu_torch.models.clip import resize_bilinear
from animate3d_tpu_torch.models.diffusion import DDIMScheduler, SchedulerConfig
from animate3d_tpu_torch.utils import trace


# Room the refine step needs beside the encoder activations the plan keeps
# (and the one chunk a recompute rebuilds): the CFG UNet call that runs
# while they are held, the backward's buffers, the allocator's cached but
# unallocated blocks and the CUDA context, none of which the allocated count
# holds. On an H100 80GB at refine_frame_16.yaml's shapes (64 SDS renders at
# 256², chunks of 8 holding 6.40e9 bytes each, all 8 kept) the step peaked
# at 62.21e9 bytes allocated: 1.76e9 above the lower of the two decision
# readings (9.25e9 and 9.83e9 allocated, one each refine bucket) plus the
# kept chunks; the allocator reserved 1.82e9 more (64.04e9), and the CUDA
# context and libraries held 0.80e9 outside it (read by
# tests/test_torch_guidance_memory.py on the card). 6 GiB covers those
# 4.38e9 with 2.06e9 to spare.
ENCODE_HEADROOM_BYTES = 6 * 2 ** 30


@functools.lru_cache(maxsize=None)
def _capacity(index: int) -> int:
    return torch.cuda.get_device_properties(index).total_memory


def device_memory(device) -> Optional[Tuple[int, int]]:
    """(bytes allocated, capacity) of a CUDA device, from the caching
    allocator's host-side counter (no sync); None on a device without one."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    return torch.cuda.memory_allocated(index), _capacity(index)


def encode_plan(n_chunks: int, chunk_bytes: Optional[int],
                memory: Optional[Tuple[int, int]]) -> Tuple[bool, ...]:
    """Which chunks of an encode keep their activations (True) rather
    than recompute them: all of them where the bytes allocated, theirs and
    :data:`ENCODE_HEADROOM_BYTES` fit the capacity; else the first ones,
    leaving room for the one chunk a recompute rebuilds in the backward
    while the kept chunks are still held; none where the device memory
    (:func:`device_memory`) or a chunk's bytes are unknown."""
    if memory is None or chunk_bytes is None:
        return (False,) * n_chunks
    allocated, capacity = memory
    fits = (capacity - allocated - ENCODE_HEADROOM_BYTES) // max(chunk_bytes, 1)
    kept = n_chunks if fits >= n_chunks else max(0, fits - 1)
    return (True,) * kept + (False,) * (n_chunks - kept)


@dataclass(frozen=True)
class GuidanceConfig:
    """The guidance's settings. ``vae_encode_chunk`` is the unit of the SDS
    encode and of its memory plan: each chunk of that many images keeps its
    encoder activations for the backward or recomputes them there."""

    guidance_scale: float = 5.0
    n_view: int = 4
    n_frame: int = 16
    recon_std_rescale: float = 0.25
    i2v_cond_time_zero: bool = False
    latent_scaling: float = 0.18215
    num_train_timesteps: int = 1000
    image_size: int = 256  # the SDS encode resolution
    vae_encode_chunk: int = 8
    min_step_percent: object = 0.02  # schedulable (C() lists allowed)
    max_step_percent: object = 0.2


class GuidanceDraws(NamedTuple):
    """A step's draws, each optional: ``t_video`` (B,) int, ``posterior``
    (B·N·F, h, w, C) ε of the posterior sample, ``noise`` (B·N, F-1, h, w, C)
    of frames 1..F-1."""

    t_video: Optional[torch.Tensor] = None
    posterior: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None


@register("animatemv-diffusion-guidance")
class AnimateMVGuidance:
    """Guidance around a frozen ``unet_apply(latents (B, F, h, w, C), t (B,),
    ctx, camera, image_embeds, i2v_cond_time_zero)`` → eps and ``vae_encode(
    images (B, H, W, 3) in [-1, 1])`` → (mean, logvar);
    ``image_encode(images in [0, 1])`` → (B, D) when a vision tower is
    loaded. Built from a config by :func:`build_guidance_from_config`."""

    def __init__(self, unet_apply: Callable, vae_encode: Callable,
                 cfg: GuidanceConfig = GuidanceConfig(),
                 scheduler: Optional[DDIMScheduler] = None,
                 image_encode: Optional[Callable] = None, device="cpu"):
        self.unet_apply = unet_apply
        self.vae_encode = vae_encode
        self.cfg = cfg
        self.scheduler = scheduler or DDIMScheduler(SchedulerConfig(), device=device)
        self.image_encode = image_encode
        # bytes a chunk's encode holds for its backward, by chunk shape
        self._chunk_bytes: Dict[tuple, int] = {}

    @contextlib.contextmanager
    def _holding(self, key: tuple, device):
        """Record under ``key`` the most the allocator's count grew across
        the block: a kept chunk's forward, or a recomputed chunk's second
        forward in the backward (its first holds only its output)."""
        before = device_memory(device)[0]
        try:
            yield
        finally:  # also where checkpoint stops a recompute after its last saved tensor
            held = device_memory(device)[0] - before
            self._chunk_bytes[key] = max(held, self._chunk_bytes.get(key, 0))

    @trace.spanned("guidance.encode")
    def _chunked_vae_encode(self, x: torch.Tensor):
        chunk = self.cfg.vae_encode_chunk
        n = x.shape[0]
        if chunk <= 0 or n <= chunk or n % chunk != 0 or not torch.is_grad_enabled():
            return self.vae_encode(x)
        memory = device_memory(x.device)
        key = (chunk, *x.shape[1:], x.dtype)
        plan = encode_plan(n // chunk, self._chunk_bytes.get(key), memory)
        holding = contextlib.nullcontext if memory is None else functools.partial(
            self._holding, key, x.device)
        parts = []
        for i, keep in zip(range(0, n, chunk), plan):
            if keep:
                with holding():
                    parts.append(self.vae_encode(x[i:i + chunk]))
            else:
                parts.append(checkpoint(self.vae_encode, x[i:i + chunk], use_reentrant=False,
                                        context_fn=lambda: (contextlib.nullcontext(), holding())))
        kept = sum(plan)
        trace.count(("vae_encode_chunk", "kept"), kept)
        trace.count(("vae_encode_chunk", "recomputed"), len(plan) - kept)
        return tuple(torch.cat([p[j] for p in parts]) for j in range(2))

    def min_max_step(self, global_step: int) -> Tuple[int, int]:
        """The annealed timestep bounds."""
        cfg = self.cfg
        return (int(cfg.num_train_timesteps * C(cfg.min_step_percent, 0, global_step)),
                int(cfg.num_train_timesteps * C(cfg.max_step_percent, 0, global_step)))

    def _sample_t(self, bn: int, t_range: Tuple[int, int],
                  generator: Optional[torch.Generator], device) -> torch.Tensor:
        mn, mx = t_range
        u = torch.rand((bn // self.cfg.n_view,), generator=generator,
                       device=generator.device if generator is not None else device)
        return torch.clamp((mn + u.to(device) * (mx + 1 - mn)).to(torch.int32), mn, mx)

    @staticmethod
    def camera16(c2w, bn: int, n_frame: int) -> torch.Tensor:
        """(B·N·F, 4, 4) → (B·N, 16): each view's frame-0 c2w with its
        translation on the unit sphere, flattened."""
        c2w_v = torch.as_tensor(c2w).reshape(bn, n_frame, 4, 4)[:, 0].float().clone()
        t = c2w_v[:, :3, 3]
        c2w_v[:, :3, 3] = t / (torch.linalg.norm(t, dim=1, keepdim=True) + 1e-8)
        return c2w_v.reshape(bn, 16)

    @trace.spanned("guidance.unet_cfg")
    def _cfg_eps(self, x, t, ctx, cam2, img2):
        eps = self.unet_apply(x, t, ctx, cam2, img2,
                              i2v_cond_time_zero=self.cfg.i2v_cond_time_zero)
        e_t, e_u = eps.chunk(2, dim=0)
        return e_t, e_t + self.cfg.guidance_scale * (e_t - e_u)

    def loss(self, rgb: torch.Tensor, text_cond: torch.Tensor, text_uncond: torch.Tensor,
             camera_16d: torch.Tensor, image_embeds: torch.Tensor, t_video: torch.Tensor,
             draws: Optional[GuidanceDraws] = None,
             generator: Optional[torch.Generator] = None,
             shard: Optional[Tuple[slice, Callable]] = None) -> torch.Tensor:
        """The SDS loss of renders ``rgb`` (B·N·F, H, W, 3) in [0, 1];
        gradients flow to ``rgb`` through the VAE encode only.

        ``shard = (rows, gather)`` (data parallel): ``rgb`` holds only the
        rows ``rows`` of the batch, which are encoded here; ``gather``
        concatenates every rank's rows (its backward keeping this rank's)
        for the UNet, which couples a video's views and frames."""
        cfg = self.cfg
        draws = draws or GuidanceDraws()
        rows, gather = shard or (slice(None), lambda x: x)
        n, f = cfg.n_view, cfg.n_frame
        b = t_video.shape[0]
        bn = b * n
        if self.image_encode is not None:
            with torch.no_grad():
                firsts = gather(rgb.detach()).reshape(bn, f, *rgb.shape[1:])[:, 0]
                image_embeds = self.image_encode(firsts).float()
        s = cfg.image_size
        if rgb.shape[1] != s or rgb.shape[2] != s:
            rgb = resize_bilinear(rgb, s, s)
        mean, logvar = self._chunked_vae_encode(rgb * 2.0 - 1.0)
        # drawn for the whole batch, so that every rank's generator stays in step
        eps_post = draws.posterior if draws.posterior is not None else torch.randn(
            (bn * f, *mean.shape[1:]), generator=generator, device=mean.device)
        latents = (mean + torch.exp(0.5 * logvar) * eps_post[rows]) * cfg.latent_scaling
        lh, lw, lc = latents.shape[1:]
        latents = gather(latents).reshape(bn, f, lh, lw, lc)
        t = t_video.to(latents.device).long().repeat_interleave(n)
        with torch.no_grad():
            rest = latents[:, 1:].detach()
            noise = draws.noise if draws.noise is not None else torch.randn(
                rest.shape, generator=generator, device=rest.device)
            noisy = torch.cat([latents[:, :1].detach(),
                               self.scheduler.add_noise(rest, noise, t)], dim=1)
            eps_text, eps_cfg = self._cfg_eps(
                torch.cat([noisy, noisy]), torch.cat([t, t]),
                torch.cat([text_cond, text_uncond]), torch.cat([camera_16d, camera_16d]),
                torch.cat([image_embeds, torch.zeros_like(image_embeds)]))
            flat = lambda x: x.reshape(bn * f, lh, lw, lc)
            tf = t.repeat_interleave(f)
            recon = self.scheduler.pred_original(flat(noisy), flat(eps_cfg.float()), tf)
            recon = recon.reshape(bn, f, lh, lw, lc)
            if cfg.recon_std_rescale > 0:
                recon_nocfg = self.scheduler.pred_original(
                    flat(noisy), flat(eps_text.float()), tf).reshape(b, n, f, lh, lw, lc)
                dims = (1, 2, 3, 4, 5)
                r = recon.reshape(b, n, f, lh, lw, lc)
                factor = ((torch.std(recon_nocfg[:, :, 1:], dim=dims, correction=0) + 1e-8)
                          / (torch.std(r[:, :, 1:], dim=dims, correction=0) + 1e-8))
                adjust = (r * factor.reshape(b, 1, 1, 1, 1, 1)).reshape(bn, f, lh, lw, lc)
                recon = cfg.recon_std_rescale * adjust + (1 - cfg.recon_std_rescale) * recon
            recon = torch.cat([latents[:, :1].detach(), recon[:, 1:]], dim=1)
        return 0.5 * torch.sum((latents - recon) ** 2) / (bn * f) * f / (f - 1)

    def pixel_grad(self, rgb: torch.Tensor, text_cond, text_uncond, c2w, image_embeds,
                   t_range: Tuple[int, int], draws: Optional[GuidanceDraws] = None,
                   generator: Optional[torch.Generator] = None):
        """(loss, ∂loss/∂rgb) of detached renders."""
        bn = rgb.shape[0] // self.cfg.n_frame
        draws = draws or GuidanceDraws()
        t_video = draws.t_video if draws.t_video is not None else self._sample_t(
            bn, t_range, generator, rgb.device)
        x = rgb.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self.loss(x, text_cond, text_uncond,
                             self.camera16(c2w, bn, self.cfg.n_frame).to(rgb.device),
                             image_embeds, t_video, draws, generator)
            (grad,) = torch.autograd.grad(loss, x)
        return loss.detach(), grad

    @torch.no_grad()
    def preview(self, vae_decode: Callable, latents: torch.Tensor, text_cond, text_uncond,
                camera_16d, image_embeds, t_start: int, num_steps: int = 25,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The guidance-eval preview: noise the clean latents (B·N, F, h, w, C)
        to ``t_start`` and DDIM-sample back with CFG, frame 0 kept; returns
        the decoded frames (B·N, F, H, W, 3) in [0, 1]."""
        cfg = self.cfg
        bn, f = latents.shape[:2]
        ts_all = self.scheduler.timesteps(num_steps)
        active = ts_all[ts_all <= t_start]
        first = latents[:, :1]
        if noise is None:
            noise = torch.randn(latents[:, 1:].shape, generator=generator,
                                device=latents.device)
        t0 = torch.full((bn,), int(t_start), device=latents.device)
        x = torch.cat([first, self.scheduler.add_noise(latents[:, 1:], noise, t0)], dim=1)
        ctx = torch.cat([text_cond, text_uncond])
        cam2 = torch.cat([camera_16d, camera_16d])
        img2 = torch.cat([image_embeds, torch.zeros_like(image_embeds)])
        for t in active:
            _, e = self._cfg_eps(torch.cat([x, x]), t.expand(2 * bn), ctx, cam2, img2)
            prev, _ = self.scheduler.step(e.float(), t, x, num_steps)
            x = torch.cat([first, prev[:, 1:]], dim=1)
        lh, lw, lc = x.shape[2:]
        imgs = vae_decode((x / cfg.latent_scaling).reshape(bn * f, lh, lw, lc))
        return (imgs / 2 + 0.5).clamp(0, 1).reshape(bn, f, *imgs.shape[1:])

    @torch.no_grad()
    def preview_from_rgb(self, vae_decode: Callable, rgb: torch.Tensor, text_cond,
                         text_uncond, c2w, image_embeds, t_start: int, num_steps: int = 25,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Guidance-eval from renders (B·N·F, H, W, 3): encode them (the
        posterior mean), then :meth:`preview`."""
        cfg = self.cfg
        f = cfg.n_frame
        bn = rgb.shape[0] // f
        if self.image_encode is not None:
            image_embeds = self.image_encode(rgb.reshape(bn, f, *rgb.shape[1:])[:, 0]).float()
        s = cfg.image_size
        if rgb.shape[1] != s or rgb.shape[2] != s:
            rgb = resize_bilinear(rgb, s, s)
        mean, _ = self.vae_encode(rgb * 2.0 - 1.0)
        latents = (mean * cfg.latent_scaling).reshape(bn, f, *mean.shape[1:])
        return self.preview(vae_decode, latents, text_cond, text_uncond,
                            self.camera16(c2w, bn, f).to(rgb.device), image_embeds, t_start,
                            num_steps, noise, generator)


def build_guidance_from_config(sys_cfg, acfg, device=None):
    """The frozen MV-VDM, VAE and CLIP towers for 4D-SDS from the experiment
    config: weights from ``guidance.flax_params_dir`` (the artifact root of
    ``convert/weights.py``) and ``guidance.pretrained_unet_path``, seeded
    where a file is missing (smoke mode). The UNet's weights are bf16 and the
    VAE's are rounded to bf16 (the JAX package casts both; its f32 VAE then
    computes in f32, as this one does); the UNet runs under
    ``attention_backend("flash")`` without gradients. Returns (guidance,
    inputs: text_cond / text_uncond (N, 77, D), the fallback image_embeds,
    vae_decode)."""
    import os

    import numpy as np

    from animate3d_tpu_torch.core.device import resolve_device
    from animate3d_tpu_torch.models.clip import encode_ip_adapter_images
    from animate3d_tpu_torch.models.factory import build_models, has_tokenizer, init_and_load
    from animate3d_tpu_torch.ops.attention import attention_backend

    dev = resolve_device(device)
    g = dict(sys_cfg.get("guidance", {}) or {})
    model_size = g.get("model_size", sys_cfg.get("model_size", "full"))
    root = g.get("flax_params_dir")
    unet, vae, text_model, vision_model = build_models(
        model_size, acfg.n_view, dev, dtype=torch.bfloat16,
        clip=bool(root) and os.path.isdir(root))
    unet, vae, text_model, vision_model, loaded = init_and_load(
        unet, vae, text_model, vision_model, root, g.get("pretrained_unet_path"))
    if "unet" not in loaded and "motion_ckpt" not in loaded:
        print("[guidance] WARNING: randomly initialized guidance (smoke mode)")
    with torch.no_grad():
        for p in vae.parameters():
            p.copy_(p.to(torch.bfloat16).float())

    def unet_apply(lat, t, ctx, cam, ie, i2v_cond_time_zero=False):
        with torch.no_grad(), attention_backend("flash"):
            return unet(lat, t, ctx, cam, ie, i2v_cond_time_zero=i2v_cond_time_zero)

    image_encode = None
    if vision_model is not None:
        def image_encode(imgs):
            return encode_ip_adapter_images(vision_model, imgs)

    gcfg = GuidanceConfig(
        guidance_scale=g.get("guidance_scale", 5.0), n_view=g.get("n_view", acfg.n_view),
        n_frame=g.get("n_frame", acfg.n_frame), image_size=g.get("image_size", 256),
        recon_std_rescale=g.get("recon_std_rescale", 0.25),
        min_step_percent=g.get("min_step_percent", 0.02),
        max_step_percent=g.get("max_step_percent", 0.2),
        i2v_cond_time_zero=(g.get("model_config", {}) or {}).get("i2v_cond_time_zero", False))
    guidance = AnimateMVGuidance(unet_apply, vae.encode, gcfg, image_encode=image_encode,
                                 device=dev)
    guidance.modules = (unet, vae, text_model, vision_model)

    bn = acfg.n_view
    pp = dict(sys_cfg.get("prompt_processor", {}) or {})
    prompt = pp.get("prompt", "") or ""
    negative = pp.get("negative_prompt", "") or ""
    ucfg = unet.config
    if text_model is not None and has_tokenizer(root):
        from animate3d_tpu_torch.convert.weights import tokenizer_root
        from animate3d_tpu_torch.models.prompt_processor import PromptProcessor
        from animate3d_tpu_torch.utils.tokenizer import ClipTokenizer, find_tokenizer_files

        tok = ClipTokenizer(*find_tokenizer_files(tokenizer_root(root)), max_length=77)

        def encode_fn(prompts):
            ids = torch.as_tensor(tok(prompts), dtype=torch.long, device=dev)
            with torch.no_grad():
                return text_model(ids).float().cpu().numpy()

        proc = PromptProcessor(encode_fn, cache_dir=pp.get("cache_dir", ".cache/text_embeddings"))
        embs = proc(prompt, negative)
        on_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        text_cond = on_dev(embs["cond"])[None].repeat(bn, 1, 1)
        text_uncond = on_dev(embs["uncond"])[None].repeat(bn, 1, 1)
    else:
        from animate3d_tpu_torch.models.prompt_processor import encode_prompt_or_zeros

        text_cond, text_uncond = encode_prompt_or_zeros(
            prompt, negative, bn, hidden_size=ucfg.cross_attention_dim, device=dev)
    inputs = {"text_cond": text_cond, "text_uncond": text_uncond,
              "image_embeds": torch.zeros((bn, ucfg.image_embed_dim), device=dev),
              "vae_decode": vae.decode}
    return guidance, inputs
