"""Driver of the ``svd_i2v`` traffic: Stable Video Diffusion XT
image-to-video requests back to back, one in flight, each what
``animate3d_tpu_torch/cli/inference.py`` does under ``model_type: svd_xt``
(GIF writing left out): the conditioning image through the vision tower
and, noise-augmented, the VAE encoder; the starting noise; the Euler-EDM
loop with batched CFG (``pipelines/svd_sampler.py``); the temporal decode.

The window's unit is one Euler step. The check follows the program step by
step from its own state, as the sampling cell's does: for a finished
request drawn from the seed, the reference (``reference/svd/``) recomputes
the conditioning, the starting noise, the UNet's output for both CFG halves
at a few steps drawn from the seed from the program's latents before each,
and the decode of the program's final latents. The step itself is read
back: the Euler update inverted with the reference's sigmas gives the
guided model output, and the CFG rule inverted with the program's own
unconditioned output and the reference's per-frame ramp gives the
conditioned one, which a correct step reproduces. Relative L2 gaps."""

from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark import harness
from benchmark.harness import span
from benchmark.reference import precision
from benchmark.reference.svd import svd_xt as ref
from benchmark.weights import seeded_weights, shapes_of


def _pick(cls, d: dict):
    names = {f.name for f in fields(cls)}
    return cls(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()
                  if k in names})


def ref_configs(config: dict):
    return (_pick(ref.UNetConfig, config["unet"]), _pick(ref.VAEConfig, config["vae"]),
            _pick(ref.VisionConfig, config["vision"]))


def load_weights(mods: dict, config: dict, seed: int, device, upcast: bool = False) -> None:
    """The seeded weights of each model, made in the type it is served in
    (the UNet's ``unet_dtype``, the rest float32; ``upcast``: then widened
    to float32 for the reference); names and shapes from the reference
    built on the meta device."""
    meta = ref.build(*ref_configs(config), "meta")
    dtypes = {"unet": getattr(torch, config["unet_dtype"])}
    for name, m in meta.items():
        sd = seeded_weights(shapes_of(m), harness.seed_for(seed, "weights", name), device,
                            dtypes.get(name, torch.float32))
        mods[name].load_state_dict({k: v.float() for k, v in sd.items()} if upcast else sd)
        del sd


def _program_modules(config: dict, device) -> dict:
    """The port's UNet, temporal VAE and vision tower at the configuration's
    sizes (``models/factory.py::build_svd_models``' classes and casts),
    storage only: the benchmark's weights are loaded over them."""
    from animate3d_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionModelWithProjection
    from animate3d_tpu_torch.models.unet_svd import SVDUNet, SVDUNetConfig
    from animate3d_tpu_torch.models.vae import VAEConfig
    from animate3d_tpu_torch.models.vae_temporal import AutoencoderKLTemporalDecoder

    with torch.device("meta"):
        mods = {"unet": SVDUNet(_pick(SVDUNetConfig, config["unet"])),
                "vae": AutoencoderKLTemporalDecoder(_pick(VAEConfig, config["vae"])),
                "vision": CLIPVisionModelWithProjection(_pick(CLIPVisionConfig,
                                                              config["vision"]))}
    mods = {k: m.to_empty(device=device).eval().requires_grad_(False) for k, m in mods.items()}
    mods["unet"].to(getattr(torch, config["unet_dtype"]))
    return mods


def _image(traffic: dict, height: int, width: int, seed: int, device) -> torch.Tensor:
    """(1, H, W, 3) in [0, 1]: a smooth seeded colour field."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = traffic["image_coarse"]
    low = torch.rand((1, 3, c, 2 * c), generator=g, device=device)
    up = F.interpolate(low, size=(height, width), mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous()


@dataclass
class Request:
    index: int
    seed: int
    taps: Dict[int, tuple] = field(default_factory=dict)  # step: (x, x_next)
    out: Dict[int, torch.Tensor] = field(default_factory=dict)  # step: UNet output, both halves
    outputs: Dict[str, torch.Tensor] = field(default_factory=dict)
    done: bool = False


class _Tap(torch.nn.Module):
    """The UNet inside a span; keeps its output at the checked steps."""

    def __init__(self, unet, steps: set):
        super().__init__()
        self.unet, self.steps = unet, steps
        self.request: Optional[Request] = None
        self.step = 0

    def forward(self, *args):
        with span("sampler.unet"):
            out = self.unet(*args)
        if self.step in self.steps:
            self.request.out[self.step] = out.detach().float().clone()
        self.step += 1
        return out


class _StepTap:
    """The sampler's scheduler, keeping the latents before and after each
    checked step."""

    def __init__(self, sched, tap: _Tap):
        self._s, self._tap = sched, tap

    def __getattr__(self, name):
        return getattr(self._s, name)

    def step(self, denoised, sample, sigma, sigma_next):
        out = self._s.step(denoised, sample, sigma, sigma_next)
        i = self._tap.step - 1
        if i in self._tap.steps:
            self._tap.request.taps[i] = (sample.detach().clone(), out.detach().clone())
        return out


class _Ticks(list):
    """``SVDSampler.step_seconds``: each append follows a step's device
    synchronise; it ticks the window."""

    def __init__(self, win):
        super().__init__()
        self.win = win

    def append(self, x):
        super().append(x)
        self.win.tick()


@dataclass
class State:
    ctx: harness.Ctx
    config: dict
    traffic: dict
    mods: dict
    sampler: object
    tap: _Tap
    checked: List[int]
    requests: List[Request] = field(default_factory=list)
    events: List[tuple] = field(default_factory=list)
    unpatch: object = None


def checked_steps(traffic: dict, seed: int) -> List[int]:
    g = torch.Generator().manual_seed(harness.seed_for(seed, "check_steps"))
    n = traffic["steps"]
    return sorted(int(i) for i in torch.randperm(n, generator=g)[:traffic["check_steps"]])


def _sampler(config: dict, traffic: dict, mods: dict, tap: _Tap, steps: int):
    from animate3d_tpu_torch.models.diffusion import EulerEDMConfig
    from animate3d_tpu_torch.pipelines.svd_sampler import SVDSampler, SVDSamplerConfig

    scfg = _pick(SVDSamplerConfig, dict(config["sampling"], num_inference_steps=steps))
    sampler = SVDSampler(tap, mods["vae"], mods["vision"], scfg,
                         _pick(EulerEDMConfig, config["scheduler"]))
    sampler.scheduler = _StepTap(sampler.scheduler, tap)
    return sampler


def _temporal_events(state: State):
    """While a profiler records, the card's time between the start and the
    end of each of the program's ``unet.temporal_*`` spans, by CUDA events
    (``trace.span`` wrapped; the spans as the program opens them). Returns
    the undo."""
    from animate3d_tpu_torch.utils import trace

    orig = trace.span

    @contextlib.contextmanager
    def timed(ctx):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with ctx:
            a.record()
            try:
                yield
            finally:
                b.record()
                state.events.append((a, b))

    def span_with_events(name):
        ctx = orig(name)
        if (name.startswith("unet.temporal_") and torch.cuda.is_available()
                and torch.autograd.profiler._is_profiler_enabled):
            return timed(ctx)
        return ctx

    trace.span = span_with_events
    return lambda: setattr(trace, "span", orig)


def setup(ctx: harness.Ctx) -> State:
    from animate3d_tpu_torch.core.device import resolve_device

    config, traffic = ctx.spec.config, ctx.spec.traffic
    dev = resolve_device(ctx.device)
    mods = _program_modules(config, dev)
    load_weights(mods, config, ctx.seed, dev)
    picks = checked_steps(traffic, ctx.seed)
    tap = _Tap(mods["unet"], set(picks))
    state = State(ctx=ctx, config=config, traffic=traffic, mods=mods, sampler=None, tap=tap,
                  checked=picks)
    # every shape of the window once: the towers, one CFG step, the decode
    state.sampler = _sampler(config, traffic, mods, tap, 1)
    run_request(state, Request(index=-1, seed=harness.seed_for(ctx.seed, "warm")))
    state.sampler = _sampler(config, traffic, mods, tap, traffic["steps"])
    if dev.type == "cuda":
        state.unpatch = _temporal_events(state)
        torch.cuda.synchronize(dev)
    return state


@torch.inference_mode()
def run_request(state: State, req: Request) -> Request:
    """One request through the port, as ``cli/inference.py`` runs it."""
    s, dev, sampler = state.config["sampling"], state.ctx.device, state.sampler
    image = _image(state.traffic, s["height"], s["width"], harness.seed_for(req.seed, "image"),
                   dev)
    state.tap.request, state.tap.step = req, 0
    gen = torch.Generator(device=dev).manual_seed(req.seed)
    with span("request"):
        with span("svd.condition"):
            cond = sampler.condition(image, gen)
        starts = sampler.initial_latents(1, gen)
        req.outputs.update(image=cond.embeds.clone(), latent=cond.image_latents.clone(),
                           starts=starts.clone())
        latents = sampler.denoise(starts, cond)
        with span("vae.decode"):
            video = sampler.decode(latents)
    req.outputs.update(final=latents.clone(), video=video)
    req.done = True
    return req


def window(state: State, win) -> None:
    state.sampler.step_seconds = _Ticks(win)
    i = 0
    while True:
        req = Request(index=i, seed=harness.seed_for(state.ctx.seed, "request", i))
        state.requests.append(req)
        run_request(state, req)
        i += 1


# -- counted operations of the traced window ------------------------------------

def request_flops(config: dict) -> Dict[str, float]:
    """Operations of the products and convolutions of one request's parts,
    counted on the reference over meta tensors: the CFG UNet call of one
    step, the image through the vision tower and the VAE encoder, the
    decode of the clip."""
    from torch.utils.flop_counter import FlopCounterMode

    s, u = config["sampling"], config["unet"]
    f, hh, ww = s["num_frames"], s["height"], s["width"]
    down = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    mods = ref.build(*ref_configs(config), "meta")
    meta = dict(device="meta")

    def count(fn) -> float:
        with FlopCounterMode(display=False) as fc:
            fn()
        return float(fc.get_total_flops())

    img = torch.zeros((1, hh, ww, 3), **meta)
    return {
        "unet_step": count(lambda: mods["unet"](
            torch.zeros((2, f, u["in_channels"], hh // down, ww // down), **meta), 0.5,
            torch.zeros((2, 1, u["cross_attention_dim"]), **meta), torch.zeros((2, 3), **meta))),
        "condition": count(lambda: ref.condition(mods["vision"], mods["vae"], img, img, 0.02)),
        "decode": count(lambda: mods["vae"].decode(
            torch.zeros((f, 4, hh // down, ww // down), **meta), f)),
    }


def trace_counts(state: State, win) -> Dict[str, float]:
    fl = request_flops(state.config)
    started = len(state.requests)
    finished = sum(1 for r in state.requests if r.done)
    flops = fl["unet_step"] * win.units + fl["condition"] * started + fl["decode"] * finished
    out = {"flops": flops, "unet_step_flops": fl["unet_step"],
           "request_flops": fl["condition"] + fl["decode"]}
    if state.events:
        torch.cuda.synchronize()
        out["temporal_device_s"] = sum(a.elapsed_time(b) for a, b in state.events) * 1e-3
    return out


# -- the check ----------------------------------------------------------------------

def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def ramp(sampling: dict, device) -> torch.Tensor:
    """(1, F, 1, 1, 1): the published per-frame guidance scale, linear from
    ``min_guidance_scale`` to ``max_guidance_scale`` (the read-back's)."""
    g = torch.linspace(sampling["min_guidance_scale"], sampling["max_guidance_scale"],
                       sampling["num_frames"], device=device)
    return g.reshape(1, -1, 1, 1, 1)


def read_back(x: torch.Tensor, x_next: torch.Tensor, uncond: torch.Tensor, sigma: float,
              sigma_next: float, scale: torch.Tensor) -> torch.Tensor:
    """The conditioned model output that a step from ``x`` to ``x_next``
    carried out: the Euler update inverted (D = x - (x_next - x) sigma /
    (sigma_next - sigma)), the preconditioning inverted (F = (D - c_skip x)
    / c_out), then the CFG rule with the unconditioned output ``uncond`` and
    the per-frame ``scale``: c = u + (F - u) / g."""
    x, x_next, u = x.double(), x_next.double(), uncond.double()
    d = x - (x_next - x) * sigma / (sigma_next - sigma)
    guided = (d - x / (sigma ** 2 + 1.0)) / (-sigma / (sigma ** 2 + 1.0) ** 0.5)
    return (u + (guided - u) / scale.double()).float()


def _reference_models(config: dict, seed: int, device) -> dict:
    mods = ref.build(*ref_configs(config), device)
    load_weights(mods, config, seed, device, upcast=True)
    return mods


def program_outputs(req: Request, checked: List[int], config: dict, traffic: dict,
                    device) -> Dict[str, object]:
    """What the program produced, in :func:`follow`'s layout; the step's
    conditioned output read back (:func:`read_back`)."""
    sigmas = ref.karras_sigmas(traffic["steps"])
    scale = ramp(config["sampling"], device)
    cond = {s: read_back(*req.taps[s], req.out[s].chunk(2)[0], sigmas[s], sigmas[s + 1], scale)
            for s in checked}
    return {"image": req.outputs["image"], "latent": req.outputs["latent"],
            "starts": req.outputs["starts"], "out": {s: req.out[s] for s in checked},
            "cond": cond, "video": req.outputs["video"]}


@torch.inference_mode()
def follow(config: dict, traffic: dict, mods: dict, req: Request, checked: List[int], device,
           mode: str = "f32", stand_in: bool = False) -> Dict[str, object]:
    """The reference's outputs for the parts of ``req`` the check compares,
    each step from the program's own latents, in ``precision.mode(mode)``.
    ``stand_in``: the reference in the program's place (the control, a
    fault), its steps carried out with its own guided output and read back
    as the program's are."""
    s = config["sampling"]
    with precision.mode(mode):
        image = _image(traffic, s["height"], s["width"], harness.seed_for(req.seed, "image"),
                       device)
        gen = torch.Generator(device=device).manual_seed(req.seed)
        aug = torch.randn(image.shape, generator=gen, device=device)
        latents_down = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
        noise = torch.randn((1, s["num_frames"], 4, s["height"] // latents_down,
                             s["width"] // latents_down), generator=gen, device=device)
        embeds, lat = ref.condition(mods["vision"], mods["vae"], image, aug,
                                    s["noise_aug_strength"])
        sigmas = ref.karras_sigmas(traffic["steps"])
        ids = ref.added_time_ids(s["fps"], s["motion_bucket_id"], s["noise_aug_strength"], 2,
                                 device)
        scale = ref.guidance_scale(s["num_frames"], s["min_guidance_scale"],
                                   s["max_guidance_scale"], device)
        out = {"image": embeds, "latent": lat, "starts": noise * ref.init_noise_sigma(sigmas),
               "out": {}, "cond": {}}
        for step in checked:
            x = req.taps[step][0]
            both, guided = ref.cfg_model_output(mods["unet"], x, sigmas[step], embeds, lat, ids,
                                                scale)
            out["out"][step] = both
            if stand_in:
                x_next = ref.euler_step(ref.denoised(guided, x, sigmas[step]), x, sigmas[step],
                                        sigmas[step + 1])
                out["cond"][step] = read_back(x, x_next, both.chunk(2)[0], sigmas[step],
                                              sigmas[step + 1], ramp(s, device))
            else:
                out["cond"][step] = both.chunk(2)[1]
        out["video"] = ref.decode(mods["vae"], req.outputs["final"], s["decode_chunk_size"])
    return out


def gaps(got: Dict[str, object], want: Dict[str, object]) -> Dict[str, float]:
    """Relative L2 gaps of ``got`` (the program's, or a stand-in's) against
    the reference's ``want``: the image embedding, the noise-augmented image
    latent, the starting noise, the UNet's output at the checked steps (both
    CFG halves, worst step), the conditioned output each checked step
    carried out (worst step), the decode."""
    worst = lambda key: max(rel(got[key][k], w) for k, w in want[key].items())
    return {"image_rel": rel(got["image"], want["image"]),
            "latent_rel": rel(got["latent"], want["latent"]),
            "starts_rel": rel(got["starts"], want["starts"]),
            "denoised_rel": worst("out"), "step_rel": worst("cond"),
            "decode_rel": rel(got["video"], want["video"])}


def pick_request(state: State) -> Request:
    """A finished request drawn from the seed; where the window finished
    none, the next request is run to its end after the window (untimed)."""
    done = [r for r in state.requests if r.done]
    if not done:
        state.sampler.step_seconds = []
        req = Request(index=len(state.requests),
                      seed=harness.seed_for(state.ctx.seed, "request", len(state.requests)))
        done = [run_request(state, req)]
    g = torch.Generator().manual_seed(harness.seed_for(state.ctx.seed, "pick"))
    return done[int(torch.randint(len(done), (1,), generator=g))]


def free_program(state: State) -> None:
    if state.unpatch is not None:
        state.unpatch()
        state.unpatch = None
    state.mods.clear()
    state.sampler = state.tap = None
    gc.collect()
    if state.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def check(state: State) -> Dict[str, dict]:
    req = pick_request(state)
    config, traffic, dev = state.config, state.traffic, state.ctx.device
    got = program_outputs(req, state.checked, config, traffic, dev)
    free_program(state)
    mods = _reference_models(config, state.ctx.seed, dev)
    numbers = gaps(got, follow(config, traffic, mods, req, state.checked, dev))
    limits = traffic["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


# -- faults planted in the reference, put in the program's place ---------------------

def _padded_unmasked(orig):
    """Attention over 25-token sequences as kernel B pads them, with the
    seven padded keys (zero k, zero v) left in the softmax."""
    def attention(qx, kx, vx, heads, quantise=True, score_bytes=1 << 30):
        if qx.shape[1] == kx.shape[1] == 25:
            pad = lambda t: F.pad(t, (0, 0, 0, 7))
            return orig(qx, pad(kx), pad(vx), heads, quantise, score_bytes)
        return orig(qx, kx, vx, heads, quantise, score_bytes)
    return attention


def _no_conv3d(self, x, temb):
    h = F.silu(self.norm1(x))
    if temb is not None:
        h = h + self.time_emb_proj(F.silu(temb)).permute(0, 2, 1)[:, :, :, None, None]
    return F.silu(self.norm2(h)) + x


def _mix_one(self, x_spatial, x_temporal, image_only):
    """The blender with its mix fixed at 1 (alpha sigmoid(1))."""
    alpha = torch.sigmoid(torch.ones(1, device=x_spatial.device))
    if self.with_images:
        alpha = torch.where(image_only.bool(), torch.ones_like(image_only), alpha)
    if self.switch:
        alpha = 1.0 - alpha
    return alpha * x_spatial + (1.0 - alpha) * x_temporal


def _cfg_mean(orig):
    def guidance_scale(num_frames, lo=1.0, hi=3.0, device=None):
        g = orig(num_frames, lo, hi, device)
        return torch.full_like(g, float(g.mean()))
    return guidance_scale


FAULTS = {
    "unmasked": ("attention", _padded_unmasked),
    "no_conv3d": ("TemporalResnetBlock.forward", lambda orig: _no_conv3d),
    "cfg_mean": ("guidance_scale", _cfg_mean),
    "mix_one": ("AlphaBlender.forward", lambda orig: _mix_one),
}


@contextlib.contextmanager
def planted(fault: str):
    """The reference with ``fault`` planted (see :data:`FAULTS`)."""
    where, make = FAULTS[fault]
    owner = ref
    parts = where.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    orig = getattr(owner, parts[-1])
    setattr(owner, parts[-1], make(orig))
    try:
        yield
    finally:
        setattr(owner, parts[-1], orig)


def calibrate(ctx: harness.Ctx, control: bool) -> Dict[str, Dict[str, float]]:
    """The numbers of the window's first request, for the program and, with
    ``control``, for the control (the reference one precision step down)
    and each planted fault put in its place."""
    state = setup(ctx)
    req = Request(index=0, seed=harness.seed_for(ctx.seed, "request", 0))
    run_request(state, req)
    config, traffic, dev = state.config, state.traffic, ctx.device
    got = program_outputs(req, state.checked, config, traffic, dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    free_program(state)
    mods = _reference_models(config, ctx.seed, dev)
    want = follow(config, traffic, mods, req, state.checked, dev)
    out = {"program": gaps(got, want), "peak": {"bytes": peak}}
    if control:
        out["control"] = gaps(follow(config, traffic, mods, req, state.checked, dev, "fp8",
                                     stand_in=True), want)
        for fault in FAULTS:
            with planted(fault):
                out[fault] = gaps(follow(config, traffic, mods, req, state.checked, dev,
                                         stand_in=True), want)
    return out
