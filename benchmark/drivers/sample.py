"""Driver of the ``sample`` traffic: MV-VDM sampling requests back to back,
one in flight, each what ``animate3d_tpu_torch/cli/inference.py`` does for
one asset (GIF writing left out): the prompt through the text tower, the
conditioning renders through the vision tower and the VAE encoder,
``MVSampler.sample`` (DDIM x FreeInit rounds, CFG), ``decode_video``.

The window's unit is one denoise step. The check follows the program step
by step from its own state (sampling amplifies rounding over its steps, so
a whole-run comparison would compare chaos): the reference recomputes the
conditioning, the step-0 latents, a few denoise steps drawn from the seed
from the program's latents before each, the FreeInit re-noise from the
program's first-round result, and the decode of the program's final
latents. Relative L2 gaps; a step's gap is taken over the step's update."""

from __future__ import annotations

import gc
import os
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional

import torch

from benchmark import harness
from benchmark.harness import span
from benchmark.reference import precision
from benchmark.reference.sd import pipeline as ref
from benchmark.weights import seeded_weights, shapes_of

def _dc(cls, d: dict):
    names = {f.name for f in fields(cls)}
    return cls(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()
                  if k in names})


def load_weights(mods: dict, config: dict, seed: int, device, upcast: bool = False,
                 vae_dtype: torch.dtype = torch.float32) -> None:
    """Load the seeded weights of every module, each made in the type it is
    served in (the UNet's ``unet_dtype``, the VAE's ``vae_dtype``, the
    towers float32; ``upcast``: then widened to float32 for the reference).
    Names and shapes come from the reference modules built on the meta
    device."""
    meta = ref.build(config, "meta")
    dtypes = {"unet": getattr(torch, config["unet_dtype"]), "vae": vae_dtype}
    for name, m in meta.items():
        sd = seeded_weights(shapes_of(m), harness.seed_for(seed, "weights", name), device,
                            dtypes.get(name, torch.float32))
        mods[name].load_state_dict({k: v.float() for k, v in sd.items()} if upcast else sd)
        del sd


def _program_modules(config: dict, device):
    """The port's UNet, VAE and towers from the configuration file's sizes
    (``models/factory.py::build_models``' classes and casts), with storage
    only: the benchmark's weights are loaded over it."""
    from animate3d_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel,
                                                 CLIPVisionConfig,
                                                 CLIPVisionModelWithProjection)
    from animate3d_tpu_torch.models.unet_blocks import MotionAttnConfig
    from animate3d_tpu_torch.models.unet_mv import MVMotionUNet, MVUNetConfig
    from animate3d_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    u = dict(config["unet"])
    ucfg = _dc(MVUNetConfig, dict(u, motion_attn=_dc(MotionAttnConfig, u.get("motion_attn", {}))))
    with torch.device("meta"):
        mods = {"unet": MVMotionUNet(ucfg), "vae": AutoencoderKL(_dc(VAEConfig, config["vae"])),
                "text": CLIPTextModel(_dc(CLIPTextConfig, config["text"])),
                "vision": CLIPVisionModelWithProjection(_dc(CLIPVisionConfig,
                                                            config["vision"]))}
    mods = {k: m.to_empty(device=device).eval().requires_grad_(False) for k, m in mods.items()}
    mods["unet"].to(getattr(torch, config["unet_dtype"]))
    return mods


def _images(traffic: dict, n: int, size: int, seed: int, device) -> torch.Tensor:
    """(n, size, size, 3) conditioning renders in [0, 1]: smooth seeded
    colour fields (coarse noise, bilinear up)."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = traffic["image_coarse"]
    low = torch.rand((n, 3, c, c), generator=g, device=device)
    up = torch.nn.functional.interpolate(low, size=(size, size), mode="bilinear",
                                         align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous()


@dataclass
class Request:
    index: int
    seed: int
    prompt: str
    taps: Dict[int, torch.Tensor] = field(default_factory=dict)
    eps: Dict[int, torch.Tensor] = field(default_factory=dict)
    renoise: List[tuple] = field(default_factory=list)
    outputs: Dict[str, torch.Tensor] = field(default_factory=dict)
    done: bool = False


class _Tap(torch.nn.Module):
    """The UNet inside a span; keeps the latents that enter the recorded
    steps of the current request (the first half of the CFG batch) and the
    UNet's output at the checked steps."""

    def __init__(self, unet, steps: set, outputs: set):
        super().__init__()
        self.unet, self.steps, self.outputs = unet, steps, outputs
        self.request: Optional[Request] = None
        self.step = 0

    def forward(self, x2, t, *args, **kw):
        step, req = self.step, self.request
        if step in self.steps:
            req.taps[step] = x2[:x2.shape[0] // 2].detach().float().clone()
        self.step += 1
        with span("sampler.unet"):
            out = self.unet(x2, t, *args, **kw)
        if step in self.outputs:
            req.eps[step] = out.detach().float().clone()
        return out


class _SchedulerSpans:
    """The sampler's scheduler with its calls inside a span."""

    def __init__(self, sched):
        self._s = sched

    def __getattr__(self, name):
        attr = getattr(self._s, name)
        if name in ("step", "add_noise") and callable(attr):
            def wrapped(*a, **k):
                with span("sampler.scheduler"):
                    return attr(*a, **k)
            return wrapped
        return attr


class _Ticks(list):
    """``MVSampler.step_seconds``: each append follows a step's device
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
    tok_dir: str
    requests: List[Request] = field(default_factory=list)
    checked: List[int] = field(default_factory=list)


def _steps_per_request(traffic: dict) -> int:
    return traffic["steps"] * traffic["freeinit_rounds"]


def checked_steps(traffic: dict, seed: int) -> List[int]:
    """``check_steps`` steps drawn from the seed, none the last of a round
    (the step after it starts from the re-noise)."""
    n, per = _steps_per_request(traffic), traffic["steps"]
    cand = [s for s in range(n) if s % per != per - 1]
    g = torch.Generator().manual_seed(harness.seed_for(seed, "check_steps"))
    return sorted(cand[int(i)] for i in torch.randperm(len(cand), generator=g)[:traffic["check_steps"]])


def _sampler(config, traffic, device, steps: int, rounds: int, unet):
    from animate3d_tpu_torch.models.diffusion import DDIMScheduler, SchedulerConfig
    from animate3d_tpu_torch.pipelines.mv_sampler import MVSampler, MVSamplerConfig

    s = config["sampling"]
    sched = DDIMScheduler(_dc(SchedulerConfig, config["scheduler"]), device=device)
    scfg = MVSamplerConfig(num_inference_steps=steps, guidance_scale=traffic["guidance_scale"],
                           num_views=s["num_views"], num_frames=s["num_frames"],
                           height=s["size"], width=s["size"],
                           vae_scale_factor=2 ** (len(config["vae"]["block_out_channels"]) - 1),
                           latent_scaling=config["vae"]["scaling_factor"],
                           freeinit_enabled=rounds > 1, freeinit_num_iters=rounds,
                           i2v_cond_time_zero=s["i2v_cond_time_zero"],
                           camera_elevation=s["camera_elevation"])
    sampler = MVSampler(unet, scfg, sched)
    sampler.scheduler = _SchedulerSpans(sched)
    return sampler


def setup(ctx: harness.Ctx) -> State:
    from animate3d_tpu_torch.core.device import resolve_device
    from animate3d_tpu_torch.utils.tokenizer import write_char_level_tokenizer

    config, traffic = ctx.spec.config, ctx.spec.traffic
    dev = resolve_device(ctx.device)
    mods = _program_modules(config, dev)
    load_weights(mods, config, ctx.seed, dev)
    tok_dir = os.path.join(ctx.tmp, "tokenizer")
    write_char_level_tokenizer(tok_dir)
    picks = checked_steps(traffic, ctx.seed)
    starts = {r * traffic["steps"] for r in range(traffic["freeinit_rounds"])}
    tap = _Tap(mods["unet"], starts | set(picks) | {p + 1 for p in picks}, set(picks))
    state = State(ctx=ctx, config=config, traffic=traffic, mods=mods, sampler=None, tap=tap,
                  tok_dir=tok_dir, checked=picks)
    # every shape of the window once: one step in each of two rounds (the
    # re-noise), the towers, the encode and the decode
    state.sampler = _sampler(config, traffic, dev, 1, 2, tap)
    run_request(state, Request(index=-1, seed=harness.seed_for(ctx.seed, "warm"),
                               prompt=traffic["prompts"][0]))
    state.sampler = _sampler(config, traffic, dev, traffic["steps"],
                             traffic["freeinit_rounds"], tap)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state


@torch.inference_mode()
def run_request(state: State, req: Request) -> Request:
    """One request through the port, as ``cli/inference.py`` runs it."""
    from animate3d_tpu_torch.models.clip import encode_ip_adapter_images
    from animate3d_tpu_torch.models.factory import encode_text
    from animate3d_tpu_torch.pipelines.mv_sampler import (decode_video,
                                                          encode_conditioning_images)

    m, s, dev = state.mods, state.config["sampling"], state.ctx.device
    images = _images(state.traffic, s["num_views"], s["size"],
                     harness.seed_for(req.seed, "images"), dev)
    state.tap.request, state.tap.step = req, 0
    sampler = state.sampler
    orig_renoise = sampler.freeinit_renoise

    def renoise(latents, *a, **k):  # the program's re-noise, its input and output kept
        out = orig_renoise(latents, *a, **k)
        req.renoise.append((latents.float().clone(), out.float().clone()))
        return out

    sampler.freeinit_renoise = renoise
    try:
        with span("request"):
            with span("clip.encode"):
                cond, uncond = encode_text(req.prompt, "", s["num_views"], m["text"],
                                           state.tok_dir)
                embeds = encode_ip_adapter_images(m["vision"], images).float()
            with span("vae.encode"):
                ffl = encode_conditioning_images(m["vae"], images * 2.0 - 1.0,
                                                 state.config["vae"]["scaling_factor"])
            req.outputs.update(text=torch.cat([cond, uncond]).float().clone(),
                               image=embeds.clone())
            gen = torch.Generator(device=dev).manual_seed(req.seed)
            latents = sampler.sample(ffl, cond, uncond, embeds, generator=gen)
            with span("vae.decode"):
                video = decode_video(m["vae"], latents, state.config["vae"]["scaling_factor"])
    finally:
        sampler.freeinit_renoise = orig_renoise
    req.outputs.update(final=latents.float().clone(), video=video.float().clone())
    req.done = True
    return req


def window(state: State, win) -> None:
    state.sampler.step_seconds = _Ticks(win)
    prompts = state.traffic["prompts"]
    i = 0
    while True:
        g = torch.Generator().manual_seed(harness.seed_for(state.ctx.seed, "prompt", i))
        req = Request(index=i, seed=harness.seed_for(state.ctx.seed, "request", i),
                      prompt=prompts[int(torch.randint(len(prompts), (1,), generator=g))])
        state.requests.append(req)
        run_request(state, req)
        i += 1


# -- counted operations of the traced window ------------------------------------

def request_flops(config: dict, traffic: dict) -> Dict[str, float]:
    """Operations of the products and convolutions of one request's parts,
    counted on the reference modules over meta tensors: the CFG UNet
    forward of one step, the two prompts through the text tower, the
    renders through the vision tower and the VAE encoder, the decode."""
    from torch.utils.flop_counter import FlopCounterMode

    s = config["sampling"]
    n, f, size = s["num_views"], s["num_frames"], s["size"]
    lat = size // 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    mods = ref.build(config, "meta")
    meta = dict(device="meta")
    u, t = config["unet"], config["text"]

    def count(fn) -> float:
        with FlopCounterMode(display=False) as fc:
            fn()
        return float(fc.get_total_flops())

    img = torch.zeros((n, size, size, 3), **meta)
    return {
        "unet_step": count(lambda: mods["unet"](
            torch.zeros((2 * n, f, lat, lat, u.get("in_channels", 4)), **meta),
            torch.tensor(500, **meta), torch.zeros((2 * n, 77, u["cross_attention_dim"]), **meta),
            torch.zeros((2 * n, 16), **meta), torch.zeros((2 * n, u["image_embed_dim"]), **meta))),
        "text": count(lambda: mods["text"](torch.zeros((2, t["max_position_embeddings"]),
                                                       dtype=torch.long, **meta))),
        "vision": count(lambda: ref.image_conditioning(mods["vision"], img)),
        "vae_encode": count(lambda: mods["vae"].encode_mode(img)),
        "vae_decode": count(lambda: mods["vae"].decode(
            torch.zeros((n * f, lat, lat, 4), **meta))),
    }


def trace_counts(state: State, win) -> Dict[str, float]:
    fl = request_flops(state.config, state.traffic)
    per_request = fl["text"] + fl["vision"] + fl["vae_encode"] + fl["vae_decode"]
    started = sum(1 for r in state.requests)
    finished = sum(1 for r in state.requests if r.done)
    # a request's conditioning runs at its start, its decode at its end
    flops = (fl["unet_step"] * win.units
             + (fl["text"] + fl["vision"] + fl["vae_encode"]) * started
             + fl["vae_decode"] * finished)
    return {"flops": flops, "unet_step_flops": fl["unet_step"],
            "request_flops": per_request, "heads": float(state.config["unet"]["num_heads"])}


# -- the check ----------------------------------------------------------------------

def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _reference_models(config: dict, seed: int, device):
    mods = ref.build(config, device)
    load_weights(mods, config, seed, device, upcast=True)
    return mods


@torch.inference_mode()
def follow(config: dict, traffic: dict, mods: dict, req: Request, checked: List[int], device,
           mode: str = "f32") -> Dict[str, object]:
    """The reference's outputs for the parts of ``req`` the check compares,
    the steps taken from the program's own latents; in ``precision.mode(mode)``
    ("fp8": the control, one step below the configuration's precisions)."""
    with precision.mode(mode):
        return _follow(config, traffic, mods, req, checked, device)


def _follow(config, traffic, mods, req, checked, device):
    s = config["sampling"]
    n, scaling = s["num_views"], config["vae"]["scaling_factor"]
    images = _images(traffic, n, s["size"], harness.seed_for(req.seed, "images"), device)
    cond, uncond = ref.text_conditioning(mods["text"], req.prompt, n)
    embeds = ref.image_conditioning(mods["vision"], images)
    ffl = ref.first_frame_latents(mods["vae"], images, scaling)
    gen = torch.Generator(device=device).manual_seed(req.seed)
    lat = s["size"] // 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    shape = (n, s["num_frames"] - 1, lat, lat, config["unet"].get("in_channels", 4))
    noise = [torch.randn(shape, generator=gen, device=device)
             for _ in range(traffic["freeinit_rounds"])]
    sched = ref.scheduler(config, device)
    ts = sched.timesteps(traffic["steps"])
    cam = ref.cameras(n, s["camera_elevation"], device)
    ctx = torch.cat([uncond, cond])
    img2 = torch.cat([torch.zeros_like(embeds), embeds])
    starts = [torch.cat([ffl, noise[0]], dim=1)]
    for r, (end, _) in enumerate(req.renoise):
        starts.append(ref.renoise(sched, torch.cat([ffl, end[:, 1:]], dim=1), noise[0],
                                  noise[r + 1]))
    out = {"text": torch.cat([cond, uncond]), "image": embeds, "starts": starts,
           "eps": {}, "cond": {}}
    for step in checked:
        x = req.taps[step]
        t = ts[step % traffic["steps"]]
        eps = mods["unet"](torch.cat([x, x]), t, ctx, torch.cat([cam, cam]), img2).float()
        eps_c = eps.chunk(2)[1]
        out["eps"][step] = eps
        out["cond"][step] = eps_c[:, 1:]
    if "final" in req.outputs:
        out["video"] = ref.decode(mods["vae"], req.outputs["final"], scaling)
    return out


def gaps(got: Dict[str, object], want: Dict[str, object]) -> Dict[str, float]:
    """The numbers compared, relative L2 gaps of ``got`` (the program's or
    the control's outputs) against the reference's ``want``: the text and
    image conditioning; the latents that start each round (the encoded
    first frame with the initial noise, then each FreeInit re-noise); the
    UNet's output at the checked steps (both halves of the CFG batch, worst
    step); the text-conditioned noise prediction as each checked step
    carried it out (worst step); the decode."""
    worst = lambda key: max((rel(got[key][k], w) for k, w in want[key].items()), default=0.0)
    out = {"text_rel": rel(got["text"], want["text"]),
           "image_rel": rel(got["image"], want["image"]),
           "starts_rel": rel(torch.cat([x.flatten() for x in got["starts"]]),
                             torch.cat([x.flatten() for x in want["starts"]])),
           "eps_rel": worst("eps"), "step_rel": worst("cond")}
    if "video" in want:
        out["decode_rel"] = rel(got["video"], want["video"])
    return out


def program_outputs(req: Request, checked: List[int], config: dict, traffic: dict,
                    device) -> Dict[str, object]:
    """What the program produced, in :func:`follow`'s layout. The
    text-conditioned noise prediction behind a checked step is read back
    from the step itself: the DDIM update inverted with the reference's
    coefficients gives the guided prediction,
    g_eps = (x_next - sqrt(a_prev / a) x) / (sqrt(1 - a_prev) - sqrt(a_prev (1 - a) / a)),
    and the CFG rule inverted with the program's own unconditioned output
    u gives c = u + (g_eps - u) / scale. A correct step reproduces the
    UNet's conditioned output; a step that does not move its latents, or
    moves them wrongly, does not (frames 1..; frame 0 is re-injected)."""
    sched = ref.scheduler(config, device)
    ts = sched.timesteps(traffic["steps"])
    per, scale = traffic["steps"], traffic["guidance_scale"]
    cond = {}
    for step in checked:
        t = ts[step % per]
        a = sched._alpha(t).double()
        prev_t = t - sched.config.num_train_timesteps // per
        a_prev = (sched._alpha(prev_t) if int(prev_t) >= 0 else sched.final_alpha_cumprod).double()
        x, nxt = req.taps[step][:, 1:].double(), req.taps[step + 1][:, 1:].double()
        coef = torch.sqrt(1 - a_prev) - torch.sqrt(a_prev * (1 - a) / a)
        guided = (nxt - torch.sqrt(a_prev / a) * x) / coef
        u = req.eps[step].double().chunk(2)[0][:, 1:]
        cond[step] = (u + (guided - u) / scale).float()
    got = {"text": req.outputs["text"], "image": req.outputs["image"],
           "starts": [req.taps[r * per] for r in range(traffic["freeinit_rounds"])],
           "eps": {s: req.eps[s] for s in checked}, "cond": cond}
    if "final" in req.outputs:
        got["video"] = req.outputs["video"]
    return got


def pick_request(state: State) -> Request:
    """A finished request drawn from the seed; where the window finished
    none, the next request is run to its end after the window (untimed)."""
    done = [r for r in state.requests if r.done]
    if not done:
        state.sampler.step_seconds = []
        req = Request(index=len(state.requests),
                      seed=harness.seed_for(state.ctx.seed, "request", len(state.requests)),
                      prompt=state.traffic["prompts"][0])
        done = [run_request(state, req)]
    g = torch.Generator().manual_seed(harness.seed_for(state.ctx.seed, "pick"))
    return done[int(torch.randint(len(done), (1,), generator=g))]


def free_program(state: State) -> None:
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


def calibrate(ctx: harness.Ctx, control: bool) -> Dict[str, Dict[str, float]]:
    """The numbers of one request of the window's (its first), for the
    program and, with ``control``, for the control put in its place:
    the readings the limits are set from."""
    state = setup(ctx)
    req = Request(index=0, seed=harness.seed_for(ctx.seed, "request", 0),
                  prompt=state.traffic["prompts"][0])
    run_request(state, req)
    config, traffic, dev = state.config, state.traffic, ctx.device
    got = program_outputs(req, state.checked, config, traffic, dev)
    free_program(state)
    mods = _reference_models(config, ctx.seed, dev)
    want = follow(config, traffic, mods, req, state.checked, dev)
    out = {"program": gaps(got, want)}
    if control:
        out["control"] = gaps(follow(config, traffic, mods, req, state.checked, dev,
                                     mode="fp8"), want)
    return out
