"""Driver of the ``cogvideox_i2v`` traffic: CogVideoX-5B image-to-video
requests back to back, one in flight, each what
``animate3d_tpu_torch/cli/inference.py`` does under ``model_type:
cogvideox_i2v`` up to the final latents: a seeded prompt's ids and the
empty negative through the T5 encoder, the seeded image through the 3D
VAE's encoder (one latent frame, padded to 13), the starting noise, 50 DDIM
steps with batched CFG (``pipelines/cogvideox_sampler.py``). The decode of
the 13 latent frames to 49 is not timed: it runs for the check, after the
window.

The window's unit is one DDIM step. The check follows the program from its
own state, as the image-to-video cell's does: for the request the steps
were checked in (three steps drawn from the seed below ``check_below``, so
that the window reaches them; else that request is run again after the
window, untimed), the reference (``reference/cogvideox/``, float32) recomputes
the T5 states, the image latent and the starting noise; the transformer's
output for both CFG halves at the checked steps from the program's latents
before each; block 0's joint attention from the program's own input to it;
and the decode of the latents the program held when the window closed. The
step is read back: the DDIM update inverted with the reference's
coefficients gives the guided output, and the CFG rule inverted with the
program's own unconditioned output gives the conditioned one. Relative L2
gaps. The reference transformer runs a block at a time, each block's
weights made from the seed as it is needed, so its 22 GB of float32 weights
are never held whole."""

from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmark import harness
from benchmark.counts.cogvideox import ref_configs
from benchmark.harness import span
from benchmark.reference import precision
from benchmark.reference.cogvideox import cogvideox as ref
from benchmark.weights import seeded_weights, shapes_of


def _pick(cls, d: dict):
    names = {f.name for f in fields(cls)}
    return cls(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items()
                  if k in names})


# -- seeded weights, a part at a time ----------------------------------------------------

def _part(shapes: Dict[str, torch.Size], seed: int, tag, device, dtype) -> Dict[str, torch.Tensor]:
    """The seeded weights of one part in ``dtype``; the learned positional
    embedding drawn N(0, 1) (the configuration's ``assumed``)."""
    sd = seeded_weights(shapes, harness.seed_for(seed, "weights", *tag), device)
    for k, v in sd.items():
        if k.endswith("pos_embedding"):
            v.mul_((v.numel() // v.shape[0]) ** 0.5)
    return {k: v.to(dtype) for k, v in sd.items()}


def transformer_head(config: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        meta = ref.Transformer(ref_configs(config)[0], blocks=False)
    return _part(shapes_of(meta), seed, ("transformer", "head"), device, dtype)


def transformer_block(config: dict, seed: int, i: int, device, dtype) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        meta = ref.Block(ref_configs(config)[0])
    return _part(shapes_of(meta), seed, ("transformer", "block", i), device, dtype)


def t5_parts(config: dict, seed: int, device):
    """(prefix, state dict) of the T5 encoder a part at a time: the
    embedding and final norm, then each block. T5 scales no attention
    logit: its initialisation folds d_kv^-0.5 into q (std (d_model
    d_kv)^-0.5), and so does this seeding; q at N(0, 1/d_model) alone
    gives logits of std 8: near-argmax attention, so chaotic through 24
    layers that TF32 rounding moves the output by half."""
    c = ref_configs(config)[1]
    with torch.device("meta"):
        meta = ref.T5Encoder(c)
    shapes = shapes_of(meta)
    head = {k: v for k, v in shapes.items() if not k.startswith("encoder.block.")}
    yield "", _part(head, seed, ("t5", "head"), device, torch.float32)
    for i in range(c.num_layers):
        pre = f"encoder.block.{i}."
        part = {k[len(pre):]: v for k, v in shapes.items() if k.startswith(pre)}
        sd = _part(part, seed, ("t5", "block", i), device, torch.float32)
        sd["layer.0.SelfAttention.q.weight"].mul_(c.d_kv ** -0.5)
        yield pre, sd


def vae_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        meta = ref.VAE(ref_configs(config)[2])
    return _part(shapes_of(meta), seed, ("vae",), device, torch.float32)


def _load(module: torch.nn.Module, prefix: str, sd: Dict[str, torch.Tensor]) -> None:
    own = module.state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            own[prefix + k].copy_(v)


def load_program_weights(mods: dict, config: dict, seed: int, device) -> None:
    """The seeded weights, a part at a time, in the dtype each model is
    served in."""
    dtype = getattr(torch, config["transformer_dtype"])
    tr = mods["transformer"]
    _load(tr, "", transformer_head(config, seed, device, dtype))
    for i in range(len(tr.transformer_blocks)):
        _load(tr, f"transformer_blocks.{i}.", transformer_block(config, seed, i, device, dtype))
    for pre, sd in t5_parts(config, seed, device):
        _load(mods["t5"], pre, sd)
    _load(mods["vae"], "", vae_weights(config, seed, device))


def _program_modules(config: dict, device) -> dict:
    """The port's transformer, 3D VAE and T5 encoder at the configuration's
    sizes (``models/factory.py::build_cogvideox_models``' classes and
    casts), storage only: the benchmark's weights are loaded over them."""
    from animate3d_tpu_torch.models.t5 import T5Config, T5EncoderModel
    from animate3d_tpu_torch.models.transformer_cogvideox import (CogVideoXConfig,
                                                                  CogVideoXTransformer3DModel)
    from animate3d_tpu_torch.models.vae_cogvideox import AutoencoderKLCogVideoX, VAE3DConfig

    with torch.device("meta"):
        mods = {"transformer": CogVideoXTransformer3DModel(_pick(CogVideoXConfig,
                                                                 config["transformer"])),
                "vae": AutoencoderKLCogVideoX(_pick(VAE3DConfig, config["vae"])),
                "t5": T5EncoderModel(_pick(T5Config, config["t5"]))}
        mods["transformer"].to(getattr(torch, config["transformer_dtype"]))
    return {k: m.to_empty(device=device).eval().requires_grad_(False) for k, m in mods.items()}


# -- the request --------------------------------------------------------------------------

def _image(traffic: dict, height: int, width: int, seed: int, device) -> torch.Tensor:
    """(1, H, W, 3) in [0, 1]: a smooth seeded colour field."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = traffic["image_coarse"]
    low = torch.rand((1, 3, c, 2 * c), generator=g, device=device)
    up = F.interpolate(low, size=(height, width), mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous()


def prompt_ids(traffic: dict, length: int, vocab: int, seed: int, device) -> torch.Tensor:
    """(1, length): a seeded prompt (``prompt_len`` ids in [3, vocab), its
    length drawn), EOS (1), padding (0)."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = traffic["prompt_len"]
    n = int(torch.randint(lo, min(hi, length - 1) + 1, (1,), generator=g))
    ids = torch.zeros((1, length), dtype=torch.long)
    ids[0, :n] = torch.randint(3, vocab, (n,), generator=g)
    ids[0, n] = 1
    return ids.to(device)


def negative_ids(length: int, device) -> torch.Tensor:
    """The empty prompt: EOS, then padding."""
    ids = torch.zeros((1, length), dtype=torch.long)
    ids[0, 0] = 1
    return ids.to(device)


@dataclass
class Request:
    index: int
    seed: int
    x: Dict[int, torch.Tensor] = field(default_factory=dict)  # step: latents before it
    out: Dict[int, torch.Tensor] = field(default_factory=dict)  # step: output, both halves
    attn: Dict[int, tuple] = field(default_factory=dict)  # step: block 0's (input, output)
    outputs: Dict[str, torch.Tensor] = field(default_factory=dict)
    steps: int = 0
    done: bool = False


class _Stop(Exception):
    """Ends a request after the steps the check needs (untimed runs)."""


class _Tap(torch.nn.Module):
    """The transformer: keeps its input latents, its output and block 0's
    attention at the steps the check reads, and the latest latents; may
    stop the request after ``stop_after`` calls."""

    def __init__(self, transformer, steps: set, latent_channels: int):
        super().__init__()
        self.transformer, self.steps, self.c = transformer, steps, latent_channels
        self.config = transformer.config
        self.request: Optional[Request] = None
        self.stop_after: Optional[int] = None
        self.last: Optional[torch.Tensor] = None
        self._hook_step = None
        transformer.transformer_blocks[0].attn1.register_forward_hook(self._attn_hook)

    def _attn_hook(self, module, args, output):
        if self._hook_step is not None:
            self.request.attn[self._hook_step] = (args[0].detach().clone(), output.detach().clone())

    def forward(self, x, t, text, rope):
        req = self.request
        i = req.steps
        if self.stop_after is not None and i >= self.stop_after:
            raise _Stop
        lat = x[: x.shape[0] // 2, :, : self.c].detach().float().clone()
        self.last = lat
        if i in self.steps or i - 1 in self.steps:
            req.x[i] = lat
        self._hook_step = i if i in self.steps else None
        try:
            with span("sampler.transformer"):
                out = self.transformer(x, t, text, rope)
        finally:
            self._hook_step = None
        if i in self.steps:
            req.out[i] = out.detach().float().clone()
        req.steps += 1
        return out


class _Ticks(list):
    """``CogVideoXSampler.step_seconds``: each append follows a step's device
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
    window_latents: Optional[torch.Tensor] = None
    unpatch: object = None


def checked_steps(traffic: dict, seed: int) -> List[int]:
    """Three steps below ``check_below`` (the window reaches them)."""
    g = torch.Generator().manual_seed(harness.seed_for(seed, "check_steps"))
    n = min(traffic["check_below"], traffic["steps"] - 1)
    return sorted(int(i) for i in torch.randperm(n, generator=g)[:traffic["check_steps"]])


def _sampler(config: dict, mods: dict, tap: _Tap, steps: int):
    from animate3d_tpu_torch.pipelines.cogvideox_sampler import (CogVideoXSampler,
                                                                 CogVideoXSamplerConfig)

    scfg = _pick(CogVideoXSamplerConfig, dict(config["sampling"], num_inference_steps=steps))
    return CogVideoXSampler(tap, mods["vae"], mods["t5"], scfg)


def _attn_events(state: State):
    """While a profiler records, the card's time between the start and the
    end of each of the program's ``cogvideox.attn`` spans, by CUDA events
    (``trace.span`` wrapped). Returns the undo."""
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
        if (name == "cogvideox.attn" and torch.cuda.is_available()
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
    load_program_weights(mods, config, ctx.seed, dev)
    picks = checked_steps(traffic, ctx.seed)
    tap = _Tap(mods["transformer"], set(picks), config["vae"]["latent_channels"])
    state = State(ctx=ctx, config=config, traffic=traffic, mods=mods, sampler=None, tap=tap,
                  checked=picks)
    # every shape of the window once: T5, the image encode, one CFG step
    state.sampler = _sampler(config, mods, tap, 1)
    run_request(state, Request(index=-1, seed=harness.seed_for(ctx.seed, "warm")))
    state.sampler = _sampler(config, mods, tap, traffic["steps"])
    if dev.type == "cuda":
        state.unpatch = _attn_events(state)
        torch.cuda.synchronize(dev)
    return state


@torch.inference_mode()
def run_request(state: State, req: Request, stop_after: Optional[int] = None) -> Request:
    """One request through the port up to its final latents, as
    ``cli/inference.py`` runs it (``stop_after``: only its first steps)."""
    s, dev, sampler = state.config["sampling"], state.ctx.device, state.sampler
    tc = state.config["transformer"]
    image = _image(state.traffic, s["height"], s["width"], harness.seed_for(req.seed, "image"),
                   dev)
    ids = prompt_ids(state.traffic, tc["max_text_seq_length"], state.config["t5"]["vocab_size"],
                     harness.seed_for(req.seed, "prompt"), dev)
    neg = negative_ids(tc["max_text_seq_length"], dev)
    state.tap.request, state.tap.stop_after = req, stop_after
    gen = torch.Generator(device=dev).manual_seed(req.seed)
    try:
        with span("request"):
            cond = sampler.condition(image, ids, neg, gen)
            starts = sampler.initial_latents(1, gen)
            req.outputs.update(ids=ids, text=cond.text.clone(), latent=cond.image_latents.clone(),
                               starts=starts.clone())
            req.outputs["final"] = sampler.denoise(starts, cond)
        req.done = True
    except _Stop:
        pass
    finally:
        state.tap.stop_after = None
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

def trace_counts(state: State, win) -> Dict[str, float]:
    """The counted operations of the window's steps and of each started
    request's conditioning (``counts/cogvideox.py``), and the card's time
    inside the ``cogvideox.attn`` spans."""
    from benchmark.counts.cogvideox import request_flops

    fl = request_flops(state.config)
    started = len(state.requests)
    flops = fl["step"] * win.units + fl["condition"] * started
    out = {"flops": flops, "step_flops": fl["step"], "condition_flops": fl["condition"]}
    if state.events:
        torch.cuda.synchronize()
        out["attn_device_s"] = sum(a.elapsed_time(b) for a, b in state.events) * 1e-3
    return out


# -- the check ----------------------------------------------------------------------

def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def schedule(config: dict, traffic: dict, spacing: Optional[str] = None):
    """(ᾱ float64, timesteps) of the configuration's scheduler."""
    sc = config["scheduler"]
    a = ref.alphas_cumprod(sc["num_train_timesteps"], sc["beta_start"], sc["beta_end"],
                           sc["snr_shift_scale"], sc["rescale_betas_zero_snr"])
    return a, ref.timesteps(traffic["steps"], sc["num_train_timesteps"],
                            spacing or sc["timestep_spacing"])


def read_back(x: torch.Tensor, x_next: torch.Tensor, uncond: torch.Tensor, c_x: float,
              c_v: float, scale: float) -> torch.Tensor:
    """The conditioned output a step from ``x`` to ``x_next`` carried out:
    the guided v = (x_next − c_x x) / c_v, then the CFG rule with the
    unconditioned output: c = u + (v − u) / g."""
    v = (x_next.double() - c_x * x.double()) / c_v
    u = uncond.double()
    return (u + (v - u) / scale).float()


def pick_request(state: State) -> Request:
    """The first request of the window that reached every checked step and
    the one after it; else a request run after the window (untimed) up to
    those steps."""
    need = max(state.checked) + 2
    for r in state.requests:
        if r.steps >= need:
            return r
    state.sampler.step_seconds = []
    req = Request(index=len(state.requests),
                  seed=harness.seed_for(state.ctx.seed, "request", len(state.requests)))
    return run_request(state, req, stop_after=need)


def program_outputs(state: State, req: Request) -> Dict[str, object]:
    """What the program produced, in :func:`follow`'s layout."""
    a, ts = schedule(state.config, state.traffic)
    g = state.config["sampling"]["guidance_scale"]
    cond = {}
    for s in state.checked:
        c_x, c_v = ref.ddim_coefficients(a, ts[s], state.traffic["steps"])
        cond[s] = read_back(req.x[s], req.x[s + 1], req.out[s].chunk(2)[0], c_x, c_v, g)
    return {"text": req.outputs["text"], "latent": req.outputs["latent"],
            "starts": req.outputs["starts"], "out": {s: req.out[s] for s in state.checked},
            "attn": {s: req.attn[s][1] for s in state.checked}, "cond": cond}


def _free_cuda(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def free_program(state: State) -> None:
    if state.unpatch is not None:
        state.unpatch()
        state.unpatch = None
    state.mods.clear()
    state.sampler = state.tap = None
    _free_cuda(state.ctx.device)


@torch.inference_mode()
def follow(config: dict, traffic: dict, req: Request, checked: List[int], window_latents,
           device, seed: int, mode: str = "f32", stand_in: bool = False,
           fault: Optional[str] = None) -> Dict[str, object]:
    """The reference's outputs for the parts of ``req`` the check compares,
    each step from the program's own latents, in ``precision.mode(mode)``.
    ``stand_in``: the reference in the program's place (the control, a
    fault), its steps carried out with its own guided output and read back
    as the program's are."""
    tc, t5c, vc = ref_configs(config)
    s = config["sampling"]
    n = traffic["steps"]
    g = s["guidance_scale"]
    out: Dict[str, object] = {"out": {}, "attn": {}, "cond": {}}
    with precision.mode(mode):
        # T5 on [negative, prompt]
        with torch.device("meta"):
            t5 = ref.T5Encoder(t5c)
        t5 = t5.to_empty(device=device).eval()
        for pre, sd in t5_parts(config, seed, device):
            _load(t5, pre, sd)
            del sd
        ids = req.outputs["ids"]
        text = t5(torch.cat([negative_ids(ids.shape[1], device), ids])).float()
        del t5
        _free_cuda(device)
        out["text"] = text
        # the image latent, then the starting noise, from the request's generator
        with torch.device("meta"):
            vae = ref.VAE(vc)
        vae = vae.to_empty(device=device).eval()
        _load(vae, "", vae_weights(config, seed, device))
        image = _image(traffic, s["height"], s["width"], harness.seed_for(req.seed, "image"),
                       device)
        gen = torch.Generator(device=device).manual_seed(req.seed)
        frames = (s["num_frames"] - 1) // vc.temporal_compression_ratio + 1
        lat = ref.image_latent(vae, image, gen, frames)
        if fault == "image_zero":
            lat = torch.zeros_like(lat)
        down = 2 ** (len(vc.block_out_channels) - 1)
        starts = torch.randn((1, frames, vc.latent_channels, s["height"] // down,
                              s["width"] // down), generator=gen, device=device)
        out.update(latent=lat, starts=starts)
        if window_latents is not None:
            out["video"] = ref.decode(vae, window_latents)
        del vae
        _free_cuda(device)
        # the transformer, a block at a time, over the checked steps
        a, ts = schedule(config, traffic, "leading" if fault == "leading" else None)
        dtype = getattr(torch, config["transformer_dtype"])
        with torch.device("meta"):
            head = ref.Transformer(tc, blocks=False)
        head = head.to_empty(device=device).eval()
        _load(head, "", {k: v.float() for k, v in
                         transformer_head(config, seed, device, dtype).items()})
        image2 = torch.cat([lat, lat])
        states = {}
        for st in checked:
            x = torch.cat([torch.cat([req.x[st], req.x[st]]), image2], dim=2)
            t = torch.full((2,), ts[st], device=device, dtype=torch.long)
            states[st] = head.embed(x, t, text)
        rope = head.rope(frames, s["height"] // down, s["width"] // down, device)
        for i in range(tc.num_layers):
            with torch.device("meta"):
                blk = ref.Block(tc)
            blk = blk.to_empty(device=device).eval()
            _load(blk, "", {k: v.float() for k, v in
                            transformer_block(config, seed, i, device, dtype).items()})
            for st in checked:
                h, e, temb = states[st]
                if i == 0:
                    y = req.attn[st][0].float()
                    nt = e.shape[1]
                    ah, ae = blk.attn1(y[:, nt:], y[:, :nt], rope)
                    out["attn"][st] = torch.cat([ae, ah], dim=1)
                h, e = blk(h, e, temb, rope)
                states[st] = (h, e, temb)
            del blk
        for st in checked:
            h, e, temb = states[st]
            both = head.out(h, e, temb, (2, frames) + tuple(req.x[st].shape[2:]))
            out["out"][st] = both
            uncond, cond = both.chunk(2)
            if stand_in:
                guided = uncond + g * (cond - uncond)
                c_x, c_v = _stand_in_coefficients(a, ts[st], n, fault)
                x_next = c_x * req.x[st] + c_v * guided
                a0, ts0 = schedule(config, traffic)
                c_x0, c_v0 = ref.ddim_coefficients(a0, ts0[st], n)
                out["cond"][st] = read_back(req.x[st], x_next, uncond, c_x0, c_v0, g)
            else:
                out["cond"][st] = cond
        del head, states
    _free_cuda(device)
    return out


def _stand_in_coefficients(a, t: int, steps: int, fault: Optional[str]):
    if fault != "v_as_eps":
        return ref.ddim_coefficients(a, t, steps)
    # the model output read as epsilon: x0 = (x - sqrt(1 - a) e) / sqrt(a)
    prev = t - 1000 // steps
    at, ap = float(a[t]), (float(a[prev]) if prev >= 0 else 1.0)
    at = max(at, 1e-12)
    r = (ap / at) ** 0.5
    return r, (1 - ap) ** 0.5 - r * (1 - at) ** 0.5


def gaps(got: Dict[str, object], want: Dict[str, object]) -> Dict[str, float]:
    """Relative L2 gaps of ``got`` (the program's, or a stand-in's) against
    the reference's ``want``: the T5 states, the image latent, the starting
    noise, block 0's joint attention and the transformer's output at the
    checked steps (worst step), the conditioned output each checked step
    carried out (worst step), the decode."""
    worst = lambda key: max(rel(got[key][k], w) for k, w in want[key].items())
    return {"text_rel": rel(got["text"], want["text"]),
            "image_rel": rel(got["latent"], want["latent"]),
            "starts_rel": rel(got["starts"], want["starts"]),
            "attn_rel": worst("attn"), "v_rel": worst("out"), "step_rel": worst("cond"),
            "decode_rel": rel(got["video"], want["video"])}


def check(state: State) -> Dict[str, dict]:
    window_latents = state.tap.last
    req = pick_request(state)
    got = program_outputs(state, req)
    got["video"] = state.sampler.decode(window_latents) if window_latents is not None else None
    config, traffic, dev, seed = state.config, state.traffic, state.ctx.device, state.ctx.seed
    checked = state.checked
    free_program(state)
    want = follow(config, traffic, req, checked, window_latents, dev, seed)
    limits = traffic["limits"]
    return {k: {"value": v, "limit": limits[k]} for k, v in gaps(got, want).items()}


# -- faults planted in the reference, put in the program's place ---------------------

def _attention(rope_on: bool = True, rope_text: bool = False, qk_norm: bool = True):
    def forward(self, h, e, rope):
        nt = e.shape[1]
        x = torch.cat([e, h], dim=1)
        b, s, d = x.shape
        split = lambda t: t.reshape(b, s, self.heads, -1).transpose(1, 2)
        qh, kh, vh = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        if qk_norm:
            qh, kh = self.norm_q(qh), self.norm_k(kh)
        if rope_on and rope_text:
            cos, sin = (torch.cat([r[:nt], r]) for r in rope)
            qh, kh = ref.apply_rotary(qh, cos, sin), ref.apply_rotary(kh, cos, sin)
        elif rope_on:
            qh = torch.cat([qh[:, :, :nt], ref.apply_rotary(qh[:, :, nt:], *rope)], dim=2)
            kh = torch.cat([kh[:, :, :nt], ref.apply_rotary(kh[:, :, nt:], *rope)], dim=2)
        o = ref.joint_attention(qh, kh, vh, qh.shape[-1] ** -0.5)
        o = self.to_out[0](o.transpose(1, 2).reshape(b, s, d))
        return o[:, nt:], o[:, :nt]
    return forward


def _gates_one(orig):
    def forward(self, h, e, temb):
        nh, ne, g, eg = orig(self, h, e, temb)
        return nh, ne, torch.ones_like(g), torch.ones_like(eg)
    return forward


def _no_pos(orig):
    def forward(self, text, video):
        return orig(self, text, video) - self.pos_embedding.float()
    return forward


FAULTS = {
    "no_rope": ("Attention.forward", lambda orig: _attention(rope_on=False)),
    "rope_text": ("Attention.forward", lambda orig: _attention(rope_text=True)),
    "no_qk_norm": ("Attention.forward", lambda orig: _attention(qk_norm=False)),
    "gates_one": ("LayerNormZero.forward", _gates_one),
    "no_pos_emb": ("PatchEmbed.forward", _no_pos),
    "image_zero": (None, None),
    "v_as_eps": (None, None),
    "leading": (None, None),
}


@contextlib.contextmanager
def planted(fault: str):
    """The reference with ``fault`` planted (see :data:`FAULTS`; the last
    three are carried out by :func:`follow` itself)."""
    where, make = FAULTS[fault]
    if where is None:
        yield
        return
    cls, attr = where.split(".")
    owner = getattr(ref, cls)
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def calibrate(ctx: harness.Ctx, control: bool) -> Dict[str, Dict[str, float]]:
    """The numbers of one request run to the checked steps, for the program
    and, with ``control``, for the control (the reference one precision step
    down: float8 operands in the transformer, TF32 in T5 and the VAE) and
    each planted fault put in its place."""
    state = setup(ctx)
    req = Request(index=0, seed=harness.seed_for(ctx.seed, "request", 0))
    state.sampler.step_seconds = []
    run_request(state, req, stop_after=max(state.checked) + 2)
    got = program_outputs(state, req)
    window_latents = state.tap.last
    got["video"] = state.sampler.decode(window_latents)
    peak = int(torch.cuda.max_memory_allocated(ctx.device)) if ctx.device.type == "cuda" else 0
    config, traffic, dev, checked = state.config, state.traffic, ctx.device, state.checked
    free_program(state)
    want = follow(config, traffic, req, checked, window_latents, dev, ctx.seed)
    out = {"program": gaps(got, want), "peak": {"bytes": peak}}
    if control:
        out["control"] = gaps(follow(config, traffic, req, checked, window_latents, dev,
                                     ctx.seed, "fp8", stand_in=True), want)
        for fault in FAULTS:
            with planted(fault):
                out[fault] = gaps(follow(config, traffic, req, checked, window_latents, dev,
                                         ctx.seed, stand_in=True, fault=fault), want)
    return out
