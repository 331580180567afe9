"""Driver of the ``recon`` traffic: steps of stage-1 motion reconstruction,
``Animate3DSystem.step`` driven as ``cli/launch.py::run_train`` drives it
(the whole-video batch uploaded once, the metrics read every
``log_every`` steps), one job in flight.

The asset (gaussians on a thin shell), the starting deformation field and
the video it is fitted to are made from the seed by the benchmark: the
video is the asset under a seeded motion (a second field) rendered by the
benchmark's reference renderer. The window cycles through one step index
from each stage of the progressive schedule (``cycle``), so each pass holds
the whole schedule's mix of frame buckets. Every step's random draws (the
renderer's straight-through masks and background draw, the ARAP sample)
are made from the seed by the benchmark and handed to the step.

The check is a training check: set-up drives the system through its first
three steps with the window's own call, and the reference follows them
from the same starting field: each step's loss, each leaf's first gradient
(as the optimizer got it, read back from its first moment) and each leaf's
change over the three steps, by the worst leaf."""

from __future__ import annotations

import gc
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import harness
from benchmark.harness import span
from benchmark.reference import precision
from benchmark.reference.gs import cameras as ref_cameras
from benchmark.reference.gs import system as ref_system
from benchmark.reference.gs.state import GaussianState as RefState

CHECKED = 3
ADAM_B1 = 0.9
# K-planes planes (index into the pairs of the axes x, y, z, t) that hold t
TIME_PLANES = (2, 4, 5)


def make_asset(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``n_gaussians`` on a thin shell of radius ``asset_radius`` with seeded
    colours, opacities, scales and rotations (degree-0 SH)."""
    g = torch.Generator(device=device).manual_seed(harness.seed_for(seed, "asset"))
    n, a = cfg["n_gaussians"], cfg["asset"]
    d = torch.randn((n, 3), generator=g, device=device)
    d = d / d.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    r = a["radius"] * (1.0 + a["thickness"] * torch.randn((n, 1), generator=g, device=device))
    rgb = torch.rand((n, 3), generator=g, device=device)
    quat = torch.randn((n, 4), generator=g, device=device)
    return {"xyz": d * r,
            "features_dc": ((rgb - 0.5) / 0.28209479177387814)[:, None, :],
            "features_rest": torch.zeros((n, 0, 3), device=device),
            "opacity": a["opacity_logit"] + a["opacity_spread"] * torch.randn(
                (n, 1), generator=g, device=device),
            "scaling": np.log(a["scale"]) + a["scale_spread"] * torch.randn(
                (n, 3), generator=g, device=device),
            "rotation": quat / quat.norm(dim=-1, keepdim=True)}


def field_weights(shapes: Dict[str, torch.Size], seed: int, tag: str, out_scale: float,
                  device) -> Dict[str, torch.Tensor]:
    """A deformation field from the seed: spatial planes U(0.1, 0.5), time
    planes 1 + 0.1·U(-1, 1), hidden layers N(0, 1/fan_in), output layers
    ``out_scale``·N(0, 1/fan_in) (the port starts them at 0; a nonzero start
    gives every leaf a gradient on the first step)."""
    g = torch.Generator(device=device).manual_seed(harness.seed_for(seed, "field", tag))
    out = {}
    for name, shape in shapes.items():
        if name.startswith("grid_"):
            u = torch.rand(shape, generator=g, device=device)
            time_plane = int(name.split("_")[2]) in TIME_PLANES
            out[name] = 1.0 + 0.1 * (2.0 * u - 1.0) if time_plane else 0.1 + 0.4 * u
        else:
            z = torch.randn(shape, generator=g, device=device) * shape[1] ** -0.5
            out[name] = z * (out_scale if name.endswith("out.weight") else 1.0)
    return out


def camera_params(cfg: dict):
    return (cfg["elevation_deg"], cfg["azimuth_deg"], cfg["camera_distance"], cfg["fovy_deg"],
            cfg["n_frame"])


def draws_for(cfg: dict, seed: int, k: int, n_items: int, device) -> ref_system.Draws:
    """The random draws of the window's k-th step, from the seed."""
    g = torch.Generator(device=device).manual_seed(harness.seed_for(seed, "draws", k))
    n = cfg["n_gaussians"]
    st = (torch.rand((n_items, n, 1), generator=g, device=device)
          < cfg["renderer"]["straight_through_prob"]).float()
    bg = torch.rand((), generator=g, device=device)
    idx = torch.randint(0, n, (cfg["loss"]["arap_sample_num"],), generator=g, device=device)
    return ref_system.Draws(st, bg, idx)


def n_items(cfg: dict, step: int) -> int:
    """Items (views x frames) the step renders: the unlocked frames' bucket,
    or every frame past half the video."""
    f = cfg["n_frame"]
    active = min(step // cfg["progressive_iter_per_frame"], f - 2) + 1
    bucket = 2
    while bucket < active:
        bucket *= 2
    return cfg["n_view"] * (f if bucket > f // 2 else bucket)


@dataclass
class State:
    ctx: harness.Ctx
    cfg: dict
    traffic: dict
    system: object
    batch: dict
    video: tuple
    k: int = 0
    pending: List[dict] = field(default_factory=list)
    losses: List[float] = field(default_factory=list)
    first_grad: Dict[str, torch.Tensor] = field(default_factory=dict)
    after: Dict[str, torch.Tensor] = field(default_factory=dict)
    start: Dict[str, torch.Tensor] = field(default_factory=dict)


def _ref_state(asset: Dict[str, torch.Tensor]) -> RefState:
    return RefState(**asset)


def _reference(cfg: dict, asset, weights, video, device) -> ref_system.Recon:
    c2w, fovy, ts = ref_cameras.view_major(*camera_params(cfg))
    cams = ref_cameras.gs_cameras(c2w, fovy, cfg["size"], cfg["size"], device)
    rgb, mask = video
    return ref_system.Recon(cfg, _ref_state(asset), weights, cams, ts, rgb, mask)


def make_video(cfg: dict, seed: int, asset, shapes, device):
    """The video the recon fits: the asset under a seeded motion (a field
    with ``motion_scale`` output layers), every view and frame rendered by
    the reference; mask = alpha > 0.5."""
    motion = field_weights(shapes, seed, "motion", cfg["motion_scale"], device)
    empty = (torch.zeros(0, device=device), torch.zeros(0, device=device))
    rec = _reference(cfg, asset, motion, empty, device)
    rgb, alpha = rec.render_all()
    return rgb.contiguous(), (alpha > 0.5)[..., None].float().contiguous()


def _program_system(cfg: dict, asset, device, guidance=None, guidance_inputs=None):
    from animate3d_tpu_torch.gaussians.deform import DeformConfig
    from animate3d_tpu_torch.gaussians.state import GaussianState
    from animate3d_tpu_torch.rendering.renderer4d import Renderer4DConfig
    from animate3d_tpu_torch.systems.animate3d import (Animate3DConfig, Animate3DSystem,
                                                       LossConfig)

    r, lc = cfg["renderer"], cfg["loss"]
    acfg = Animate3DConfig(
        n_view=cfg["n_view"], n_frame=cfg["n_frame"],
        progressive_iter_per_frame=cfg["progressive_iter_per_frame"],
        sample_strategy=cfg["sample_strategy"], frame_bucketing=cfg["frame_bucketing"],
        delta_xyz_network_lr=cfg["delta_xyz_network_lr"],
        delta_rot_network_lr=cfg["delta_rot_network_lr"],
        delta_scaling_network_lr=cfg["delta_scaling_network_lr"],
        grid_lr=cfg["grid_lr"], global_trans_lr=cfg["global_trans_lr"],
        deform=DeformConfig(grid_sizes=tuple(tuple(x) for x in cfg["grid_size"]),
                            grid_feature_dim=cfg["n_grid_dims"], mlp_width=cfg["mlp_width"],
                            use_global_trans=cfg["use_global_trans"]),
        renderer=Renderer4DConfig(height=cfg["size"], width=cfg["size"],
                                  back_ground_color=tuple(r["back_ground_color"]),
                                  invert_bg_prob=r["invert_bg_prob"],
                                  first_frame_trainable=r["first_frame_trainable"],
                                  straight_through_prob=r["straight_through_prob"]),
        load_guidance=guidance is not None,
        loss=LossConfig(**{k: lc[k] for k in ("lambda_rgb", "lambda_mask", "lambda_arap",
                                              "lambda_sds", "arap_radius", "arap_K",
                                              "arap_sample_num") if k in lc}))
    state = GaussianState(**{k: v.clone() for k, v in asset.items()})
    return Animate3DSystem(acfg, state=state, device=device, guidance=guidance,
                           guidance_inputs=guidance_inputs)


def _program_batch(cfg: dict, video, device) -> dict:
    from animate3d_tpu_torch.data.cameras import _view_major, gs_cameras_from_batch

    elev, azim, dist, fovy, f = camera_params(cfg)
    nv = len(azim)
    raw = _view_major(np.full(nv, elev, np.float64), np.asarray(azim, np.float64), dist, fovy,
                      cfg["size"], cfg["size"], f)
    return {"gs_cameras": gs_cameras_from_batch(raw, device=device),
            "timestamps": np.asarray(raw["timestamps"]), "rgb": video[0], "mask": video[1]}


def run_step(state: State) -> dict:
    """The window's call: step ``k`` of the run, at the cycle's step index,
    with its draws."""
    from animate3d_tpu_torch.rendering.renderer4d import RenderDraws
    from animate3d_tpu_torch.systems.animate3d import StepDraws

    cycle = state.traffic["cycle"]
    idx = cycle[state.k % len(cycle)]
    d = draws_for(state.cfg, state.ctx.seed, state.k, n_items(state.cfg, idx),
                  state.ctx.device)
    state.system.global_step = idx
    with span("system.step"):
        metrics = state.system.step(state.batch, draws=StepDraws(
            render=RenderDraws(d.st_mask, d.bg_uniform), arap_idx=d.arap_idx))
    state.k += 1
    state.pending.append(metrics)
    if len(state.pending) >= state.traffic["log_every"]:
        flush(state)
    return metrics


def flush(state: State) -> None:
    """The metrics read back, as ``run_train`` reads them every
    ``log_every`` steps (a device synchronise)."""
    with span("metrics.flush"):
        for m in state.pending:
            for v in m.values():
                float(v)
    state.pending.clear()


def setup(ctx: harness.Ctx) -> State:
    from animate3d_tpu_torch.core.device import resolve_device

    cfg, traffic = ctx.spec.config, ctx.spec.traffic
    dev = resolve_device(ctx.device)
    asset = make_asset(cfg, ctx.seed, dev)
    shapes = {k: v.shape for k, v in ref_system.DeformationField(
        ref_system.deform_config(cfg)).state_dict().items()}
    video = make_video(cfg, ctx.seed, asset, shapes, dev)
    system = _program_system(cfg, asset, dev)
    start = field_weights(shapes, ctx.seed, "start", cfg["start_out_scale"], dev)
    system.field.load_state_dict(start)
    state = State(ctx=ctx, cfg=cfg, traffic=traffic, system=system,
                  batch=_program_batch(cfg, video, dev), video=video)
    first_steps(state, run_step, max(CHECKED, len(traffic["cycle"])),
                lambda: system.opt.mu, lambda: dict(system.field.named_parameters()))
    return state


def first_steps(state: State, step_fn, n: int, first_moments, leaves) -> None:
    """The run's first ``n`` steps through the window's own call: the first
    three are the ones checked (their losses, the first gradient from the
    optimizer's first moments ``first_moments()`` by leaf, the leaves
    ``leaves()`` after the third), the rest warm every shape of the cycle."""
    state.start = {k: v.detach().clone() for k, v in leaves().items()}
    for i in range(n):
        metrics = step_fn(state)
        if i < CHECKED:
            state.losses.append(float(metrics["loss"]))
        if i == 0:
            state.first_grad = {k: (m / (1.0 - ADAM_B1)).clone()
                                for k, m in first_moments().items()}
        if i == CHECKED - 1:
            state.after = {k: v.detach().clone() for k, v in leaves().items()}
    flush(state)


def window(state: State, win) -> None:
    while True:
        run_step(state)
        win.tick()


def step_flops(cfg: dict, step: int) -> float:
    """Counted operations of one recon step (forward and backward taken as
    three forwards): the K-planes interpolation (per point, scale and plane
    four taps of every feature, and the product over planes) and the MLPs
    (the position and rotation networks; the global networks act on one
    mean a frame) at the step's frames, and the projection of every point
    of every rendered item. The compositor's work depends on the data and
    is not counted."""
    f_items = n_items(cfg, step)
    frames = f_items // cfg["n_view"]
    n, c, w = cfg["n_gaussians"], cfg["n_grid_dims"], cfg["mlp_width"]
    scales = len(cfg["grid_size"])
    kplanes = scales * 6 * (4 * c * 2 + c)
    feat = c * scales
    mlps = sum(2 * (feat * w + w * out) for out in (3, 4))
    projection = 250
    return 3.0 * (frames * n * (kplanes + mlps) + f_items * n * projection)


def trace_counts(state: State, win) -> Dict[str, float]:
    cycle = state.traffic["cycle"]
    first = state.k - win.units
    flops = sum(step_flops(state.cfg, cycle[k % len(cycle)]) for k in range(first, state.k))
    return {"flops": flops}


# -- the check -------------------------------------------------------------------

def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             floor: float = 1e-3) -> float:
    """The worst leaf's |‖got‖ − ‖want‖| over the larger of its reference
    norm and the median leaf's; leaves whose reference norm is under
    ``floor`` of the median leaf's (no gradient to rounding) are left out."""
    norms = {k: float(want[k].double().norm()) for k in want}
    med = float(np.median(list(norms.values())))
    worst = 0.0
    for k, ref in norms.items():
        if ref < floor * med:
            continue
        gap = abs(float(got[k].double().norm()) - ref) / max(ref, med)
        worst = max(worst, gap)
    return worst


def follow(state: State, mode: str = "f32", fault: Optional[str] = None):
    """The reference through the three checked steps from the same start:
    (losses, first gradients, parameters after the three); with ``fault``,
    the reference with that fault planted."""
    cfg, dev, seed = state.cfg, state.ctx.device, state.ctx.seed
    asset = make_asset(cfg, seed, dev)
    start = {k: v.clone() for k, v in state.start.items()}
    rec = _reference(cfg, asset, start, state.video, dev)
    rec.fault = fault
    cycle = state.traffic["cycle"]
    losses, first = [], None
    with precision.mode(mode):
        for k in range(CHECKED):
            idx = cycle[k % len(cycle)]
            loss, grads = rec.step(idx, draws_for(cfg, seed, k, n_items(cfg, idx), dev))
            losses.append(float(loss))
            if k == 0:
                first = grads
    return losses, first, {k: p.detach().clone() for k, p in rec.params.items()}


def gaps(state: State, got, want) -> Dict[str, float]:
    """loss_rel: the worst step's relative loss gap; grad_gap and
    change_gap: :func:`leaf_gap` of the first gradients and of the
    parameters' change over the three steps. ``got`` and ``want`` are
    (losses, first gradients, parameters after the three)."""
    (losses, first, after), (want_l, want_g, want_p) = got, want
    change = lambda p: {k: p[k] - state.start[k] for k in p}
    return {"loss_rel": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, want_l)),
            "grad_gap": leaf_gap(first, want_g),
            "change_gap": leaf_gap(change(after), change(want_p))}


def program_readings(state: State):
    return state.losses, state.first_grad, state.after


def release(device) -> None:
    """Collect what is no longer referenced and hand the cached blocks back,
    before the reference (or the next reading) builds its modules."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def free_program(state: State) -> None:
    state.system = state.batch = None
    state.pending.clear()
    release(state.ctx.device)


def check(state: State, follow_fn=None) -> Dict[str, dict]:
    free_program(state)
    numbers = gaps(state, program_readings(state), (follow_fn or follow)(state))
    return with_limits(numbers, state.traffic["limits"])


def with_limits(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """The numbers the traffic gives a limit, each beside it (a number with
    no limit is not compared: PERF.md names it with its readings)."""
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}


def calibrate(ctx: harness.Ctx, control: bool) -> Dict[str, Dict[str, float]]:
    """The numbers of the three checked steps for the program and, with
    ``control``, for the reference with TF32 on put in its place (one step
    below the configuration's float32) and for the reference with each
    planted fault (:func:`follow`). A state left unchanged reads 1 by the
    change's measure and needs no run."""
    return readings(setup(ctx), control, follow, "tf32")


def readings(state: State, control: bool, follow_fn, control_mode: str):
    free_program(state)
    want = follow_fn(state)
    out = {"program": gaps(state, program_readings(state), want)}
    if control:
        out["control"] = gaps(state, follow_fn(state, control_mode), want)
        for fault in ("half_batch", "altered"):
            out[fault] = gaps(state, follow_fn(state, fault=fault), want)
    return out
