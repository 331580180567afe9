"""Animate3D 4D optimisation system (stage-1 motion reconstruction and
stage-2 4D-SDS refine): the port of ``animate3d_tpu/systems/animate3d.py``.

  * progressive frame unlocking: ``start = step // progressive_iter_per_frame``
    ('normal': frames 1..start+1; 'light': one random past frame + the
    newest); frame 0 (the static asset) never carries loss;
  * frame bucketing: only the unlocked frames are rendered, padded to a
    power-of-two bucket whose pad slots repeat the last active frame with
    weight 0, so loss, normalisation and ARAP equal the full batch's;
  * loss: rgb MSE against the background-composited GT + mask MSE, ARAP
    over the first view's trajectory (frame-0 connectivity), optional
    position / sparsity / scales / TV terms, all weights ``C()``-schedulable;
  * only the deformation field trains: per-group Adam (eps 1e-15, each
    group's learning rate an exp-interpolated ``c_schedule``) applied as
    optax applies it.

A step's random draws (the straight-through masks, the ARAP sample, the
background inversion) come from the system's ``torch.Generator``, or are
given to :meth:`Animate3DSystem.step` (the tests feed JAX's).

Data parallel (``mesh``, a ``parallel.mesh.Mesh`` with dp > 1; the JAX
launcher's ``trainer.mesh_dp``): every rank draws the whole step's draws
from its generator (all seeded alike, so they stay in step) and renders its
contiguous slice of the step's view·frame items and of the SDS batch (which
it VAE-encodes; the latents are gathered for the guidance's UNet, which
couples a video's views and frames); terms that are means over the items
are normalised by the global batch, terms that do not depend on it (ARAP)
count on rank 0 only, and the field's gradients are summed over the ranks
before ``DeformAdam``.
"""

from __future__ import annotations

import dataclasses
import json
import random as pyrandom
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from animate3d_tpu_torch.core.config import C_max
from animate3d_tpu_torch.core.device import resolve_device
from animate3d_tpu_torch.core.registry import register
from animate3d_tpu_torch.core.schedule import C, c_schedule
from animate3d_tpu_torch.gaussians import arap as arap_mod
from animate3d_tpu_torch.gaussians.deform import DeformationField, DeformConfig
from animate3d_tpu_torch.gaussians.ply import load_gaussians
from animate3d_tpu_torch.gaussians.state import GaussianState
from animate3d_tpu_torch.ops.rasterize import GSCameraArrays
from animate3d_tpu_torch.parallel import mesh as pmesh
from animate3d_tpu_torch.rendering.renderer4d import (
    RenderDraws,
    Renderer4DConfig,
    make_draws,
    render_batch,
)
from animate3d_tpu_torch.utils.loss import tv_loss


@dataclass
class LossConfig:
    lambda_rgb: Any = 100.0
    lambda_mask: Any = 100.0
    lambda_sds: Any = 0.0
    lambda_arap: Any = 12.0
    arap_radius: float = 0.01
    arap_K: int = 3
    arap_sample_num: int = 512
    lambda_position: Any = 0.0
    lambda_opacity: Any = 0.0
    lambda_sparsity: Any = 0.0
    lambda_scales: Any = 0.0
    lambda_tv_loss: Any = 0.0
    lambda_depth_tv_loss: Any = 0.0


@dataclass
class Animate3DConfig:
    n_view: int = 4
    n_frame: int = 16
    progressive_iter_per_frame: int = 50
    sample_strategy: str = "normal"  # normal | light
    frame_bucketing: bool = True
    load_guidance: bool = False
    geometry_convert_from: str = ""
    rot_x_degree: float = 0.0
    rot_z_degree: float = 0.0
    scale_factor: float = 1.0
    max_sh_degree: int = 0
    connected_vertices_info_path: str = ""
    delta_xyz_network_lr: Any = 1e-4
    delta_rot_network_lr: Any = 1e-4
    delta_scaling_network_lr: Any = 1e-4
    grid_lr: Any = 0.01
    global_trans_lr: Any = 1e-3
    deform: DeformConfig = field(default_factory=DeformConfig)
    renderer: Renderer4DConfig = field(default_factory=Renderer4DConfig)
    loss: LossConfig = field(default_factory=LossConfig)


def _param_group(name: str) -> str:
    for prefix, group in (("grid_", "grid"), ("delta_xyz", "delta_xyz_network"),
                          ("delta_rot", "delta_rot_network"),
                          ("delta_scaling", "delta_scaling_network"),
                          ("global_", "global_trans")):
        if name.startswith(prefix):
            return group
    return "grid"


class DeformAdam:
    """optax ``multi_transform`` of per-group ``adam(c_schedule(lr, "exp"),
    eps=1e-15)``: moments ``(1-b)·g + b·m``, bias correction in f32 with the
    incremented count, the learning rate at the count before it, the update
    added to the parameters. A parameter without a gradient counts as a
    zero gradient, as in the JAX package's full-tree update."""

    def __init__(self, named_params: Dict[str, torch.nn.Parameter],
                 lrs: Dict[str, Callable[[int], float]], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-15):
        self.params = dict(named_params)
        self.lrs = {name: lrs[_param_group(name)] for name in self.params}
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        count = self.count + 1
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        bc1 = float(1 - f32(self.b1) ** count)
        bc2 = float(1 - f32(self.b2) ** count)
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * (g * g) + self.b2 * self.nu[k]
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
            p.add_(-self.lrs[k](self.count) * upd)
        self.count = count

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}


def make_deform_optimizer(field_: DeformationField, cfg: Animate3DConfig) -> DeformAdam:
    """Per-group Adam (eps 1e-15) with exp-interpolated learning rates."""
    lrs = {"delta_xyz_network": cfg.delta_xyz_network_lr,
           "delta_rot_network": cfg.delta_rot_network_lr,
           "delta_scaling_network": cfg.delta_scaling_network_lr,
           "grid": cfg.grid_lr, "global_trans": cfg.global_trans_lr}
    return DeformAdam(dict(field_.named_parameters()),
                      {k: c_schedule(v, "exp") for k, v in lrs.items()})


class StepDraws(NamedTuple):
    """A step's given random draws, each optional: ``render`` (the
    renderer's :class:`RenderDraws`), ``arap_idx`` (the ARAP node sample)
    and ``guidance`` (the SDS loss's ``GuidanceDraws``); what is not given
    comes from the system's generator."""

    render: Optional[RenderDraws] = None
    arap_idx: Optional[torch.Tensor] = None
    guidance: Optional[Any] = None  # pipelines.guidance.GuidanceDraws


class _GatherRows(torch.autograd.Function):
    """Every dp rank's rows, concatenated; the backward keeps this rank's
    rows of the gradient. Right where every rank computes the same function
    of the gathered tensor, so the incoming gradient is the same on all."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows = pmesh.shard_rows(mesh, x.shape[0] * mesh.dp)
        return pmesh.all_gather_rows(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows], None


@register("gaussian-splatting-animate3d-system")
class Animate3DSystem:
    """Holds the frozen gaussian state, the trainable deformation field and
    its optimizer, on ``device`` (``cuda`` unless asked for the CPU)."""

    def __init__(self, cfg: Animate3DConfig, state: Optional[GaussianState] = None,
                 seed: int = 0, device=None, guidance=None,
                 guidance_inputs: Optional[Dict[str, Any]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.guidance = guidance
        self.guidance_inputs = guidance_inputs or {}
        if state is None:
            if not cfg.geometry_convert_from:
                raise ValueError("need system.geometry.geometry_convert_from (a .ply) or a state")
            state = load_gaussians(cfg.geometry_convert_from, cfg.rot_x_degree,
                                   cfg.rot_z_degree, cfg.scale_factor, cfg.max_sh_degree)
        self.state = state.to(self.device)
        init_gen = torch.Generator().manual_seed(seed)
        self.field = DeformationField(cfg.deform, generator=init_gen).to(self.device)
        self.opt = make_deform_optimizer(self.field, cfg)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.mesh: Optional[pmesh.Mesh] = None  # set for data parallel (dp > 1)
        self.global_step = 0
        if cfg.connected_vertices_info_path:
            with open(cfg.connected_vertices_info_path) as f:
                nn_idx, valid = arap_mod.connectivity_from_mesh_edges(json.load(f))
            self.mesh_nn_idx = torch.as_tensor(nn_idx, device=self.device)
            self.mesh_valid = torch.as_tensor(valid, device=self.device)
            self.connectivity = None
        else:
            self.mesh_nn_idx = None
            self.connectivity = arap_mod.connectivity_from_points(
                self.state.xyz[None], radius=cfg.loss.arap_radius, K=cfg.loss.arap_K)
        self.active_terms = frozenset(
            name for name in ("lambda_position", "lambda_sparsity", "lambda_scales",
                              "lambda_tv_loss", "lambda_arap")
            if C_max(getattr(cfg.loss, name)) > 0.0)
        self._bucket_key = None

    @classmethod
    def from_config(cls, cfg, seed: int = 0, device=None):
        """From an ExperimentConfig (``system_type:
        gaussian-splatting-animate3d-system``)."""
        from animate3d_tpu_torch.core.config import parse_structured

        s = cfg.system
        geo = dict(s.get("geometry", {}))
        load_ply = dict(geo.get("load_ply_cfg", {}))
        renderer = dict(s.get("renderer", {}))
        loss = {k: v for k, v in dict(s.get("loss", {})).items()
                if k in LossConfig.__dataclass_fields__}
        acfg = Animate3DConfig(
            n_view=s.get("n_view", 4), n_frame=s.get("n_frame", 16),
            progressive_iter_per_frame=s.get("progressive_iter_per_frame", 50),
            sample_strategy=s.get("sample_strategy", "normal"),
            frame_bucketing=s.get("frame_bucketing", True),
            load_guidance=s.get("load_guidance", False),
            geometry_convert_from=geo.get("geometry_convert_from", ""),
            rot_x_degree=load_ply.get("rot_x_degree", 0.0),
            rot_z_degree=load_ply.get("rot_z_degree", 0.0),
            scale_factor=load_ply.get("scale_factor", 1.0),
            connected_vertices_info_path=s.get("connected_vertices_info_path", ""),
            delta_xyz_network_lr=geo.get("delta_xyz_network_lr", 1e-4),
            delta_rot_network_lr=geo.get("delta_rot_network_lr", 1e-4),
            delta_scaling_network_lr=geo.get("delta_scaling_network_lr", 1e-4),
            grid_lr=geo.get("grid_lr", 0.01), global_trans_lr=geo.get("global_trans_lr", 1e-3),
            deform=DeformConfig(
                grid_sizes=tuple(tuple(g) for g in geo.get(
                    "grid_size", ((50, 50, 50, 8), (100, 100, 100, 16)))),
                grid_feature_dim=geo.get("n_grid_dims", 16),
                use_global_trans=geo.get("use_global_trans", False)),
            renderer=Renderer4DConfig(
                height=cfg.data.get("height", 256), width=cfg.data.get("width", 256),
                back_ground_color=tuple(renderer.get("back_ground_color", (1, 1, 1))),
                invert_bg_prob=renderer.get("invert_bg_prob", 1.0),
                first_frame_trainable=renderer.get("first_frame_trainable", False)),
            loss=parse_structured(LossConfig, loss))
        guidance = guidance_inputs = None
        if acfg.load_guidance:
            if not (cfg.data.get("use_random_camera", False)):
                raise ValueError("system.load_guidance=true (refine) renders the SDS batch "
                                 "of data.random_camera: set data.use_random_camera=true")
            from animate3d_tpu_torch.pipelines.guidance import build_guidance_from_config

            guidance, guidance_inputs = build_guidance_from_config(s, acfg, device)
        return cls(acfg, seed=seed, device=device, guidance=guidance,
                   guidance_inputs=guidance_inputs)

    # -- progressive frame schedule (host side) --------------------------------

    def frame_weights(self, step: int) -> np.ndarray:
        """(F,) weight per frame: frame 0 always 0, frames past the
        progressive horizon 0."""
        cfg = self.cfg
        start = min(step // cfg.progressive_iter_per_frame, cfg.n_frame - 2)
        w = np.zeros((cfg.n_frame,), np.float32)
        if cfg.sample_strategy == "normal":
            w[1:start + 2] = 1.0
        elif cfg.sample_strategy == "light":
            if start == 0:
                w[1] = 1.0
            elif step >= cfg.progressive_iter_per_frame * (cfg.n_frame - 1):
                w[1:] = 1.0
            else:
                w[pyrandom.randint(1, start)] = 1.0
                w[start + 1] = 1.0
        else:
            raise NotImplementedError(cfg.sample_strategy)
        return w

    def lambdas(self, step: int) -> Dict[str, float]:
        lc = self.cfg.loss
        out = {k: float(C(getattr(lc, k), 0, step))
               for k in ("lambda_rgb", "lambda_mask", "lambda_arap", "lambda_sds",
                         "lambda_position", "lambda_sparsity", "lambda_scales",
                         "lambda_tv_loss")}
        if self.guidance is not None:
            out["g_min_step"], out["g_max_step"] = self.guidance.min_max_step(step)
        return out

    # -- loss --------------------------------------------------------------------

    def _arap(self, means_per_frame: torch.Tensor, frame_w: torch.Tensor,
              draws: StepDraws) -> torch.Tensor:
        """means_per_frame: (F', Nv, 3) first-view trajectory."""
        cfg = self.cfg
        nodes = torch.cat([self.state.xyz[None], means_per_frame], dim=0)
        if self.mesh_nn_idx is not None:
            picked = arap_mod.sample_neighbor_subset(
                self.mesh_nn_idx, self.mesh_valid, cfg.loss.arap_K, generator=self.generator)
            w = (picked >= 0).float()
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-12)
            conn = arap_mod.Connectivity(nn_idx=picked, weight=w)
        else:
            conn = self.connectivity
        return arap_mod.arap_error(nodes, conn, sample_idx=draws.arap_idx,
                                   sample_num=cfg.loss.arap_sample_num, frame_weights=frame_w,
                                   generator=self.generator)

    def _rows(self, n: int) -> slice:
        """This rank's items of ``n`` (all of them without a dp mesh)."""
        return slice(0, n) if self.mesh is None else pmesh.shard_rows(self.mesh, n)

    def loss(self, cameras: GSCameraArrays, timestamps: torch.Tensor, gt_rgb: torch.Tensor,
             gt_mask: torch.Tensor, frame_w: torch.Tensor, lambdas: Dict[str, float],
             draws: Optional[StepDraws] = None):
        """→ (loss, metrics) of one step's items (view-major, F' frames a
        view). On a dp mesh: this rank's part, whose sum over the ranks is
        the loss (and the metrics, but for ``psnr``, which :meth:`step`
        derives again after the sum)."""
        cfg = self.cfg
        draws = draws or StepDraws()
        b = timestamps.shape[0]
        n_active = b // cfg.n_view
        frame_ts = timestamps[:n_active]
        deformed = self.field.deform_frames(self.state, frame_ts, False)

        def frame_index(ts):
            return torch.argmin(torch.abs(frame_ts[None, :] - ts[:, None]), dim=1)

        def deform_fn(ts):  # per item: its frame's deformation
            fi = frame_index(ts)
            return tuple(d[fi] for d in deformed)

        rd = draws.render
        if rd is None:
            rd = make_draws(cfg.renderer, b, self.state.num_points, self.generator, self.device)
        rows = self._rows(b)
        frac = (rows.stop - rows.start) / b  # this rank's share of a mean over the items
        out = render_batch(self.state, deform_fn, cameras.index(rows), timestamps[rows],
                           cfg.renderer, draws=RenderDraws(rd.st_mask[rows], rd.bg_uniform))
        item_w = frame_w.repeat(cfg.n_view)
        wsum = torch.clamp(item_w.sum(), min=1e-8)
        item_w = item_w[rows]
        gt_rgb, gt_mask = gt_rgb[rows], gt_mask[rows]
        bgc = torch.tensor(cfg.renderer.back_ground_color, dtype=torch.float32,
                           device=self.device)
        gt = gt_rgb * gt_mask + bgc * (1.0 - gt_mask)
        per_item_rgb = ((gt - out.rgb) ** 2).mean(dim=(1, 2, 3))
        loss_rgb = (per_item_rgb * item_w).sum() / wsum
        per_item_mask = ((gt_mask[..., 0] - out.alpha) ** 2).mean(dim=(1, 2))
        loss_mask = (per_item_mask * item_w).sum() / wsum
        loss = lambdas["lambda_rgb"] * loss_rgb + lambdas["lambda_mask"] * loss_mask
        psnr = -10.0 * torch.log10(torch.clamp((per_item_rgb * item_w).sum() / wsum, min=1e-10))
        metrics = {"loss_rgb": loss_rgb, "loss_mask": loss_mask, "psnr": psnr,
                   "raster_overflow": out.overflow.float()}
        if "lambda_arap" in self.active_terms:
            # the first view's trajectory (render_batch's means3d of its
            # items), which a dp rank may not render
            static = (frame_ts == -1.0) & (not cfg.renderer.first_frame_trainable)
            means = torch.where(static[:, None, None], self.state.xyz[None],
                                deformed[0][frame_index(frame_ts)])
            # drawn on every rank, so that the generators stay in step
            loss_arap = self._arap(means, frame_w, draws)
            if self.mesh is None or self.mesh.is_main:
                loss = loss + lambdas["lambda_arap"] * loss_arap
            else:
                loss_arap = torch.zeros_like(loss_arap)
            metrics["loss_arap"] = loss_arap
        if "lambda_position" in self.active_terms:
            safe_norm = torch.sqrt((out.means3d ** 2).sum(-1) + 1e-12)
            loss = loss + lambdas["lambda_position"] * (safe_norm.mean() * frac)
        if "lambda_sparsity" in self.active_terms:
            loss = loss + lambdas["lambda_sparsity"] * (
                torch.sqrt(out.alpha ** 2 + 0.01).mean() * frac)
        if "lambda_scales" in self.active_terms:
            loss = loss + lambdas["lambda_scales"] * (
                out.scales.sum() / out.scales.shape[0] * frac)
        if "lambda_tv_loss" in self.active_terms:
            loss = loss + lambdas["lambda_tv_loss"] * (tv_loss(out.rgb) * frac)
        metrics["loss"] = loss
        return loss, metrics

    # -- public ------------------------------------------------------------------

    def step_batch(self, batch: Dict[str, Any]):
        """(cameras, timestamps, rgb, mask, frame weights) of this step's
        items: the bucketed or 'light' subset of the whole-video batch."""
        cfg = self.cfg
        frame_w = self.frame_weights(self.global_step)
        cameras, timestamps = batch["gs_cameras"], np.asarray(batch["timestamps"])
        rgb, mask = batch["rgb"], batch["mask"]
        active = np.nonzero(frame_w)[0]
        if cfg.sample_strategy == "light" and not self.do_guidance:
            if len(active) == 1:
                active = np.array([active[0], active[0]])
            idx = np.concatenate([v * cfg.n_frame + active for v in range(cfg.n_view)])
            return (cameras.index(torch.as_tensor(idx, device=rgb.device)), timestamps[idx],
                    rgb[idx], mask[idx], np.ones(len(active), np.float32))
        bucket = 2
        while bucket < len(active):
            bucket *= 2
        if cfg.sample_strategy != "normal" or not cfg.frame_bucketing \
                or bucket > cfg.n_frame // 2:
            return cameras, timestamps, rgb, mask, frame_w
        pad = np.full(bucket - len(active), active[-1], np.int64)
        active_p = np.concatenate([active, pad])
        key = (active_p.tobytes(), id(rgb), id(mask))
        if self._bucket_key != key:  # the subset changes at phase boundaries only
            idx = np.concatenate([v * cfg.n_frame + active_p for v in range(cfg.n_view)])
            it = torch.as_tensor(idx, device=rgb.device)
            self._bucket_key = key
            self._bucket = (cameras.index(it), timestamps[idx], rgb[it], mask[it])
        return self._bucket + (np.concatenate([frame_w[active],
                                               np.zeros(len(pad), np.float32)]),)

    @property
    def do_guidance(self) -> bool:
        return self.cfg.load_guidance and self.guidance is not None

    def _render_guidance_rgb(self, guidance_batch: Dict[str, Any]) -> torch.Tensor:
        """This rank's rows (:meth:`_rows`) of the SDS batch's renders
        (B·N·F, s, s, 3) at the guidance's size ``s``, each item deformed at
        its frame (scales too), no draws."""
        cfg = self.cfg
        res = self.guidance.cfg.image_size
        rcfg = dataclasses.replace(cfg.renderer, height=res, width=res)
        ts = torch.as_tensor(guidance_batch["timestamps"], dtype=torch.float32,
                             device=self.device)
        frame_ts = ts[:cfg.n_frame]
        deformed = self.field.deform_frames(self.state, frame_ts, True)

        def deform_fn(items):
            fi = torch.argmin(torch.abs(frame_ts[None, :] - items[:, None]), dim=1)
            return tuple(d[fi] for d in deformed)

        rows = self._rows(ts.shape[0])
        return render_batch(self.state, deform_fn, guidance_batch["cameras"].index(rows),
                            ts[rows], rcfg).rgb

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every dp rank's rows of ``x`` (``x`` itself without a dp mesh)."""
        return x if self.mesh is None else _GatherRows.apply(x, self.mesh)

    def sds_loss(self, guidance_batch: Dict[str, Any], lambdas: Dict[str, float],
                 draws=None) -> torch.Tensor:
        """The 4D-SDS loss of the SDS batch, differentiable in the field's
        parameters (render → VAE encode → loss). On a dp mesh each rank
        renders and encodes its rows; the latents are gathered for the
        UNet, which every rank runs on the whole batch."""
        from animate3d_tpu_torch.pipelines.guidance import GuidanceDraws

        g = self.guidance
        draws = draws or GuidanceDraws()
        n_items = len(guidance_batch["timestamps"])
        bn = n_items // g.cfg.n_frame
        rgb = self._render_guidance_rgb(guidance_batch)
        t_video = draws.t_video if draws.t_video is not None else g._sample_t(
            bn, (lambdas["g_min_step"], lambdas["g_max_step"]), self.generator, self.device)
        cam16 = g.camera16(guidance_batch["c2w"], bn, g.cfg.n_frame).to(self.device)
        return g.loss(rgb, guidance_batch["text_cond"], guidance_batch["text_uncond"], cam16,
                      guidance_batch["image_embeds"], t_video, draws, self.generator,
                      shard=(self._rows(n_items), self._gather))

    def sds_gradients(self, guidance_batch: Dict[str, Any], lambdas: Dict[str, float],
                      draws=None):
        """(loss_sds, {parameter name: gradient}) of the SDS loss alone."""
        loss = self.sds_loss(guidance_batch, lambdas, draws)
        names, params = zip(*self.field.named_parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), {n: (gr if gr is not None else torch.zeros_like(p))
                               for n, p, gr in zip(names, params, grads)}

    @torch.no_grad()
    def guidance_preview(self, guidance_batch: Dict[str, Any], num_steps: int = 25,
                         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Guidance-eval: the SDS batch's renders through the frozen
        teacher's preview sampler from the current largest annealed t;
        (B·N, F, H, W, 3) in [0, 1]."""
        if self.guidance is None:
            raise ValueError("guidance_preview needs system.load_guidance=true")
        g = guidance_batch
        rgb = self._gather(self._render_guidance_rgb(g))
        _, mx = self.guidance.min_max_step(self.global_step)
        return self.guidance.preview_from_rgb(
            self.guidance_inputs["vae_decode"], rgb, g["text_cond"], g["text_uncond"],
            g["c2w"], g["image_embeds"], int(mx), num_steps, noise=noise,
            generator=self.generator)

    def step(self, batch: Dict[str, Any], draws: Optional[StepDraws] = None,
             guidance_batch: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """One optimisation step on the whole-video batch (``gs_cameras``,
        ``timestamps``, ``rgb`` (B, H, W, 3), ``mask`` (B, H, W, 1) on the
        system's device) and, in refine, the SDS batch ``guidance_batch``
        (``cameras``, ``timestamps``, ``c2w``, ``text_cond``, ``text_uncond``,
        ``image_embeds``). Returns the metrics as device scalars (no sync)."""
        cameras, timestamps, rgb, mask, frame_w = self.step_batch(batch)
        dev = self.device
        draws = draws or StepDraws()
        lambdas = self.lambdas(self.global_step)
        loss, metrics = self.loss(cameras, torch.as_tensor(timestamps, device=dev), rgb,
                                  mask.float(), torch.as_tensor(frame_w, device=dev),
                                  lambdas, draws)
        metrics = {k: v.detach() for k, v in metrics.items()}
        loss_sds = None
        if self.do_guidance:
            if guidance_batch is None:
                raise ValueError("refine (load_guidance) needs the step's guidance_batch")
            loss_sds = self.sds_loss(guidance_batch, lambdas, draws.guidance)
            loss = loss + lambdas["lambda_sds"] * loss_sds
        self.opt.zero_grad()
        loss.backward()
        if self.mesh is not None:  # each rank's loss is a part of the sum
            params = list(self.opt.params.values())
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            parts = [v for k, v in metrics.items() if k != "psnr"]
            pmesh.all_reduce_(self.mesh, grads + parts, "sum")
            for p, g in zip(params, grads):
                p.grad = g
            metrics["psnr"] = -10.0 * torch.log10(torch.clamp(metrics["loss_rgb"], min=1e-10))
        self.opt.step()
        self.global_step += 1
        if loss_sds is not None:
            metrics["loss_sds"] = loss_sds.detach()
            metrics["loss"] = metrics["loss"] + lambdas["lambda_sds"] * metrics["loss_sds"]
        return metrics

    @torch.no_grad()
    def render(self, cameras: GSCameraArrays, timestamps, renderer_cfg=None):
        """Deterministic renders (no draws), each item deformed at its time."""
        ts = torch.as_tensor(np.asarray(timestamps), dtype=torch.float32, device=self.device)
        uniq, inverse = torch.unique(ts, return_inverse=True)
        deformed = self.field.deform_many(self.state, uniq, False)
        return render_batch(self.state, lambda _: tuple(d[inverse] for d in deformed),
                            cameras, ts, renderer_cfg or self.cfg.renderer,
                            do_reconstruction=False)
