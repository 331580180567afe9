"""The stage-1 recon step as plain code: the port's
``systems/animate3d.py`` (``frame_weights`` and ``step_batch`` of the
'normal' strategy with frame bucketing, ``loss`` without guidance or dp,
``step``) and its ``DeformAdam`` with constant learning rates, written out
again over the frozen copies beside this file."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from . import arap
from .deform import DeformationField, DeformConfig
from .rasterize import GSCameraArrays
from .renderer4d import RenderDraws, Renderer4DConfig, render_batch
from .state import GaussianState

GROUPS = (("grid_", "grid_lr"), ("delta_xyz", "delta_xyz_network_lr"),
          ("delta_rot", "delta_rot_network_lr"),
          ("delta_scaling", "delta_scaling_network_lr"), ("global_", "global_trans_lr"))


def lr_of(name: str, cfg: dict) -> float:
    for prefix, key in GROUPS:
        if name.startswith(prefix):
            return float(np.float32(cfg[key]))
    return float(np.float32(cfg["grid_lr"]))


def deform_config(cfg: dict) -> DeformConfig:
    return DeformConfig(grid_sizes=tuple(tuple(g) for g in cfg["grid_size"]),
                        grid_feature_dim=cfg["n_grid_dims"], mlp_width=cfg["mlp_width"],
                        use_global_trans=cfg["use_global_trans"])


def renderer_config(cfg: dict) -> Renderer4DConfig:
    r = cfg["renderer"]
    return Renderer4DConfig(height=cfg["size"], width=cfg["size"],
                            back_ground_color=tuple(r["back_ground_color"]),
                            invert_bg_prob=r["invert_bg_prob"],
                            first_frame_trainable=r["first_frame_trainable"],
                            straight_through_prob=r["straight_through_prob"])


class Draws(NamedTuple):
    st_mask: torch.Tensor  # (B, N, 1)
    bg_uniform: torch.Tensor  # ()
    arap_idx: torch.Tensor  # (S,)
    guidance: Optional[dict] = None  # the SDS batch: cameras, timestamps, c2w
    sds: Optional[object] = None  # its draws (sds.SDSDraws)


class Recon:
    """The deformation field over a frozen asset, its Adam state, and the
    whole-video batch."""

    def __init__(self, cfg: dict, state: GaussianState, field_weights: Dict[str, torch.Tensor],
                 cameras: GSCameraArrays, timestamps: np.ndarray, rgb: torch.Tensor,
                 mask: torch.Tensor):
        self.cfg, self.state = cfg, state
        dev = state.xyz.device
        self.field = DeformationField(deform_config(cfg)).to(dev)
        self.field.load_state_dict(field_weights)
        self.params = dict(self.field.named_parameters())
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.count = 0
        loss = cfg["loss"]
        self.connectivity = arap.connectivity_from_points(
            state.xyz[None], radius=loss["arap_radius"], K=loss["arap_K"])
        self.rcfg = renderer_config(cfg)
        self.cameras, self.timestamps, self.rgb, self.mask = cameras, timestamps, rgb, mask
        self.sds = None  # the 4D-SDS term (sds.SDS) of a refine step
        # a planted fault, for reading what it does to the check's numbers:
        # "half_batch" (the second half of the items left out, the mean over
        # the rest) or "altered" (the renders dimmed by 2% where produced)
        self.fault: Optional[str] = None

    def frame_weights(self, step: int) -> np.ndarray:
        f = self.cfg["n_frame"]
        start = min(step // self.cfg["progressive_iter_per_frame"], f - 2)
        w = np.zeros((f,), np.float32)
        w[1:start + 2] = 1.0
        return w

    def items(self, step: int):
        """(item indices, per-frame weights) of the step: the unlocked
        frames padded to a power-of-two bucket with the last one at weight
        0, or every frame past half the video."""
        f, nv = self.cfg["n_frame"], self.cfg["n_view"]
        w = self.frame_weights(step)
        active = np.nonzero(w)[0]
        bucket = 2
        while bucket < len(active):
            bucket *= 2
        if bucket > f // 2:
            return np.arange(nv * f), w
        frames = np.concatenate([active, np.full(bucket - len(active), active[-1])])
        idx = np.concatenate([v * f + frames for v in range(nv)])
        return idx, np.concatenate([w[active], np.zeros(bucket - len(active), np.float32)])

    def loss(self, step: int, draws: Draws) -> torch.Tensor:
        cfg, lc = self.cfg, self.cfg["loss"]
        dev = self.state.xyz.device
        idx, frame_w = self.items(step)
        it = torch.as_tensor(idx, device=dev)
        cams = GSCameraArrays(*(t[it] for t in self.cameras))
        ts = torch.as_tensor(self.timestamps[idx], device=dev)
        gt_rgb, gt_mask = self.rgb[it], self.mask[it].float()
        frame_w = torch.as_tensor(frame_w, device=dev)
        n_active = ts.shape[0] // cfg["n_view"]
        frame_ts = ts[:n_active]
        deformed = self.field.deform_frames(self.state, frame_ts, False)

        def frame_index(t):
            return torch.argmin(torch.abs(frame_ts[None, :] - t[:, None]), dim=1)

        def deform_fn(t):
            fi = frame_index(t)
            return tuple(d[fi] for d in deformed)

        out = render_batch(self.state, deform_fn, cams, ts, self.rcfg,
                           draws=RenderDraws(draws.st_mask, draws.bg_uniform))
        item_w = frame_w.repeat(cfg["n_view"])
        if self.fault == "half_batch":
            item_w = torch.cat([item_w[:len(item_w) // 2], 0.0 * item_w[len(item_w) // 2:]])
        elif self.fault == "altered":
            out = out._replace(rgb=out.rgb * 0.98)
        wsum = torch.clamp(item_w.sum(), min=1e-8)
        bgc = torch.tensor(self.rcfg.back_ground_color, dtype=torch.float32, device=dev)
        gt = gt_rgb * gt_mask + bgc * (1.0 - gt_mask)
        loss_rgb = (((gt - out.rgb) ** 2).mean(dim=(1, 2, 3)) * item_w).sum() / wsum
        loss_mask = (((gt_mask[..., 0] - out.alpha) ** 2).mean(dim=(1, 2)) * item_w).sum() / wsum
        loss = lc["lambda_rgb"] * loss_rgb + lc["lambda_mask"] * loss_mask
        if lc["lambda_arap"] > 0:
            static = (frame_ts == -1.0) & (not self.rcfg.first_frame_trainable)
            means = torch.where(static[:, None, None], self.state.xyz[None],
                                deformed[0][frame_index(frame_ts)])
            nodes = torch.cat([self.state.xyz[None], means], dim=0)
            loss = loss + lc["lambda_arap"] * arap.arap_error(
                nodes, self.connectivity, sample_idx=draws.arap_idx,
                sample_num=lc["arap_sample_num"], frame_weights=frame_w)
        if self.sds is not None:
            rgb = self.sds.render(self.field, self.state, draws.guidance, self.rcfg)
            loss = loss + lc["lambda_sds"] * self.sds.loss(rgb, draws.guidance["c2w"], draws.sds)
        return loss

    def step(self, step: int, draws: Draws):
        """(loss, {leaf: gradient}) of one step, then the Adam update
        (moments, bias correction in float32, eps 1e-15)."""
        for p in self.params.values():
            p.grad = None
        loss = self.loss(step, draws)
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
                 for k, p in self.params.items()}
        count = self.count + 1
        b1, b2, eps = 0.9, 0.999, 1e-15
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        bc1, bc2 = float(1 - f32(b1) ** count), float(1 - f32(b2) ** count)
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k]
                self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
                self.nu[k] = (1 - b2) * (g * g) + b2 * self.nu[k]
                p.add_(-lr_of(k, self.cfg) * (self.mu[k] / bc1)
                       / (torch.sqrt(self.nu[k] / bc2) + eps))
        self.count = count
        return loss.detach(), grads

    @torch.no_grad()
    def render_all(self, field: Optional[DeformationField] = None) -> torch.Tensor:
        """Every item of the video through ``field`` (default: this one),
        no draws: (rgb (B, H, W, 3), alpha (B, H, W))."""
        field = field or self.field
        dev = self.state.xyz.device
        ts = torch.as_tensor(self.timestamps, device=dev)
        uniq, inverse = torch.unique(ts, return_inverse=True)
        deformed = field.deform_many(self.state, uniq, False)
        out = render_batch(self.state, lambda _: tuple(d[inverse] for d in deformed),
                           self.cameras, ts, self.rcfg, do_reconstruction=False)
        return out.rgb, out.alpha
