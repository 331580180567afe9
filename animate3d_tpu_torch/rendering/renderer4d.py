"""4D gaussian batch renderer, deform → rasterize over view·frame items: the
port of ``animate3d_tpu/rendering/renderer4d.py``.

  * timestamp -1 renders the static (undeformed) asset unless
    ``first_frame_trainable``;
  * reconstruction applies a per-gaussian straight-through gradient mask
    (``v*m + v.detach()*(1-m)``, m ~ Bernoulli(``straight_through_prob``)
    per item) to means, scales and rotations;
  * the RGB is clipped to [0, 1]; the deformed means / rotations / scales
    come back per item for ARAP and trajectory export.

The items are one batch dimension of the rasterizer, so one launch of
kernel H (or G, at 64² and below) per direction covers every render of the
call, up to ``_PLANE_ELEMS`` of composited planes per launch: all 64
renders of a recon step at 256², and of the four-view test at 512²; 32
renders a launch at 1024². The draws (the masks and
the background inversion) come from ``generator``, or are given in
``draws`` (the tests feed the JAX package's); with neither, nothing is
drawn, as the JAX renderer without a key.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from animate3d_tpu_torch.gaussians.state import GaussianState
from animate3d_tpu_torch.ops.rasterize import GSCameraArrays, RasterConfig, rasterize
from animate3d_tpu_torch.utils import trace

_PLANE_ELEMS = 1 << 28  # f32 plane elements per rasterize call (1 GiB)


@dataclass(frozen=True)
class Renderer4DConfig:
    height: int = 256
    width: int = 256
    back_ground_color: tuple = (1.0, 1.0, 1.0)
    invert_bg_prob: float = 1.0  # P(keep bg), the reference's semantics
    first_frame_trainable: bool = False
    straight_through_prob: float = 0.1

    def raster_config(self) -> RasterConfig:
        return RasterConfig(height=self.height, width=self.width)


class RenderDraws(NamedTuple):
    """The renderer's random draws for one call: ``st_mask`` (B, N, 1) in
    {0, 1}; ``bg_uniform`` a scalar U(0, 1) (background inverted when it
    exceeds ``invert_bg_prob``)."""

    st_mask: torch.Tensor
    bg_uniform: Optional[torch.Tensor] = None


class Render4DOutput(NamedTuple):
    rgb: torch.Tensor  # (B, H, W, 3)
    depth: torch.Tensor  # (B, H, W)
    alpha: torch.Tensor  # (B, H, W)
    means3d: torch.Tensor  # (B, N, 3) deformed positions
    rotations: torch.Tensor  # (B, N, 4)
    scales: torch.Tensor  # (B, N, 3)
    overflow: torch.Tensor  # () gaussian x tile pairs past the binning's caps


def make_draws(cfg: Renderer4DConfig, b: int, n: int, generator: torch.Generator,
               device) -> RenderDraws:
    u = torch.rand((b, n, 1), generator=generator, device=generator.device)
    st = (u < cfg.straight_through_prob).float().to(device)
    return RenderDraws(st, torch.rand((), generator=generator, device=generator.device))


@trace.spanned("renderer4d.render_batch")
def render_batch(state: GaussianState, deform_fn: Optional[Callable],
                 cameras: GSCameraArrays, timestamps: torch.Tensor, cfg: Renderer4DConfig,
                 draws: Optional[RenderDraws] = None,
                 generator: Optional[torch.Generator] = None,
                 do_reconstruction: bool = True) -> Render4DOutput:
    """Render B = len(timestamps) items. ``deform_fn(timestamps)`` →
    (means (B, N, 3), normalised rotations (B, N, 4), linear scales (B, N, 3))."""
    b, n = timestamps.shape[0], state.num_points
    dev = state.xyz.device
    raster_cfg = cfg.raster_config()
    opacity = state.get_opacity().reshape(-1)
    shs = state.get_features()
    bg_color = torch.tensor(cfg.back_ground_color, dtype=torch.float32, device=dev)
    if draws is None and generator is not None and do_reconstruction:
        draws = make_draws(cfg, b, n, generator, dev)
    if draws is not None and do_reconstruction and cfg.invert_bg_prob < 1.0:
        # invert when u > invert_bg_prob (prob 1.0: never)
        bg_color = torch.where(draws.bg_uniform.to(dev) > cfg.invert_bg_prob,
                               1.0 - bg_color, bg_color)

    static_scales = state.get_scaling().expand(b, n, 3)
    static_rot = state.get_rotation().expand(b, n, 4)
    static_xyz = state.xyz.expand(b, n, 3)
    if deform_fn is not None:
        xyz_d, rot_d, scales_d = deform_fn(timestamps)
        is_static = ((timestamps == -1.0) & (not cfg.first_frame_trainable))[:, None, None]
        xyz = torch.where(is_static, static_xyz, xyz_d)
        rot = torch.where(is_static, static_rot, rot_d)
        scales = torch.where(is_static, static_scales, scales_d)
    else:
        xyz, rot, scales = static_xyz, static_rot, static_scales

    if draws is not None and do_reconstruction:
        m = draws.st_mask
        st = lambda v: v * m + v.detach() * (1 - m)
        xyz_in, scales_in, rot_in = st(xyz), st(scales), st(rot)
    else:
        xyz_in, scales_in, rot_in = xyz, scales, rot
    if not do_reconstruction:
        xyz_in = xyz_in.detach()

    per_view = raster_cfg.tiles_x * raster_cfg.tiles_y * 8 * raster_cfg.tile ** 2
    step = max(1, _PLANE_ELEMS // per_view)
    outs = [rasterize(xyz_in[v0:v0 + step], scales_in[v0:v0 + step], rot_in[v0:v0 + step],
                      opacity, cameras.index(slice(v0, v0 + step)), raster_cfg, shs=shs,
                      bg=bg_color, active_sh_degree=state.active_sh_degree)
            for v0 in range(0, b, step)]
    cat = lambda i: torch.cat([o[i] for o in outs])
    return Render4DOutput(rgb=torch.clamp(cat(0), 0.0, 1.0), depth=cat(1), alpha=cat(2),
                          means3d=xyz, rotations=rot, scales=scales,
                          overflow=sum(o.overflow for o in outs))
