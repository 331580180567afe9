"""Camera batches (host-side NumPy): the port of
``animate3d_tpu/data/cameras.py``.

``fixed_view_cameras`` is the multi-image dataset's 4 training views x F
frames (elevation 15°, azimuths 0/90/180/270, distance 3, fovy 40°),
view-major, with ``timestamps = linspace(-1, 1, F)`` per view. The
evaluation batches: :func:`val_orbit_cameras` (the ``--validate`` orbit
video) and :func:`testset_grid_cameras` (the ``testset`` metrics grid).
:func:`gs_cameras_from_batch` turns a batch into the rasterizer's stacked
camera tensors. :class:`HybridRandomCameraSampler` is the refine stage's
random 4-view x F-frame SDS batch, drawn from ``np.random.default_rng(seed)``
in the JAX sampler's order, so one seed gives the same cameras in both
packages. The batch holds what the rasterizer and the losses read; the
reference's rays and MVP matrices, which nothing in either package's 4D
stage reads, are not built.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from animate3d_tpu_torch.core.registry import register
from animate3d_tpu_torch.ops.rasterize import GSCameraArrays
from animate3d_tpu_torch.utils import camera as camu


@dataclass
class RandomCameraConfig:
    batch_size: int = 64
    n_view: int = 4
    total_frame: int = 16
    width: int = 256
    height: int = 256
    eval_width: int = 512
    eval_height: int = 512
    elevation_range: Tuple[float, float] = (0.0, 30.0)
    azimuth_range: Tuple[float, float] = (-180.0, 180.0)
    camera_distance_range: Tuple[float, float] = (0.8, 1.0)  # relative
    fovy_range: Tuple[float, float] = (15.0, 60.0)
    zoom_range: Tuple[float, float] = (1.0, 1.0)
    relative_radius: bool = True
    camera_perturb: float = 0.0
    center_perturb: float = 0.0
    up_perturb: float = 0.0
    light_distance_range: Tuple[float, float] = (7.5, 10.0)
    eval_elevation_deg: float = 15.0
    eval_camera_distance: float = 3.0
    eval_fovy_deg: float = 40.0
    n_val_views: int = 128
    n_test_views: int = 120
    progressive_until: int = 0
    rays_d_normalize: bool = True


def _camera_batch(c2w, fovy_deg, height, width, timestamps, elevation_deg, azimuth_deg,
                  camera_distances) -> Dict[str, np.ndarray]:
    return {
        "c2w": c2w.astype(np.float32),
        "fovy": np.deg2rad(fovy_deg).astype(np.float32),
        "camera_positions": c2w[:, :3, 3].astype(np.float32),
        "elevation": elevation_deg.astype(np.float32),
        "azimuth": azimuth_deg.astype(np.float32),
        "camera_distances": camera_distances.astype(np.float32),
        "timestamps": timestamps.astype(np.float32),
        "height": height,
        "width": width,
    }


@register("hybrid-random-camera-datamodule")
class HybridRandomCameraSampler:
    """Random n_view x F-frame camera batches for SDS: each item's views
    cover the azimuth range evenly from a shared random offset, the
    elevation is uniform in angle or on the sphere (50/50), fovy, distance
    (relative to the fovy) and zoom from their ranges; timestamps
    ``linspace(-1, 1, F)`` per view."""

    def __init__(self, cfg: RandomCameraConfig, seed: int = 0):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.elevation_range = list(cfg.elevation_range)
        self.azimuth_range = list(cfg.azimuth_range)

    def update_step(self, global_step: int) -> None:
        """Progressive view widening from the eval elevation / azimuth 0."""
        cfg = self.cfg
        r = min(1.0, global_step / (cfg.progressive_until + 1))
        self.elevation_range = [
            (1 - r) * cfg.eval_elevation_deg + r * cfg.elevation_range[0],
            (1 - r) * cfg.eval_elevation_deg + r * cfg.elevation_range[1]]
        self.azimuth_range = [r * cfg.azimuth_range[0], r * cfg.azimuth_range[1]]

    def sample(self) -> Dict[str, np.ndarray]:
        cfg, rng = self.cfg, self.rng
        nv, nf = cfg.n_view, cfg.total_frame
        nvf = nv * nf
        if cfg.batch_size % nvf:
            raise ValueError(f"random_camera.batch_size {cfg.batch_size} is not a multiple "
                             f"of n_view x total_frame = {nvf}")
        rb = cfg.batch_size // nvf
        if rng.random() < 0.5:
            elev_deg = rng.uniform(*self.elevation_range, size=rb)
        else:
            lo, hi = np.deg2rad(self.elevation_range)
            elev_deg = np.rad2deg(np.arcsin(rng.uniform(np.sin(lo), np.sin(hi), size=rb)))
        elev_deg = np.repeat(elev_deg, nvf)
        az_span = self.azimuth_range[1] - self.azimuth_range[0]
        azim_deg = ((rng.random(rb)[:, None] + np.arange(nv)[None, :]) / nv * az_span
                    + self.azimuth_range[0]).reshape(-1)
        azim_deg = np.repeat(azim_deg, nf)
        fovy_deg = np.repeat(rng.uniform(*cfg.fovy_range, size=rb), nvf)
        dist = np.repeat(rng.uniform(*cfg.camera_distance_range, size=rb), nvf)
        if cfg.relative_radius:
            dist = dist / np.tan(0.5 * np.deg2rad(fovy_deg))
        zoom = np.repeat(rng.uniform(*cfg.zoom_range, size=rb), nvf)
        fovy_deg = fovy_deg * zoom
        pos = camu.spherical_camera_position(elev_deg, azim_deg, dist)
        pos = pos + rng.uniform(-cfg.camera_perturb, cfg.camera_perturb, size=pos.shape)
        center = rng.normal(0, cfg.center_perturb, size=pos.shape) \
            if cfg.center_perturb > 0 else np.zeros_like(pos)
        up = np.array([0.0, 0.0, 1.0]) + (
            rng.normal(0, cfg.up_perturb, size=3) if cfg.up_perturb > 0 else 0.0)
        c2w = camu.look_at_c2w(pos, center=center, up=tuple(up))
        timestamps = np.tile(np.linspace(-1.0, 1.0, nf), rb * nv)
        return _camera_batch(c2w, fovy_deg, cfg.height, cfg.width, timestamps, elev_deg,
                             azim_deg, dist)


def fixed_view_cameras(elevation_deg: float = 15.0,
                       azimuths_deg: Tuple[float, ...] = (0.0, 90.0, 180.0, 270.0),
                       distance: float = 3.0, fovy_deg: float = 40.0, height: int = 256,
                       width: int = 256, total_frame: int = 16) -> Dict[str, np.ndarray]:
    """The fixed training views x F frames, view-major."""
    nv = len(azimuths_deg)
    return _view_major(np.full(nv, elevation_deg), np.asarray(azimuths_deg, np.float64),
                       distance, fovy_deg, height, width, total_frame)


def val_orbit_cameras(n_views: int = 120, elevation_deg: float = 15.0, distance: float = 3.0,
                      fovy_deg: float = 40.0, height: int = 512, width: int = 512,
                      total_frame: int = 16) -> Dict[str, np.ndarray]:
    """The validation orbit video: the azimuth sweeps 0 → 360° over
    ``n_views`` frames while the animation time cycles through the F
    frames in lockstep."""
    azim = np.linspace(0.0, 360.0, n_views, endpoint=False)
    elev = np.full(n_views, elevation_deg)
    dist = np.full(n_views, distance)
    c2w = camu.look_at_c2w(camu.spherical_camera_position(elev, azim, dist))
    timestamps = np.linspace(-1.0, 1.0, total_frame)[np.arange(n_views) % total_frame]
    return _camera_batch(c2w, np.full(n_views, fovy_deg), height, width, timestamps, elev, azim,
                         dist)


def testset_grid_cameras(elevations_deg: Tuple[float, ...] = (15.0, 0.0, 30.0),
                         azimuth_sets_deg: Tuple[Tuple[float, ...], ...] = (
                             (0.0, 90.0, 180.0, 270.0), (30.0, 120.0, 210.0, 300.0),
                             (-45.0, 45.0, 135.0, 225.0)),
                         distance: float = 3.0, fovy_deg: float = 40.0, height: int = 512,
                         width: int = 512, total_frame: int = 16) -> Dict[str, np.ndarray]:
    """The 3-elevation x 4-azimuth evaluation grid (the paper-metrics
    surface), view-major x F frames: each elevation is paired with its own
    azimuth set, not a Cartesian product."""
    if len(azimuth_sets_deg) != len(elevations_deg):
        raise ValueError(
            f"eval_azimuth_deg needs one azimuth set per elevation "
            f"({len(elevations_deg)} elevations, {len(azimuth_sets_deg)} sets)")
    views = [(e, a) for e, az in zip(elevations_deg, azimuth_sets_deg) for a in az]
    return _view_major(np.asarray([v[0] for v in views], np.float64),
                       np.asarray([v[1] for v in views], np.float64), distance, fovy_deg,
                       height, width, total_frame)


def _view_major(elev1, azim1, distance, fovy_deg, height, width, total_frame):
    """Views (elevation, azimuth) x F frames, view-major, timestamps
    linspace(-1, 1, F) per view."""
    nv = len(azim1)
    elev = np.repeat(elev1, total_frame)
    azim = np.repeat(azim1, total_frame)
    dist = np.full(nv * total_frame, distance)
    c2w = camu.look_at_c2w(camu.spherical_camera_position(elev, azim, dist))
    timestamps = np.tile(np.linspace(-1.0, 1.0, total_frame), nv)
    return _camera_batch(c2w, np.full(nv * total_frame, fovy_deg), height, width, timestamps,
                         elev, azim, dist)


def gs_cameras_from_batch(batch: Dict[str, np.ndarray], znear: float = 0.1,
                          zfar: float = 100.0, device="cpu") -> GSCameraArrays:
    """Batch → stacked rasterizer cameras (B leading) on ``device``."""
    h, w = batch["height"], batch["width"]
    wvs, fps, ccs, tfx, tfy = [], [], [], [], []
    for c2w, fy in zip(batch["c2w"], batch["fovy"]):
        fy = float(fy)
        fx = 2.0 * math.atan(math.tan(0.5 * fy) * (w / h))
        wv, fp, cc = camu.gs_camera_info(c2w, fx, fy, znear, zfar)
        wvs.append(wv)
        fps.append(fp)
        ccs.append(cc)
        tfx.append(math.tan(0.5 * fx))
        tfy.append(math.tan(0.5 * fy))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return GSCameraArrays(world_view=t(np.stack(wvs)), full_proj=t(np.stack(fps)),
                          camera_center=t(np.stack(ccs)), tanfovx=t(tfx), tanfovy=t(tfy))
