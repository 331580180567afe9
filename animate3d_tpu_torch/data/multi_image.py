"""Tracked multi-view video frames → the recon batch: the port of
``animate3d_tpu/data/multi_image.py``.

A flat directory of RGBA frames numbered ``view·F + frame``, sorted
numerically; the fixed training cameras; one whole-video batch with rgb
(N·F, H, W, 3), a bool mask (N·F, H, W, 1), cameras and timestamps; with
``use_random_camera`` (refine), ``batch(step)`` also holds the SDS batch of
the random-camera sampler under ``random_camera``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

from animate3d_tpu_torch.core.registry import register
from animate3d_tpu_torch.data.cameras import (
    HybridRandomCameraSampler,
    RandomCameraConfig,
    fixed_view_cameras,
)


@dataclass
class MultiImageConfig:
    image_root: str = ""
    height: int = 256
    width: int = 256
    default_elevation_deg: float = 15.0
    default_azimuth_deg: Tuple[float, ...] = (0.0, 90.0, 180.0, 270.0)
    default_camera_distance: float = 3.0
    default_fovy_deg: float = 40.0
    n_view: int = 4
    total_frame: int = 16
    use_random_camera: bool = False
    rays_d_normalize: bool = False
    random_camera: RandomCameraConfig = field(default_factory=RandomCameraConfig)


def load_rgba_frames(image_root: str, height: int, width: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Numerically sorted RGBA frames → (rgb (B, H, W, 3) f32, mask (B, H, W, 1) bool)."""
    from PIL import Image

    names = [n for n in os.listdir(image_root) if n.lower().endswith((".png", ".jpg", ".webp"))]
    names.sort(key=lambda x: int(os.path.splitext(x)[0]))
    rgbs, masks = [], []
    for name in names:
        img = Image.open(os.path.join(image_root, name)).convert("RGBA")
        if img.size != (width, height):
            img = img.resize((width, height), Image.LANCZOS)
        rgba = np.asarray(img, dtype=np.float32) / 255.0
        rgbs.append(rgba[..., :3])
        masks.append(rgba[..., 3:] > 0.5)
    return np.stack(rgbs), np.stack(masks)


@register("simple-multi-image-datamodule")
class MultiImageDataset:
    """The fixed whole-video batch, and per step the random-camera batch."""

    @classmethod
    def from_config(cls, data_cfg, seed: int = 0):
        from animate3d_tpu_torch.core.config import parse_structured

        d = {k: v for k, v in dict(data_cfg).items() if k in MultiImageConfig.__dataclass_fields__}
        rc = d.get("random_camera")
        if isinstance(rc, dict):
            d["random_camera"] = parse_structured(RandomCameraConfig, {
                k: v for k, v in rc.items() if k in RandomCameraConfig.__dataclass_fields__})
        return cls(parse_structured(MultiImageConfig, d), seed=seed)

    def __init__(self, cfg: MultiImageConfig, seed: int = 0):
        self.cfg = cfg
        self.cameras = fixed_view_cameras(
            elevation_deg=cfg.default_elevation_deg, azimuths_deg=tuple(cfg.default_azimuth_deg),
            distance=cfg.default_camera_distance, fovy_deg=cfg.default_fovy_deg,
            height=cfg.height, width=cfg.width, total_frame=cfg.total_frame)
        self.rgbs, self.masks = load_rgba_frames(cfg.image_root, cfg.height, cfg.width)
        expected = cfg.n_view * cfg.total_frame
        if self.rgbs.shape[0] != expected:
            raise ValueError(f"expected {expected} frames (view-major) in {cfg.image_root}, "
                             f"got {self.rgbs.shape[0]}")
        self.random_sampler = (HybridRandomCameraSampler(cfg.random_camera, seed=seed)
                               if cfg.use_random_camera else None)

    def batch(self, global_step: int = 0) -> Dict[str, np.ndarray]:
        out = dict(self.cameras)
        out["rgb"] = self.rgbs
        out["mask"] = self.masks
        if self.random_sampler is not None:
            self.random_sampler.update_step(global_step)
            out["random_camera"] = self.random_sampler.sample()
        return out
