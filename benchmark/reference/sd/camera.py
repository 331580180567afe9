"""Camera math (host-side NumPy).

The port's own copy of the part of ``animate3d_tpu/utils/camera.py`` the
sampler and the rasterizer need: +z up, OpenGL c2w columns (right, up,
-lookat), the unit-translation-normalised flattened 4x4 c2w as the MV-VDM's
16-d camera input, and the gaussian rasterizer's COLMAP-convention
row-vector view / projection matrices.
"""

from __future__ import annotations

import math

import numpy as np


def spherical_camera_position(elevation_deg, azimuth_deg, distance) -> np.ndarray:
    """Positions on a sphere; elevation from the xy-plane, azimuth about +z."""
    elev = np.deg2rad(np.asarray(elevation_deg, dtype=np.float64))
    azim = np.deg2rad(np.asarray(azimuth_deg, dtype=np.float64))
    dist = np.asarray(distance, dtype=np.float64)
    return np.stack([dist * np.cos(elev) * np.cos(azim),
                     dist * np.cos(elev) * np.sin(azim),
                     dist * np.sin(elev)], axis=-1)


def look_at_c2w(camera_position: np.ndarray, center=None, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Batched look-at c2w (..., 4, 4) towards ``center`` (default the
    origin), OpenGL column convention."""
    pos = np.asarray(camera_position, dtype=np.float64)
    if center is None:
        center = np.zeros_like(pos)
    up_v = np.broadcast_to(np.asarray(up, dtype=np.float64), pos.shape)

    def _norm(v):
        return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-12)

    lookat = _norm(center - pos)
    right = _norm(np.cross(lookat, up_v))
    up_o = _norm(np.cross(right, lookat))
    c2w = np.zeros(pos.shape[:-1] + (4, 4), dtype=np.float64)
    c2w[..., :3, :3] = np.stack([right, up_o, -lookat], axis=-1)
    c2w[..., :3, 3] = pos
    c2w[..., 3, 3] = 1.0
    return c2w


def normalize_c2w(c2w: np.ndarray) -> np.ndarray:
    """Move the camera location onto the unit sphere."""
    c2w = np.array(c2w, dtype=np.float64).reshape(-1, 4, 4)
    t = c2w[:, :3, 3]
    c2w[:, :3, 3] = t / (np.linalg.norm(t, axis=1, keepdims=True) + 1e-8)
    return c2w


def get_camera(num_views: int, elevation: float = 15.0,
               azimuth_start: float = 0.0, azimuth_span: float = 360.0) -> np.ndarray:
    """(num_views, 16) float32 flattened unit-translation orbit c2w."""
    gap = azimuth_span / num_views
    azimuths = np.arange(azimuth_start, azimuth_span + azimuth_start, gap)[:num_views]
    mats = [normalize_c2w(look_at_c2w(np.atleast_2d(
        spherical_camera_position(elevation, float(a), 1.0)))).reshape(16)
        for a in azimuths]
    return np.stack(mats, axis=0).astype(np.float32)


def convert_pose(c2w: np.ndarray) -> np.ndarray:
    """OpenGL → COLMAP camera axes: flip y and z."""
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    return np.asarray(c2w, dtype=np.float64) @ flip


def gs_projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """The gaussian-splatting projection matrix (column convention)."""
    top, right = math.tan(fovy / 2) * znear, math.tan(fovx / 2) * znear
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def gs_camera_info(c2w: np.ndarray, fovx: float, fovy: float, znear: float = 0.1,
                   zfar: float = 100.0):
    """The rasterizer's (world_view, full_proj, camera_center), float32, in
    the reference's row-vector layout: ``x_view = x_world @ world_view``."""
    world_view = np.linalg.inv(convert_pose(c2w)).T
    full_proj = world_view @ gs_projection_matrix(znear, zfar, fovx, fovy).T
    camera_center = np.linalg.inv(world_view)[3, :3]
    return (world_view.astype(np.float32), full_proj.astype(np.float32),
            camera_center.astype(np.float32))
