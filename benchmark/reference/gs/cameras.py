"""The fixed training cameras (views x frames, view-major) and the
rasterizer's camera tensors (the port's ``data/cameras.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.sd import camera as camu

from .rasterize import GSCameraArrays


def view_major(elevation_deg: float, azimuths_deg, distance: float, fovy_deg: float,
               total_frame: int):
    """(c2w (V·F, 4, 4), fovy radians (V·F,), timestamps (V·F,)): views x F
    frames, view-major, timestamps linspace(-1, 1, F) per view."""
    nv = len(azimuths_deg)
    elev = np.repeat(np.full(nv, elevation_deg, np.float64), total_frame)
    azim = np.repeat(np.asarray(azimuths_deg, np.float64), total_frame)
    dist = np.full(nv * total_frame, distance)
    c2w = camu.look_at_c2w(camu.spherical_camera_position(elev, azim, dist))
    ts = np.tile(np.linspace(-1.0, 1.0, total_frame), nv)
    return (c2w.astype(np.float32), np.deg2rad(np.full(nv * total_frame, fovy_deg)).astype(
        np.float32), ts.astype(np.float32))


def gs_cameras(c2ws, fovys, height: int, width: int, device, znear: float = 0.1,
               zfar: float = 100.0) -> GSCameraArrays:
    wvs, fps, ccs, tfx, tfy = [], [], [], [], []
    for c2w, fy in zip(c2ws, fovys):
        fy = float(fy)
        fx = 2.0 * math.atan(math.tan(0.5 * fy) * (width / height))
        wv, fp, cc = camu.gs_camera_info(c2w, fx, fy, znear, zfar)
        wvs.append(wv)
        fps.append(fp)
        ccs.append(cc)
        tfx.append(math.tan(0.5 * fx))
        tfy.append(math.tan(0.5 * fy))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return GSCameraArrays(world_view=t(np.stack(wvs)), full_proj=t(np.stack(fps)),
                          camera_center=t(np.stack(ccs)), tanfovx=t(tfx), tanfovy=t(tfy))


def random_cameras(rc: dict, rng: np.random.Generator, step: int) -> dict:
    """One SDS batch of random cameras (the port's
    ``HybridRandomCameraSampler`` after ``update_step(step)``, no
    perturbations): ``batch_size / (n_view·total_frame)`` videos, each
    with n_view views evenly around a random azimuth offset, elevation
    uniform in angle or on the sphere (50/50), fovy and relative distance
    from their ranges; timestamps linspace(-1, 1, F) per view."""
    nv, nf = rc["n_view"], rc["total_frame"]
    nvf = nv * nf
    rb = rc["batch_size"] // nvf
    r = min(1.0, step / (rc["progressive_until"] + 1))
    er = [(1 - r) * rc["eval_elevation_deg"] + r * rc["elevation_range"][0],
          (1 - r) * rc["eval_elevation_deg"] + r * rc["elevation_range"][1]]
    ar = [r * rc["azimuth_range"][0], r * rc["azimuth_range"][1]]
    if rng.random() < 0.5:
        elev = rng.uniform(*er, size=rb)
    else:
        lo, hi = np.deg2rad(er)
        elev = np.rad2deg(np.arcsin(rng.uniform(np.sin(lo), np.sin(hi), size=rb)))
    elev = np.repeat(elev, nvf)
    azim = ((rng.random(rb)[:, None] + np.arange(nv)[None, :]) / nv * (ar[1] - ar[0])
            + ar[0]).reshape(-1)
    azim = np.repeat(azim, nf)
    fovy = np.repeat(rng.uniform(*rc["fovy_range"], size=rb), nvf)
    dist = np.repeat(rng.uniform(*rc["camera_distance_range"], size=rb), nvf)
    dist = dist / np.tan(0.5 * np.deg2rad(fovy))
    c2w = camu.look_at_c2w(camu.spherical_camera_position(elev, azim, dist),
                           center=np.zeros((len(elev), 3)))
    return {"c2w": c2w.astype(np.float32), "fovy": np.deg2rad(fovy).astype(np.float32),
            "camera_positions": c2w[:, :3, 3].astype(np.float32),
            "elevation": elev.astype(np.float32), "azimuth": azim.astype(np.float32),
            "camera_distances": dist.astype(np.float32),
            "timestamps": np.tile(np.linspace(-1.0, 1.0, nf), rb * nv).astype(np.float32),
            "height": rc["height"], "width": rc["width"]}
