"""Gaussian-splat PLY IO, the port of ``animate3d_tpu/gaussians/ply.py``.

Standard 3D-GS vertex layout: x y z nx ny nz f_dc_{0..2} f_rest_{...}
opacity scale_{0..2} rot_{0..3}. ``load_gaussians`` applies the
reference's load-time asset transform: rotate by rot_x then rot_z, scale
positions and linear scales, and rotate every quaternion by the same world
rotation.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from animate3d_tpu_torch.gaussians.state import GaussianState
from animate3d_tpu_torch.utils.rotation import matrix_to_quat_np, quat_to_matrix_np

_PLY_DTYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
}


def read_ply_vertices(path: str) -> Dict[str, np.ndarray]:
    """The 'vertex' element of an ascii or binary_little_endian PLY."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt, elements = None, []
        for line in header:
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append((name, int(count), []))
            elif line.startswith("property"):
                parts = line.split()
                dt = None if parts[1] == "list" else _PLY_DTYPES[parts[1]]
                elements[-1][2].append((parts[-1], dt))
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"Unsupported PLY format {fmt}")
        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if any(dt is None for _, dt in props):
                raise ValueError("List properties unsupported in gaussian PLY reader")
            dtype = np.dtype(props)
            if fmt == "ascii":
                rows = [tuple(float(t) for t in f.readline().split()) for _ in range(count)]
                data = np.array(rows, dtype=dtype)
            else:
                data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
            if name == "vertex":
                out = {p: np.ascontiguousarray(data[p]) for p, _ in props}
        if not out:
            raise ValueError(f"No vertex element found in {path}")
        return out


def write_gaussian_ply(path: str, state: GaussianState) -> None:
    a = lambda t: t.detach().cpu().numpy().astype(np.float32)
    xyz = a(state.xyz)
    n = xyz.shape[0]
    f_dc = a(state.features_dc).reshape(n, -1)
    # reference layout: (N, 3*(K-1)) channel-major
    f_rest = a(state.features_rest).transpose(0, 2, 1).reshape(n, -1)
    props = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"] + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)])
    data = np.concatenate([xyz, np.zeros_like(xyz), f_dc, f_rest, a(state.opacity).reshape(n, 1),
                           a(state.scaling), a(state.rotation)], axis=1)
    rec = np.rec.fromarrays(data.T.astype(np.float32), names=props, formats=["f4"] * len(props))
    with open(path, "wb") as f:
        head = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        head += [f"property float {p}" for p in props] + ["end_header"]
        f.write(("\n".join(head) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def _sorted(v, prefix):
    names = [k for k in v if re.fullmatch(prefix + r"\d+", k)]
    return sorted(names, key=lambda s: int(s.split("_")[-1]))


def read_gaussian_ply(path: str, max_sh_degree: int = 0, device="cpu") -> GaussianState:
    v = read_ply_vertices(path)
    n = v["x"].shape[0]
    f_dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]], axis=1)[:, None, :]
    rest = _sorted(v, "f_rest_")
    if max_sh_degree > 0:
        k_rest = (max_sh_degree + 1) ** 2 - 1
        if len(rest) != 3 * k_rest:
            raise ValueError(f"{path}: {len(rest)} f_rest fields for SH degree {max_sh_degree}")
        f_rest = np.stack([v[k] for k in rest], axis=1).reshape(n, 3, k_rest).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    return GaussianState.from_numpy(
        xyz=np.stack([v["x"], v["y"], v["z"]], axis=1), features_dc=f_dc, features_rest=f_rest,
        opacity=v["opacity"][:, None],
        scaling=np.stack([v[k] for k in _sorted(v, "scale_")], axis=1),
        rotation=np.stack([v[k] for k in _sorted(v, "rot_")], axis=1),
        sh_degree=max_sh_degree, device=device)


def asset_transform_matrix(rot_x_degree: float, rot_z_degree: float) -> np.ndarray:
    """World rotation applied at asset load: Rz @ Rx."""
    tx, tz = np.deg2rad(rot_x_degree), np.deg2rad(rot_z_degree)
    rx = np.array([[1, 0, 0], [0, np.cos(tx), -np.sin(tx)], [0, np.sin(tx), np.cos(tx)]])
    rz = np.array([[np.cos(tz), -np.sin(tz), 0], [np.sin(tz), np.cos(tz), 0], [0, 0, 1]])
    return rz @ rx


def load_gaussians(path: str, rot_x_degree: float = 0.0, rot_z_degree: float = 0.0,
                   scale_factor: float = 1.0, max_sh_degree: int = 0,
                   device="cpu") -> GaussianState:
    """Load and re-pose a gaussian asset (float64 host math, as the JAX package)."""
    state = read_gaussian_ply(path, max_sh_degree=max_sh_degree)
    rot = asset_transform_matrix(rot_x_degree, rot_z_degree)
    xyz = (rot @ state.xyz.numpy().T).T * scale_factor
    scaling = np.log(np.exp(state.scaling.numpy()) * scale_factor)
    rotation = matrix_to_quat_np(rot[None] @ quat_to_matrix_np(state.rotation.numpy()))
    return GaussianState.from_numpy(xyz, state.features_dc, state.features_rest,
                                    state.opacity, scaling, rotation,
                                    sh_degree=max_sh_degree, device=device)
