"""OBJ / MTL mesh loading and mesh → point utilities (NumPy + PIL).

The port's own copy of ``animate3d_tpu/utils/mesh.py``: host geometry of
the mesh-animation flow, read once per asset, so it stays NumPy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class Mesh:
    verts: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (F, 3) int32 vertex indices
    uvs: Optional[np.ndarray] = None  # (T, 2) float32
    face_uvs: Optional[np.ndarray] = None  # (F, 3) int32 uv indices
    vert_colors: Optional[np.ndarray] = None  # (V, 3) float32 in [0, 1]
    texture: Optional[np.ndarray] = None  # (H, W, 3) float32 in [0, 1]


def _load_mtl_textures(mtl_path: str) -> Dict[str, str]:
    """material name → diffuse texture path (``map_Kd``)."""
    textures: Dict[str, str] = {}
    if not os.path.exists(mtl_path):
        return textures
    current = None
    base = os.path.dirname(mtl_path)
    with open(mtl_path) as fh:
        for line in fh:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "newmtl":
                current = tok[1]
            elif tok[0] == "map_Kd" and current is not None:
                textures[current] = os.path.join(base, tok[-1])
    return textures


def load_obj(path: str) -> Mesh:
    """An OBJ with its MTL texture lookup: ``v`` (with the per-vertex colour
    extension), ``vt``, ``f`` (polygons fan-triangulated), ``mtllib`` and
    ``usemtl`` (the last used material's ``map_Kd``, else the first)."""
    verts, uvs, faces, face_uvs, vcolors = [], [], [], [], []
    mtl_textures: Dict[str, str] = {}
    active_texture_path: Optional[str] = None
    base = os.path.dirname(path)
    with open(path) as fh:
        for line in fh:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append([float(x) for x in tok[1:4]])
                if len(tok) >= 7:
                    vcolors.append([float(x) for x in tok[4:7]])
            elif tok[0] == "vt":
                uvs.append([float(tok[1]), float(tok[2])])
            elif tok[0] == "mtllib":
                mtl_textures.update(_load_mtl_textures(os.path.join(base, tok[1])))
            elif tok[0] == "usemtl":
                active_texture_path = mtl_textures.get(tok[1], active_texture_path)
            elif tok[0] == "f":
                idx = [t.split("/") for t in tok[1:]]
                for i in range(1, len(idx) - 1):
                    tri = [idx[0], idx[i], idx[i + 1]]
                    faces.append([int(t[0]) - 1 for t in tri])
                    if all(len(t) > 1 and t[1] for t in tri):
                        face_uvs.append([int(t[1]) - 1 for t in tri])

    texture = None
    if active_texture_path is None and mtl_textures:
        active_texture_path = next(iter(mtl_textures.values()))
    if active_texture_path and os.path.exists(active_texture_path):
        from PIL import Image

        with Image.open(active_texture_path) as img:
            texture = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0

    return Mesh(
        verts=np.asarray(verts, dtype=np.float32),
        faces=np.asarray(faces, dtype=np.int32).reshape(-1, 3),
        uvs=np.asarray(uvs, dtype=np.float32) if uvs else None,
        face_uvs=np.asarray(face_uvs, dtype=np.int32).reshape(-1, 3) if face_uvs else None,
        vert_colors=np.asarray(vcolors, dtype=np.float32) if vcolors else None,
        texture=texture,
    )


def sample_texture_bilinear(texture: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Sample an (H, W, 3) texture at (N, 2) UVs (origin bottom-left, v up)."""
    h, w = texture.shape[:2]
    u = np.clip(uv[:, 0], 0.0, 1.0) * (w - 1)
    v = (1.0 - np.clip(uv[:, 1], 0.0, 1.0)) * (h - 1)
    x0 = np.floor(u).astype(np.int64)
    y0 = np.floor(v).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = (u - x0)[:, None]
    fy = (v - y0)[:, None]
    c00, c01 = texture[y0, x0], texture[y0, x1]
    c10, c11 = texture[y1, x0], texture[y1, x1]
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def vertex_colors(mesh: Mesh) -> np.ndarray:
    """Per-vertex colours: the OBJ's own, else the mean of the texture
    samples of every face corner at the vertex, else 0.5 gray."""
    if mesh.vert_colors is not None:
        return mesh.vert_colors
    n = mesh.verts.shape[0]
    if mesh.texture is None or mesh.uvs is None or mesh.face_uvs is None:
        return np.full((n, 3), 0.5, dtype=np.float32)
    color_sum = np.zeros((n, 3), dtype=np.float64)
    count = np.zeros((n, 1), dtype=np.float64)
    for i in range(3):
        vid = mesh.faces[:, i]
        corner_colors = sample_texture_bilinear(mesh.texture, mesh.uvs[mesh.face_uvs[:, i]])
        np.add.at(color_sum, vid, corner_colors)
        np.add.at(count, vid, 1.0)
    return (color_sum / np.clip(count, 1.0, None)).astype(np.float32)


def unique_undirected_edges(faces: np.ndarray) -> np.ndarray:
    """(E, 2) unique undirected edges, each once, sorted (lo, hi)."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def mean_abs_edge_vectors(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-vertex mean of |edge vector| over its unique neighbours: the
    per-axis gaussian size before the edge shrink."""
    edges = unique_undirected_edges(faces)
    n = verts.shape[0]
    acc = np.zeros((n, 3), dtype=np.float64)
    cnt = np.zeros((n,), dtype=np.float64)
    vec = np.abs(verts[edges[:, 1]] - verts[edges[:, 0]])
    np.add.at(acc, edges[:, 0], vec)
    np.add.at(acc, edges[:, 1], vec)
    np.add.at(cnt, edges[:, 0], 1.0)
    np.add.at(cnt, edges[:, 1], 1.0)
    mask = cnt > 0
    acc[mask] /= cnt[mask, None]
    return acc.astype(np.float32)


def edge_connectivity(verts: np.ndarray, faces: np.ndarray) -> Dict[int, Dict[int, float]]:
    """vertex → {neighbour: euclidean distance}: the ARAP connectivity the
    mesh-mode recon reads (``system.connected_vertices_info_path``)."""
    out: Dict[int, Dict[int, float]] = {}
    for edges in (faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]):
        d = np.linalg.norm(verts[edges[:, 0]] - verts[edges[:, 1]], axis=1)
        for (a, b), dist in zip(edges.tolist(), d.tolist()):
            out.setdefault(a, {})[b] = dist
            out.setdefault(b, {})[a] = dist
    return out
