"""Export the optimised per-vertex trajectories as an animated mesh (the
port of ``animate3d_tpu/tools/export_animated_mesh.py``).

    python -m animate3d_tpu_torch.tools.export_animated_mesh --base_obj asset.obj \\
        --trajectory_dir <trial>/save/gaussian_trajectory --output asset_anim.glb

The trajectories (``means3D_frame_{i}.npy`` of the mesh-mode recon's
``--export``) are taken back to the mesh's frame (the inverse of the
asset's load-time rotation and scale). Where ``bpy`` imports, Blender's
shape-key FBX flow runs; elsewhere a self-contained glTF (GLB) is written:
the mesh with one morph target a frame and a weights animation.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import struct
from typing import List, Optional

import numpy as np

from animate3d_tpu_torch.gaussians.ply import asset_transform_matrix
from animate3d_tpu_torch.utils.mesh import load_obj


def load_trajectory_frames(traj_dir: str) -> np.ndarray:
    """``means3D_frame_{i}.npy`` (any ``*_{i}.npy``), by i → (F, N, 3)."""
    names = [n for n in os.listdir(traj_dir) if n.endswith(".npy")]
    names.sort(key=lambda n: int(re.findall(r"(\d+)", n)[-1]))
    return np.stack([np.load(os.path.join(traj_dir, n)) for n in names])


def inverse_asset_transform(traj: np.ndarray, rot_x_degree: float,
                            rot_z_degree: float, scale_factor: float) -> np.ndarray:
    """Undo the load-time re-posing, so the animation lives in the mesh's frame."""
    inv = np.linalg.inv(asset_transform_matrix(rot_x_degree, rot_z_degree))
    return np.einsum("ij,fnj->fni", inv, traj / scale_factor)


def write_glb_morph_animation(path: str, verts: np.ndarray, faces: np.ndarray,
                              frames: np.ndarray, fps: float = 8.0) -> str:
    """A GLB of the mesh (``verts`` (N, 3), ``faces`` (F, 3)) with one morph
    target a frame of ``frames`` (T, N, 3) and a LINEAR weights animation
    keyed one-hot at t / fps."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.uint32)
    deltas = np.asarray(frames, np.float32) - verts[None]
    t_frames = deltas.shape[0]
    buffers: List[bytes] = []
    views, accessors = [], []

    def add(data: np.ndarray, target: Optional[int], acc_type: str, comp: int) -> int:
        raw = data.tobytes()
        offset = sum(len(b) for b in buffers)
        pad = (-offset) % 4
        if pad:
            buffers.append(b"\x00" * pad)
            offset += pad
        buffers.append(raw)
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(raw),
                      **({"target": target} if target else {})})
        acc = {"bufferView": len(views) - 1, "componentType": comp,
               "count": data.shape[0], "type": acc_type}
        if acc_type == "VEC3":
            acc["min"] = data.min(0).tolist()
            acc["max"] = data.max(0).tolist()
        elif acc_type == "SCALAR" and comp == 5126:
            acc["min"] = [float(data.min())]
            acc["max"] = [float(data.max())]
        accessors.append(acc)
        return len(accessors) - 1

    pos_acc = add(verts, 34962, "VEC3", 5126)
    idx_acc = add(faces.reshape(-1), 34963, "SCALAR", 5125)
    target_accs = [add(deltas[t], 34962, "VEC3", 5126) for t in range(t_frames)]
    time_acc = add(np.arange(t_frames, dtype=np.float32) / fps, None, "SCALAR", 5126)
    # shape key t fully on at time t; t_frames weights per keyframe, flattened
    w_acc = add(np.eye(t_frames, dtype=np.float32).reshape(-1, 1), None, "SCALAR", 5126)
    accessors[w_acc]["count"] = t_frames * t_frames

    gltf = {
        "asset": {"version": "2.0", "generator": "animate3d_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": "animated_mesh"}],
        "meshes": [{
            "primitives": [{
                "attributes": {"POSITION": pos_acc},
                "indices": idx_acc,
                "targets": [{"POSITION": a} for a in target_accs],
            }],
            "weights": [0.0] * t_frames,
        }],
        "animations": [{
            "samplers": [{"input": time_acc, "output": w_acc, "interpolation": "LINEAR"}],
            "channels": [{"sampler": 0, "target": {"node": 0, "path": "weights"}}],
        }],
        "buffers": [{"byteLength": sum(len(b) for b in buffers)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    json_bytes = json.dumps(gltf).encode()
    json_bytes += b" " * ((-len(json_bytes)) % 4)
    bin_bytes = b"".join(buffers)
    bin_bytes += b"\x00" * ((-len(bin_bytes)) % 4)
    with open(path, "wb") as f:
        total = 12 + 8 + len(json_bytes) + 8 + len(bin_bytes)
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_bytes), 0x4E4F534A))
        f.write(json_bytes)
        f.write(struct.pack("<II", len(bin_bytes), 0x004E4942))
        f.write(bin_bytes)
    return path


def export_fbx_bpy(obj_path: str, frames: np.ndarray, out_path: str, fps: float = 8.0) -> str:
    """Blender's shape-key FBX export (needs ``bpy``)."""
    import bpy

    bpy.ops.wm.read_factory_settings(use_empty=True)
    bpy.ops.wm.obj_import(filepath=obj_path)
    obj = bpy.context.selected_objects[0]
    obj.shape_key_add(name="Basis")
    for t in range(frames.shape[0]):
        sk = obj.shape_key_add(name=f"frame_{t}")
        for vi, pos in enumerate(frames[t]):
            sk.data[vi].co = tuple(pos)
    for t in range(frames.shape[0]):
        sk = obj.data.shape_keys.key_blocks[f"frame_{t}"]
        for t2 in range(frames.shape[0]):
            sk.value = 1.0 if t2 == t else 0.0
            sk.keyframe_insert("value", frame=t2)
    bpy.ops.export_scene.fbx(filepath=out_path, bake_anim=True, path_mode="COPY",
                             embed_textures=True)
    return out_path


def run(base_obj: str, trajectory_dir: str, output_path: str, rot_x_degree: float = 90.0,
        rot_z_degree: float = 0.0, scale_factor: float = 1.0, fps: float = 8.0) -> str:
    mesh = load_obj(base_obj)
    traj = load_trajectory_frames(trajectory_dir)
    if traj.shape[1] != mesh.verts.shape[0]:
        raise ValueError(f"trajectory has {traj.shape[1]} points but mesh has "
                         f"{mesh.verts.shape[0]} vertices — run mesh-mode reconstruction")
    frames = inverse_asset_transform(traj, rot_x_degree, rot_z_degree, scale_factor)
    try:
        import bpy  # noqa: F401
    except ImportError:
        if output_path.endswith(".fbx"):
            output_path = output_path[:-4] + ".glb"
        return write_glb_morph_animation(output_path, mesh.verts, mesh.faces, frames, fps)
    return export_fbx_bpy(base_obj, frames, output_path, fps)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--base_obj", required=True)
    parser.add_argument("--trajectory_dir", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--rot_x_degree", type=float, default=90.0)
    parser.add_argument("--rot_z_degree", type=float, default=0.0)
    parser.add_argument("--scale_factor", type=float, default=1.0)
    parser.add_argument("--fps", type=float, default=8.0)
    args = parser.parse_args(argv)
    out = run(args.base_obj, args.trajectory_dir, args.output, args.rot_x_degree,
              args.rot_z_degree, args.scale_factor, args.fps)
    print(f"exported {out}")


if __name__ == "__main__":
    main()
