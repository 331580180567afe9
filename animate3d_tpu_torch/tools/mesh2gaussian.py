"""OBJ mesh → coarse gaussian splat + ARAP connectivity JSON: step 1 of the
mesh-animation flow (the port of ``animate3d_tpu/tools/mesh2gaussian.py``).

    python -m animate3d_tpu_torch.tools.mesh2gaussian --input_obj asset.obj \\
        --output_dir data/asset --output_name asset

One gaussian a vertex: colours averaged from the UV texture over the
incident faces (SH degree 0), log-scales = log(mean |edge vector| / 1.1)
per axis, identity rotations, opacity inverse_sigmoid(1 - 1e-5). Writes
``<name>.ply`` and ``<name>.json`` ({vertex: {neighbour: distance}}), the
two files ``configs/animate3d/mesh_animation_frame_16.yaml`` reads.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from animate3d_tpu_torch.gaussians.ply import write_gaussian_ply
from animate3d_tpu_torch.gaussians.state import GaussianState, inverse_sigmoid
from animate3d_tpu_torch.utils.mesh import (
    edge_connectivity,
    load_obj,
    mean_abs_edge_vectors,
    vertex_colors,
)
from animate3d_tpu_torch.utils.sh import rgb_to_sh


def mesh_to_gaussians(obj_path: str, edge_shrink: float = 1.1, mesh=None) -> GaussianState:
    """The asset's gaussians (on the CPU; ``mesh``: the loaded OBJ, if the
    caller has it)."""
    mesh = mesh if mesh is not None else load_obj(obj_path)
    colors = vertex_colors(mesh)
    mean_edges = mean_abs_edge_vectors(mesh.verts, mesh.faces) / edge_shrink
    n = mesh.verts.shape[0]
    rotation = np.zeros((n, 4), dtype=np.float32)
    rotation[:, 0] = 1.0
    return GaussianState.from_numpy(
        xyz=mesh.verts,
        features_dc=rgb_to_sh(colors.astype(np.float32))[:, None, :],
        features_rest=np.zeros((n, 0, 3), dtype=np.float32),
        opacity=inverse_sigmoid(np.ones((n, 1)) - 1e-5),
        scaling=np.log(np.clip(mean_edges, 1e-12, None)),
        rotation=rotation, sh_degree=0)


def run(input_obj: str, output_dir: str, output_name: str) -> None:
    os.makedirs(output_dir, exist_ok=True)
    mesh = load_obj(input_obj)
    write_gaussian_ply(os.path.join(output_dir, f"{output_name}.ply"),
                       mesh_to_gaussians(input_obj, mesh=mesh))
    conn = edge_connectivity(mesh.verts, mesh.faces)
    with open(os.path.join(output_dir, f"{output_name}.json"), "w") as f:
        json.dump({str(k): v for k, v in conn.items()}, f, indent=2)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Convert OBJ to gaussian point cloud + connectivity JSON.")
    parser.add_argument("--input_obj", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--output_name", required=True)
    args = parser.parse_args(argv)
    run(args.input_obj, args.output_dir, args.output_name)
    print(f"Wrote {args.output_name}.ply and {args.output_name}.json to {args.output_dir}")


if __name__ == "__main__":
    main()
