"""Prepare Rodin-Gen1 OBJ assets (the port of
``animate3d_tpu/tools/process_rodin.py``): insert ``usemtl Material`` after
the ``mtllib`` line and write a template ``base.mtl`` whose ``map_Kd`` is
the diffuse texture.

    python -m animate3d_tpu_torch.tools.process_rodin --input_obj asset.obj
"""

from __future__ import annotations

import argparse
import os

MTL_TEMPLATE = """newmtl Material
Ns 250.000000
Ka 1.000000 1.000000 1.000000
Kd 0.800000 0.800000 0.800000
Ks 0.500000 0.500000 0.500000
Ke 0.000000 0.000000 0.000000
Ni 1.450000
d 1.000000
illum 2
map_Kd {texture_name}
"""


def process(obj_path: str, texture_name: str = "texture_diffuse.png") -> None:
    with open(obj_path) as fh:
        lines = fh.read().splitlines()
    out = []
    inserted = False
    for line in lines:
        out.append(line)
        if line.startswith("mtllib") and not inserted:
            out.append("usemtl Material")
            inserted = True
    if not inserted:
        out = ["mtllib base.mtl", "usemtl Material"] + out
    with open(obj_path, "w") as f:
        f.write("\n".join(out) + "\n")
    with open(os.path.join(os.path.dirname(obj_path), "base.mtl"), "w") as f:
        f.write(MTL_TEMPLATE.format(texture_name=texture_name))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_obj", required=True)
    parser.add_argument("--texture_name", default="texture_diffuse.png")
    args = parser.parse_args(argv)
    process(args.input_obj, args.texture_name)
    print(f"processed {args.input_obj}")


if __name__ == "__main__":
    main()
