"""Split the 4-view-wide MV-VDM GIF into per-view frame PNGs (the port of
``animate3d_tpu/tools/split_gif.py``).

    python -m animate3d_tpu_torch.tools.split_gif --gif_path out.gif --output_dir frames/

Each frame of the horizontal concatenation is cut into ``n_views`` tiles,
saved as ``{view·F + frame}.png``: the numbering the tracking step and the
multi-image dataset read.
"""

from __future__ import annotations

import argparse
import os


def split_gif(gif_path: str, output_dir: str, n_views: int = 4) -> int:
    """Returns the GIF's frame count."""
    from PIL import Image, ImageSequence

    os.makedirs(output_dir, exist_ok=True)
    with Image.open(gif_path) as gif:
        frames = [f.convert("RGB").copy() for f in ImageSequence.Iterator(gif)]
    n_frames = len(frames)
    w, h = frames[0].size
    tile_w = w // n_views
    for view in range(n_views):
        for fi, frame in enumerate(frames):
            tile = frame.crop((view * tile_w, 0, (view + 1) * tile_w, h))
            tile.save(os.path.join(output_dir, f"{view * n_frames + fi}.png"))
    return n_frames


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--gif_path", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--n_views", type=int, default=4)
    args = parser.parse_args(argv)
    n = split_gif(args.gif_path, args.output_dir, args.n_views)
    print(f"split {n} frames × {args.n_views} views into {args.output_dir}")


if __name__ == "__main__":
    main()
