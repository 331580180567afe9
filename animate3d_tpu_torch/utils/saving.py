"""Artifact saving: the port's own copies of the parts of
``animate3d_tpu/utils/saving.py`` it uses (multi-view and grid GIFs, RGBA
pngs, mp4 videos with a GIF fallback, trajectory npys, json, and the
trial-dir :class:`Saver`).
"""

from __future__ import annotations

import json
import os

import numpy as np


def _to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    return img


def export_to_gif_mv(frames: np.ndarray, path: str, fps: int = 8) -> str:
    """(N_view, F, H, W, 3) video in [0, 1] → GIF with the views side by side."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n, f = frames.shape[:2]
    pil_frames = [Image.fromarray(np.concatenate(
        [_to_uint8(frames[v, fi]) for v in range(n)], axis=1)) for fi in range(f)]
    pil_frames[0].save(path, save_all=True, append_images=pil_frames[1:],
                       duration=int(1000 / fps), loop=0)
    return path


def save_video_mp4(frames: np.ndarray, path: str, fps: int = 8) -> str:
    """(F, H, W, 3) video in [0, 1] → mp4 through an ffmpeg-capable
    ``imageio`` writer; where there is none (``imageio`` or its ffmpeg
    plugin missing, or the writer failing), a GIF beside it. Returns the
    path written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio

        writer = imageio.get_writer(path, fps=fps)
        for fr in frames:
            writer.append_data(_to_uint8(fr))
        writer.close()
        return path
    except (ImportError, ValueError, OSError, RuntimeError):  # no usable mp4 writer
        alt = os.path.splitext(path)[0] + ".gif"
        export_to_gif_mv(np.asarray(frames)[None], alt, fps=fps)
        return alt


def save_videos_grid(videos: np.ndarray, path: str, n_rows: int = 4, fps: int = 8) -> str:
    """(B, F, H, W, 3) videos in [0, 1] → one GIF of an ``n_rows`` grid."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    b, f = videos.shape[:2]
    cols = int(np.ceil(b / n_rows))
    blank = np.zeros_like(_to_uint8(videos[0, 0]))
    pil_frames = []
    for fi in range(f):
        rows = [np.concatenate([_to_uint8(videos[r * cols + c, fi]) if r * cols + c < b
                                else blank for c in range(cols)], axis=1)
                for r in range(n_rows)]
        pil_frames.append(Image.fromarray(np.concatenate(rows, axis=0)))
    pil_frames[0].save(path, save_all=True, append_images=pil_frames[1:],
                       duration=int(1000 / fps), loop=0)
    return path


def save_rgba_image(path: str, rgb: np.ndarray, alpha: np.ndarray) -> str:
    """RGBA png from rgb (H, W, 3) and alpha (H, W) in [0, 1]."""
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(np.concatenate([_to_uint8(rgb), _to_uint8(alpha)[..., None]], -1)).save(path)
    return path


class Saver:
    """Saves under one trial directory (threestudio's SaverMixin paths)."""

    def __init__(self, save_dir: str):
        self.save_dir = save_dir

    def path(self, name: str) -> str:
        p = os.path.join(self.save_dir, name)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def rgba(self, name: str, rgb: np.ndarray, alpha: np.ndarray) -> str:
        return save_rgba_image(self.path(name), rgb, alpha)

    def gif_mv(self, name: str, frames: np.ndarray, fps: int = 8) -> str:
        return export_to_gif_mv(frames, self.path(name), fps)

    def mp4(self, name: str, frames: np.ndarray, fps: int = 8) -> str:
        return save_video_mp4(frames, self.path(name), fps)

    def trajectory(self, name: str, means3d: np.ndarray) -> str:
        """Per-frame gaussian positions (the mesh-animation export's input)."""
        p = self.path(name)
        np.save(p, np.asarray(means3d))
        return p

    def json(self, name: str, data) -> str:
        p = self.path(name)
        with open(p, "w") as f:
            json.dump(data, f, indent=2)
        return p
