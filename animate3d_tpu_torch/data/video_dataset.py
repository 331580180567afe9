"""MV-Video training dataset (host side), port of ``animate3d_tpu/data/video_dataset.py``.

A JSON manifest maps each item to per-view videos and a caption (and an
optional ``azimuth_start``); ``sample_n_frames`` frames are taken at a
random stride phase of the clip, pixels normalised to [-1, 1], cameras from
the MVDream orbit (``utils/camera.get_camera``). Frames are read as the JAX
package reads them: image sequences (a directory of frames, or a still
image) and container files (mp4) through the native decoder
(``data/native_loader.py``, an area downscale), PIL with LANCZOS only where
that library is unavailable or an image fails in it. A container the native
decoder fails on raises: there is no other video reader.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np
from PIL import Image

from animate3d_tpu_torch.data import native_loader
from animate3d_tpu_torch.utils.camera import get_camera

_IMAGE_EXT = (".png", ".jpg", ".jpeg")


@dataclass
class MVideoConfig:
    manifest_path: str = ""
    video_root: str = ""
    sample_size: int = 256
    sample_n_frames: int = 16
    total_frames: int = 48  # source clip length the stride phase samples from
    num_views: int = 4
    elevation: float = 15.0


def _frame_paths(path: str, indices: np.ndarray) -> Optional[List[str]]:
    """The file of each frame index for an image-sequence directory (frames
    sorted by name length, then name; indices past the end take the last)
    or a still image (every index); None for anything else (containers)."""
    if os.path.isdir(path):
        names = sorted((n for n in os.listdir(path) if n.lower().endswith(_IMAGE_EXT)),
                       key=lambda x: (len(x), x))
        if not names:
            raise FileNotFoundError(f"no image frames in {path!r}")
        return [os.path.join(path, names[min(int(i), len(names) - 1)]) for i in indices]
    if path.lower().endswith(_IMAGE_EXT):
        return [path] * len(indices)
    return None


def _read_frames(path: str, indices: np.ndarray, size: int) -> np.ndarray:
    """(len(indices), size, size, 3) float32 in [-1, 1]."""
    files = _frame_paths(path, indices)
    if files is None:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no video at {path!r}")
        frames = native_loader.decode_video(path, indices, size)
        if frames is None:
            why = native_loader.build_error() or "corrupt or unsupported file?"
            raise RuntimeError(f"cannot decode video {path!r}: the native libavcodec decoder "
                               f"failed on it ({why}) and there is no other video reader")
        return frames
    frames = native_loader.decode_images(files, size)
    if frames is not None:
        return frames
    out = []
    for f in files:
        with Image.open(f) as im:
            # RGB and RGBA as they are (JAX's reader); other modes (L, LA, P) to RGB
            a = np.asarray(im if im.mode in ("RGB", "RGBA") else im.convert("RGB"))
        if a.shape[0] != size or a.shape[1] != size:
            a = np.asarray(Image.fromarray(a).resize((size, size), Image.LANCZOS))
        out.append(a[..., :3])
    return np.stack(out).astype(np.float32) / 127.5 - 1.0


class MVideoDataset:
    """items: [{"videos": [per-view paths], "caption": str, ("azimuth_start": deg)}]"""

    def __init__(self, cfg: MVideoConfig, seed: int = 0):
        self.cfg = cfg
        with open(cfg.manifest_path) as f:
            self.items: List[Dict] = json.load(f)
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.items)

    def _indices(self) -> np.ndarray:
        """A clip's frame indices at a random stride phase (one draw)."""
        cfg = self.cfg
        stride = cfg.total_frames // cfg.sample_n_frames
        phase = int(self.rng.integers(0, max(stride, 1)))
        return phase + stride * np.arange(cfg.sample_n_frames)

    def _item(self, idx: int, indices: np.ndarray) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        item = self.items[idx]
        pixel_values = np.stack([
            _read_frames(os.path.join(cfg.video_root, rel), indices, cfg.sample_size)
            for rel in item["videos"][: cfg.num_views]])  # (N, F, H, W, 3)
        cameras = get_camera(cfg.num_views, elevation=cfg.elevation,
                             azimuth_start=item.get("azimuth_start", 0.0))
        return {"pixel_values": pixel_values, "cameras": cameras,
                "text": item.get("caption", "")}

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self._item(idx, self._indices())

    def _collate(self, idxs, keep: slice) -> Dict[str, np.ndarray]:
        """The rows ``keep`` of the batch of items ``idxs``: every item's
        phase is drawn, only the kept ones are read."""
        draws = [(int(i), self._indices()) for i in idxs]
        samples = [self._item(i, ind) for i, ind in draws[keep]]
        return {"pixel_values": np.stack([s["pixel_values"] for s in samples]),
                "cameras": np.stack([s["cameras"] for s in samples]),
                "text": [s["text"] for s in samples]}

    def iterate(self, batch_size: int = 1, shuffle: bool = True,
                keep: slice = slice(None)) -> Iterator[Dict[str, np.ndarray]]:
        """Endless batches: epochs over a shuffled order, or, when the
        dataset is smaller than a batch, draws with replacement. ``keep``
        selects the rows of each batch this process reads (a data-parallel
        rank's slice of the global batch); the draws are the whole batch's,
        so every rank's generator stays in step."""
        order = np.arange(len(self.items))
        if len(order) < batch_size:
            while True:
                yield self._collate(self.rng.choice(len(self.items), batch_size, replace=True),
                                    keep)
        while True:
            if shuffle:
                self.rng.shuffle(order)
            for start in range(0, len(order) - batch_size + 1, batch_size):
                yield self._collate(order[start:start + batch_size], keep)


class Prefetcher:
    """Background-thread prefetch over any batch iterator: the host reads
    the next batches while the device runs the current step. ``depth``
    bounds the queued batches; an error in the reader is raised on the
    consumer side. :meth:`close` (or leaving a ``with`` block) stops the
    reader thread."""

    def __init__(self, it, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._sentinel = object()
        self._err = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # re-raised by __next__
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._t = threading.Thread(target=worker, daemon=True, name="batch-prefetch")
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the reader, draining the queue so that a blocked ``put``
        returns, and wait for its thread to end."""
        self._stop.set()
        while self._t.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._t.join(timeout=0.05)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
