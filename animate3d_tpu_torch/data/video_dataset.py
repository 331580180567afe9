"""MV-Video training dataset (host side), port of ``animate3d_tpu/data/video_dataset.py``.

A JSON manifest maps each item to per-view videos and a caption (and an
optional ``azimuth_start``); ``sample_n_frames`` frames are taken at a
random stride phase of the clip, pixels normalised to [-1, 1], cameras from
the MVDream orbit (``utils/camera.get_camera``). Still images and
directories of image frames are read with PIL. Container formats (mp4)
need the JAX package's native libavcodec decoder, which is not ported yet:
they raise.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np
from PIL import Image

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


def _frame_paths(path: str, indices: np.ndarray) -> List[str]:
    """The file of each frame index for an image-sequence directory (frames
    sorted by name length, then name; indices past the end take the last)
    or a still image (every index)."""
    if os.path.isdir(path):
        names = sorted((n for n in os.listdir(path) if n.lower().endswith(_IMAGE_EXT)),
                       key=lambda x: (len(x), x))
        if not names:
            raise FileNotFoundError(f"no image frames in {path!r}")
        return [os.path.join(path, names[min(int(i), len(names) - 1)]) for i in indices]
    if path.lower().endswith(_IMAGE_EXT):
        return [path] * len(indices)
    raise NotImplementedError(
        f"cannot read {path!r}: video containers (mp4) need the native libavcodec "
        "decoder (animate3d_tpu/data/native_loader.py), which the port has not "
        "ported yet; give a directory of frames or a still image")


def _read_frames(path: str, indices: np.ndarray, size: int) -> np.ndarray:
    """(len(indices), size, size, 3) float32 in [-1, 1]."""
    out = []
    for f in _frame_paths(path, indices):
        with Image.open(f) as im:
            im = im.convert("RGB")
            if im.size != (size, size):
                im = im.resize((size, size), Image.LANCZOS)
            out.append(np.asarray(im, np.float32))
    return np.stack(out) / 127.5 - 1.0


class MVideoDataset:
    """items: [{"videos": [per-view paths], "caption": str, ("azimuth_start": deg)}]"""

    def __init__(self, cfg: MVideoConfig, seed: int = 0):
        self.cfg = cfg
        with open(cfg.manifest_path) as f:
            self.items: List[Dict] = json.load(f)
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        item = self.items[idx]
        stride = cfg.total_frames // cfg.sample_n_frames
        phase = int(self.rng.integers(0, max(stride, 1)))
        indices = phase + stride * np.arange(cfg.sample_n_frames)
        pixel_values = np.stack([
            _read_frames(os.path.join(cfg.video_root, rel), indices, cfg.sample_size)
            for rel in item["videos"][: cfg.num_views]])  # (N, F, H, W, 3)
        cameras = get_camera(cfg.num_views, elevation=cfg.elevation,
                             azimuth_start=item.get("azimuth_start", 0.0))
        return {"pixel_values": pixel_values, "cameras": cameras,
                "text": item.get("caption", "")}

    def _collate(self, idxs) -> Dict[str, np.ndarray]:
        samples = [self[int(i)] for i in idxs]
        return {"pixel_values": np.stack([s["pixel_values"] for s in samples]),
                "cameras": np.stack([s["cameras"] for s in samples]),
                "text": [s["text"] for s in samples]}

    def iterate(self, batch_size: int = 1, shuffle: bool = True
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Endless batches: epochs over a shuffled order, or, when the
        dataset is smaller than a batch, draws with replacement."""
        order = np.arange(len(self.items))
        if len(order) < batch_size:
            while True:
                yield self._collate(self.rng.choice(len(self.items), batch_size, replace=True))
        while True:
            if shuffle:
                self.rng.shuffle(order)
            for start in range(0, len(order) - batch_size + 1, batch_size):
                yield self._collate(order[start:start + batch_size])


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
