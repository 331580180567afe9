"""ctypes binding for the repository's native host-side loader
(``native/mvloader.cpp``): the port's counterpart of
``animate3d_tpu/data/native_loader.py``, with the same functions and the
same ``None`` contract.

Parallel PNG / JPEG decode with an area (box) downscale, and container
(mp4) decode through libavformat / libavcodec, to (n, size, size, 3)
float32 in [-1, 1]. The C calls release the GIL, so the trainer's prefetch
thread overlaps decoding with device steps.

The library is compiled at first use with ``g++`` (the flags and libraries
of ``native/Makefile``) into ``animate3d_tpu_torch/_build/`` under a name
that hashes the source and flags, so an edited source rebuilds; the build
log lands beside it as ``.log``. Where it cannot be built or loaded the
functions return ``None`` (``encode_video`` False) and the caller falls back
or raises. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG.parent / "native" / "mvloader.cpp"
BUILD_DIR = PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
LIBS = ("-lpng", "-ljpeg", "-lpthread", "-lavformat", "-lavcodec", "-lavutil", "-lswscale")


class _Loader:
    """The built and loaded library, or None once a build or load failed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tried = False
        self.lib: Optional[ctypes.CDLL] = None
        self.error = ""

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
        h.update(SOURCE.read_bytes())
        return BUILD_DIR / f"libmvloader-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the library unless it is there; raise on a failed build."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {SOURCE} (rc {proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(tmp, out)  # atomic: ranks building at once each keep a whole file
        return out

    def load(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if self._tried:
                return self.lib
            self._tried = True
            try:
                lib = ctypes.CDLL(str(self.build()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                self.error = str(e)
                return None
            f_ptr, i_ptr = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
            lib.mv_decode_images.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_int, f_ptr]
            lib.mv_decode_images.restype = ctypes.c_int
            lib.mv_decode_video.argtypes = [ctypes.c_char_p, i_ptr, ctypes.c_int,
                                            ctypes.c_int, f_ptr]
            lib.mv_decode_video.restype = ctypes.c_int
            lib.mv_encode_video.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
                                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int]
            lib.mv_encode_video.restype = ctypes.c_int
            lib.mv_video_frame_count.argtypes = [ctypes.c_char_p]
            lib.mv_video_frame_count.restype = ctypes.c_int
            self.lib = lib
            return lib


_LOADER = _Loader()


def available() -> bool:
    return _LOADER.load() is not None


def build_error() -> str:
    """Why the library is unavailable ('' when it loaded or was not tried)."""
    return _LOADER.error


def decode_images(paths: List[str], size: int,
                  n_threads: Optional[int] = None) -> Optional[np.ndarray]:
    """→ (len(paths), size, size, 3) float32 in [-1, 1]; None when the library
    is unavailable or any file fails to decode (the caller falls back and
    surfaces the bad file)."""
    lib = _LOADER.load()
    if lib is None or not paths:
        return None
    n_threads = n_threads or min(len(paths), os.cpu_count() or 1)
    out = np.empty((len(paths), size, size, 3), np.float32)
    n_ok = lib.mv_decode_images("\n".join(paths).encode(), len(paths), size, n_threads,
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if n_ok == len(paths) else None


def decode_video(path: str, indices, size: int) -> Optional[np.ndarray]:
    """Frames ``indices`` of a container file (mp4 etc.) → (len(indices),
    size, size, 3) float32 in [-1, 1]; indices past the clip's end clamp to
    its last frame. None when the library is unavailable or the file cannot
    be decoded."""
    lib = _LOADER.load()
    if lib is None:
        return None
    idx = np.ascontiguousarray(np.asarray(indices, np.int32))
    out = np.zeros((len(idx), size, size, 3), np.float32)
    filled = lib.mv_decode_video(path.encode(), idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                                 len(idx), size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if filled >= len(idx) else None


def video_frame_count(path: str) -> Optional[int]:
    """Frames in a container file; None when the library is unavailable or
    the file cannot be opened."""
    lib = _LOADER.load()
    if lib is None:
        return None
    n = lib.mv_video_frame_count(path.encode())
    return None if n < 0 else int(n)


def encode_video(path: str, frames: np.ndarray, fps: int = 8) -> bool:
    """Encode (F, H, W, 3) uint8 RGB frames to an mp4 (mpeg4): fixtures and
    tools need no binary files. False when the library is unavailable or
    the encode fails."""
    lib = _LOADER.load()
    if lib is None:
        return False
    frames = np.ascontiguousarray(frames, np.uint8)
    f, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"encode_video: frames must be (F, H, W, 3), got {frames.shape}")
    rc = lib.mv_encode_video(path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                             f, h, w, fps)
    return rc == 0
