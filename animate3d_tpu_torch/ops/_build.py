"""Build the CUDA sources in ``csrc/`` at first use and load them via ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``_build/`` (listed in
``.gitignore``), named by a hash of the sources and flags so an edited source
rebuilds. All missing libraries build in parallel, one ``nvcc`` each. A
failed build or load raises; nothing here runs at import time.

``LAUNCHES`` counts kernel launches by (counter name, shape key): each
wrapper adds one right where it launches its kernel, and nowhere else. It
is ``utils/trace.COUNTERS``, which holds the program's other counters
beside them under other names.
One launch may serve two TPU kernels (``flash_bwd``'s single pass writes
what the TPU's dq and dkv kernels wrote: it counts one ``flash_bwd_dq`` when
it writes dq and one ``flash_bwd_dkv`` when it writes dk / dv), and one
kernel may serve two TPU kernels' routes (``packed_attn`` launched under
``attention_backend("packed_flash")`` counts as ``packed_temporal``), so the
counter names (``COUNTERS``) are the routes', not the libraries'.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

from animate3d_tpu_torch.utils import trace

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNELS = ("flash_fwd", "packed_attn", "geglu", "flash_bwd", "packed_attn_bwd",
           "composite_coarse", "composite_fields", "kplanes")
COUNTERS = ("flash_fwd", "packed_attn", "geglu", "flash_bwd_dq", "flash_bwd_dkv",
            "packed_attn_bwd", "composite_coarse_fwd", "composite_coarse_bwd",
            "composite_fields_fwd", "composite_fields_bwd", "packed_temporal",
            "kplanes_fwd", "kplanes_bwd")

LAUNCHES: "collections.Counter[tuple]" = trace.COUNTERS

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def launch_totals() -> Dict[str, int]:
    """Launches per counter name, summed over shapes."""
    totals = {name: 0 for name in COUNTERS}
    for (name, _), n in LAUNCHES.items():
        if name in totals:
            totals[name] += n
    return totals


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named library that is not built yet, in parallel.

    Returns {name: seconds} for the libraries compiled by this call (the
    ptxas report of each lands beside it as ``<lib>.log``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    took, errors = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(name: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code)
        raise RuntimeError(f"{name}: CUDA error {code}: {msg.decode()}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
