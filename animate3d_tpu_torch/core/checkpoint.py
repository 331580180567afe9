"""Checkpoints as ``torch.save`` files, for the trainer and the 4D stage.

The layout of ``animate3d_tpu/core/checkpoint.py``: ``<dir>/step_N`` per
save, the latest found by step number. The motion-modules-only export
(``extract_motion_modules``) lives beside the trainer, which owns the
parameter names. The JAX package writes orbax directories, which cannot
be read without JAX; here ``step_N`` holds one ``checkpoint.pt`` with the
payload dict (tensors, numbers, nested dicts).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

_FILE = "checkpoint.pt"


def save_checkpoint(ckpt_dir: str, step: int, payload: Dict[str, Any],
                    keep: Optional[int] = None) -> str:
    """Write ``payload`` to ``ckpt_dir/step_{step}``; with ``keep``, delete
    all but the newest ``keep`` steps."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    if keep is not None:
        for s in list_checkpoint_steps(ckpt_dir)[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"))
    return path


def list_checkpoint_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, _FILE)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def find_latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``step_*`` path with the largest step, or None."""
    steps = list_checkpoint_steps(ckpt_dir)
    return os.path.join(ckpt_dir, f"step_{steps[-1]}") if steps else None


def restore_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
    """The payload saved at ``path`` (a ``step_N`` directory), tensors on
    ``device`` (the CPU by default: optimizer state and generator states
    are loaded from there)."""
    return torch.load(os.path.join(path, _FILE), map_location=device, weights_only=True)

