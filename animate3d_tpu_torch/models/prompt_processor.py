"""Prompt processing with an on-disk embedding cache: the port of
``animate3d_tpu/models/prompt_processor.py``.

Text embeddings are computed once and cached as one ``.npz`` a prompt
(array ``emb``), named by the md5 of ``"{model_id}:{prompt}"``: the JAX
package's key and layout, so one cache directory serves both packages.
View-dependent prompting appends the front / side / back / overhead
suffixes chosen by azimuth and elevation thresholds; with no text encoder,
:func:`encode_prompt_or_zeros` gives zero embeddings (smoke mode).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@dataclass
class DirectionConfig:
    name: str
    prompt_suffix: str


DIRECTIONS = (
    DirectionConfig("side", ", side view"),
    DirectionConfig("front", ", front view"),
    DirectionConfig("back", ", back view"),
    DirectionConfig("overhead", ", overhead view"),
)


def direction_ids(elevation_deg: np.ndarray, azimuth_deg: np.ndarray,
                  front_threshold: float = 30.0, back_threshold: float = 30.0,
                  overhead_threshold: float = 60.0) -> np.ndarray:
    """Per-view direction index into :data:`DIRECTIONS`."""
    az = (np.asarray(azimuth_deg) + 180.0) % 360.0 - 180.0
    ids = np.zeros(az.shape, np.int32)  # side
    ids[(az > -front_threshold) & (az < front_threshold)] = 1
    ids[(az > 180 - back_threshold) | (az < -180 + back_threshold)] = 2
    ids[np.asarray(elevation_deg) > overhead_threshold] = 3
    return ids


class PromptProcessor:
    """Compute-or-load cached text embeddings; ``encode_fn(prompts)`` →
    (len(prompts), 77, D) array."""

    def __init__(self, encode_fn: Optional[Callable[[List[str]], np.ndarray]] = None,
                 cache_dir: str = ".cache/text_embeddings", model_id: str = "clip-text"):
        self.encode_fn = encode_fn
        self.cache_dir = cache_dir
        self.model_id = model_id
        os.makedirs(cache_dir, exist_ok=True)

    def _cache_path(self, prompt: str) -> str:
        h = hashlib.md5(f"{self.model_id}:{prompt}".encode()).hexdigest()
        return os.path.join(self.cache_dir, f"{h}.npz")

    def embed(self, prompt: str) -> np.ndarray:
        path = self._cache_path(prompt)
        if os.path.exists(path):
            return np.load(path)["emb"]
        if self.encode_fn is None:
            raise RuntimeError(
                f"No cached embedding for {prompt!r} and no text encoder available")
        emb = np.asarray(self.encode_fn([prompt])[0])
        tmp = f"{path[:-4]}.{os.getpid()}.tmp.npz"
        np.savez(tmp, emb=emb)
        os.replace(tmp, path)  # whole files only: data-parallel ranks share the cache
        return emb

    def __call__(self, prompt: str, negative_prompt: str = "",
                 view_dependent: bool = False) -> Dict[str, np.ndarray]:
        """{'cond': (77, D), or (4, 77, D) view-dependent; 'uncond': (77, D)}."""
        uncond = self.embed(negative_prompt)
        if view_dependent:
            cond = np.stack([self.embed(prompt + d.prompt_suffix) for d in DIRECTIONS])
        else:
            cond = self.embed(prompt)
        return {"cond": cond, "uncond": uncond}


def encode_prompt_or_zeros(prompt: str, negative_prompt: str, n_views: int,
                           hidden_size: int = 768, max_length: int = 77,
                           model_root: Optional[str] = None, text_model=None,
                           device="cpu"):
    """Per-view (n_views, 77, D) cond / uncond embeddings through a tokenizer
    under ``model_root`` and ``text_model`` when both are given; zeros
    otherwise (smoke mode)."""
    if model_root is not None and text_model is not None:
        from animate3d_tpu_torch.models.factory import encode_text

        return encode_text(prompt, negative_prompt, n_views, text_model, model_root,
                           max_length=max_length)
    print("[prompt] WARNING: no text encoder — zero text embeddings (smoke mode)")
    z = torch.zeros((n_views, max_length, hidden_size), dtype=torch.float32, device=device)
    return z, z
