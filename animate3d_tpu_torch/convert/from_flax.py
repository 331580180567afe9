"""Carry weights from a flax param tree to the port's state dicts.

The inverse of ``animate3d_tpu/convert/torch_to_flax.py``
(``translate_torch_path`` / ``convert_leaf``): flax module names that merged
diffusers segments with underscores split back into dotted form
(``down_blocks_0_attentions_1`` → ``down_blocks.0.attentions.1``), and
leaves convert by kind:

  Dense kernel (I, O) → weight (O, I);   Conv kernel HWIO → weight OIHW;
  norm scale → weight;   Embed embedding → weight;   bias → bias;
  raw tables (row_embed / col_embed) → ``<table>.weight``;
  other raw params (``mix_factor``, ``camera_embed``) as they are.

Adapter parameters (``to_q_i2v``, ``to_k_ip``, ``to_*_sp``,
``alpha_blender.mix_factor``) sit directly under their attention module, as
in the flax tree. Works for the UNet and the VAE trees;
:func:`clip_from_flax` carries the CLIP text and vision towers' trees to the
transformers names, and :func:`deform_params_from_flax` the 4D deformation
field's.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_GROUPS = ("down_blocks", "up_blocks", "resnets", "attentions", "motion_modules",
           "downsamplers", "upsamplers", "transformer_blocks")
_GROUP_RE = re.compile(r"(?:^|_)(" + "|".join(_GROUPS) + r")_(\d+)")
_RAW_TABLES = ("row_embed", "col_embed")


def translate_flax_segment(seg: str) -> str:
    """One flax module name → its dotted diffusers path."""
    if seg == "to_out_0":
        return "to_out.0"
    if seg == "net_0_proj":
        return "net.0.proj"
    m = re.fullmatch(r"net_(\d+)", seg)
    if m:
        return f"net.{m[1]}"
    m = re.fullmatch(r"encoder_hid_proj_(\d+)", seg)
    if m:
        return f"encoder_hid_proj.image_projection_layers.{m[1]}"
    m = re.fullmatch(r"mid_block_(resnets|attentions|motion_modules)_(\d+)", seg)
    if m:
        return f"mid_block.{m[1]}.{m[2]}"
    out = _GROUP_RE.sub(lambda g: ("." if g.start() else "") + f"{g[1]}.{g[2]}", seg)
    return re.sub(r"(\.\d+)_", r"\1.", out)  # ..._downsamplers_0_conv


def _convert_leaf(leaf: str, value: np.ndarray):
    """(flax leaf name, array) → (torch leaf name, array)."""
    if leaf == "kernel":
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        return "weight", value.T
    if leaf in ("scale", "embedding"):
        return "weight", value
    if leaf in _RAW_TABLES:
        return f"{leaf}.weight", value
    return leaf, value


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax param tree (``{"params": ...}`` or its inner dict) of numpy (or
    array-protocol) leaves → ``{diffusers name: float32 tensor}``."""
    tree = params["params"] if set(params) == {"params"} else params
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        leaf, arr = _convert_leaf(path[-1], np.array(value, dtype=np.float32))
        name = ".".join([translate_flax_segment(s) for s in path[:-1]] + [leaf])
        if name in out:
            raise ValueError(f"two flax leaves map to {name}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax_params(module: torch.nn.Module, params: Mapping[str, Any]) -> None:
    """Load a flax tree into ``module`` strictly (every parameter covered,
    no key left over), casting to the module's dtypes and device."""
    module.load_state_dict(from_flax(params), strict=True)


def deform_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``DeformationField``'s params (numpy leaves) → the port's
    ``DeformationField`` state dict: ``grid_{s}_{p}`` as they are, each
    Dense ``kernel`` (in, out) transposed to ``weight`` (out, in)."""
    tree = params["params"] if set(params) == {"params"} else params
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        arr = np.array(value, dtype=np.float32)
        if path[-1] == "kernel":
            path, arr = path[:-1] + ("weight",), arr.T
        out[".".join(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


_CLIP_TOP = {
    "text": {"token_embedding": "text_model.embeddings.token_embedding",
             "position_embedding": "text_model.embeddings.position_embedding",
             "final_layer_norm": "text_model.final_layer_norm"},
    "vision": {"class_embedding": "vision_model.embeddings.class_embedding",
               "patch_embedding": "vision_model.embeddings.patch_embedding",
               "position_embedding": "vision_model.embeddings.position_embedding",
               "pre_layrnorm": "vision_model.pre_layrnorm",
               "post_layernorm": "vision_model.post_layernorm",
               "visual_projection": "visual_projection"},
}


def clip_from_flax(params: Mapping[str, Any], tower: str) -> Dict[str, torch.Tensor]:
    """The JAX ``CLIPTextModel`` (``tower="text"``) or
    ``CLIPVisionModelWithProjection`` (``"vision"``) params → the port
    tower's state dict: ``layers_{i}`` → ``<tower>_model.encoder.layers.{i}``,
    ``mlp_fc1`` → ``mlp.fc1``, the raw tables ``position_embedding`` →
    ``...position_embedding.weight`` and ``class_embedding`` as it is."""
    tree = params["params"] if set(params) == {"params"} else params
    top = _CLIP_TOP[tower]
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        arr = np.array(value, dtype=np.float32)
        head = path[0]
        m = re.fullmatch(r"layers_(\d+)", head)
        if m:
            mods = [f"{tower}_model.encoder.layers.{m[1]}"] + [
                s.replace("mlp_", "mlp.") for s in path[1:-1]]
            leaf, arr = _convert_leaf(path[-1], arr)
        elif head in ("position_embedding", "class_embedding"):
            mods, leaf = [top[head]], ("weight" if head == "position_embedding" else None)
        else:
            mods = [top[head]] + list(path[1:-1])
            leaf, arr = _convert_leaf(path[-1], arr)
        name = ".".join(mods + ([leaf] if leaf else []))
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
