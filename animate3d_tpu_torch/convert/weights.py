"""Read the released torch weight files into the port's modules.

The JAX package converts these artifacts in two steps:
``scripts/convert_weights.py`` writes an orbax bundle, and its CLIs read the
bundle. Orbax cannot be read without JAX, so the port reads the released
artifacts directly, from the layout that script discovers under a root:

  * the MVDream SD1.5 stack: ``unet/ vae/ text_encoder/ tokenizer/``;
  * the AnimateDiff motion adapter (its ``config.json`` names
    ``MotionAdapter``), merged over the UNet;
  * the IP-Adapter: ``models/ip-adapter_sd15.bin`` onto each cross-attention's
    ``to_k_ip`` / ``to_v_ip`` and the image projection, plus
    ``models/image_encoder``;
  * ``animate3d_motion_modules.ckpt`` (any ``*motion*.ckpt`` / ``.pth``),
    loaded last with the strict=False key audit of the JAX package's
    ``load_animate3d_motion_checkpoint``.

``.bin`` / ``.ckpt`` / ``.pth`` files load with ``torch.load(...,
weights_only=True)``; ``.safetensors`` with :func:`read_safetensors`, a
reader of the format itself (an 8-byte little-endian header length, a JSON
header, raw little-endian buffers). A root that holds an orbax bundle and
no torch files raises.

Released UNet keys reach the port's names as the JAX converter's path
rules do: adapter keys lose ``.processor.``, and ``to_k_ip.0`` / ``to_v_ip.0``
(a ``ModuleList`` of one in the reference) become ``to_k_ip`` / ``to_v_ip``.
The VAE's and the CLIP towers' keys are the port's own names; the legacy
VAE attention names (``query``, ``key``, ``value``, ``proj_attn``) are
renamed to ``to_q``, ``to_k``, ``to_v``, ``to_out.0``.

The video models' releases (Stable Video Diffusion, CogVideoX) carry the
port's names as they are: :func:`load_svd_artifacts`,
:func:`load_cogvideox_artifacts`.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, List, Optional, Tuple

import torch

MODEL_FILES = ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
               "model.safetensors", "pytorch_model.bin")

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file → {name: CPU tensor}. Raises on a dtype the
    reader does not know, or on offsets outside the buffer."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file (too short)")
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n].decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']!r}, which "
                             f"this reader does not know ({sorted(_ST_DTYPES)})")
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= len(data) - base:
            raise ValueError(f"{path}: tensor {name!r} lies outside the file")
        shape = tuple(info["shape"])
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: tensor {name!r} has {end - begin} bytes for shape {shape}")
        buf = bytearray(data[base + begin:base + end])
        t = torch.frombuffer(buf, dtype=dtype) if count else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """The inverse of :func:`read_safetensors` (contiguous CPU copies)."""
    names = {v: k for k, v in _ST_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode("utf-8")
    head += b" " * ((-len(head)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b)


def _flatten(d: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in d.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "."))
        elif isinstance(v, torch.Tensor):
            out[name] = v
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A weight file → flat {name: tensor}: nested dicts (the IP-Adapter's
    ``image_proj`` / ``ip_adapter``) join with dots, a ``state_dict`` key
    is unwrapped, non-tensor entries are dropped."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    return _flatten(obj)


def find_model_file(d: str, names=MODEL_FILES) -> Optional[str]:
    for n in names:
        p = os.path.join(d, n)
        if os.path.exists(p):
            return p
    return None


def discover_artifacts(root: str) -> dict:
    """Walk ``root`` and find the four artifact families by their directory
    signatures, as ``scripts/convert_weights.py`` does. The MVDream stack is
    a directory with ``unet/`` and ``vae/``, or (a text-only root) with
    ``text_encoder/`` and ``tokenizer/``."""
    found = {"mvdream_dir": None, "motion_adapter_dir": None,
             "ip_adapter_dir": None, "animate3d_ckpt": None}
    text_only = None
    for dirpath, dirnames, filenames in os.walk(root, followlinks=True):
        dirnames[:] = [d for d in dirnames if not d.startswith(".")]
        has = lambda sub: os.path.isdir(os.path.join(dirpath, sub))
        if found["mvdream_dir"] is None and has("unet") and has("vae"):
            found["mvdream_dir"] = dirpath
        if text_only is None and has("text_encoder") and has("tokenizer"):
            text_only = dirpath
        if (found["ip_adapter_dir"] is None and os.path.exists(
                os.path.join(dirpath, "models", "ip-adapter_sd15.bin"))):
            found["ip_adapter_dir"] = dirpath
        if found["motion_adapter_dir"] is None and "config.json" in filenames:
            try:
                with open(os.path.join(dirpath, "config.json")) as f:
                    if json.load(f).get("_class_name") == "MotionAdapter":
                        found["motion_adapter_dir"] = dirpath
            except (OSError, ValueError):
                pass
        if found["animate3d_ckpt"] is None:
            for n in filenames:
                if n.endswith((".ckpt", ".pth")) and "motion" in n.lower():
                    found["animate3d_ckpt"] = os.path.join(dirpath, n)
                    break
    if found["motion_adapter_dir"] is None:
        for dirpath, dirnames, filenames in os.walk(root, followlinks=True):
            if "motion-adapter" in os.path.basename(dirpath) and find_model_file(dirpath):
                found["motion_adapter_dir"] = dirpath
                break
    if found["mvdream_dir"] is None:
        found["mvdream_dir"] = text_only
    # an image encoder on its own (no ip-adapter_sd15.bin beside it)
    if found["ip_adapter_dir"] is None:
        for dirpath, dirnames, filenames in os.walk(root, followlinks=True):
            if os.path.isdir(os.path.join(dirpath, "models", "image_encoder")):
                found["ip_adapter_dir"] = dirpath
                break
    return found


def _is_orbax_bundle(root: str) -> bool:
    for sub in ("unet", "vae", "text_encoder", "image_encoder"):
        d = os.path.join(root, sub)
        if os.path.isdir(d) and any(re.fullmatch(r"step_\d+", n) for n in os.listdir(d)):
            return True
    return False


def check_artifact_root(root: str) -> dict:
    """:func:`discover_artifacts`, raising where ``root`` holds an orbax
    bundle (the JAX package's converted weights) and no torch artifact."""
    found = discover_artifacts(root)
    if not any(found.values()) and _is_orbax_bundle(root):
        raise ValueError(
            f"{root!r} holds an orbax bundle (the JAX package's converted weights), which "
            "cannot be read without JAX. The port reads the released torch artifacts that "
            "bundle is converted from: point it at the directory with the MVDream stack "
            "(unet/ vae/ text_encoder/ tokenizer/), the IP-Adapter and the motion checkpoint")
    return found


def unet_key(name: str) -> str:
    """A released diffusers UNet key → the port's parameter name."""
    name = name.replace(".processor.", ".")
    if name.startswith("module."):
        name = name[len("module."):]
    return re.sub(r"\.(to_[kv]_ip)\.0\.", r".\1.", name)


_VAE_LEGACY = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def vae_key(name: str) -> str:
    return re.sub(r"\.attentions\.(\d+)\.(query|key|value|proj_attn)\.",
                  lambda m: f".attentions.{m[1]}.{_VAE_LEGACY[m[2]]}.", name)


def ip_adapter_state(sd: Dict[str, torch.Tensor], ucfg) -> Dict[str, torch.Tensor]:
    """``ip-adapter_sd15.bin`` (flattened) → port UNet names: ``image_proj``
    onto ``encoder_hid_proj.image_projection_layers.0`` (``proj`` →
    ``image_embeds``), ``ip_adapter.{i}.to_{k,v}_ip`` onto the attn2 of the
    i // 2-th cross-attention transformer in diffusers' processor order
    (down blocks, up blocks, mid)."""
    order = []
    n_blocks = len(ucfg.block_out_channels)
    for i in range(n_blocks - 1):
        for j in range(ucfg.layers_per_block):
            order.append(f"down_blocks.{i}.attentions.{j}")
    for i in range(1, n_blocks):
        for j in range(ucfg.layers_per_block + 1):
            order.append(f"up_blocks.{i}.attentions.{j}")
    order.append("mid_block.attentions.0")
    out = {}
    for name, value in sd.items():
        parts = name.split(".")
        if parts[0] == "image_proj":
            sub = {"proj": "image_embeds", "norm": "norm"}[parts[1]]
            out[f"encoder_hid_proj.image_projection_layers.0.{sub}.{parts[-1]}"] = value
        elif parts[0] == "ip_adapter":
            block = order[int(parts[1]) // 2]
            out[f"{block}.transformer_blocks.0.attn2.{parts[2]}.{parts[-1]}"] = value
    return out


def _assign(module: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> Tuple[List[str], List[str]]:
    """Copy ``sd`` into ``module``'s parameters and buffers by name (cast to
    each one's dtype and device; shapes must match) → (missing,
    unexpected), both sorted."""
    own = dict(module.state_dict())
    unexpected = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    with torch.no_grad():
        for k in set(sd) & set(own):
            if tuple(sd[k].shape) != tuple(own[k].shape):
                raise ValueError(f"{k}: file shape {tuple(sd[k].shape)}, module "
                                 f"{tuple(own[k].shape)}")
            own[k].copy_(sd[k])
    return missing, unexpected


def load_clip_state(model: torch.nn.Module, path: str) -> Tuple[List[str], List[str]]:
    """A transformers CLIP text / vision state dict into the port's tower
    (the buffer ``position_ids`` older files carry is dropped)."""
    sd = {k: v for k, v in load_torch_state_dict(path).items()
          if not k.endswith("position_ids")}
    return _assign(model, sd)


_TRAINED_MARKERS = ("motion_modules", "_i2v", "_sp", "alpha_blender")


def load_animate3d_motion_checkpoint(unet: torch.nn.Module, path: str) -> int:
    """The released motion-modules checkpoint onto the UNet, strict=False:
    an unknown key means a broken file, a trained key (motion modules,
    I2V / spatial adapters, alpha blenders) that the file lacks raises too.
    Returns the count of missing (frozen base) keys."""
    sd = {unet_key(k): v for k, v in load_torch_state_dict(path).items()}
    missing, unexpected = _assign(unet, sd)
    if unexpected:
        raise ValueError(f"checkpoint has {len(unexpected)} unknown keys, e.g. "
                         f"{unexpected[:5]} — file is broken or layout drifted")
    for k in missing:
        if any(m in k for m in _TRAINED_MARKERS):
            raise ValueError(f"trained key {k} missing from checkpoint")
    return len(missing)


def load_motion_export(unet: torch.nn.Module, path: str) -> Tuple[str, int]:
    """The port trainer's motion-module export (``<dir>/step_N`` or the
    directory holding them: the newest step) grafted onto the UNet; every
    exported tensor must have a home. Returns (step path, tensors grafted)."""
    from animate3d_tpu_torch.core.checkpoint import find_latest_checkpoint, restore_checkpoint

    if not os.path.basename(os.path.normpath(path)).startswith("step_"):
        latest = find_latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"--pretrained_unet_path {path!r}: no step_N checkpoint")
        path = latest
    raw = restore_checkpoint(path)
    sd = raw.get("params", raw)
    _, unexpected = _assign(unet, sd)
    if unexpected:
        raise ValueError(f"{path}: {len(unexpected)} exported tensors have no home in the "
                         f"UNet, e.g. {unexpected[:5]}")
    return path, len(sd)


def load_artifacts(root: str, unet=None, vae=None, text_model=None, vision_model=None,
                   motion_ckpt: bool = True) -> Dict[str, dict]:
    """Load what ``root`` holds into the given modules, in the order of
    ``scripts/convert_weights.py``: UNet base, motion adapter and IP-Adapter
    merged, then the motion checkpoint on top; the VAE; the text encoder;
    the image encoder. Returns {component: audit} for each component
    loaded (missing / unexpected counts, or the motion checkpoint's frozen
    key count); a component whose file is absent is not in it."""
    found = check_artifact_root(root)
    audit: Dict[str, dict] = {}
    mv = found["mvdream_dir"]
    if unet is not None:
        merged: Dict[str, torch.Tensor] = {}
        base = find_model_file(os.path.join(mv, "unet")) if mv else None
        if base:
            merged.update({unet_key(k): v for k, v in load_torch_state_dict(base).items()})
        if found["motion_adapter_dir"]:
            ma = find_model_file(found["motion_adapter_dir"])
            if ma:
                merged.update({unet_key(k): v for k, v in load_torch_state_dict(ma).items()})
        ip = (os.path.join(found["ip_adapter_dir"], "models", "ip-adapter_sd15.bin")
              if found["ip_adapter_dir"] else None)
        if ip and os.path.exists(ip):
            merged.update(ip_adapter_state(load_torch_state_dict(ip), unet.config))
        if merged:
            missing, unexpected = _assign(unet, merged)
            audit["unet"] = {"missing": len(missing), "unexpected": len(unexpected)}
        if motion_ckpt and found["animate3d_ckpt"]:
            n = load_animate3d_motion_checkpoint(unet, found["animate3d_ckpt"])
            audit["motion_ckpt"] = {"frozen_base_keys": n}
    if vae is not None and mv:
        vfile = find_model_file(os.path.join(mv, "vae"))
        if vfile:
            sd = {vae_key(k): v for k, v in load_torch_state_dict(vfile).items()}
            missing, unexpected = _assign(vae, sd)
            audit["vae"] = {"missing": len(missing), "unexpected": len(unexpected)}
    if text_model is not None and mv:
        tfile = find_model_file(os.path.join(mv, "text_encoder"))
        if tfile:
            missing, unexpected = load_clip_state(text_model, tfile)
            audit["text_encoder"] = {"missing": len(missing), "unexpected": len(unexpected)}
    if vision_model is not None and found["ip_adapter_dir"]:
        ifile = find_model_file(os.path.join(found["ip_adapter_dir"], "models",
                                             "image_encoder"))
        if ifile:
            missing, unexpected = load_clip_state(vision_model, ifile)
            audit["image_encoder"] = {"missing": len(missing), "unexpected": len(unexpected)}
    return audit


def tokenizer_root(root: Optional[str]) -> Optional[str]:
    """The directory whose ``vocab.json`` / ``merges.txt`` (in it or in its
    ``tokenizer/``) the artifact root's text tower uses, or None."""
    from animate3d_tpu_torch.utils.tokenizer import find_tokenizer_files

    if not root or not os.path.isdir(root):
        return None
    for cand in (root, discover_artifacts(root)["mvdream_dir"]):
        if cand is None:
            continue
        try:
            find_tokenizer_files(cand)
            return cand
        except FileNotFoundError:
            pass
    return None


SVD_MODEL_FILES = MODEL_FILES + ("diffusion_pytorch_model.fp16.safetensors",
                                 "model.fp16.safetensors")


def load_svd_artifacts(root: str, unet=None, vae=None, vision_model=None) -> Dict[str, dict]:
    """Load a Stable Video Diffusion release laid out as on the hub
    (``unet/``, ``vae/``, ``image_encoder/`` under ``root``) into the port's
    modules, whose parameter names are diffusers' own: the UNet's and the
    temporal VAE's keys load as they are (legacy VAE attention names
    renamed, :func:`vae_key`), the image encoder's as a transformers CLIP
    vision tower. Returns {component: {missing, unexpected}} for each file
    found; a component without a file is left out."""
    audit: Dict[str, dict] = {}
    for name, module, key in (("unet", unet, lambda k: k), ("vae", vae, vae_key)):
        path = find_model_file(os.path.join(root, name), SVD_MODEL_FILES) if module else None
        if path:
            missing, unexpected = _assign(module, {key(k): v for k, v in
                                                   load_torch_state_dict(path).items()})
            audit[name] = {"missing": len(missing), "unexpected": len(unexpected)}
    path = (find_model_file(os.path.join(root, "image_encoder"), SVD_MODEL_FILES)
            if vision_model is not None else None)
    if path:
        missing, unexpected = load_clip_state(vision_model, path)
        audit["image_encoder"] = {"missing": len(missing), "unexpected": len(unexpected)}
    return audit


def _model_shards(d: str) -> List[str]:
    """A component directory's weight files: one of ``MODEL_FILES`` (or its
    fp16 variant), else every shard of a sharded release
    (``*-00001-of-00003.safetensors`` and the like), in name order."""
    single = find_model_file(d, SVD_MODEL_FILES)
    if single:
        return [single]
    if not os.path.isdir(d):
        return []
    shard = re.compile(r".*-\d{5}-of-\d{5}\.(safetensors|bin)$")
    return sorted(os.path.join(d, f) for f in os.listdir(d) if shard.match(f))


def load_cogvideox_artifacts(root: str, transformer=None, vae=None,
                             t5=None) -> Dict[str, dict]:
    """Load a CogVideoX release laid out as on the hub (``transformer/``,
    ``vae/``, ``text_encoder/`` under ``root``, single files or shards) into
    the port's modules, whose names are diffusers' and transformers' own:
    every key loads as it is, but the T5 encoder's ``encoder.embed_tokens``,
    which ties to ``shared``. Returns {component: {missing, unexpected}} for
    each component with files; a component without files is left out."""
    audit: Dict[str, dict] = {}
    for name, module in (("transformer", transformer), ("vae", vae), ("text_encoder", t5)):
        paths = _model_shards(os.path.join(root, name)) if module is not None else []
        if not paths:
            continue
        sd: Dict[str, torch.Tensor] = {}
        for path in paths:
            sd.update(load_torch_state_dict(path))
        sd.pop("encoder.embed_tokens.weight", None)
        missing, unexpected = _assign(module, sd)
        audit[name] = {"missing": len(missing), "unexpected": len(unexpected)}
    return audit
