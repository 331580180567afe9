"""Opt-in runtime shape and dtype contracts (``launch.py --typecheck``): the
port of ``animate3d_tpu/core/typecheck.py``.

:func:`enable_typecheck` wraps the data boundaries where outside tensors
enter the 4D stage with the JAX package's four contracts, written as plain
shape and dtype checks (jaxtyping and typeguard are not dependencies of the
port). A contract binds named axes across its arguments, so a mis-shaped
input fails at the boundary with the argument and axis named instead of
deep inside a kernel. The checks read shapes and dtypes only: no device
synchronisation.

Boundaries covered:
  * ``Animate3DSystem.step``                — recon / refine batches;
  * ``rendering.renderer4d.render_batch``   — cameras + timestamps;
  * ``ops.rasterize.rasterize``             — gaussian tensors (the port's
    rasterize takes a leading view axis, bound as ``*b``);
  * ``ops.attention.multi_head_attention``  — merged-head q / k / v.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

_originals: list = []


class TypeCheckError(TypeError):
    """A tensor broke a boundary contract."""


def _kind_ok(x, kind: str) -> bool:
    """``num``: any number but bool (jaxtyping's ``Num``); ``float``:
    floating point (``Float``)."""
    if isinstance(x, torch.Tensor):
        if kind == "float":
            return x.dtype.is_floating_point
        return x.dtype != torch.bool
    dt = np.asarray(x).dtype
    if kind == "float":
        return np.issubdtype(dt, np.floating)
    return np.issubdtype(dt, np.number)


def _bind(contract: str, args: List[Tuple[str, object, str, str]]) -> Dict[str, object]:
    """Check ``(name, array, "axis names", kind)`` for each argument: the
    dtype kind, the rank, literal sizes, and that a name means one size
    (``*b`` one run of leading sizes) over all of them. Returns the binding."""
    binding: Dict[str, object] = {}
    for name, x, dims, kind in args:
        shape = tuple(np.shape(x)) if not isinstance(x, torch.Tensor) else tuple(x.shape)
        dtype = x.dtype if isinstance(x, torch.Tensor) else np.asarray(x).dtype
        if not _kind_ok(x, kind):
            raise TypeCheckError(f"{contract}: argument {name!r} has dtype {dtype}, "
                                 f"not a {kind} type")
        axes = dims.split()
        variadic = axes[0].startswith("*") if axes else False
        fixed = axes[1:] if variadic else axes
        if len(shape) < len(fixed) or (not variadic and len(shape) != len(fixed)):
            raise TypeCheckError(f"{contract}: argument {name!r} has shape {shape}, "
                                 f"expected {dims!r}")
        lead, rest = shape[:len(shape) - len(fixed)], shape[len(shape) - len(fixed):]
        pairs = ([(axes[0], lead)] if variadic else []) + list(zip(fixed, rest))
        for axis, size in pairs:
            if axis.isdigit():
                if int(axis) != size:
                    raise TypeCheckError(f"{contract}: argument {name!r} has shape {shape}: "
                                         f"axis {axis!r} is {size}")
            elif binding.setdefault(axis, size) != size:
                raise TypeCheckError(f"{contract}: argument {name!r} has shape {shape}: "
                                     f"axis {axis!r} is {size}, bound to {binding[axis]} by "
                                     f"an earlier argument")
    return binding


def check_recon_batch(rgb, mask, timestamps) -> None:
    _bind("recon batch", [("rgb", rgb, "bnf h w 3", "num"), ("mask", mask, "bnf h w 1", "num"),
                          ("timestamps", timestamps, "bnf", "num")])


def check_render_batch(timestamps, w2c, full_proj, cam_pos) -> None:
    _bind("render_batch", [("timestamps", timestamps, "b", "num"),
                           ("w2c", w2c, "b 4 4", "float"),
                           ("full_proj", full_proj, "b 4 4", "float"),
                           ("cam_pos", cam_pos, "b 3", "float")])


def check_rasterize(means, scales, quats, opacity) -> None:
    _bind("rasterize", [("means", means, "*b n 3", "float"),
                        ("scales", scales, "*b n 3", "float"),
                        ("quats", quats, "*b n 4", "float"),
                        ("opacity", opacity, "n", "float")])


def check_attention(q, k, v, num_heads: int, kv_group: int = 1) -> None:
    """q (B, Sq, C), k / v (B / kv_group, Sk, C), C divisible by num_heads."""
    bind = _bind("multi_head_attention", [("q", q, "b sq c", "num"), ("k", k, "bk sk c", "num"),
                                          ("v", v, "bk sk c", "num")])
    if bind["b"] != bind["bk"] * kv_group:
        raise TypeCheckError(f"multi_head_attention: q's batch {bind['b']} is not k / v's "
                             f"{bind['bk']} x kv_group {kv_group}")
    if bind["c"] % num_heads:
        raise ValueError(f"multi_head_attention: channels {bind['c']} not divisible by "
                         f"num_heads {num_heads}")


def _wrap(obj, name: str, make_wrapper) -> None:
    fn = getattr(obj, name)
    wrapped = functools.update_wrapper(make_wrapper(fn), fn)
    _originals.append((obj, name, fn))
    setattr(obj, name, wrapped)


def enable_typecheck() -> None:
    """Install the contracts (idempotent)."""
    if _originals:
        return
    from animate3d_tpu_torch.models import attention_layers
    from animate3d_tpu_torch.ops import attention, rasterize
    from animate3d_tpu_torch.rendering import renderer4d
    from animate3d_tpu_torch.systems import animate3d

    def sys_step(fn):
        def wrapper(self, batch, draws=None, guidance_batch=None):
            check_recon_batch(batch["rgb"], batch["mask"], batch["timestamps"])
            return fn(self, batch, draws=draws, guidance_batch=guidance_batch)
        return wrapper

    def render_batch(fn):
        def wrapper(state, deform_fn, cameras, timestamps, cfg, *args, **kw):
            check_render_batch(timestamps, cameras.world_view, cameras.full_proj,
                               cameras.camera_center)
            return fn(state, deform_fn, cameras, timestamps, cfg, *args, **kw)
        return wrapper

    def rasterize_(fn):
        def wrapper(means, scales, quats, opacity, camera, cfg, *args, **kw):
            check_rasterize(means, scales, quats, opacity)
            return fn(means, scales, quats, opacity, camera, cfg, *args, **kw)
        return wrapper

    def mha(fn):
        def wrapper(q, k, v, num_heads, scale=None, kv_group=1, self_attention=False):
            check_attention(q, k, v, num_heads, kv_group)
            return fn(q, k, v, num_heads, scale=scale, kv_group=kv_group,
                      self_attention=self_attention)
        return wrapper

    _wrap(animate3d.Animate3DSystem, "step", sys_step)
    # modules that imported a function by name hold their own binding
    for mod in (renderer4d, animate3d):
        _wrap(mod, "render_batch", render_batch)
    for mod in (rasterize, renderer4d):
        _wrap(mod, "rasterize", rasterize_)
    for mod in (attention, attention_layers):
        _wrap(mod, "multi_head_attention", mha)


def disable_typecheck() -> None:
    """Restore the unwrapped functions."""
    while _originals:
        obj, name, fn = _originals.pop()
        setattr(obj, name, fn)
