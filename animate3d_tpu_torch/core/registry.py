"""Module registry (the port's copy of ``animate3d_tpu/core/registry.py``):
configs select systems and datamodules by name, ``"main:sub"`` composing a
type whose bases are ``(sub..., main)``."""

from __future__ import annotations

from typing import Any, Dict, Type

__modules__: Dict[str, Type[Any]] = {}


def register(name: str):
    def decorator(cls):
        if name in __modules__ and __modules__[name] is not cls:
            raise ValueError(f"Module {name!r} already registered")
        __modules__[name] = cls
        return cls

    return decorator


def find(name: str) -> Type[Any]:
    if ":" in name:
        main_name, sub_name = name.split(":")
        names = sub_name.split(",") + [main_name]
        return type(f"{main_name}.{sub_name}", tuple(__modules__[n] for n in names), {})
    if name not in __modules__:
        raise KeyError(f"No module registered under {name!r}; known: {sorted(__modules__)}")
    return __modules__[name]
