"""YAML config helpers: the port's own copy of the part of
``animate3d_tpu/core/config.py`` the CLIs need (nested merge and dotted
``key.path=value`` overrides)."""

from __future__ import annotations

from typing import Any, Dict, List

import yaml


def deep_merge(base: Any, override: Any) -> Any:
    """Merge ``override`` into ``base`` (dicts merged recursively, else replaced)."""
    if isinstance(base, dict) and isinstance(override, dict):
        out = dict(base)
        for k, v in override.items():
            out[k] = deep_merge(out[k], v) if k in out else v
        return out
    return override


def _set_dotted(cfg: Dict[str, Any], dotted_key: str, value: Any) -> None:
    keys = dotted_key.split(".")
    node = cfg
    for k in keys[:-1]:
        nxt = node.get(k)
        if not isinstance(nxt, dict):
            nxt = {}
            node[k] = nxt
        node = nxt
    node[keys[-1]] = value


def parse_cli_overrides(args: List[str]) -> Dict[str, Any]:
    """``["a.b=1", "c=x"]`` → ``{"a": {"b": 1}, "c": "x"}`` (values parsed as YAML)."""
    cfg: Dict[str, Any] = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"CLI override must look like key.path=value, got {arg!r}")
        key, raw = arg.split("=", 1)
        _set_dotted(cfg, key.strip(), yaml.safe_load(raw) if raw != "" else None)
    return cfg
