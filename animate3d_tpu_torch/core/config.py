"""YAML config: the port's own copy of ``animate3d_tpu/core/config.py``
(threestudio's semantics without OmegaConf).

  * YAML files deep-merged in order, then dotted ``key.path=value`` CLI
    overrides (values parsed as YAML), then keyword arguments;
  * ``${...}`` interpolation: dotted references and the ``rmspace``
    resolver, innermost first;
  * :func:`parse_structured` builds a dataclass from a dict, unknown keys
    raising; :class:`ExperimentConfig` derives the trial directory.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field, fields as dc_fields, is_dataclass
from datetime import datetime
from typing import Any, Dict, List, Optional

import yaml


def C_max(value: Any) -> float:
    """The largest value a ``C()`` schedule reaches."""
    if isinstance(value, (int, float)):
        return value
    value = list(value)
    if len(value) >= 6:
        max_value = value[2]
        for i in range(4, len(value), 2):
            max_value = max(max_value, value[i])
        value = [value[0], value[1], max_value, value[3]]
    if len(value) == 3:
        value = [0] + value
    if len(value) != 4:
        raise ValueError(f"Cannot interpret schedule spec {value}")
    return max(value[1], value[2])


# the resolvers the shipped configs use (the JAX package registers the
# reference's full set)
_RESOLVERS = {
    "rmspace": lambda s, sub: s.replace(" ", sub),
}

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")  # innermost ${...}


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


def _lookup(root: Any, path: str) -> Any:
    node = root
    for part in path.split("."):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node


def _resolve_expr(expr: str, root: Any) -> Any:
    expr = expr.strip()
    name, sep, argstr = expr.partition(":")
    if sep:
        if name.strip() not in _RESOLVERS:
            raise NotImplementedError(f"config resolver {name.strip()!r} is not ported")
        args = [yaml.safe_load(a.strip()) if a.strip() != "" else ""
                for a in argstr.split(",")] if argstr else []
        return _RESOLVERS[name.strip()](*args)
    return _lookup(root, expr)


def resolve_interpolations(node: Any, root: Any, _depth: int = 0) -> Any:
    """Resolve ``${...}``, innermost first, to a fixpoint; a string that is
    one whole interpolation keeps the resolved value's type."""
    if _depth > 32:
        raise RecursionError("Interpolation depth exceeded (cycle?)")
    if isinstance(node, dict):
        return {k: resolve_interpolations(v, root, _depth) for k, v in node.items()}
    if isinstance(node, list):
        return [resolve_interpolations(v, root, _depth) for v in node]
    if not isinstance(node, str):
        return node
    m = _INTERP_RE.fullmatch(node.strip())
    if m:
        val = _resolve_expr(m.group(1), root)
        if isinstance(val, str) and _INTERP_RE.search(val):
            val = resolve_interpolations(val, root, _depth + 1)
        return val
    out = node
    for _ in range(32):
        if _INTERP_RE.fullmatch(out.strip()):
            return resolve_interpolations(out, root, _depth + 1)
        new = _INTERP_RE.sub(lambda mm: str(_resolve_expr(mm.group(1), root)), out)
        if new == out:
            return new
        out = new
    raise RecursionError(f"Interpolation did not converge for {node!r}")


def _fixpoint_resolve(cfg: Dict[str, Any]) -> Dict[str, Any]:
    for _ in range(8):
        new = resolve_interpolations(cfg, cfg)
        if new == cfg:
            return new
        cfg = new
    return cfg


def parse_structured(cls: Any, cfg: Optional[Dict[str, Any]] = None) -> Any:
    """Dataclass ``cls`` from a dict, recursing into dataclass fields.
    Unknown keys raise."""
    cfg = dict(cfg or {})
    if not is_dataclass(cls):
        raise TypeError(f"{cls} is not a dataclass")
    names = {f.name: f for f in dc_fields(cls)}
    unknown = set(cfg) - set(names)
    if unknown:
        raise ValueError(f"Unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for k, v in cfg.items():
        ftype = names[k].type
        kwargs[k] = parse_structured(ftype, v) if is_dataclass(ftype) and isinstance(v, dict) \
            else v
    return cls(**kwargs)


def config_to_primitive(config: Any) -> Any:
    if isinstance(config, dict):
        return {k: config_to_primitive(v) for k, v in config.items()}
    if isinstance(config, (list, tuple)):
        return [config_to_primitive(v) for v in config]
    return config


def dump_config(path: str, config: Any) -> None:
    with open(path, "w") as fp:
        yaml.safe_dump(config_to_primitive(config), fp, sort_keys=False)


@dataclass
class ExperimentConfig:
    """Top-level experiment config (threestudio/utils/config.py:51-101)."""

    name: str = "default"
    description: str = ""
    tag: str = ""
    seed: int = 0
    use_timestamp: bool = True
    timestamp: Optional[str] = None
    exp_root_dir: str = "outputs"
    exp_dir: str = "outputs/default"
    trial_name: str = "exp"
    trial_dir: str = "outputs/default/exp"
    n_devices: int = 1
    resume: Optional[str] = None
    data_type: str = ""
    data: dict = field(default_factory=dict)
    system_type: str = ""
    system: dict = field(default_factory=dict)
    trainer: dict = field(default_factory=dict)
    checkpoint: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.tag and not self.use_timestamp:
            raise ValueError("Either tag is specified or use_timestamp is True.")
        self.trial_name = self.tag
        if self.timestamp is None:
            self.timestamp = ""
            if self.use_timestamp and self.n_devices <= 1:
                self.timestamp = datetime.now().strftime("@%Y%m%d-%H%M%S")
        self.trial_name += self.timestamp
        self.exp_dir = os.path.join(self.exp_root_dir, self.name)
        self.trial_dir = os.path.join(self.exp_dir, self.trial_name)


def load_config(*yamls: str, cli_args: Optional[List[str]] = None, from_string: bool = False,
                makedirs: bool = True, **kwargs: Any) -> ExperimentConfig:
    cfg: Dict[str, Any] = {}
    for y in yamls:
        raw = y if from_string else open(y).read()
        cfg = deep_merge(cfg, yaml.safe_load(raw) or {})
    cfg = deep_merge(cfg, parse_cli_overrides(list(cli_args or [])))
    cfg = _fixpoint_resolve(deep_merge(cfg, kwargs))
    scfg = parse_structured(ExperimentConfig, cfg)
    if makedirs:
        os.makedirs(scfg.trial_dir, exist_ok=True)
    return scfg
