"""Dataclass configs, ``--cfg`` files and dotted overrides — the port of
``deeplearning_tpu/core/config.py``.

A config is any (nested) dataclass. ``load_config`` merges, in order:
dataclass defaults < ``_base_`` yaml files < the yaml file < dotted CLI
overrides (``train.lr 3e-4`` or ``train.lr=3e-4``, each value read by
``yaml.safe_load``), and returns a frozen instance.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import typing
from typing import Any, Dict, List, Optional, Sequence, Tuple, TypeVar

import yaml

T = TypeVar("T")

__all__ = ["asdict", "merge_dict", "load_config", "save_config",
           "pop_flag", "config_cli"]

_BASE_KEY = "_base_"


def asdict(cfg: Any) -> Dict[str, Any]:
    """Recursively convert a dataclass config to a plain dict."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: asdict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(asdict(v) for v in cfg)
    if isinstance(cfg, dict):
        return {k: asdict(v) for k, v in cfg.items()}
    return cfg


def _coerce(value: Any, target_type: Any) -> Any:
    """Best-effort coercion of a YAML/CLI value to the field's type."""
    if value is None:
        return None
    origin = getattr(target_type, "__origin__", None)
    if origin in (tuple, Tuple):
        args = getattr(target_type, "__args__", ())
        if args and args[-1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in value)
        if args and len(args) == len(value):
            return tuple(_coerce(v, t) for v, t in zip(value, args))
        return tuple(value)
    if origin in (list, List):
        args = getattr(target_type, "__args__", ())
        elem = args[0] if args else None
        return [_coerce(v, elem) if elem else v for v in value]
    if origin is not None:  # Optional[X] / Union
        for arg in getattr(target_type, "__args__", ()):
            if arg is type(None):
                continue
            try:
                return _coerce(value, arg)
            except (TypeError, ValueError):
                continue
        return value
    if isinstance(target_type, type):
        if target_type is bool and isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        if target_type in (int, float, str) and \
                not isinstance(value, target_type):
            return target_type(value)
    return value


def merge_dict(cfg: T, overrides: Dict[str, Any], strict: bool = True) -> T:
    """Return a new config with ``overrides`` (a nested dict) merged in.
    An unknown key raises ``KeyError`` listing the valid ones."""
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"merge_dict expects a dataclass, got {type(cfg)}")
    field_map = {f.name: f for f in dataclasses.fields(cfg)}
    # resolve string annotations (``from __future__ import annotations``)
    # so a CLI "1e-4" becomes a float, not a string
    try:
        hints = typing.get_type_hints(type(cfg))
    except Exception:                                    # noqa: BLE001
        hints = {}
    updates = {}
    for key, value in overrides.items():
        if key == _BASE_KEY:
            continue
        if key not in field_map:
            if strict:
                raise KeyError(
                    f"Unknown config key {key!r} for {type(cfg).__name__}; "
                    f"valid keys: {sorted(field_map)}")
            continue
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[key] = merge_dict(current, value, strict=strict)
        else:
            updates[key] = _coerce(value, hints.get(key,
                                                    field_map[key].type))
    return dataclasses.replace(cfg, **updates)


def _parse_dotted(opts: Sequence[str]) -> Dict[str, Any]:
    """``['a.b', '1', 'c', 'true']`` or ``['a.b=1']`` -> nested dict."""
    flat: List[Tuple[str, str]] = []
    i = 0
    opts = list(opts)
    while i < len(opts):
        if "=" in opts[i]:
            k, v = opts[i].split("=", 1)
            flat.append((k, v))
            i += 1
        else:
            if i + 1 >= len(opts):
                raise ValueError(f"Dangling config override key {opts[i]!r}")
            flat.append((opts[i], opts[i + 1]))
            i += 2
    nested: Dict[str, Any] = {}
    for key, raw in flat:
        try:
            value = yaml.safe_load(raw)
        except yaml.YAMLError:
            value = raw
        node = nested
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return nested


def _load_yaml_with_bases(path: str) -> Dict[str, Any]:
    """Load a YAML file, recursively resolving ``_base_`` inheritance."""
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    bases = data.pop(_BASE_KEY, [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for base in bases:
        base_path = base if os.path.isabs(base) else os.path.join(
            os.path.dirname(path), base)
        _deep_update(merged, _load_yaml_with_bases(base_path))
    _deep_update(merged, data)
    return merged


def _deep_update(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def load_config(defaults: T, yaml_path: Optional[str] = None,
                opts: Optional[Sequence[str]] = None,
                strict: bool = True) -> T:
    """defaults < yaml (with _base_ chain) < dotted CLI opts."""
    cfg = defaults
    if yaml_path:
        cfg = merge_dict(cfg, _load_yaml_with_bases(yaml_path), strict=strict)
    if opts:
        cfg = merge_dict(cfg, _parse_dotted(opts), strict=strict)
    return cfg


def save_config(cfg: Any, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(asdict(cfg), f, sort_keys=False)


def pop_flag(argv: list, name: str) -> Optional[str]:
    """Extract ``name VALUE`` or ``name=VALUE`` from argv in place and
    return the value (None if absent). The scan stops at a literal
    ``--``."""
    for i, a in enumerate(argv):
        if a == "--":
            return None
        if a == name:
            if i + 1 >= len(argv):
                raise SystemExit(f"{name} requires a value")
            value = argv[i + 1]
            del argv[i:i + 2]
            return value
        if a.startswith(name + "="):
            del argv[i]
            return a.split("=", 1)[1]
    return None


def config_cli(defaults: T, argv: Optional[Sequence[str]] = None,
               description: str = "") -> T:
    """Standard CLI: ``prog [--cfg FILE] [key value | key=value ...]``."""
    import argparse
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--cfg", type=str, default=None,
                        help="YAML config file")
    parser.add_argument("opts", nargs="*", default=[],
                        help="dotted overrides: train.lr 3e-4 or "
                             "train.lr=3e-4")
    args = parser.parse_args(argv)
    return load_config(defaults, args.cfg, args.opts)
