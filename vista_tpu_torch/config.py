"""Typed configs: YAML <-> nested frozen dataclasses (counterpart of
``vista_tpu/config.py``).

YAML keys map onto the port's dataclass configs, so a config is checked when
it is loaded: an unknown key raises. Files merge left to right, then
``a.b.c=value`` dotlist overrides apply.

The shipped configs were written for the JAX package, whose
``VideoUNetConfig`` has three fields that only the TPU reads
(:data:`UNET_TPU_ONLY`). The port knows them by name: ``attn_backend`` is
read and dropped with a notice (the card always runs the hand-written
kernels, the CPU their plain versions); ``remat_max_ds`` and
``remat_policy`` change what remat stores and raise unless null (the port
remats every block whole).
"""

from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Dict, Optional, Sequence, Type, TypeVar

T = TypeVar("T")

UNET_TPU_ONLY = ("attn_backend", "remat_max_ds", "remat_policy")


def _convert(value, field_type):
    """Structural conversion of YAML scalars and containers."""
    origin = typing.get_origin(field_type)
    if dataclasses.is_dataclass(field_type) and isinstance(value, dict):
        return from_dict(field_type, value)
    if origin in (tuple, Sequence) and isinstance(value, (list, tuple)):
        args = typing.get_args(field_type)
        if args and args[-1] is Ellipsis:
            return tuple(_convert(v, args[0]) for v in value)
        if args and len(args) == len(value):
            return tuple(_convert(v, a) for v, a in zip(value, args))
        return tuple(value)
    if origin is typing.Union:  # Optional[...]
        for a in typing.get_args(field_type):
            if a is type(None):
                continue
            try:
                return _convert(value, a)
            except (TypeError, ValueError):
                continue
        return value
    if field_type in (int, float, str, bool) and value is not None:
        return field_type(value)
    if origin is frozenset and isinstance(value, (list, tuple, set)):
        return frozenset(value)
    return value


def _drop_tpu_only(cls, data: Dict[str, Any]) -> Dict[str, Any]:
    """The UNet config without the JAX package's TPU-only keys: each is
    dropped, ``remat_max_ds`` and ``remat_policy`` only when null."""
    from vista_tpu_torch.models.unet import VideoUNetConfig

    if cls is not VideoUNetConfig or not set(UNET_TPU_ONLY) & set(data):
        return data
    for key in ("remat_max_ds", "remat_policy"):
        if data.get(key) is not None:
            raise ValueError(f"engine.unet.{key}={data[key]!r}: the port remats every block "
                             "whole; only null is accepted")
    if "attn_backend" in data:
        print(f"note: engine.unet.attn_backend={data['attn_backend']!r} is a TPU setting and "
              "has no effect here (the card runs the port's kernels, the CPU their plain "
              "versions)")
    return {k: v for k, v in data.items() if k not in UNET_TPU_ONLY}


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Build a (nested) dataclass from a plain dict; unknown keys raise."""
    data = _drop_tpu_only(cls, data)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"{cls.__name__}: unknown config keys {sorted(unknown)}")
    hints = typing.get_type_hints(cls)
    return cls(**{name: _convert(value, hints.get(name, Any)) for name, value in data.items()})


def to_dict(cfg) -> Dict[str, Any]:
    """Dataclass -> plain JSON/YAML-safe dict."""
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (tuple, list)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, frozenset):
        return sorted(cfg)
    return cfg


def _deep_merge(base: Dict, extra: Dict) -> Dict:
    out = dict(base)
    for k, v in extra.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_scalar(s: str):
    try:
        return json.loads(s)
    except (json.JSONDecodeError, ValueError):
        return s


def apply_overrides(data: Dict, overrides: Sequence[str]) -> Dict:
    """Apply ``a.b.c=value`` dotlist overrides (values parsed as JSON, else
    taken as strings)."""
    out = json.loads(json.dumps(data))
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, value = ov.partition("=")
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_scalar(value)
    return out


def load_config(cls: Type[T], paths: Sequence[str] = (), overrides: Sequence[str] = (),
                base: Optional[Dict] = None) -> T:
    """Merge YAML files left to right, apply dotlist overrides, build ``cls``."""
    import yaml

    data: Dict = dict(base or {})
    for p in paths:
        with open(p) as f:
            data = _deep_merge(data, yaml.safe_load(f) or {})
    return from_dict(cls, apply_overrides(data, overrides))


def save_config(cfg, path: str) -> None:
    """Write the port's own fields as YAML."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)
