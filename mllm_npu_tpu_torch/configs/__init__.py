"""``_target_`` YAML module trees and a small ``instantiate`` (the port's
own copy of ``mllm_npu_tpu/configs/__init__.py``; the port's YAMLs name
the port's builders)."""

from __future__ import annotations

import importlib
from pathlib import Path
from typing import Any

import yaml

CONFIG_DIR = Path(__file__).parent


def passthrough_dict(**kw) -> dict:
    return kw


def resolve_target(path: str):
    parts = path.split(".")
    # import the longest importable module prefix, then getattr the rest
    for i in range(len(parts), 0, -1):
        try:
            mod = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        obj = mod
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(f"cannot resolve target {path!r}")


def _is_target_cfg(cfg: Any) -> bool:
    return isinstance(cfg, dict) and "_target_" in cfg


def instantiate(cfg: Any, **overrides):
    """``hydra.utils.instantiate``'s core, as the port's YAMLs use it:
    resolve ``_target_``, instantiate children that have one, and call the
    target with the remaining keys plus ``overrides``."""
    if not _is_target_cfg(cfg):
        raise ValueError("instantiate() requires a dict with _target_")
    kwargs = {k: instantiate(v) if _is_target_cfg(v) else v
              for k, v in cfg.items() if k != "_target_"}
    kwargs.update(overrides)
    return resolve_target(cfg["_target_"])(**kwargs)


def load_config(path) -> dict:
    """Load a YAML file; a relative path that does not exist is looked up
    under this package's ``configs/``."""
    path = Path(path)
    if not path.exists() and (CONFIG_DIR / path).exists():
        path = CONFIG_DIR / path
    with open(path) as f:
        return yaml.safe_load(f)
