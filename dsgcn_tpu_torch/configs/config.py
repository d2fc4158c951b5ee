"""Layered python-dict config system.

Keeps the *behavior* of the reference's mmcv Config (SURVEY §5.6): python
config files with ``_base_`` inheritance where leaf dicts override base dicts
key-by-key, a ``_delete_=True`` escape hatch to replace instead of merge, and
work_dir defaulting from the config filename — with no mmcv dependency and
validated references (a missing ``_base_`` is an immediate error, unlike the
reference's broken committed configs, SURVEY §0.2).
"""
from __future__ import annotations

import copy
import json
import os
import types
from typing import Any, Dict

RESERVED = {"_base_", "__builtins__"}


def _exec_config(path: str) -> Dict[str, Any]:
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"config not found: {path}")
    ns: Dict[str, Any] = dict(__file__=path)
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    exec(code, ns)
    return {k: v for k, v in ns.items()
            if not k.startswith("__") and not isinstance(v, types.ModuleType)}


def merge_dict(base: Dict, override: Dict) -> Dict:
    """Recursive merge: override wins; dicts merge unless _delete_ is set."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if (k in out and isinstance(out[k], dict) and isinstance(v, dict)
                and not v.get("_delete_", False)):
            out[k] = merge_dict(out[k], v)
        else:
            v = copy.deepcopy(v)
            if isinstance(v, dict):
                v.pop("_delete_", None)
            out[k] = v
    return out


class Config(dict):
    """dict with attribute access, loaded from layered python files."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        raw = _exec_config(path)
        bases = raw.pop("_base_", [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for b in bases:
            bpath = os.path.join(os.path.dirname(os.path.abspath(path)), b)
            merged = merge_dict(merged, dict(cls.fromfile(bpath)))
        merged = merge_dict(merged, raw)
        cfg = cls(merged)
        cfg.setdefault(
            "work_dir",
            os.path.join("./work_dirs",
                         os.path.splitext(os.path.basename(path))[0]))
        return cfg

    def dump(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self, f, indent=2, default=repr)
