"""Python-file config system with `_base_` inheritance and CLI overrides
(a copy of `vitadapter/utils/config.py`, which imports no framework).

Parity target: the reference's mmcv config layer (SURVEY §5.6): python config
files composed via `_base_` lists, `_delete_=True` subtree replacement, and
`--cfg-options key.sub=value` dotted overrides
(reference `detection/train.py:51-67`).
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List, Optional


class Config(dict):
    """A dict with attribute access and the mm-style composition rules."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) else v

    def __setattr__(self, k, v):
        self[k] = v

    # ---- loading ----

    @staticmethod
    def fromfile(path: str) -> "Config":
        path = os.path.abspath(path)
        ns: Dict[str, Any] = {}
        with open(path) as f:
            code = f.read()
        exec(compile(code, path, "exec"), ns)
        cfg = {k: v for k, v in ns.items()
               if not k.startswith("__") and not callable(v)
               and not isinstance(v, type(os))}
        bases = cfg.pop("_base_", [])
        if isinstance(bases, str):
            bases = [bases]
        merged: Dict[str, Any] = {}
        for b in bases:
            base_cfg = Config.fromfile(os.path.join(os.path.dirname(path), b))
            merged = _merge(merged, base_cfg)
        merged = _merge(merged, cfg)
        return Config(merged)

    def merge_from_options(self, options: Dict[str, Any]) -> "Config":
        """Apply dotted-key overrides: {'model.backbone.depth': 24}."""
        for key, value in options.items():
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                nxt = node.get(p)
                if not isinstance(nxt, dict):
                    nxt = {}
                    node[p] = nxt
                node = nxt
            node[parts[-1]] = _maybe_literal(value)
        return self


def _maybe_literal(v):
    if isinstance(v, str):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


def _merge(base: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, Any]:
    """Deep merge `new` onto `base`; a dict with `_delete_=True` replaces the
    base subtree entirely."""
    out = copy.deepcopy(dict(base))
    for k, v in new.items():
        if isinstance(v, dict):
            v = dict(v)
            if v.pop("_delete_", False) or not isinstance(out.get(k), dict):
                out[k] = _merge({}, v)
            else:
                out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def parse_cfg_options(pairs: Optional[List[str]]) -> Dict[str, Any]:
    """['a.b=1', 'c=[2,3]'] -> {'a.b': 1, 'c': [2, 3]}."""
    out: Dict[str, Any] = {}
    for item in pairs or []:
        key, _, val = item.partition("=")
        out[key.strip()] = _maybe_literal(val.strip())
    return out
