"""Lightweight yacs-style config node.

Reference analog: yacs ``CfgNode`` as used by ``scripts/default_config.py``
(reference ``default_config.py:1-112``). We provide the same three-level
precedence: code defaults -> YAML overlay (``merge_from_file``) -> CLI dotlist
(``merge_from_list``), with type checking on merge.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import yaml


class ConfigNode(dict):
    """A dict with attribute access, key freezing, and typed merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    # -- attribute access ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    # -- merging ---------------------------------------------------------
    def merge_from_other(self, other: "ConfigNode", path: str = "") -> None:
        for k, v in other.items():
            full = f"{path}.{k}" if path else k
            if k not in self:
                raise KeyError(f"Unknown config key: {full}")
            cur = self[k]
            if isinstance(cur, ConfigNode):
                if not isinstance(v, (dict, ConfigNode)):
                    raise TypeError(f"Cannot overwrite config section {full} with a scalar")
                cur.merge_from_other(ConfigNode(dict(v)), full)
            else:
                self[k] = _coerce(v, cur, full)

    def merge_from_file(self, yaml_path: str) -> None:
        with open(yaml_path, "r") as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_other(ConfigNode(data))

    def merge_from_list(self, opts: List[Any]) -> None:
        """Merge a dotlist: ["train.lr", 0.01, "model.name", "resnet50"]."""
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            parts = str(key).split(".")
            node = self
            for p in parts[:-1]:
                node = node[p]
                if not isinstance(node, ConfigNode):
                    raise KeyError(f"{key}: {p} is not a config section")
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            if isinstance(value, str):
                value = _parse_literal(value)
            node[leaf] = _coerce(value, node[leaf], key)

    def clone(self) -> "ConfigNode":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: v.to_dict() if isinstance(v, ConfigNode) else v for k, v in self.items()
        }

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def freeze(self) -> None:  # API-compat no-op (keys are always frozen on merge)
        pass


def _parse_literal(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


#: Knobs declared as a bool|str union (False | True | string payload).
#: Only these may cross the bool<->str boundary in _coerce — every other
#: bool knob must stay strictly typed so a YAML typo like
#: ``cuda.fused_eval: "ture"`` raises instead of silently becoming truthy.
_BOOL_STR_UNION_KEYS = frozenset({"data.decode_cache"})


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Type-check a replacement value against the default, yacs-style."""
    if old is None or value is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            # truthy/falsey words coerce to bool for every knob (yacs-style
            # CLI convenience); arbitrary strings are only legal on the
            # declared bool|str unions (data.decode_cache: dir path)
            low = value.strip().lower()
            if low in ("true", "yes", "on", "1"):
                return True
            if low in ("false", "no", "off", "0", ""):
                return False
            if key in _BOOL_STR_UNION_KEYS:
                return value
        raise TypeError(f"{key}: expected bool, got {value!r}")
    if isinstance(old, float) and isinstance(value, (int, float)):
        return float(value)
    if isinstance(old, float) and isinstance(value, str):
        # PyYAML leaves '1e-4'-style scientific notation as a string
        # (its float resolver wants a dot); yacs accepted these via
        # literal_eval — keep CLI overrides like 'train.lr 3e-4' working
        try:
            return float(value)
        except ValueError:
            raise TypeError(f"{key}: expected float, got {value!r}")
    if isinstance(old, int) and isinstance(value, int):
        return value
    if isinstance(old, str) and isinstance(value, str):
        return value
    if (isinstance(old, str) and isinstance(value, bool)
            and key in _BOOL_STR_UNION_KEYS):
        # the other direction of the bool|str union: a knob previously set
        # to a path (data.decode_cache) can be flipped back to a bool
        return value
    if isinstance(old, (list, tuple)):
        if isinstance(value, (list, tuple)):
            return list(value)
        raise TypeError(f"{key}: expected list, got {type(value).__name__}")
    if type(old) is type(value):
        return value
    raise TypeError(
        f"{key}: expected {type(old).__name__}, got {type(value).__name__} ({value!r})"
    )
