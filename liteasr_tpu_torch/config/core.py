"""Minimal Hydra/OmegaConf-equivalent composition engine.

Implements the subset of behavior the reference relies on
(liteasr/train.py:21-38, liteasr/config/config.yaml:1-7, registry decorators
storing dataclasses in the Hydra ConfigStore, e.g. liteasr/models/__init__.py:79-82):

* a ``ConfigStore`` mapping (group, name) -> dataclass node
* YAML config groups with ``defaults`` composition
* ``???`` (MISSING) required fields
* ``${a.b.c}`` interpolation (OmegaConf ``II``)
* dotted CLI overrides (``optimization.max_epoch=3``) and group selection
  (``model=my_U2``)
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import os
import re
from typing import Any, Dict, List, Optional

MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def II(path: str) -> str:
    """OmegaConf-style interpolation marker."""
    return "${" + path + "}"


class DotDict(dict):
    """Dict with attribute access; nested dicts are wrapped on read.

    The wrapper is cached back into the parent so attribute-chained
    mutation (``cfg.a.b = x``) persists.
    """

    def __getattr__(self, key: str) -> Any:
        try:
            val = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        if isinstance(val, dict) and not isinstance(val, DotDict):
            val = DotDict(val)
            self[key] = val
        elif isinstance(val, list):
            return [_wrap(v) for v in val]
        return val

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        del self[key]


def _wrap(val: Any) -> Any:
    if isinstance(val, DotDict):
        return val
    if isinstance(val, dict):
        return DotDict(val)
    if isinstance(val, list):
        return [_wrap(v) for v in val]
    return val


def _node_to_dict(node: Any) -> Any:
    """Convert a dataclass (class or instance) to a plain dict tree."""
    if isinstance(node, type) and dataclasses.is_dataclass(node):
        node = node()
    if dataclasses.is_dataclass(node):
        out = {}
        for f in dataclasses.fields(node):
            out[f.name] = _node_to_dict(getattr(node, f.name))
        return out
    if isinstance(node, enum.Enum):
        return node.value
    if isinstance(node, dict):
        return {k: _node_to_dict(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_node_to_dict(v) for v in node]
    return node


class ConfigStore:
    """(group, name) -> dataclass registry. Singleton like Hydra's."""

    _instance: Optional["ConfigStore"] = None

    def __init__(self) -> None:
        self._store: Dict[str, Dict[str, Any]] = {}

    @classmethod
    def instance(cls) -> "ConfigStore":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def store(self, name: str, node: Any, group: Optional[str] = None) -> None:
        self._store.setdefault(group or "", {})[name] = node

    def get(self, name: str, group: Optional[str] = None) -> Any:
        return self._store.get(group or "", {}).get(name)

    def names(self, group: Optional[str] = None) -> List[str]:
        return sorted(self._store.get(group or "", {}).keys())


def load_yaml(path: str) -> dict:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def _deep_merge(base: dict, over: dict) -> dict:
    """Merge `over` into `base` (new dict). Lists are replaced, not merged."""
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _get_path(tree: dict, path: str) -> Any:
    cur: Any = tree
    for part in path.split("."):
        if isinstance(cur, list):
            cur = cur[int(part)]
        elif isinstance(cur, dict):
            if part not in cur:
                raise KeyError(path)
            cur = cur[part]
        else:
            raise KeyError(path)
    return cur


def _set_path(tree: dict, path: str, value: Any) -> None:
    parts = path.split(".")
    cur: Any = tree
    for part in parts[:-1]:
        if isinstance(cur, list):
            cur = cur[int(part)]
        else:
            if part not in cur or not isinstance(cur[part], (dict, list)):
                cur[part] = {}
            cur = cur[part]
    if isinstance(cur, list):
        cur[int(parts[-1])] = value
    else:
        cur[parts[-1]] = value


def resolve(tree: dict, max_passes: int = 16) -> dict:
    """Resolve ``${a.b}`` interpolations in-place-ish (returns new tree)."""
    tree = copy.deepcopy(tree)

    def resolve_value(val: Any) -> Any:
        if isinstance(val, str):
            full = _INTERP_RE.fullmatch(val)
            if full:
                try:
                    return _get_path(tree, full.group(1))
                except KeyError:
                    return val
            if _INTERP_RE.search(val):

                def sub(m: "re.Match[str]") -> str:
                    try:
                        return str(_get_path(tree, m.group(1)))
                    except KeyError:
                        return m.group(0)

                return _INTERP_RE.sub(sub, val)
        return val

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(resolve_value(v)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(resolve_value(v)) for v in node]
        return resolve_value(node)

    for _ in range(max_passes):
        new_tree = walk(tree)
        if new_tree == tree:
            break
        tree = new_tree
    return tree


def _default_config_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "yaml")


_GROUPS = ("task", "model", "criterion", "optimizer")


def _load_group(group: str, name: str, config_dir: str) -> dict:
    """Compose one group node: registered dataclass defaults + preset YAML."""
    cs = ConfigStore.instance()
    search_dirs = [os.path.join(config_dir, group)]
    builtin = os.path.join(_default_config_dir(), group)
    if builtin not in search_dirs:
        search_dirs.append(builtin)

    yaml_cfg: Optional[dict] = None
    for d in search_dirs:
        p = os.path.join(d, f"{name}.yaml")
        if os.path.isfile(p):
            yaml_cfg = load_yaml(p)
            break

    if yaml_cfg is None:
        node = cs.get(name, group=group)
        if node is None:
            raise ValueError(
                f"unknown {group} '{name}' (registered: {cs.names(group)})"
            )
        out = _node_to_dict(node)
        out["name"] = name
        return out

    # preset YAML; may inherit a registered schema via `defaults: [Base]`
    base: dict = {}
    for d in yaml_cfg.pop("defaults", []):
        if d == "_self_":
            continue
        node = cs.get(d, group=group)
        if node is None:
            base = _deep_merge(base, _load_group(group, d, config_dir))
        else:
            merged = _node_to_dict(node)
            merged["name"] = d
            base = _deep_merge(base, merged)
    return _deep_merge(base, yaml_cfg)


def parse_value(raw: str) -> Any:
    import yaml

    val = yaml.safe_load(raw)
    # YAML 1.1 treats "1e-3" (no dot) as a string; numbers should win
    if isinstance(val, str):
        try:
            return int(val)
        except ValueError:
            pass
        try:
            return float(val)
        except ValueError:
            pass
    return val


def compose(
    overrides: Optional[List[str]] = None,
    config_dir: Optional[str] = None,
    config_name: str = "config",
    base: Optional[dict] = None,
) -> DotDict:
    """Compose the full config tree.

    Mirrors the reference CLI surface: ``liteasr-train task=asr model=my_U2
    task.vocab=... optimization.max_epoch=3`` (reference README.md:84-108).
    """
    # defer to avoid cycles; importing registers component dataclasses
    import liteasr_tpu_torch  # noqa: F401

    overrides = list(overrides or [])
    config_dir = config_dir or _default_config_dir()

    cs = ConfigStore.instance()
    root = cs.get("liteasr_config")
    if root is None:
        from liteasr_tpu_torch.config import config_init

        config_init()
        root = cs.get("liteasr_config")
    tree = _node_to_dict(root)

    if base is not None:
        tree = _deep_merge(tree, copy.deepcopy(base))
    else:
        cfg_path = os.path.join(config_dir, f"{config_name}.yaml")
        file_cfg = load_yaml(cfg_path) if os.path.isfile(cfg_path) else {}
        file_cfg.pop("defaults", None)
        file_cfg.pop("hydra", None)
        tree = _deep_merge(tree, file_cfg)

    group_sel: Dict[str, str] = {}
    dotted: List[tuple] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' must be key=value")
        key, _, raw = ov.partition("=")
        key = key.strip()
        if key in _GROUPS:
            group_sel[key] = raw.strip()
        else:
            dotted.append((key, parse_value(raw)))

    for group, name in group_sel.items():
        tree[group] = _load_group(group, name, config_dir)

    for key, value in dotted:
        _set_path(tree, key, value)

    return DotDict(resolve(tree))


def to_dict(cfg: Any) -> Any:
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [to_dict(v) for v in cfg]
    return cfg


def to_yaml(cfg: Any) -> str:
    import yaml

    return yaml.safe_dump(to_dict(cfg), sort_keys=False)
