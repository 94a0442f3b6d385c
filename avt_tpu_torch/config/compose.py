"""Config composition: defaults list, group loading, interpolation.

Counterpart of avt_tpu/config/compose.py (`load_yaml`, `Composer`,
`compose`, `resolve_interpolations`), on the port's own YAML reader
(`overrides.yaml_load`) in place of PyYAML: ${...} interpolations are
stashed around the parse as the JAX package stashes them, and the
resolvers' literal arguments are read by the same reader.
"""
from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

from avt_tpu_torch.config.overrides import (
    Override,
    YAMLSubsetError,
    parse_override,
    parse_value,
    plain,
    restore_interpolations,
    stash_interpolations,
    yaml_load,
)


def _yaml_load_with_interp(text: str):
    """YAML-load text where ${...} interpolations may appear in flow
    contexts YAML itself rejects: stash them as tokens, parse, restore."""
    prepared, tokens = stash_interpolations(text)
    return restore_interpolations(plain(yaml_load(prepared)), tokens)


def load_yaml(fpath: Union[str, Path]) -> Dict:
    with open(fpath, "r") as fin:
        data = _yaml_load_with_interp(fin.read())
    return data or {}


def _set_path(cfg: Dict, dotted: str, value: Any, *, add: bool = False):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or node[p] is None:
            node[p] = {}
        node = node[p]
    key = parts[-1]
    if not add and key not in node:
        raise KeyError(f"Key {dotted!r} not in config (use +{dotted}= to add it)")
    if isinstance(node.get(key), dict) and isinstance(value, dict):
        _merge(node[key], value)
    else:
        node[key] = value


def _get_path(cfg: Dict, dotted: str) -> Any:
    node = cfg
    for p in dotted.split("."):
        if not isinstance(node, dict) or p not in node:
            raise KeyError(dotted)
        node = node[p]
    return node


def _del_path(cfg: Dict, dotted: str):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if not isinstance(node, dict) or p not in node:
            return  # nothing to delete
        node = node[p]
    if isinstance(node, dict):
        node.pop(parts[-1], None)


def _merge(dst: Dict, src: Dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


class Composer:
    """Loads config groups from a conf/ directory and applies overrides."""

    def __init__(self, conf_dir: Union[str, Path]):
        self.conf_dir = Path(conf_dir)

    def _load_group(self, group: str, option: str) -> Dict:
        fpath = self.conf_dir / group / f"{option}.yaml"
        if not fpath.exists():
            raise FileNotFoundError(f"No config {fpath} for group {group!r} option {option!r}")
        return load_yaml(fpath)

    def compose(
        self,
        config_name: str = "config",
        overrides: Sequence[Union[str, Override]] = (),
        resolve: bool = True,
        extra_resolvers: Optional[Dict] = None,
    ) -> Dict:
        """Hydra-semantics composition.

        Group overrides substitute into the defaults list (the switched
        option replaces the default option's whole contribution; later
        defaults entries, e.g. child groups, still land inside it in list
        order). `+group@key=option` additions append new defaults entries.
        Plain key=value overrides apply after all groups, in their order.
        """
        cfg = load_yaml(self.conf_dir / f"{config_name}.yaml")
        defaults = cfg.pop("defaults", [])

        switches: Dict[str, tuple] = {}   # target_key -> (group, option)
        additions: List[tuple] = []       # (group, target_key, option)
        value_ovs: List[Override] = []
        for ov in overrides:
            if isinstance(ov, str):
                ov = parse_override(ov)
            if ov.sweep_values is not None:
                raise ValueError(f"Sweep override {ov.key} must be expanded before compose")
            if ov.delete:
                value_ovs.append(ov)
            elif ov.group is not None:
                # group@key=option: compose a group instance at `key`
                entry = (ov.group, ov.key, str(ov.value))
                if ov.add:
                    additions.append(entry)
                else:
                    switches[ov.key] = (ov.group, str(ov.value))
            elif "/" in ov.key and isinstance(ov.value, str) and not ov.value.startswith("$"):
                # group switch: model/backbone=identity
                switches[ov.key.replace("/", ".")] = (ov.key, str(ov.value))
            elif (
                isinstance(ov.value, str)
                and not ov.value.startswith("$")
                and not ov.add
                and "." not in ov.key
                and (self.conf_dir / ov.key).is_dir()
            ):
                # top-level group switch: train_eval_op=pred_future_feat
                switches[ov.key] = (ov.key, str(ov.value))
            else:
                value_ovs.append(ov)

        used = set()
        for entry in defaults:
            if isinstance(entry, str):
                group, option = entry.rsplit("/", 1)
                target_key = group.replace("/", ".")
            else:
                (group_spec, option), = entry.items()
                if "@" in group_spec:
                    group, target_key = group_spec.split("@", 1)
                else:
                    group, target_key = group_spec, group_spec.replace("/", ".")
            if target_key in switches:
                group, option = switches[target_key]
                used.add(target_key)
            _set_path(cfg, target_key, self._load_group(group, option), add=True)
        # switches of groups absent from the defaults list, and additions:
        # fresh nodes at their target (replace anything there)
        for target_key, (group, option) in switches.items():
            if target_key in used:
                continue
            loaded = self._load_group(group, option)
            _del_path(cfg, target_key)
            _set_path(cfg, target_key, loaded, add=True)
        for group, target_key, option in additions:
            loaded = self._load_group(group, option)
            _del_path(cfg, target_key)
            _set_path(cfg, target_key, loaded, add=True)

        for ov in value_ovs:
            if ov.delete:
                _del_path(cfg, ov.key)
            else:
                _set_path(cfg, ov.key, ov.value, add=ov.add)
        if resolve:
            cfg = resolve_interpolations(cfg, extra_resolvers)
        return cfg


# ----------------------------------------------------------- interpolation
_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


def compose(
    conf_dir: Union[str, Path],
    config_name: str = "config",
    overrides: Sequence[Union[str, Override]] = (),
    resolve: bool = True,
) -> Dict:
    """`config_name` of `conf_dir` with `overrides` applied: Composer(conf_dir).compose."""
    return Composer(conf_dir).compose(config_name, overrides, resolve)


def _is_literal(a: str) -> bool:
    """Whether a resolver argument reads as a YAML int, float or bool."""
    try:
        v = yaml_load(a.strip())
    except YAMLSubsetError:
        return False
    return isinstance(v, (int, float, bool))


def resolve_interpolations(cfg: Dict, extra_resolvers: Optional[Dict] = None) -> Dict:
    """Resolve ${a.b} refs and ${resolver:args} calls through the tree.

    Resolvers: minus, times_int, plus cwd.
    """
    cfg = copy.deepcopy(cfg)
    resolvers = {
        "minus": lambda a, b: a - b,
        "times_int": lambda a, b: int(a * b),
    }
    resolvers.update(extra_resolvers or {})

    def resolve_value(val, stack):
        if isinstance(val, str):
            return resolve_str(val, stack)
        if isinstance(val, dict):
            return {k: resolve_value(v, stack) for k, v in val.items()}
        if isinstance(val, list):
            return [resolve_value(v, stack) for v in val]
        return val

    def lookup(expr, stack):
        if expr in stack:
            raise ValueError(f"Interpolation cycle at {expr}")
        if ":" in expr:
            name, argstr = expr.split(":", 1)
            if name in resolvers:
                args = [
                    resolve_str(f"${{{a.strip()}}}", stack | {expr})
                    if not _is_literal(a) else parse_value(a)
                    for a in argstr.split(",")
                ]
                return resolvers[name](*args)
        if expr == "cwd":
            return os.getcwd()
        raw = _get_path(cfg, expr)
        return resolve_value(raw, stack | {expr})

    def resolve_str(s, stack):
        # iterate: nested ${a:${b},${c}} resolves innermost-first
        for _ in range(10):
            m = _INTERP_RE.fullmatch(s.strip())
            if m:  # full-string interpolation preserves the value's type
                resolved = lookup(m.group(1), stack)
                if isinstance(resolved, str) and "${" in resolved:
                    s = resolved
                    continue
                return resolved
            if "${" not in s:
                return s
            s = _INTERP_RE.sub(lambda mm: str(lookup(mm.group(1), stack)), s)
        raise ValueError(f"Interpolation did not converge: {s!r}")

    return resolve_value(cfg, frozenset())
