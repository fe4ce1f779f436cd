"""Hierarchical config system with Hydra-like composition (the JAX
package's ``core/config.py``).

A small engine that keeps Hydra's ergonomics over the repo's
``configs/``:

- group composition: ``defaults: [dataset: simcol, model: small, ...]``
  resolved from a config root directory;
- CLI overrides ``key=value``, ``group=option`` (reselects a group file),
  and ``++key=value`` (force-add);
- ``${a.b.c}`` interpolation;
- experiment run-dir templating and config/override snapshots
  (``configs/experiments/.../{config,overrides}.yaml``).

Files, override values and snapshots go through the port's own YAML
subset (``core.yamlsubset``), which follows PyYAML's YAML 1.1 rules; the
port never imports ``yaml``.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any

from . import yamlsubset

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class Config(dict):
    """dict with attribute access, nested."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_plain(self) -> Any:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o
        return unwrap(self)


def _get_path(cfg: dict, dotted: str) -> Any:
    node: Any = cfg
    for part in dotted.split("."):
        node = node[part]
    return node


def _set_path(cfg: dict, dotted: str, value: Any, create: bool = True) -> None:
    parts = dotted.split(".")
    node = cfg
    for part in parts[:-1]:
        if part not in node:
            if not create:
                raise KeyError(dotted)
            node[part] = Config()
        node = node[part]
    if not create and parts[-1] not in node:
        raise KeyError(dotted)
    node[parts[-1]] = value


def _parse_value(text: str) -> Any:
    """YAML-parse a scalar override value.

    YAML 1.1 treats ``1e-5`` (no dot) as a string; Hydra-style overrides
    expect a float, so numeric-looking strings are coerced. Text the YAML
    subset refuses stays text.
    """
    try:
        value = yamlsubset.load(text, "<override>")
    except yamlsubset.YamlSubsetError:
        return text
    if isinstance(value, str):
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                continue
    return value


def _deep_merge(base: dict, extra: dict) -> dict:
    for k, v in extra.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, dict):
            _deep_merge(base[k], v)
        else:
            base[k] = copy.deepcopy(v)
    return base


def _resolve_interpolations(cfg: dict) -> None:
    # Targets are resolved on demand (recursively, with a cycle guard):
    # dict-order resolution would hand out the raw '${...}' template for
    # any forward reference (a key interpolating one defined later).
    resolving: set[str] = set()

    def resolve_target(path: str) -> Any:
        if path in resolving:
            raise ValueError(f"interpolation cycle through ${{{path}}}")
        target = _get_path(cfg, path)
        if isinstance(target, str) and _INTERP_RE.search(target):
            resolving.add(path)
            try:
                target = resolve_str(target)
            finally:
                resolving.discard(path)
        return target

    def resolve_str(value: str) -> Any:
        if _INTERP_RE.fullmatch(value):
            # Whole-string interpolation preserves type.
            return resolve_target(value[2:-1])
        return _INTERP_RE.sub(
            lambda m: str(resolve_target(m.group(1))), value)

    def resolve(value: Any) -> Any:
        if isinstance(value, str):
            return resolve_str(value)
        if isinstance(value, dict):
            for k in value:
                value[k] = resolve(value[k])
            return value
        if isinstance(value, list):
            return [resolve(v) for v in value]
        return value
    resolve(cfg)


def load_yaml(path: str) -> dict:
    return yamlsubset.load_file(path) or {}


def compose(config_root: str, config_name: str = "default",
            overrides: list[str] | None = None) -> Config:
    """Compose ``<config_root>/<config_name>.yaml`` + group defaults + CLI.

    Group selection overrides (``model=large``) are applied before file
    loading; value overrides (``model.encoder_lr=1e-5``, ``++new.key=1``)
    after.
    """
    overrides = list(overrides or [])
    root_cfg = load_yaml(os.path.join(config_root, f"{config_name}.yaml"))

    defaults = root_cfg.pop("defaults", [])
    group_choice: dict[str, str] = {}
    for entry in defaults:
        if entry == "_self_":
            continue
        if isinstance(entry, dict):
            group_choice.update({str(k): str(v) for k, v in entry.items()})
        else:
            group_choice[str(entry)] = "default"

    value_overrides: list[tuple[str, str, bool]] = []
    for ov in overrides:
        force = ov.startswith("++")
        body = ov[2:] if force else (ov[1:] if ov.startswith("+") else ov)
        if "=" not in body:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = body.split("=", 1)
        if key in group_choice and "." not in key:
            group_choice[key] = val  # group reselect
        else:
            value_overrides.append((key, val, force or ov.startswith("+")))

    cfg: dict = {}
    for group, option in group_choice.items():
        group_file = os.path.join(config_root, group, f"{option}.yaml")
        cfg[group] = load_yaml(group_file)
    # Root-level keys (hydra block etc.) merge on top.
    _deep_merge(cfg, root_cfg)

    for key, val, force in value_overrides:
        _set_path(cfg, key, _parse_value(val), create=force)

    _resolve_interpolations(cfg)
    wrapped = Config.wrap(cfg)
    wrapped["_groups_"] = Config.wrap(group_choice)
    wrapped["_overrides_"] = list(overrides)
    return wrapped


def run_dir(cfg: Config, template: str) -> str:
    """Expand a ``${...}``-templated run directory path."""
    def repl(m: re.Match) -> str:
        return str(_get_path(cfg, m.group(1)))
    return _INTERP_RE.sub(repl, template)


def snapshot(cfg: Config, directory: str) -> None:
    """Write config.yaml / overrides.yaml snapshots (Hydra-style record)."""
    os.makedirs(directory, exist_ok=True)
    plain = {k: v for k, v in cfg.to_plain().items()
             if k not in ("_groups_", "_overrides_")}
    for name, value in (("config.yaml", plain),
                        ("overrides.yaml", list(cfg.get("_overrides_", [])))):
        with open(os.path.join(directory, name), "w", encoding="utf-8") as f:
            f.write(yamlsubset.dump(value))
