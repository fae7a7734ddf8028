"""Minimal Hydra-style config system: YAML per stage + dotted CLI overrides.

The PyTorch port keeps its own copy of ``skix.config`` (same ``Cfg`` node,
same ``configs/<stage>.yaml`` layout, same ``key.sub=value`` overrides and
``${a.b}`` interpolation), so that ``skix_torch`` imports nothing of the
JAX package. Two differences:

- ``yaml`` is imported only where a YAML file or an override string is
  parsed, so a config given as a mapping needs no PyYAML;
- a ``cli_main`` entry point also accepts a mapping in place of ``argv``.
"""

from __future__ import annotations

import copy
import functools
import os
import re
import sys
from pathlib import Path
from typing import Any, Iterable, Mapping

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class Cfg:
    """Nested attribute-access config node (a thin, typed dict wrapper)."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = Cfg(v) if isinstance(v, Mapping) else v

    # -- mapping protocol -------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(f"config has no key {key!r}; keys: {list(self._data)}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = Cfg(value) if isinstance(value, Mapping) else value

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self.__setattr__(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other) -> bool:
        if isinstance(other, Cfg):
            return self.to_dict() == other.to_dict()
        if isinstance(other, Mapping):
            return self.to_dict() == dict(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"Cfg({self.to_dict()!r})"

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, Cfg) else v for k, v in self._data.items()}

    # -- dotted access ----------------------------------------------------
    def select(self, dotted: str, default: Any = ...) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Cfg) and part in node:
                node = node[part]
            else:
                if default is ...:
                    raise KeyError(dotted)
                return default
        return node

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Cfg):
                node[part] = Cfg()
            node = node[part]
        node[parts[-1]] = value


def _parse_value(text: str) -> Any:
    """Parse a CLI override value with YAML semantics (int/float/bool/list)."""
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _resolve_interpolations(root: Cfg, node: Any, _depth: int = 0) -> Any:
    if _depth > 16:
        raise ValueError("config interpolation recursion limit exceeded")
    if isinstance(node, Cfg):
        for k in list(node.keys()):
            node[k] = _resolve_interpolations(root, node[k], _depth + 1)
        return node
    if isinstance(node, list):
        return [_resolve_interpolations(root, v, _depth + 1) for v in node]
    if isinstance(node, str):
        def repl(m: re.Match) -> str:
            val = root.select(m.group(1))
            val = _resolve_interpolations(root, copy.copy(val), _depth + 1)
            return str(val)

        full = _INTERP_RE.fullmatch(node)
        if full:  # whole-string interpolation preserves type
            return _resolve_interpolations(root, copy.copy(root.select(full.group(1))), _depth + 1)
        return _INTERP_RE.sub(repl, node)
    return node


def default_config_dir() -> Path:
    env = os.environ.get("SKIX_CONFIG_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parent.parent / "configs"


def config_from_mapping(data: Mapping[str, Any]) -> Cfg:
    """A resolved ``Cfg`` from an in-memory mapping (no YAML involved)."""
    cfg = Cfg(copy.deepcopy(dict(data)))
    _resolve_interpolations(cfg, cfg)
    return cfg


def load_config(
    name: str,
    overrides: Iterable[str] = (),
    config_dir: str | Path | None = None,
) -> Cfg:
    """Load ``configs/<name>.yaml``, apply ``key=value`` overrides, resolve
    ``${a.b}`` interpolations."""
    import yaml

    cdir = Path(config_dir) if config_dir else default_config_dir()
    path = cdir / f"{name}.yaml"
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = Cfg(raw)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, val = ov.partition("=")
        cfg.set_dotted(key.strip(), _parse_value(val.strip()))
    _resolve_interpolations(cfg, cfg)
    return cfg


def cli_main(name: str):
    """Decorator mirroring ``@hydra.main``: parses ``sys.argv`` overrides and
    calls the wrapped function with the loaded config. The wrapper also
    takes a mapping (or ``Cfg``) in place of ``argv``: the config is then
    that mapping, and no file is read."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(argv: list[str] | Mapping[str, Any] | Cfg | None = None):
            if isinstance(argv, Cfg):
                argv = argv.to_dict()
            if isinstance(argv, Mapping):
                return fn(config_from_mapping(argv))
            args = list(sys.argv[1:] if argv is None else argv)
            config_dir = None
            overrides = []
            for a in args:
                if a.startswith("--config-dir="):
                    config_dir = a.split("=", 1)[1]
                else:
                    overrides.append(a)
            cfg = load_config(name, overrides, config_dir=config_dir)
            return fn(cfg)

        return wrapper

    return deco


def iter_person_dirs(root, cfg=None):
    """Sorted person directories under ``root``, filtered by the
    ``only_persons`` override (comma-separated names or a list)."""
    only = cfg.get("only_persons") if cfg is not None else None
    if isinstance(only, str):
        only = [p.strip() for p in only.split(",") if p.strip()]
    dirs = sorted(d for d in Path(root).iterdir() if d.is_dir())
    if only:
        keep = set(only)
        dirs = [d for d in dirs if d.name in keep]
    return dirs
