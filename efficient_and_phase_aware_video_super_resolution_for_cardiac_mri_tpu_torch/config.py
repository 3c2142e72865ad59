"""Config system: YAML files with dot-access and the name registries.

The port's copy of the JAX package's ``config.py``: every run is described by
one YAML file whose component blocks are ``{name: <ClassName>, kwargs:
{...}}``, instantiated by name from a registry, so the shipped configs load
unchanged.

PyYAML is imported only where a file is parsed (:func:`load_config`).  The
config snapshot a run writes is JSON text, which YAML parsers read as YAML, so
a run built from a config in code needs no PyYAML.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Iterable, Mapping


class Cfg(dict):
    """A dict with attribute access, recursively applied.

    ``cfg.dataset.kwargs.data_dir`` works, as does ``cfg['dataset']``.
    """

    def __init__(self, data: Mapping | None = None, **kwargs):
        super().__init__()
        merged = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Cfg):
            return value
        if isinstance(value, Mapping):
            return Cfg(value)
        if isinstance(value, list):
            return [Cfg._wrap(v) for v in value]
        if isinstance(value, tuple):
            return tuple(Cfg._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, Cfg._wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        self[name] = value

    def __delattr__(self, name: str):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def update(self, *args, **kwargs):  # keep wrapping on update
        for mapping in args:
            for k, v in dict(mapping).items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def to_dict(self) -> dict:
        def unwrap(value):
            if isinstance(value, Cfg):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return [unwrap(v) for v in value]
            return value

        return unwrap(self)

    def copy(self) -> "Cfg":
        return Cfg(copy.deepcopy(self.to_dict()))

    def to_yaml(self, filename: str | Path | None = None) -> str:
        """The config as JSON text (a subset of YAML), written to ``filename``
        when given."""
        text = json.dumps(self.to_dict(), indent=2, default=str) + "\n"
        if filename is not None:
            Path(filename).write_text(text)
        return text


def load_config(path: str | Path) -> Cfg:
    """Load a YAML config file into a :class:`Cfg`."""
    import yaml

    with open(path) as f:
        return Cfg(yaml.safe_load(f) or {})


class Registry:
    """A name → class registry for config-driven instantiation."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Any] = {}

    def register(self, name: str | None = None):
        def deco(obj):
            self._entries[name or obj.__name__] = obj
            return obj

        return deco

    def add(self, name: str, obj: Any):
        self._entries[name] = obj

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> Any:
        if name not in self._entries:
            raise KeyError(
                f"Unknown {self.kind} component {name!r}. "
                f"Available: {sorted(self._entries)}"
            )
        return self._entries[name]

    def names(self) -> Iterable[str]:
        return sorted(self._entries)

    def build(self, config: Mapping, *args, **extra_kwargs) -> Any:
        """Instantiate ``config.name`` with ``config.kwargs`` (plus extras)."""
        cls = self.get(config["name"])
        kwargs = dict(config.get("kwargs") or {})
        kwargs.update(extra_kwargs)
        return cls(*args, **kwargs)


# Registries of the components this slice of the port provides, populated by
# the subpackages at import time.
DATASETS = Registry("dataset")
DATALOADERS = Registry("dataloader")
NETS = Registry("net")
LOSSES = Registry("loss")
METRICS = Registry("metric")
PREDICTORS = Registry("predictor")
TRANSFORMS = Registry("transform")
