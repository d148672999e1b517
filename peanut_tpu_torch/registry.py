"""Registries and the dict-config builder (the port's copy of
``peanut_tpu.registry``).

Components register by name and build from ``{'type': Name, **kwargs}``
dicts (mmcv's convention), which lets tests swap in fake components.  No
import-time magic and no scopes: a module registers its classes when it is
imported (``models/encoder_decoder.py`` imports the zoo's modules).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, Callable] = {}

    def register(self, cls_or_name=None, *, name: Optional[str] = None):
        """Use as ``@REG.register()``, ``@REG.register``,
        ``@REG.register("Name")`` or ``REG.register(cls)``; a name taken by
        another class raises KeyError."""
        def _do(cls, key):
            key = key or cls.__name__
            if key in self._modules and self._modules[key] is not cls:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._modules[key] = cls
            return cls

        if cls_or_name is None:
            return lambda cls: _do(cls, name)
        if isinstance(cls_or_name, str):
            return lambda cls: _do(cls, cls_or_name)
        return _do(cls_or_name, name)

    def get(self, key: str) -> Callable:
        if key not in self._modules:
            raise KeyError(
                f"{key!r} not found in registry {self.name!r}; "
                f"available: {sorted(self._modules)}")
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._modules

    def keys(self):
        return self._modules.keys()

    def build(self, cfg: Dict[str, Any], **extra) -> Any:
        """Build from ``{'type': name, **kwargs}`` (mmcv convention)."""
        if not isinstance(cfg, dict) or "type" not in cfg:
            raise TypeError(
                f"cfg must be a dict with a 'type' key, got {cfg!r}")
        cfg = dict(cfg)
        typ = cfg.pop("type")
        cls = self.get(typ) if isinstance(typ, str) else typ
        return cls(**cfg, **extra)


# the global registries, as the JAX package's
BACKBONES = Registry("backbones")
NECKS = Registry("necks")
HEADS = Registry("heads")
LOSSES = Registry("losses")
SEGMENTORS = Registry("segmentors")
DATASETS = Registry("datasets")
PIPELINES = Registry("pipelines")
