"""Model registry, counterpart of ``cnn_tpu/models/registry.py``."""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_model(name: str, **kwargs):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
