"""Model registry, counterpart of ``cnn_tpu/models/registry.py``."""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


# cnn_tpu families the port does not build yet (ROADMAP.md Queue 1)
UNPORTED = {"moecnn": "its MoE layer (nn/moe.py) and expert parallelism"}


def get_model(name: str, **kwargs):
    if name in UNPORTED:
        raise NotImplementedError(f"model family '{name}' is not ported "
                                  f"yet: {UNPORTED[name]}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
