"""Small tree utilities for params and state, counterpart of
``cnn_tpu/core/pytree.py``.

A tree is what the port's models and checkpoints hold: nested dicts,
lists and tuples whose leaves are tensors or numpy arrays
(``utils/checkpoint.py:model_trees``, a train state's ``params``). Dicts
are walked in sorted key order, as JAX walks them.
"""

from __future__ import annotations

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [] if tree is None else [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, t) for t in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return tree if tree is None else fn(tree)


def _size(x) -> int:
    return x.numel() if torch.is_tensor(x) else int(np.size(x))


def _itemsize(x) -> int:
    return x.element_size() if torch.is_tensor(x) else np.asarray(x).itemsize


def param_count(tree) -> int:
    """Total number of scalars in ``tree`` (the reference's per-layer
    ``Conv2D::get_params_num``, ``conv2d.cpp:238-240``, for the whole
    model)."""
    return sum(_size(x) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Bytes of every leaf of ``tree``."""
    return sum(_size(x) * _itemsize(x) for x in tree_leaves(tree))


def cast_floats(tree, dtype):
    """``tree`` with its floating-point leaves cast to the torch ``dtype``
    (e.g. bf16 compute params): tensors by ``.to``, float numpy arrays as
    tensors (numpy has no bf16); integer and boolean leaves as they are."""
    def cast(x):
        if not torch.is_tensor(x):
            x = np.asarray(x)
            if not np.issubdtype(x.dtype, np.floating):
                return x
            x = torch.from_numpy(x)
        return x.to(dtype) if x.is_floating_point() else x
    return _map(cast, tree)
