"""Weights: the reference ``.model`` format and ``cnn_tpu`` param trees.

Counterpart of ``cnn_tpu/utils/checkpoint.py``, numpy only.

A reference ``.model`` file is the flat little-endian float32 concatenation,
in layer order, of: conv ``w`` as OIHW then ``b``; dense ``w`` as [in][out]
with ``in`` in CHW flatten order, then ``b``; BN ``gamma``, ``beta``,
``mean``, ``var`` (or only ``gamma``, ``beta`` in the older 2-vector format).
``import_reference_model`` returns it as ``cnn_tpu`` lays it out (HWIO conv
weights, an NHWC-ordered dense in-dim), and ``load_jax_params`` copies such
param/state trees into a port model. ``load_jax_train_state`` carries a
whole ``cnn_tpu`` ``TrainState`` across: params, BN state, optax's momentum
trace (a tree shaped like the params) and its update count, and the step.

The native ``.ckpt`` pickle is not read here: it names optax classes, which
the port does not import.
"""

from __future__ import annotations

import numpy as np
import torch

from cnn_tpu_torch.nn.module import BatchNorm2D, Conv2D, Linear


def _net(model):
    return getattr(model, "net", model)


def _param_layers(net):
    for layer in _net(net):
        if isinstance(layer, (Conv2D, Linear, BatchNorm2D)):
            yield layer


def reference_param_count(net, bn_vectors: int = 4) -> int:
    """Float32 count of a ``.model`` file for ``net``; ``bn_vectors=2`` is
    the older gamma/beta-only BN format."""
    n = 0
    for layer in _param_layers(net):
        if isinstance(layer, Conv2D):
            n += layer.out_channels * (
                layer.in_channels * layer.kernel_size ** 2 + 1)
        elif isinstance(layer, Linear):
            n += layer.in_features * layer.out_features + layer.out_features
        else:
            n += bn_vectors * layer.num_channels
    return n


def import_reference_model(path, net) -> tuple[dict, dict]:
    """Reads a reference ``.model`` file into ``(params, state)`` numpy trees
    in ``cnn_tpu``'s layout (see ``import_reference_array``)."""
    return import_reference_array(np.fromfile(path, dtype="<f4"), net, path)


def import_reference_array(raw: np.ndarray, net,
                           what="reference array") -> tuple[dict, dict]:
    """A ``.model`` file's flat float32 contents as ``(params, state)``.

    The dense layer's input is taken as the last conv's C x hw x hw
    features, hw from its in-dim. The older 2-vector BN format gets
    identity moving statistics.
    """
    raw = np.asarray(raw, "<f4").ravel()
    expected = reference_param_count(net)
    legacy = reference_param_count(net, bn_vectors=2)
    if raw.size not in (expected, legacy):
        raise ValueError(f"{what}: has {raw.size} f32, model needs {expected} "
                         f"(or {legacy} in the legacy 2-vector-BN format)")
    legacy_bn = raw.size == legacy != expected
    params: dict = {}
    state: dict = {}
    pos = 0

    def take(n):
        nonlocal pos
        out = raw[pos:pos + n]
        pos += n
        return out

    last_conv_channels = None
    for layer in _param_layers(net):
        if isinstance(layer, Conv2D):
            o, i, k = layer.out_channels, layer.in_channels, layer.kernel_size
            w = take(o * i * k * k).reshape(o, i, k, k).transpose(2, 3, 1, 0)
            params[layer.name] = {"w": np.ascontiguousarray(w),
                                  "b": take(o).copy()}
            last_conv_channels = o
        elif isinstance(layer, Linear):
            fin, fout = layer.in_features, layer.out_features
            w = take(fin * fout).reshape(fin, fout)
            c = last_conv_channels
            if c is not None and fin % c == 0:
                hw = int(round((fin // c) ** 0.5))
                if c * hw * hw != fin:
                    raise ValueError(f"dense in-dim {fin} is not {c}x{hw}x{hw}")
                # reference in-dim order is (c, h, w); NHWC flatten is (h, w, c)
                w = w.reshape(c, hw, hw, fout).transpose(1, 2, 0, 3)
                w = w.reshape(fin, fout)
            params[layer.name] = {"w": np.ascontiguousarray(w),
                                  "b": take(fout).copy()}
        else:
            n = layer.num_channels
            params[layer.name] = {"gamma": take(n).copy(),
                                  "beta": take(n).copy()}
            if legacy_bn:
                state[layer.name] = {"mean": np.zeros(n, np.float32),
                                     "var": np.ones(n, np.float32)}
            else:
                state[layer.name] = {"mean": take(n).copy(),
                                     "var": take(n).copy()}
    return params, state


def load_jax_params(model, params: dict, state: dict) -> None:
    """Copies ``cnn_tpu`` param/state trees (arrays, e.g. numpy) into
    ``model`` in place; every shape must match."""
    with torch.no_grad():
        for layer in _param_layers(model):
            tensors = dict(params[layer.name])
            if isinstance(layer, BatchNorm2D):
                tensors.update(state[layer.name])
            for key, value in tensors.items():
                dst = getattr(layer, key)
                src = torch.tensor(np.asarray(value, dtype=np.float32))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{layer.name}.{key}: shape "
                                     f"{tuple(src.shape)} != {tuple(dst.shape)}")
                dst.copy_(src)


def load_reference_model(model, path) -> None:
    """Loads a reference ``.model`` file into ``model`` in place."""
    load_jax_params(model, *import_reference_model(path, model))


def load_jax_train_state(ts, params: dict, state: dict, trace=None,
                         count: int = 0, step: int = 0) -> None:
    """Copies a ``cnn_tpu`` ``TrainState``, given as numpy trees, into the
    port's ``TrainState`` ``ts`` in place: the params and BN state into
    ``ts.model``, optax's momentum ``trace`` (``{layer: {key: array}}``, or
    None for plain SGD) and update ``count`` into ``ts.opt_state``, and the
    step counter."""
    load_jax_params(ts.model, params, state)
    if (trace is None) != (ts.opt_state["trace"] is None):
        raise ValueError("a momentum trace must come with a momentum "
                         "optimizer, and only with one")
    if trace is not None:
        with torch.no_grad():
            for name, dst in ts.opt_state["trace"].items():
                layer, key = name.split(".")
                src = torch.tensor(np.asarray(trace[layer][key], np.float32))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"trace {name}: shape {tuple(src.shape)} "
                                     f"!= {tuple(dst.shape)}")
                dst.copy_(src)
    ts.opt_state["count"] = int(count)
    ts.step = int(step)
