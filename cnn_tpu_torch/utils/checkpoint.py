"""Checkpoints: the native ``.ckpt`` pickle and the reference ``.model``
format, in ``cnn_tpu``'s layouts. Counterpart of
``cnn_tpu/utils/checkpoint.py``, numpy only.

A reference ``.model`` file is the flat little-endian float32 concatenation,
in layer order, of: conv ``w`` as OIHW then ``b``; dense ``w`` as [in][out]
with ``in`` in CHW flatten order, then ``b``; BN ``gamma``, ``beta``,
``mean``, ``var`` (or only ``gamma``, ``beta`` in the older 2-vector format).
``import_reference_model`` returns it as ``cnn_tpu`` lays it out (HWIO conv
weights, an NHWC-ordered dense in-dim), ``load_jax_params`` copies such
param/state trees into a port model and ``export_reference_model`` writes
them back; the ``.model`` format is the flat AlexNet stack's only, as in
``cnn_tpu``. ``load_jax_train_state`` carries a whole ``cnn_tpu``
``TrainState`` across: params, BN state, optax's momentum trace (a tree
shaped like the params) and its update count, and the step.

Trees follow the model's layers (``Layer.tree_leaves``): ``{layer: {key:
array}}`` for a flat stack, nested for the blocks (``{"block_2": {"body":
{"block_2_conv1": {"w": ...}}, "proj": {...}}}``) and stacked with a
leading [L] axis under a ``StackedBlocks`` (``{"trunk": {"body":
{"b_conv1": {"w": [L,3,3,C,C]}}}}``), as ``cnn_tpu``'s are.

A native ``.ckpt`` is ``cnn_tpu``'s pickle of a dict: ``params``, ``state``
and ``opt_state`` as numpy trees, ``step``, ``rng`` (uint32[2], the
threefry key data that JAX's ``wrap_key_data`` takes) and ``format_version``
1. ``opt_state`` is optax's own tuple, whose classes the pickle names by
optax's module paths: ``()`` for plain SGD at a constant rate, else
``(TraceState(trace) or EmptyState(), ScaleByScheduleState(count) or
EmptyState())``, the first for momentum, the second for a schedule. The
port writes the same (``save_checkpoint``), naming optax's classes without
importing optax, plus one key ``cnn_tpu`` ignores, ``torch_rng``: the
device type and state of the train state's ``torch.Generator``. Its reader
(``read_checkpoint``) maps those optax names onto the NamedTuple stubs below
and refuses every other global but numpy's array and dtype ones, so a
checkpoint can carry no code.

The generator on a load (``load_checkpoint``): a ``torch_rng`` state saved
on the same device type is restored as it was. Otherwise (a ``cnn_tpu``
checkpoint, or one saved on another device type) the key data's words,
read big-endian as one integer ``k`` (``k0 << 32 | k1`` for threefry),
become the train state's ``seed`` and the generator is seeded with
``(k + step) mod 2**64``. The port writes ``rng`` as the key data of
``jax.random.key(seed)``, ``[seed >> 32, seed & 0xffffffff]``, so a seed
survives a round trip either way.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, NamedTuple

import numpy as np
import torch

from cnn_tpu_torch.nn.module import (BatchNorm2D, Conv2D, Linear, leaf_name,
                                     leaf_path)


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


def _at(tree: dict, path, what: str):
    """The leaf of ``tree`` at ``path``."""
    node = tree
    for i, key in enumerate(path):
        if not isinstance(node, dict) or key not in node:
            raise KeyError(f"{what} tree has no {'/'.join(path[:i + 1])}")
        node = node[key]
    return node


def _copy_into(dst: torch.Tensor, value, name: str) -> None:
    src = torch.tensor(np.asarray(value, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


def load_jax_params(model, params: dict, state: dict) -> None:
    """Copies ``cnn_tpu`` param/state trees (arrays, e.g. numpy; nested and
    [L]-stacked as the model's layers are) into ``model`` in place; every
    shape must match."""
    with torch.no_grad():
        for path, dst, is_state in _net(model).tree_leaves():
            tree, what = (state, "state") if is_state else (params, "param")
            _copy_into(dst, _at(tree, path, what), leaf_name(path))


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
                _copy_into(dst, _at(trace, leaf_path(name), "trace"),
                           f"trace {name}")
    ts.opt_state["count"] = int(count)
    ts.step = int(step)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tree(leaves) -> dict:
    """``(path, tensor)`` pairs as a nested dict of numpy copies, keys
    sorted at every level as JAX's tree functions sort them."""
    out: dict = {}
    for path, t in sorted(leaves, key=lambda pt: pt[0]):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _np(t).copy()
    return out


def model_trees(model) -> tuple[dict, dict]:
    """``model``'s ``(params, state)`` as ``cnn_tpu``'s numpy trees
    (module docstring); the state holds the BN layers' ``mean`` and
    ``var``."""
    leaves = list(_net(model).tree_leaves())
    return (_tree((p, t) for p, t, st in leaves if not st),
            _tree((p, t) for p, t, st in leaves if st))


def export_reference_model(path, net, params: dict | None = None,
                           state: dict | None = None) -> None:
    """Writes ``(params, state)`` (``cnn_tpu``'s trees, numpy or tensors;
    default: ``net``'s own) as a reference-format ``.model`` file for
    ``net``'s layer stack, as ``cnn_tpu``'s ``export_reference_model``."""
    if params is None:
        params, state = model_trees(net)
    chunks: list[np.ndarray] = []
    last_conv_channels = None
    for layer in _param_layers(net):
        p = {k: _np(v) for k, v in params[layer.name].items()}
        if isinstance(layer, Conv2D):
            chunks.append(np.ascontiguousarray(
                p["w"].transpose(3, 2, 0, 1)).ravel())  # HWIO -> OIHW
            chunks.append(p["b"].ravel())
            last_conv_channels = layer.out_channels
        elif isinstance(layer, Linear):
            w = p["w"]
            fin, fout = w.shape
            c = last_conv_channels
            if c is not None and fin % c == 0:
                hw = int(round((fin // c) ** 0.5))
                w = w.reshape(hw, hw, c, fout).transpose(2, 0, 1, 3)
                w = w.reshape(fin, fout)
            chunks.append(np.ascontiguousarray(w).ravel())
            chunks.append(p["b"].ravel())
        else:
            st = {k: _np(v) for k, v in state[layer.name].items()}
            chunks.extend([p["gamma"].ravel(), p["beta"].ravel(),
                           st["mean"].ravel(), st["var"].ravel()])
    flat = np.concatenate(chunks).astype("<f4")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat.tofile(path)


# ---------------------------------------------------------------- native ----


class TraceState(NamedTuple):
    """optax's momentum state: ``trace``, a tree shaped like the params."""
    trace: Any


class ScaleByScheduleState(NamedTuple):
    """optax's schedule state: ``count``, the updates made so far."""
    count: Any


class EmptyState(NamedTuple):
    """optax's state of a transform that keeps none."""


class EmaState(NamedTuple):
    """``cnn_tpu.optim.EmaState``, the optimizer state of an ``--ema`` run:
    the inner state and the EMA weights. Read so that it can be refused:
    EMA weights are not ported yet (``ema_state``)."""
    inner: Any
    ema: Any
    count: Any
    decay: Any = None
    mstate: Any = None


# the optax module each stub is written under (optax 0.2's paths); on a
# read, the class name under any optax module maps onto its stub
_OPTAX_MODULES = {TraceState: "optax.transforms._accumulation",
                  ScaleByScheduleState: "optax._src.transform",
                  EmptyState: "optax._src.base"}
_STUBS = {cls.__name__: cls for cls in _OPTAX_MODULES}
_NUMPY_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype"),
                  ("numpy.core.multiarray", "_reconstruct"),
                  ("numpy._core.multiarray", "_reconstruct"),
                  ("numpy.core.multiarray", "scalar"),
                  ("numpy._core.multiarray", "scalar")}


class _OptaxPickler(pickle._Pickler):
    """The pure-Python pickler, which writes the stubs as references to
    optax's classes: the C pickler's ``save_global`` imports the module it
    names, and the port does not import optax."""

    def save_global(self, obj, name=None):
        module = _OPTAX_MODULES.get(obj)
        if module is None:
            return super().save_global(obj, name)
        self.save(module)
        self.save(obj.__name__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _RestrictedUnpickler(pickle.Unpickler):
    """Data-only unpickler: numpy arrays and dtypes, and optax's three
    state classes and ``cnn_tpu``'s ``EmaState`` as the stubs; any other
    global is refused."""

    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS:
            return super().find_class(module, name)
        if (module, name) == ("cnn_tpu.optim", "EmaState"):
            return EmaState
        root = module.split(".")[0]
        if root == "optax" and name in _STUBS:
            return _STUBS[name]
        if root == "numpy":
            cls = super().find_class(module, name)
            if isinstance(cls, type) and issubclass(cls, np.dtype):
                return cls
        raise pickle.UnpicklingError(
            f"checkpoint contains blocked global {module}.{name}")


def _nest(flat: dict) -> dict:
    """``{leaf_name: tensor}`` -> the nested tree of arrays, sorted."""
    return _tree((leaf_path(name), t) for name, t in flat.items())


def _optax_state(opt_state: dict):
    trace = opt_state["trace"]
    if trace is None and not opt_state["scheduled"]:
        return ()       # cnn_tpu's own plain SGD keeps no state
    first = EmptyState() if trace is None else TraceState(_nest(trace))
    second = (ScaleByScheduleState(np.asarray(opt_state["count"], np.int32))
              if opt_state["scheduled"] else EmptyState())
    return (first, second)


def _find(opt_state, cls):
    """The ``cls`` state in optax's tuple, or None."""
    return next((st for st in opt_state if isinstance(st, cls)), None)


def _key_data(seed: int) -> np.ndarray:
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _key_seed(key) -> int:
    k = 0
    for word in np.asarray(key, np.uint32).ravel():
        k = ((k << 32) | int(word)) % 2**64
    return k


def save_checkpoint(path: str, train_state) -> None:
    """Writes the port's ``TrainState`` as a ``cnn_tpu`` ``.ckpt``
    (module docstring), atomically."""
    ts = train_state
    params, state = model_trees(ts.model)
    payload = {
        "params": params,
        "state": state,
        "opt_state": _optax_state(ts.opt_state),
        "step": int(ts.step),
        "rng": _key_data(ts.seed),
        "format_version": 1,
        "torch_rng": {"device": ts.rng.device.type,
                      "state": ts.rng.get_state().numpy().copy()},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _OptaxPickler(f, protocol=4).dump(payload)
    os.replace(tmp, path)


def read_checkpoint(path: str) -> dict:
    """A ``.ckpt``'s payload as it was pickled: numpy trees, the optax
    states as the stubs."""
    with open(path, "rb") as f:
        return _RestrictedUnpickler(f).load()


def refuse_ema(payload: dict, path: str) -> None:
    """Raises ``NotImplementedError`` for a checkpoint whose optimizer
    state tracks EMA weights (``cnn_tpu``'s ``--ema``), which the port
    does not run yet (ROADMAP.md Queue 1 item 5, ``optim.with_ema``)."""
    if isinstance(payload["opt_state"], EmaState):
        raise NotImplementedError(
            f"{path}: its optimizer state holds EMA weights; EMA "
            "(optim.with_ema, ROADMAP.md Queue 1 item 5) is not ported yet")


def load_checkpoint(path: str, train_state):
    """Loads a ``.ckpt`` (``cnn_tpu``'s or the port's) into the port's
    ``train_state`` in place and returns it: params, BN state, the momentum
    trace and the count, the step, and the generator (module docstring)."""
    ts = train_state
    payload = read_checkpoint(path)
    refuse_ema(payload, path)
    step = int(payload["step"])
    trace = _find(payload["opt_state"], TraceState)
    sched = _find(payload["opt_state"], ScaleByScheduleState)
    load_jax_train_state(ts, payload["params"], payload["state"],
                         None if trace is None else trace.trace,
                         step if sched is None else int(sched.count), step)
    ts.seed = _key_seed(payload["rng"])
    saved = payload.get("torch_rng")
    if saved is not None and saved["device"] == ts.rng.device.type:
        ts.rng.set_state(torch.from_numpy(np.asarray(saved["state"],
                                                     np.uint8).copy()))
    else:
        ts.rng.manual_seed((ts.seed + step) % 2**64)
    return ts


def tree_has_bn(tree) -> bool:
    """True if the param tree contains a BatchNorm-shaped subtree (a dict
    with both 'gamma' and 'beta' leaves)."""
    if isinstance(tree, dict):
        if "gamma" in tree and "beta" in tree:
            return True
        return any(tree_has_bn(v) for v in tree.values())
    return False


def checkpoint_name(iteration: int, train_acc: float, valid_acc: float,
                    suffix: str = ".ckpt") -> str:
    """Reference filename convention (cnn.cpp:121-124)."""
    return f"iter_{iteration}_train_{train_acc:.3f}_valid_{valid_acc:.3f}{suffix}"


def parse_checkpoint_name(name: str):
    m = re.match(r"iter_(\d+)_train_([\d.]+)_valid_([\d.]+)\.", name)
    if not m:
        return None
    return int(m.group(1)), float(m.group(2)), float(m.group(3))
