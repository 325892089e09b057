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
``TrainState`` across: params, BN state, the optimizer state and the
step; ``warm_start`` copies the leaves that fit into a fresh run.

Trees follow the model's layers (``Layer.tree_leaves``): ``{layer: {key:
array}}`` for a flat stack, nested for the blocks (``{"block_2": {"body":
{"block_2_conv1": {"w": ...}}, "proj": {...}}}``) and stacked with a
leading [L] axis under a ``StackedBlocks`` (``{"trunk": {"body":
{"b_conv1": {"w": [L,3,3,C,C]}}}}``), as ``cnn_tpu``'s are. An MoE layer's
params are ``router``, ``w1``, ``b1``, ``w2``, ``b2`` and its state
``load`` (and ``aux_loss`` with a balance loss): ``{"moe": {"load": [E]}}``.

A native ``.ckpt`` is ``cnn_tpu``'s pickle of a dict: ``params``, ``state``
and ``opt_state`` as numpy trees, ``step``, ``rng`` (uint32[2], the
threefry key data that JAX's ``wrap_key_data`` takes) and ``format_version``
1. ``opt_state`` is optax's own nesting, whose classes the pickle names by
optax's module paths: ``()`` for plain SGD at a constant rate; ``(TraceState
(trace) or EmptyState(), ScaleByScheduleState(count) or EmptyState())`` for
``optax.sgd``; ``(ScaleByAdamState(count, mu, nu), [EmptyState(),]
ScaleByScheduleState or EmptyState())`` for Adam (AdamW); weight decay and
the clip each an ``EmptyState`` link of a chain before it; and
``cnn_tpu.optim.EmaState(inner, ema, count, decay, mstate)`` around any of
them for ``--ema``. The port's optimizer state has the same nesting
(``optim.py``), so it maps one to one: ``save_checkpoint`` writes it
(``pickled_state``), naming optax's and cnn_tpu's classes without
importing either, plus one key ``cnn_tpu`` ignores, ``torch_rng``: the
device type and state of the train state's ``torch.Generator``. Its reader
(``read_checkpoint``) maps those names onto the port's classes and refuses
every other global but numpy's array and dtype ones, so a checkpoint can
carry no code; ``load_opt_state`` copies a read state into a live one.

On a mesh (``parallel/train_step.py:shard_train_state``) the file holds
the full tree all the same: ``save_checkpoint`` gathers each slice held
over ``'model'`` and process 0 alone writes; ``load_checkpoint`` reads the
full tree on every rank and keeps its slices.

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

import numpy as np
import torch

from cnn_tpu_torch.nn.module import (BatchNorm2D, Conv2D, Linear, leaf_name,
                                     leaf_path)
from cnn_tpu_torch.optim import (EmaState, EmptyState, ScaleByAdamState,
                                 ScaleByScheduleState, TraceState,
                                 ema_model_state, ema_params,
                                 ema_seed_model_state)
from cnn_tpu_torch.parallel.train_step import (named_params, named_state,
                                               unsharded)


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
    src = torch.tensor(np.asarray(
        value, np.float32 if dst.is_floating_point() else None)).to(dst.dtype)
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


def load_jax_train_state(ts, params: dict, state: dict, opt_state=(),
                         step: int = 0) -> None:
    """Copies a ``cnn_tpu`` ``TrainState``, given as numpy (or JAX) trees,
    into the port's ``TrainState`` ``ts`` in place: the params and BN state
    into ``ts.model``, ``opt_state`` (optax's nesting, ``cnn_tpu``'s
    ``EmaState``) into ``ts.opt_state`` (``load_opt_state``), and the
    step."""
    load_jax_params(ts.model, params, state)
    ts.opt_state = load_opt_state(ts.opt_state, opt_state,
                                  named_state(ts.model))
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


# the module each state class is pickled under (optax 0.2's paths, and
# cnn_tpu's EmaState); on a read, the class name under any optax module
# maps onto the port's class
_PICKLED_MODULES = {TraceState: "optax.transforms._accumulation",
                    ScaleByScheduleState: "optax._src.transform",
                    ScaleByAdamState: "optax._src.transform",
                    EmptyState: "optax._src.base",
                    EmaState: "cnn_tpu.optim"}
_STUBS = {cls.__name__: cls for cls in _PICKLED_MODULES if cls is not EmaState}
_NUMPY_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype"),
                  ("numpy.core.multiarray", "_reconstruct"),
                  ("numpy._core.multiarray", "_reconstruct"),
                  ("numpy.core.multiarray", "scalar"),
                  ("numpy._core.multiarray", "scalar")}


class _OptaxPickler(pickle._Pickler):
    """The pure-Python pickler, which writes the state classes as
    references to optax's and cnn_tpu's: the C pickler's ``save_global``
    imports the module it names, and the port imports neither."""

    def save_global(self, obj, name=None):
        module = _PICKLED_MODULES.get(obj)
        if module is None:
            return super().save_global(obj, name)
        self.save(module)
        self.save(obj.__name__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _RestrictedUnpickler(pickle.Unpickler):
    """Data-only unpickler: numpy arrays and dtypes, and optax's state
    classes and ``cnn_tpu``'s ``EmaState`` as the port's; any other global
    is refused."""

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


def pickled_state(node):
    """The port's optimizer state as ``cnn_tpu`` pickles its own: the same
    classes and tuples, each ``{name: tensor}`` as a nested numpy tree, a
    count as int32 and the EMA decay as float32 0-d arrays."""
    if node is None:
        return None
    if isinstance(node, torch.Tensor):
        return _np(node).copy()
    if isinstance(node, float):
        return np.asarray(node, np.float32)
    if isinstance(node, dict):
        return _nest(node)
    if hasattr(node, "_fields"):
        return type(node)(*(pickled_state(v) for v in node))
    return tuple(pickled_state(v) for v in node)


@torch.no_grad()
def load_opt_state(live, saved, state: dict | None = None, where="opt_state"):
    """Copies ``saved`` (``cnn_tpu``'s optimizer state, numpy or JAX
    arrays) into the port's ``live`` state of the same optimizer, in
    place, and returns it (a new ``EmaState`` where a field changes).
    The two must have the same nesting: another optimizer's state raises
    ``ValueError``. A legacy ``EmaState`` keeps ``live``'s decay (the run's
    ``--ema``) and has its ``mstate`` seeded from ``state``."""
    if isinstance(live, torch.Tensor):
        _copy_into(live, saved, where)
        return live
    if isinstance(live, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"{where}: a tree here, "
                             f"{type(saved).__name__} saved")
        for name, t in live.items():
            _copy_into(t, _at(saved, leaf_path(name), where),
                       f"{where} {name}")
        return live
    if (type(live).__name__ != type(saved).__name__
            or len(live) != len(saved)):
        raise ValueError(f"{where}: the optimizer keeps "
                         f"{pickled_layout(live)}, the checkpoint "
                         f"{pickled_layout(saved)}")
    if isinstance(live, EmaState):
        inner = load_opt_state(live.inner, saved.inner, state,
                               f"{where}.inner")
        load_opt_state(live.ema, saved.ema, state, f"{where}.ema")
        load_opt_state(live.count, saved.count, state, f"{where}.count")
        decay = live.decay if saved.decay is None else float(
            np.float32(saved.decay))
        out = live._replace(inner=inner, decay=decay)
        if saved.mstate is None:
            return ema_seed_model_state(out._replace(mstate=None), state)
        if live.mstate is None:
            out = ema_seed_model_state(out, state)
        load_opt_state(out.mstate, saved.mstate, state, f"{where}.mstate")
        return out
    fields = getattr(live, "_fields", None)
    parts = [load_opt_state(a, b, state,
                            f"{where}.{fields[i] if fields else i}")
             for i, (a, b) in enumerate(zip(live, saved))]
    return tuple(parts) if fields is None else type(live)(*parts)


def pickled_layout(node) -> str:
    """The nesting of an optimizer state's classes, its trees and arrays
    left out (``EmaState((ScaleByAdamState, EmptyState))``), for
    messages."""
    inner = ", ".join(pickled_layout(v) for v in node
                      if isinstance(v, tuple))
    if hasattr(node, "_fields"):
        return type(node).__name__ + (f"({inner})" if inner else "")
    return f"({inner})"


def _key_data(seed: int) -> np.ndarray:
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _key_seed(key) -> int:
    k = 0
    for word in np.asarray(key, np.uint32).ravel():
        k = ((k << 32) | int(word)) % 2**64
    return k


def save_checkpoint(path: str, train_state) -> None:
    """Writes the port's ``TrainState`` as a ``cnn_tpu`` ``.ckpt``
    (module docstring), atomically. On a mesh every rank calls it: the
    params and optimizer leaves held as slices over ``'model'`` are
    gathered (``parallel/train_step.py:unsharded``), and process 0 alone
    writes the full tree, the one a one-rank run writes."""
    ts = train_state
    with unsharded(ts):
        if ts.mesh is None or ts.mesh.rank == 0:
            _write(path, ts)


def _write(path: str, ts) -> None:
    params, state = model_trees(ts.model)
    payload = {
        "params": params,
        "state": state,
        "opt_state": pickled_state(ts.opt_state),
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
    """A ``.ckpt``'s payload as it was pickled: numpy trees, the optimizer
    states as the port's classes (``optim.py``)."""
    with open(path, "rb") as f:
        return _RestrictedUnpickler(f).load()


def load_checkpoint(path: str, train_state):
    """Loads a ``.ckpt`` (``cnn_tpu``'s or the port's) into the port's
    ``train_state`` in place and returns it: params, BN state, the
    optimizer state (``load_opt_state``: a legacy EMA state's decay from
    the run's, its model-state average seeded from the loaded state), the
    step, and the generator (module docstring). On a mesh every rank
    loads the full tree and keeps its slices."""
    ts = train_state
    payload = read_checkpoint(path)
    step = int(payload["step"])
    with unsharded(ts):
        load_jax_train_state(ts, payload["params"], payload["state"],
                             payload["opt_state"], step)
    ts.seed = _key_seed(payload["rng"])
    saved = payload.get("torch_rng")
    if saved is not None and saved["device"] == ts.rng.device.type:
        ts.rng.set_state(torch.from_numpy(np.asarray(saved["state"],
                                                     np.uint8).copy()))
    else:
        ts.rng.manual_seed((ts.seed + step) % 2**64)
    return ts


def eval_trees(payload: dict) -> tuple[dict, dict, bool]:
    """A checkpoint's ``(params, state, is_ema)`` to evaluate with: its EMA
    weights and EMA'd model state where its optimizer state has them (the
    raw state where a legacy one has no ``mstate``), else its params and
    state."""
    ema = ema_params(payload["opt_state"])
    if ema is None:
        return payload["params"], payload["state"], False
    return ema, ema_model_state(payload["opt_state"], payload["state"]), True


def warm_start(train_state, path: str, optimizer=None):
    """Transfer-learning init (``cnn_tpu``'s ``warm_start``): copies into
    ``train_state``'s model every param and state leaf of the ``.ckpt`` at
    ``path`` whose tree path exists there with the same shape; the others
    (e.g. a head of another ``num_classes``) keep their fresh init. With
    ``optimizer``, the optimizer state is made anew from the merged params
    and its EMA seeded; the step and the generator stay fresh. Returns
    ``(train_state, copied_paths, skipped_paths)``, in ``cnn_tpu``'s
    words."""
    payload = read_checkpoint(path)
    copied, skipped = [], []

    def fresh_tree(want_state):
        tree: dict = {}
        for p, t, st in _net(train_state.model).tree_leaves():
            if st == want_state:
                node = tree
                for key in p[:-1]:
                    node = node.setdefault(key, {})
                node[p[-1]] = t
        return tree

    def merge(fresh, loaded, prefix):
        if isinstance(fresh, dict):
            if not isinstance(loaded, dict):
                skipped.append(f"{prefix} (not a dict in source)")
                return
            for k, v in fresh.items():
                if k in loaded:
                    merge(v, loaded[k], f"{prefix}/{k}")
                else:
                    skipped.append(f"{prefix}/{k} (missing in source)")
            return
        l_shape = getattr(loaded, "shape", None)
        if l_shape == tuple(fresh.shape):
            copied.append(prefix)
            _copy_into(fresh, loaded, prefix)
        else:
            skipped.append(f"{prefix} (shape {l_shape} vs "
                           f"{tuple(fresh.shape)})")

    with torch.no_grad():
        merge(fresh_tree(False), payload["params"], "")
        merge(fresh_tree(True), payload["state"], "")
    if optimizer is not None:
        train_state.opt_state = ema_seed_model_state(
            optimizer.init(named_params(train_state.model)),
            named_state(train_state.model))
    return train_state, copied, skipped


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
