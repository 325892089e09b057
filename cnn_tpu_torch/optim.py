"""Optimizers and learning-rate schedules, counterpart of ``cnn_tpu/optim.py``.

An ``Optimizer`` is ``(init, update)`` as in ``cnn_tpu``: ``init(params)``
makes the state and ``update(grads, opt_state, params)`` changes the
parameters and the state's tensors in place. ``params`` and ``grads`` are
dicts keyed by parameter name (``parallel/train_step.py:named_params``).

``sgd`` is the reference's ``w -= lr * g`` and keeps no state (``()``).
Every other optimizer is a chain of optax's transforms, ported here as
``GradientTransformation``s over those dicts with optax's arithmetic in
float32: ``trace`` (momentum, ``t = g + mu * t``), ``scale_by_adam`` (b1
0.9, b2 0.999, eps 1e-8, eps_root 0, bias correction by the incremented
count), ``add_decayed_weights`` (``u + wd * p``), ``clip_by_global_norm``
(``u / |u| * max`` where the global norm reaches ``max``) and
``scale_by_learning_rate`` (``-lr``, or ``-lr(count)`` on a schedule).

The state mirrors optax's nesting leaf for leaf, with the classes below in
place of optax's: a chain's state is the tuple of its links' states, a
transform that keeps none has ``EmptyState()``, a tree is a dict keyed by
parameter name, and a count is a 0-d int32 tensor on the CPU (a schedule
reads it without a device synchronisation). ``utils/checkpoint.py`` writes
that state as optax's pickled tree and reads it back into place.

A value the host computes from a count each update (a scheduled rate,
Adam's bias corrections, the EMA rate) reaches the update as a 0-d float32
tensor on the parameters' device (``step_scalar``): filled from the host
value eagerly, or, while work is captured into a CUDA graph, a slot of a
``ScalarFeed``'s device buffer that the feed fills before each replay. The
arithmetic is the same either way.

``with_ema`` keeps a float32 exponential moving average of the weights in
``EmaState`` (effective decay ``min(d, (1+t)/(10+t))``); the train step
averages the model state (BN's moving statistics) beside it with
``ema_update_state``. ``with_frozen`` holds the parameters under given
tree-path prefixes still. The schedules are plain functions equal to
optax's.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class Optimizer(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict], None]


class GradientTransformation(NamedTuple):
    """optax's transform: ``init(params) -> state``; ``update(updates,
    state, params) -> updates``, the state's tensors changed in place."""
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict], dict]


# ------------------------------------------------------------------ state --
# named as optax's (and cnn_tpu's EmaState) so that a checkpoint maps one
# to one

class EmptyState(NamedTuple):
    """The state of a transform that keeps none."""


class TraceState(NamedTuple):
    """Momentum: ``trace``, a dict shaped like the params."""
    trace: Any


class ScaleByScheduleState(NamedTuple):
    """A scheduled rate: ``count``, the updates made so far."""
    count: Any


class ScaleByAdamState(NamedTuple):
    """Adam: the update ``count`` and the first and second moments."""
    count: Any
    mu: Any
    nu: Any


class EmaState(NamedTuple):
    """``with_ema``'s state: the inner optimizer's state, the float32 EMA
    of the weights, the update count, the decay, and the EMA of the model
    state (``mstate``, BN's moving statistics; ``ema_update_state``)."""
    inner: Any
    ema: Any
    count: Any
    decay: Any = None
    mstate: Any = None


def counter() -> torch.Tensor:
    """A count: 0-d int32 on the CPU."""
    return torch.zeros((), dtype=torch.int32)


def tree_path(name: str) -> str:
    """A parameter name as ``cnn_tpu``'s '/'-joined tree path
    (``conv_layer_1.w`` -> ``conv_layer_1/w``)."""
    return name.replace(".", "/")


def _zeros(params: dict) -> dict:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _device(tree: dict):
    """The device of a dict's tensors (the CPU for an empty one)."""
    return next((t.device for t in tree.values()), torch.device("cpu"))


# ------------------------------------------------------- per-step scalars --

_FEED = None   # the ScalarFeed of a capture underway, if any


def step_scalar(count, fn, device) -> torch.Tensor:
    """``fn(int(count))`` as a 0-d float32 tensor on ``device``: filled
    from the host value, or, inside ``feeding(feed)``, the next slot of
    ``feed``'s buffer."""
    if _FEED is not None:
        return _FEED.read(count, fn)
    return torch.full((), fn(int(count)), dtype=torch.float32, device=device)


def counts(opt_state) -> list:
    """Every count of an optimizer state (the ``count`` field of each
    state class that has one), in tree order."""
    if isinstance(opt_state, tuple) and hasattr(opt_state, "_fields"):
        found = []
        for field in opt_state._fields:
            value = getattr(opt_state, field)
            found += [value] if field == "count" else counts(value)
        return found
    if isinstance(opt_state, (tuple, list)):
        return [c for s in opt_state for c in counts(s)]
    return []


class ScalarFeed:
    """The per-update scalars of work captured into a CUDA graph.

    Made before the capture with the state's counts as they stand
    (``counts``); inside ``feeding(feed)`` each ``step_scalar`` takes the
    next slot of a float32 device buffer and records its function and its
    count's offset from that start (the capture runs each update's host
    side, so the counts move). ``fill()`` computes every slot from the
    counts as they stand then and copies them to the device in one
    transfer: call it before each replay, with the counts advanced by the
    replays before it."""

    def __init__(self, counts_now, device, capacity: int = 256):
        self.base = {id(c): int(c) for c in counts_now}
        self.buf = torch.zeros(capacity, dtype=torch.float32, device=device)
        self.entries = []

    def read(self, count, fn) -> torch.Tensor:
        if id(count) not in self.base:
            raise RuntimeError("step_scalar: a count the ScalarFeed was not "
                               "made with")
        if len(self.entries) == self.buf.numel():
            raise RuntimeError(f"ScalarFeed: more than {self.buf.numel()} "
                               "scalars")
        self.entries.append((fn, count, int(count) - self.base[id(count)]))
        return self.buf[len(self.entries) - 1]

    def values(self) -> list:
        """Each slot's value at the counts as they stand."""
        return [fn(int(count) + off) for fn, count, off in self.entries]

    def fill(self) -> None:
        vals = torch.tensor(self.values(), dtype=torch.float32)
        if self.buf.is_cuda:
            vals = vals.pin_memory()
        self.buf[:len(vals)].copy_(vals, non_blocking=True)


@contextmanager
def feeding(feed: ScalarFeed):
    """``step_scalar`` reads ``feed`` inside the block."""
    global _FEED
    if _FEED is not None:
        raise RuntimeError("a ScalarFeed is already active")
    _FEED = feed
    try:
        yield feed
    finally:
        _FEED = None


# -------------------------------------------------------------- schedules --

def constant_schedule(value: float):
    return lambda count: value


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """optax.linear_schedule."""
    def schedule(count):
        c = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1 - c / transition_steps) + end_value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0):
    """optax.cosine_decay_schedule: ``init * (0.5 (1 + cos(pi t / T)))``,
    held at ``alpha * init`` past ``T``."""
    def schedule(count):
        c = min(count, decay_steps)
        decay = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * decay + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int):
    """optax.warmup_cosine_decay_schedule (end value 0): a linear warmup,
    then a cosine over the remaining ``decay_steps - warmup_steps``."""
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    cos = cosine_decay_schedule(peak_value, decay_steps - warmup_steps)
    return lambda count: (warm(count) if count < warmup_steps
                          else cos(count - warmup_steps))


def piecewise_constant_schedule(init_value: float,
                                boundaries_and_scales: dict):
    """optax.piecewise_constant_schedule: the value is scaled by each
    ``scale`` from its boundary on."""
    def schedule(count):
        v = init_value
        for boundary, scale in sorted(boundaries_and_scales.items()):
            if count >= boundary:
                v *= scale
        return v
    return schedule


def make_schedule(learning_rate: float, schedule: str = "constant",
                  total_steps: int = 0, warmup_steps: int = 0):
    """``count -> lr``, or the rate itself for a constant rate with no
    warmup (as ``cnn_tpu`` returns it there)."""
    if schedule == "constant" and warmup_steps == 0:
        return learning_rate
    if schedule == "constant":
        return linear_schedule(0.0, learning_rate, warmup_steps)
    if total_steps <= 0:
        raise ValueError(f"schedule '{schedule}' needs total_steps")
    if schedule == "cosine":
        if warmup_steps:
            return warmup_cosine_decay_schedule(0.0, learning_rate,
                                                warmup_steps, total_steps)
        return cosine_decay_schedule(learning_rate, total_steps)
    if schedule == "step":
        # /10 at 60% and 85% of training
        return piecewise_constant_schedule(
            learning_rate, {int(total_steps * 0.6): 0.1,
                            int(total_steps * 0.85): 0.1})
    raise ValueError(f"unknown schedule '{schedule}'")


# ------------------------------------------------------------- transforms --

def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: EmptyState(),
                                  lambda updates, state, params: updates)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    """optax.chain: the links in turn; the state is their tuple."""
    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params):
        for tx, st in zip(txs, state):
            updates = tx.update(updates, st, params)
        return updates

    return GradientTransformation(init, update)


def trace(decay: float) -> GradientTransformation:
    """optax.trace: ``t = g + decay * t``; the update is the new trace."""
    def init(params):
        return TraceState(_zeros(params))

    def update(updates, state, params):
        for k, t in state.trace.items():
            t.mul_(decay).add_(updates[k])
        return dict(state.trace)

    return GradientTransformation(init, update)


def scale_by_schedule(schedule) -> GradientTransformation:
    """optax.scale_by_schedule: ``u * schedule(count)``, then count + 1."""
    def init(params):
        return ScaleByScheduleState(counter())

    def update(updates, state, params):
        step = step_scalar(state.count, schedule, _device(updates))
        state.count.add_(1)
        return {k: u * step for k, u in updates.items()}

    return GradientTransformation(init, update)


def scale(step: float) -> GradientTransformation:
    return GradientTransformation(
        lambda params: EmptyState(),
        lambda updates, state, params: {k: u * step
                                        for k, u in updates.items()})


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    """optax.scale_by_learning_rate: ``-lr``, or ``-lr(count)`` on a
    schedule (which keeps the count)."""
    if callable(learning_rate):
        return scale_by_schedule(lambda count: -learning_rate(count))
    return scale(-learning_rate)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """optax.add_decayed_weights: ``u + wd * p`` (into the update, before
    momentum or Adam scale it)."""
    def update(updates, state, params):
        return {k: u + weight_decay * params[k] for k, u in updates.items()}

    return GradientTransformation(lambda params: EmptyState(), update)


def global_norm(updates: dict, params: dict | None = None) -> torch.Tensor:
    """optax's global norm: the leaves' sums of squares added in tree
    order (keys sorted level by level), then the square root. A leaf
    whose parameter holds a shard over a mesh's ``'model'`` axis (its
    ``tp``, ``(mesh, dim)``: ``parallel/train_step.py:shard_train_state``)
    or its ``'expert'`` axis (its ``ep``), or a pipelined trunk's over
    ``'stage'`` and ``'model'`` (its ``cuts``, ``(mesh, axes)``:
    ``parallel/pipeline.py:shard_pp_train_state``), adds the squares of
    every rank's shard, summed over those axes."""
    names = sorted(updates, key=lambda n: tuple(tree_path(n).split("/")))
    params = params or {}
    split = {}      # axes -> (mesh, names)
    for n in names:
        p = params.get(n)
        if getattr(p, "tp", None) is not None:
            mesh, axes = p.tp[0], ("model",)
        elif getattr(p, "ep", None) is not None:
            mesh, axes = p.ep[0], ("expert",)
        elif getattr(p, "cuts", None) is not None:
            mesh, axes = p.cuts
        else:
            continue
        split.setdefault(axes, (mesh, []))[1].append(n)
    held = {n for _, part in split.values() for n in part}
    total = sum(torch.sum(updates[n] * updates[n]) for n in names
                if n not in held)
    order = [("model",), ("expert",)]
    for axes in sorted(split, key=lambda a: (order + [a]).index(a)):
        mesh, part = split[axes]
        squares = sum(torch.sum(updates[n] * updates[n]) for n in part)
        for axis in axes:
            squares = mesh.all_sum(squares, axis)
        total = total + squares
    return torch.sqrt(total)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: where the global norm ``g`` is at least
    ``max_norm``, each update becomes ``(u / g) * max_norm``."""
    def update(updates, state, params):
        g_norm = global_norm(updates, params)
        keep = g_norm < max_norm
        return {k: torch.where(keep, u, (u / g_norm.to(u.dtype)) * max_norm)
                for k, u in updates.items()}

    return GradientTransformation(lambda params: EmptyState(), update)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1) - np.power(np.float32(decay),
                                          np.float32(count)))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """optax.scale_by_adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 +
    b2 nu``, the count incremented, then ``mu_hat / (sqrt(nu_hat +
    eps_root) + eps)`` with ``x_hat = x / (1 - b**count)``."""
    def init(params):
        return ScaleByAdamState(counter(), _zeros(params), _zeros(params))

    def update(updates, state, params):
        for k, g in updates.items():
            state.mu[k].mul_(b1).add_((1 - b1) * g)
            state.nu[k].mul_(b2).add_((1 - b2) * (g * g))
        state.count.add_(1)
        dev = _device(updates)
        bc1 = step_scalar(state.count, lambda c: _bias_correction(b1, c), dev)
        bc2 = step_scalar(state.count, lambda c: _bias_correction(b2, c), dev)
        out = {}
        for k in updates:
            nu_hat = state.nu[k] / bc2
            if eps_root:
                nu_hat = nu_hat + eps_root
            out[k] = (state.mu[k] / bc1) / (torch.sqrt(nu_hat) + eps)
        return out

    return GradientTransformation(init, update)


def sgd_transform(learning_rate, momentum: float | None = None
                  ) -> GradientTransformation:
    """optax.sgd: the momentum trace (or nothing) and the rate."""
    return chain(trace(momentum) if momentum is not None else identity(),
                 scale_by_learning_rate(learning_rate))


def adam(learning_rate) -> GradientTransformation:
    """optax.adam."""
    return chain(scale_by_adam(), scale_by_learning_rate(learning_rate))


def adamw(learning_rate, weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw: the decay between Adam and the rate."""
    return chain(scale_by_adam(), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def from_transform(tx: GradientTransformation) -> Optimizer:
    """The optimizer that applies ``tx``'s updates: ``p += u``."""
    @torch.no_grad()
    def update(grads, opt_state, params):
        updates = tx.update(grads, opt_state, params)
        for k, p in params.items():
            p.add_(updates[k].to(p.dtype))

    return Optimizer(tx.init, update)


def sgd(learning_rate: float) -> Optimizer:
    """Plain SGD: ``w -= lr * g``, the reference's exact update; no state."""
    step = -float(learning_rate)

    @torch.no_grad()
    def update(grads, opt_state, params):
        for k, p in params.items():
            p.add_(grads[k].to(p.dtype) * step)

    return Optimizer(lambda params: (), update)


# ---------------------------------------------------------------- wrappers --

def _ema_rate(decay, count: int) -> float:
    """``min(d, (1+t)/(10+t))`` in float32."""
    d = np.float32(0.999 if decay is None else decay)
    return float(min(d, np.float32(1 + count) / np.float32(10 + count)))


def _ema_scalars(decay, count, device):
    """The effective decay after update ``count`` and one minus it, in
    float32, as ``step_scalar``s."""
    return (step_scalar(count, lambda c: _ema_rate(decay, c), device),
            step_scalar(count, lambda c: float(
                np.float32(1) - np.float32(_ema_rate(decay, c))), device))


def _lerp_into(avg: torch.Tensor, new: torch.Tensor, eff, rest) -> None:
    """``avg = eff * avg + rest * new`` (``rest`` = 1 - eff), float32."""
    avg.mul_(eff).add_(new.float() * rest)


def with_ema(opt: Optimizer, decay: float = 0.999) -> Optimizer:
    """Tracks a float32 exponential moving average of the weights beside
    ``opt`` (``EmaState``), at the effective decay ``min(decay,
    (1+t)/(10+t))`` after update ``t``. Evaluate with ``ema_params``
    and ``ema_model_state``."""
    d = float(np.float32(decay))

    def init(params):
        return EmaState(inner=opt.init(params),
                        ema={k: p.detach().float().clone()
                             for k, p in params.items()},
                        count=counter(), decay=d)

    @torch.no_grad()
    def update(grads, opt_state, params):
        opt.update(grads, opt_state.inner, params)
        opt_state.count.add_(1)
        eff, rest = _ema_scalars(d, opt_state.count, _device(params))
        for k, e in opt_state.ema.items():
            _lerp_into(e, params[k], eff, rest)

    return Optimizer(init, update)


def _f32_copy(state: dict) -> dict:
    return {k: (v.detach().float().clone() if v.is_floating_point()
                else v.detach().clone()) for k, v in state.items()}


@torch.no_grad()
def ema_update_state(opt_state, state: dict):
    """Averages the model ``state`` (``{name: tensor}``: BN's moving
    statistics, an MoE layer's ``load`` and ``aux_loss``) into
    ``opt_state.mstate`` at the weights' effective decay,
    the count already advanced by the update; non-float leaves are copied
    through. A no-op unless ``opt_state`` is an ``EmaState``; a missing
    ``mstate`` is seeded with a float32 copy of ``state``. Returns the
    state (a new ``EmaState`` when seeded)."""
    if not isinstance(opt_state, EmaState):
        return opt_state
    if opt_state.mstate is None:
        return opt_state._replace(mstate=_f32_copy(state))
    eff, rest = _ema_scalars(opt_state.decay, opt_state.count,
                             _device(opt_state.mstate))
    for k, m in opt_state.mstate.items():
        if m.is_floating_point():
            _lerp_into(m, state[k], eff, rest)
        else:
            m.copy_(state[k])
    return opt_state


def ema_seed_model_state(opt_state, state: dict, decay=None):
    """At a load or a warm start: backfills a legacy ``EmaState``'s missing
    ``decay`` from ``decay`` (the live run's ``--ema``) and seeds a
    missing ``mstate`` from ``state``; the average is not advanced."""
    if isinstance(opt_state, EmaState):
        if opt_state.decay is None and decay is not None:
            opt_state = opt_state._replace(decay=float(np.float32(decay)))
        if opt_state.mstate is None:
            return ema_update_state(opt_state, state)
    return opt_state


def ema_model_state(opt_state, fallback=None):
    """The EMA'd model state if the optimizer state has one, else
    ``fallback``: evaluate EMA weights with this state."""
    if isinstance(opt_state, EmaState) and opt_state.mstate is not None:
        return opt_state.mstate
    return fallback


def ema_params(opt_state):
    """The EMA weights (``{name: tensor}``) if ``opt_state`` has them,
    else None."""
    if isinstance(opt_state, EmaState):
        return opt_state.ema
    return None


def with_frozen(opt: Optimizer, prefixes) -> Optimizer:
    """Freezes every parameter whose tree path (``tree_path``) starts with
    one of ``prefixes``: its gradient is zeroed before ``opt``'s update
    and the parameter restored after it, so momentum or weight decay move
    neither it (their slots still advance). ``init`` asserts that a
    parameter matched."""
    prefixes = tuple(p.strip() for p in prefixes if p.strip())
    assert prefixes, "with_frozen needs at least one path prefix"

    def frozen(name: str) -> bool:
        return any(tree_path(name).startswith(p) for p in prefixes)

    def init(params):
        assert any(frozen(k) for k in params), \
            f"--freeze {prefixes} matched no parameters"
        return opt.init(params)

    @torch.no_grad()
    def update(grads, opt_state, params):
        kept = {k: p.clone() for k, p in params.items() if frozen(k)}
        grads = {k: torch.zeros_like(g) if k in kept else g
                 for k, g in grads.items()}
        opt.update(grads, opt_state, params)
        for k, p in kept.items():
            params[k].copy_(p)

    return Optimizer(init, update)


def make_optimizer(name: str, learning_rate: float, momentum: float = 0.0,
                   schedule: str = "constant", total_steps: int = 0,
                   warmup_steps: int = 0, weight_decay: float = 0.0,
                   grad_clip: float = 0.0) -> Optimizer:
    """``cnn_tpu``'s chain: ``momentum`` is 0.9 unless given; weight decay
    goes before ``sgd`` (or between Adam and the rate: ``adamw``); a clip
    (``grad_clip > 0``) is the outermost link; plain ``sgd`` only for
    ``sgd`` with no momentum, a constant rate and no clip."""
    lr = make_schedule(learning_rate, schedule, total_steps, warmup_steps)

    def clipped(tx: GradientTransformation) -> Optimizer:
        if grad_clip > 0.0:
            tx = chain(clip_by_global_norm(grad_clip), tx)
        return from_transform(tx)

    mom = momentum or (0.9 if name == "momentum" else 0.0)
    if weight_decay > 0.0:
        if name == "adam":
            return clipped(adamw(lr, weight_decay=weight_decay))
        return clipped(chain(add_decayed_weights(weight_decay),
                             sgd_transform(lr, mom or None)))
    if name == "sgd" and mom == 0.0 and isinstance(lr, float) \
            and grad_clip == 0.0:
        return sgd(lr)
    if name in ("sgd", "momentum"):
        return clipped(sgd_transform(lr, mom or None))
    if name == "adam":
        return clipped(adam(lr))
    raise ValueError(f"unknown optimizer '{name}'")
