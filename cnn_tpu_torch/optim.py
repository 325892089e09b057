"""Optimizers and learning-rate schedules, counterpart of ``cnn_tpu/optim.py``.

``sgd`` is the reference's ``w -= lr * g``; ``momentum`` (and ``sgd`` with a
momentum or a schedule) is optax's ``sgd``: the trace ``t = g + mu * t``,
then ``p += -lr(count) * t``, with ``count`` the number of updates made
before this one (optax's ``ScaleByScheduleState.count``). The schedules are
plain functions equal to optax's.

An ``Optimizer`` is ``(init, update)`` as in ``cnn_tpu``: ``init(params)``
makes the state (``{"trace": {name: tensor} or None, "count": int,
"scheduled": bool}``, the last saying whether the rate is a schedule, as
optax's state then holds the count; ``utils/checkpoint.py`` writes the
state in optax's layout from it) and
``update(grads, opt_state, params)`` changes the parameters and the state
in place. ``params`` and ``grads`` are dicts keyed by parameter name.

Weight decay, clipping, Adam, EMA and freezing are not ported yet: asking
for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[dict], dict]
    update: Callable[[dict, dict, dict], None]


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
    """``count -> lr``, or a float for a constant rate with no warmup (as
    ``cnn_tpu`` returns a float there)."""
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


def _update(lr, momentum: float) -> Optimizer:
    schedule = lr if callable(lr) else constant_schedule(lr)

    def init(params: dict) -> dict:
        trace = ({k: torch.zeros_like(p) for k, p in params.items()}
                 if momentum else None)
        return {"trace": trace, "count": 0, "scheduled": callable(lr)}

    @torch.no_grad()
    def update(grads: dict, opt_state: dict, params: dict) -> None:
        step = -schedule(opt_state["count"])
        for name, p in params.items():
            u = grads[name].to(p.dtype)
            if momentum:
                t = opt_state["trace"][name]
                t.mul_(momentum).add_(u)
                u = t
            p.add_(u * step)
        opt_state["count"] += 1

    return Optimizer(init, update)


def sgd(learning_rate: float) -> Optimizer:
    """Plain SGD: ``w -= lr * g``, the reference's exact update."""
    return _update(float(learning_rate), 0.0)


def make_optimizer(name: str, learning_rate: float, momentum: float = 0.0,
                   schedule: str = "constant", total_steps: int = 0,
                   warmup_steps: int = 0, weight_decay: float = 0.0,
                   grad_clip: float = 0.0) -> Optimizer:
    """``sgd`` or ``momentum`` (momentum 0.9 unless given), on a schedule."""
    for flag, value in (("weight_decay", weight_decay),
                        ("grad_clip", grad_clip)):
        if value:
            raise NotImplementedError(f"{flag} is not ported yet")
    if name == "adam":
        raise NotImplementedError("adam is not ported yet")
    if name not in ("sgd", "momentum"):
        raise ValueError(f"unknown optimizer '{name}'")
    lr = make_schedule(learning_rate, schedule, total_steps, warmup_steps)
    mom = momentum or (0.9 if name == "momentum" else 0.0)
    return _update(lr, mom)
