"""Train and eval steps on one device, counterpart of
``cnn_tpu/parallel/train_step.py``.

A train step runs, in order: the augmentation (or the uint8 normalize
kernel), the forward in training mode (BN by batch statistics, moving
statistics updated in place), the softmax cross-entropy, the backward
(autograd through the conv and pool kernels' Functions) and the optimizer
update. PyTorch runs eagerly and in place, so the step changes the model,
the optimizer state and the generator of ``TrainState`` and returns it.

Not ported yet (each raises ``NotImplementedError``): bf16 compute, meshes,
``grad_accum``, ``steps_per_call``, mixup/cutmix, distillation and TTA.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from cnn_tpu_torch.ops.hopper.normalize import uint8_normalize
from cnn_tpu_torch.ops.losses import softmax_cross_entropy


@dataclass
class TrainState:
    """``model`` holds the params and the BN state; ``rng`` draws every
    random number of the steps on the model's device; ``seed`` keys the
    per-epoch permutations of the epoch samplers."""
    model: nn.Module
    opt_state: dict
    step: int
    rng: torch.Generator
    seed: int


def named_params(model) -> dict:
    """``{"<layer>.<key>": parameter}`` in layer order, ``cnn_tpu``'s names."""
    net = getattr(model, "net", model)
    return {f"{layer.name}.{k}": p for layer in net
            for k, p in layer.named_parameters(recurse=False)}


def create_train_state(model, optimizer, seed: int = 0) -> TrainState:
    device = next(model.parameters()).device
    rng = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model, optimizer.init(named_params(model)), 0, rng, seed)


def check_supported(**flags) -> None:
    """Raises ``NotImplementedError`` naming each option not ported yet."""
    off = {"compute_dtype": (None, torch.float32), "mesh": (None,),
           "grad_accum": (1,), "steps_per_call": (1,), "mixup": (0.0,),
           "cutmix": (0.0,), "distill": (None,), "tta": ("",)}
    for name, value in flags.items():
        if value not in off[name]:
            raise NotImplementedError(f"{name}={value!r} is not ported yet")


def prep(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 by the normalize kernel; float passes through."""
    return uint8_normalize(images) if images.dtype == torch.uint8 else images


def loss_fn(model, images, labels, label_smoothing: float = 0.0):
    """Forward and loss; returns ``(loss, correct)``."""
    logits = model(images).float()
    loss = softmax_cross_entropy(logits, labels, label_smoothing)
    correct = (logits.argmax(dim=-1) == labels).sum()
    return loss, correct


def apply_gradients(ts: TrainState, optimizer, images, labels,
                    label_smoothing: float = 0.0) -> dict:
    """Forward in training mode, backward, optimizer update; advances
    ``ts.step``. Returns the metrics, as device tensors."""
    ts.model.train()
    params = named_params(ts.model)
    loss, correct = loss_fn(ts.model, images, labels, label_smoothing)
    grads = torch.autograd.grad(loss, list(params.values()))
    optimizer.update(dict(zip(params, grads)), ts.opt_state, params)
    ts.step += 1
    return {"loss": loss.detach(), "correct": correct}


def make_train_step(model, optimizer, *, compute_dtype=None, mesh=None,
                    augment_fn=None, label_smoothing: float = 0.0,
                    grad_accum: int = 1, mixup: float = 0.0,
                    cutmix: float = 0.0, distill=None):
    """Returns ``(ts, images, labels) -> (ts, metrics)``.

    ``images``: [B,H,W,C] uint8 (normalized on the device) or float;
    ``labels``: [B] int. ``augment_fn(generator, images)`` runs first when
    given (e.g. ``ops/augment.py:augment_batch``).
    """
    check_supported(compute_dtype=compute_dtype, mesh=mesh,
                    grad_accum=grad_accum, mixup=mixup, cutmix=cutmix,
                    distill=distill)

    def step(ts: TrainState, images, labels):
        images = (augment_fn(ts.rng, images) if augment_fn is not None
                  else prep(images))
        metrics = apply_gradients(ts, optimizer, images, labels,
                                  label_smoothing)
        return ts, metrics

    return step


def make_eval_step(model, *, compute_dtype=None, mesh=None, tta: str = ""):
    """Returns ``(images, labels) -> {"loss", "correct", "pred"}`` in eval
    mode: the mean NLL of the log-softmax, the count of right argmaxes and
    the predictions."""
    check_supported(compute_dtype=compute_dtype, mesh=mesh, tta=tta)

    def step(images, labels):
        model.eval()
        with torch.no_grad():
            log_p = torch.log_softmax(model(prep(images)).float(), dim=-1)
        nll = -log_p.gather(1, labels.long()[:, None])[:, 0]
        pred = log_p.argmax(dim=-1)
        return {"loss": nll.mean(), "correct": (pred == labels).sum(),
                "pred": pred}

    return step
