"""Train and eval steps on one device, counterpart of
``cnn_tpu/parallel/train_step.py``.

A train step runs, in order: the augmentation (or the uint8 normalize
kernel), the forward in training mode (BN by batch statistics, moving
statistics updated in place), the softmax cross-entropy, the backward
(autograd through the conv and pool kernels' Functions) and the optimizer
update. PyTorch runs eagerly and in place, so the step changes the model,
the optimizer state and the generator of ``TrainState`` and returns it.

``compute_dtype`` is None / float32, or bf16: ``cnn_tpu``'s bf16 policy.
The master parameters, the optimizer state and BN's moving statistics stay
float32; uint8 images are normalized to float32 and rounded to bf16 (an
``augment_fn``'s output is cast to it); each conv and the linear layer cast
their input and weights to bf16; the logits go to float32 before the loss.

A Dropout in the model draws its channels from ``ts.rng`` in training.

Eval runs in eval mode without gradients: ``make_eval_step`` (with
test-time augmentation, ``tta``), ``make_ensemble_eval_step`` and
``make_forward`` (probabilities, for inference).

Not ported yet (each raises ``NotImplementedError``): other compute dtypes
(float16), meshes, ``grad_accum``, ``steps_per_call``, mixup/cutmix and
distillation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from cnn_tpu_torch.nn.module import leaf_name
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
    """``{name: parameter}`` in layer order, each named by its path in
    ``cnn_tpu``'s param tree (``nn/module.py:leaf_name``: ``conv_layer_1.w``,
    ``block_2/body/block_2_conv1.w``; a ``StackedBlocks``' stacked tensor
    ``trunk/body/b_conv1.w``)."""
    net = getattr(model, "net", model)
    return {leaf_name(path): t for path, t, is_state in net.tree_leaves()
            if not is_state}


def create_train_state(model, optimizer, seed: int = 0) -> TrainState:
    device = next(model.parameters()).device
    rng = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model, optimizer.init(named_params(model)), 0, rng, seed)


def check_supported(**flags) -> None:
    """Raises ``NotImplementedError`` naming each option not ported yet."""
    off = {"compute_dtype": (None, torch.float32, torch.bfloat16),
           "mesh": (None,),
           "grad_accum": (1,), "steps_per_call": (1,), "mixup": (0.0,),
           "cutmix": (0.0,), "distill": (None,), "tta": tuple(TTA_VIEWS)}
    for name, value in flags.items():
        if value not in off[name]:
            raise NotImplementedError(f"{name}={value!r} is not ported yet")


def prep(images: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """uint8 -> float32 by the normalize kernel, rounded to
    ``compute_dtype`` when given (``_prep``); float passes through."""
    if images.dtype != torch.uint8:
        return images
    return uint8_normalize(images, compute_dtype or torch.float32)


def loss_fn(model, images, labels, label_smoothing: float = 0.0,
            compute_dtype=None, generator=None):
    """Forward and loss; returns ``(loss, correct)``. ``generator`` feeds
    a Dropout in training mode."""
    logits = model(images, compute_dtype=compute_dtype,
                   generator=generator).float()
    loss = softmax_cross_entropy(logits, labels, label_smoothing)
    correct = (logits.argmax(dim=-1) == labels).sum()
    return loss, correct


def apply_gradients(ts: TrainState, optimizer, images, labels,
                    label_smoothing: float = 0.0, compute_dtype=None) -> dict:
    """Forward in training mode, backward, optimizer update; advances
    ``ts.step``; a Dropout draws from ``ts.rng``. Returns the metrics, as
    device tensors."""
    ts.model.train()
    params = named_params(ts.model)
    loss, correct = loss_fn(ts.model, images, labels, label_smoothing,
                            compute_dtype, ts.rng)
    grads = torch.autograd.grad(loss, list(params.values()))
    optimizer.update(dict(zip(params, grads)), ts.opt_state, params)
    ts.step += 1
    return {"loss": loss.detach(), "correct": correct}


def to_compute(images, generator, augment_fn=None, compute_dtype=None):
    """The step's images: ``augment_fn(generator, images)`` cast to
    ``compute_dtype`` when both are given, else ``prep``."""
    if augment_fn is None:
        return prep(images, compute_dtype)
    images = augment_fn(generator, images)
    return images if compute_dtype is None else images.to(compute_dtype)


def make_train_step(model, optimizer, *, compute_dtype=None, mesh=None,
                    augment_fn=None, label_smoothing: float = 0.0,
                    grad_accum: int = 1, mixup: float = 0.0,
                    cutmix: float = 0.0, distill=None):
    """Returns ``(ts, images, labels) -> (ts, metrics)``.

    ``images``: [B,H,W,C] uint8 (normalized on the device) or float;
    ``labels``: [B] int. ``augment_fn(generator, images)`` runs first when
    given (e.g. ``ops/augment.py:augment_batch``); its output is cast to
    ``compute_dtype`` when that is given.
    """
    check_supported(compute_dtype=compute_dtype, mesh=mesh,
                    grad_accum=grad_accum, mixup=mixup, cutmix=cutmix,
                    distill=distill)

    def step(ts: TrainState, images, labels):
        images = to_compute(images, ts.rng, augment_fn, compute_dtype)
        metrics = apply_gradients(ts, optimizer, images, labels,
                                  label_smoothing, compute_dtype)
        return ts, metrics

    return step


# test-time augmentation: the views of a batch (NHWC), flipped after prep
TTA_VIEWS = {
    "": lambda x: (x,),
    "hflip": lambda x: (x, torch.flip(x, dims=(2,))),
    "flips": lambda x: (x, torch.flip(x, dims=(2,)), torch.flip(x, dims=(1,)),
                        torch.flip(x, dims=(1, 2))),
}


def metrics_from_log_ps(log_ps, labels) -> dict:
    """Eval metrics from per-view and per-model log-probabilities: the
    class probabilities averaged, in log space (``logsumexp - log n``),
    as ``cnn_tpu``'s ``_metrics_from_log_ps``; the mean NLL, the count of
    right argmaxes and the predictions."""
    log_p = torch.logsumexp(torch.stack(log_ps), dim=0) - math.log(len(log_ps))
    nll = -log_p.gather(1, labels.long()[:, None])[:, 0]
    pred = log_p.argmax(dim=-1)
    return {"loss": nll.mean(), "correct": (pred == labels).sum(),
            "pred": pred}


def make_eval_step(model, *, compute_dtype=None, mesh=None, tta: str = ""):
    """Returns ``(images, labels) -> {"loss", "correct", "pred"}`` in eval
    mode (``metrics_from_log_ps``). ``tta``: '' (off), 'hflip' (the image
    and its horizontal flip) or 'flips' (all four flips); the class
    probabilities are averaged over the views."""
    check_supported(mesh=mesh)
    return make_ensemble_eval_step((model,), compute_dtype=compute_dtype,
                                   tta=tta)


def make_ensemble_eval_step(models, *, compute_dtype=None, tta: str = ""):
    """``make_eval_step`` over a model ensemble: the class probabilities
    are averaged over every (model, view) pair. Returns ``(images,
    labels) -> metrics``."""
    check_supported(compute_dtype=compute_dtype, tta=tta)
    models = tuple(models)

    def step(images, labels):
        images = prep(images, compute_dtype)
        log_ps = []
        with torch.no_grad():
            for model in models:
                model.eval()
                for view in TTA_VIEWS[tta](images):
                    logits = model(view, compute_dtype=compute_dtype)
                    log_ps.append(torch.log_softmax(logits.float(), dim=-1))
        return metrics_from_log_ps(log_ps, labels)

    return step


def make_forward(model, *, compute_dtype=None):
    """Returns ``images -> probs``: uint8 [B,H,W,3] through the normalize
    kernel (float passes through), the model in eval mode without
    gradients, a float32 softmax."""
    check_supported(compute_dtype=compute_dtype)

    def fwd(images):
        model.eval()
        with torch.no_grad():
            logits = model(prep(images, compute_dtype),
                           compute_dtype=compute_dtype)
            return torch.softmax(logits.float(), dim=-1)

    return fwd
