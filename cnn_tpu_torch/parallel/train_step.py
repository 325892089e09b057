"""Train and eval steps on one device, counterpart of
``cnn_tpu/parallel/train_step.py``.

A train step runs, in order: the augmentation (or the uint8 normalize
kernel), then for each of ``grad_accum`` microbatches (one by default) the
batch mixing (MixUp / CutMix, ``ops/augment.py:batch_mix``), the teachers'
eval forwards (distillation), the forward in training mode (BN by batch
statistics, moving statistics updated in place, so once a microbatch),
the loss and the backward (autograd through the conv and pool kernels'
Functions); then the optimizer update on the mean gradient and the EMA of
the model state (``optim.ema_update_state``). PyTorch runs eagerly and in
place, so the step changes the model, the optimizer state and the
generator of ``TrainState`` and returns it.

The loss is ``cnn_tpu``'s ``_loss_fn``: the softmax cross-entropy, mixed
as ``lam * CE(y) + (1 - lam) * CE(y[perm])`` under MixUp / CutMix, then
``alpha * loss + (1 - alpha) * KD`` with a teacher, KD the
``T^2``-scaled KL against the mean of the teachers' softmaxes at ``T``,
plus in training every auxiliary term a layer left (``collect_aux_losses``:
the MoE balance loss).

``remat=True`` wraps the whole training forward in ``torch.utils.checkpoint``
(``cnn_tpu``'s ``jax.checkpoint`` of ``apply``): the backward recomputes
it. The recompute draws nothing new and updates no state twice
(``remat_forward``), so the gradients and the new state are those of
``remat=False``, bit for bit.

``compute_dtype`` is None / float32, or bf16: ``cnn_tpu``'s bf16 policy.
The master parameters, the optimizer state and BN's moving statistics stay
float32; uint8 images are normalized to float32 and rounded to bf16 (an
``augment_fn``'s output is cast to it); each conv and the linear layer cast
their input and weights to bf16; the logits go to float32 before the loss.

Every draw (a Dropout's channels, the mix) comes from ``ts.rng``.

Eval runs in eval mode without gradients: ``make_eval_step`` (with
test-time augmentation, ``tta``), ``make_ensemble_eval_step`` and
``make_forward`` (probabilities, for inference); ``ema_weights`` puts a
train state's EMA weights and model state in its model around an eval.

On a mesh (``parallel/mesh.py``, ``mesh=``) a step computes what
``cnn_tpu``'s GSPMD step computes on the global batch, which is what the
single-device step computes: not plain DDP, whose BN statistics and MoE
capacities would be each rank's. ``shard_train_state`` puts the mesh in
the model's layers (``shard_model``: BN's statistics over ``'data'`` and
``'spatial'``, MoE's routing over ``'data'``, ``nn/moe.py``; the layers
run on strips of image rows over ``'spatial'``, ``nn/module.py``) and cuts
each leaf that the layers' ``param_pspecs`` shard over ``'model'``, and,
on a mesh with an ``'expert'`` axis, each that MoE's
``param_pspecs_ep`` shards over it, to this rank's slice, its optimizer
leaves with it (``model_pspecs``, ``cnn_tpu``'s walk of ``layers``,
``body`` and ``proj``). The steps take the global batch and keep this
rank's rows (``Mesh.rows``), whole images, which the model cuts into
strips of rows after the augmentation and the mix. Each rank draws from a
generator in the same state, so every draw is the global batch's, each
rank keeping its rows (the augmentation: ``ops/augment.py:shard_draws``;
MixUp / CutMix mix its rows with partners from the gathered batch; a
Dropout's channels are one draw for all). The objective on a rank is its
part of the global batch's loss (``loss / (D * S * E)`` over the sizes of
``'data'``, ``'spatial'`` and ``'expert'``: the aux terms are the global
batch's, added on every rank, and ``parallel/collectives.py`` sums the
cotangents over these axes); a gradient is summed over each of the three
axes that does not shard its param, each in one bucket, and a replicated
param's averaged over ``'model'`` (which keeps the replicas bit-equal);
``grad_clip``'s norm adds every ``'model'`` and ``'expert'`` shard's
squares (``optim.global_norm``); the metrics are the global batch's, the
same on every rank. Microbatch ``k`` of ``grad_accum`` is slice ``k`` of
every rank's rows (``cnn_tpu``'s ``make_microbatch_regroup``).
``unsharded`` holds the full tensors in place around a checkpoint's write
or read.

The pipeline's steps, on a ``('data', 'stage'[, 'model'])`` mesh, are
``parallel/pipeline.py``'s.

Not ported (each raises ``NotImplementedError``): other compute dtypes
(float16).
"""

from __future__ import annotations

import contextlib
import math
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from cnn_tpu_torch.nn.module import Layer, StackedBlocks, leaf_name, leaf_path
from cnn_tpu_torch.ops.augment import (apply_mix, batch_mix, draw_mix,
                                       shard_draws)
from cnn_tpu_torch.ops.hopper.normalize import uint8_normalize
from cnn_tpu_torch.ops.losses import (distillation_loss_from_probs,
                                      softmax_cross_entropy)
from cnn_tpu_torch.optim import (ema_model_state, ema_params,
                                 ema_update_state)


@dataclass
class TrainState:
    """``model`` holds the params and the BN state; ``rng`` draws every
    random number of the steps on the model's device; ``seed`` keys the
    per-epoch permutations of the epoch samplers. On a mesh
    (``shard_train_state``): ``mesh``, and ``shards``, the params held as
    this rank's slice -> ``(axis, dim)``, the mesh axis and the dim cut (a
    pipeline's trunk leaves, BN buffers among them, -> a tuple of such
    cuts, ``_cuts``: ``parallel/pipeline.py:shard_pp_train_state``)."""
    model: nn.Module
    opt_state: object
    step: int
    rng: torch.Generator
    seed: int
    mesh: object = None
    shards: dict = field(default_factory=dict)


def named_params(model) -> dict:
    """``{name: parameter}`` in layer order, each named by its path in
    ``cnn_tpu``'s param tree (``nn/module.py:leaf_name``: ``conv_layer_1.w``,
    ``block_2/body/block_2_conv1.w``; a ``StackedBlocks``' stacked tensor
    ``trunk/body/b_conv1.w``)."""
    net = getattr(model, "net", model)
    return {leaf_name(path): t for path, t, is_state in net.tree_leaves()
            if not is_state}


def named_state(model) -> dict:
    """``{name: buffer}`` of the model state (BN's moving statistics),
    named as ``named_params`` names the params."""
    net = getattr(model, "net", model)
    return {leaf_name(path): t for path, t, is_state in net.tree_leaves()
            if is_state}


def create_train_state(model, optimizer, seed: int = 0) -> TrainState:
    """The optimizer's fresh state, its EMA of the model state seeded
    here (``cnn_tpu``'s ``create_train_state`` does the same)."""
    device = next(model.parameters()).device
    rng = torch.Generator(device=device).manual_seed(seed)
    opt_state = ema_update_state(optimizer.init(named_params(model)),
                                 named_state(model))
    return TrainState(model, opt_state, 0, rng, seed)


@contextmanager
def ema_weights(ts: TrainState):
    """Inside the block ``ts.model`` holds the EMA weights of
    ``ts.opt_state`` and its EMA'd model state (the raw state where a
    legacy checkpoint has none); outside, its own. Without an EMA, the
    model as it is."""
    ema = ema_params(ts.opt_state)
    if ema is None:
        yield
        return
    live = {**named_params(ts.model), **named_state(ts.model)}
    swap = {**ema, **ema_model_state(ts.opt_state, {})}
    with torch.no_grad():
        kept = {k: live[k].clone() for k in swap}
        for k, v in swap.items():
            live[k].copy_(v)
    try:
        yield
    finally:
        with torch.no_grad():
            for k, v in kept.items():
                live[k].copy_(v)


def check_supported(**flags) -> None:
    """Raises ``NotImplementedError`` naming each option not ported."""
    off = {"compute_dtype": (None, torch.float32, torch.bfloat16),
           "tta": tuple(TTA_VIEWS)}
    for name, value in flags.items():
        if value not in off[name]:
            raise NotImplementedError(f"{name}={value!r} is not ported yet")


def prep(images: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """uint8 -> float32 by the normalize kernel, rounded to
    ``compute_dtype`` when given (``_prep``); float passes through."""
    if images.dtype != torch.uint8:
        return images
    return uint8_normalize(images, compute_dtype or torch.float32)


def collect_aux_losses(model):
    """The sum of the differentiable auxiliary terms (``aux``) that the
    model's layers left in their last training forward (the MoE balance
    loss, ``nn/moe.py``), or None where none did."""
    total = None
    for m in model.modules():
        aux = getattr(m, "aux", None)
        if aux is not None:
            total = aux if total is None else total + aux
    return total


def remat_forward(model, images, compute_dtype=None, generator=None):
    """The training forward under ``torch.utils.checkpoint``: returns
    ``(logits, aux)`` (``collect_aux_losses``), and the backward recomputes
    the forward. The forward draws from a copy of ``generator`` taken at
    its state on entry, which the recompute replays, and ``generator`` is
    left where the first run left its copy; the recompute puts back every
    state tensor it wrote (BN's moving statistics, the MoE load) and drops
    the auxiliary terms it left (which would keep its graph alive through
    the backward). So the draws, the state and the gradients are those of
    the plain forward."""
    state = list(named_state(model).values())
    start = None if generator is None else generator.get_state()
    done = []

    def run(x):
        g = generator
        if g is not None:
            g = torch.Generator(device=generator.device)
            g.set_state(start)
        kept = [t.clone() for t in state] if done else None
        logits = model(x, compute_dtype=compute_dtype, generator=g)
        aux = collect_aux_losses(model)
        if kept is not None:        # a recompute: its writes are undone,
            with torch.no_grad():   # and no layer keeps its graph alive
                for t, k in zip(state, kept):
                    t.copy_(k)
            for m in model.modules():
                if getattr(m, "aux", None) is not None:
                    m.aux = None
        else:
            done.append(True)
            if generator is not None:
                generator.set_state(g.get_state())
        return logits, aux

    # the recompute runs to the end of ``run``, where it undoes its writes
    # (by default it stops once it has what the backward needs)
    with torch_checkpoint.set_checkpoint_early_stop(False):
        return torch_checkpoint.checkpoint(run, images, use_reentrant=False)


def loss_fn(model, images, labels, label_smoothing: float = 0.0,
            compute_dtype=None, generator=None, mix=None, dist=None,
            remat: bool = False):
    """Forward and loss (``cnn_tpu``'s ``_loss_fn``); returns ``(loss,
    correct)``. ``generator`` feeds a Dropout in training mode; ``mix`` is
    ``(partner labels, lam)`` of a mixed batch, ``dist`` ``(teacher_probs, T,
    alpha)``; ``remat`` runs a training forward through
    ``remat_forward``. In training the layers' auxiliary terms are added
    (``collect_aux_losses``)."""
    if remat and model.training:
        logits, aux = remat_forward(model, images, compute_dtype, generator)
    else:
        logits = model(images, compute_dtype=compute_dtype,
                       generator=generator)
        aux = collect_aux_losses(model) if model.training else None
    loss, correct = objective(logits, labels, label_smoothing, mix, dist)
    if aux is not None:
        loss = loss + aux
    return loss, correct


def objective(logits, labels, label_smoothing: float = 0.0, mix=None,
              dist=None):
    """``(loss, correct)`` of ``logits`` (taken to float32): the (mixed)
    cross-entropy, then the distillation term (``loss_fn``'s ``mix`` and
    ``dist``), and the count of right argmaxes."""
    logits = logits.float()
    if mix is not None:
        partner, lam = mix
        loss = (lam * softmax_cross_entropy(logits, labels, label_smoothing)
                + (1.0 - lam) * softmax_cross_entropy(
                    logits, partner, label_smoothing))
    else:
        loss = softmax_cross_entropy(logits, labels, label_smoothing)
    if dist is not None:
        probs, temp, alpha = dist
        loss = alpha * loss + (1.0 - alpha) * distillation_loss_from_probs(
            logits, probs, temp)
    return loss, (logits.argmax(dim=-1) == labels).sum()


def normalize_distill(distill):
    """A ``distill`` spec, ``(teacher model or list of them, T, alpha)``
    (the models hold their weights), as ``([teachers], T, alpha)``, or
    None."""
    if distill is None:
        return None
    teacher, temp, alpha = distill
    if not isinstance(teacher, (list, tuple)):
        teacher = [teacher]
    return list(teacher), temp, alpha


def teacher_probs(teachers, images, temperature: float, compute_dtype=None):
    """The mean over ``teachers`` of ``softmax(logits / T)``, float32, the
    teachers run in eval mode without gradients."""
    probs = None
    with torch.no_grad():
        for tm in teachers:
            tm.eval()
            logits = tm(images, compute_dtype=compute_dtype)
            p = torch.softmax(logits.float() / temperature, dim=-1)
            probs = p if probs is None else probs + p
    return probs / len(teachers)


def mix_and_teacher_targets(generator, images, labels, *,
                            mixup: float = 0.0, cutmix: float = 0.0,
                            distill=None, compute_dtype=None, mesh=None):
    """The step body's first half: the batch mix, then the teachers' soft
    targets on the mixed images. ``distill`` is a ``normalize_distill``
    result. Returns ``(images, mix, dist)``, the last two the trailing
    arguments of ``loss_fn``. On a mesh ``images`` and ``labels`` are this
    rank's rows of the batch, which the draw and the partners span."""
    mix = None
    if (mixup > 0.0 or cutmix > 0.0) and (mesh is None
                                          or not mesh.active("data")):
        images, perm, lam = batch_mix(generator, images, mixup_alpha=mixup,
                                      cutmix_alpha=cutmix)
        mix = (labels[perm], lam)
    elif mixup > 0.0 or cutmix > 0.0:
        b, h, w = images.shape[:3]
        lo, n = mesh.index("data") * b, b * mesh.size("data")
        d = draw_mix(generator, n, h, w, mixup, cutmix)
        images, perm, lam = apply_mix(
            images, d._replace(perm=d.perm[lo:lo + b]),
            partners=mesh.assemble(images, "data", n, lo))
        mix = (mesh.assemble(labels, "data", n, lo)[perm], lam)
    dist = None
    if distill is not None:
        teachers, temp, alpha = distill
        dist = (teacher_probs(teachers, images, temp, compute_dtype), temp,
                alpha)
    return images, mix, dist


def accumulate_grads(ts: TrainState, images, labels, *, grad_accum: int = 1,
                     label_smoothing: float = 0.0, compute_dtype=None,
                     mixup: float = 0.0, cutmix: float = 0.0, distill=None,
                     remat: bool = False, mesh=None):
    """Mean gradients over ``grad_accum`` equal microbatches, run in turn
    (``cnn_tpu``'s ``accumulate_grads``): BN normalizes each by its own
    statistics and updates its moving statistics once each; each draws
    its own mix and Dropout channels from ``ts.rng``, the teachers see the
    mixed microbatch; ``remat`` recomputes each forward in its backward
    (``remat_forward``). One microbatch is the plain step. Returns
    ``({name: grad}, loss, correct)``, the loss the mean over microbatches
    and ``correct`` the sum.

    On ``mesh`` the batch is this rank's rows and microbatch ``k`` is
    their slice ``k``: ``cnn_tpu``'s regroup, where each microbatch takes
    an equal contiguous slice of every shard. Each rank differentiates its
    part of the objective (the loss over the ``'data'``, ``'spatial'`` and
    ``'expert'`` ranks); the gradients (a param's not over the axis that
    shards it) and the loss are summed over those axes, ``correct`` over
    ``'data'`` (the global batch's). A param that no output of this rank
    reaches (a layer with no image row here) has a zero part."""
    K = grad_accum
    B = images.shape[0]
    if B % K:
        raise ValueError(
            f"batch {B} not divisible by grad_accum {K}" if mesh is None else
            f"a shard's {B} rows do not split into {K} microbatches (a "
            "microbatch smaller than the data axis is not ported)")
    mb = B // K
    split = [a for a in ("data", "spatial", "expert") if mesh is not None
             and mesh.active(a) and mesh.size(a) > 1]
    parts = math.prod(mesh.size(a) for a in split)
    ts.model.train()
    params = named_params(ts.model)
    gsum = lsum = csum = None
    for i in range(K):
        x, y = images[i * mb:(i + 1) * mb], labels[i * mb:(i + 1) * mb]
        x, mix, dist = mix_and_teacher_targets(
            ts.rng, x, y, mixup=mixup, cutmix=cutmix, distill=distill,
            compute_dtype=compute_dtype, mesh=mesh)
        loss, correct = loss_fn(ts.model, x, y, label_smoothing,
                                compute_dtype, ts.rng, mix, dist, remat)
        if parts > 1:
            loss = loss / parts
        g = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
        g = [torch.zeros_like(p) if t is None else t
             for t, p in zip(g, params.values())]
        if gsum is None:
            gsum, lsum, csum = list(g), loss.detach(), correct
        else:
            gsum = [a + b for a, b in zip(gsum, g)]
            lsum, csum = lsum + loss.detach(), csum + correct
    if K > 1:
        gsum = [g / K for g in gsum]
        lsum = lsum / K
    owned = [shard_axis(p) for p in params.values()]
    for axis in split:
        summed = [i for i, a in enumerate(owned) if a != axis]
        for i, t in zip(summed, sum_over([gsum[i] for i in summed], mesh,
                                         axis)):
            gsum[i] = t
        lsum = mesh.all_sum(lsum, axis)
    if "data" in split:
        csum = mesh.all_sum(csum, "data")
    if mesh is not None and mesh.active("model"):
        # a replicated param's gradient is the same on every 'model' rank
        # in exact arithmetic, but a backward kernel whose sum order varies
        # from run to run (cuDNN's) can move its last bits: the ranks'
        # mean keeps the replicas bit-equal
        rep = [i for i, p in enumerate(params.values())
               if getattr(p, "tp", None) is None]
        size = mesh.size("model")
        for i, g in zip(rep, sum_over([gsum[i] for i in rep], mesh,
                                      "model")):
            gsum[i] = g / size
    return dict(zip(params, gsum)), lsum, csum


def shard_axis(p) -> str | None:
    """The mesh axis whose ranks each hold a slice of param ``p``
    (``shard_train_state``), or None."""
    if getattr(p, "tp", None) is not None:
        return "model"
    return "expert" if getattr(p, "ep", None) is not None else None


def sum_over(tensors: list, mesh, axis: str) -> list:
    """Each tensor summed over ``mesh``'s ``axis``, in one collective of
    their concatenation."""
    if not tensors:
        return []
    flat = mesh.all_sum(torch.cat([t.reshape(-1) for t in tensors]), axis)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def apply_gradients(ts: TrainState, optimizer, images, labels,
                    label_smoothing: float = 0.0, compute_dtype=None, *,
                    grad_accum: int = 1, mixup: float = 0.0,
                    cutmix: float = 0.0, distill=None,
                    remat: bool = False, mesh=None) -> dict:
    """``accumulate_grads``, the optimizer update, the EMA of the model
    state; advances ``ts.step``. Returns the metrics, as device
    tensors."""
    grads, loss, correct = accumulate_grads(
        ts, images, labels, grad_accum=grad_accum,
        label_smoothing=label_smoothing, compute_dtype=compute_dtype,
        mixup=mixup, cutmix=cutmix, distill=distill, remat=remat, mesh=mesh)
    optimizer.update(grads, ts.opt_state, named_params(ts.model))
    ts.opt_state = ema_update_state(ts.opt_state, named_state(ts.model))
    ts.step += 1
    return {"loss": loss, "correct": correct}


def to_compute(images, generator, augment_fn=None, compute_dtype=None,
               mesh=None):
    """The step's images: ``augment_fn(generator, images)`` cast to
    ``compute_dtype`` when both are given, else ``prep``. On ``mesh``,
    ``images`` are this rank's shard of the batch, which the
    augmentation's draws span (``ops/augment.py:shard_draws``)."""
    if augment_fn is None:
        return prep(images, compute_dtype)
    draws = (shard_draws(mesh.index("data"), mesh.size("data"))
             if mesh is not None and mesh.size("data") > 1
             else contextlib.nullcontext())
    with draws:
        images = augment_fn(generator, images)
    return images if compute_dtype is None else images.to(compute_dtype)


def local_rows(mesh, images, labels, even: bool = True):
    """This rank's rows (``Mesh.rows``) of a global batch, on its device;
    ``even``: the shards must be equal (training)."""
    n = images.shape[0]
    if even and n % mesh.size("data"):
        raise ValueError(f"batch {n} does not split over "
                         f"{mesh.size('data')} data shards")
    lo, hi = mesh.rows(n)
    return images[lo:hi].to(mesh.device), labels[lo:hi].to(mesh.device)


# ------------------------------------------------------------ the mesh --

def spec_layers(model):
    """The layers whose ``param_pspecs`` ``cnn_tpu`` reads: the model's,
    and within each, those of its ``body`` and its ``proj`` (a
    ``StackedBlocks``' block is not entered)."""
    stack = list(getattr(model, "net", model))
    while stack:
        layer = stack.pop()
        yield layer
        body = getattr(layer, "body", None)
        if body is not None:
            stack.extend(body)
        proj = getattr(layer, "proj", None)
        if proj is not None:
            stack.append(proj)


def model_pspecs(model, mesh) -> dict:
    """``{layer name: {param key: spec}}``: each layer's declared
    ``'model'`` sharding on this mesh and, where the mesh has an
    ``'expert'`` axis, MoE's ``param_pspecs_ep`` (``cnn_tpu``'s
    ``model_pspecs``, a spec a tuple of axis names)."""
    model_dim = mesh.shape.get("model", 1)
    has_ep = "expert" in mesh.shape
    specs = {}
    for layer in spec_layers(model):
        ps = layer.param_pspecs(model_dim)
        ep = getattr(layer, "param_pspecs_ep", None)
        if has_ep and ep is not None:
            ps = {**(ps or {}), **ep()}
        if ps:
            specs[layer.name] = ps
    return specs


def _all_layers(model):
    for m in model.modules():
        yield m
        if isinstance(m, StackedBlocks):   # its template, off the tree
            yield from m.block.modules()


def shard_model(model, mesh) -> None:
    """Puts ``mesh`` in every layer of ``model`` (BN's statistics and MoE's
    routing then span its ``'data'`` axis)."""
    for m in _all_layers(model):
        if isinstance(m, Layer):
            m.mesh = mesh


def _opt_trees(node):
    """The ``{name: tensor}`` trees of an optimizer state."""
    if isinstance(node, dict):
        yield node
    elif isinstance(node, tuple):
        for v in node:
            yield from _opt_trees(v)


def _cuts(shard: tuple) -> tuple:
    """A shard's cuts: ``(axis, dim)``, or ``(axis, dim, V)`` for the
    ``'stage'`` rows of a pipelined trunk held as V chunks; a shard is one
    cut or a tuple of them, applied in turn."""
    return (shard,) if isinstance(shard[0], str) else tuple(shard)


def _own(t: torch.Tensor, shard: tuple, mesh) -> torch.Tensor:
    """This rank's slice of the full ``t`` over ``shard``'s cuts (a copy).
    A ``'stage'`` cut of ``V`` chunks keeps rows ``(k * S + s) * l + j``
    (``l = L / (S * V)``), chunk k at rows ``k * l + j``: ``cnn_tpu``'s
    interleaved placement; V = 1 keeps rows ``[s * l, (s + 1) * l)``."""
    for axis, dim, *v in _cuts(shard):
        n, i = mesh.size(axis), mesh.index(axis)
        if v:
            rows = t.shape[dim] // (n * v[0])
            t = t.unflatten(dim, (v[0], n, rows)).select(dim + 1, i)
            t = t.flatten(dim, dim + 1)
        else:
            k = t.shape[dim] // n
            t = t.narrow(dim, i * k, k)
    return t.contiguous()


def _full(t: torch.Tensor, shard: tuple, mesh) -> torch.Tensor:
    """Every rank's slice ``t`` over ``shard``'s cuts joined (no
    gradient): ``_own``'s inverse."""
    for axis, dim, *v in reversed(_cuts(shard)):
        n, i = mesh.size(axis), mesh.index(axis)
        if v:
            rows = t.shape[dim] // v[0]
            t = mesh.assemble(t.unflatten(dim, (v[0], 1, rows)), axis, n, i,
                              dim + 1).flatten(dim, dim + 2)
        else:
            k = t.shape[dim]
            t = mesh.assemble(t, axis, k * n, i * k, dim)
    return t


def shard_train_state(ts: TrainState, mesh, model=None) -> TrainState:
    """``ts`` on ``mesh``, in place: the mesh in its model's layers
    (``shard_model``) and, with ``model``, each param that its layer's
    specs (``model_pspecs``) shard over ``'model'`` or ``'expert'`` (where
    every sharded dim divides, as ``cnn_tpu`` checks) cut to this rank's
    slice, with its optimizer leaves; the layer then runs its slice
    (``Layer.tp``, ``Layer.ep``). Without ``model``, everything stays
    replicated (plain data parallelism)."""
    if ts.shards:
        raise ValueError("this train state is sharded already")
    shard_model(ts.model, mesh)
    ts.mesh = mesh
    if model is None:
        return ts
    specs = model_pspecs(model, mesh)
    owners = {layer.name: layer for layer in spec_layers(model)}
    with torch.no_grad():
        for name, p in named_params(ts.model).items():
            path = leaf_path(name)
            for n in path:
                spec = specs.get(n, {}).get(path[-1])
                if spec and len(spec) == p.dim() and all(
                        ax is None or p.shape[i] % mesh.size(ax) == 0
                        for i, ax in enumerate(spec)):
                    axis = next(ax for ax in spec if ax is not None)
                    shard = (axis, spec.index(axis))
                    p.data = _own(p.data, shard, mesh)
                    mark = "tp" if axis == "model" else "ep"
                    setattr(p, mark, (mesh, shard[1]))
                    setattr(owners[n], mark, mesh)
                    ts.shards[name] = shard
                    for tree in _opt_trees(ts.opt_state):
                        if name in tree:
                            tree[name] = _own(tree[name], shard, mesh)
                    break
    return ts


@contextmanager
def unsharded(ts: TrainState):
    """Inside, each param, model-state buffer and optimizer leaf of ``ts``
    held as a slice (over ``'model'`` or ``'expert'``, or a pipelined
    trunk's over ``'stage'``) holds the full tensor (gathered from every
    rank: every rank enters); on the way out each takes back its slice of
    it, into its own storage, so a load inside sticks and a captured
    step's addresses hold."""
    if not ts.shards:
        yield ts
        return
    mesh = ts.mesh
    held = {**named_params(ts.model), **named_state(ts.model)}
    kept = []   # (tensor or None, tree or None, name, shard, its slice)
    with torch.no_grad():
        for name, shard in ts.shards.items():
            p = held[name]
            kept.append((p, None, name, shard, p.data))
            p.data = _full(p.data, shard, mesh)
            for tree in _opt_trees(ts.opt_state):
                if name in tree:
                    kept.append((None, tree, name, shard, tree[name]))
                    tree[name] = _full(tree[name], shard, mesh)
    try:
        yield ts
    finally:
        with torch.no_grad():
            for p, tree, name, shard, part in kept:
                part.copy_(_own(p.data if p is not None else tree[name],
                                shard, mesh))
                if p is not None:
                    p.data = part
                else:
                    tree[name] = part


def make_train_step(model, optimizer, *, compute_dtype=None, mesh=None,
                    augment_fn=None, label_smoothing: float = 0.0,
                    grad_accum: int = 1, mixup: float = 0.0,
                    cutmix: float = 0.0, distill=None, remat: bool = False):
    """Returns ``(ts, images, labels) -> (ts, metrics)``.

    ``images``: [B,H,W,C] uint8 (normalized on the device) or float;
    ``labels``: [B] int. ``augment_fn(generator, images)`` runs first when
    given (e.g. ``ops/augment.py:augment_batch``); its output is cast to
    ``compute_dtype`` when that is given. ``grad_accum``: microbatches a
    step (``accumulate_grads``); ``mixup`` / ``cutmix``: Beta alphas, 0
    off; ``distill``: ``(teacher model(s), T, alpha)``; ``remat``: the
    backward recomputes the forward (``remat_forward``). ``mesh``: the
    images and labels are the global batch, on any device, identical on
    every rank; the step keeps this rank's rows (module docstring).
    """
    check_supported(compute_dtype=compute_dtype)
    dst = normalize_distill(distill)
    if mesh is not None:
        shard_model(model, mesh)
        for teacher in (dst[0] if dst else ()):
            shard_model(teacher, mesh)

    def step(ts: TrainState, images, labels):
        if mesh is not None:
            images, labels = local_rows(mesh, images, labels)
        images = to_compute(images, ts.rng, augment_fn, compute_dtype, mesh)
        metrics = apply_gradients(ts, optimizer, images, labels,
                                  label_smoothing, compute_dtype,
                                  grad_accum=grad_accum, mixup=mixup,
                                  cutmix=cutmix, distill=dst, remat=remat,
                                  mesh=mesh)
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
    probabilities are averaged over the views.

    ``mesh``: the images and labels are the global batch, on any device,
    identical on every rank; each rank runs its rows (shards as even as
    they go) and the metrics are the global batch's on every rank, ``pred``
    among them. A batch smaller than the data axis runs whole on every
    rank, its ``'data'`` collectives off."""
    local = make_ensemble_eval_step((model,), compute_dtype=compute_dtype,
                                    tta=tta)
    if mesh is None:
        return local
    shard_model(model, mesh)

    def step(images, labels):
        n = images.shape[0]
        if n < mesh.size("data"):
            shard_model(model, mesh.without_data())
            try:
                return local(images.to(mesh.device), labels.to(mesh.device))
            finally:
                shard_model(model, mesh)
        lo, hi = mesh.rows(n)
        m = local(*local_rows(mesh, images, labels, even=False))
        return {"loss": mesh.all_sum(m["loss"] * (hi - lo), "data") / n,
                "correct": mesh.all_sum(m["correct"], "data"),
                "pred": mesh.assemble(m["pred"], "data", n, lo)}

    return step


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
