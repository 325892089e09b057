"""Pipeline parallelism over a ``'stage'`` mesh axis, counterpart of
``cnn_tpu/parallel/pipeline.py``, on ``torch.distributed`` ranks.

The model's ``net`` holds exactly one ``StackedBlocks`` trunk
(``pp_decompose``): the stem before it, the trunk, the head after it. A
``('data', 'stage'[, 'model'])`` mesh (``parallel/mesh.py:make_pp_mesh``)
puts the batch over ``'data'`` and the trunk's depth over ``'stage'``:
``shard_pp_train_state`` leaves each rank the rows of the trunk's stacked
params, BN statistics and optimizer leaves that its stage runs, and the
stem and the head whole. Stage 0 runs the stem, the last stage the head and
the loss; each stage runs its rows through ``StackedBlocks``' own block
machinery (``run_blocks``: the conv kernels and their launch counters, the
``remat`` modes). Activations go one stage on, and cotangents one stage
back, by ``Mesh.hop`` (``parallel/collectives.py``), which every rank of a
stage line enters at every sub-slot, bubble or not: a bubble's compute is
skipped, its hop is not, so the collectives never diverge.

Three schedules, as ``cnn_tpu``'s, with its asserts:

- ``'gpipe'``: the local batch splits into M microbatches; for ``M + S -
  1`` ticks stage ``s`` runs microbatch ``t - s``, keeping each one's
  graph; the last stage's head and loss run on the whole output; then the
  ticks run backward, each stage differentiating microbatch ``t - s`` at
  the cotangent the next stage sent. Live activations grow with M.
- ``'1f1b'``: warmup, steady and drain sub-slots (``_make_1f1b``'s
  schedule, ``cnn_tpu``'s ``_make_1f1b_device_fn``): a forward sub-slot
  runs its chunk without a graph and keeps the chunk's input; the last
  stage runs the head and the loss of each microbatch as it completes
  (``1/M`` of its loss each); a backward sub-slot recomputes its chunk
  from the kept input, differentiates it at once and sends the cotangent
  back. At most ``2S - 1`` inputs are kept a stage, whatever M.
- interleaved 1F1B (``virtual_stages`` V > 1): chunk ``k*S + d`` of the
  ``V*S`` chunks runs on stage d; needs ``M % S == 0``. Each rank holds
  its V chunks (``shard_pp_train_state(..., virtual_stages=V)``: local row
  ``k*l + j`` is block ``(k*S + s)*l + j``), which ``unsharded``, and so
  every checkpoint, sees in the canonical ``[L]`` order.

Semantics are ``cnn_tpu``'s ``shard_map`` step's, not its GSPMD step's:

- BN normalizes each data shard's microbatch by its own statistics (the
  layers hold no mesh: the sharded steps' global-batch BN is not used,
  ``parallel/train_step.py``); the moving
  statistics take one update a microbatch, in microbatch order, bubbles
  and recomputes writing nothing; after each accumulation chunk they are
  averaged over ``'data'``, and the stem's go from stage 0 to every stage.
- The stem's and the head's gradients, which one stage computes, are
  summed over ``'stage'``; every gradient, and the loss, is averaged over
  ``'data'`` and ``correct`` summed. So every rank leaves the step with
  the same stem, head and optimizer leaves.
- A random Dropout in the trunk takes the permutation the unpipelined
  step draws for its block: every rank draws all L blocks' from
  ``ts.rng`` (``StackedBlocks.draw_perms``) and runs its own, so the
  generators stay in step, and every microbatch shares its block's mask.
  The augmentation and the mix run on every rank alike; the teachers
  (distillation) on the last stage. A random Dropout in the stem or the
  head is not ported (``NotImplementedError``): no model has one.
- Under a ``'model'`` axis each trunk block runs Megatron's pair
  (``tp_split_block``): the column conv's out-channels and the layers up
  to the row conv hold this rank's channels (``trunk_tp_pspecs``), the
  row conv's in-channels too, and its partial sums are summed over the
  axis with the identity as backward, the bias kept out of the sum
  (``Conv2D.pipe_tp``); the column conv's input goes through Megatron's
  *f* (``Mesh.model_input``). A Dropout between the pair applies its
  slice of the whole layer's mask (``Dropout.channel_cut``), so the masks
  are the unsharded step's. The gradients of the leaves replicated over
  ``'model'`` are averaged over it, which keeps their replicas bit-equal.

``make_pp_train_step`` takes ``cnn_tpu``'s options: grad accumulation
(microbatch k slice k of every rank's rows, mixed within itself), MixUp /
CutMix, distillation, EMA and freezing (through the optimizer),
``steps_per_call``, and the device dataset with its samplers and the
device augmentation. No CUDA graph captures a gloo collective, so the
pipelined device step runs its eager loop on the card (under NCCL too: a
pipeline needs a rank a stage, and one card holds no such mesh).
``make_pp_eval_step`` pads ragged batches and averages TTA views.
"""

from __future__ import annotations

import torch

from cnn_tpu_torch.nn.module import (AvgPool2D, BatchNorm2D, Conv2D,
                                     DepthwiseConv2D, Dropout, MaxPool2D,
                                     StackedBlocks, leaf_path)
from cnn_tpu_torch.nn.sequential import Sequential
from cnn_tpu_torch.ops.conv import conv_out_size
from cnn_tpu_torch.optim import ema_update_state
from cnn_tpu_torch.parallel.train_step import (TTA_VIEWS, TrainState,
                                               _opt_trees, _own,
                                               check_supported, local_rows,
                                               metrics_from_log_ps,
                                               mix_and_teacher_targets,
                                               named_params, named_state,
                                               normalize_distill, objective,
                                               prep, sum_over,
                                               teacher_probs, to_compute)


def _has_state(layer) -> bool:
    return any(st for _, _, st in layer.tree_leaves())


def _has_params(layer) -> bool:
    return any(True for _ in layer.parameters(recurse=False))


def pp_decompose(model) -> tuple[Sequential, StackedBlocks, Sequential]:
    """Split ``model.net`` into (stem, trunk, head) at its StackedBlocks."""
    layers = list(model.net)
    idx = [i for i, l in enumerate(layers) if isinstance(l, StackedBlocks)]
    if len(idx) != 1:
        raise ValueError(
            f"pipeline parallelism needs exactly one StackedBlocks trunk, "
            f"found {len(idx)} in {[l.name for l in layers]}")
    i = idx[0]
    head = layers[i + 1:]
    if any(_has_state(l) for l in head):
        raise ValueError("layers after the pipelined trunk must be "
                         "stateless (their state is only computed validly "
                         "on the last stage)")
    return Sequential(layers[:i]), layers[i], Sequential(head)


def tp_split_block(block) -> tuple[Conv2D, Conv2D]:
    """Validate a trunk block for Megatron-style tensor parallelism and
    return its (column, row) conv pair: a projection-free
    ``ResidualBlock`` whose body holds exactly two convs."""
    if block.proj is not None:
        raise ValueError("TP trunk blocks must be projection-free")
    convs = [l for l in block.body if isinstance(l, Conv2D)]
    if len(convs) != 2:
        raise ValueError(
            f"TP needs exactly two convs per block (column+row pair), "
            f"found {[c.name for c in convs]}")
    return convs[0], convs[1]


def trunk_tp_pspecs(trunk: StackedBlocks, stage: str = "stage",
                    model: str = "model"):
    """``cnn_tpu``'s per-leaf spec trees ``(params, state)`` of a TP'd
    trunk, each spec a tuple naming every dim's axis: the leading ``[L]``
    on ``'stage'``, the channels of the column conv and of the layers
    between the pair on ``'model'``, the row conv's in-channels on
    ``'model'``, everything after it replicated over ``'model'``."""
    col, row = tp_split_block(trunk.block)
    p_specs, s_specs = {}, {}
    after_row = False
    for l in trunk.block.body:
        if l is col:
            p_specs[l.name] = {"w": (stage, None, None, None, model),
                               "b": (stage, model)}
        elif l is row:
            p_specs[l.name] = {"w": (stage, None, None, model, None),
                               "b": (stage,)}
            after_row = True
        elif isinstance(l, BatchNorm2D):
            spec = (stage,) if after_row else (stage, model)
            p_specs[l.name] = {"gamma": spec, "beta": spec}
            s_specs[l.name] = {"mean": spec, "var": spec}
        elif _has_params(l) or _has_state(l):
            raise ValueError(f"unsupported parameterized TP body layer "
                             f"{l.name} ({type(l).__name__})")
    return {"body": p_specs}, {"body": s_specs}


def _trunk_model_dims(trunk: StackedBlocks) -> dict:
    """``{leaf key under the trunk ('body/b_conv1/w'): its 'model' dim}``
    of ``trunk_tp_pspecs``."""
    dims = {}
    for tree in trunk_tp_pspecs(trunk):
        for layer, leaves in tree["body"].items():
            for key, spec in leaves.items():
                if "model" in spec:
                    dims[f"body/{layer}/{key}"] = spec.index("model")
    return dims


def _random_dropouts(seq: Sequential) -> list:
    return [l.name for l in seq if isinstance(l, Dropout) and l.random]


def _trunk_input_shape(stem: Sequential, shape) -> tuple:
    """The [B, H, W, C] of the stem's output for images of ``shape``."""
    b, h, w, c = shape
    for l in stem:
        if isinstance(l, (Conv2D, DepthwiseConv2D)):
            h, w = (conv_out_size(v, l.kernel_size, l.stride, l.padding)
                    for v in (h, w))
            c = l.out_channels
        elif isinstance(l, (MaxPool2D, AvgPool2D)):
            h, w = (conv_out_size(v, l.kernel_size, l.stride)
                    for v in (h, w))
        elif _has_params(l) and not isinstance(l, BatchNorm2D):
            raise NotImplementedError(
                f"{l.name} ({type(l).__name__}) in a pipelined stem")
    return b, h, w, c


def _check_pp(model, mesh, n_microbatches: int, schedule: str = "gpipe",
             virtual_stages: int = 1):
    """``cnn_tpu``'s build-time checks of a pipelined step, with its
    messages; returns ``pp_decompose(model)``."""
    stem, trunk, head = pp_decompose(model)
    S = mesh.size("stage")
    assert trunk.n_blocks % S == 0, \
        f"{trunk.n_blocks} blocks must divide over {S} stages"
    if mesh.size("model") > 1:
        tp_split_block(trunk.block)  # fail fast on unsupported shapes
    assert schedule in ("gpipe", "1f1b"), f"unknown schedule '{schedule}'"
    V = virtual_stages
    assert V >= 1
    if V > 1:
        assert schedule == "1f1b", \
            "virtual_stages > 1 is an interleaved-1F1B feature"
        assert trunk.n_blocks % (S * V) == 0, \
            f"{trunk.n_blocks} blocks must divide over {S} stages x {V} " \
            f"virtual chunks"
    if schedule == "1f1b" and V > 1:
        assert n_microbatches % S == 0, \
            f"interleaved 1F1B needs microbatches ({n_microbatches}) % " \
            f"stages ({S}) == 0"
    drops = _random_dropouts(stem) + _random_dropouts(head)
    if drops:
        raise NotImplementedError(
            f"a random Dropout outside the pipelined trunk ({drops}) is "
            "not ported")
    return stem, trunk, head


class _Stage:
    """This rank's part of a pipelined model: the stem (stage 0), its
    chunks of the trunk, the head and the loss (the last stage), the
    schedules and the reductions over the mesh."""

    def __init__(self, model, mesh, n_microbatches: int, compute_dtype,
                 schedule: str = "gpipe", virtual_stages: int = 1):
        self.model, self.mesh = model, mesh
        self.stem, self.trunk, self.head = _check_pp(
            model, mesh, n_microbatches, schedule, virtual_stages)
        self.M, self.cd, self.V = n_microbatches, compute_dtype, virtual_stages
        self.schedule = schedule
        self.S, self.s = mesh.size("stage"), mesh.index("stage")
        self.last = self.S - 1
        self.chunk_rows = self.trunk.n_blocks // (self.S * self.V)
        self.params = named_params(model)
        self.state = named_state(model)
        part = {l.name: "stem" for l in self.stem}
        part.update({l.name: "head" for l in self.head})
        part[self.trunk.name] = "trunk"
        self.part = {n: part[leaf_path(n)[0]]
                     for n in (*self.params, *self.state)}
        self.trunk_params = [p for n, p in self.params.items()
                             if self.part[n] == "trunk"]

    def _names(self, which, tree=None) -> list:
        return [n for n in (tree or self.params) if self.part[n] == which]

    def check_state(self, ts: TrainState) -> None:
        """The train state must be placed for this step
        (``shard_pp_train_state`` with the same ``virtual_stages``)."""
        if ts.mesh is not self.mesh or not all(
                n in ts.shards for n in self._names("trunk")):
            raise ValueError("the train state is not placed on this "
                             "pipeline mesh (shard_pp_train_state)")
        held = getattr(self.trunk, "stage_chunks", 1)
        if held != self.V:
            raise ValueError(
                f"the train state holds {held} trunk chunk(s) a stage and "
                f"the step runs {self.V} (shard_pp_train_state's "
                "virtual_stages)")

    # ------------------------------------------------------------ pieces --

    def chunk(self, k: int, x, drawn, *, write_state: bool = True,
              remat: bool = True):
        """This rank's virtual chunk ``k`` (its local rows ``k*l .. k*l +
        l - 1``, blocks ``(k*S + s)*l + j``) on ``x``."""
        l = self.chunk_rows
        first = (k * self.S + self.s) * l
        return self.trunk.run_blocks(
            x, range(k * l, (k + 1) * l), drawn[first:first + l], self.cd,
            remat=remat, write_state=write_state)

    def head_loss(self, out, loss_of):
        """The head and ``loss_of(logits) -> (loss, correct)`` on ``out``:
        ``(loss, correct, d_out, head grads)``."""
        out = out.detach().requires_grad_()
        head_params = [self.params[n] for n in self._names("head")]
        with torch.enable_grad():
            logits = self.head(out, compute_dtype=self.cd)
            loss, correct = loss_of(logits)
            grads = torch.autograd.grad(loss, [out, *head_params],
                                        allow_unused=True)
        return loss.detach(), correct, grads[0], list(grads[1:])

    def _grad_chunk(self, y, inp, cot):
        """``(d inp, [d trunk param])`` of ``y`` at ``cot``."""
        grads = torch.autograd.grad(y, [inp, *self.trunk_params], cot,
                                    allow_unused=True)
        return grads[0], list(grads[1:])

    @staticmethod
    def _add(acc, grads):
        if acc is None:
            return [g for g in grads]
        return [a if g is None else (g if a is None else a + g)
                for a, g in zip(acc, grads)]

    # --------------------------------------------------------- schedules --

    def gpipe(self, x_mb, act_like, loss_of, drawn):
        """The GPipe schedule on the microbatches ``x_mb`` (stage 0) with
        ``loss_of`` on the whole output (the last stage): ``(d x_mb, trunk
        grads, head grads, loss, correct)``, each None where this stage
        has none."""
        S, s, M, last = self.S, self.s, self.M, self.last
        T = M + S - 1
        saved, outs = {}, [None] * M
        act = None
        for t in range(T):
            m = t - s
            if 0 <= m < M:
                inp = (x_mb[m] if s == 0 else act).detach().requires_grad_()
                with torch.enable_grad():
                    y = self.chunk(0, inp, drawn)
                saved[m] = (inp, y)
                send = y.detach()
                if s == last:
                    outs[m] = send
            else:
                send = torch.zeros_like(act_like)
            if t < T - 1:
                act = self.mesh.hop(send, 1)
        loss = correct = d_mb = g_hd = None
        if s == last:
            loss, correct, d_out, g_hd = self.head_loss(torch.cat(outs),
                                                        loss_of)
            d_mb = d_out.split(act_like.shape[0])
        d_x, g_tr, cot = [None] * M, None, None
        for t in reversed(range(T)):
            m = t - s
            if 0 <= m < M:
                inp, y = saved.pop(m)
                d, g = self._grad_chunk(y, inp, d_mb[m] if s == last
                                        else cot)
                g_tr = self._add(g_tr, g)
                send = d_x[m] = d
            else:
                send = torch.zeros_like(act_like)
            if t > 0:
                cot = self.mesh.hop(send, -1)
        return d_x, g_tr, g_hd, loss, correct

    def one_f_one_b(self, x_mb, act_like, mb_loss_of, drawn):
        """The (interleaved) 1F1B schedule (module docstring;
        ``cnn_tpu``'s ``_make_1f1b_device_fn``): ``mb_loss_of(logits, m)``
        is microbatch m's ``(loss / M, correct)``. Returns as ``gpipe``."""
        S, s, M, V, last = self.S, self.s, self.M, self.V, self.last
        C = V * S
        MV = M * V
        steady = MV - S * (V - 1)
        saved, seeds = {}, {}
        d_x = [None] * M
        run = {"act": None, "cot": None, "g_tr": None, "g_hd": None,
               "loss": None, "correct": None}

        def f_sub(n):
            u = n - s
            if 0 <= u < MV:
                g_i, q = divmod(u, C)
                m, k = g_i * S + q % S, q // S
                inp = x_mb[m] if (s == 0 and k == 0) else run["act"]
                with torch.no_grad():
                    y = self.chunk(k, inp, drawn)
                saved[(m, k)] = inp
                if s == last and k == V - 1:
                    loss, correct, seeds[m], g = self.head_loss(
                        y, lambda logits: mb_loss_of(logits, m))
                    run["g_hd"] = self._add(run["g_hd"], g)
                    run["loss"] = loss if run["loss"] is None \
                        else run["loss"] + loss
                    run["correct"] = correct if run["correct"] is None \
                        else run["correct"] + correct
                send = y
            else:
                send = torch.zeros_like(act_like)
            run["act"] = self.mesh.hop(send, 1)

        def b_sub(n):
            u = n - (S - 1 - s)
            if 0 <= u < MV:
                g_i, q = divmod(u, C)
                k, r = V - 1 - q // S, q % S
                m = g_i * S + r
                inp = saved.pop((m, k)).detach().requires_grad_()
                cot = (seeds.pop(m) if (s == last and k == V - 1)
                       else run["cot"])
                # the recompute at the kept input: the training forward
                # normalizes by batch statistics, so it is the forward's
                # value; it writes no statistics
                with torch.enable_grad():
                    y = self.chunk(k, inp, drawn, write_state=False,
                                   remat=False)
                d, g = self._grad_chunk(y, inp, cot)
                run["g_tr"] = self._add(run["g_tr"], g)
                if s == 0 and k == 0:
                    d_x[m] = d
                send = d
            else:
                send = torch.zeros_like(act_like)
            run["cot"] = self.mesh.hop(send, -1)

        for n in range(C - 1):                    # warmup
            f_sub(n)
        for i in range(steady):                   # steady: F then B
            f_sub(C - 1 + i)
            b_sub(i)
        for n in range(steady, steady + C - 1):   # drain
            b_sub(n)
        return d_x, run["g_tr"], run["g_hd"], run["loss"], run["correct"]

    # ------------------------------------------------------- one batch --

    def grads(self, images, labels, mix, teachers, label_smoothing, drawn):
        """One pass of the schedule over this rank's ``images`` (its data
        shard, float) and ``labels``: ``({name: grad}, loss, correct)``
        summed over ``'stage'``, the gradients and the loss averaged over
        ``'data'`` (``correct`` summed), the replicated gradients averaged
        over ``'model'``; the BN statistics averaged over ``'data'`` and
        the stem's sent from stage 0."""
        mesh, s, M = self.mesh, self.s, self.M
        b = images.shape[0]
        assert b % M == 0, f"batch {b} must divide into {M} microbatches"
        mb = b // M
        shape = _trunk_input_shape(self.stem, images.shape)
        act_like = torch.zeros((mb, *shape[1:]),
                               dtype=self.cd or torch.float32,
                               device=images.device)
        h = x_mb = None
        if s == 0:
            with torch.enable_grad():
                h = self.stem(images, compute_dtype=self.cd)
            x_mb = h.detach().split(mb)
        dist = None
        if s == self.last and teachers is not None:
            dist = (teacher_probs(teachers[0], images, teachers[1], self.cd),
                    teachers[1], teachers[2])

        if self.schedule == "gpipe":
            d_x, g_tr, g_hd, loss, correct = self.gpipe(
                x_mb, act_like,
                lambda logits: objective(logits, labels, label_smoothing,
                                         mix, dist), drawn)
        else:
            def mb_loss_of(logits, m):
                rows = slice(m * mb, (m + 1) * mb)
                mx = None if mix is None else (mix[0][rows], mix[1])
                ds = None if dist is None else (dist[0][rows], *dist[1:])
                loss, correct = objective(logits, labels[rows],
                                          label_smoothing, mx, ds)
                return loss / M, correct
            d_x, g_tr, g_hd, loss, correct = self.one_f_one_b(
                x_mb, act_like, mb_loss_of, drawn)

        grads = dict.fromkeys(self.params)
        if s == 0:
            stem_names = self._names("stem")
            g_st = torch.autograd.grad(
                h, [self.params[n] for n in stem_names], torch.cat(d_x),
                allow_unused=True) if stem_names else []
            grads.update(zip(stem_names, g_st))
        if g_hd is not None:
            grads.update(zip(self._names("head"), g_hd))
        grads.update(zip(self._names("trunk"), g_tr))
        grads = {n: torch.zeros_like(p) if grads[n] is None else grads[n]
                 for n, p in self.params.items()}
        dev = images.device
        loss = torch.zeros((), device=dev) if loss is None else loss.float()
        correct = (torch.zeros((), dtype=torch.int64, device=dev)
                   if correct is None else correct)
        return self.reduce(grads, loss, correct)

    def reduce(self, grads, loss, correct):
        mesh = self.mesh
        rep = [n for n in grads if self.part[n] != "trunk"]
        stem_state = self._names("stem", self.state)
        if mesh.active("stage"):
            # the stem's and the head's gradients and the stem's statistics
            # from the one stage that has them, the loss from the last
            zero = self.s != 0
            parts = ([grads[n] for n in rep]
                     + [torch.zeros_like(self.state[n]) if zero
                        else self.state[n].float() for n in stem_state]
                     + [loss.reshape(1), correct.reshape(1).float()])
            summed = sum_over(parts, mesh, "stage")
            for n, g in zip(rep, summed):
                grads[n] = g
            with torch.no_grad():
                for n, t in zip(stem_state, summed[len(rep):]):
                    self.state[n].copy_(t)
            loss = summed[-2][0]
            correct = summed[-1][0].round().long()
        if mesh.active("model"):
            cut = self.model_cut
            same = [n for n in grads if n not in cut]
            size = mesh.size("model")
            for n, g in zip(same, sum_over([grads[n] for n in same], mesh,
                                           "model")):
                grads[n] = g / size
        if mesh.active("data"):
            d = mesh.size("data")
            names = list(grads)
            st = list(self.state)
            parts = ([grads[n] for n in names]
                     + [self.state[n].float() for n in st] + [loss.reshape(1)])
            summed = sum_over(parts, mesh, "data")
            grads = {n: g / d for n, g in zip(names, summed)}
            with torch.no_grad():
                for n, t in zip(st, summed[len(names):]):
                    self.state[n].copy_(t / d)
            loss = summed[-1][0] / d
            correct = mesh.all_sum(correct, "data")
        return grads, loss, correct

    @property
    def model_cut(self) -> set:
        """The params held as a slice over ``'model'``."""
        return {n for n, p in self.params.items()
                if getattr(p, "cuts", None) is not None
                and "model" in p.cuts[1]}

    def forward_eval(self, images):
        """The forward in eval mode on this rank's float ``images``: the
        logits (float32) on every rank of the stage line. V = 1: the GPipe
        ticks; V chunks a stage (the state's placement,
        ``StackedBlocks.stage_chunks``): each microbatch in turn through
        the ``V*S`` chunks, chunk ``c`` on stage ``c % S``."""
        S, s, M, last = self.S, self.s, self.M, self.last
        V = getattr(self.trunk, "stage_chunks", 1)
        l = self.trunk.n_blocks // (S * V)
        b = images.shape[0]
        mb = b // M
        shape = _trunk_input_shape(self.stem, images.shape)
        idle = torch.zeros((mb, *shape[1:]), dtype=self.cd or torch.float32,
                           device=images.device)
        drawn = [{}] * self.trunk.n_blocks
        x_mb = (self.stem(images, compute_dtype=self.cd).split(mb)
                if s == 0 else None)

        def run(k, x):
            first = (k * S + s) * l
            return self.trunk.run_blocks(x, range(k * l, (k + 1) * l),
                                         drawn[first:first + l], self.cd)

        # (tick, microbatch, chunk) of each of this stage's applies
        if V == 1:
            ticks = [[(m, 0)] if 0 <= (m := t - s) < M else []
                     for t in range(M + S - 1)]
        else:
            ticks = [[(m, c // S)] if c % S == s else []
                     for m in range(M) for c in range(V * S)]
        outs, act = [], None
        for t, work in enumerate(ticks):
            send = idle
            for m, k in work:
                send = run(k, x_mb[m] if s == 0 and k == 0 else act)
                if s == last and k == V - 1:
                    outs.append(send)
            if t < len(ticks) - 1:
                act = self.mesh.hop(send, 1)
        logits = (self.head(torch.cat(outs), compute_dtype=self.cd).float()
                  if s == last else
                  torch.zeros((b, self.model.num_classes),
                              device=images.device))
        return self.mesh.all_sum(logits, "stage")


def _microbatch_rows(images, labels, k: int, i: int):
    mb = images.shape[0] // k
    return images[i * mb:(i + 1) * mb], labels[i * mb:(i + 1) * mb]


def make_pp_train_step(model, optimizer, mesh, *, n_microbatches: int,
                       compute_dtype=None, label_smoothing: float = 0.0,
                       donate: bool = True, grad_accum: int = 1,
                       mixup: float = 0.0, cutmix: float = 0.0, distill=None,
                       dataset=None, batch_size: int | None = None,
                       augment_fn=None, sample_mode: str = "local",
                       steps_per_call: int = 1, schedule: str = "gpipe",
                       virtual_stages: int = 1):
    """A pipelined train step on ``mesh`` (a ``make_pp_mesh``), with
    ``cnn_tpu``'s options (module docstring); the train state comes from
    ``shard_pp_train_state`` with the same ``virtual_stages``.

    Host-fed (``dataset=None``): ``(ts, images, labels) -> (ts,
    metrics)``, the global batch, identical on every rank, each rank
    keeping its data shard's rows. Device-resident (``dataset``, uploaded
    on ``mesh``): ``(ts) -> (ts, metrics)``, sampled as
    ``make_device_train_step`` samples (``sample_mode``), ``batch_size``
    rows a step, ``steps_per_call`` steps a call. ``augment_fn(generator,
    images)`` runs first on every rank (its output cast to
    ``compute_dtype``), else the uint8 batch is normalized. ``distill``:
    ``(teacher model(s), T, alpha)``. ``donate`` is accepted and changes
    nothing: the state is updated in place."""
    from cnn_tpu_torch.data.device_dataset import device_batches

    check_supported(compute_dtype=compute_dtype)
    stage = _Stage(model, mesh, n_microbatches, compute_dtype, schedule,
                   virtual_stages)
    dst = normalize_distill(distill)
    teachers = None if dst is None else (dst[0], dst[1], dst[2])
    del donate

    def accumulate(ts, images, labels):
        stage.check_state(ts)
        K = grad_accum
        if images.shape[0] % K:
            raise ValueError(f"a shard's {images.shape[0]} rows do not split "
                             f"into {K} microbatches")
        ts.model.train()
        gsum = lsum = csum = None
        for i in range(K):
            x, y = _microbatch_rows(images, labels, K, i)
            x, mix, _ = mix_and_teacher_targets(
                ts.rng, x, y, mixup=mixup, cutmix=cutmix, mesh=mesh)
            drawn = stage.trunk.draw_perms(ts.rng)
            g, loss, correct = stage.grads(x, y, mix, teachers,
                                           label_smoothing, drawn)
            if gsum is None:
                gsum, lsum, csum = g, loss, correct
            else:
                gsum = {n: gsum[n] + g[n] for n in gsum}
                lsum, csum = lsum + loss, csum + correct
        if K > 1:
            gsum = {n: g / K for n, g in gsum.items()}
            lsum = lsum / K
        return gsum, lsum, csum

    def update(ts, images, labels) -> dict:
        images = to_compute(images, ts.rng, augment_fn, compute_dtype, mesh)
        grads, loss, correct = accumulate(ts, images, labels)
        optimizer.update(grads, ts.opt_state, stage.params)
        ts.opt_state = ema_update_state(ts.opt_state, stage.state)
        ts.step += 1
        return {"loss": loss, "correct": correct}

    if dataset is None:
        def host_step(ts: TrainState, images, labels):
            images, labels = local_rows(mesh, images, labels)
            return ts, update(ts, images, labels)
        return host_step

    assert batch_size is not None, "device mode needs batch_size"
    if dataset.mesh is not mesh:
        raise ValueError("dataset must be uploaded onto the same PP mesh")
    if batch_size % mesh.size("data"):
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{mesh.size('data')} data shards")
    draw, _ = device_batches(dataset, batch_size, mesh, sample_mode)
    print(f"device step on the pipeline mesh {mesh.shape} "
          f"({mesh.backend or 'no process group'}): the eager loop",
          flush=True)

    def device_step(ts: TrainState):
        runs = []
        for _ in range(steps_per_call):
            images, labels = draw(ts)
            runs.append(update(ts, images, labels))
        if steps_per_call == 1:
            metrics = runs[0]
        else:
            metrics = {"loss": torch.stack([m["loss"] for m in runs]).mean(),
                       "correct": sum(m["correct"] for m in runs)}
        metrics["batch"] = batch_size * steps_per_call
        return ts, metrics

    return device_step


def _pp_views(model, mesh, n_microbatches: int, compute_dtype):
    """``(images, views) -> [float32 logits of each view]``: the global
    batch zero-padded to a multiple of ``'data'`` x M, this rank's rows
    prepped and viewed (``TTA_VIEWS``), each view through the pipelined
    forward in eval mode, the logits gathered over ``'data'`` and cut to
    the batch, the same on every rank."""
    stage = _Stage(model, mesh, n_microbatches, compute_dtype)
    step = mesh.size("data") * n_microbatches

    def run(images, views=TTA_VIEWS[""]):
        b = images.shape[0]
        if b % step:
            images = torch.cat([images, images.new_zeros(
                ((-b) % step, *images.shape[1:]))])
        n = images.shape[0]
        lo, hi = mesh.rows(n)
        x = prep(images[lo:hi].to(mesh.device), compute_dtype)
        model.eval()
        with torch.no_grad():
            return [mesh.assemble(stage.forward_eval(v), "data", n, lo)[:b]
                    for v in views(x)]

    return run


def make_pp_forward(model, mesh, *, n_microbatches: int = 1,
                    compute_dtype=None):
    """The pipelined forward: ``images -> logits`` (float32, eval mode),
    the global batch on every rank and the logits on every rank (the
    ``shard_map`` inside ``cnn_tpu``'s ``make_pp_eval_step``)."""
    check_supported(compute_dtype=compute_dtype)
    run = _pp_views(model, mesh, n_microbatches, compute_dtype)
    return lambda images: run(images)[0]


def make_pp_eval_step(model, mesh, *, n_microbatches: int = 1,
                      compute_dtype=None, tta: str = ""):
    """A pipelined eval step: ``(images, labels) -> {"loss", "correct",
    "pred"}`` in eval mode (moving BN statistics), the global batch on
    every rank. A ragged batch is zero-padded to a multiple of ``'data'``
    x M; each rank runs its rows, the last stage's logits go to every
    stage and are gathered over ``'data'``, and the metrics are the
    unpadded batch's (``metrics_from_log_ps``, averaged over the ``tta``
    views), the same on every rank."""
    check_supported(compute_dtype=compute_dtype, tta=tta)
    run = _pp_views(model, mesh, n_microbatches, compute_dtype)

    def step(images, labels):
        log_ps = [torch.log_softmax(logits, dim=-1)
                  for logits in run(images, TTA_VIEWS[tta])]
        return metrics_from_log_ps(log_ps, labels.to(mesh.device))

    return step


def shard_pp_train_state(ts: TrainState, mesh, model,
                         virtual_stages: int = 1) -> TrainState:
    """``ts`` placed for the pipeline on ``mesh``, in place: every param,
    BN statistic and optimizer leaf under the trunk keeps this rank's
    stage rows (its ``virtual_stages`` chunks, ``_own``'s interleaved
    placement) and, on a ``'model'`` axis, its channels of
    ``trunk_tp_pspecs``; the stem and the head stay whole. Each cut goes
    into ``ts.shards`` (``unsharded`` joins them) and on the param
    (``cuts``: the clip's global norm sums over those axes); under
    ``'model'`` the trunk block's conv pair and the Dropouts between it
    take their roles (``Conv2D.pipe_tp``, ``Dropout.channel_cut``)."""
    if ts.shards:
        raise ValueError("this train state is sharded already")
    _, trunk, _ = pp_decompose(model)
    S, V = mesh.size("stage"), virtual_stages
    assert trunk.n_blocks % (S * V) == 0, \
        f"{trunk.n_blocks} blocks must divide over {S} stages x {V} " \
        f"virtual chunks"
    tp = mesh.size("model") > 1
    dims = _trunk_model_dims(trunk) if tp else {}
    ts.mesh = mesh
    params = named_params(ts.model)
    held = {**params, **named_state(ts.model)}
    with torch.no_grad():
        for name, t in held.items():
            path = leaf_path(name)
            if path[0] != trunk.name:
                continue
            key = "/".join(path[1:])
            shard = (("stage", 0, V),)
            if key in dims:
                shard += (("model", dims[key]),)
            t.data = _own(t.data, shard, mesh)
            if name in params:
                t.cuts = (mesh, tuple(c[0] for c in shard))
            ts.shards[name] = shard
            for tree in _opt_trees(ts.opt_state):
                if name in tree:
                    tree[name] = _own(tree[name], shard, mesh)
    trunk.stage_chunks = V
    if tp:
        col, row = tp_split_block(trunk.block)
        col.pipe_tp, row.pipe_tp = ("column", mesh), ("row", mesh)
        between = False
        for l in trunk.block.body:
            between = (between or l is col) and l is not row
            if between and isinstance(l, Dropout):
                l.channel_cut = mesh
    return ts
