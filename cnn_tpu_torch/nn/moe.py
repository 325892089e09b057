"""Mixture-of-Experts block, counterpart of ``cnn_tpu/nn/moe.py``.

A Switch-style top-1 routed bank of expert MLPs on [B, D] features, with
a residual: ``x + y``. Routing follows ``cnn_tpu`` step for step, in fixed
shapes:

- the router logits ``x @ router`` in float32 (``cnn_tpu`` runs them at
  ``Precision.HIGHEST``: an argmax reads them; like every float32 product
  of the port, in full float32 unless the caller turned TF32 on), the
  softmax and its argmax, the top-1 expert of each token;
- each token's place in its expert's queue, a cumsum in batch order; a
  token at or past the capacity ``cap = max(1, int(capacity_factor * B /
  E))`` is dropped and leaves through the residual unchanged;
- ``dispatch`` [B, E, cap] (0 or 1) gathers the kept tokens, the experts
  run as batched products over E, and ``combine`` (``dispatch`` times the
  token's router probability, whose gradient trains the router) scatters
  the results back.

The products run in ``compute_dtype`` (the input's dtype by default):
``dispatch`` and ``combine`` are cast to it, as ``cnn_tpu`` casts them to
``w_dtype``; a bf16 product sums in float32 (``ops/linear.py:matmul``).
``cnn_tpu`` computes them with XLA einsums outside any Pallas kernel, so
here they are PyTorch products. The forward never reads a value back to
the host (no ``.item()``, no boolean indexing, one-hots by comparison with
an ``arange``), so a serving bucket captures it into its CUDA graph. The
capacity depends on the batch, so a served image's result depends on the
bucket it is padded into.

State: ``load`` [E], the fraction of the batch routed to each expert, and
with ``balance_coeff`` > 0 ``aux_loss``, Switch's balance term ``coeff * E
* sum_e f_e * P_e`` (f the dispatch fractions, P the mean router
probabilities). A training forward writes both (detached) and keeps the
differentiable term in ``aux``, which the train step adds to the loss
(``parallel/train_step.py:collect_aux_losses``); an eval forward writes
nothing and leaves ``aux`` None.

On a mesh whose batch shards over ``'data'`` (``mesh``, set by
``parallel/train_step.py:shard_model``) the block routes the global batch,
as ``cnn_tpu``'s GSPMD step does: the capacity comes from the global batch
size, a token's place in its expert's queue is the lower data ranks'
counts for that expert plus its place among this rank's tokens (each
rank's counts are gathered once a forward), and ``load`` and the balance
term are means over the global batch (the router probabilities summed
over the axis, differentiably). The experts' MLP acts on each queue slot
alone, so each rank runs its own tokens at their global places. The
block declares no ``'model'`` sharding (``param_pspecs`` None, as in
``cnn_tpu``).

Expert parallelism is ``cnn_tpu``'s ``param_pspecs_ep``: on a mesh with
an ``'expert'`` axis of n ranks, ``parallel/train_step.py:
shard_train_state`` cuts every [E]-leading tensor (``w1``, ``b1``, ``w2``,
``b2``) to this rank's E / n experts and marks the block (``ep``). The
batch is not sharded over ``'expert'``: every rank of the axis routes the
same tokens, exactly as above, and runs the queues of its own experts
only; their partial ``y`` (zero for a token routed elsewhere) is summed
over the axis (``collectives.psum``, whose backward sums the ranks'
cotangents: the router's gradient through ``combine`` is partial on each
rank, and the train step sums it over the axis).
"""

from __future__ import annotations

import torch
from torch import nn

from cnn_tpu_torch.nn.module import Layer, _normal
from cnn_tpu_torch.ops.linear import matmul


class MoEBlock(Layer):
    """[B, D] -> [B, D]: residual top-1 MoE FFN (Switch semantics). The
    router and the expert weights start at N(0, 1) / sqrt(D), the biases
    and ``w2`` at zero (the block starts as the identity); ``load`` at
    1/E, ``aux_loss`` at 0.

    ``state_eval_inert``: the state is monitoring only, never read by the
    forward, so the eval-only transforms (``quant.py``'s BN folding and
    int8 serving) keep the block and drop its buffers, as ``cnn_tpu``'s
    flag lets them."""
    casts = True
    state_eval_inert = True

    def __init__(self, name, dim=128, hidden=256, n_experts=8,
                 capacity_factor=2.0, balance_coeff=0.0, *, device=None,
                 generator=None):
        super().__init__(name)
        self.dim, self.hidden, self.n_experts = dim, hidden, n_experts
        self.capacity_factor, self.balance_coeff = (capacity_factor,
                                                    balance_coeff)
        e, d, h = n_experts, dim, hidden
        self.router = _normal((d, e), generator, device, d ** -0.5)
        self.w1 = _normal((e, d, h), generator, device, d ** -0.5)
        self.b1 = nn.Parameter(torch.zeros((e, h), device=device))
        self.w2 = nn.Parameter(torch.zeros((e, h, d), device=device))
        self.b2 = nn.Parameter(torch.zeros((e, d), device=device))
        self.register_buffer("load", torch.full((e,), 1.0 / e,
                                                device=device))
        if balance_coeff > 0.0:
            self.register_buffer("aux_loss", torch.zeros((), device=device))
        self.aux = None

    def param_pspecs_ep(self) -> dict:
        """``cnn_tpu``'s expert-parallel placement: every [E]-leading
        tensor over ``'expert'``."""
        return {"w1": ("expert", None, None), "b1": ("expert", None),
                "w2": ("expert", None, None), "b2": ("expert", None)}

    def tree_leaves(self):
        yield from super().tree_leaves()
        # ``load``, then ``aux_loss`` with a balance loss: the buffers it
        # holds (a folded copy holds none)
        for key, t in self.named_buffers(recurse=False):
            yield (key,), t, True

    def capacity(self, batch: int) -> int:
        return max(1, int(self.capacity_factor * batch / self.n_experts))

    def _global_counts(self, onehot, mesh):
        """``(batch, lower, counts)`` of the global batch: its size, the
        lower data ranks' tokens per expert [E] and every rank's [E] summed,
        from one gather of each rank's counts and batch size. In training
        the shards are equal, so the size needs no read on the host."""
        bsz, e = onehot.shape
        mine = torch.cat([onehot.sum(dim=0), onehot.new_full((1,), bsz)])
        d, size = mesh.index("data"), mesh.size("data")
        table = mesh.assemble(mine[None], "data", size, d)      # [D, E+1]
        total = bsz * size if self.training else int(table[:, e].sum())
        return total, table[:d, :e].sum(dim=0), table[:, :e].sum(dim=0)

    def forward(self, x, compute_dtype=None):
        e = self.n_experts
        bsz = x.shape[0]
        mesh = self.mesh if self.mesh is not None and self.mesh.active(
            "data") else None
        logits = x.float() @ self.router.float()               # [B, E]
        probs = torch.softmax(logits, dim=-1)
        experts = torch.arange(e, device=x.device)
        onehot = (probs.argmax(dim=-1)[:, None] == experts).float()
        # each token's place in its expert's queue; -1 off its expert
        place = torch.cumsum(onehot, dim=0)
        total = bsz
        if mesh is not None:
            total, lower, counts = self._global_counts(onehot, mesh)
            place = place + lower
        cap = self.capacity(total)
        pos = place * onehot - 1.0                              # [B, E]
        keep = (pos >= 0) & (pos < cap)
        slots = torch.arange(cap, device=x.device)
        dispatch = ((pos.long()[..., None] == slots)
                    & keep[..., None]).float()                  # [B, E, C]
        gate = (probs * onehot).sum(dim=-1)                     # [B]
        combine = dispatch * gate[:, None, None]
        n = self.w1.shape[0]            # the experts held here
        if self.ep is not None:         # this rank's queues only
            lo = self.ep.index("expert") * n
            dispatch, combine = dispatch[:, lo:lo + n], combine[:, lo:lo + n]

        wd = compute_dtype or x.dtype
        flat = dispatch.to(wd).reshape(bsz, n * cap)
        xe = matmul(flat.mT, x.to(wd)).reshape(n, cap, -1)      # [n, C, D]
        h = torch.relu(matmul(xe, self.w1.to(wd))
                       + self.b1[:, None, :].to(wd))
        ye = matmul(h, self.w2.to(wd)) + self.b2[:, None, :].to(wd)
        y = matmul(combine.to(wd).reshape(bsz, n * cap),
                   ye.reshape(n * cap, -1))                     # [B, D]
        if self.ep is not None:
            y = self.ep.psum(y, "expert")

        self.aux = None
        if self.training:
            f = onehot.mean(dim=0) if mesh is None else counts / total
            with torch.no_grad():
                self.load.copy_(f)
            if self.balance_coeff > 0.0:
                p_mean = (probs.mean(dim=0) if mesh is None else
                          mesh.psum(probs.sum(dim=0), "data") / total)
                aux = self.balance_coeff * e * (f * p_mean).sum()
                with torch.no_grad():
                    self.aux_loss.copy_(aux)
                self.aux = aux
        return x + y.to(x.dtype)
