"""Sequential container, counterpart of ``cnn_tpu/nn/sequential.py``.

Layers are kept in order under the same names as in ``cnn_tpu`` (the keys of
its param and state trees). A Conv2D directly followed by a ReLU runs as one
fused ``relu=True`` conv launch, the fusion the conv kernel exists for; in
training its autograd Function keeps the output for the ReLU mask, as
``_vjp_bwd`` does. With BN in between, the conv runs ``relu=False`` and BN
and ReLU follow as plain tensor ops. ``fuses`` states that rule and
``run_layers`` applies it, for ``forward`` and for any caller that replays
a slice of the stack (Grad-CAM's tail), so both launch the same kernels.

``forward(x, compute_dtype=, generator=, capture=)`` threads the compute
dtype to the layers that cast (``Layer.casts``: the convs, Linear and the
composite blocks), as ``cnn_tpu``'s ``apply(compute_dtype=)`` threads it to
every layer, and the generator to the layers that draw (``Layer.draws``:
Dropout and the blocks), with ``perms``, Dropout permutations drawn ahead
by name (``StackedBlocks``). ``capture`` names layers whose outputs are
returned beside the result, as ``apply(capture=)``: a captured conv runs
``relu=False`` so that its own output exists, and the plain ReLU follows.

A Sequential nests inside a ``ResidualBlock`` as its body, with the same
fusion rule; ``tree_leaves`` gives ``cnn_tpu``'s tree paths, keyed by
layer name.

On a mesh with a ``'spatial'`` axis (``parallel/mesh.py``) the model's
entry calls ``cut_rows``: it plans every layer's input rows for images of
the batch's height (``plan_rows``) and hands the stack this rank's strip
of them, so that the images arrive whole (augmented, mixed and flipped as
a whole) and every layer runs on strips (``nn/module.py``).
"""

from __future__ import annotations

from typing import Iterable, Sequence

from torch import nn

from cnn_tpu_torch.nn.module import Conv2D, Dropout, Layer, ReLU


def fuses(layers: Sequence[Layer], i: int, capture=()) -> bool:
    """Whether ``layers[i]`` runs as one launch with the ReLU after it: a
    Conv2D directly followed by a ReLU whose own output is not captured."""
    return (isinstance(layers[i], Conv2D) and i + 1 < len(layers)
            and isinstance(layers[i + 1], ReLU)
            and layers[i].name not in capture)


def run_layers(layers: Sequence[Layer], x, *, compute_dtype=None,
               generator=None, capture: Iterable[str] = (),
               captured: dict | None = None, perms: dict | None = None):
    """``layers`` applied in order to ``x``, fused by ``fuses``; the outputs
    of the layers named in ``capture`` go into ``captured``; a Dropout
    named in ``perms`` takes that permutation."""
    capture = frozenset(capture)
    i = 0
    while i < len(layers):
        layer = layers[i]
        fuse = fuses(layers, i, capture)
        kw = {"relu": True} if fuse else {}
        if compute_dtype is not None and layer.casts:
            kw["compute_dtype"] = compute_dtype
        if layer.draws:
            kw["generator"] = generator
            if isinstance(layer, Dropout):
                kw["perm"] = (perms or {}).get(layer.name)
            elif perms:
                kw["perms"] = perms
        x = layer(x, **kw)
        ran = layers[i:i + 2] if fuse else (layer,)
        for done in ran:      # a fused conv is never among the captured
            if done.name in capture:
                captured[done.name] = x
        i += len(ran)
    return x


def cut_rows(net: "Sequential", x):
    """On a mesh with a live ``'spatial'`` axis (its first layer's
    ``mesh``): ``net.plan_rows`` for the images ``x`` [B, H, W, C] and this
    rank's strip of their rows (``Mesh.strip``); elsewhere ``x``."""
    mesh = next(iter(net)).mesh
    if mesh is None or not mesh.active("spatial"):
        return x
    net.plan_rows(x.shape[1])
    lo, hi = mesh.strip(x.shape[1])
    return x[:, lo:hi]


class Sequential(nn.Module):
    def __init__(self, layers: Sequence[Layer]):
        super().__init__()
        names = [l.name for l in layers]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate layer names: {names}")
        self.layers = nn.ModuleDict((l.name, l) for l in layers)

    def __iter__(self):
        return iter(self.layers.values())

    def __getitem__(self, name: str) -> Layer:
        return self.layers[name]

    def tree_leaves(self):
        """``(path, tensor, is_state)`` of every layer's tree, each path
        under its layer's name (``Layer.tree_leaves``)."""
        for layer in self:
            for path, t, is_state in layer.tree_leaves():
                yield (layer.name, *path), t, is_state

    def plan_rows(self, h):
        """Each layer's input rows in turn (``Layer.plan_rows``); the
        output's."""
        for layer in self:
            h = layer.plan_rows(h)
        return h

    def forward(self, x, compute_dtype=None, generator=None, capture=None,
                perms=None):
        """The output; with ``capture`` (layer names), ``(output,
        {name: activation})``."""
        captured = {}
        out = run_layers(list(self.layers.values()), x,
                         compute_dtype=compute_dtype, generator=generator,
                         capture=capture or (), captured=captured,
                         perms=perms)
        return out if capture is None else (out, captured)
