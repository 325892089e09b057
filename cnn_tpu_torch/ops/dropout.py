"""Channel dropout over NHWC (whole feature maps), counterpart of
``cnn_tpu/ops/dropout.py``, with its three modes:

- ``compat="reference"``: the first ``int(p*C)`` channels are dropped at
  every training step (the reference C++ selects no random subset); eval
  multiplies by ``1 - p``.
- ``compat="sampled"``: a random subset of ``int(p*C)`` channels is
  dropped; eval multiplies by ``1 - p``.
- ``compat="inverted"`` (default): a random subset is dropped and the kept
  channels are divided by the kept fraction; eval is the identity.

The draw and the apply are two functions: ``draw_permutation`` takes a
permutation of the channels from an explicit ``torch.Generator``, and
``channel_dropout`` drops the channels whose place in it is below
``int(p*C)``, as ``cnn_tpu`` does with ``jax.random.permutation``. Given
the same permutation the two give the same bits; the generators cannot
agree (Philox against threefry).
"""

from __future__ import annotations

import torch

MODES = ("reference", "sampled", "inverted")


def draw_permutation(channels: int, generator: torch.Generator) -> torch.Tensor:
    """A uniform permutation of ``range(channels)`` on the generator's
    device."""
    return torch.randperm(channels, generator=generator,
                          device=generator.device)


def channel_dropout(x: torch.Tensor, p: float, *, train: bool,
                    perm: torch.Tensor | None = None,
                    compat: str = "inverted") -> torch.Tensor:
    """``x`` [..., C] with ``int(p*C)`` channels dropped (module docstring).
    ``perm`` (a permutation of the C channels) is needed in training by
    the two random modes."""
    if compat not in MODES:
        raise ValueError(f"unknown dropout compat mode: {compat!r}")
    if p <= 0.0:
        return x
    c = x.shape[-1]
    n_drop = int(p * c)
    if n_drop >= c:
        raise ValueError(f"cannot drop all {c} channels (p={p})")
    if not train:
        if compat == "inverted":
            return x
        return x * torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
    if compat == "reference":
        keep = torch.arange(c, device=x.device) >= n_drop
        return x * keep.to(x.dtype)
    if perm is None:
        raise ValueError(f"{compat} dropout draws its channels in training: "
                         "pass a permutation (draw_permutation)")
    keep = (perm.to(x.device) >= n_drop).to(x.dtype)
    if compat == "inverted":
        keep = keep / torch.full((), 1.0 - n_drop / c, dtype=x.dtype,
                                 device=x.device)
    return x * keep
