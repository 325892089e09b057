"""The model wrapper the families share: a ``Sequential`` stack in
``self.net`` and ``cnn_tpu``'s ``apply`` as ``forward``."""

from __future__ import annotations

import torch
from torch import nn

from cnn_tpu_torch import default_device
from cnn_tpu_torch.nn.sequential import cut_rows


class SequentialModel(nn.Module):
    """``train()`` normalizes BN by batch statistics and updates the
    moving ones (and drops channels in a Dropout); ``eval()`` uses the
    moving statistics and, with no gradient asked for, runs the bare
    kernels."""

    def __init__(self, num_classes: int, image_size: int):
        super().__init__()
        self.num_classes = num_classes
        self.image_size = image_size

    def forward(self, x, compute_dtype=None, generator=None, capture=None):
        """[B, S, S, 3] float -> logits [B, num_classes], in
        ``compute_dtype`` when given (the parameters stay float32);
        ``generator`` feeds a training-mode Dropout; with ``capture``
        (layer names) ``(logits, {name: activation})``."""
        return self.net(cut_rows(self.net, x), compute_dtype=compute_dtype,
                        generator=generator, capture=capture)


def init_args(device=None, generator=None) -> tuple[torch.device,
                                                    torch.Generator]:
    """The device (``default_device``) and the CPU generator the weights
    are drawn from, in layer order (default: seed 0)."""
    return (default_device(device),
            generator if generator is not None
            else torch.Generator().manual_seed(0))
