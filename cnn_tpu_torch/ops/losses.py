"""Softmax, one-hot and softmax cross-entropy, counterpart of
``cnn_tpu/ops/losses.py``.

``softmax_cross_entropy`` is the batch mean of ``-sum(y * log_softmax)`` in
float32, with optional label smoothing ``y * (1 - s) + s / C``; its gradient
with respect to the logits is ``(softmax - y) / B``.
"""

from __future__ import annotations

import torch


def softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=dim)


def one_hot(labels: torch.Tensor, num_classes: int,
            dtype=torch.float32) -> torch.Tensor:
    return torch.nn.functional.one_hot(labels.long(), num_classes).to(dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Batch-mean softmax CE. ``labels``: int [B] or one-hot [B, C]."""
    logits = logits.float()
    log_p = torch.log_softmax(logits, dim=-1)
    if labels.dim() == logits.dim() - 1:
        labels = one_hot(labels, logits.shape[-1])
    if label_smoothing > 0.0:
        labels = labels * (1.0 - label_smoothing) + label_smoothing / logits.shape[-1]
    return torch.mean(-torch.sum(labels * log_p, dim=-1))
