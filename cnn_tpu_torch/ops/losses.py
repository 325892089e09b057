"""Softmax, one-hot and softmax cross-entropy, counterpart of
``cnn_tpu/ops/losses.py``.

``softmax_cross_entropy`` is the batch mean of ``-sum(y * log_softmax)`` in
float32, with optional label smoothing ``y * (1 - s) + s / C``; its gradient
with respect to the logits is ``(softmax - y) / B``.

``distillation_loss`` and ``distillation_loss_from_probs`` are the
knowledge-distillation term ``T^2 * KL(p_teacher || softmax(s / T))``,
batch mean, with the teacher held without gradient.
"""

from __future__ import annotations

import torch


def softmax(logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Float32 softmax over ``axis`` (``cnn_tpu``'s keyword)."""
    return torch.softmax(logits.float(), dim=axis)


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


def distillation_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor,
                      temperature: float = 2.0) -> torch.Tensor:
    """Batch-mean ``T^2 * KL(softmax(t/T) || softmax(s/T))`` in float32;
    no gradient reaches the teacher."""
    t = teacher_logits.detach().float() / temperature
    s = student_logits.float() / temperature
    p_t = torch.softmax(t, dim=-1)
    kl = torch.sum(p_t * (torch.log_softmax(t, dim=-1)
                          - torch.log_softmax(s, dim=-1)), dim=-1)
    return (temperature ** 2) * torch.mean(kl)


def distillation_loss_from_probs(student_logits: torch.Tensor,
                                 teacher_probs: torch.Tensor,
                                 temperature: float = 2.0) -> torch.Tensor:
    """The same term against given teacher probabilities at ``T`` (an
    ensemble's mean of tempered softmaxes): ``log p_t`` floored at
    ``log(1e-20)``."""
    p_t = teacher_probs.detach().float()
    s = student_logits.float() / temperature
    log_p_t = torch.log(torch.clamp(p_t, min=1e-20))
    kl = torch.sum(p_t * (log_p_t - torch.log_softmax(s, dim=-1)), dim=-1)
    return (temperature ** 2) * torch.mean(kl)
