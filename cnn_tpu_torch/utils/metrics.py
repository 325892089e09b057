"""Streaming metrics, a copy of ``cnn_tpu/utils/metrics.py`` (numpy only).

Reference: ``ClassificationEvaluator`` (``metrics.h:8-20``,
``metrics.cpp:6-20``) — accumulate correct/sample counts, ``get()`` the
running top-1 accuracy, ``clear()``. Same surface here, plus a mean-loss
accumulator (the reference keeps that ad hoc in ``cnn.cpp:72-73``).
"""

from __future__ import annotations


class ClassificationEvaluator:
    def __init__(self):
        self.correct_num = 0
        self.sample_num = 0

    def compute(self, predict, labels) -> None:
        """Accumulate a batch; accepts arrays or lists of int."""
        import numpy as np
        predict = np.asarray(predict)
        labels = np.asarray(labels)
        self.correct_num += int((predict == labels).sum())
        self.sample_num += int(labels.shape[0])

    def add_counts(self, correct: int, total: int) -> None:
        """Accumulate device-computed counts (avoids host argmax)."""
        self.correct_num += int(correct)
        self.sample_num += int(total)

    def get(self) -> float:
        return self.correct_num / self.sample_num if self.sample_num else 0.0

    def clear(self) -> None:
        self.correct_num = 0
        self.sample_num = 0


class ConfusionMatrix:
    """Streaming confusion matrix — listed as unimplemented in the
    reference (cnn.cpp:24, TODO #9)."""

    def __init__(self, num_classes: int):
        import numpy as np
        self.matrix = np.zeros((num_classes, num_classes), dtype=int)

    def compute(self, predict, labels) -> None:
        import numpy as np
        predict = np.asarray(predict).ravel()
        labels = np.asarray(labels).ravel()
        np.add.at(self.matrix, (labels, predict), 1)

    def get(self):
        return self.matrix.copy()

    def per_class_accuracy(self):
        import numpy as np
        totals = self.matrix.sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            acc = np.diag(self.matrix) / totals
        return np.where(totals > 0, acc, 0.0)

    def pretty(self, categories=None) -> str:
        n = self.matrix.shape[0]
        categories = categories or [str(i) for i in range(n)]
        w = max(len(c) for c in categories) + 2
        lines = [" " * w + "".join(f"{c:>{w}}" for c in categories) + "   (pred)"]
        for i, c in enumerate(categories):
            lines.append(f"{c:>{w}}" + "".join(
                f"{int(v):>{w}}" for v in self.matrix[i]))
        return "\n".join(lines)

    def clear(self) -> None:
        self.matrix[:] = 0


class MeanLoss:
    def __init__(self):
        self.total = 0.0
        self.count = 0

    def add(self, loss: float) -> None:
        self.total += float(loss)
        self.count += 1

    def get(self) -> float:
        return self.total / self.count if self.count else 0.0

    def clear(self) -> None:
        self.total = 0.0
        self.count = 0
