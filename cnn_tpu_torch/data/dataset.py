"""Dataset discovery and splitting, a copy of ``cnn_tpu/data/dataset.py``
(the same membership and order from the same seed).

Reference (``pipeline.cpp:81-108``): walk ``dataset_path/<category>/`` for
each category in order, label by category index, shuffle the combined list
(``std::shuffle`` seed 212), slice 8:1:1 into train/test/valid **in that
order** (train first, then test, then valid — ``pipeline.cpp:100-105``).

Divergence note: C++ ``std::shuffle`` with ``std::default_random_engine``
cannot be reproduced from NumPy, so the exact train/test/valid membership
differs from the reference run even with the same seed. Same distribution,
same sizes, deterministic under our seed — accuracy comparisons are
statistical, weight-level parity flows through checkpoints (SURVEY.md §7).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

Sample = tuple[str, int]


def discover_dataset(dataset_path: str, categories: Sequence[str]) -> list[Sample]:
    """[(image_path, label_index)] for all images under each category dir."""
    samples: list[Sample] = []
    for label, cat in enumerate(categories):
        cat_dir = os.path.join(dataset_path, cat)
        if not os.path.isdir(cat_dir):
            raise FileNotFoundError(f"category directory missing: {cat_dir}")
        for name in sorted(os.listdir(cat_dir)):
            path = os.path.join(cat_dir, name)
            if os.path.isfile(path):
                samples.append((path, label))
    return samples


def split_dataset(samples: list[Sample], train_ratio: float = 0.8,
                  test_ratio: float = 0.1, seed: int = 212) -> dict[str, list[Sample]]:
    """Shuffled train/test/valid split; slice order matches pipeline.cpp:100-105."""
    assert train_ratio > 0 and test_ratio > 0 and train_ratio + test_ratio < 1
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(samples))
    shuffled = [samples[i] for i in order]
    n = len(shuffled)
    n_train = int(n * train_ratio)
    n_test = int(n * test_ratio)
    return {
        "train": shuffled[:n_train],
        "test": shuffled[n_train:n_train + n_test],
        "valid": shuffled[n_train + n_test:],
    }
