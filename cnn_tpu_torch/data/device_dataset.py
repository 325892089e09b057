"""Device-resident dataset and the fully on-device train step, counterpart
of ``cnn_tpu/data/device_dataset.py``.

The uint8 canvases and their labels are uploaded to the GPU once; each step
samples its batch there (uniform with replacement, or by walking per-epoch
permutations), augments it, and trains on it, with no host traffic but the
launches; ``steps_per_call`` such steps a call.

``DeviceDataset(samples, image_size, num_workers)`` decodes a list of
``(path, label)`` samples through the host ``DataLoader`` (``data/image.py``
in place of cv2), as ``cnn_tpu`` does, and uploads the result;
``DeviceDataset.from_arrays`` takes in-memory arrays. ``epoch_batches``
walks the rows in order for eval.
"""

from __future__ import annotations

import numpy as np
import torch

from cnn_tpu_torch import default_device
from cnn_tpu_torch.data.loader import DataLoader
from cnn_tpu_torch.parallel.train_step import (TrainState, apply_gradients,
                                               check_supported,
                                               normalize_distill, to_compute)


class DeviceDataset:
    """[N,S,S,C] uint8 canvases and [N] int64 labels held on one device."""

    def __init__(self, samples, image_size: int = 256, num_workers: int = 4,
                 sharding=None, mesh=None, device=None):
        """Decodes ``samples`` at ``image_size`` (``num_workers`` threads)
        and uploads them to ``device`` (default: the GPU)."""
        check_supported(mesh=mesh)
        if sharding is not None:
            raise NotImplementedError("sharding is not ported yet")
        dev = default_device(device)
        # batch_size bounds the loader's in-flight decode futures: at 1 the
        # worker pool degenerates to serial decode (one future per yield)
        bs = max(1, min(8 * num_workers, len(samples)))
        loader = DataLoader(samples, batch_size=bs, shuffle=False,
                            image_size=image_size, num_workers=num_workers)
        imgs = np.empty((len(samples), image_size, image_size, 3), np.uint8)
        lbls = np.empty((len(samples),), np.int64)
        pos = 0
        for img, lbl in loader:
            imgs[pos:pos + len(lbl)] = img
            lbls[pos:pos + len(lbl)] = lbl
            pos += len(lbl)
        self._place(imgs, lbls, dev)

    @classmethod
    def from_arrays(cls, images: np.ndarray, labels: np.ndarray,
                    sharding=None, mesh=None, device=None) -> "DeviceDataset":
        """Uploads in-memory arrays to ``device`` (default: the GPU)."""
        check_supported(mesh=mesh)
        if sharding is not None:
            raise NotImplementedError("sharding is not ported yet")
        self = cls.__new__(cls)
        self._place(images, labels, default_device(device))
        return self

    def _place(self, images: np.ndarray, labels: np.ndarray, device) -> None:
        if images.shape[:1] != np.shape(labels):
            raise ValueError(f"{images.shape[0]} images, {np.shape(labels)} "
                             "labels")
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        self.labels = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
        self.n = self.n_real = images.shape[0]
        self.image_size = images.shape[1]

    def sample(self, generator: torch.Generator, batch_size: int):
        """Uniform sampling with replacement, on the device."""
        idx = torch.randint(0, self.n, (batch_size,), generator=generator,
                            device=self.images.device)
        return self.images.index_select(0, idx), self.labels.index_select(0, idx)

    def epoch_sample(self, seed: int, step: int, batch_size: int,
                     fixed: bool):
        """The batch of ``step`` when walking per-epoch permutations."""
        idx = epoch_indices(seed, step, batch_size, self.n, fixed,
                            self.images.device)
        return self.images.index_select(0, idx), self.labels.index_select(0, idx)

    def epoch_batches(self, batch_size: int):
        """Sequential full-epoch iteration (for eval): the rows in order,
        ``batch_size`` at a time, then the remainder; views of the device
        tensors."""
        n = self.n_real
        for start in range(0, n - batch_size + 1, batch_size):
            yield (self.images[start:start + batch_size],
                   self.labels[start:start + batch_size])
        rem = n % batch_size
        if rem:
            yield self.images[n - rem:n], self.labels[n - rem:n]


def _epoch_perm(seed: int, epoch: int, n: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 0x9E3779B1 + 0x45504F43 + epoch) % 2**63)
    return torch.randperm(n, generator=g, device=device)


def epoch_indices(seed: int, step: int, batch_size: int, n: int, fixed: bool,
                  device) -> torch.Tensor:
    """Rows of batch ``step`` without replacement: positions
    ``step*bs + i`` walk a permutation of ``[0, n)`` per epoch, and a batch
    that straddles an epoch boundary takes its tail from the next epoch's
    permutation, so every sample is seen once per epoch (the reference's
    protocol). ``fixed`` uses the same permutation every epoch (the
    reference reseeds its shuffle each epoch)."""
    if batch_size > n:
        raise ValueError(f"batch {batch_size} exceeds the dataset ({n} rows)")
    g = step * batch_size + torch.arange(batch_size, device=device)
    e, pos = g // n, g % n
    e0 = step * batch_size // n
    p0 = _epoch_perm(seed, 0 if fixed else e0, n, device)
    p1 = _epoch_perm(seed, 0 if fixed else e0 + 1, n, device)
    return torch.where(e == e0, p0[pos], p1[pos])


def make_device_train_step(model, optimizer, dataset: DeviceDataset,
                           batch_size: int, *, compute_dtype=None,
                           augment_fn=None, label_smoothing: float = 0.0,
                           mesh=None,
                           sample_mode: str = "local",
                           steps_per_call: int = 1, grad_accum: int = 1,
                           mixup: float = 0.0, cutmix: float = 0.0,
                           distill=None):
    """Fully on-device train step: sampling, augmentation (or the normalize
    kernel when ``augment_fn`` is None), forward, backward and update.

    Returns ``(ts) -> (ts, metrics)``. ``sample_mode``: 'local' (or
    'global', the same without a mesh) samples uniformly with replacement
    from ``ts.rng``; 'epoch' walks a fresh permutation per epoch, keyed by
    ``ts.seed`` and ``ts.step``; 'epoch_fixed' the same permutation every
    epoch. ``augment_fn(generator, images)`` draws from ``ts.rng``; its
    output is cast to ``compute_dtype`` when that is given (pass it the same
    ``dtype``, e.g. ``augment_batch(..., dtype=torch.bfloat16)``, as
    ``cnn_tpu``'s train CLI does); without it the uint8 batch is normalized
    to float32 and rounded to ``compute_dtype``.

    ``steps_per_call``: that many steps a call, each on its own sampled
    batch; the metrics are their mean loss, their summed ``correct`` and
    ``batch = batch_size * steps_per_call``. ``grad_accum``, ``mixup``,
    ``cutmix`` and ``distill`` are ``make_train_step``'s.
    """
    check_supported(compute_dtype=compute_dtype, mesh=mesh)
    if sample_mode not in ("local", "global", "epoch", "epoch_fixed"):
        raise ValueError(f"unknown sample_mode '{sample_mode}'")
    epoch_mode = sample_mode.startswith("epoch")
    dst = normalize_distill(distill)

    def one(ts: TrainState):
        if epoch_mode:
            images, labels = dataset.epoch_sample(
                ts.seed, ts.step, batch_size, sample_mode == "epoch_fixed")
        else:
            images, labels = dataset.sample(ts.rng, batch_size)
        images = to_compute(images, ts.rng, augment_fn, compute_dtype)
        return apply_gradients(ts, optimizer, images, labels,
                               label_smoothing, compute_dtype,
                               grad_accum=grad_accum, mixup=mixup,
                               cutmix=cutmix, distill=dst)

    def step(ts: TrainState):
        if steps_per_call == 1:
            metrics = one(ts)
        else:
            runs = [one(ts) for _ in range(steps_per_call)]
            metrics = {"loss": torch.stack([m["loss"] for m in runs]).mean(),
                       "correct": sum(m["correct"] for m in runs)}
        metrics["batch"] = batch_size * steps_per_call
        return ts, metrics

    return step
