"""Device-resident dataset and the fully on-device train step, counterpart
of ``cnn_tpu/data/device_dataset.py``.

The uint8 canvases and their labels are uploaded to the GPU once; each step
samples its batch there (uniform with replacement, or by walking per-epoch
permutations), augments it, and trains on it, with no host traffic but the
launches; ``steps_per_call`` such steps a call.

On the GPU each call of the step is one CUDA graph, as each call of
``cnn_tpu``'s is one compiled program (``lax.scan`` over the steps). The
first call runs its steps eagerly (real training, and the warm-up); the
second captures all of them into one graph and every call from then on
replays it (``GraphedSteps``). The eager loop stays as the plain version:
it is the CPU path, and ``make_device_train_step(..., eager=True)`` runs it
on the GPU for comparisons.

``DeviceDataset(samples, image_size, num_workers)`` decodes a list of
``(path, label)`` samples through the host ``DataLoader`` (``data/image.py``
in place of cv2), as ``cnn_tpu`` does, and uploads the result;
``DeviceDataset.from_arrays`` takes in-memory arrays. ``epoch_batches``
walks the rows in order for eval.
"""

from __future__ import annotations

import numpy as np
import torch

from cnn_tpu_torch import default_device, optim
from cnn_tpu_torch.data.loader import DataLoader
from cnn_tpu_torch.ops.hopper import add_counters, counted_capture
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
    return call_indices(seed, step, 1, batch_size, n, fixed, device)[0]


def call_indices(seed: int, step: int, steps: int, batch_size: int, n: int,
                 fixed: bool, device) -> torch.Tensor:
    """``epoch_indices`` of batches ``step .. step + steps - 1``, as
    [steps, batch_size], each epoch's permutation drawn once."""
    if batch_size > n:
        raise ValueError(f"batch {batch_size} exceeds the dataset ({n} rows)")
    g = step * batch_size + torch.arange(steps * batch_size, device=device)
    e, pos = g // n, g % n
    if fixed:
        return _epoch_perm(seed, 0, n, device)[pos].reshape(steps, -1)
    e0, e1 = step * batch_size // n, ((step + steps) * batch_size - 1) // n
    perms = torch.stack([_epoch_perm(seed, k, n, device)
                         for k in range(e0, e1 + 1)])
    return perms[e - e0, pos].reshape(steps, -1)


class GraphedSteps:
    """A device-dataset call as one CUDA graph: ``(ts) -> (ts, metrics)``.

    ``run(ts, rows)`` is the call's eager body (``rows``: the [K, B]
    dataset rows of the epoch samplers, else None). The first call runs
    it on a side stream, for real: the warm-up. The second captures it on
    that stream, with ``ts.rng`` registered with the graph (each replay
    advances it as the eager steps would) and the optimizer's per-update
    scalars read from an ``optim.ScalarFeed``; the capture runs the host's
    side of the steps, so the counts and ``ts.step`` are then put back.
    Every call from the second on, before its replay, fills the feed from
    the counts and, in the epoch modes, the rows from ``call_indices``;
    after it, adds the kernel counters the capture recorded
    (``ops/hopper:counted_capture``), ``K`` to ``ts.step`` and to each
    count what the capture moved it by. The metrics are copies of the
    graph's. The graph holds the addresses of the state's tensors: a call
    with another train state, or one whose state tensors were replaced,
    raises."""

    def __init__(self, run, steps: int, batch_size: int, dataset,
                 sampler=None):
        self.run, self.k, self.batch_size = run, steps, batch_size
        self.dataset, self.sampler = dataset, sampler
        self.graph = None
        self.ts = None

    @staticmethod
    def _held(ts) -> list:
        """The identities the graph depends on."""
        return [id(x) for x in (ts.model, ts.opt_state, ts.rng,
                                *ts.model.parameters(), *ts.model.buffers())]

    def __call__(self, ts):
        dev = self.dataset.images.device
        main = torch.cuda.current_stream(dev)
        if self.ts is None:
            self.ts, self.held = ts, self._held(ts)
            self.stream = torch.cuda.Stream(dev)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                metrics = self.run(ts, None)
            main.wait_stream(self.stream)
            return ts, self._out(metrics)
        if ts is not self.ts or self._held(ts) != self.held:
            raise RuntimeError("this step's CUDA graph holds the train state "
                               "of its first call: make a new step for "
                               "another state")
        if self.graph is None:
            self._capture(ts)
        self.feed.fill()
        if self.rows is not None:
            self.rows.copy_(self.sampler(ts.seed, ts.step))
        self.graph.replay()
        add_counters(self.launches)
        ts.step += self.k
        for c, n in zip(self.counts, self.advance):
            c.add_(n)
        return ts, self._out(self.metrics)

    def _out(self, metrics) -> dict:
        return {"loss": metrics["loss"].clone(),
                "correct": metrics["correct"].clone(),
                "batch": self.batch_size * self.k}

    def _capture(self, ts) -> None:
        dev = self.dataset.images.device
        self.counts = optim.counts(ts.opt_state)
        start = [int(c) for c in self.counts]
        step = ts.step
        self.feed = optim.ScalarFeed(self.counts, dev, capacity=64 * self.k)
        self.rows = (None if self.sampler is None else
                     torch.empty((self.k, self.batch_size), dtype=torch.long,
                                 device=dev))
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(ts.rng)

        def capture():
            with optim.feeding(self.feed), \
                    torch.cuda.graph(graph, stream=self.stream):
                return self.run(ts, self.rows)

        self.metrics, self.launches = counted_capture(capture)
        if self._held(ts) != self.held:
            raise RuntimeError("the captured steps replaced a state tensor")
        self.advance = [int(c) - s for c, s in zip(self.counts, start)]
        for c, s in zip(self.counts, start):
            c.fill_(s)
        ts.step = step
        self.graph = graph


def make_device_train_step(model, optimizer, dataset: DeviceDataset,
                           batch_size: int, *, compute_dtype=None,
                           augment_fn=None, label_smoothing: float = 0.0,
                           mesh=None,
                           sample_mode: str = "local",
                           steps_per_call: int = 1, grad_accum: int = 1,
                           mixup: float = 0.0, cutmix: float = 0.0,
                           distill=None, eager: bool = False):
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

    On the GPU a call is one CUDA graph of its steps from the second call
    on (``GraphedSteps``); ``eager=True`` keeps the eager loop there, the
    graph's oracle.
    """
    check_supported(compute_dtype=compute_dtype, mesh=mesh)
    if sample_mode not in ("local", "global", "epoch", "epoch_fixed"):
        raise ValueError(f"unknown sample_mode '{sample_mode}'")
    epoch_mode = sample_mode.startswith("epoch")
    dst = normalize_distill(distill)

    fixed = sample_mode == "epoch_fixed"

    def one(ts: TrainState, rows=None):
        if rows is not None:
            images = dataset.images.index_select(0, rows)
            labels = dataset.labels.index_select(0, rows)
        elif epoch_mode:
            images, labels = dataset.epoch_sample(ts.seed, ts.step,
                                                  batch_size, fixed)
        else:
            images, labels = dataset.sample(ts.rng, batch_size)
        images = to_compute(images, ts.rng, augment_fn, compute_dtype)
        return apply_gradients(ts, optimizer, images, labels,
                               label_smoothing, compute_dtype,
                               grad_accum=grad_accum, mixup=mixup,
                               cutmix=cutmix, distill=dst)

    def run(ts: TrainState, rows=None) -> dict:
        """The call's steps; ``rows``: their [K, B] epoch-sampler rows."""
        runs = [one(ts, None if rows is None else rows[k])
                for k in range(steps_per_call)]
        if steps_per_call == 1:
            return runs[0]
        return {"loss": torch.stack([m["loss"] for m in runs]).mean(),
                "correct": sum(m["correct"] for m in runs)}

    if dataset.images.device.type == "cuda" and not eager:
        sampler = None
        if epoch_mode:
            def sampler(seed, step):
                return call_indices(seed, step, steps_per_call, batch_size,
                                    dataset.n, fixed, dataset.images.device)
        return GraphedSteps(run, steps_per_call, batch_size, dataset,
                            sampler)

    def step(ts: TrainState):
        metrics = run(ts)
        metrics["batch"] = batch_size * steps_per_call
        return ts, metrics

    return step
