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

On a mesh (``parallel/mesh.py``) the dataset shards over ``'data'``: the
rows are padded to a multiple of the data axis by re-listing the leading
ones, and each rank holds (and decodes) its contiguous shard only. The
sharded step samples each rank's rows of the global batch:

- ``'local'``: each shard samples its ``B / D`` rows from its own rows,
  uniformly with replacement; every rank draws the indices of all the
  shards (``[D, B / D]``, from ``ts.rng``, in the same state on every
  rank) and keeps its own, so no collective runs;
- ``'global'``: the unsharded path's indices (one draw of ``B`` over the
  whole padded set), each rank keeping its rows of the batch, which the
  ranks holding them send (a zero-filled ``all_reduce``); the
  single-device equivalence mode;
- ``'epoch'`` / ``'epoch_fixed'``: each shard walks its own per-epoch
  permutation of its rows, the shard index folded into the seed; the
  last shard's pad slots are remapped to real rows of its own, drawn
  anew each epoch, so every real row is seen at least once an epoch and
  no fixed row twice.

The ranks that share a data shard (the other axes: ``'stage'``,
``'model'``, ``'spatial'``, ``'expert'``) hold the same rows and draw from generators
in the same state, so they sample, augment and mix the same whole images;
the model then cuts each rank's strip of their rows
(``nn/sequential.py:cut_rows``).

On the GPU the sharded call is one CUDA graph where the process group is
NCCL (collectives included); under gloo, whose collectives a graph
cannot capture, the eager loop runs and the step says so when made.
``device_batches`` is the sampling of both this step and the pipelined
one (``parallel/pipeline.py``), whose stages of a data shard draw alike.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cnn_tpu_torch import default_device, optim
from cnn_tpu_torch.data.loader import DataLoader
from cnn_tpu_torch.ops.hopper import add_counters, counted_capture
from cnn_tpu_torch.parallel.train_step import (TrainState, apply_gradients,
                                               check_supported,
                                               normalize_distill, shard_model,
                                               to_compute)


def _shard_rows(n_real: int, mesh) -> tuple[int, range]:
    """The padded row count (a multiple of the data axis) and the rows of
    the real set that this rank's shard lists (pad rows re-list the
    leading ones)."""
    n = n_real + (-n_real) % mesh.size("data")
    k = n // mesh.size("data")
    lo = mesh.index("data") * k
    return n, range(lo, lo + k)


class DeviceDataset:
    """[N,S,S,C] uint8 canvases and [N] int64 labels held on one device;
    on a mesh this rank's shard of them (``n`` rows padded, ``n_real``
    real, ``n_local`` here)."""

    def __init__(self, samples, image_size: int = 256, num_workers: int = 4,
                 sharding=None, mesh=None, device=None):
        """Decodes ``samples`` at ``image_size`` (``num_workers`` threads)
        and uploads them to ``device`` (default: the GPU; on ``mesh``, its
        device, this rank's shard only)."""
        if sharding is not None:
            raise NotImplementedError("a sharding other than the mesh's "
                                      "'data' axis is not ported")
        dev = mesh.device if mesh is not None else default_device(device)
        n_real = len(samples)
        if mesh is not None:
            samples = [samples[i % n_real]
                       for i in _shard_rows(n_real, mesh)[1]]
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
        self._place(imgs, lbls, dev, mesh, n_real)

    @classmethod
    def from_arrays(cls, images: np.ndarray, labels: np.ndarray,
                    sharding=None, mesh=None, device=None) -> "DeviceDataset":
        """Uploads in-memory arrays to ``device`` (default: the GPU); on
        ``mesh``, this rank's shard of them to its device."""
        if sharding is not None:
            raise NotImplementedError("a sharding other than the mesh's "
                                      "'data' axis is not ported")
        if images.shape[:1] != np.shape(labels):
            raise ValueError(f"{images.shape[0]} images, {np.shape(labels)} "
                             "labels")
        self = cls.__new__(cls)
        n_real = len(labels)
        if mesh is None:
            self._place(images, labels, default_device(device), None, n_real)
        else:
            rows = [i % n_real for i in _shard_rows(n_real, mesh)[1]]
            self._place(images[rows], np.asarray(labels)[rows], mesh.device,
                        mesh, n_real)
        return self

    def _place(self, images: np.ndarray, labels: np.ndarray, device, mesh,
               n_real: int) -> None:
        self.images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        self.labels = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
        self.mesh, self.n_real = mesh, n_real
        self.n_local = images.shape[0]
        self.n = n_real if mesh is None else _shard_rows(n_real, mesh)[0]
        self.image_size = images.shape[1]

    def sample(self, generator: torch.Generator, batch_size: int):
        """Uniform sampling with replacement, on the device (unsharded:
        a sharded set samples through ``shard_sample``)."""
        self._unsharded()
        idx = torch.randint(0, self.n, (batch_size,), generator=generator,
                            device=self.images.device)
        return self.images.index_select(0, idx), self.labels.index_select(0, idx)

    def _unsharded(self) -> None:
        if self.mesh is not None:
            raise ValueError("this dataset is sharded over a mesh: its rows "
                             "are one shard's (make_device_train_step "
                             "samples it)")

    def epoch_batches(self, batch_size: int):
        """Sequential full-epoch iteration (for eval): the rows in order,
        ``batch_size`` at a time, then the remainder; views of the device
        tensors. (An unsharded dataset only, as ``cnn_tpu``'s train CLI
        keeps its validation set.)"""
        self._unsharded()
        n = self.n_real
        for start in range(0, n - batch_size + 1, batch_size):
            yield (self.images[start:start + batch_size],
                   self.labels[start:start + batch_size])
        rem = n % batch_size
        if rem:
            yield self.images[n - rem:n], self.labels[n - rem:n]


def _epoch_generator(seed: int, epoch: int, device, shard=None,
                     stream: int = 0x45504F43) -> torch.Generator:
    """The generator of ``epoch``'s draws: ``stream`` "EPOC" for the
    permutation, "PADD" for the pad slots' rows; a shard's index folded
    into the seed."""
    key = seed * 0x9E3779B1 + stream + epoch
    if shard is not None:
        key = key * 0x9E3779B1 + shard + 1
    return torch.Generator(device=device).manual_seed(key % 2**63)


def _epoch_perm(seed: int, epoch: int, n: int, device,
                shard=None) -> torch.Tensor:
    return torch.randperm(n, generator=_epoch_generator(
        seed, epoch, device, shard), device=device)


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
                 fixed: bool, device, shard=None, real: int | None = None,
                 ) -> torch.Tensor:
    """``epoch_indices`` of batches ``step .. step + steps - 1``, as
    [steps, batch_size], each epoch's permutation drawn once. ``shard``:
    the data shard whose ``n`` local rows these walk (its own
    permutations), of which the first ``real`` are real: a slot on a pad
    row takes a real row drawn for it each epoch."""
    if batch_size > n:
        raise ValueError(f"batch {batch_size} exceeds the dataset ({n} rows)")
    g = step * batch_size + torch.arange(steps * batch_size, device=device)
    e, pos = g // n, g % n
    e0, e1 = step * batch_size // n, ((step + steps) * batch_size - 1) // n
    epochs = [0] if fixed else range(e0, e1 + 1)
    at = torch.zeros_like(e) if fixed else e - e0
    idx = torch.stack([_epoch_perm(seed, k, n, device, shard)
                       for k in epochs])[at, pos]
    if real is not None and real < n:
        repl = torch.stack([torch.randint(
            0, real, (n,), device=device, generator=_epoch_generator(
                seed, k, device, shard, 0x50414444)) for k in epochs])
        idx = torch.where(idx >= real, repl[at, pos], idx)
    return idx.reshape(steps, -1)


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
                     torch.empty_like(self.sampler(ts.seed, ts.step)))
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


def shard_sample(dataset: DeviceDataset, mode: str,
                 generator: torch.Generator, batch_size: int):
    """This rank's rows of a uniform global batch on a sharded dataset
    (module docstring): ``'local'`` from its shard, ``'global'`` the
    unsharded path's indices over the padded set."""
    mesh, dev = dataset.mesh, dataset.images.device
    d, size = mesh.index("data"), mesh.size("data")
    per = batch_size // size
    if mode == "local":
        idx = torch.randint(0, dataset.n_local, (size, per),
                            generator=generator, device=dev)[d]
        return (dataset.images.index_select(0, idx),
                dataset.labels.index_select(0, idx))
    idx = torch.randint(0, dataset.n, (batch_size,), generator=generator,
                        device=dev)
    # every row of the batch from the rank whose shard holds it, the
    # others adding zeros
    mine = (idx // dataset.n_local) == d
    own = torch.where(mine, idx - d * dataset.n_local, torch.zeros_like(idx))
    images = dataset.images.index_select(0, own) * mine.to(
        torch.uint8)[:, None, None, None]
    labels = dataset.labels.index_select(0, own) * mine
    return (mesh.all_sum(images, "data")[d * per:(d + 1) * per],
            mesh.all_sum(labels, "data")[d * per:(d + 1) * per])


def device_batches(dataset: DeviceDataset, batch_size: int, mesh=None,
                   sample_mode: str = "local"):
    """The batches of a device step: ``(draw, sampler)``. ``draw(ts,
    rows=None)`` is this rank's ``(images, labels)`` of the step's batch:
    dataset ``rows`` where given, the epoch modes' rows of ``ts.step``
    (``sampler(ts.seed, ts.step)``), else a uniform draw from ``ts.rng``
    (``DeviceDataset.sample``, or ``shard_sample`` on ``mesh``).
    ``sampler(seed, step, steps=1)``: the [steps, rows] dataset rows of
    the epoch modes."""
    if sample_mode not in ("local", "global", "epoch", "epoch_fixed"):
        raise ValueError(f"unknown sample_mode '{sample_mode}'")
    epoch_mode = sample_mode.startswith("epoch")
    fixed = sample_mode == "epoch_fixed"
    sample = (dataset.sample if mesh is None
              else functools.partial(shard_sample, dataset, sample_mode))

    def draw(ts: TrainState, rows=None):
        if rows is None and epoch_mode:
            rows = sampler(ts.seed, ts.step)[0]
        if rows is not None:
            return (dataset.images.index_select(0, rows),
                    dataset.labels.index_select(0, rows))
        return sample(ts.rng, batch_size)

    def sampler(seed, step, steps=1):
        if mesh is None:
            return call_indices(seed, step, steps, batch_size, dataset.n,
                                fixed, dataset.images.device)
        d, size = mesh.index("data"), mesh.size("data")
        assert dataset.n - dataset.n_real < dataset.n_local, (
            dataset.n, dataset.n_real, dataset.n_local)
        # the pad rows are the padded set's tail: the last shard's
        real = (dataset.n_real - (size - 1) * dataset.n_local
                if d == size - 1 else dataset.n_local)
        return call_indices(seed, step, steps, batch_size // size,
                            dataset.n_local, fixed, dataset.images.device,
                            shard=d, real=real)

    return draw, sampler


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

    ``mesh``: the dataset's (``DeviceDataset(..., mesh=)``); each rank
    samples its rows of the global batch (module docstring) and the step
    runs sharded (``parallel/train_step.py``). The call is captured only
    where the process group is NCCL; under gloo the eager loop runs, and
    the step prints which.
    """
    check_supported(compute_dtype=compute_dtype)
    draw, sampler = device_batches(dataset, batch_size, mesh, sample_mode)
    if mesh is not dataset.mesh:
        raise ValueError("the dataset must be uploaded onto the same mesh")
    epoch_mode = sample_mode.startswith("epoch")
    dst = normalize_distill(distill)
    if mesh is not None:
        shard_model(model, mesh)
        for teacher in (dst[0] if dst else ()):
            shard_model(teacher, mesh)
        if batch_size % mesh.size("data"):
            raise ValueError(f"batch {batch_size} does not split over "
                             f"{mesh.size('data')} data shards")

    def one(ts: TrainState, rows=None):
        images, labels = draw(ts, rows)
        images = to_compute(images, ts.rng, augment_fn, compute_dtype, mesh)
        return apply_gradients(ts, optimizer, images, labels,
                               label_smoothing, compute_dtype,
                               grad_accum=grad_accum, mixup=mixup,
                               cutmix=cutmix, distill=dst, mesh=mesh)

    def run(ts: TrainState, rows=None) -> dict:
        """The call's steps; ``rows``: their [K, B] epoch-sampler rows."""
        runs = [one(ts, None if rows is None else rows[k])
                for k in range(steps_per_call)]
        if steps_per_call == 1:
            return runs[0]
        return {"loss": torch.stack([m["loss"] for m in runs]).mean(),
                "correct": sum(m["correct"] for m in runs)}

    captured = dataset.images.device.type == "cuda" and not eager and (
        mesh is None or mesh.backend == "nccl")
    if mesh is not None:
        how = "one CUDA graph a call" if captured else "the eager loop"
        if not captured and dataset.images.device.type == "cuda" and not eager:
            how += " (gloo's collectives cannot be captured)"
        backend = mesh.backend or "no process group"
        print(f"device step on the mesh {mesh.shape} ({backend}): {how}",
              flush=True)
    if captured:
        return GraphedSteps(run, steps_per_call, batch_size, dataset,
                            functools.partial(sampler, steps=steps_per_call)
                            if epoch_mode else None)

    def step(ts: TrainState):
        metrics = run(ts)
        metrics["batch"] = batch_size * steps_per_call
        return ts, metrics

    return step
