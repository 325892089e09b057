"""Multi-process smoke of the pipeline, counterpart of
``cnn_tpu/tools/multihost_pp_smoke.py``: one process per rank.

Every process runs this same program (``parallel/mesh.py:
init_distributed`` starts the process group at ``--coordinator``, unless
one is running). On the world's ``W`` ranks, ``W / 2`` data shards and 2
stages:

- ``PP OK``: PipeCNN (width 8, 32 px, 2 blocks a stage) on the
  ``('data', 'stage')`` mesh, two GPipe steps at 2 microbatches on the
  global batch (process p's part from a generator seeded with p, as in
  ``cnn_tpu``; every process builds every part, since the port's step
  takes the global batch);
- ``PP-1F1B OK``: the same two steps under 1F1B from the same state; the
  loss must equal GPipe's within 1e-5;
- ``PP3 OK``: with 4 ranks or more, ``('data', 'stage', 'model')`` with
  2 stages and 2 model ranks (Megatron's pair in each trunk block), a
  trunk Dropout of 0.25, one step;
- ``EPOCH OK``: the epoch sampler over the data shards of a device
  dataset with unique labels: one epoch sees each of this rank's rows
  exactly once.

The replicated losses are identical on every process.

Run (each process; ``main(argv, device="cpu")`` on the CPU):
    python -m cnn_tpu_torch.tools.multihost_pp_smoke \\
        --coordinator localhost:9876 --num-processes 4 --process-id {0..3}
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from cnn_tpu_torch import default_device, optim
from cnn_tpu_torch.data.device_dataset import DeviceDataset, device_batches
from cnn_tpu_torch.models import PipeCNN
from cnn_tpu_torch.parallel import (create_train_state, make_pp_train_step,
                                    shard_pp_train_state)
from cnn_tpu_torch.parallel.mesh import init_distributed, make_pp_mesh
from cnn_tpu_torch.parallel.train_step import TrainState


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    args = ap.parse_args(argv)

    dev = default_device(device)
    had_group = dist.is_initialized()
    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     dev)
    try:
        return _run(dev)
    finally:
        if not had_group:
            dist.destroy_process_group()


def _run(dev) -> int:
    rank, world = dist.get_rank(), dist.get_world_size()
    stages = 2
    assert world % stages == 0 and world >= stages, (world, stages)
    dp = world // stages
    where = dev if dev.type == "cpu" else None
    mesh = make_pp_mesh(dp, stages, device=where)
    print(f"process {rank}/{world}: pp mesh {mesh.shape} "
          f"({dist.get_backend()})", flush=True)

    def pipecnn(**kw):
        return PipeCNN(num_classes=3, width=8, n_blocks=2 * stages,
                       image_size=32, device=mesh.device,
                       generator=torch.Generator().manual_seed(0), **kw)

    model = pipecnn()
    opt = optim.make_optimizer("momentum", 1e-2, 0.9)

    # the global batch: data shard p's part from a generator seeded with p
    per_shard = 8
    x = torch.from_numpy(np.concatenate([
        np.random.default_rng(p).integers(0, 256, (per_shard, 32, 32, 3),
                                          np.uint8) for p in range(dp)]))
    y = torch.arange(per_shard * dp) % 3

    losses = {}
    for schedule in ("gpipe", "1f1b"):
        ts = shard_pp_train_state(create_train_state(model, opt, seed=0),
                                  mesh, model)
        step = make_pp_train_step(model, opt, mesh, n_microbatches=2,
                                  schedule=schedule)
        for _ in range(2):
            ts, metrics = step(ts, x, y)
        losses[schedule] = float(metrics["loss"])
        assert np.isfinite(losses[schedule]), losses
        assert ts.step == 2
        model = pipecnn()          # a fresh model for the next schedule
    print(f"PP OK loss={losses['gpipe']:.6f}", flush=True)
    assert abs(losses["1f1b"] - losses["gpipe"]) < 1e-5, (
        f"1F1B loss {losses['1f1b']} != GPipe loss {losses['gpipe']} "
        "across processes")
    print(f"PP-1F1B OK loss={losses['1f1b']:.6f} (== gpipe)", flush=True)

    if world >= 4:
        mesh3 = make_pp_mesh(world // 4, stages, 2, device=where)
        tmodel = PipeCNN(num_classes=3, width=8, n_blocks=stages,
                         image_size=32, dropout=0.25, device=mesh3.device,
                         generator=torch.Generator().manual_seed(1))
        tts = shard_pp_train_state(create_train_state(tmodel, opt, seed=1),
                                   mesh3, tmodel)
        tstep = make_pp_train_step(tmodel, opt, mesh3, n_microbatches=2)
        tts, tmetrics = tstep(tts, x[:8 * (world // 4)],
                              y[:8 * (world // 4)])
        tloss = float(tmetrics["loss"])
        assert np.isfinite(tloss), tloss
        print(f"PP3 OK loss={tloss:.6f}", flush=True)

    # the epoch sampler: exactly once over this rank's data shard
    n, bs = 16 * dp, 8
    ids = np.arange(n)      # unique ids as labels
    ds = DeviceDataset.from_arrays(np.zeros((n, 8, 8, 3), np.uint8), ids,
                                   mesh=mesh)
    draw, _ = device_batches(ds, bs, mesh, "epoch")
    local_rows = Counter(ds.labels.tolist())
    seen = Counter()
    ts = TrainState(None, None, 0, None, 7)
    for step_i in range(n // bs):      # one full epoch
        ts.step = step_i
        seen.update(draw(ts)[1].tolist())
    assert seen == local_rows, (
        f"epoch sampling not exactly-once on process {rank}: "
        f"missing={sorted(local_rows - seen)} "
        f"extra={sorted(seen - local_rows)}")
    print(f"EPOCH OK rows={sum(local_rows.values())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
