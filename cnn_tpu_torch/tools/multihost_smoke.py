"""Multi-process smoke, counterpart of ``cnn_tpu/tools/multihost_smoke.py``:
N processes, one ``('data', 'model')`` mesh of their ranks, one train step.

Every process runs this same program. ``parallel/mesh.py:init_distributed``
starts the process group at ``--coordinator`` (gloo between processes on
the CPU or on one shared GPU, NCCL where each has a GPU of its own), the
mesh's ``'data'`` axis spans the processes, the sharded step keeps each
process's rows of the global batch and sums the gradients over the axis.
Each process's part of the batch comes from a generator seeded with its
index, as in ``cnn_tpu``; since the port's sharded step takes the global
batch, every process builds every part. Then the device-resident dataset
runs over the same mesh: each process uploads its shard only and samples
from it.

Run (each process; ``main(argv, device="cpu")`` on the CPU):
    python -m cnn_tpu_torch.tools.multihost_smoke \
        --coordinator localhost:9876 --num-processes 2 --process-id {0,1}

Prints ``MULTIHOST OK loss=<x> device_ds_loss=<y>``, the same on every
process.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from cnn_tpu_torch import default_device, optim
from cnn_tpu_torch.data.device_dataset import (DeviceDataset,
                                               make_device_train_step)
from cnn_tpu_torch.models import AlexNet
from cnn_tpu_torch.parallel import (create_train_state, make_train_step,
                                    shard_train_state)
from cnn_tpu_torch.parallel.mesh import init_distributed, make_mesh


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)

    dev = default_device(device)
    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     dev)
    try:
        return _run(args, dev)
    finally:
        dist.destroy_process_group()


def _run(args, dev) -> int:
    mesh = make_mesh(device=dev if dev.type == "cpu" else None)
    rank, world = dist.get_rank(), dist.get_world_size()
    print(f"process {rank}/{world}: 1 local of {world} global devices "
          f"({dist.get_backend()})", flush=True)

    model = AlexNet(num_classes=3, image_size=64, device=mesh.device,
                    generator=torch.Generator().manual_seed(0))
    opt = optim.sgd(1e-2)
    ts = shard_train_state(create_train_state(model, opt, seed=0), mesh,
                           model)

    # the global batch: process p's part from a generator seeded with p
    per_proc = 2
    parts = [np.random.default_rng(p).integers(0, 256, (per_proc, 64, 64, 3),
                                               np.uint8)
             for p in range(world)]
    x = torch.from_numpy(np.concatenate(parts))
    y = torch.arange(per_proc * world) % 3

    step = make_train_step(model, opt, mesh=mesh)
    loss = None
    for _ in range(args.steps):
        ts, metrics = step(ts, x, y)
        loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    assert ts.step == args.steps

    n = 4 * world
    imgs = np.tile(np.arange(n, dtype=np.uint8)[:, None, None, None],
                   (1, 64, 64, 3))
    ds = DeviceDataset.from_arrays(imgs, np.arange(n) % 3, mesh=mesh)
    dstep = make_device_train_step(model, opt, ds, world * 2, mesh=mesh)
    ts, metrics = dstep(ts)
    dloss = float(metrics["loss"])
    assert np.isfinite(dloss), dloss
    print(f"MULTIHOST OK loss={loss:.6f} device_ds_loss={dloss:.6f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
