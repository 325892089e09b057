"""One rank of ``tests/test_torch_parallel.py``'s gloo runs on the CPU.

    python tests/fixtures/torch_rank_worker.py WORKDIR PORT WORLD RANK

Reads ``WORKDIR/plan.json`` (the cases) and ``WORKDIR/inputs.npz`` (the
weights and batches, made with numpy by the test), runs each case on a
mesh of the WORLD ranks, and writes ``WORKDIR/out<RANK>.npz``: each
array under ``<case>/<what>``, the sharded tensors gathered to their full
shape. A case's failure is written as its ``<case>/error`` text and the
other cases still run, so that one test's fault fails that test alone.
Imports the port only (no JAX).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from cnn_tpu_torch import optim  # noqa: E402
from cnn_tpu_torch.data.device_dataset import (  # noqa: E402
    DeviceDataset, make_device_train_step)
from cnn_tpu_torch.models import get_model  # noqa: E402
from cnn_tpu_torch.nn.module import leaf_path  # noqa: E402
from cnn_tpu_torch.ops.augment import augment_batch  # noqa: E402
from cnn_tpu_torch.parallel import train_step as tstep  # noqa: E402
from cnn_tpu_torch.parallel.mesh import (init_distributed,  # noqa: E402
                                         make_mesh)
from cnn_tpu_torch.tools import train  # noqa: E402
from cnn_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402


def nest(flat: dict, prefix: str) -> dict:
    """``inputs['<prefix>/<leaf name>']`` as a nested tree."""
    tree: dict = {}
    for key, v in flat.items():
        if key.startswith(prefix + "/"):
            path = leaf_path(key[len(prefix) + 1:])
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
    return tree


def build(case, inputs):
    """The case's model with the test's weights, its optimizer and a
    fresh train state."""
    from cnn_tpu_torch.utils.checkpoint import load_jax_params
    model = get_model(case["model"], device="cpu", **case["kwargs"])
    w = case["weights"]
    load_jax_params(model, nest(inputs, f"{w}/p"), nest(inputs, f"{w}/s"))
    opt = optim.make_optimizer("momentum", case.get("lr", 0.05), 0.9,
                               grad_clip=case.get("clip", 0.0))
    return model, opt, tstep.create_train_state(model, opt, seed=0)


def trained(ts) -> dict:
    """The params, the model state and the optimizer's trees, full."""
    out = {}
    with tstep.unsharded(ts):
        for k, v in tstep.named_params(ts.model).items():
            out[f"param/{k}"] = v.detach().numpy().copy()
        for k, v in tstep.named_state(ts.model).items():
            out[f"state/{k}"] = v.numpy().copy()
        for i, tree in enumerate(tstep._opt_trees(ts.opt_state)):
            for k, v in tree.items():
                out[f"opt{i}/{k}"] = v.numpy().copy()
    return out


def case_mesh(case, inputs, world):
    out = {"shape": np.array(list(make_mesh(device="cpu").shape.values()))}
    out["shape_2x2"] = np.array(list(make_mesh(2, 2, device="cpu")
                                     .shape.values()))
    try:
        make_mesh(world, 2, device="cpu")
        out["too_big"] = np.array("no error")
    except AssertionError as e:
        out["too_big"] = np.array(f"AssertionError: {e}")
    return out


def case_step(case, inputs, world):
    """One sharded step's gradients (before it), then the step: its
    params, state and optimizer trees, and its loss."""
    mesh = make_mesh(case["data"], case["model_parallel"], device="cpu")
    model, opt, ts = build(case, inputs)
    tstep.shard_train_state(ts, mesh, model)
    x = torch.from_numpy(inputs[case["x"]])
    y = torch.from_numpy(inputs[case["y"]])
    k = case.get("grad_accum", 1)
    kept = {n: v.clone() for n, v in tstep.named_state(model).items()}
    xl, yl = tstep.local_rows(mesh, x, y)
    grads, loss, _ = tstep.accumulate_grads(ts, xl, yl, grad_accum=k,
                                            mesh=mesh)
    # a gradient of a param held as a slice over 'model', joined
    out = {f"grad/{n}": (g if n not in ts.shards else tstep._full(
        g, ts.shards[n], mesh)).numpy() for n, g in grads.items()}
    with torch.no_grad():
        for n, v in tstep.named_state(model).items():
            v.copy_(kept[n])
    ts, m = tstep.make_train_step(model, opt, mesh=mesh, grad_accum=k)(
        ts, x, y)
    out.update(trained(ts))
    out["loss"] = m["loss"].numpy()
    out["grad_loss"] = loss.numpy()
    out["shards"] = np.array(sorted(ts.shards))
    return out


def case_mix(case, inputs, world):
    """One sharded step with MixUp and CutMix (partners across shards)."""
    mesh = make_mesh(case["data"], case["model_parallel"], device="cpu")
    model, opt, ts = build(case, inputs)
    tstep.shard_train_state(ts, mesh, model)
    ts, m = tstep.make_train_step(model, opt, mesh=mesh, mixup=0.2,
                                  cutmix=1.0, grad_accum=2)(
        ts, torch.from_numpy(inputs[case["x"]]),
        torch.from_numpy(inputs[case["y"]]))
    out = trained(ts)
    out["loss"] = m["loss"].numpy()
    return out


def case_eval(case, inputs, world):
    mesh = make_mesh(case["data"], case["model_parallel"], device="cpu")
    model, _, ts = build(case, inputs)
    tstep.shard_train_state(ts, mesh, model)
    ev = tstep.make_eval_step(model, mesh=mesh)
    m = ev(torch.from_numpy(inputs[case["x"]]),
           torch.from_numpy(inputs[case["y"]]))
    return {k: v.numpy() for k, v in m.items()}


def case_device_global(case, inputs, world):
    """One 'global'-sampling device-dataset step on the mesh."""
    mesh = make_mesh(case["data"], case["model_parallel"], device="cpu")
    model, opt, ts = build(case, inputs)
    tstep.shard_train_state(ts, mesh, model)
    ds = DeviceDataset.from_arrays(inputs[case["images"]],
                                   inputs[case["labels"]], mesh=mesh)
    size = case["augment"]
    step = make_device_train_step(
        model, opt, ds, case["batch"], mesh=mesh, sample_mode="global",
        augment_fn=lambda g, im: augment_batch(g, im, out_size=size))
    ts, m = step(ts)
    out = trained(ts)
    out["loss"] = m["loss"].numpy()
    return out


def case_ckpt(case, inputs, world):
    """The TP state after one step, written as a .ckpt by process 0."""
    mesh = make_mesh(case["data"], case["model_parallel"], device="cpu")
    model, opt, ts = build(case, inputs)
    tstep.shard_train_state(ts, mesh, model)
    ts, _ = tstep.make_train_step(model, opt, mesh=mesh)(
        ts, torch.from_numpy(inputs[case["x"]]),
        torch.from_numpy(inputs[case["y"]]))
    save_checkpoint(case["path"], ts)
    return {"shards": np.array(sorted(ts.shards))}


def case_cli(case, inputs, world):
    """The train CLI with ``--multihost`` in this process; its output."""
    argv = [a.replace("{rank}", str(dist.get_rank())) for a in case["argv"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(argv, device="cpu")
    return {"rc": np.array(rc), "stdout": np.array(buf.getvalue())}


CASES = {"mesh": case_mesh, "step": case_step, "eval": case_eval,
         "mix": case_mix,
         "device_global": case_device_global, "ckpt": case_ckpt,
         "cli": case_cli}


def main() -> int:
    work, port, world, rank = sys.argv[1:5]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    torch.manual_seed(0)
    init_distributed(f"localhost:{port}", world, rank, "cpu")
    with open(os.path.join(work, "plan.json")) as f:
        plan = json.load(f)
    inputs = dict(np.load(os.path.join(work, "inputs.npz")))
    out = {}
    for case in plan:
        try:
            got = CASES[case["kind"]](case, inputs, world)
        except Exception:
            got = {"error": np.array(traceback.format_exc())}
        out.update({f"{case['name']}/{k}": v for k, v in got.items()})
        dist.barrier()
    np.savez(os.path.join(work, f"out{rank}.npz"), **out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
