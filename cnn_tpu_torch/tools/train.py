"""Training CLI, counterpart of ``cnn_tpu/tools/train.py``, with its flags.

The loop is ``cnn_tpu``'s: train on host-loader batches, or on batches
sampled from a ``DeviceDataset`` held on the card (``--device-dataset``);
every ``--valid-iters`` validate and append to the history; every
``--save-iters`` write ``iter_<n>_train_<a>_valid_<b>.ckpt`` (``cnn_tpu``'s
format, ``utils/checkpoint.py``) and track the best by valid accuracy; at
the end reload the best checkpoint and test it, with its confusion matrix.
SIGTERM or SIGUSR1 asks for a clean stop: the loop writes
``preempt_iter_<n>.ckpt`` and exits 0, and ``--resume auto`` continues
from the newest checkpoint.

The training toolbox is ``cnn_tpu``'s: ``--optimizer adam``,
``--weight-decay`` and ``--grad-clip`` (``optim.make_optimizer``);
``--freeze`` prefixes and ``--ema`` (validation and the test then run on
the EMA weights with the EMA'd BN statistics); ``--init-from`` (a warm
start, ``utils/checkpoint.py:warm_start``); ``--mixup`` / ``--cutmix``
and ``--color-jitter`` (the last inside the device augmentation only);
``--distill-from`` with ``--distill-model``, ``--distill-temp`` and
``--distill-alpha`` (the teachers' EMA weights where they have them);
``--grad-accum``; and ``--steps-per-call`` (that many device-dataset
steps a call), each printing ``cnn_tpu``'s line.

Every family trains (``--name``), MoECNN among them, with
``--moe-balance`` (the Switch balance loss, added to the objective in the
train step) and a ``MoE load [<layer>]: [...]`` line at each validation
(``moe_load`` in the history record); ``--space-to-depth`` runs AlexNet's
conv1 and conv2 as space-to-depth convs and exits with ``cnn_tpu``'s
message for any other family.

The host loader augments on the host (``--augment true`` without
``--device-augment`` or ``--device-dataset``, ``cnn_tpu``'s default:
``data/augment.py``, cv2's warp in numpy). On the GPU each
``--device-dataset`` call is one CUDA graph of its ``--steps-per-call``
steps from the second call on (``data/device_dataset.py:GraphedSteps``).
``--compile-cache DIR`` builds and loads the kernel library under DIR
(``ops/hopper/_build.py:set_build_root``), so that a later run with the
same DIR and sources builds nothing; the run ends with a line that says
which it was. With ``device="cpu"`` nothing is built.

Data, tensor, spatial and expert parallelism are ``cnn_tpu``'s: with more
than one rank (``--multihost``: ``--coordinator HOST:PORT``,
``--num-processes``, ``--process-id``, or torchrun's environment where a
flag is absent; ``parallel/mesh.py:init_distributed``),
``--data-parallel``, ``--model-parallel``, ``--spatial-parallel`` or
``--expert-parallel``, the run takes a ``('data', 'model'[,
'spatial'][, 'expert'])`` mesh of the ranks (one device each; ``mesh:
{...}``), shards the train state over it and steps on the global batch
(``parallel/train_step.py``). With ``--pipeline-stages N`` above 1 it takes
``cnn_tpu``'s ``('data', 'stage')`` mesh instead (``pipeline mesh:
{...}``, ``--data-parallel`` 0 meaning the ranks over N), places the
state for the pipeline (``--virtual-stages`` chunks a stage) and runs the
pipelined train step (``--microbatches``, ``--pipeline-schedule``) on the
host batches or the device dataset, and the pipelined eval
(``parallel/pipeline.py``). Every process
reads the same seeded host batches and keeps its rows; the device dataset
shards over ``'data'`` (the validation set stays whole on each). All
processes must start at the same iteration (a resume that differs
raises), agree at each validation whether to stop, and write their
history to ``history.p{rank}.jsonl`` beside process 0's
``history.jsonl``; only process 0 writes checkpoints, each the full
(``'model'``-gathered) tree a one-rank run writes. With more than one
process the final test runs on the final state (process 0 alone holds
the best checkpoint).

It runs on the GPU; ``main(argv, device="cpu")`` runs the plain versions
on the CPU (tests; gloo between processes). ``--donate`` is accepted and
changes nothing: PyTorch updates the train state in place either way.
``--backend native`` (and ``auto``, the default, on the GPU) resizes each
host-loader batch with one launch of the resize kernel where ``--cache
false`` and the host augmentation is off, as ``cnn_tpu``'s native engine
applies (``data/native.py``); on the CPU ``auto`` is the Python path.

Usage: python -m cnn_tpu_torch.tools.train [--total-iters N] [--batch-norm true] ...
"""

from __future__ import annotations

import glob
import os
import signal
import sys

import numpy as np
import torch
import torch.distributed as dist

from cnn_tpu_torch import default_device, optim
from cnn_tpu_torch.core.config import parse_configs
from cnn_tpu_torch.data import (DataLoader, DeviceDataset, discover_dataset,
                                make_device_train_step, split_dataset)
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.nn import MoEBlock
from cnn_tpu_torch.ops.augment import (augment_batch, augment_batch_fast,
                                       color_jitter)
from cnn_tpu_torch.ops.hopper import _build
from cnn_tpu_torch.parallel import (create_train_state, make_eval_step,
                                    make_pp_eval_step, make_pp_train_step,
                                    make_train_step, shard_pp_train_state,
                                    shard_train_state)
from cnn_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                         make_pp_mesh)
from cnn_tpu_torch.parallel.train_step import ema_weights
from cnn_tpu_torch.utils.checkpoint import (checkpoint_name, load_checkpoint,
                                            save_checkpoint, warm_start)
from cnn_tpu_torch.utils.history import HistoryWriter
from cnn_tpu_torch.utils.metrics import (ClassificationEvaluator,
                                         ConfusionMatrix, MeanLoss)
from cnn_tpu_torch.utils.profiling import StepTimer, trace


def pipeline_mesh(train_cfg, world: int, device):
    """``--pipeline-stages``: ``cnn_tpu``'s divisibility checks, then the
    ``('data', 'stage')`` mesh of the ranks."""
    stages = train_cfg.pipeline_stages
    dp = train_cfg.data_parallel or max(1, world // stages)
    # the real constraint is per data shard per accumulation chunk: each
    # chunk's sub-batch must split into the microbatches
    assert train_cfg.train_batch_size % (dp * train_cfg.grad_accum) == 0, \
        f"--train-batch-size {train_cfg.train_batch_size} must divide " \
        f"over {dp} data shards x {train_cfg.grad_accum} accum chunks"
    per_chunk = train_cfg.train_batch_size // dp // train_cfg.grad_accum
    assert per_chunk % train_cfg.microbatches == 0, \
        f"per-shard per-chunk batch {per_chunk} must divide into " \
        f"{train_cfg.microbatches} microbatches"
    return make_pp_mesh(dp, stages, device=device)


def model_kwargs(model_cfg) -> dict:
    """The family options ``cnn_tpu``'s train CLI passes to ``get_model``:
    ``--space-to-depth`` and ``--moe-balance`` where set, ``--width`` (an
    int where it is whole) and ``--n-blocks`` where set."""
    kwargs = {}
    if model_cfg.space_to_depth:
        kwargs["space_to_depth"] = True
    if model_cfg.moe_balance > 0.0:
        kwargs["balance_coeff"] = model_cfg.moe_balance
    if model_cfg.width > 0:
        w = model_cfg.width
        kwargs["width"] = int(w) if float(w).is_integer() else w
    if model_cfg.n_blocks > 0:
        kwargs["n_blocks"] = model_cfg.n_blocks
    return kwargs


def load_teachers(model_cfg, train_cfg, device):
    """``--distill-from`` (checkpoints, comma-separated) with
    ``--distill-model`` (one family spec for all, or one each, as
    ``name[@k=v...]``; default the student's): the teacher models, each
    with its checkpoint's EMA weights where it has them and BN layers
    where its params have them; returns ``make_train_step``'s ``distill``
    and prints ``cnn_tpu``'s line."""
    from cnn_tpu_torch.tools.evaluate import _member_kwargs, load_model
    t_ckpts = [c for c in train_cfg.distill_from.split(",") if c]
    t_specs = ([n for n in train_cfg.distill_model.split(",") if n]
               or [model_cfg.name])
    if len(t_specs) == 1:
        t_specs = t_specs * len(t_ckpts)
    assert len(t_specs) == len(t_ckpts), \
        "--distill-model must list one family (shared) or one per ckpt"
    teachers = []
    for spec, ck in zip(t_specs, t_ckpts):
        name, *kvs = spec.split("@")
        teachers.append(load_model(ck, name, device, announce=False,
                                   num_classes=model_cfg.num_classes,
                                   image_size=model_cfg.image_size,
                                   **_member_kwargs(kvs)))
    print(f"distilling from {len(teachers)} teacher(s) "
          f"{list(zip(t_specs, t_ckpts))} "
          f"(T={train_cfg.distill_temp}, alpha={train_cfg.distill_alpha})")
    return teachers, train_cfg.distill_temp, train_cfg.distill_alpha


def moe_load(model) -> dict:
    """``{layer: [fraction routed to each expert]}`` of the model's MoE
    layers (the state the last train step wrote), rounded to 4 places."""
    return {layer.name: layer.load.cpu().numpy().round(4).tolist()
            for layer in model.net if isinstance(layer, MoEBlock)}


def _to(device, images: np.ndarray, labels: np.ndarray):
    images = torch.from_numpy(images)
    labels = torch.from_numpy(labels.astype(np.int64))
    if device is None:
        return images, labels
    return images.to(device), labels.to(device)


def agree(mesh, value: int) -> list:
    """Every rank's ``value``, in rank order (a zero-filled
    ``all_reduce`` over the ranks)."""
    n = dist.get_world_size()
    mine = torch.zeros(n, dtype=torch.int64, device=mesh.device)
    mine[mesh.rank] = value
    dist.all_reduce(mine)
    return mine.tolist()


def evaluate(eval_step, loader, device,
             confusion: ConfusionMatrix | None = None) -> tuple[float, float]:
    """Mean loss and accuracy over one epoch of the host ``loader``
    (``device`` None: the batches go to the step on the host, as a
    sharded step takes them)."""
    ev = ClassificationEvaluator()
    ml = MeanLoss()
    for images, labels in loader:
        m = eval_step(*_to(device, images, labels))
        ev.add_counts(int(m["correct"]), len(labels))
        ml.add(float(m["loss"]))
        if confusion is not None:
            confusion.compute(m["pred"].cpu().numpy(), labels)
    return ml.get(), ev.get()


def evaluate_device(eval_step, device_ds, batch_size: int) -> tuple[float, float]:
    """Eval over a ``DeviceDataset`` (data already on the device)."""
    ev = ClassificationEvaluator()
    ml = MeanLoss()
    for images, labels in device_ds.epoch_batches(batch_size):
        m = eval_step(images, labels)
        ev.add_counts(int(m["correct"]), int(labels.shape[0]))
        ml.add(float(m["loss"]))
    return ml.get(), ev.get()


def main(argv=None, *, device=None):
    """Runs the CLI on ``device`` (default: the GPU); returns the exit code.

    SIGTERM and SIGUSR1 become a request for a clean stop (a checkpoint,
    then exit 0) while it runs; the previous handlers are restored on
    exit, so an in-process caller keeps its own."""
    preempted = []
    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        try:
            prev_handlers[sig] = signal.signal(
                sig, lambda *_: preempted.append(True))
        except (ValueError, OSError):  # not the main thread
            pass
    had_group = dist.is_initialized()
    try:
        return _main(argv, preempted, device)
    finally:
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()    # the one --multihost started
        for sig, handler in prev_handlers.items():
            if handler is None:
                # installed from C, not Python: nothing to restore, and
                # signal.signal(sig, None) raises
                continue
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):
                pass


def use_compile_cache(cache_dir: str) -> None:
    """``--compile-cache DIR``: made if missing, then the kernel library's
    build root (``cnn_tpu``'s flag points XLA's persistent cache there)."""
    if cache_dir:
        _build.set_build_root(cache_dir)


def _main(argv, preempted, device):
    model_cfg, data_cfg, train_cfg, _ = parse_configs(argv,
                                                      "cnn_tpu_torch train")
    dev = default_device(device)
    rank, world = 0, 1
    if train_cfg.multihost:
        init_distributed(train_cfg.coordinator, train_cfg.num_processes,
                         train_cfg.process_id, dev)
        rank, world = dist.get_rank(), dist.get_world_size()
        print(f"multihost: process {rank}/{world}")
    is_main = rank == 0
    mesh = None
    pipelined = train_cfg.pipeline_stages > 1
    if pipelined:
        mesh = pipeline_mesh(train_cfg, world,
                             dev if dev.type == "cpu" else None)
        dev = mesh.device
    elif (world > 1 or train_cfg.data_parallel > 1
            or train_cfg.model_parallel > 1
            or train_cfg.spatial_parallel > 1
            or train_cfg.expert_parallel > 1):
        mesh = make_mesh(train_cfg.data_parallel, train_cfg.model_parallel,
                         train_cfg.spatial_parallel,
                         train_cfg.expert_parallel,
                         device=dev if dev.type == "cpu" else None)
        dev = mesh.device
    # rank 0 builds the kernel library; the others load it once it is there
    use_compile_cache(train_cfg.compile_cache)
    if world > 1 and dev.type == "cuda":
        if is_main:
            _build.load()
        dist.barrier()

    samples = discover_dataset(data_cfg.dataset_path, data_cfg.categories)
    splits = split_dataset(samples, data_cfg.train_ratio, data_cfg.test_ratio,
                           data_cfg.split_seed)
    print(f"train  :  {len(splits['train'])}\n"
          f"test   :  {len(splits['test'])}\n"
          f"valid  :  {len(splits['valid'])}")

    device_augment = data_cfg.device_augment and data_cfg.augment
    train_loader = valid_loader = None
    if not data_cfg.device_dataset:
        train_loader = DataLoader(splits["train"], train_cfg.train_batch_size,
                                  augment=data_cfg.augment and not device_augment,
                                  shuffle=True,
                                  image_size=(data_cfg.canvas_size if device_augment
                                              else data_cfg.image_size),
                                  seed=data_cfg.loader_seed,
                                  num_workers=data_cfg.num_workers,
                                  prefetch=data_cfg.prefetch,
                                  backend=data_cfg.backend, cache=data_cfg.cache,
                                  device=dev)
        valid_loader = DataLoader(splits["valid"], train_cfg.valid_batch_size,
                                  augment=False, shuffle=False,
                                  image_size=data_cfg.image_size,
                                  backend=data_cfg.backend, cache=data_cfg.cache,
                                  device=dev)

    if model_cfg.space_to_depth and model_cfg.name != "alexnet":
        sys.exit(f"--space-to-depth applies to the AlexNet family only "
                 f"(its small-Cin stride-2 conv1); --name {model_cfg.name} "
                 f"does not accept it")
    model = get_model(model_cfg.name, num_classes=model_cfg.num_classes,
                      batch_norm=model_cfg.batch_norm,
                      dropout=model_cfg.dropout,
                      image_size=model_cfg.image_size, device=dev,
                      generator=torch.Generator().manual_seed(train_cfg.seed),
                      **model_kwargs(model_cfg))
    opt = optim.make_optimizer(train_cfg.optimizer, train_cfg.learning_rate,
                               train_cfg.momentum,
                               schedule=train_cfg.lr_schedule,
                               total_steps=train_cfg.total_iters,
                               warmup_steps=train_cfg.warmup_steps,
                               weight_decay=train_cfg.weight_decay,
                               grad_clip=train_cfg.grad_clip)
    if train_cfg.freeze:
        # head-only fine-tuning with --init-from; init asserts a match
        opt = optim.with_frozen(opt, train_cfg.freeze.split(","))
        print(f"frozen param prefixes: {train_cfg.freeze}")
    if train_cfg.ema > 0.0:
        opt = optim.with_ema(opt, train_cfg.ema)
        print(f"weight EMA: decay {train_cfg.ema} "
              "(validation/test use the averaged weights)")
    if pipelined:
        print(f"pipeline mesh: {mesh.shape} "
              f"(microbatches {train_cfg.microbatches}, "
              f"schedule {train_cfg.pipeline_schedule})")
    elif mesh is not None:
        print(f"mesh: {mesh.shape}")
    compute_dtype = (torch.bfloat16 if model_cfg.compute_dtype == "bfloat16"
                     else None)
    ts = create_train_state(model, opt, seed=train_cfg.seed)
    if train_cfg.init_from:
        ts, copied, skipped = warm_start(ts, train_cfg.init_from, opt)
        print(f"warm start from {train_cfg.init_from}: "
              f"{len(copied)} tensors copied"
              + (f", kept fresh: {', '.join(skipped)}" if skipped else ""))

    resume = train_cfg.resume
    if resume == "auto":
        # resume from the newest checkpoint in checkpoint_dir, if any
        cks = sorted(glob.glob(os.path.join(train_cfg.checkpoint_dir, "*.ckpt")),
                     key=os.path.getmtime)
        resume = cks[-1] if cks else ""
    start_iters = train_cfg.start_iters
    if resume and os.path.exists(resume):
        ts = load_checkpoint(resume, ts)
        start_iters = max(start_iters, ts.step + 1)
        print(f"resumed from {resume} at step {ts.step}")
    if pipelined:
        # the full state, loaded or fresh, cut to this rank's stage rows
        ts = shard_pp_train_state(ts, mesh, model,
                                  train_cfg.virtual_stages)
    elif mesh is not None:
        # the full state, loaded or fresh, cut to this rank's shards
        ts = shard_train_state(ts, mesh, model)
    if world > 1:
        # every process must enter the loop at the same iteration: a resume
        # that differs would desynchronize the collectives and hang
        starts = agree(mesh, start_iters)
        if len(set(starts)) > 1:
            raise RuntimeError(
                f"resume state diverges across processes (start iters "
                f"{starts}); use a shared checkpoint dir or an explicit "
                "--resume path present on every host")

    augment_fn = None
    jitter = data_cfg.color_jitter
    if jitter > 0.0 and not (
            (device_augment or data_cfg.device_dataset) and data_cfg.augment):
        sys.exit("--color-jitter is applied by the device-side augmentation "
                 "pipeline; it needs --augment true plus --device-augment "
                 "or --device-dataset (on the host-loader path it would "
                 "silently do nothing)")
    if (device_augment or data_cfg.device_dataset) and data_cfg.augment:
        aug = augment_batch_fast if data_cfg.augment_mode == "fast" else augment_batch
        aug_dtype = compute_dtype or torch.float32

        def augment_fn(generator, images):
            # augment in the compute dtype, as cnn_tpu does
            x = aug(generator, images, out_size=data_cfg.image_size,
                    dtype=aug_dtype)
            return color_jitter(generator, x, jitter) if jitter > 0.0 else x
        print(f"augmentation: on-device '{data_cfg.augment_mode}' "
              + (f"+ color jitter {jitter} " if jitter > 0.0 else "")
              + "(in the train step)")

    distill = None
    if train_cfg.distill_from:
        distill = load_teachers(model_cfg, train_cfg, dev)

    device_train_ds = device_valid_ds = None
    if data_cfg.device_dataset:
        canvas = data_cfg.canvas_size if data_cfg.augment else data_cfg.image_size
        print(f"uploading dataset to device (canvas {canvas}px)...")
        # the train set shards over the mesh's 'data' axis; the validation
        # set stays whole on every rank
        device_train_ds = DeviceDataset(splits["train"], canvas,
                                        data_cfg.num_workers, mesh=mesh,
                                        device=dev)
        device_valid_ds = DeviceDataset(splits["valid"], data_cfg.image_size,
                                        data_cfg.num_workers, device=dev)
    toolbox = dict(compute_dtype=compute_dtype,
                   label_smoothing=train_cfg.label_smoothing,
                   grad_accum=train_cfg.grad_accum, mixup=train_cfg.mixup,
                   cutmix=train_cfg.cutmix, distill=distill)
    if pipelined:
        # the pipelined step, on host batches or the device dataset; the
        # eval at one microbatch (pipelining gains nothing there), padding
        # ragged batches itself
        step_fn = make_pp_train_step(
            model, opt, mesh, n_microbatches=train_cfg.microbatches,
            dataset=device_train_ds, batch_size=train_cfg.train_batch_size,
            augment_fn=augment_fn, sample_mode=data_cfg.sample_mode,
            steps_per_call=train_cfg.steps_per_call,
            schedule=train_cfg.pipeline_schedule,
            virtual_stages=train_cfg.virtual_stages, **toolbox)
        eval_fn = make_pp_eval_step(model, mesh, n_microbatches=1,
                                    compute_dtype=compute_dtype,
                                    tta=train_cfg.tta)
    elif data_cfg.device_dataset:
        step_fn = make_device_train_step(
            model, opt, device_train_ds, train_cfg.train_batch_size,
            augment_fn=augment_fn, mesh=mesh,
            sample_mode=data_cfg.sample_mode,
            steps_per_call=train_cfg.steps_per_call, **toolbox)
    else:
        step_fn = make_train_step(model, opt, mesh=mesh,
                                  augment_fn=augment_fn, **toolbox)
    if not pipelined:
        eval_fn = make_eval_step(model, compute_dtype=compute_dtype,
                                 mesh=mesh, tta=train_cfg.tta)
    # a sharded step takes the global batch on the host and keeps its rows
    host_dev = None if mesh is not None else dev

    os.makedirs(train_cfg.checkpoint_dir, exist_ok=True)
    history = HistoryWriter(
        train_cfg.history_path
        or os.path.join(train_cfg.checkpoint_dir,
                        "history.jsonl" if is_main
                        else f"history.p{rank}.jsonl"))
    train_eval = ClassificationEvaluator()
    mean_loss = MeanLoss()
    best_acc, best_path = -1.0, None
    timer = StepTimer()

    device_mode = device_train_ds is not None
    bs = train_cfg.train_batch_size
    chunk = train_cfg.steps_per_call if device_mode else 1
    # saves happen at validation boundaries (the checkpoint name embeds the
    # valid accuracy, cnn.cpp:121-124), so an unaligned cadence would
    # silently save every lcm(valid, save) iters — or never
    assert train_cfg.save_iters % train_cfg.valid_iters == 0, \
        f"--save-iters {train_cfg.save_iters} must be a multiple of " \
        f"--valid-iters {train_cfg.valid_iters}"
    if chunk > 1:
        # a call advances `chunk` iterations: the validate/save cadence,
        # the total and a resume point must land on its boundaries
        assert train_cfg.valid_iters % chunk == 0, \
            (train_cfg.valid_iters, chunk)
        assert train_cfg.total_iters % chunk == 0, \
            f"--total-iters {train_cfg.total_iters} must be a multiple of " \
            f"--steps-per-call {chunk}"
        assert (start_iters - 1) % chunk == 0, \
            f"resume step {start_iters - 1} must align with --steps-per-call"
    with trace(train_cfg.profile_dir or None, dev):
        for it in range(start_iters + chunk - 1, train_cfg.total_iters + 1,
                        chunk):
            if device_mode:
                # on-device step(s): no host data; the metrics are fetched
                # (a synchronisation) only at the logging cadence, once per
                # crossed multiple of 100
                ts, metrics = step_fn(ts)
                timer.tick(bs * chunk)
                if (it % 100 < chunk or it == train_cfg.total_iters
                        or it % train_cfg.valid_iters == 0):
                    mean_loss.add(float(metrics["loss"]))
                    train_eval.add_counts(int(metrics["correct"]),
                                          bs * chunk)
            else:
                images, labels = train_loader.generate_batch()
                ts, metrics = step_fn(ts, *_to(host_dev, images, labels))
                mean_loss.add(float(metrics["loss"]))
                train_eval.add_counts(int(metrics["correct"]), len(labels))
                timer.tick(len(labels))

            if it % 100 < chunk or it == train_cfg.total_iters:
                print(f"\rTrain===> [batch {it}/{train_cfg.total_iters}] "
                      f"[loss {mean_loss.get():.3f}] [Accuracy {train_eval.get():.3f}] "
                      f"[{timer.images_per_sec:.1f} img/s]", end="", flush=True)

            stop_now = bool(preempted) and world == 1
            if world > 1 and it % train_cfg.valid_iters == 0:
                # a sync point: the processes agree to stop together
                stop_now = any(agree(mesh, int(bool(preempted))))
            if stop_now:
                path = os.path.join(train_cfg.checkpoint_dir,
                                    f"preempt_iter_{it}.ckpt")
                save_checkpoint(path, ts)
                print(f"\npreemption signal: checkpointed step {it} to "
                      f"{path}; relaunch with --resume auto to continue")
                best_acc = -1.0   # exit fast: no final test under a deadline
                break

            if it % train_cfg.valid_iters == 0:
                print("\nvalidating...")
                # the EMA weights with the EMA'd BN statistics, if any
                with ema_weights(ts):
                    if device_mode:
                        v_loss, v_acc = evaluate_device(
                            eval_fn, device_valid_ds,
                            train_cfg.valid_batch_size)
                    else:
                        v_loss, v_acc = evaluate(eval_fn, valid_loader,
                                                 host_dev)
                print(f"Valid===> [loss {v_loss:.3f}] [Accuracy {v_acc:.3f}]")
                # the MoE layers' expert loads from the last train step
                moe_loads = moe_load(model)
                for n, ld in moe_loads.items():
                    print(f"MoE load [{n}]: {ld}")
                history.log(step=it, loss=mean_loss.get(),
                            accuracy=train_eval.get(), valid_loss=v_loss,
                            valid_accuracy=v_acc,
                            images_per_sec=timer.images_per_sec,
                            **({"moe_load": moe_loads} if moe_loads else {}))
                if it % train_cfg.save_iters == 0:
                    name = checkpoint_name(it, train_eval.get(), v_acc)
                    path = os.path.join(train_cfg.checkpoint_dir, name)
                    save_checkpoint(path, ts)
                    if is_main:
                        print(f"weights have been saved to {path}")
                    if v_acc > best_acc:
                        best_acc, best_path = v_acc, path
                mean_loss.clear()
                train_eval.clear()
                timer.reset()

    if train_loader is not None:
        train_loader.close()
    history.close()
    print("\ntraining done!")

    # the decision to test keys on best_acc, the same on every process
    # (the sharded eval's collectives need all of them)
    if best_acc >= 0.0:
        if world == 1:
            print(f"best checkpoint: {best_path} (valid acc {best_acc:.3f})")
            ts = load_checkpoint(best_path, ts)
        else:
            print(f"best checkpoint (on process 0): {best_path} "
                  f"(valid acc {best_acc:.3f}); testing the FINAL state")
        test_loader = DataLoader(splits["test"], train_cfg.valid_batch_size,
                                 augment=False, shuffle=False,
                                 image_size=data_cfg.image_size,
                                 num_workers=data_cfg.num_workers,
                                 backend=data_cfg.backend,
                                 cache=data_cfg.cache, device=dev)
        confusion = ConfusionMatrix(model_cfg.num_classes)
        with ema_weights(ts):
            t_loss, t_acc = evaluate(eval_fn, test_loader, host_dev,
                                     confusion)
        print(f"Test===> [loss {t_loss:.3f}] [Accuracy {t_acc:.3f}]")
        print("confusion matrix (rows = truth):")
        print(confusion.pretty(list(data_cfg.categories)))
    if train_cfg.compile_cache and dev.type == "cuda":
        print(_build.describe())
    return 0


if __name__ == "__main__":
    sys.exit(main())
