"""Config layer, a copy of ``cnn_tpu/core/config.py``.

Every field, default and flag spelling is ``cnn_tpu``'s, so one argv parses
to equal configs in either package (the train CLIs share their flags).
Options the port does not run yet are refused where they are used
(``tools/train.py:check_flags``), not here.

The reference has no config system at all — every hyperparameter is a
hard-coded ``const`` local (``cpu/src/cnn.cpp:36-43,67-71``; checkpoint paths
at ``cnn.cpp:60``, ``inference.cpp:35``, ``grad_cam.cpp:34``). Here they are
lifted into dataclasses that double as CLI flag definitions.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class ModelConfig:
    """Architecture config (reference: ``AlexNet`` ctor, ``alexnet.cpp:10-33``)."""

    name: str = "alexnet"
    num_classes: int = 3
    batch_norm: bool = False   # reference trains with BN off by default
    dropout: float = 0.0       # reference's Dropout is commented out (alexnet.cpp:28)
    image_size: int = 224
    channels: int = 3
    # cnn_tpu's space-to-depth flag of the stride-2 convs with Cin < 32
    # (AlexNet family); here they stay stride-2 convs (nn/module.py:Conv2D)
    space_to_depth: bool = False
    moe_balance: float = 0.0   # Switch aux balance-loss coefficient for the
                               # moecnn family (0 = off; load stats are
                               # logged either way — nn/moe.py)
    width: float = 0.0         # family width override (pipecnn/moecnn trunk
                               # channels, mobilenet multiplier; 0 = default)
    n_blocks: int = 0          # pipecnn trunk depth override (0 = default)
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # flip to bfloat16 for MXU-friendly training


@dataclass(frozen=True)
class DataConfig:
    """Dataset/pipeline config (reference: ``cnn.cpp:41-50``, ``pipeline.h``)."""

    dataset_path: str = "/root/reference/datasets/animals"
    categories: Sequence[str] = ("dog", "panda", "bird")
    train_ratio: float = 0.8
    test_ratio: float = 0.1
    split_seed: int = 212       # reference: pipeline.cpp:96
    loader_seed: int = 212      # reference: pipeline.h:53
    augment: bool = True
    device_augment: bool = False    # run augmentation on-device (ops/augment.py);
                                    # the host then ships fixed canvases
    canvas_size: int = 256          # host canvas size for device augmentation
    image_size: int = 224
    # 'bgr' matches the reference (cv::imread order, never swapped,
    # data_format.cpp:13-23); 'rgb' is the sane default for new models.
    channel_order: str = "bgr"
    prefetch: int = 4           # host->device prefetch depth (reference: none)
    num_workers: int = 2        # decode/augment worker threads (reference: single-thread)
    backend: str = "auto"       # 'auto' | 'native' (C++ loader) | 'python'
    cache: bool = True          # decode-once RAM cache (dataset is ~2 GB decoded)
    device_dataset: bool = False  # pin the whole dataset in HBM; sample batches
                                  # on-device (zero steady-state host traffic)
    augment_mode: str = "fast"  # 'fast' (flips+crop, gather-free) | 'full' (+rotate)
    color_jitter: float = 0.0   # device-augment superset: per-sample
                                # brightness/contrast/saturation jitter
                                # strength (0 = off; geometric-only matches
                                # the reference policy)
    sample_mode: str = "local"  # device-dataset batch sampling: 'local'/'global'
                                # uniform-with-replacement; 'epoch' = every
                                # sample exactly once per epoch (the reference's
                                # protocol, pipeline.cpp:145-151); 'epoch_fixed'
                                # adds its same-permutation-every-epoch quirk


@dataclass(frozen=True)
class TrainConfig:
    """Training loop config (reference constants at ``cnn.cpp:36-43,67-71``)."""

    train_batch_size: int = 4       # reference: cnn.cpp:36
    valid_batch_size: int = 64      # reference forced 1 (cnn.cpp:37-40); we batch
    learning_rate: float = 1e-3     # reference: cnn.cpp:69
    total_iters: int = 400_000      # reference: cnn.cpp:68
    start_iters: int = 1
    valid_iters: int = 1000         # validate every N iters (cnn.cpp:70)
    save_iters: int = 5000          # checkpoint every N iters (cnn.cpp:71)
    checkpoint_dir: str = "checkpoints/alexnet"
    resume: str = ""                # path to a native .ckpt to resume from
    init_from: str = ""             # warm-start: copy shape-matching weights
                                    # from this .ckpt into the fresh model
                                    # (mismatched head keeps its init; opt
                                    # state/step reset — transfer learning)
    history_path: str = ""          # JSONL training-history log (default: <ckpt_dir>/history.jsonl)
    profile_dir: str = ""           # write a jax.profiler trace here (empty = off)
    compile_cache: str = ""         # persistent XLA compilation cache dir:
                                    # re-launching an identical program skips
                                    # the multi-minute compile (empty = off)
    optimizer: str = "sgd"          # 'sgd' matches reference; 'momentum'/'adam' are supersets
    momentum: float = 0.0
    lr_schedule: str = "constant"   # constant | cosine | step (reference: constant)
    warmup_steps: int = 0
    weight_decay: float = 0.0       # superset (reference: none)
    grad_clip: float = 0.0          # clip global grad norm (0 = off)
    label_smoothing: float = 0.0    # superset (reference: hard one-hots)
    mixup: float = 0.0              # MixUp Beta alpha (0 = off); blends
                                    # batch pairs + mixes the loss
    cutmix: float = 0.0             # CutMix Beta alpha (0 = off); both set
                                    # = pick one per step uniformly
    freeze: str = ""                # comma-separated param-path prefixes to
                                    # freeze (e.g. 'stem,block' = train the
                                    # head only; compose with --init-from)
    distill_from: str = ""          # teacher .ckpt for knowledge distillation
                                    # (loss: alpha*CE + (1-alpha)*T^2*KL)
    distill_model: str = ""         # teacher family (default: same as --name)
    distill_temp: float = 2.0       # distillation softmax temperature
    distill_alpha: float = 0.5      # weight of the hard-label CE term
    tta: str = ""                   # test-time augmentation for valid/test:
                                    # '' | 'hflip' | 'flips' (prob averaging)
    ema: float = 0.0                # weight EMA decay (0 = off); validation,
                                    # best-tracking and the final test then
                                    # use the averaged weights (optim.with_ema)
    seed: int = 212
    # parallelism: number of data-parallel shards ('auto' = all local devices)
    data_parallel: int = 0          # 0 = auto
    model_parallel: int = 1
    spatial_parallel: int = 1       # shard activation rows (SP for CNNs);
                                    # XLA inserts conv halo exchanges
    expert_parallel: int = 1        # shard MoE experts over an 'expert' axis
    pipeline_stages: int = 1        # pipeline stages over a 'stage' axis
                                    # (models with a StackedBlocks trunk)
    microbatches: int = 4           # pipeline microbatches per step
    pipeline_schedule: str = "gpipe"  # 'gpipe' (all-forward-then-backward)
                                      # | '1f1b' (memory-bounded: live
                                      # activations O(stages), not O(M))
    virtual_stages: int = 1         # interleaved 1F1B (Megatron-style): V
                                    # non-contiguous trunk chunks per stage,
                                    # bubble 2(S-1)/V; needs M % stages == 0
    multihost: bool = False         # jax.distributed.initialize() for multi-host
                                    # slices (same SPMD code; DCN joins the mesh)
    coordinator: str = ""           # host:port of process 0 ('' = from env)
    num_processes: int = 0          # 0 = from env / TPU metadata
    process_id: int = -1            # -1 = from env / TPU metadata
    donate: bool = True
    steps_per_call: int = 1         # device-dataset mode: train steps chained
                                    # inside ONE compiled program (lax.scan);
                                    # cuts per-step dispatch overhead ~7%
    grad_accum: int = 1             # gradient accumulation: split each batch
                                    # into K sequential microbatches, average
                                    # grads, ONE optimizer step — effective
                                    # batch beyond the activation-HBM limit


def _add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str = "") -> None:
    for f in dataclasses.fields(cls):
        name = f"--{prefix}{f.name.replace('_', '-')}"
        try:
            if f.type in ("bool", bool) or isinstance(f.default, bool):
                parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                    default=f.default)
            elif f.name == "categories":
                parser.add_argument(name, type=lambda s: tuple(s.split(",")), default=f.default)
            else:
                typ = {"int": int, "float": float, "str": str}.get(str(f.type), str)
                if isinstance(f.default, (int, float, str)):
                    typ = type(f.default)
                parser.add_argument(name, type=typ, default=f.default)
        except argparse.ArgumentError:
            pass  # shared field (e.g. image_size appears in two configs)


def parse_configs(argv: Sequence[str] | None = None,
                  description: str = "cnn_tpu") -> tuple[ModelConfig, DataConfig, TrainConfig, argparse.Namespace]:
    """Build (ModelConfig, DataConfig, TrainConfig) from CLI flags."""
    parser = argparse.ArgumentParser(description=description)
    _add_dataclass_args(parser, ModelConfig)
    _add_dataclass_args(parser, DataConfig)
    _add_dataclass_args(parser, TrainConfig)
    ns, _ = parser.parse_known_args(argv)

    def pick(cls):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in vars(ns).items() if k in names})

    return pick(ModelConfig), pick(DataConfig), pick(TrainConfig), ns
