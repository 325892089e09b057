"""Checkpoint evaluation CLI, counterpart of ``cnn_tpu/tools/evaluate.py``,
with its flags (the train CLI's, plus ``--split`` and ``--ensemble``).

``python -m cnn_tpu_torch.tools.evaluate --resume <ckpt> [--split
valid|test|both] [--tta hflip|flips] ...`` loads a ``.ckpt`` and reports
the loss, the accuracy and the confusion matrix over the requested splits
of the dataset, through the train CLI's eval step (``make_eval_step``,
with test-time augmentation). ``--ensemble name:ckpt[,name:ckpt...]``
averages the class probabilities of several checkpoints
(``make_ensemble_eval_step``) in place of ``--resume``; each member's BN
layers follow its checkpoint. A checkpoint of an ``--ema`` run is
evaluated on its EMA weights with its EMA'd BN statistics (the raw ones
where a legacy checkpoint has none), as ``cnn_tpu`` does.

It runs on the GPU; ``main(argv, device="cpu")`` runs the plain versions
on the CPU. ``--name`` and the ensemble members take every family
(alexnet, resnet10/18, vgg8/11, mobilenet, pipecnn, moecnn; a member's
options as ``pipecnn@width=64@n_blocks=8:ckpt``). ``--compile-cache DIR``
builds and loads the kernel library under DIR, as the train CLI does.
``--backend`` is the train CLI's: with ``--cache false``, ``native`` (and
``auto`` on the GPU) resizes each batch with one resize-kernel launch.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from cnn_tpu_torch import default_device
from cnn_tpu_torch.core.config import parse_configs
from cnn_tpu_torch.data import DataLoader, discover_dataset, split_dataset
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.parallel import make_ensemble_eval_step, make_eval_step
from cnn_tpu_torch.tools.train import evaluate, use_compile_cache
from cnn_tpu_torch.utils.checkpoint import (eval_trees, load_jax_params,
                                            read_checkpoint, tree_has_bn)
from cnn_tpu_torch.utils.metrics import ConfusionMatrix


def load_model(path: str, name: str, device, announce: bool = True,
               **kwargs):
    """The ``name`` model with the weights of the ``.ckpt`` at ``path``
    (``eval_trees``: the EMA's where it has them, said in ``cnn_tpu``'s
    line when ``announce``), BN layers where its param tree has them."""
    params, state, ema = eval_trees(read_checkpoint(path))
    if ema and announce:
        print(f"{path}: evaluating the EMA-averaged weights")
    model = get_model(name, batch_norm=tree_has_bn(params), device=device,
                      **kwargs)
    load_jax_params(model, params, state)
    return model


def _member_kwargs(kvs) -> dict:
    """``k=v`` strings (``name@k=v...:ckpt``) as model kwargs."""
    kwargs = {}
    for kv in kvs:
        k, v = kv.split("=", 1)
        kwargs[k.replace("-", "_")] = (
            int(v) if v.lstrip("-").isdigit() else float(v))
    return kwargs


def main(argv=None, *, device=None):
    """Runs the CLI on ``device`` (default: the GPU); returns the exit
    code (2 when ``--resume`` names no file)."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--split", default="both",
                     choices=("valid", "test", "both"))
    pre.add_argument("--ensemble", default="",
                     help="name:ckpt[,name:ckpt...] — average class "
                          "probabilities across models; replaces "
                          "--resume/--name")
    pre_ns, rest = pre.parse_known_args(argv if argv is not None
                                        else sys.argv[1:])
    model_cfg, data_cfg, train_cfg, _ = parse_configs(
        rest, "cnn_tpu_torch evaluate")
    if not pre_ns.ensemble and (not train_cfg.resume
                                or not os.path.exists(train_cfg.resume)):
        print(f"--resume must point at a checkpoint (got '{train_cfg.resume}')",
              file=sys.stderr)
        return 2
    use_compile_cache(train_cfg.compile_cache)
    dev = default_device(device)

    samples = discover_dataset(data_cfg.dataset_path, data_cfg.categories)
    splits = split_dataset(samples, data_cfg.train_ratio, data_cfg.test_ratio,
                           data_cfg.split_seed)
    compute_dtype = (torch.bfloat16 if model_cfg.compute_dtype == "bfloat16"
                     else None)
    shape = {"num_classes": model_cfg.num_classes,
             "image_size": model_cfg.image_size}

    if pre_ns.ensemble:
        models = []
        for spec in pre_ns.ensemble.split(","):
            name, _, ck = spec.partition(":")
            if not ck:
                raise ValueError(f"--ensemble spec '{spec}' must be "
                                 "name[@k=v...]:ckpt")
            name, *kvs = name.split("@")
            models.append(load_model(ck, name, dev, **shape,
                                     **_member_kwargs(kvs)))
        eval_fn = make_ensemble_eval_step(models, compute_dtype=compute_dtype,
                                          tta=train_cfg.tta)
        print(f"ensemble of {len(models)} models"
              + (f", TTA {train_cfg.tta}" if train_cfg.tta else ""))
    else:
        model = load_model(train_cfg.resume, model_cfg.name, dev, **shape,
                           dropout=model_cfg.dropout)
        eval_fn = make_eval_step(model, compute_dtype=compute_dtype,
                                 tta=train_cfg.tta)
        if train_cfg.tta:
            print(f"test-time augmentation: {train_cfg.tta}")

    want = ("valid", "test") if pre_ns.split == "both" else (pre_ns.split,)
    for split in want:
        loader = DataLoader(splits[split], train_cfg.valid_batch_size,
                            augment=False, shuffle=False,
                            image_size=data_cfg.image_size,
                            num_workers=data_cfg.num_workers,
                            backend=data_cfg.backend, cache=data_cfg.cache,
                            device=dev)
        confusion = ConfusionMatrix(model_cfg.num_classes)
        try:
            loss, acc = evaluate(eval_fn, loader, dev, confusion)
        finally:
            loader.close()
        print(f"{split.capitalize()}===> [loss {loss:.3f}] [Accuracy {acc:.3f}]")
        print("confusion matrix (rows = truth):")
        print(confusion.pretty(list(data_cfg.categories)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
