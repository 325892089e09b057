"""Checkpoint conversion CLI, counterpart of ``cnn_tpu/tools/convert.py``:
native ``.ckpt`` <-> reference ``.model``, for the AlexNet stack (the only
one the ``.model`` format has). A ``.model`` becomes a ``.ckpt`` with plain
SGD's empty optimizer state at step 0; a ``.ckpt`` becomes a ``.model``
(``--use-ema``: its EMA weights with the EMA'd BN statistics).

It runs on the GPU; ``main(argv, device="cpu")`` runs on the CPU.

Usage:
  python -m cnn_tpu_torch.tools.convert in.model out.ckpt   [--batch-norm true]
  python -m cnn_tpu_torch.tools.convert in.ckpt  out.model  [--batch-norm true]
"""

from __future__ import annotations

import argparse
import sys

from cnn_tpu_torch import default_device
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.optim import sgd
from cnn_tpu_torch.parallel import create_train_state
from cnn_tpu_torch.utils.checkpoint import (eval_trees,
                                            export_reference_model,
                                            load_reference_model,
                                            read_checkpoint, save_checkpoint)


def main(argv=None, *, device=None):
    """Runs the CLI on ``device`` (default: the GPU); returns 0."""
    ap = argparse.ArgumentParser(description="cnn_tpu_torch checkpoint "
                                             "converter")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--num-classes", type=int, default=3)
    ap.add_argument("--batch-norm", type=lambda s: s.lower() in ("1", "true"),
                    default=False)
    ap.add_argument("--use-ema", action="store_true",
                    help="export the EMA weights (paired with the EMA'd BN "
                         "stats) from an --ema training run")
    args = ap.parse_args(argv)

    model = get_model("alexnet", num_classes=args.num_classes,
                      batch_norm=args.batch_norm,
                      device=default_device(device))
    if args.src.endswith(".model"):
        load_reference_model(model, args.src)
        save_checkpoint(args.dst, create_train_state(model, sgd(0.0)))
        print(f"imported {args.src} -> {args.dst}")
    else:
        payload = read_checkpoint(args.src)
        params, state = payload["params"], payload["state"]
        if args.use_ema:
            params, state, ema = eval_trees(payload)
            if not ema:
                sys.exit(f"{args.src} has no EMA state (trained without "
                         "--ema)")
        export_reference_model(args.dst, model.net, params, state)
        print(f"exported {args.src} -> {args.dst} (reference .model format)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
