"""Export a serving artifact from a checkpoint, counterpart of
``cnn_tpu/tools/export_artifact.py``: the output file carries the program
and the weights, serves any batch size, and loads with this package alone
(``cnn_tpu_torch/export.py``; ``import cnn_tpu_torch`` registers the
kernels' operators that the program calls).

It runs on the GPU; ``main(argv, device="cpu")`` exports on the CPU.

Usage:
  python -m cnn_tpu_torch.tools.export_artifact ckpt.ckpt out.ctsa \
      --name alexnet [--num-classes 3] [--compute-dtype bfloat16] \
      [--int8 calib1.jpg calib2.jpg ...] [--platforms cuda cpu]

Reference ``.model`` checkpoints are accepted too.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from cnn_tpu_torch import default_device
from cnn_tpu_torch.data.image import imread, resize

DEFAULT_CLASSES = ["dog", "panda", "bird"]  # the reference's category order


def _read_calib(paths, image_size):
    imgs = []
    for p in paths:
        try:
            img = imread(p)
        except IOError:
            print(f"warning: unreadable calibration image {p}",
                  file=sys.stderr)
            continue
        imgs.append(resize(img, (image_size, image_size)))
    if not imgs:
        raise SystemExit("--int8 given but no calibration images loaded")
    return np.stack(imgs)


def main(argv=None, *, device=None):
    """Runs the CLI on ``device`` (default: the GPU); returns 0."""
    from cnn_tpu_torch.export import export_serving_artifact
    from cnn_tpu_torch.models import get_model
    from cnn_tpu_torch.tools.infer import load_params

    ap = argparse.ArgumentParser(
        description="cnn_tpu_torch serving-artifact export")
    ap.add_argument("src", help=".ckpt or reference .model checkpoint")
    ap.add_argument("dst", help="output artifact path (.ctsa)")
    ap.add_argument("--name", default="alexnet")
    ap.add_argument("--num-classes", type=int, default=3)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batch-norm", type=lambda s: s.lower() in ("1", "true"),
                    default=False, help="for .model imports of BN nets")
    ap.add_argument("--compute-dtype", default=None,
                    choices=[None, "float32", "bfloat16"])
    ap.add_argument("--int8", nargs="+", metavar="IMG", default=None,
                    help="calibration images; exports the int8 graph")
    ap.add_argument("--platforms", nargs="+", default=["cuda", "cpu"])
    ap.add_argument("--class-names", nargs="+", default=None)
    ap.add_argument("--use-ema", action="store_true",
                    help="export the EMA weights from an --ema training run")
    args = ap.parse_args(argv)
    dev = default_device(device)

    kwargs = {"num_classes": args.num_classes,
              "image_size": args.image_size}
    if args.name == "alexnet":
        kwargs["batch_norm"] = args.batch_norm
    model = get_model(args.name, device=dev, **kwargs)
    load_params(args.src, model, use_ema=args.use_ema)
    calib = (_read_calib(args.int8, model.image_size)
             if args.int8 else None)
    names = args.class_names or (
        DEFAULT_CLASSES if args.num_classes == 3 else None)
    meta = export_serving_artifact(
        model, args.dst,
        compute_dtype={"bfloat16": torch.bfloat16,
                       "float32": torch.float32}.get(args.compute_dtype),
        int8_calib=calib, platforms=tuple(args.platforms),
        class_names=names)
    size = os.path.getsize(args.dst)
    print(f"exported {args.src} -> {args.dst} "
          f"({size/1e6:.2f} MB, platforms={meta['platforms']}, "
          f"int8={meta['int8']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
