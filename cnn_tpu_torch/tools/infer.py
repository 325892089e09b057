"""Single-image inference CLI, counterpart of ``cnn_tpu/tools/infer.py`` (the
reference's ``inference`` binary): load a checkpoint, then per image decode,
resize, forward (``make_forward``: the normalize, conv and pool kernels, a
float32 softmax), print the class and its probability. Takes a native
``.ckpt`` or a reference ``.model`` (give ``--batch-norm`` for a BN one).
``--bench`` also times 50 forwards of each image, the device synchronised
after each, and prints their p50 and p90.

It runs on the GPU; ``main(argv, device="cpu")`` runs the plain versions on
the CPU. ``--use-ema`` serves the EMA weights (with the EMA'd BN
statistics) of an ``--ema`` run's ``.ckpt``.

Usage:
  python -m cnn_tpu_torch.tools.infer --checkpoint path.[ckpt|model] img1 [img2 ...]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from cnn_tpu_torch import default_device
from cnn_tpu_torch.data.image import imread, resize
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.parallel import make_forward
from cnn_tpu_torch.utils.checkpoint import (eval_trees, load_jax_params,
                                            load_reference_model,
                                            read_checkpoint)

DEFAULT_CKPT = ("/root/reference/cpu/checkpoints/AlexNet_aug_1e-3/"
                "iter_395000_train_0.918_valid_0.913.model")
DEFAULT_IMAGES = [
    "/root/reference/datasets/images/dog.jpg",
    "/root/reference/datasets/images/panda.jpg",
    "/root/reference/datasets/images/bird.jpg",
]


def load_params(checkpoint: str, model, use_ema: bool = False) -> None:
    """Loads the weights of a ``.model`` or a ``.ckpt`` into ``model`` in
    place: a ``.ckpt``'s raw params and BN state, or with ``use_ema`` its
    EMA weights and EMA'd state (``ValueError`` where it has none, as
    ``cnn_tpu`` raises)."""
    if checkpoint.endswith(".model"):
        load_reference_model(model, checkpoint)
        return
    payload = read_checkpoint(checkpoint)
    params, state = payload["params"], payload["state"]
    if use_ema:
        params, state, ema = eval_trees(payload)
        if not ema:
            raise ValueError(f"{checkpoint} has no EMA state "
                             "(trained without --ema)")
    load_jax_params(model, params, state)


def read_image(path: str, size: int):
    """``path`` decoded (BGR uint8) and resized to ``size`` x ``size``, or
    None (with ``cnn_tpu``'s message printed) where it does not decode."""
    try:
        img = imread(path)
    except IOError:
        print(f"Failed to read image file  {path}")
        return None
    return resize(img, (size, size))


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, *, device=None):
    """Runs the CLI on ``device`` (default: the GPU); returns 0."""
    ap = argparse.ArgumentParser(description="cnn_tpu_torch inference")
    ap.add_argument("images", nargs="*", default=DEFAULT_IMAGES)
    ap.add_argument("--checkpoint", default=DEFAULT_CKPT)
    ap.add_argument("--categories", default="dog,panda,bird")
    ap.add_argument("--model", default="alexnet",
                    help="model family (alexnet | vgg8 | resnet10 | ...)")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--batch-norm", action="store_true",
                    help="checkpoint was trained with BatchNorm layers")
    ap.add_argument("--bench", action="store_true",
                    help="report p50 and p90 latency")
    ap.add_argument("--use-ema", action="store_true",
                    help="use the EMA weights from an --ema training run")
    args = ap.parse_args(argv)
    categories = args.categories.split(",")
    dev = default_device(device)

    model = get_model(args.model, num_classes=len(categories),
                      image_size=args.image_size, batch_norm=args.batch_norm,
                      device=dev)
    load_params(args.checkpoint, model, use_ema=args.use_ema)
    fwd = make_forward(model)

    for path in args.images or DEFAULT_IMAGES:
        img = read_image(path, args.image_size)
        if img is None:
            continue
        x = torch.from_numpy(img[None]).to(dev)    # uint8, normalized there
        probs = fwd(x)[0].cpu().numpy()
        k = int(probs.argmax())
        print(f"{path}===> [classification: {categories[k]}] "
              f"[prob: {probs[k]:.6f}]")

        if args.bench:
            lat = []
            for _ in range(50):
                t0 = time.perf_counter()
                fwd(x)
                synchronize(dev)
                lat.append(time.perf_counter() - t0)
            print(f"  p50 latency: {1e3 * float(np.percentile(lat, 50)):.3f} "
                  f"ms (p90 {1e3 * float(np.percentile(lat, 90)):.3f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
