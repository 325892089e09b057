"""Grad-CAM CLI, counterpart of ``cnn_tpu/tools/gradcam.py`` (the reference's
``gradCAM`` binary), with its two CAM modes:

- ``mode='reference'``: what the reference C++ computes: the channel
  weights are the spatial mean of the captured activations;
- ``mode='gradcam'`` (default): canonical Grad-CAM, the weights the spatial
  mean of d score[class] / d activation.

cam = relu(sum_c w_c * fmap_c), min-max normalized. The forward runs
without gradients (the bare kernels) and captures the layer's output
(``Sequential.forward(capture=)``); the gradient replays the layers after
it from the captured activation (``run_layers``, fused as a forward is)
with the parameters frozen, so the conv Function computes only dx and the
max pool, when it is in that tail, runs its tap and backward kernels.

The heatmap is the reference's post-processing: invert, resize to the
input, JET colormap, blend with the input; written as ``<i>.png``
(``data/image.py``: the resize, the colormap and the PNG are cv2's).

It runs on the GPU; ``main(argv, device="cpu")`` runs the plain versions on
the CPU, for any model family (``--model``). A top-level layer name is
captured; so is a position inside a ``StackedBlocks`` trunk (PipeCNN's):
``trunk/block_<i>`` (the block's output) or ``trunk/block_<i>/<layer>`` (a
layer of the block's body), as ``cnn_tpu`` unrolls its scanned trunk at
block i. Blocks 0..i-1 run as modules built from their slices of the
stacked tensors (``StackedBlocks.block_at``), then block i up to the
captured point; the tail replays the rest of block i (its body's later
layers, the shortcut, the residual sum and ReLU), the later blocks and the
head.

Usage:
  python -m cnn_tpu_torch.tools.gradcam --checkpoint path.[ckpt|model] \\
      [--layer conv_layer_3] [--mode gradcam|reference] img1 [img2 ...]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from cnn_tpu_torch import default_device
from cnn_tpu_torch.data.image import apply_colormap_jet, imwrite, resize
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.nn import ResidualBlock, StackedBlocks
from cnn_tpu_torch.nn.sequential import run_layers
from cnn_tpu_torch.ops.activations import relu
from cnn_tpu_torch.ops.preprocess import uint8_to_float
from cnn_tpu_torch.ops.tensor import minmax_normalize
from cnn_tpu_torch.tools.infer import DEFAULT_CKPT, load_params, read_image

DEFAULT_IMAGES = [
    "/root/reference/datasets/images/dog.jpg",
    "/root/reference/datasets/images/bird_2.jpg",
    "/root/reference/datasets/images/panda.jpg",
    "/root/reference/datasets/images/dog_3.jpg",
    "/root/reference/datasets/images/panda_2.jpg",
    "/root/reference/datasets/images/bird.jpg",
]


def parse_layer_path(model, layer_path: str):
    """Validates a capture path against ``model``; raises ValueError with
    ``cnn_tpu``'s messages. Returns ``(name, None, None)`` for a top-level
    layer, ``(trunk, i, None)`` for ``trunk/block_<i>`` and ``(trunk, i,
    layer)`` for ``trunk/block_<i>/<layer>``."""
    names = [l.name for l in model.net]
    parts = layer_path.split("/")
    if parts[0] not in names:
        raise ValueError(f"layer '{parts[0]}' not in model; "
                         f"choose one of: {', '.join(names)}")
    if len(parts) == 1:
        return (parts[0], None, None)
    trunk = model.net[parts[0]]
    if not isinstance(trunk, StackedBlocks):
        raise ValueError(f"'{parts[0]}' is not a scanned trunk; nested "
                         "paths address StackedBlocks layers only")
    if len(parts) > 3 or not parts[1].startswith("block_"):
        raise ValueError(f"bad trunk path '{layer_path}' (want "
                         f"'{parts[0]}/block_<i>[/<body_layer>]')")
    i = int(parts[1].split("_")[-1])
    if not 0 <= i < trunk.n_blocks:
        raise ValueError(f"block index {i} out of range "
                         f"[0, {trunk.n_blocks})")
    sub = parts[2] if len(parts) == 3 else None
    if sub is not None:
        if not isinstance(trunk.block, ResidualBlock):
            raise ValueError("body-layer capture needs a ResidualBlock "
                             f"trunk block, got {type(trunk.block).__name__}")
        body_names = [l.name for l in trunk.block.body]
        if sub not in body_names:
            raise ValueError(f"'{sub}' not in the trunk block's body; "
                             f"choose one of: {', '.join(body_names)}")
    return (parts[0], i, sub)


def _forward_with_capture(model, x, layer_path: str):
    """Eval forward without gradients, capturing ``layer_path``'s output.
    Returns ``(logits, fmap, resume)``; ``resume(act)`` replays the network
    after the capture point from ``act``."""
    name, i, sub = parse_layer_path(model, layer_path)
    layers = list(model.net)
    names = [l.name for l in layers]
    ti = names.index(name)
    model.eval()
    if i is None:             # a top-level layer
        tail = layers[ti + 1:]
        with torch.no_grad():
            logits, captured = model(x, capture=(name,))
        return logits, captured[name], lambda act: run_layers(tail, act)

    trunk = model.net[name]
    blocks = [trunk.block_at(j) for j in range(trunk.n_blocks)]
    tail = layers[ti + 1:]

    def finish(h, start):
        for block in blocks[start:]:
            h = block(h)
        return run_layers(tail, h)

    with torch.no_grad():
        h = run_layers(layers[:ti], x)
        for block in blocks[:i]:
            h = block(h)
        block_in = h
        if sub is None:       # the block's output
            fmap = blocks[i](block_in)

            def resume(act):
                return finish(act, i + 1)
        else:                 # a layer of the block's body
            block = blocks[i]
            body = list(block.body)
            k = [l.name for l in body].index(sub)
            fmap = run_layers(body[:k + 1], block_in)
            sc = block.shortcut(block_in)

            def resume(act):
                y = run_layers(body[k + 1:], act)
                return finish(block.combine(y, sc), i + 1)
        logits = resume(fmap)
    return logits, fmap, resume


def compute_cam(model, x: torch.Tensor, layer_name: str,
                mode: str = "gradcam", class_idx: int | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Returns (cam [H,W] in 0..1, probs [C]) for one image ``x`` [1,H,W,C]
    float on the model's device."""
    logits, fmap, resume = _forward_with_capture(model, x, layer_name)
    probs = torch.softmax(logits.float(), dim=-1)[0]

    if mode == "reference":
        weights = fmap[0].mean(dim=(0, 1))
    elif mode == "gradcam":
        k = int(probs.argmax()) if class_idx is None else class_idx
        act = fmap.detach().requires_grad_(True)
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:      # d score / d act only: no dw, no db
            p.requires_grad_(False)
        try:
            with torch.enable_grad():
                (grads,) = torch.autograd.grad(resume(act)[0, k], act)
        finally:
            for p in params:
                p.requires_grad_(True)
        weights = grads[0].mean(dim=(0, 1))
    else:
        raise ValueError(f"unknown CAM mode '{mode}'")

    cam = minmax_normalize(relu((fmap[0] * weights).sum(dim=-1)))
    return (cam.cpu().numpy().astype(np.float32),
            probs.cpu().numpy().astype(np.float32))


def render_heatmap(img_bgr: np.ndarray, cam01: np.ndarray) -> np.ndarray:
    """The reference's post-processing: invert, resize, JET, blend."""
    cam_u8 = np.uint8(np.clip(255 * cam01, 0, 255))
    cam_u8 = 255 - cam_u8
    cam_u8 = resize(cam_u8, (img_bgr.shape[1], img_bgr.shape[0]))
    heat = apply_colormap_jet(cam_u8).astype(np.float32)
    blend = heat / 255.0 + img_bgr.astype(np.float32) / 255.0
    blend = blend / blend.max() * 255.0
    return blend.astype(np.uint8)


def main(argv=None, *, device=None):
    """Runs the CLI on ``device`` (default: the GPU); returns 0."""
    ap = argparse.ArgumentParser(description="cnn_tpu_torch Grad-CAM")
    ap.add_argument("images", nargs="*", default=DEFAULT_IMAGES)
    ap.add_argument("--checkpoint", default=DEFAULT_CKPT)
    ap.add_argument("--categories", default="dog,panda,bird")
    ap.add_argument("--model", default="alexnet",
                    help="model family (alexnet | vgg8 | resnet10 | ...)")
    ap.add_argument("--layer", default="conv_layer_3",
                    help="capture layer: a top-level name (block_4 for "
                         "resnet10), or inside a scanned trunk: "
                         "trunk/block_3 or trunk/block_3/b_conv1 (pipecnn)")
    ap.add_argument("--mode", default="gradcam",
                    choices=["gradcam", "reference"])
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--output-dir", default="output")
    ap.add_argument("--batch-norm", action="store_true",
                    help="checkpoint was trained with BatchNorm layers")
    ap.add_argument("--width", type=int, default=0,
                    help="trunk width (pipecnn checkpoints; 0 = family default)")
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="trunk depth (pipecnn checkpoints; 0 = family default)")
    args = ap.parse_args(argv)
    categories = args.categories.split(",")
    dev = default_device(device)

    kwargs = {}
    if args.width:
        kwargs["width"] = args.width
    if args.n_blocks:
        kwargs["n_blocks"] = args.n_blocks
    model = get_model(args.model, num_classes=len(categories),
                      image_size=args.image_size, batch_norm=args.batch_norm,
                      device=dev, **kwargs)
    try:
        parse_layer_path(model, args.layer)
    except ValueError as e:
        ap.error(f"--layer '{args.layer}': {e}")
    load_params(args.checkpoint, model)
    os.makedirs(args.output_dir, exist_ok=True)

    for i, path in enumerate(args.images or DEFAULT_IMAGES):
        img = read_image(path, args.image_size)
        if img is None:
            continue
        # float input, true division (no normalize kernel on this path)
        x = uint8_to_float(torch.from_numpy(img[None]).to(dev))
        cam, probs = compute_cam(model, x, args.layer, args.mode)
        k = int(probs.argmax())
        print(f"{path}===> [classification: {categories[k]}] "
              f"[prob: {probs[k]:.6f}]")
        out_path = os.path.join(args.output_dir, f"{i}.png")
        imwrite(out_path, render_heatmap(img, cam))
        print(f"  saved {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
