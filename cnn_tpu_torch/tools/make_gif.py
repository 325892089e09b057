"""Assemble PNG / JPEG frames into an animated GIF, counterpart of
``cnn_tpu/tools/make_gif.py`` (the reference's ``make_gif.py``): the
frames of a directory in name order, read and optionally resized through
``data/image.py``, written with PIL (``duration`` 1000 / fps ms a frame,
looping).

Usage: python -m cnn_tpu_torch.tools.make_gif <frames_dir> <out.gif> [--fps 2]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from cnn_tpu_torch.data.image import imread, resize


def main(argv=None):
    ap = argparse.ArgumentParser(description="frames -> GIF")
    ap.add_argument("frames_dir")
    ap.add_argument("out_gif")
    ap.add_argument("--fps", type=float, default=2.0)
    ap.add_argument("--size", type=int, default=0, help="resize frames to NxN")
    args = ap.parse_args(argv)

    from PIL import Image

    frames = sorted(glob.glob(os.path.join(args.frames_dir, "*.png")) +
                    glob.glob(os.path.join(args.frames_dir, "*.jpg")))
    if not frames:
        print(f"no frames in {args.frames_dir}")
        return 1
    images = []
    for f in frames:
        try:
            img = imread(f)
        except IOError:
            continue
        if args.size:
            img = resize(img, (args.size, args.size))
        images.append(Image.fromarray(img[:, :, ::-1].copy()))   # BGR -> RGB
    images[0].save(args.out_gif, save_all=True, append_images=images[1:],
                   duration=1000 / args.fps, loop=0)
    print(f"wrote {args.out_gif} ({len(images)} frames)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
