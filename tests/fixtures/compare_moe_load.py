"""Prints the ``MoE load`` lines of both train CLIs on one argv: MoECNN
with ``--moe-balance 0.01`` at 32 px, resumed from one ``cnn_tpu``
checkpoint (iteration 4) and trained to iteration 28, validating every 4,
on the CPU, on ``tests/test_torch_data.py``'s synthetic images.

    JAX_PLATFORMS=cpu python tests/fixtures/compare_moe_load.py [DIR]

It writes the images and checkpoints under DIR (default: a temporary
directory). Equal lines say that the router's load follows ``cnn_tpu``'s
over many steps, where the tests compare one step.
"""

from __future__ import annotations

import contextlib
import glob
import io
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))                   # tests/
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))  # the repo

SHOWN = ("MoE load", "Valid===>", "Test===>")


def main(root: str) -> int:
    from cnn_tpu.tools import train as j_train
    from cnn_tpu_torch.tools import train
    from test_torch_data import write_dataset
    data = write_dataset(os.path.join(root, "animals"))
    base = ["--dataset-path", data, "--image-size", "32",
            "--train-batch-size", "8", "--valid-batch-size", "8",
            "--valid-iters", "4", "--save-iters", "4", "--augment", "false",
            "--batch-norm", "true", "--optimizer", "momentum",
            "--lr-schedule", "cosine", "--learning-rate", "1.5e-2",
            "--backend", "python", "--num-workers", "2", "--name", "moecnn",
            "--moe-balance", "0.01"]

    def run(main_fn, ckdir, *more, **kwargs):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main_fn(base + ["--checkpoint-dir", os.path.join(root, ckdir),
                                 *more], **kwargs)
        assert rc == 0, out.getvalue()[-2000:]
        return [line.strip() for line in out.getvalue().splitlines()
                if line.startswith(SHOWN)]

    run(j_train.main, "start", "--total-iters", "4")
    (start,) = glob.glob(os.path.join(root, "start", "iter_4_*.ckpt"))
    more = ("--total-iters", "28", "--resume", start)
    want = run(j_train.main, "cnn_tpu", *more)
    got = run(train.main, "port", *more, device="cpu")
    for name, lines in (("cnn_tpu", want), ("cnn_tpu_torch", got)):
        print(name)
        for line in lines:
            print("  " + line)
    loads = [[l for l in lines if l.startswith("MoE load")]
             for lines in (want, got)]
    print("MoE load lines equal:", loads[0] == loads[1])
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        sys.exit(main(sys.argv[1]))
    with tempfile.TemporaryDirectory() as tmp:
        sys.exit(main(tmp))
