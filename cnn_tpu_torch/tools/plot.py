"""Plot training history (loss / accuracy curves) from the JSONL log the
train CLI writes, counterpart of ``cnn_tpu/tools/plot.py``: a PNG through
matplotlib where it is installed, else ASCII curves (``utils/history.py``).

Usage: python -m cnn_tpu_torch.tools.plot <history.jsonl> [--out curves.png]
"""

from __future__ import annotations

import argparse
import sys

from cnn_tpu_torch.utils.history import plot_history


def main(argv=None):
    ap = argparse.ArgumentParser(description="plot training history")
    ap.add_argument("history")
    ap.add_argument("--out", default=None)
    ap.add_argument("--keys", default="loss,accuracy,valid_loss,valid_accuracy")
    args = ap.parse_args(argv)
    result = plot_history(args.history, args.out,
                          keys=tuple(args.keys.split(",")))
    print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
