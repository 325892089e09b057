"""Training history log, counterpart of ``cnn_tpu/utils/history.py``: the
JSONL writer the train CLI appends to, its reader, and an offline plotter
(``plot_history``: matplotlib where it is installed, else ASCII curves,
``cnn_tpu``'s own fallback, so that the feature works in minimal images).
"""

from __future__ import annotations

import json
import os
from typing import Iterable


class HistoryWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)

    def log(self, **fields) -> None:
        self._f.write(json.dumps(fields) + "\n")

    def close(self) -> None:
        self._f.close()


def read_history(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _ascii_curve(values: Iterable[float], width: int = 72,
                 height: int = 12) -> str:
    vals = list(values)
    if not vals:
        return "(no data)"
    if len(vals) > width:
        # downsample by averaging buckets
        k = len(vals) / width
        vals = [sum(vals[int(i * k):max(int(i * k) + 1, int((i + 1) * k))]) /
                max(1, len(vals[int(i * k):max(int(i * k) + 1,
                                               int((i + 1) * k))]))
                for i in range(width)]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    rows = [[" "] * len(vals) for _ in range(height)]
    for x, v in enumerate(vals):
        y = int((v - lo) / span * (height - 1))
        rows[height - 1 - y][x] = "*"
    header = f"max {hi:.4f}"
    footer = f"min {lo:.4f}"
    return "\n".join([header] + ["".join(r) for r in rows] + [footer])


def plot_history(path: str, out_png: str | None = None,
                 keys: tuple[str, ...] = ("loss", "accuracy")) -> str:
    """Plot curves; returns the output path or the ASCII chart."""
    hist = read_history(path)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(len(keys), 1, figsize=(8, 3 * len(keys)))
        if len(keys) == 1:
            axes = [axes]
        for ax, key in zip(axes, keys):
            pts = [(h.get("step", i), h[key]) for i, h in enumerate(hist)
                   if key in h]
            if pts:
                xs, ys = zip(*pts)
                ax.plot(xs, ys)
            ax.set_title(key)
            ax.grid(True, alpha=0.3)
        out_png = out_png or (os.path.splitext(path)[0] + ".png")
        fig.tight_layout()
        fig.savefig(out_png, dpi=120)
        return out_png
    except ImportError:
        charts = []
        for key in keys:
            vals = [h[key] for h in hist if key in h]
            charts.append(f"--- {key} ---\n{_ascii_curve(vals)}")
        return "\n".join(charts)
