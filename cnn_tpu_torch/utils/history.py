"""Training history log, counterpart of ``cnn_tpu/utils/history.py``: the
JSONL writer the train CLI appends to, and its reader. The plotter
(``plot_history``) comes with the port of ``tools/plot.py``.
"""

from __future__ import annotations

import json
import os


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
