"""Tracing and profiling, counterpart of ``cnn_tpu/utils/profiling.py``.

- ``StepTimer``: wall-clock and images/sec accounting for the train loop.
- ``trace(log_dir)``: a ``torch.profiler`` scope (host activity, and the
  GPU's when there is one) that writes a Chrome trace,
  ``<log_dir>/trace.json``, at its end; a no-op when ``log_dir`` is falsy
  (the train CLI's ``--profile-dir``).
- ``device_memory_stats()``: the CUDA caching allocator's bytes in use and
  their peak.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from cnn_tpu_torch import default_device


class StepTimer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.images = 0
        self.steps = 0

    def tick(self, batch_size: int):
        self.images += batch_size
        self.steps += 1

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def images_per_sec(self) -> float:
        dt = self.elapsed
        return self.images / dt if dt > 0 else 0.0

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.elapsed / self.steps if self.steps else 0.0


@contextlib.contextmanager
def trace(log_dir: str | None, device=None):
    """``torch.profiler`` scope writing ``<log_dir>/trace.json``; no-op when
    ``log_dir`` is falsy. ``device`` (default: the GPU) says whether to
    record CUDA activity too."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if default_device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device=None) -> dict:
    """``bytes_in_use`` and ``peak_bytes_in_use`` of the CUDA caching
    allocator on ``device`` (default: the GPU); empty for the CPU."""
    dev = default_device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}
