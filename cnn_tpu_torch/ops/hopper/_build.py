"""Builds and loads the CUDA kernels under ``cnn_tpu_torch/csrc/``.

One ``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, which ``ctypes`` loads. No PyTorch headers,
no ``torch.utils.cpp_extension``, no ninja: the build takes seconds.

No ``--use_fast_math``: the normalize kernel needs IEEE division to be
bit-identical to its plain version.

The library lands in ``build/cnn_tpu_torch/<hash>/`` beside the package,
keyed by a hash of the sources and flags, so a checkout builds once and an
edited source rebuilds.

Every entry point takes a ``cudaStream_t`` and returns the ``cudaError_t`` of
its launch. ``launch`` makes the tensors' device current for the call only,
so the caller's current device is left as it was, and raises on anything
but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "cnn_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# entry point -> argument types after the leading stream
SIGNATURES = {
    # x_u8, y_f32, n
    "cnn_normalize_u8": [P, P, I64],
    # x, y, tap (null: not written), B, H, W, C
    "cnn_maxpool2x2_fwd": [P, P, P, I, I, I, I],
    # x, w, b, y, B, H, W, Cin, Cout, k, stride, relu
    "cnn_conv2d_bias_relu": [P, P, P, P, I, I, I, I, I, I, I, I],
}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the nvcc call of this process, if any
build_log = ""         # nvcc's output for that call (register/smem report)


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libcnn_tpu_torch.so"


def _build(out: Path) -> None:
    global build_seconds, build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{build_log}")
    (out.parent / "nvcc.log").write_text(build_log)
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this checkout."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [P, *args]
                fn.restype = I
            _lib = lib
    return _lib


def launch(name: str, device, stream: int, *args) -> None:
    """Calls entry point ``name`` on ``device`` and ``stream``; raises if the
    launch was refused."""
    fn = getattr(load(), name)
    with torch.cuda.device(device):
        err = fn(stream, *args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def cuda_args(name: str, *tensors, dtypes) -> int:
    """Checks that the kernel can take ``tensors`` and returns the current
    stream of their device.

    Each tensor must be a contiguous CUDA tensor of its dtype in ``dtypes``,
    all on one device, and no gradient may be asked of them: the kernels
    have no backward yet, and a silent one would be wrong.
    """
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expects CUDA tensors on one device, "
                             f"got {t.device} (CPU tensors take the plain "
                             "version)")
        if t.dtype != dt:
            raise TypeError(f"{name}: expects {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; run "
                           "under torch.no_grad() or torch.inference_mode()")
    return torch.cuda.current_stream(dev).cuda_stream
