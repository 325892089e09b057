"""Builds and loads the CUDA kernels under ``cnn_tpu_torch/csrc/``.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc`` process,
all started together, and one more ``nvcc`` links the objects into one
shared library with a plain C interface, which ``ctypes`` loads. No PyTorch
headers, no ``torch.utils.cpp_extension``, no ninja: the build takes
seconds.

No ``--use_fast_math``: the normalize kernels' division must be correctly
rounded to be bit-identical to its plain version.

The library lands in ``build/cnn_tpu_torch/<hash>/`` beside the package,
keyed by a hash of the sources and flags, so a checkout builds once and an
edited source rebuilds. ``set_build_root(DIR)`` (the CLIs'
``--compile-cache DIR``) puts it in ``DIR/cnn_tpu_torch/<hash>/`` instead,
before the first ``load()``: a later process with the same DIR and sources
loads it without building, from any checkout.

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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# entry point -> argument types after the leading stream
SIGNATURES = {
    # x_u8, y_f32, n, then normalize_plan's variant index, blocks, head
    "cnn_normalize_u8": [P, P, I64, I, I, I64],
    # x_u8, y_f32, n: the previous design
    "cnn_normalize_u8_direct": [P, P, I64],
    # x, y, tap (null: not written), B, H, W, C
    "cnn_maxpool2x2_fwd": [P, P, P, I, I, I, I],
    # tap, g, dx, B, H, W, C (H, W: the forward's input extent)
    "cnn_maxpool2x2_bwd": [P, P, P, I, I, I, I],
    # the same: one thread per window and 4 channels (C % 4 == 0)
    "cnn_maxpool2x2_bwd_window": [P, P, P, I, I, I, I],
    # the forward and the window backward on bf16 values
    "cnn_maxpool2x2_fwd_bf16": [P, P, P, I, I, I, I],
    # the window forward (16 bytes of channels a thread): x, y, tap, B, H,
    # W, C, then the block's (tx, ty) of ops/hopper/pool.py:pool_fwd_block
    "cnn_maxpool2x2_fwd_window": [P, P, P, I, I, I, I, I, I],
    "cnn_maxpool2x2_fwd_window_bf16": [P, P, P, I, I, I, I, I, I],
    "cnn_maxpool2x2_bwd_window_bf16": [P, P, P, I, I, I, I],
    # x, w, b, y, B, H, W, Cin, Cout, k, stride, pad (zero padding), relu
    "cnn_conv2d_bias_relu": [P, P, P, P, I, I, I, I, I, I, I, I, I],
    # the same, then the tile id of ops/hopper/conv.py:TILES
    "cnn_conv2d_bias_relu_tiled": [P, P, P, P, I, I, I, I, I, I, I, I, I, I],
    # the same (k 1, pad 0), then the tile id of ops/hopper/conv.py:PW_TILES
    # and the grid's x
    "cnn_conv2d_bias_relu_pw": [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I],
    # the same, then the strip id of ops/hopper/conv.py:STRIP_ROWS
    "cnn_conv2d_bias_relu_strip": [P, P, P, P, I, I, I, I, I, I, I, I, I, I],
    # x, w, b, y, B, H, W, Cin, Cout, k, stride, pad, relu, then
    # ops/hopper/conv.py:conv_bf16_plan's variant (an index into
    # BF16_VARIANTS) and tile id in that variant's table
    "cnn_conv2d_bias_relu_bf16": [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I],
    # img, s1, s2, s3, out, B, S, C, L, pad_l, bf16, then the tile plan of
    # ops/hopper/augment.py: rows, pixels, lanes_max, table_max, smem_bytes
    "cnn_rotate_shear": [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I],
    # img, s1, s2, s3, out, B, S, C, L, pad_l, bf16: the previous design
    "cnn_rotate_shear_direct": [P, P, P, P, P, I, I, I, I, I, I],
    # src, meta, xtab, ytab, out, n, s (ops/hopper/resize.py:Packed)
    "cnn_resize_linear_u8": [P, P, P, P, P, I, I],
}

_lock = threading.Lock()
_lib = None
_lib_path = None       # where the loaded library came from
build_seconds = None   # wall time of the nvcc call of this process, if any
build_log = ""         # nvcc's output for that call (register/smem report)


def set_build_root(cache_dir) -> Path:
    """Builds and loads the library under ``cache_dir/cnn_tpu_torch/``
    (made if missing) from now on; returns that root. Raises if this
    process already loaded the library from another root: it is loaded
    once."""
    global BUILD_ROOT
    root = Path(cache_dir).resolve() / "cnn_tpu_torch"
    with _lock:
        if _lib is not None and _lib_path.parent.parent != root:
            raise RuntimeError(
                f"the kernel library is already loaded from {_lib_path}; "
                f"set the compile cache ({cache_dir}) before the first "
                "kernel call")
        root.mkdir(parents=True, exist_ok=True)
        BUILD_ROOT = root
    return root


def describe() -> str:
    """Where the loaded library came from, and whether this process built
    it (with the seconds) or found it built."""
    if _lib is None:
        return "kernel library: not loaded"
    if build_seconds is None:
        return f"kernel library: already built, loaded from {_lib_path}"
    return f"kernel library: built in {build_seconds:.1f} s into {_lib_path}"


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


def _run_all(cmds: list[list[str]]) -> str:
    """Runs the commands side by side; returns their joined output, or
    raises with it if any failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    for cmd, p in zip(cmds, procs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{log}")
    return log


def _build(out: Path) -> None:
    global build_seconds, build_log
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = out.with_name(f"{out.name}.{tag}")
    nvcc = _nvcc()
    objs, compiles = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out.parent / f"{src.stem}.{tag}.o"
        objs.append(obj)
        compiles.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    t0 = time.perf_counter()
    try:
        log = _run_all(compiles)
        log += _run_all([[nvcc, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = log
    (out.parent / "nvcc.log").write_text(build_log)
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this checkout."""
    global _lib, _lib_path
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
            _lib, _lib_path = lib, path
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
    all on one device, and no gradient may be asked of them: a wrapper has
    no backward of its own. Gradients go through the autograd Functions
    (``conv2d_bias_relu_fn``, ``max_pool2d_fn``), whose forward calls the
    wrapper with grad mode off.
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
        raise RuntimeError(f"{name}: the wrapper has no backward; use its "
                           "autograd Function, or run under torch.no_grad()")
    return torch.cuda.current_stream(dev).cuda_stream
