"""Where the window max-pool forward's time goes, on the card.

    python -m cnn_tpu_torch.tools.pool_probe

Compiles ``csrc/pool.cu`` once as built and once for each mask of
``POOL_FWD_PROBE`` (bit 1 reads the same bytes of x as contiguous runs,
one run a load instruction of a warp, instead of the window's columns 2j
and 2j+1, which lie C elements apart; bit 2 stores nothing), side by side,
and times each build's window forward with the tap, in bf16 and float32,
at AlexNet's pool (batch 256 and 64) and two VGG pools at B = 64. Each
time: 20 launches captured into one CUDA graph, one replay timed with CUDA
events, the builds in turns (full, probes, probes, full); L2-warm (one
input) and HBM-cold (the launches take their input in turn from copies
that together pass the 50 MB L2). The builds that skip work compute wrong
results and serve only for timing; the full build is held bit for bit to
the package's kernel. Each line gives the bound (x's covered rows, y and
the tap over 3.35 TB/s). Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from cnn_tpu_torch.ops.hopper import _build
from cnn_tpu_torch.ops.hopper.pool import launch_pool_fwd, pool_fwd_block

MASKS = {"full": 0, "contiguous loads": 1, "no stores": 2,
         "contiguous, no stores": 3}
SHAPES = ((256, 111, 111, 16), (64, 111, 111, 16), (64, 224, 224, 32),
          (64, 28, 28, 512))
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20


def build(out_dir: Path) -> dict:
    """mask -> the library built with ``POOL_FWD_PROBE`` = mask."""
    src = _build.CSRC / "pool.cu"
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                      f"-DPOOL_FWD_PROBE={m}", "-o",
                      str(out_dir / f"pool_{m}.so"), str(src)]
                     for m in MASKS.values()])
    libs = {}
    for m in MASKS.values():
        lib = ctypes.CDLL(str(out_dir / f"pool_{m}.so"))
        for entry in ("cnn_maxpool2x2_fwd_window",
                      "cnn_maxpool2x2_fwd_window_bf16"):
            getattr(lib, entry).argtypes = [_build.P,
                                            *_build.SIGNATURES[entry]]
            getattr(lib, entry).restype = _build.I
        libs[m] = lib
    return libs


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn(i)``: ``iters`` calls in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("pool_probe: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            entry = "cnn_maxpool2x2_fwd_window" + ("_bf16" if bf16 else "")
            for b, h, w, c in SHAPES:
                x = torch.relu(torch.round(torch.randn(
                    (b, h, w, c), generator=gen, device=dev) * 4) / 4)
                x = x.to(dtype)
                copies = [x] + [x.clone() for _ in range(
                    -(-2 * L2_BYTES // (x.numel() * x.element_size())))]
                y = torch.empty((b, h // 2, w // 2, c), dtype=dtype,
                                device=dev)
                tap = torch.empty(y.shape, dtype=torch.uint8, device=dev)
                tx, ty, _ = pool_fwd_block(b, h // 2, w // 2, c, bf16)

                def run(lib, cold):
                    def go(i):
                        xi = copies[i % len(copies)] if cold else x
                        err = getattr(lib, entry)(
                            torch.cuda.current_stream().cuda_stream,
                            xi.data_ptr(), y.data_ptr(), tap.data_ptr(), b,
                            h, w, c, tx, ty)
                        if err:
                            raise RuntimeError(f"launch failed: {err}")
                    return go

                run(libs[0], False)(0)
                want, want_tap = launch_pool_fwd(x, True, "window")
                if not (torch.equal(y.view(torch.uint8),
                                    want.view(torch.uint8))
                        and torch.equal(tap, want_tap)):
                    raise AssertionError("the full build differs from the "
                                         "package's kernel")
                es = x.element_size()
                nbytes = (es * b * (h // 2 * 2) * (w // 2 * 2) * c
                          + y.numel() * es + tap.numel())
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                for cold in (False, True):
                    order = list(MASKS.items())
                    ms = {k: 0.0 for k in MASKS}
                    for name, m in order + order[::-1]:
                        ms[name] += graph_ms(run(libs[m], cold)) / 2
                    print(f"{str(dtype)[6:]} [{b},{h},{w},{c}] with tap, "
                          f"block {tx}x{ty}, "
                          f"{'HBM-cold' if cold else 'L2-warm'}: " + ", ".join(
                              f"{k} {v:.4f}" for k, v in ms.items())
                          + f" ms; bound {bound:.4f} ms, the full build at "
                          f"{bound / ms['full']:.3f} of it", flush=True)
                del copies
    return 0


if __name__ == "__main__":
    sys.exit(main())
