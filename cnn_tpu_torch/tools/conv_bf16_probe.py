"""Where the bf16 wgmma and tma conv kernels' time goes, and the float32
pointwise kernel's, on the card.

    python -m cnn_tpu_torch.tools.conv_bf16_probe

Compiles ``csrc/conv.cu`` once as built and once for each mask of
``CONV_WG_PROBE`` (bit 1 skips the wgmmas, 2 the copies of A, 4 the copies
of B, 7 all three: what is left is the block's skeleton; bit 8 copies the
wgmma kernel's B through L2 only, ``cp.async.cg``, instead of through L1),
side by side, and times each build with the plan's tile: the wgmma
kernel on conv2-4 of the AlexNet at batch 256 and 64, the tma kernel on
PipeCNN's padded 3x3 trunk conv and MobileNet's 1x1 pw_2 at B = 64 and on
AlexNet's conv4 at batch 256 and 64. Each time: 20 launches captured into
one CUDA graph, one replay timed with CUDA events. The builds
that skip work compute wrong results and serve only for timing; the full
build is held bit for bit to the package's kernel. Each line also gives
the bytes the blocks copy into shared memory (A's im2col rows and B's
weights, per block, padding included) and that rate per SM the grid
occupies. The pointwise kernel likewise, for each mask of ``CONV_PW_PROBE``
(bit 1 skips the FMAs and their shared-memory reads, 2 the copies of A, 4
the stores of the output tiles, 7 all three), at MobileNet's pw_1, pw_2,
pw_3 and pw_6 and resnet18's 32 -> 64 projection at B = 64, with the
plan's tile. Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from cnn_tpu_torch.ops.conv import conv_out_size
from cnn_tpu_torch.ops.hopper import _build
from cnn_tpu_torch.ops.hopper.conv import (BF16_VARIANTS, H100_SMS,
                                           PW_TILES, TMA_TILES, WGMMA_TILES,
                                           conv2d_bias_relu, conv_bf16_plan,
                                           conv_tile_plan, launch_conv_bf16)

MASKS = {"full": 0, "no wgmma": 1, "no A copies": 2, "no B copies": 4,
         "no copies": 6, "no copies, no wgmma": 7, "B through L2": 8}
# (variant, B, H, Cin, Cout, k, stride, pad)
SHAPES = tuple(("wgmma", b, h, cin, cout, 3, 2, 0) for b in (256, 64)
               for cin, cout, h in ((16, 32, 55), (32, 64, 27),
                                    (64, 128, 13))) + (
    ("tma", 64, 56, 64, 64, 3, 1, 1), ("tma", 64, 56, 64, 128, 1, 1, 0),
    ("tma", 256, 13, 64, 128, 3, 2, 0), ("tma", 64, 13, 64, 128, 3, 2, 0))
ENTRY = "cnn_conv2d_bias_relu_bf16"
PW_MASKS = {"full": 0, "no FMAs": 1, "no A copies": 2, "no stores": 4,
            "skeleton": 7}
# (B, H, Cin, Cout, stride) of the pointwise kernel's shapes
PW_SHAPES = ((64, 112, 32, 64, 1), (64, 56, 64, 128, 1),
             (64, 56, 128, 128, 1), (64, 14, 256, 512, 1),
             (64, 112, 32, 64, 2))
PW_ENTRY = "cnn_conv2d_bias_relu_pw"


def build(out_dir: Path) -> dict:
    """(macro, mask) -> the library built with that mask of that macro
    (``CONV_WG_PROBE`` or ``CONV_PW_PROBE``; mask 0 is the one build as it
    ships)."""
    src = _build.CSRC / "conv.cu"
    keys = sorted({("CONV_WG_PROBE", m) for m in MASKS.values()}
                  | {("CONV_PW_PROBE", m) for m in PW_MASKS.values() if m})
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                      f"-D{macro}={m}", "-o",
                      str(out_dir / f"conv_{macro}_{m}.so"), str(src)]
                     for macro, m in keys])
    libs = {}
    for macro, m in keys:
        lib = ctypes.CDLL(str(out_dir / f"conv_{macro}_{m}.so"))
        for entry in (ENTRY, PW_ENTRY):
            getattr(lib, entry).argtypes = [_build.P,
                                            *_build.SIGNATURES[entry]]
            getattr(lib, entry).restype = _build.I
        libs[macro, m] = lib
    libs["CONV_PW_PROBE", 0] = libs["CONV_WG_PROBE", 0]
    return libs


def pw_lines(libs: dict, gen) -> None:
    """The pointwise kernel at ``PW_SHAPES``, each build of
    ``PW_MASKS``."""
    dev = torch.device("cuda")
    for bsz, h, cin, cout, s in PW_SHAPES:
        x = torch.relu(torch.randn((bsz, h, h, cin), generator=gen,
                                   device=dev))
        w = torch.randn((1, 1, cin, cout), generator=gen, device=dev) * 0.1
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        plan = conv_tile_plan(bsz, h, h, cin, cout, 1, s, True)
        if plan.variant != "pw":
            raise AssertionError(f"{x.shape} -> {cout}: planned {plan}")
        ho = conv_out_size(h, 1, s)
        y = torch.empty((bsz, ho, ho, cout), device=dev)
        args = [x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz,
                h, h, cin, cout, 1, s, 0, 0, plan.tile, plan.grid[0]]

        def run(lib):
            def go():
                err = getattr(lib, PW_ENTRY)(
                    torch.cuda.current_stream().cuda_stream, *args)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            return go

        run(libs["CONV_PW_PROBE", 0])()
        want = conv2d_bias_relu(x, w, b, s, False)
        if not torch.equal(y.view(torch.int32), want.view(torch.int32)):
            raise AssertionError("the full build differs from the "
                                 "package's kernel")
        ms = {name: graph_ms(run(libs["CONV_PW_PROBE", m]))
              for name, m in PW_MASKS.items()}
        tiles = -(-bsz * ho * ho // PW_TILES[plan.tile][0]) * plan.grid[1]
        print(f"B={bsz} {h}x{h}x{cin}->{cout} s{s} pw, tile "
              f"{'x'.join(map(str, PW_TILES[plan.tile]))}, grid "
              f"{plan.grid}, {tiles} tiles: " + ", ".join(
                  f"{k_} {v:.4f}" for k_, v in ms.items()) + " ms",
              flush=True)


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()``: ``iters`` calls in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
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
        print("conv_bf16_probe: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for variant, bsz, h, cin, cout, k, s, p in SHAPES:
            x = torch.relu(torch.randn((bsz, h, h, cin), generator=gen,
                                       device=dev)).bfloat16()
            w = (torch.randn((k, k, cin, cout), generator=gen,
                             device=dev) * 0.1).bfloat16()
            b = (torch.randn((cout,), generator=gen, device=dev)
                 * 0.1).bfloat16()
            plan = conv_bf16_plan(bsz, h, h, cin, cout, k, s, True, variant,
                                  p)
            ho = conv_out_size(h, k, s, p)
            y = torch.empty((bsz, ho, ho, cout), dtype=torch.bfloat16,
                            device=dev)
            args = [x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                    bsz, h, h, cin, cout, k, s, p, 0,
                    BF16_VARIANTS.index(variant), plan.tile]

            def run(lib):
                def go():
                    err = getattr(lib, ENTRY)(
                        torch.cuda.current_stream().cuda_stream, *args)
                    if err:
                        raise RuntimeError(f"launch failed: {err}")
                return go

            run(libs["CONV_WG_PROBE", 0])()
            with torch.no_grad():
                want = launch_conv_bf16(x, w, b, s, False, variant=variant,
                                        padding=p)[0]
            if not torch.equal(y.view(torch.int16), want.view(torch.int16)):
                raise AssertionError("the full build differs from the "
                                     "package's kernel")
            masks = {k_: m for k_, m in MASKS.items()
                     if variant == "wgmma" or m != 8}
            ms = {name: graph_ms(run(libs["CONV_WG_PROBE", m]))
                  for name, m in masks.items()}
            table = WGMMA_TILES if variant == "wgmma" else TMA_TILES
            blocks = plan.grid[0] * plan.grid[1]
            copied = blocks * 2 * plan.k_pad * (plan.bm + plan.bn)
            sms = min(blocks, H100_SMS)
            print(f"B={bsz} {h}x{h}x{cin}->{cout} k{k} s{s} p{p} {variant}, "
                  f"tile {'x'.join(map(str, table[plan.tile]))}, "
                  f"{blocks} blocks: " + ", ".join(
                      f"{k_} {v:.4f}" for k_, v in ms.items())
                  + f" ms; {copied / 1e6:.1f} MB copied into shared "
                  f"memory, {copied / ms['full'] / 1e6 / sms:.1f} GB/s "
                  f"an SM over {sms} SMs", flush=True)
        pw_lines(libs, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
