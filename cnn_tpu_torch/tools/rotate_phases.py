"""Where the tiled rotation kernel's time goes, phase by phase, on the card.

    python -m cnn_tpu_torch.tools.rotate_phases

Compiles ``csrc/rotate.cu`` once as built and once for each mask of
``ROTATE_SKIP_PHASES`` (bit 1 skips T1, 2 the second shear, 4 the output;
7 leaves the set-up alone), side by side, and times each build with CUDA
events at [256,256,256,3] on the plan's tiles, in float32 and bf16, on the
smoke's angles (0, +-15, +-44, +-46, +-75 degrees, the rest random in +-75)
and on all-equal angles of 0, 30 and 75 degrees. A phase's time is the
set-up-only build's time subtracted from the time of the build that runs
that phase alone. The builds that skip a phase compute wrong results and
serve only for timing; the full build is checked bit for bit against the
plain version. The previous design (``cnn_rotate_shear_direct``) and a copy
of the canvas are timed in the same run. Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from cnn_tpu_torch.ops import augment as aug
from cnn_tpu_torch.ops.hopper import _build
from cnn_tpu_torch.ops.hopper.augment import rotate_tile_plan

MASKS = {"full": 0, "set-up": 7, "set-up + T1": 6, "set-up + T2": 5,
         "set-up + output": 3}
B, S, C = 256, 256, 3


def build(out_dir: Path) -> dict:
    """mask name -> the library built with that mask."""
    src = _build.CSRC / "rotate.cu"
    cmds = {name: [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                   f"-DROTATE_SKIP_PHASES={mask}", "-o",
                   str(out_dir / f"rotate_{mask}.so"), str(src)]
            for name, mask in MASKS.items()}
    _build._run_all(list(cmds.values()))
    libs = {}
    for name, mask in MASKS.items():
        lib = ctypes.CDLL(str(out_dir / f"rotate_{mask}.so"))
        for fn in ("cnn_rotate_shear", "cnn_rotate_shear_direct"):
            getattr(lib, fn).argtypes = [_build.P, *_build.SIGNATURES[fn]]
            getattr(lib, fn).restype = _build.I
        libs[name] = lib
    return libs


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def runner(lib, x, vecs, direct=False):
    g = aug.geometry(S, C)
    out = torch.empty_like(x)
    args = [torch.cuda.current_stream().cuda_stream, x.data_ptr(),
            *(v.data_ptr() for v in vecs), out.data_ptr(), B, S, C, g.lane,
            g.pad_l, int(x.dtype == torch.bfloat16)]
    if direct:
        fn = lib.cnn_rotate_shear_direct
    else:
        p = rotate_tile_plan(S, C, x.dtype)
        fn = lib.cnn_rotate_shear
        args += [p.rows, p.pixels, p.lanes_max, p.table_max, p.smem_bytes]

    def run():
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed with cudaError_t {err}")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("rotate_phases: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    fixed = torch.tensor([0, 15, -15, 44, -44, 46, -46, 75, -75],
                         dtype=torch.float32, device=dev)
    rand = (torch.rand(B - fixed.numel(), generator=gen, device=dev)
            * 2 - 1) * 75
    angles = {"smoke's angles": torch.deg2rad(torch.cat([fixed, rand]))}
    for deg in (0.0, 30.0, 75.0):
        angles[f"all {deg:g} deg"] = torch.full((B,), deg * torch.pi / 180,
                                                device=dev)
    x32 = torch.rand((B, S, S, C), generator=gen, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        for x in (x32, x32.bfloat16()):
            dt = "f32" if x.dtype == torch.float32 else "bf16"
            p = rotate_tile_plan(S, C, x.dtype)
            for what, theta in angles.items():
                vecs = [v.contiguous() for v in aug.shift_vectors(theta, S, C)]
                got = runner(libs["full"], x, vecs)()
                want = aug.rotate_core_plain(x, *vecs)
                view = torch.int32 if dt == "f32" else torch.int16
                if not torch.equal(got.view(view), want.view(view)):
                    raise AssertionError(f"{dt} {what}: the full build "
                                         "differs from the plain version")
                ms = {name: time_ms(runner(lib, x, vecs))
                      for name, lib in libs.items()}
                base = ms["set-up"]
                direct = time_ms(runner(libs["full"], x, vecs, direct=True))
                print(f"{dt} {p.rows}x{p.pixels} tiles, {what}: full "
                      f"{ms['full']:.4f} ms = set-up {base:.4f} + T1 "
                      f"{ms['set-up + T1'] - base:.4f} + T2 "
                      f"{ms['set-up + T2'] - base:.4f} + output "
                      f"{ms['set-up + output'] - base:.4f} (sum "
                      f"{ms['set-up + T1'] + ms['set-up + T2'] + ms['set-up + output'] - 2 * base:.4f}); "
                      f"previous design {direct:.4f}; copy of the canvas "
                      f"{time_ms(lambda: x.clone()):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
