#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for every float32 product and convolution;
2. build: one ``nvcc`` call compiles ``cnn_tpu_torch/csrc/*.cu`` for sm_90a;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the serving path's shapes with batch 64 (normalize and max-pool
   bit-exact, conv within atol 1e-5 + rtol 1e-5), timed with CUDA events
   beside the plain version, one PyTorch library call and the bound; then
   the branches those shapes do not take (conv with Cout 7 or with weights
   off 16-byte alignment, normalize of an odd length or a misaligned input);
4. serving: the full-width 224 px BatchNorm AlexNet from the committed
   reference ``.model`` behind ``InferenceEngine`` (buckets 1, 8, 64) and
   ``BatchingServer``; every kernel's launch count must move as the path
   dictates, and the results must match the same engine run on the plain
   versions on the card and on the CPU.

Every phase prints one flushed line with the seconds since start. Any failed
check raises, so the exit code is not 0. Without a CUDA device it exits 1
before printing any result. The line before the last is the kernel table as
JSON; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

import cnn_tpu_torch.nn.module as nn_module
import cnn_tpu_torch.serving as serving
from cnn_tpu_torch.models import get_model
from cnn_tpu_torch.nn import Conv2D, ReLU
from cnn_tpu_torch.ops.conv import conv2d, conv_out_size
from cnn_tpu_torch.ops.hopper import (_build, conv2d_bias_relu, max_pool2d_fwd,
                                      reset_launches, uint8_normalize)
from cnn_tpu_torch.ops.pool import max_pool2d, max_pool2d_taps
from cnn_tpu_torch.ops.preprocess import uint8_to_float
from cnn_tpu_torch.utils.checkpoint import load_reference_model

ROOT = Path(__file__).resolve().parent
MODEL = (ROOT / "checkpoints" / "alexnet_bn_device"
         / "iter_12000_train_0.997_valid_0.937.model")
BUCKETS = (1, 8, 64)
B = 64
# NVIDIA H100 SXM data sheet: HBM3 rate, and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
CONV_ATOL = CONV_RTOL = 1e-5
PROB_ATOL = 1e-5
LOGIT_ATOL = 1e-4   # the logit bar cnn_tpu holds against the reference
REPLACES = {
    "uint8_normalize": "cnn_tpu/ops/pallas/normalize.py:28",
    "max_pool2d_fwd": "cnn_tpu/ops/pallas/pool.py:61",
    "conv2d_bias_relu": "cnn_tpu/ops/pallas/conv.py:103",
}
SOURCES = {
    "uint8_normalize": "cnn_tpu_torch/csrc/normalize.cu",
    "max_pool2d_fwd": "cnn_tpu_torch/csrc/pool.cu",
    "conv2d_bias_relu": "cnn_tpu_torch/csrc/conv.cu",
}

T0 = time.perf_counter()


def phase(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls."""
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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def read_extent(n: int, k: int, s: int) -> int:
    """Rows (or columns) of an extent-``n`` input that a VALID k/s window
    reads: the rest are cropped and never leave device memory."""
    return (conv_out_size(n, k, s) - 1) * s + k


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a.view(torch.int32), b.view(torch.int32)))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def entry(name, launches, err, ms, plain, lib, bound) -> dict:
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib}


def synthetic_images(rng, n: int, size: int = 224) -> np.ndarray:
    """[n,size,size,3] uint8: 7x7 blocks of colour plus 25% pixel noise.

    Uniform noise alone drives the checkpoint's logits to +-200, where every
    softmax is exactly one-hot and probabilities compare nothing; these
    images give logits of tens and mixed labels."""
    lo = rng.integers(0, 256, (n, 7, 7, 3)).astype(np.float32)
    img = np.kron(lo, np.ones((1, size // 7, size // 7, 1), np.float32))
    img = 0.75 * img + 0.25 * rng.integers(0, 256, (n, size, size, 3))
    return img.astype(np.uint8)


def plain_versions():
    """Routes the engine's three kernel calls to their plain versions."""
    stack = ExitStack()
    stack.enter_context(mock.patch.object(nn_module, "conv2d_bias_relu",
                                          conv2d))
    stack.enter_context(mock.patch.object(nn_module, "max_pool2d_fwd",
                                          lambda x: max_pool2d(x)))
    stack.enter_context(mock.patch.object(serving, "uint8_normalize",
                                          uint8_to_float))
    return stack


def kernel_phase(model) -> dict:
    """Each kernel against its plain version at the serving shapes, B = 64."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}

    # normalize: every byte value against numpy's IEEE float32 division,
    # then a [64,224,224,3] batch bit for bit against the plain version
    every = torch.arange(256, dtype=torch.uint8, device=dev)
    want = np.arange(256, dtype=np.float32) / np.float32(255.0)
    check(np.array_equal(uint8_normalize(every).cpu().numpy().view(np.int32),
                         want.view(np.int32)), "normalize: not IEEE x/255")
    x = torch.randint(0, 256, (B, 224, 224, 3), generator=gen, device=dev,
                      dtype=torch.uint8)
    y, ref = uint8_normalize(x), uint8_to_float(x)
    check(bits_equal(y, ref), "normalize: differs from the plain version")
    err = (y - ref).abs().max().item()
    out["uint8_normalize"] = (
        err, time_ms(lambda: uint8_normalize(x)),
        time_ms(lambda: uint8_to_float(x)),
        time_ms(lambda: torch.true_divide(x, 255.0)),
        bound_ms(nbytes(x, y), x.numel()))
    phase(f"normalize [64,224,224,3] u8->f32: bit-exact; "
          f"ms={out['uint8_normalize'][1:4]}")

    # max pool: ReLU output quantized to quarters, so exact ties are common
    # (zeros and equal positives); value and tap index bit for bit
    x = torch.randn((B, 111, 111, 16), generator=gen, device=dev)
    x = torch.relu(torch.round(x * 4) / 4)
    (y, tap), (ref, ref_tap) = max_pool2d_fwd(x, with_tap=True), max_pool2d_taps(x)
    bsz, h, w_, c = x.shape
    check(bits_equal(y, ref), "max pool: value differs from the plain version")
    check(torch.equal(tap, ref_tap), "max pool: tap differs from the plain version")
    ties = (x[:, :110:2, :110:2] == x[:, :110:2, 1:110:2]).float().mean().item()
    y = max_pool2d_fwd(x)
    out["max_pool2d_fwd"] = (
        (y - ref).abs().max().item(), time_ms(lambda: max_pool2d_fwd(x)),
        time_ms(lambda: max_pool2d(x)),
        time_ms(lambda: F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)),
        bound_ms(4 * bsz * read_extent(h, 2, 2) * read_extent(w_, 2, 2) * c
                 + nbytes(y), 3 * y.numel()))
    phase(f"max pool [64,111,111,16] (tie share {ties:.3f}): value and tap "
          f"exact; ms={out['max_pool2d_fwd'][1:4]}")

    # conv: the four layers with the checkpoint's weights, ReLU off (the BN
    # path) and on (the fused path); times are for ReLU off, as served. The
    # row's bound is the sum of the layers' own bounds, labelled by the kind
    # that bounds the larger share of it.
    sums = [0.0, 0.0, 0.0, 0.0, 0.0]
    by = {"bytes": 0.0, "operations": 0.0}
    worst = 0.0
    h = 224
    for i, cin in enumerate((3, 16, 32, 64), start=1):
        layer = model.net[f"conv_layer_{i}"]
        w, b = layer.w.detach(), layer.b.detach()
        if i == 1:
            x = torch.rand((B, h, h, cin), generator=gen, device=dev)
        else:
            x = torch.relu(torch.randn((B, h, h, cin), generator=gen, device=dev))
        err = 0.0
        for relu in (False, True):
            y, ref = conv2d_bias_relu(x, w, b, 2, relu), conv2d(x, w, b, 2, relu)
            dev_ = (y - ref).abs()
            check(bool((dev_ <= CONV_ATOL + CONV_RTOL * ref.abs()).all()),
                  f"conv_layer_{i} relu={relu}: max deviation "
                  f"{dev_.max().item():.3g} over atol/rtol 1e-5")
            err = max(err, dev_.max().item())
        worst = max(worst, err)
        ho = conv_out_size(h, 3, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        ms = time_ms(lambda: conv2d_bias_relu(x, w, b, 2, False))
        ms_relu = time_ms(lambda: conv2d_bias_relu(x, w, b, 2, True))
        plain = time_ms(lambda: conv2d(x, w, b, 2, False))
        lib = time_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, 2))
        m = B * ho * ho
        flops = 2 * m * layer.out_channels * 9 * cin + m * layer.out_channels
        r = read_extent(h, 3, 2)
        bnd = bound_ms(4 * B * r * r * cin + nbytes(w, b, y), flops)
        for j, v in enumerate((ms, plain, lib, bnd[0], ms_relu)):
            sums[j] += v
        by[bnd[1]] += bnd[0]
        phase(f"conv_layer_{i} [{B},{h},{h},{cin}]->[{B},{ho},{ho},"
              f"{layer.out_channels}]: max|dev| {err:.3g}; ms={ms:.4f} "
              f"(relu {ms_relu:.4f}) plain={plain:.4f} library={lib:.4f} "
              f"bound={bnd[0]:.4f} ({bnd[1]})")
        h = ho if i > 1 else conv_out_size(ho, 2, 2)
    out["conv2d_bias_relu"] = (worst, sums[0], sums[1], sums[2],
                               (sums[3], max(by, key=by.get)))
    phase(f"conv, 4 layers per batch: ms={sums[0]:.4f} (relu {sums[4]:.4f}) "
          f"plain={sums[1]:.4f} library={sums[2]:.4f} bound={sums[3]:.4f} "
          f"(bytes {by['bytes']:.4f} + operations {by['operations']:.4f})")
    return out


def off_path_phase() -> None:
    """The kernels' branches that the serving shapes do not take, against
    the plain versions: conv's scalar path (Cout not a multiple of 4, or
    weights not 16-byte aligned) and normalize's scalar path (input not
    4-byte aligned) and its tail (a length that is no multiple of 4)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    x = torch.randn((4, 33, 20, 5), generator=gen, device=dev)
    w = torch.randn((3, 3, 5, 7), generator=gen, device=dev)
    b = torch.randn((7,), generator=gen, device=dev)
    cases.append(("Cout 7, stride 1", x, w, b, 1))
    x = torch.relu(torch.randn((4, 27, 27, 32), generator=gen, device=dev))
    buf = torch.randn((3 * 3 * 32 * 64 + 1,), generator=gen, device=dev)
    w = buf[1:].view(3, 3, 32, 64)   # contiguous, 4 bytes past 16-alignment
    check(w.is_contiguous() and w.data_ptr() % 16 != 0, "misaligned weights")
    b = torch.randn((64,), generator=gen, device=dev)
    cases.append(("weights off 16-byte alignment", x, w, b, 2))
    worst = 0.0
    for what, x, w, b, stride in cases:
        for relu in (False, True):
            y, ref = (conv2d_bias_relu(x, w, b, stride, relu),
                      conv2d(x, w, b, stride, relu))
            dev_ = (y - ref).abs()
            check(bool((dev_ <= CONV_ATOL + CONV_RTOL * ref.abs()).all()),
                  f"conv scalar path ({what}, relu={relu}): max deviation "
                  f"{dev_.max().item():.3g} over atol/rtol 1e-5")
            worst = max(worst, dev_.max().item())
    n = 1_000_003
    buf = torch.randint(0, 256, (n + 1,), generator=gen, device=dev,
                        dtype=torch.uint8)
    for what, x in (("odd length", buf[:n]), ("input off 4-byte alignment",
                                              buf[1:])):
        check(bits_equal(uint8_normalize(x), uint8_to_float(x)),
              f"normalize ({what}): differs from the plain version")
    phase(f"off the serving shapes: conv scalar path (Cout 7 at stride 1; "
          f"misaligned weights) max|dev| {worst:.3g}; normalize odd length "
          f"and misaligned input bit-exact")


def serving_phase(model) -> dict:
    """The serving path through all three kernels, with launch counts."""
    rng = np.random.default_rng(0)
    engine = serving.InferenceEngine(model, buckets=BUCKETS, device="cuda")
    engine.warmup()
    sizes = (1, 5, 64, 100)
    imgs = {n: synthetic_images(rng, n) for n in sizes}
    calls = sum(-(-n // BUCKETS[-1]) for n in sizes)   # 1 + 1 + 1 + 2

    reset_launches()
    results = {n: engine.predict(imgs[n]) for n in sizes}
    torch.cuda.synchronize()
    counts = [uint8_normalize.launches, max_pool2d_fwd.launches,
              conv2d_bias_relu.launches]
    check(counts == [calls, calls, 4 * calls],
          f"predict launches {counts}, expected {[calls, calls, 4 * calls]}")
    for n, (labels, probs) in results.items():
        check(labels.shape == (n,) and probs.shape == (n, 3), f"shape at {n}")
        check(bool(np.isfinite(probs).all()), f"non-finite probs at {n}")
        check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-5)), f"sum at {n}")
        check(bool((labels == probs.argmax(-1)).all()), f"argmax at {n}")

    with serving.BatchingServer(engine) as srv, ThreadPoolExecutor(16) as pool:
        futs = list(pool.map(srv.submit, imgs[64][:16]))
        answers = [f.result(timeout=120) for f in futs]
    torch.cuda.synchronize()
    launches = {"uint8_normalize": uint8_normalize.launches,
                "max_pool2d_fwd": max_pool2d_fwd.launches,
                "conv2d_bias_relu": conv2d_bias_relu.launches}
    served = launches["uint8_normalize"] - calls
    check(served >= 2 and launches["max_pool2d_fwd"] == calls + served
          and launches["conv2d_bias_relu"] == 4 * (calls + served),
          f"server launches {launches}")
    labels64, probs64 = results[64]
    for i, (label, probs) in enumerate(answers):
        check(label == labels64[i], f"server label {i}")
        check(bool(np.allclose(probs, probs64[i], rtol=0, atol=PROB_ATOL)),
              f"server probs {i}")
    phase(f"served {sum(sizes)} images in {calls} bucket calls and 16 "
          f"concurrent submits in {served} calls (incl. warmup); "
          f"launches {launches}")

    # the same engine on the plain versions, on the card: no kernel may run
    x = torch.from_numpy(imgs[64]).cuda()
    with torch.inference_mode():
        logits = engine.model(uint8_normalize(x))
    reset_launches()
    with plain_versions(), torch.inference_mode():
        plain = {n: engine.predict(imgs[n]) for n in sizes}
        plain_logits = engine.model(uint8_to_float(x))
    check([f.launches for f in (uint8_normalize, max_pool2d_fwd,
                                conv2d_bias_relu)] == [0, 0, 0],
          "the plain run launched a kernel")
    worst = 0.0
    for n in sizes:
        check(np.array_equal(results[n][0], plain[n][0]), f"labels at {n}")
        worst = max(worst, float(np.abs(results[n][1] - plain[n][1]).max()))
    check(worst <= PROB_ATOL, f"probs vs plain on the card: {worst:.3g}")
    logit_dev = (logits - plain_logits).abs().max().item()
    check(logit_dev <= LOGIT_ATOL, f"logits vs plain on the card: {logit_dev:.3g}")

    # and the plain versions on the CPU, on 5 images
    cpu = get_model("alexnet", num_classes=3, batch_norm=True, image_size=224,
                    device="cpu")
    load_reference_model(cpu, MODEL)
    cl, cp = serving.InferenceEngine(cpu, buckets=BUCKETS,
                                     device="cpu").predict(imgs[5])
    cpu_dev = float(np.abs(cp - results[5][1]).max())
    check(np.array_equal(cl, results[5][0]) and cpu_dev <= PROB_ATOL,
          f"probs vs the CPU: {cpu_dev:.3g}")
    phase(f"probs max|dev| vs plain on the card {worst:.3g}, vs the CPU "
          f"{cpu_dev:.3g} (atol {PROB_ATOL}); labels equal; logits at bucket "
          f"64 (|logit| <= {logits.abs().max().item():.1f}) max|dev| vs plain "
          f"{logit_dev:.3g} (atol {LOGIT_ATOL}); labels "
          f"{np.bincount(results[100][0], minlength=3).tolist()} over 100")

    # throughput at bucket 64: end to end (host arrays in, host arrays out)
    # and the device time of one bucket's forward
    engine.predict(imgs[64])
    torch.cuda.synchronize()
    t = time.perf_counter()
    reps = 20
    for _ in range(reps):
        engine.predict(imgs[64])
    e2e = reps * 64 / (time.perf_counter() - t)
    with torch.inference_mode():
        fwd = time_ms(lambda: engine.model(uint8_normalize(x)))
        split = layer_times(engine.model, uint8_normalize(x))
    phase(f"bucket 64: {e2e:.1f} img/s end to end; device forward "
          f"{fwd:.4f} ms = {64e3 / fwd:.1f} img/s; per layer (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return launches


def layer_times(model, x) -> dict:
    """Device ms of each step of the model's eval forward, fused conv+ReLU
    counted under the conv's name, as ``Sequential.forward`` runs them."""
    layers, out, i = list(model.net), {}, 0
    while i < len(layers):
        fuse = (isinstance(layers[i], Conv2D) and i + 1 < len(layers)
                and isinstance(layers[i + 1], ReLU))
        step = (lambda l=layers[i], x=x: l(x, relu=True)) if fuse else \
            (lambda l=layers[i], x=x: l(x))
        out[layers[i].name] = time_ms(step)
        x = step()
        i += 2 if fuse else 1
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(f"environment: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; TF32 off")

    _build.load()
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln]
    phase(f"build: {_build.library_path()} "
          + (f"built in {_build.build_seconds:.1f}s; " + " | ".join(regs)
             if _build.build_seconds is not None else "(already built)"))

    model = get_model("alexnet", num_classes=3, batch_norm=True,
                      image_size=224, device="cuda")
    load_reference_model(model, MODEL)
    model.eval()
    measured = kernel_phase(model)
    off_path_phase()
    launches = serving_phase(model)

    kernels = [entry(name, launches[name], *measured[name])
               for name in ("uint8_normalize", "max_pool2d_fwd",
                            "conv2d_bias_relu")]
    phase("all checks passed")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
