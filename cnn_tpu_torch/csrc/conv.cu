// k x k convolution + bias (+ ReLU), NHWC / HWIO, for Hopper: four
// float32 kernels, chosen by shape in ops/hopper/conv.py:conv_tile_plan (the
// direct, tiled and strip kernels here, the pointwise kernel in the last
// section), and four bf16 tensor-core kernels behind one entry point (the
// mma.sync kernel, the strip, the wgmma and the tma kernel), planned by
// ops/hopper/conv.py:conv_bf16_plan.
//
// Replaces: cnn_tpu/ops/pallas/conv.py, conv2d_bias_relu_pallas -> _forward
// (kernel body _conv_kernel): k*k shifted [Ho*Wo, Cin] x [Cin, Cout]
// products summed in f32, then + bias, then an optional ReLU, any stride,
// output extent (H + 2*pad - k) / stride + 1. The Pallas kernel is VALID
// only; cnn_tpu's padded convs (the ResNet, VGG, MobileNet and PipeCNN
// families: pad 1 at k 3) run through XLA, and here through these kernels:
// every entry point takes the zero padding `pad`, and a tap that falls in
// it reads zero (the direct kernel skips it, the others zero-fill its
// copy: the same sum, since a zero product leaves a float32 sum as it is).
// The strip kernels stage whole input rows, with zero margins and zero rows
// for the padding.
//
// All four are implicit GEMMs: M = B*Ho*Wo output pixels, N = Cout,
// K = k*k*Cin in (dy, dx, ci) order, in which the HWIO weights are already a
// row-major [K, N] matrix. No TF32 and no tensor cores: every sum is a chain
// of full float32 FMAs in k order, one thread per output, as the 1e-5 parity
// with the plain version and JAX's Precision.HIGHEST need. No split-K and no
// atomics, so a launch is bit-identical to the next, and the four kernels
// sum in the same order: on the same inputs they give the same bits.
//
// Bound on this card: on the AlexNet shapes, bytes for conv1 (Cin = 3, so
// K = 27 multiply-adds per output) and float32 operations for conv2-4
// (K = 144..576, 67 TFLOP/s).
//
// The strip kernel (conv1 and the families' padded Cin-3 stems: Cin <= 4,
// Cout % 4 == 0 and, in the plan, <= 64, W*Cin % 4 == 0, x 16-byte
// aligned). The direct kernel below holds conv1 to 5x its byte
// bound: it is bound by instruction issue, not bytes. Each of its threads
// decodes its position with 64-bit divisions (emulated in software), issues
// 27 unaligned 4-byte input loads (repeated by the three other threads of
// its pixel at Cout = 16) and 27 16-byte weight loads for 108 FMAs. The
// strip kernel removes that work:
//  - one block per strip of R output rows of one image (blockIdx.x the
//    strip, blockIdx.y the image: no division). The block copies the
//    (R-1)*s + k input rows its strip reads, whole, into shared memory with
//    16-byte cp.async, coalesced across the block: rows of one image are
//    contiguous in NHWC and W*Cin % 4 == 0 keeps every row 16-byte aligned.
//    At stride 2 a strip shares one row with the next, so x is read
//    (2R+1)/2R times. The weights and bias (1,792 B for conv1) are staged
//    beside them once per block. Padded (kPad, a template argument, so
//    that AlexNet's conv1 keeps the contiguous copy): the rows start at
//    oy0*s - p; each staged row gets a zero margin of p*Cin floats on each
//    side, rounded up to 16 bytes so that the image's floats stay 16-byte
//    aligned for the copies (the read index carries the shift); margins
//    and rows outside the image are zero-filled copies (cp.async with a
//    source size of 0). A tap in the padding then adds fmaf(0, w, acc) =
//    acc, where the direct kernel skips it: the same bits for finite
//    weights, in the same (dy, dx, ci) order.
//  - one warp per output row. Lane l owns pixels l, l+32, l+64 and l+96 of
//    a 128-pixel chunk of the row and 16 output channels of each (64
//    accumulators; wider Cout takes more passes over the chunk). Lanes sit
//    on neighbouring pixels, so their shared-memory reads of one tap are
//    s*Cin words apart (6 for conv1: a 2-way bank conflict at most; four
//    adjacent pixels a lane would put 24 words between lanes, 8-way). Each
//    weight read is a warp-wide broadcast of 16 bytes that feeds 4 pixels
//    x 4 FMAs; each input value read feeds 16 FMAs. Index math is 32-bit
//    except for the base pointers.
//  - epilogue: bias, the optional ReLU, then one slot's 32 pixels through
//    a per-warp staging area (20 floats a pixel), stored as 16-byte chunks
//    in pixel order: four lanes on one pixel's 64 contiguous bytes, so that
//    each store fills whole 32-byte sectors. A lane's own 16-byte stores,
//    Cout*4 bytes apart, filled half-sectors, and held the strip to about
//    0.75 TB/s of output at every Cout (on the H100, at the families'
//    padded stems).
//  - R is a template argument; the entry point's switch maps ids to R in
//    the order of STRIP_ROWS in ops/hopper/conv.py, whose plan takes the R
//    with the most blocks (a block stages all its rows before it sums, so
//    more, shorter blocks on an SM overlap staging with sums better) and
//    checks that the staged rows, the weights and the output staging fit
//    in 96 KB of dynamic shared memory (the launch sets the attribute past
//    48 KB).
//
// The tiled kernel (conv2-4: Cin % 8 == 0, Cout % 4 == 0, x and w 16-byte
// aligned). The direct kernel feeds 4 FMAs from each 4-byte input load
// and each 16-byte weight load, about 0.2 FMA per byte through L1, so the
// load/store units and not the FMA pipes set its pace, and every weight is
// fetched again for every pixel (conv4's 295 KB of weights from L2). The
// tiled kernel is a register-tiled GEMM over shared memory:
//  - a block computes a BM x BN output tile; K goes in slices of BK = 8,
//    which never straddle a tap since Cin % 8 == 0, so the slice of A row m
//    (pixel b, oy, ox) is 8 contiguous floats of x at
//    ((b*H + oy*s + dy)*W + ox*s + dx)*Cin + ci0: two 16-byte cp.async. The
//    int64 base of each row the thread loads is computed once, before the
//    K loop; a slice adds one scalar offset, walked from slice to slice
//    with no division. Rows past M are zero-filled (cp.async with a source
//    size of 0), as are columns past Cout.
//  - three stages of A and B slices in shared memory (cp.async, commit and
//    wait groups), so two slices are in flight while one is multiplied.
//  - each thread holds a TM x TN micro-tile in registers: rows tm + i*BM/TM
//    and column groups of 4 at tn*4 + g*BN/(TN/4), so the threads of a warp
//    read consecutive 16-byte words of A (row stride padded to 12 floats)
//    and of B, free of bank conflicts. Each 16-byte read of A feeds 4*TN
//    FMAs and each of B 4*TM: every loaded value is used BM or BN times
//    per block instead of 4.
//  - epilogue: bias, the optional ReLU, 16-byte stores masked at the M and
//    N tails: the activation still makes one trip to device memory.
//  - the tile (BM, BN, TM, TN) is a template argument; the entry point's
//    switch maps tile ids to the variants in the order of TILES in
//    ops/hopper/conv.py, whose plan picks one per shape (about two or more
//    waves of 132 SMs where M allows). Static shared memory stays under
//    48 KB.
//
// The direct kernel (Cout 7, misaligned pointers, rows of W*Cin floats that
// are no multiple of 4, anything else neither of the others takes): a
// direct implicit GEMM with no staging. Each thread owns one output pixel
// and four neighbouring output channels, so one input load feeds four FMAs
// and the four weights come in one 16-byte load. Neighbouring threads take
// neighbouring channel groups of the same pixel, then the next pixel: the
// weight loads of a warp are one contiguous run (shared by every pixel of
// the warp), its input loads are broadcast, and its stores are one
// contiguous run. Weights are read through the read-only cache. Bias and
// ReLU are applied before the one store. It is the reference the other two
// are held to bit for bit on the card.
//
// Tests. On the CPU, the plan and a torch emulation of the strip walk,
// held against the plain conv and the Pallas kernel in interpret mode:
//   JAX_PLATFORMS=cpu python -m pytest -q (one command)
//       tests/test_torch_conv_plan.py tests/test_torch_ops.py
// On the card, python3 chip_smoke.py builds the four kernels and holds
// each against the plain conv, and the strip, tiled and pointwise kernels
// bit for bit against the direct one.
#include <cstdint>
#include <cuda.h>   // CUtensorMap and its enums: the encoders are looked
                    // up at run time (tma_maps), no link to libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCoPerThread = 4;

// Zero padding: output pixel (oy, ox) reads input rows oy*s - pad + dy and
// columns ox*s - pad + dx, and a tap outside the image reads zero. Every
// kernel takes pad in [0, kPadMax] on images of at most kExtentMax rows and
// columns, so that the shared-memory kernels can pack a row's first input
// row and column into one int (pack_yx) and the strips' margins stay
// small.
constexpr int kPadMax = 16;
constexpr int kExtentMax = 16384;

__host__ __device__ inline bool pad_ok(int H, int W, int k, int pad) {
  return pad >= 0 && pad <= kPadMax && H <= kExtentMax && W <= kExtentMax &&
         H + 2 * pad >= k && W + 2 * pad >= k;
}

// (iy0 + kPadMax) << 16 | (ix0 + kPadMax) for the input row iy0 = oy*s -
// pad and column ix0 = ox*s - pad of an output pixel; kRowPastM for a row
// past M, whose every tap lies outside (tap_inside)
constexpr int kRowPastM = 0x7FFF0000;
__device__ __forceinline__ int pack_yx(int oy, int ox, int s, int pad) {
  return (oy * s - pad + kPadMax) << 16 | (ox * s - pad + kPadMax);
}
__device__ __forceinline__ bool tap_inside(int yx, int dy, int dx, int H,
                                           int W) {
  const int iy = (yx >> 16) - kPadMax + dy;
  const int ix = (yx & 0xFFFF) - kPadMax + dx;
  return (unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W;
}

template <bool kVec>
__global__ void conv2d_bias_relu_kernel(const float* __restrict__ x,
                                        const float* __restrict__ w,
                                        const float* __restrict__ bias,
                                        float* __restrict__ y, int B, int H,
                                        int W, int Cin, int Cout, int k, int s,
                                        int p, int Ho, int Wo, bool relu) {
  const int G = (Cout + kCoPerThread - 1) / kCoPerThread;
  const int64_t total = (int64_t)B * Ho * Wo * G;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += step) {
    const int co0 = (int)(idx % G) * kCoPerThread;
    const int64_t pix = idx / G;
    const int ox = (int)(pix % Wo);
    int64_t t = pix / Wo;
    const int oy = (int)(t % Ho);
    const int64_t b = t / Ho;
    float acc[kCoPerThread] = {0.f, 0.f, 0.f, 0.f};
    for (int dy = 0; dy < k; ++dy) {
      const int iy = oy * s + dy - p;   // a tap in the padding adds nothing
      if (iy < 0 || iy >= H) continue;
      for (int dx = 0; dx < k; ++dx) {
        const int ix = ox * s + dx - p;
        if (ix < 0 || ix >= W) continue;
        const float* xp = x + ((b * H + iy) * W + ix) * (int64_t)Cin;
        const float* wp = w + (int64_t)(dy * k + dx) * Cin * Cout + co0;
        for (int ci = 0; ci < Cin; ++ci) {
          const float xv = __ldg(xp + ci);
          if (kVec) {
            const float4 wv =
                __ldg(reinterpret_cast<const float4*>(wp + (int64_t)ci * Cout));
            acc[0] = fmaf(xv, wv.x, acc[0]);
            acc[1] = fmaf(xv, wv.y, acc[1]);
            acc[2] = fmaf(xv, wv.z, acc[2]);
            acc[3] = fmaf(xv, wv.w, acc[3]);
          } else {
#pragma unroll
            for (int j = 0; j < kCoPerThread; ++j)
              if (co0 + j < Cout)
                acc[j] = fmaf(xv, __ldg(wp + (int64_t)ci * Cout + j), acc[j]);
          }
        }
      }
    }
    float* yp = y + pix * Cout + co0;
#pragma unroll
    for (int j = 0; j < kCoPerThread; ++j) {
      if (kVec || co0 + j < Cout) {
        float v = acc[j] + __ldg(bias + co0 + j);
        acc[j] = relu ? (v > 0.f ? v : 0.f) : v;
      }
    }
    if (kVec) {
      *reinterpret_cast<float4*>(yp) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      for (int j = 0; j < kCoPerThread; ++j)
        if (co0 + j < Cout) yp[j] = acc[j];
    }
  }
}

}  // namespace

extern "C" int cnn_conv2d_bias_relu(void* stream, const void* x, const void* w,
                                    const void* b, void* y, int B, int H, int W,
                                    int Cin, int Cout, int k, int stride,
                                    int pad, int relu) {
  if (!pad_ok(H, W, k, pad)) return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * pad - k) / stride + 1;
  const int Wo = (W + 2 * pad - k) / stride + 1;
  const int G = (Cout + kCoPerThread - 1) / kCoPerThread;
  const int64_t total = (int64_t)B * Ho * Wo * G;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  const bool vec = Cout % kCoPerThread == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  if (vec)
    conv2d_bias_relu_kernel<true><<<(unsigned)blocks, threads, 0,
                                    (cudaStream_t)stream>>>(
        xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, pad, Ho, Wo, relu != 0);
  else
    conv2d_bias_relu_kernel<false><<<(unsigned)blocks, threads, 0,
                                     (cudaStream_t)stream>>>(
        xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, pad, Ho, Wo, relu != 0);
  return (int)cudaGetLastError();
}

namespace {

constexpr int kBK = 8;       // K slice: within one tap, as Cin % 8 == 0
constexpr int kBKPad = 12;   // A row stride in shared memory (floats)
constexpr int kStages = 3;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    conv2d_tiled_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ y, int H, int W, int Cin,
                        int Cout, int k, int s, int p, int Ho, int Wo, int M,
                        bool relu) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kAChunks = BM * kBK / 4;   // 16-byte chunks per A slice
  constexpr int kBChunks = kBK * BN / 4;
  constexpr int kAIters = (kAChunks + kThreads - 1) / kThreads;
  constexpr int kBIters = (kBChunks + kThreads - 1) / kThreads;
  constexpr int kGroups = TN / 4;          // column groups of 4 per thread
  constexpr int kGroupStride = BN / kGroups;
  static_assert(BM % TM == 0 && BN % TN == 0 && TN % 4 == 0 && TM >= 1,
                "tile");
  static_assert(kStages * (BM * kBKPad + kBK * BN) * 4 <= 48 * 1024,
                "static shared memory");

  __shared__ __align__(16) float sa[kStages][BM * kBKPad];
  __shared__ __align__(16) float sb[kStages][kBK * BN];

  const int tid = threadIdx.x;
  const int tn = tid % (BN / TN);
  const int tm = tid / (BN / TN);
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the rows this thread copies: their int64 bases in x (the pixel at
  // their first tap, which may lie in the padding) and that pixel's row
  // and column (pack_yx; kRowPastM past M)
  int64_t a_base[kAIters];
  int a_yx[kAIters];
#pragma unroll
  for (int i = 0; i < kAIters; ++i) {
    const int c = tid + i * kThreads;
    const int m = m0 + c / 2;
    const bool valid = c < kAChunks && m < M;
    const int mm = valid ? m : 0;
    const int ox = mm % Wo;
    const int t = mm / Wo;
    const int oy = t % Ho;
    const int64_t b = t / Ho;
    a_base[i] = ((b * H + (int64_t)oy * s - p) * W + (int64_t)ox * s - p) *
                    Cin + (c % 2) * 4;
    a_yx[i] = valid ? pack_yx(oy, ox, s, p) : kRowPastM;
  }

  // slices are loaded in k order: the offset of slice kt in x,
  // (dy*W + dx)*Cin + ci0, grows by 8 within a row of taps (the next dx
  // starts where the last one's channels end) and jumps by (W - k)*Cin to
  // the next dy; a row's slice whose tap lies in the padding is zero-filled
  int64_t koff = 0;
  int tdy = 0, tdx = 0, tci = 0;   // the slice's tap and first channel
  auto load_slice = [&](int buf, int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kAIters; ++i) {
      const int c = tid + i * kThreads;
      if (c < kAChunks) {
        const bool ok = tap_inside(a_yx[i], tdy, tdx, H, W);
        cp_async16(&sa[buf][(c / 2) * kBKPad + (c % 2) * 4],
                   ok ? x + a_base[i] + koff : x, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < kBIters; ++i) {
      const int c = tid + i * kThreads;
      if (c >= kBChunks) break;
      const int r = c / (BN / 4);
      const int n = n0 + (c % (BN / 4)) * 4;
      const bool ok = n < Cout;
      cp_async16(&sb[buf][r * BN + (c % (BN / 4)) * 4],
                 ok ? w + (int64_t)(k0 + r) * Cout + n : w, ok);
    }
    koff += kBK;
    if ((tci += kBK) == Cin) {
      tci = 0;
      if (++tdx == k) {
        tdx = 0;
        ++tdy;
        koff += (int64_t)(W - k) * Cin;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int KT = k * k * Cin / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < KT) load_slice(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();   // slice kt has landed (this thread's)
    __syncthreads();                // ... every thread's; slice kt-1 is read
    const int next = kt + kStages - 1;
    if (next < KT) load_slice(next % kStages, next);
    cp_async_commit();

    const float* As = sa[kt % kStages];
    const float* Bs = sb[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            &As[(tm + i * (BM / TM)) * kBKPad + kk]);
        a[i][0] = v.x;
        a[i][1] = v.y;
        a[i][2] = v.z;
        a[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float bv[TN];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              &Bs[(kk + q) * BN + g * kGroupStride + tn * 4]);
          bv[g * 4 + 0] = v.x;
          bv[g * 4 + 1] = v.y;
          bv[g * 4 + 2] = v.z;
          bv[g * 4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(a[i][q], bv[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();   // only empty groups can be pending here

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + i * (BM / TM);
    if (m >= M) continue;
    float* yrow = y + (int64_t)m * Cout;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int n = n0 + g * kGroupStride + tn * 4;
      if (n >= Cout) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = acc[i][g * 4 + j] + __ldg(bias + n + j);
        v[j] = relu ? (t > 0.f ? t : 0.f) : t;
      }
      *reinterpret_cast<float4*>(yrow + n) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_tiled(cudaStream_t stream, const float* x, const float* w,
                         const float* b, float* y, int B, int H, int W,
                         int Cin, int Cout, int k, int s, int p, bool relu) {
  const int Ho = (H + 2 * p - k) / s + 1, Wo = (W + 2 * p - k) / s + 1;
  const int M = B * Ho * Wo;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv2d_tiled_kernel<BM, BN, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(x, w, b, y, H, W, Cin,
                                                   Cout, k, s, p, Ho, Wo, M,
                                                   relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cnn_conv2d_bias_relu_tiled(void* stream, const void* x,
                                          const void* w, const void* b,
                                          void* y, int B, int H, int W,
                                          int Cin, int Cout, int k,
                                          int stride, int pad, int relu,
                                          int tile) {
  if (Cin % kBK != 0 || Cout % 4 != 0 || !pad_ok(H, W, k, pad) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  const bool r = relu != 0;
  switch (tile) {
    case 0: return (int)launch_tiled<128, 128, 8, 8>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, pad, r);
    case 1: return (int)launch_tiled<64, 128, 8, 8>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, pad, r);
    case 2: return (int)launch_tiled<128, 64, 8, 8>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, pad, r);
    case 3: return (int)launch_tiled<64, 64, 8, 4>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, pad, r);
    case 4: return (int)launch_tiled<128, 32, 8, 4>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, pad, r);
    case 5: return (int)launch_tiled<64, 32, 4, 4>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, pad, r);
    default: return (int)cudaErrorInvalidValue;
  }
}


namespace {

constexpr int kStripSlots = 4;   // pixels a lane holds: l, l+32, l+64, l+96
constexpr int kStripCo = 16;     // output channels a lane holds at once
// a pixel of a warp's output staging: 16 channels and 4 floats of padding,
// so that a quarter-warp's 16-byte writes (lanes 20 words apart) miss each
// other's banks
constexpr int kStripYs = kStripCo + 4;
constexpr int kStripSmemMax = 96 * 1024;

// floats of shared memory before the staged rows: the weights as blocks of
// 16 output channels, [ceil(Cout/16)][K][16] (zero past Cout), so that a
// pass's weight reads sit at fixed offsets from one base; then the bias;
// rounded up to keep the rows 16-byte aligned
__host__ __device__ inline int strip_weight_floats(int k, int Cin, int Cout) {
  return ((Cout + kStripCo - 1) / kStripCo * kStripCo * k * k * Cin + Cout +
          3) / 4 * 4;
}

// a staged input row of a padded strip: a zero margin of p*Cin floats on
// each side of the image row, each rounded up to 16 bytes, so that the
// image's floats start 16-byte aligned (the copies stay 16-byte cp.async)
// and the read index carries the shift; p = 0 leaves the row as it is
__host__ __device__ inline int strip_margin_floats(int p, int Cin) {
  return (p * Cin + 3) / 4 * 4;
}
__host__ __device__ inline int strip_row_floats(int W, int Cin, int p) {
  return W * Cin + 2 * strip_margin_floats(p, Cin);
}
__host__ __device__ inline int strip_smem_floats(int rows, int k, int s,
                                                 int W, int Cin, int Cout,
                                                 int p) {
  return strip_weight_floats(k, Cin, Cout) +
         ((rows - 1) * s + k) * strip_row_floats(W, Cin, p) +
         (Cout > kStripCo ? rows * 32 * kStripYs : 0);   // output staging
}

// kPad: rows staged with zero margins and zero rows (the families' stems);
// k3: k = 3 and Cin = 3 known at compile time (AlexNet's conv1 and the
// stems), so that the 27 taps unroll with fixed shared-memory offsets
template <int R, bool kPad, bool k3>
__global__ void __launch_bounds__(R * 32)
    conv2d_strip_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ y, int H, int W, int Cin,
                        int Cout, int k, int s, int p, int Ho, int Wo,
                        bool relu) {
  extern __shared__ __align__(16) float smem[];
  const int kk = k3 ? 3 : k, cin = k3 ? 3 : Cin;
  const int K = kk * kk * cin;
  const int nwb = (Cout + kStripCo - 1) / kStripCo * kStripCo * K;
  float* sw = smem;                          // [Cout/16][K][16], then bias
  float* sx = smem + strip_weight_floats(kk, cin, Cout);
  const int oy0 = blockIdx.x * R;
  const int rows = min(R, Ho - oy0);
  const int b = blockIdx.y;
  const int rowlen = W * cin;   // floats of one input row, a multiple of 4
  const int nin = (rows - 1) * s + kk;   // input rows the strip reads
  // staged row stride; the offset of a row's padded column 0 from its start
  const int rs = kPad ? strip_row_floats(W, cin, p) : rowlen;
  const int shift = kPad ? strip_margin_floats(p, cin) - p * cin : 0;
  // the warps' output staging, past the staged rows of a full strip
  float* sy = sx + ((min(R, Ho) - 1) * s + kk) * rs;

  if (kPad) {
    // the rows oy0*s - p ... : a row outside the image, and each row's
    // margins, are zero-filled copies (cp.async with a source size of 0),
    // never rows of a neighbouring image; x is never padded in memory
    const int margin = strip_margin_floats(p, cin);
    const int n4 = rowlen / 4, m4 = margin / 4;   // 16-byte chunks
    const int iy0 = oy0 * s - p;
    const float* xb = x + (int64_t)b * H * rowlen;
    for (int i = threadIdx.x; i < nin * (n4 + 2 * m4); i += R * 32) {
      const int r = i / (n4 + 2 * m4), c = i - r * (n4 + 2 * m4);
      const int iy = iy0 + r;
      const bool inside = c >= m4 && c < m4 + n4 && (unsigned)iy < (unsigned)H;
      cp_async16(sx + r * rs + 4 * c,
                 inside ? xb + (int64_t)iy * rowlen + 4 * (c - m4) : x,
                 inside);
    }
  } else {
    // the strip's input rows: one contiguous run of x
    const int n4 = nin * rowlen / 4;
    const float4* src = reinterpret_cast<const float4*>(
        x + ((int64_t)b * H + (int64_t)oy0 * s) * rowlen);
    for (int i = threadIdx.x; i < n4; i += R * 32)
      cp_async16(sx + 4 * i, src + i, true);
  }
  cp_async_commit();
#pragma unroll 4
  for (int i = threadIdx.x; i < nwb + Cout; i += R * 32) {
    float v;
    if (i < nwb) {
      const int cb = i / (K * kStripCo), r = i - cb * K * kStripCo;
      const int co = cb * kStripCo + (r & (kStripCo - 1));
      v = co < Cout ? __ldg(w + (r / kStripCo) * Cout + co) : 0.f;
    } else {
      v = __ldg(bias + (i - nwb));
    }
    sw[i] = v;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= rows) return;   // the last strip of an image may be short
  // tap row dy = 0 at padded column 0: a tap in the padding reads a zero
  // of the margin, which adds an exact 0 to the sum (the direct kernel
  // skips it: the same bits for finite weights)
  const float* xrow = sx + warp * s * rs + shift;
  float* yrow = y + ((int64_t)b * Ho + oy0 + warp) * Wo * Cout;
  const float* sb = sw + nwb;
  float* sv = sy + warp * 32 * kStripYs;   // this warp's 32 pixels
  for (int c0 = 0; c0 < Wo; c0 += 32 * kStripSlots) {
    int base[kStripSlots];
#pragma unroll
    for (int j = 0; j < kStripSlots; ++j) {
      const int ox = c0 + 32 * j + lane;
      base[j] = (ox < Wo ? ox : 0) * s * cin;   // a masked slot reads pixel 0
    }
    for (int co0 = 0; co0 < Cout; co0 += kStripCo) {
      float acc[kStripSlots][kStripCo];
#pragma unroll
      for (int j = 0; j < kStripSlots; ++j)
#pragma unroll
        for (int c = 0; c < kStripCo; ++c) acc[j][c] = 0.f;
      // tap (dy*k + dx)*Cin + ci of this pass's block of 16 channels (the
      // block's columns past Cout are zero weights: sums never stored)
      const float* wp = sw + co0 * K;
#pragma unroll(k3 ? 3 : 1)
      for (int dy = 0; dy < kk; ++dy) {
        const float* xd = xrow + dy * rs;
#pragma unroll(k3 ? 3 : 1)
        for (int dx = 0; dx < kk; ++dx) {
#pragma unroll(k3 ? 3 : 1)
          for (int ci = 0; ci < cin; ++ci, wp += kStripCo) {
            float xv[kStripSlots];
#pragma unroll
            for (int j = 0; j < kStripSlots; ++j)
              xv[j] = xd[base[j] + dx * cin + ci];
#pragma unroll
            for (int g = 0; g < kStripCo / 4; ++g) {
              const float4 wv = *reinterpret_cast<const float4*>(wp + 4 * g);
#pragma unroll
              for (int j = 0; j < kStripSlots; ++j) {
                acc[j][4 * g + 0] = fmaf(xv[j], wv.x, acc[j][4 * g + 0]);
                acc[j][4 * g + 1] = fmaf(xv[j], wv.y, acc[j][4 * g + 1]);
                acc[j][4 * g + 2] = fmaf(xv[j], wv.z, acc[j][4 * g + 2]);
                acc[j][4 * g + 3] = fmaf(xv[j], wv.w, acc[j][4 * g + 3]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kStripSlots; ++j) {
        const int px0 = c0 + 32 * j;
        if (px0 >= Wo) break;
        float v[kStripCo];
#pragma unroll
        for (int c = 0; c < kStripCo; ++c) {
          const float t = acc[j][c] + (co0 + c < Cout ? sb[co0 + c] : 0.f);
          v[c] = relu ? (t > 0.f ? t : 0.f) : t;
        }
        if (Cout <= kStripCo) {
          // one pass: a lane's pixel is 16 contiguous floats of y, and the
          // warp's 4 stores of a slot cover 32 pixels, one contiguous run
          if (px0 + lane < Wo) {
            float* yp = yrow + (int64_t)(px0 + lane) * Cout;
#pragma unroll
            for (int g = 0; g < kStripCo / 4; ++g)
              if (4 * g < Cout)
                *reinterpret_cast<float4*>(yp + 4 * g) = make_float4(
                    v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
          }
          continue;
        }
        // wider Cout: through the warp's staging, then 16-byte chunks in
        // pixel order, lanes 4q..4q+3 on pixel q's 64 contiguous bytes, so
        // that every store fills whole 32-byte sectors (a lane's own
        // stores, Cout*4 bytes apart, filled half-sectors)
#pragma unroll
        for (int g = 0; g < kStripCo / 4; ++g)
          *reinterpret_cast<float4*>(sv + lane * kStripYs + 4 * g) =
              make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
        __syncwarp();
        const int npx = min(32, Wo - px0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = lane + 32 * q, px = i >> 2, part = i & 3;
          if (px < npx && co0 + 4 * part < Cout)
            *reinterpret_cast<float4*>(
                yrow + (int64_t)(px0 + px) * Cout + co0 + 4 * part) =
                *reinterpret_cast<const float4*>(sv + px * kStripYs +
                                                 4 * part);
        }
        __syncwarp();
      }
    }
  }
}

template <int R, bool kPad, bool k3>
cudaError_t launch_strip(cudaStream_t stream, const float* x, const float* w,
                         const float* b, float* y, int B, int H, int W,
                         int Cin, int Cout, int k, int s, int p, bool relu) {
  const int Ho = (H + 2 * p - k) / s + 1, Wo = (W + 2 * p - k) / s + 1;
  const int rows = Ho < R ? Ho : R;
  const size_t smem =
      4 * (size_t)strip_smem_floats(rows, k, s, W, Cin, Cout, p);
  if (smem > kStripSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_strip_kernel<R, kPad, k3>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((Ho + R - 1) / R, B);
  conv2d_strip_kernel<R, kPad, k3><<<grid, R * 32, smem, stream>>>(
      x, w, b, y, H, W, Cin, Cout, k, s, p, Ho, Wo, relu);
  return cudaGetLastError();
}

template <int R, bool kPad>
cudaError_t launch_strip_k(cudaStream_t st, const float* x, const float* w,
                           const float* b, float* y, int B, int H, int W,
                           int Cin, int Cout, int k, int s, int p,
                           bool relu) {
  return k == 3 && Cin == 3
             ? launch_strip<R, kPad, true>(st, x, w, b, y, B, H, W, Cin,
                                           Cout, k, s, p, relu)
             : launch_strip<R, kPad, false>(st, x, w, b, y, B, H, W, Cin,
                                            Cout, k, s, p, relu);
}

template <int R>
cudaError_t launch_strip_pad(cudaStream_t st, const float* x, const float* w,
                             const float* b, float* y, int B, int H, int W,
                             int Cin, int Cout, int k, int s, int p,
                             bool relu) {
  return p ? launch_strip_k<R, true>(st, x, w, b, y, B, H, W, Cin, Cout, k,
                                     s, p, relu)
           : launch_strip_k<R, false>(st, x, w, b, y, B, H, W, Cin, Cout, k,
                                      s, 0, relu);
}

}  // namespace

extern "C" int cnn_conv2d_bias_relu_strip(void* stream, const void* x,
                                          const void* w, const void* b,
                                          void* y, int B, int H, int W,
                                          int Cin, int Cout, int k,
                                          int stride, int pad, int relu,
                                          int rows) {
  // a padded strip stages its rows with zero margins and zero rows
  // (pad <= kPadMax); an unpadded one copies one contiguous run of x
  if (Cin < 1 || Cin > 4 || Cout % 4 != 0 || (W * Cin) % 4 != 0 ||
      !pad_ok(H, W, k, pad) || B > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  const bool r = relu != 0;
  switch (rows) {
    case 0: return (int)launch_strip_pad<2>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, pad, r);
    case 1: return (int)launch_strip_pad<4>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, pad, r);
    case 2: return (int)launch_strip_pad<8>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, pad, r);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bf16: cnn_conv2d_bias_relu_bf16, the mma.sync kernel, an implicit GEMM on
// the tensor cores (the entry point's variants 0 "gather" and 1 "vec"). The
// plan sends the AlexNet layers to the strip and wgmma kernels below; this
// one takes every shape they do not (Cin 12, k 5, misaligned x, rows that
// are no whole 16-byte chunks), and "vec" is reached only by name, for
// comparisons.
//
// Replaces: the bf16 path of cnn_tpu/ops/pallas/conv.py, _forward (kernel
// body _conv_kernel): for bf16 x and w each tap's [Ho*Wo, Cin] x [Cin, Cout]
// product is one single-pass MXU dot with float32 accumulation, the taps are
// summed in float32, the bias is read into float32 and added, then the
// optional ReLU, then one rounding to bf16.
//
// Bound on this card: bytes, on every AlexNet layer. At batch 256 conv1
// reads 76 MB of x and writes 101 MB (0.053 ms at 3.35 TB/s) for 2.8 GFLOP
// (3.2 with K padded to 32: 0.003 ms at 989 TFLOP/s dense bf16); conv2-4
// together move 62 MB (0.019 ms) for 4.7 GFLOP. So the design keeps the
// MMAs fed from shared memory and reads x and w once per block; it does
// not yet overlap loads with MMAs beyond a double buffer (wgmma, TMA and
// warp specialisation are later work). Measured on the H100 (chip_smoke.py,
// PERF.md): conv2-4 at 0.24 of this bound alone; conv1, whose gather
// stages two bytes a lane a row, at 0.18.
//
// Design:
//  - M = B*Ho*Wo output pixels, N = Cout, K = k*k*Cin in (dy, dx, ci)
//    order, in which HWIO w is a row-major [K, N] matrix. A block owns a
//    BM x BN output tile (BM = 64*MT with 4 warps, each warp 16*MT rows and
//    all BN = 8*NT columns) and walks K in slices of 32, two m16n8k16 MMA
//    steps each (mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32).
//  - The int64 base of each of the block's rows in x is computed once,
//    into shared memory (-1 past M, whose rows are staged as zeros: the
//    ragged M edge of B = 1 or 8).
//  - Staging A, "vec" (Cin % 8 == 0, x 16-byte aligned): a K slice is 4
//    chunks of 8 bf16 per row, each inside one tap, so each is one 16-byte
//    cp.async from x; a thread keeps one chunk column and decodes its tap
//    once a slice. "gather" (any other Cin, e.g. conv1's 3): lane l of every
//    warp stages column l of the slice, decoding its k once, and loads one
//    bf16 a row. K is padded to a multiple of 32 (conv1: 27 -> 32), and the
//    padded columns, like every row past M, are written as zeros, never
//    left unset: a NaN pattern left in shared memory times a zero weight
//    would be NaN.
//  - Staging B: the slice's 32 rows of w, 16-byte cp.async (Cout % 8 ==
//    0), rows past K and columns past Cout zero-filled, into shared memory
//    as [32][BN + 8]: row k stays row k. ldmatrix.x2.trans reads an MMA's
//    B fragment (k 2t, 2t+1 of column g for lane 4g+t) out of it, so w is
//    never transposed. The 8 bf16 of padding per row (16 bytes) put the 8
//    rows of an ldmatrix on distinct banks; A's rows of 40 bf16 (80 bytes)
//    do the same for the 32-bit fragment loads (a0..a3: rows g, g+8,
//    columns 2t, 2t+1 and 2t+8, 2t+9).
//  - Two stages (cp.async commit and wait groups): slice kt+1 lands while
//    slice kt is multiplied.
//  - Epilogue: the float32 accumulator (c0..c3: rows g, g+8, columns 2t,
//    2t+1), plus the bias read into float32, the optional ReLU, one
//    __floats2bfloat162_rn, and a 4-byte store masked at the M edge and at
//    Cout.
//  - Determinism: one warp owns each output fragment and walks K in one
//    fixed order; no split-K, no atomics, so two launches are bit-identical.
//  - The tile (MT, NT) and the staging of A are template arguments; the
//    entry point's switch maps ids to them in the order of BF16_TILES and
//    BF16_VARIANTS in ops/hopper/conv.py.
//
// Tests. On the CPU, the plan and a numpy emulation of this kernel's walk
// (staged slices, fragment loads, the accumulator's lane map, the masked
// stores), held against the plain bf16 conv and the Pallas kernel in
// interpret mode:
//   JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_bf16_conv_plan.py
// On the card, python3 chip_smoke.py builds it and holds it against the
// plain bf16 conv at every AlexNet layer and off those shapes.

namespace {

constexpr int kBfBK = 32;            // K slice: two k16 MMA steps
constexpr int kBfAStride = kBfBK + 8;   // A row stride in shared memory (bf16)
constexpr int kBfWarps = 4;
constexpr int kBfThreads = kBfWarps * 32;

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// column kg = (dy*k + dx)*Cin + ci of K: its tap, and its offset in x from
// a row's base (the pixel at the row's first tap)
struct Tap {
  int dy, dx;
  int64_t off;
};
__device__ __forceinline__ Tap tap_of(int kg, int Cin, int k, int W) {
  const int tap = kg / Cin, ci = kg - tap * Cin;
  const int dy = tap / k, dx = tap - dy * k;
  return {dy, dx, (int64_t)(dy * W + dx) * Cin + ci};
}

template <int MT, int NT, bool kVecA>
__global__ void __launch_bounds__(kBfThreads)
    conv2d_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, int H, int W, int Cin,
                       int Cout, int k, int s, int p, int Ho, int Wo, int M,
                       int K, bool relu) {
  constexpr int BM = kBfWarps * 16 * MT;
  constexpr int BN = 8 * NT;
  constexpr int kBStride = BN + 8;
  static_assert(2 * (BM * kBfAStride + kBfBK * kBStride) * 2 + BM * 12 <=
                    48 * 1024, "static shared memory");

  __shared__ __align__(16) __nv_bfloat16 sa[2][BM * kBfAStride];
  __shared__ __align__(16) __nv_bfloat16 sb[2][kBfBK * kBStride];
  __shared__ int64_t rowbase[BM];   // the pixel at the row's first tap
  __shared__ int rowyx[BM];         // its row and column (pack_yx)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  for (int r = tid; r < BM; r += kBfThreads) {
    const int m = m0 + r;
    int64_t base = 0;
    int yx = kRowPastM;
    if (m < M) {
      const int ox = m % Wo, t = m / Wo;
      const int oy = t % Ho;
      const int64_t b = t / Ho;
      base = ((b * H + (int64_t)oy * s - p) * W + (int64_t)ox * s - p) * Cin;
      yx = pack_yx(oy, ox, s, p);
    }
    rowbase[r] = base;
    rowyx[r] = yx;
  }
  __syncthreads();

  // the gather path moves the bf16 bits as 16-bit integers
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  auto load_slice = [&](int buf, int kt) {
    const int k0 = kt * kBfBK;
    if (kVecA) {
      const int c = tid & 3;            // this thread's chunk column
      const int kc = k0 + 8 * c;
      const bool kok = kc < K;          // K % 8 == 0: a chunk is all in
      Tap tp = {0, 0, 0};   // decoded only inside K (no spill)
      if (kok) tp = tap_of(kc, Cin, k, W);
      for (int r = tid >> 2; r < BM; r += kBfThreads / 4) {
        const bool ok = kok && tap_inside(rowyx[r], tp.dy, tp.dx, H, W);
        cp_async16(&sa[buf][r * kBfAStride + 8 * c],
                   ok ? x + rowbase[r] + tp.off : x, ok);
      }
    } else {
      const int kg = k0 + lane;         // this lane's column
      const bool kok = kg < K;
      Tap tp = {0, 0, 0};
      if (kok) tp = tap_of(kg, Cin, k, W);
      unsigned short* dst = reinterpret_cast<unsigned short*>(sa[buf]);
      for (int r = warp; r < BM; r += kBfWarps) {
        const bool ok = kok && tap_inside(rowyx[r], tp.dy, tp.dx, H, W);
        dst[r * kBfAStride + lane] =
            ok ? xs[rowbase[r] + tp.off] : (unsigned short)0;
      }
    }
    for (int c = tid; c < kBfBK * NT; c += kBfThreads) {
      const int r = c / NT, j = c - r * NT;
      const int kr = k0 + r, n = n0 + 8 * j;
      const bool ok = kr < K && n < Cout;
      cp_async16(&sb[buf][r * kBStride + 8 * j],
                 ok ? w + (int64_t)kr * Cout + n : w, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int g = lane >> 2, t = lane & 3;
  const int KT = (K + kBfBK - 1) / kBfBK;
  load_slice(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) load_slice((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();   // slice kt has landed (this thread's copies)
    __syncthreads();      // ... and every thread's
    const __nv_bfloat16* As = sa[kt & 1];
    const __nv_bfloat16* Bs = sb[kt & 1];
#pragma unroll
    for (int ks = 0; ks < kBfBK; ks += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = warp * 16 * MT + i * 16 + g;
        const uint32_t* p0 = reinterpret_cast<const uint32_t*>(
            As + r * kBfAStride + ks + 2 * t);
        const uint32_t* p1 = reinterpret_cast<const uint32_t*>(
            As + (r + 8) * kBfAStride + ks + 2 * t);
        af[i][0] = p0[0];   // row g,   k 2t, 2t+1
        af[i][1] = p1[0];   // row g+8, k 2t, 2t+1
        af[i][2] = p0[4];   // row g,   k 2t+8, 2t+9
        af[i][3] = p1[4];   // row g+8, k 2t+8, 2t+9
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bfr[2];
        // lanes 0-7 give rows k 0-7 of the step, lanes 8-15 rows 8-15
        ldmatrix_x2_trans(bfr, Bs + (ks + (lane & 15)) * kBStride + 8 * j);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16_16816(acc[i][j], af[i], bfr);
      }
    }
    __syncthreads();      // slice kt is read before its buffer is refilled
  }
  cp_async_wait<0>();     // only empty groups can be pending here

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp * 16 * MT + i * 16 + g + 8 * half;
      if (m >= M) continue;
      __nv_bfloat16* yrow = y + (int64_t)m * Cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (n >= Cout) continue;
        float v0 = acc[i][j][2 * half] + __bfloat162float(bias[n]);
        float v1 = acc[i][j][2 * half + 1] + __bfloat162float(bias[n + 1]);
        if (relu) {
          v0 = v0 > 0.f ? v0 : 0.f;
          v1 = v1 > 0.f ? v1 : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(yrow + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int MT, int NT, bool kVecA>
cudaError_t launch_bf16(cudaStream_t stream, const __nv_bfloat16* x,
                        const __nv_bfloat16* w, const __nv_bfloat16* b,
                        __nv_bfloat16* y, int B, int H, int W, int Cin,
                        int Cout, int k, int s, int p, bool relu) {
  const int Ho = (H + 2 * p - k) / s + 1, Wo = (W + 2 * p - k) / s + 1;
  const int M = B * Ho * Wo;
  constexpr int BM = kBfWarps * 16 * MT, BN = 8 * NT;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv2d_bf16_kernel<MT, NT, kVecA><<<grid, kBfThreads, 0, stream>>>(
      x, w, b, y, H, W, Cin, Cout, k, s, p, Ho, Wo, M, k * k * Cin, relu);
  return cudaGetLastError();
}

template <bool kVecA>
cudaError_t launch_bf16_tile(int tile, cudaStream_t st,
                             const __nv_bfloat16* x, const __nv_bfloat16* w,
                             const __nv_bfloat16* b, __nv_bfloat16* y, int B,
                             int H, int W, int Cin, int Cout, int k, int s,
                             int p, bool r) {
  switch (tile) {   // (MT, NT), in the order of BF16_TILES
    case 0: return launch_bf16<1, 2, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, p, r);
    case 1: return launch_bf16<1, 4, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, p, r);
    case 2: return launch_bf16<1, 8, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, p, r);
    case 3: return launch_bf16<1, 16, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, p, r);
    case 4: return launch_bf16<2, 2, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, p, r);
    case 5: return launch_bf16<2, 4, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, p, r);
    case 6: return launch_bf16<2, 8, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, p, r);
    case 7: return launch_bf16<2, 16, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, p, r);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// bf16 on Hopper: the "strip" and "wgmma" variants of the same entry point
// ("tma", the third, has its own section below).
//
// Both replace the bf16 path of cnn_tpu/ops/pallas/conv.py, _forward (kernel
// body _conv_kernel), and compute exactly its function: exact bf16
// products summed in float32, the bias read into float32 and added, the
// optional ReLU, one rounding to bf16. No split across blocks and no
// atomics: two launches are bit-identical.
//
// "strip", two layouts of the staged rows, both Cout % 8 == 0 and <= 64, x
// and y 16-byte aligned. Natural (AlexNet's conv1: k*Cin <= 16, s*Cin
// even, rows of W*Cin bf16 a multiple of 16 bytes, no padding): the input
// rows as they lie in x. Widened (the families' padded Cin-3 stems, any
// stride and padding, k <= 4, W % 8 == 0): each pixel staged as 4 elements,
// the 4th zero, so that every A word is aligned whatever p and s.
//  - Bound on this card: bytes. At batch 256 conv1 reads 76 MB of x and
//    writes 101 MB (0.053 ms at 3.35 TB/s) for 2.8 GFLOP. The mma.sync
//    "gather" path above reaches 0.18 of that bound: each lane stages one
//    2-byte element a row, for every row of a 128-row tile, and nothing
//    overlaps the staging (the padded stems ran on it until the widened
//    layout: 0.15 of their bound).
//  - A block owns R output rows of one image (blockIdx.x the strip,
//    blockIdx.y the image) and stages the (R-1)*s + k input rows they read,
//    from row oy0*s - p. Natural: one contiguous run of x, copied with
//    16-byte cp.async, coalesced across the block, 16 bytes of padding
//    after the rows. Widened: a thread loads a group of 8 pixels of a row
//    (three 16-byte loads: 24 bf16) and stores them as 8-byte pixels (four
//    16-byte stores); a row outside the image is stored as zeros, and each
//    row has a zero margin of p pixels on each side, its left one rounded
//    up to 16 bytes (the read index carries the shift). x is never padded
//    in memory.
//  - The weights are re-laid out once per block into the m16n8k16 B
//    fragments, one k16 step per kernel row dy (natural: columns dx*Cin +
//    ci, zero past k*Cin; widened: columns dx*4 + ci, zero for ci = 3 and
//    past k*4): [dy][n8 tile][lane] as two 32-bit words, one 8-byte shared
//    load per MMA.
//  - One warp per output row, 16 output pixels (the MMA's M) at a time.
//    Output pixel ox of kernel row dy reads its k*Cin (k*4) values
//    contiguous in the staged row at element ox*s*Cin (ox*s*4 from padded
//    column 0), an even element since s*Cin (s*4) is even: the A fragment
//    words (columns 2t, 2t+1 and 2t+8, 2t+9) are aligned 32-bit loads
//    straight from the staged rows. Columns at or past k*Cin (k*4) are
//    masked to zero in the register (a word that holds column k*Cin - 1
//    and k*Cin keeps only its low half), so a NaN or an infinity in a
//    neighbouring pixel never meets a zero weight; a word wholly past them
//    is not loaded. The word of the last column may read one element past
//    the last natural row: the padding. K is padded to 16 per kernel row
//    (conv1: 27 -> 48; widened 36 -> 48): the MMAs are free, the bound is
//    bytes. No gather and no per-element shared-memory stores of x.
//  - Epilogue: bias, ReLU and the rounding per fragment into an output
//    staging area in shared memory. Natural: the strip's output, R*Wo*Cout
//    bf16, one contiguous run of y, leaves as 16-byte stores at the end.
//    Widened: each warp stages its 16 pixels (rows of Cout + 8 bf16: the
//    fragment writes miss each other's banks) and copies them out as one
//    contiguous run at once: R*Wo*Cout*2 bytes of a whole strip (115 KB
//    for VGG11's 3 -> 64 stem at R = 4) would leave few blocks an SM.
//  - R and the layout are template arguments; the switch maps ids to them
//    in the order of BF16_STRIP_TILES in ops/hopper/conv.py. So is the
//    number of n8 tiles a lane holds, 2, 4 or 8, the fewest that cover
//    Cout: the launch picks it.
//
// "wgmma" (conv2-3: Cin % 8 == 0, x and y 16-byte aligned; conv4 and every
// Cin % 64 shape now take "tma" below).
//  - Bound on this card: bytes (conv2-4 together 62 MB, 0.019 ms, for 4.7
//    GFLOP). The mma.sync "vec" path above walks K in slices of 32 with
//    two stages; conv4 (18 slices, 144 blocks on 132 SMs) is slower than
//    cuDNN. What bounds this kernel in practice is the rate at which its
//    SMs take in 16-byte cp.async copies (16-20 GB/s an SM on an H100 SXM
//    at 700 W, tools/conv_bf16_probe.py; without its wgmmas it runs within
//    8% of its time), against traffic that the im2col rows (each input
//    pixel 2.25 times) and the weights (read whole by every block) make
//    larger than the bytes of the bound.
//  - A block of SPLIT warpgroups owns a BM x BN output tile (BM = 64*MT).
//    Each warpgroup issues wgmma.mma_async m64nBNk16 (bf16 in, float32
//    accumulators in registers) on A and B read from shared memory
//    through matrix descriptors, and walks K in slices of BK through a
//    ring of S stages filled by 16-byte cp.async: S - 2 slices are in
//    flight while the wgmma groups of the two slices before them run
//    (wgmma.fence, commit_group, wait_group 1). A stage is refilled only
//    after a barrier that every warp of the warpgroup reaches past the
//    wait for the group that last read it.
//  - A, the im2col rows, is K-major: a chunk of 8 bf16 never straddles a
//    tap since Cin % 8 == 0, so it is one 16-byte cp.async from x. It is
//    stored in the descriptor's canonical no-swizzle layout: 8-row x
//    16-byte core matrices of 128 contiguous bytes, K-adjacent core
//    matrices kWgALbo bytes apart (the leading byte offset), 8-row groups
//    BK/8 core matrices apart (the stride byte offset). Copy i of thread t
//    is chunk t + 128i, stored at 16 bytes times its index, so each warp's
//    32 copies land on 512 contiguous bytes.
//  - B, HWIO w as [K, Cout], is N-contiguous: it is staged as an MN-major
//    operand (core matrices of 8 k rows x 8 n columns, N-adjacent ones
//    kWgBSbo bytes apart, K-adjacent ones BN*16) and read with wgmma's
//    transpose-B for bf16, so w is never transposed in memory. Every block
//    reads all of w: its copies allocate in L1 (cp.async.ca), which
//    blocks on one SM share; through L2 alone every layer ran slower (the
//    probe's build with CONV_WG_PROBE bit 8: conv2 1.4x as long).
//  - Where Cin is 16 (the A-via-L1 template flag) A's copies allocate in
//    L1 too: the taps of neighbouring output pixels overlap.
//  - Rows past M, K past k*k*Cin and columns past Cout are zero-filled
//    copies (cp.async with a source size of 0), never left unset.
//  - SPLIT = 2: the two warpgroups each walk half of the K slices into
//    their own ring, then the second writes its float32 accumulators to
//    shared memory and the first adds them to its own, in that one order,
//    before the bias. The plan takes it where few blocks leave SMs idle
//    and K is long (conv4 at B <= 64: 18 slices), so the serial chain of
//    slices halves; at batch 256 conv4 takes BM = 128 instead, which
//    halves the re-reads of w.
//  - BK = 32 (two k16 steps): 64-wide slices make rings of 48-96 KB a
//    block, so fewer blocks stay resident; the sweep's BK 64 tile is
//    slower than its BK 32 twin.
//  - Accumulators: warp w of a warpgroup holds rows 16w + g and 16w + g +
//    8, columns 8j + 2t and 8j + 2t + 1 (lane 4g + t). Epilogue: bias,
//    ReLU and the rounding into an output tile in shared memory (rows of
//    BN + 8 bf16: conflict-free 4-byte writes), then 16-byte stores masked
//    at M and Cout.
//  - (BN, MT, BK, S, SPLIT, A via L1) are template arguments; the switch
//    maps ids to them in the order of WGMMA_TILES in ops/hopper/conv.py,
//    whose plan (wgmma_tile_for) picks one by shape. A ring above 48 KB
//    sets cudaFuncAttributeMaxDynamicSharedMemorySize in the launch.
//
// Tests. On the CPU, the plan and numpy emulations of both walks (the
// strip's staged rows and fragment words; the wgmma ring, its descriptors
// decoded as the hardware reads them, and the split's fixed-order sum),
// held against the plain bf16 conv and the Pallas kernel in interpret
// mode:
//   JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_bf16_conv_hopper.py
// On the card, python3 chip_smoke.py builds both and holds them against
// the plain bf16 conv at every AlexNet layer and off those shapes.

namespace {

constexpr int kStripBfNtMax = 8;     // Cout <= 64: at most eight n8 tiles
constexpr int kStripBfKc = 16;       // k*Cin of a kernel row: one k16 step
constexpr int kStripBfSmemMax = 96 * 1024;
constexpr int kStripBfWide = 4;      // elements of a widened pixel

// the widened layout's staged row, in pixels: a zero margin of p pixels
// before the image row, rounded up to an even count (a 16-byte boundary),
// the W image pixels, p pixels of zeros, rounded up to an even row
__host__ __device__ inline int strip_bf16_lead(int p) { return (p + 1) / 2 * 2; }
__host__ __device__ inline int strip_bf16_wide_row(int W, int p) {
  return (strip_bf16_lead(p) + W + p + 1) / 2 * 2;
}

// bytes of shared memory of a bf16 strip of `rows` output rows: the B
// fragments, the staged input rows (natural: whole rows and 16 bytes of
// padding; widened: rows of 8-byte pixels with their margins), the output
// (natural: the strip's rows; widened: 16 pixels a warp, rows of Cout + 8)
__host__ __device__ inline int strip_bf16_frag_bytes(int k, int Cout) {
  return k * (Cout / 8) * 32 * 8;
}
__host__ __device__ inline int strip_bf16_x_bytes(int rows, int k, int s,
                                                  int W, int Cin, int p,
                                                  bool wide) {
  const int nin = (rows - 1) * s + k;
  return wide ? nin * strip_bf16_wide_row(W, p) * kStripBfWide * 2
              : nin * W * Cin * 2 + 16;
}
__host__ __device__ inline int strip_bf16_smem_bytes(int rows, int k, int s,
                                                     int W, int Cin,
                                                     int Cout, int Wo, int p,
                                                     bool wide) {
  return strip_bf16_frag_bytes(k, Cout) +
         strip_bf16_x_bytes(rows, k, s, W, Cin, p, wide) +
         (wide ? rows * 16 * (Cout + 8) * 2 : rows * Wo * Cout * 2);
}

// the shapes a layout takes (the entry point refuses the rest): natural,
// unpadded rows whose A words fall on even elements (s*Cin even) and whose
// runs are whole 16-byte chunks; widened, Cin 3 with rows of whole groups
// of 8 pixels (three 16-byte loads), any stride and padding
__host__ __device__ inline bool strip_bf16_takes(int W, int Cin, int Cout,
                                                 int k, int s, int p,
                                                 bool wide) {
  if (Cout > 8 * kStripBfNtMax) return false;
  return wide ? Cin == 3 && k * kStripBfWide <= kStripBfKc && W % 8 == 0
              : p == 0 && k * Cin <= kStripBfKc && (s * Cin) % 2 == 0 &&
                    (W * Cin) % 8 == 0;
}

__device__ __forceinline__ uint32_t lds32(const unsigned short* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int R, bool kWide, int kNt>
__global__ void __launch_bounds__(R * 32)
    conv2d_bf16_strip_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             const __nv_bfloat16* __restrict__ bias,
                             __nv_bfloat16* __restrict__ y, int H, int W,
                             int Cin, int Cout, int k, int s, int p, int Ho,
                             int Wo, bool relu) {
  extern __shared__ __align__(16) unsigned char smem_strip[];
  // elements of a staged pixel, of a kernel row's A columns, of a staged
  // row; the offset of a row's padded column 0 from its start
  const int cs = kWide ? kStripBfWide : Cin, kc = k * cs, nt = Cout / 8;
  const int rowlen = kWide ? strip_bf16_wide_row(W, p) * kStripBfWide
                           : W * Cin;
  const int shift = kWide ? (strip_bf16_lead(p) - p) * kStripBfWide : 0;
  const int oy0 = blockIdx.x * R, rows = min(R, Ho - oy0);
  const int nin = (rows - 1) * s + k;   // input rows the strip reads
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int frag = strip_bf16_frag_bytes(k, Cout);
  uint2* sw = reinterpret_cast<uint2*>(smem_strip);
  unsigned short* sx =
      reinterpret_cast<unsigned short*>(smem_strip + frag);
  // the output area sits past the staged rows of a full strip
  __nv_bfloat16* sy = reinterpret_cast<__nv_bfloat16*>(
      smem_strip + frag +
      strip_bf16_x_bytes(min(R, Ho), k, s, W, Cin, p, kWide));

  if (kWide) {
    // rows oy0*s - p ...: each group of 8 pixels of an image row is three
    // 16-byte loads of x and four 16-byte stores of 8-byte pixels, the 4th
    // element zero; a row outside the image is stored as zeros, never as a
    // row of a neighbouring image, and x is never padded in memory
    const int ng = W / 8, lead = strip_bf16_lead(p);
    const int iy0 = oy0 * s - p;
    const uint4* xg = reinterpret_cast<const uint4*>(x) + (int64_t)b * H * ng * 3;
    for (int i = tid; i < nin * ng; i += R * 32) {
      const int r = i / ng, q = i - r * ng;
      const int iy = iy0 + r;
      uint32_t v[12];
      if ((unsigned)iy < (unsigned)H) {
        const uint4* src = xg + ((int64_t)iy * ng + q) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const uint4 u = __ldg(src + c);
          v[4 * c] = u.x, v[4 * c + 1] = u.y, v[4 * c + 2] = u.z,
          v[4 * c + 3] = u.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 12; ++c) v[c] = 0u;
      }
      // pixel j holds elements 3j..3j+2: an even j starts a word, an odd
      // j its high half
      uint32_t o[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = 3 * j;
        if (j % 2 == 0) {
          o[2 * j] = v[e / 2];
          o[2 * j + 1] = v[e / 2 + 1] & 0xFFFFu;
        } else {
          o[2 * j] = (v[e / 2] >> 16) | (v[e / 2 + 1] << 16);
          o[2 * j + 1] = v[e / 2 + 1] >> 16;
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(
          sx + (r * (rowlen / kStripBfWide) + lead + 8 * q) * kStripBfWide);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dst[c] = make_uint4(o[4 * c], o[4 * c + 1], o[4 * c + 2],
                            o[4 * c + 3]);
    }
    // the margins, pairs of zero pixels: lead before the image row, the
    // rest of the staged row after it
    const int mp = (rowlen / kStripBfWide - W) / 2;
    for (int i = tid; i < nin * mp; i += R * 32) {
      const int r = i / mp, c = 2 * (i - r * mp);
      const int px = c < lead ? c : W + c;
      *reinterpret_cast<uint4*>(
          sx + (r * (rowlen / kStripBfWide) + px) * kStripBfWide) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    // the strip's input rows: one contiguous run of x, 16-byte aligned
    const int n16 = nin * rowlen / 8;
    const int4* src = reinterpret_cast<const int4*>(
        x + ((int64_t)b * H + (int64_t)oy0 * s) * rowlen);
    for (int i = tid; i < n16; i += R * 32)
      cp_async16(sx + 8 * i, src + i, true);
    cp_async_commit();
  }
  // the B fragments: b0 holds k rows 2t, 2t+1 of column g, b1 rows 2t+8,
  // 2t+9 (low half the lower row), zero past k*Cin; widened, column c of
  // a kernel row is tap dx = c / 4, channel c % 4, zero for channel 3
  const unsigned short* wb = reinterpret_cast<const unsigned short*>(w);
  for (int i = tid; i < k * nt * 32; i += R * 32) {
    const int l = i & 31, dj = i >> 5, dy = dj / nt, j = dj - dy * nt;
    const int n = 8 * j + (l >> 2), c0 = 2 * (l & 3);
    uint32_t v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t half[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * h + e;
        const int dx = kWide ? c / kStripBfWide : 0;
        const int ci = kWide ? c % kStripBfWide : c;
        const bool in = kWide ? dx < k && ci < Cin : c < kc;
        const int row = kWide ? (dy * k + dx) * Cin + ci : dy * kc + c;
        half[e] = in ? wb[(int64_t)row * Cout + n] : 0u;
      }
      v[h] = half[0] | (half[1] << 16);
    }
    sw[i] = make_uint2(v[0], v[1]);
  }
  if (!kWide) cp_async_wait<0>();
  __syncthreads();

  if (warp < rows) {
    const int g = lane >> 2, t = lane & 3;
    // the A columns this lane holds that lie inside k*Cin (widened: k*4)
    const uint32_t mlo = (2 * t < kc ? 0xFFFFu : 0u) |
                         (2 * t + 1 < kc ? 0xFFFF0000u : 0u);
    const uint32_t mhi = (2 * t + 8 < kc ? 0xFFFFu : 0u) |
                         (2 * t + 9 < kc ? 0xFFFF0000u : 0u);
    float bv[kNt][2];
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      bv[j][0] = j < nt ? __bfloat162float(bias[8 * j + 2 * t]) : 0.f;
      bv[j][1] = j < nt ? __bfloat162float(bias[8 * j + 2 * t + 1]) : 0.f;
    }
    // kernel row 0 at padded column 0: a tap in the padding reads a zero
    // of the margin or of a zero row
    const unsigned short* xr = sx + warp * s * rowlen + shift;
    // natural: the strip's output rows; widened: this warp's 16 pixels
    __nv_bfloat16* yr = kWide ? sy + warp * 16 * (Cout + 8)
                              : sy + warp * Wo * Cout;
    const int ys = kWide ? Cout + 8 : Cout;   // a staged pixel's stride
    const int ps = s * cs;   // elements between neighbouring outputs
    for (int ox0 = 0; ox0 < Wo; ox0 += 16) {
      const int pa = ox0 + g, pb = pa + 8;
      const bool va = pa < Wo, vb = pb < Wo;
      float acc[kNt][4];
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int dy = 0; dy < k; ++dy) {
        const unsigned short* xa = xr + dy * rowlen + pa * ps + 2 * t;
        const unsigned short* xb = xa + 8 * ps;
        uint32_t a[4];
        a[0] = va && mlo ? lds32(xa) & mlo : 0u;       // row g,   k 2t..
        a[1] = vb && mlo ? lds32(xb) & mlo : 0u;       // row g+8, k 2t..
        a[2] = va && mhi ? lds32(xa + 8) & mhi : 0u;   // row g,   k 2t+8..
        a[3] = vb && mhi ? lds32(xb + 8) & mhi : 0u;   // row g+8, k 2t+8..
        const uint2* wp = sw + dy * nt * 32 + lane;
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          if (j < nt) {
            const uint2 bw = wp[32 * j];
            const uint32_t bb[2] = {bw.x, bw.y};
            mma_bf16_16816(acc[j], a, bb);
          }
        }
      }
      // widened: the first pixel of this chunk is row 0 of the staging
      const int p0 = kWide ? ox0 : 0;
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        if (j >= nt) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (!(half ? vb : va)) continue;
          float v0 = acc[j][2 * half] + bv[j][0];
          float v1 = acc[j][2 * half + 1] + bv[j][1];
          if (relu) {
            v0 = v0 > 0.f ? v0 : 0.f;
            v1 = v1 > 0.f ? v1 : 0.f;
          }
          *reinterpret_cast<__nv_bfloat162*>(
              yr + ((half ? pb : pa) - p0) * ys + 8 * j + 2 * t) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      if (kWide) {
        // this warp's 16 pixels are one contiguous run of y: 16-byte stores
        __syncwarp();
        const int cpp = Cout / 8, nv = min(16, Wo - ox0);
        int4* dst = reinterpret_cast<int4*>(
            y + (((int64_t)b * Ho + oy0 + warp) * Wo + ox0) * Cout);
        for (int i = lane; i < nv * cpp; i += 32) {
          const int px = i / cpp, c = i - px * cpp;
          dst[i] = *reinterpret_cast<const int4*>(yr + px * ys + 8 * c);
        }
        __syncwarp();
      }
    }
  }
  if (!kWide) {
    __syncthreads();
    // the strip's output rows are one contiguous run of y
    const int n16o = rows * Wo * Cout / 8;
    int4* dst =
        reinterpret_cast<int4*>(y + ((int64_t)b * Ho + oy0) * Wo * Cout);
    const int4* so = reinterpret_cast<const int4*>(sy);
    for (int i = tid; i < n16o; i += R * 32) dst[i] = so[i];
  }
}

// kNt: the n8 tiles a lane's registers hold (2, 4 or 8, the fewest that
// cover Cout): a kernel sized for Cout 64 keeps 32 accumulators live even
// at conv1's Cout 16, and ran conv1 at 0.7x the speed of one sized for it
template <int R, bool kWide, int kNt>
cudaError_t launch_bf16_strip_nt(cudaStream_t stream, const __nv_bfloat16* x,
                                 const __nv_bfloat16* w,
                                 const __nv_bfloat16* b, __nv_bfloat16* y,
                                 int B, int H, int W, int Cin, int Cout,
                                 int k, int s, int p, int smem, bool relu) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_bf16_strip_kernel<R, kWide, kNt>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int Ho = (H + 2 * p - k) / s + 1, Wo = (W + 2 * p - k) / s + 1;
  const dim3 grid((Ho + R - 1) / R, B);
  conv2d_bf16_strip_kernel<R, kWide, kNt><<<grid, R * 32, smem, stream>>>(
      x, w, b, y, H, W, Cin, Cout, k, s, p, Ho, Wo, relu);
  return cudaGetLastError();
}

template <int R, bool kWide>
cudaError_t launch_bf16_strip(cudaStream_t stream, const __nv_bfloat16* x,
                              const __nv_bfloat16* w, const __nv_bfloat16* b,
                              __nv_bfloat16* y, int B, int H, int W, int Cin,
                              int Cout, int k, int s, int p, bool relu) {
  if (!strip_bf16_takes(W, Cin, Cout, k, s, p, kWide))
    return cudaErrorInvalidValue;
  const int Ho = (H + 2 * p - k) / s + 1, Wo = (W + 2 * p - k) / s + 1;
  const int smem = strip_bf16_smem_bytes(Ho < R ? Ho : R, k, s, W, Cin,
                                         Cout, Wo, p, kWide);
  if (smem > kStripBfSmemMax) return cudaErrorInvalidValue;
  if (Cout <= 16)
    return launch_bf16_strip_nt<R, kWide, 2>(stream, x, w, b, y, B, H, W,
                                             Cin, Cout, k, s, p, smem, relu);
  if (Cout <= 32)
    return launch_bf16_strip_nt<R, kWide, 4>(stream, x, w, b, y, B, H, W,
                                             Cin, Cout, k, s, p, smem, relu);
  return launch_bf16_strip_nt<R, kWide, kStripBfNtMax>(
      stream, x, w, b, y, B, H, W, Cin, Cout, k, s, p, smem, relu);
}

// ---- wgmma ----

// a 16-byte copy that also allocates in L1 (cp.async.ca), for the weights:
// every block reads all of them, and with the L2-only copy (.cg) the blocks
// of the whole card meet on one hot set of L2 lines
__device__ __forceinline__ void cp_async16_ca(void* smem, const void* gmem,
                                              bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// Compiled with -DCONV_WG_PROBE=m, the wgmma kernel skips its wgmmas (bit
// 1), the copies of A (bit 2) or of B (bit 4), or copies B through L2 only
// (bit 8): wrong results, for timing only (cnn_tpu_torch/tools/
// conv_bf16_probe.py). The build the package loads has m = 0.
#ifndef CONV_WG_PROBE
#define CONV_WG_PROBE 0
#endif
constexpr int kWgProbe = CONV_WG_PROBE;

constexpr int kWgThreads = 128;      // one warpgroup
constexpr int kWgCore = 128;         // a core matrix: 8 rows of 16 bytes
constexpr int kWgALbo = kWgCore;     // A: K-adjacent core matrices
constexpr int kWgBSbo = kWgCore;     // B: N-adjacent core matrices
// A's stride byte offset (8-row groups) is BK / 8 core matrices; B's
// leading byte offset (K-adjacent cores) is BN * 16 bytes

// a shared-memory matrix descriptor, no swizzle: start address, leading
// and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async
// one: each thread fences its landed copies before the barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the barrier of one warpgroup's ring, by immediate id (an id in a
// register would make ptxas reserve all 16 of the block's barriers)
template <int SPLIT>
__device__ __forceinline__ void ring_sync(int wg) {
  if constexpr (SPLIT == 1)
    __syncthreads();
  else if (wg == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}
// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that owns it
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void wgmma_m64n16(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 16) wgmma_m64n16(d, da, db);
  else if constexpr (BN == 32) wgmma_m64n32(d, da, db);
  else if constexpr (BN == 64) wgmma_m64n64(d, da, db);
  else wgmma_m64n128(d, da, db);
}

template <int BN, int MT, int BK>
__host__ __device__ constexpr int wgmma_stage_bytes() {
  return 64 * MT * BK * 2 + BK * BN * 2;
}

template <int BN, int MT, int BK, int S, int SPLIT, bool kAL1>
__global__ void __launch_bounds__(kWgThreads * SPLIT)
    conv2d_bf16_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w,
                             const __nv_bfloat16* __restrict__ bias,
                             __nv_bfloat16* __restrict__ y, int H, int W,
                             int Cin, int Cout, int k, int s, int p, int Ho,
                             int Wo, int M, int K, bool relu) {
  constexpr int BM = 64 * MT;
  constexpr int kCpr = BK / 8;         // 16-byte chunks of an A row
  constexpr int kASbo = kWgCore * kCpr;
  constexpr int kABytes = BM * BK * 2;
  constexpr int kStage = wgmma_stage_bytes<BN, MT, BK>();
  constexpr int kNAcc = BN / 2;        // accumulators per m64 tile
  constexpr int kARows = BM * kCpr / kWgThreads;   // A rows a thread stages
  constexpr int kBChunks = BK * BN / 8;            // B chunks of a slice
  constexpr int kP = S - 2;            // slices in flight
  constexpr int kRed = SPLIT > 1 ? MT * kNAcc * kWgThreads * 4 : 0;
  constexpr int kOutStride = BN + 8;   // bf16 per row of the output tile
  static_assert((BK == 32 || BK == 64) && S >= 3 && S <= 8 &&
                    (SPLIT == 1 || SPLIT == 2), "ring");
  static_assert(kRed + BM * kOutStride * 2 <= SPLIT * S * kStage,
                "the epilogue's buffers alias the rings");
  extern __shared__ __align__(128) unsigned char smem_wg[];

  const int tid = threadIdx.x, wg = tid / kWgThreads, t = tid % kWgThreads;
  unsigned char* ring = smem_wg + wg * S * kStage;
  const uint32_t ring_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = (K + BK - 1) / BK;
  const int per = (KT + SPLIT - 1) / SPLIT;
  const int kt0 = wg * per, nk = max(0, min(KT, kt0 + per) - kt0);

  // this thread's A rows (the pixel at the row's first tap, and its row
  // and column packed by pack_yx: kRowPastM past M) and chunk column: copy
  // i of thread t is chunk idx = t + 128 i, row 8 * (idx / (8 * kCpr)) +
  // idx % 8, column (idx / 8) % kCpr, at byte 16 * idx of the stage (the
  // core matrices' order), so a warp's 32 copies land on 512 contiguous
  // bytes. A chunk whose tap lies in the padding is zero-filled, as past M
  int64_t base[kARows];
  int yx[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int idx = t + kWgThreads * i;
    const int m = m0 + 8 * (idx / (8 * kCpr)) + (idx & 7);
    base[i] = 0;
    yx[i] = kRowPastM;
    if (m < M) {
      const int ox = m % Wo, q = m / Wo;
      const int oy = q % Ho;
      const int64_t bb = q / Ho;
      base[i] = ((bb * H + (int64_t)oy * s - p) * W + (int64_t)ox * s - p) *
                Cin;
      yx[i] = pack_yx(oy, ox, s, p);
    }
  }
  const int ca = (t >> 3) % kCpr;

  auto load_slice = [&](int kt, int st) {
    unsigned char* sa = ring + st * kStage;
    unsigned char* sb = sa + kABytes;
    const int kc = kt * BK + 8 * ca;
    const bool kok = kc < K;          // K % 8 == 0: a chunk is all in
    const Tap tp = tap_of(kok ? kc : 0, Cin, k, W);
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const bool ok = kok && tap_inside(yx[i], tp.dy, tp.dx, H, W);
      void* dst = sa + 16 * (t + kWgThreads * i);
      const void* src = ok ? x + base[i] + tp.off : x;
      if (kWgProbe & 2)
        continue;
      if (kAL1)
        cp_async16_ca(dst, src, ok);
      else
        cp_async16(dst, src, ok);
    }
    if (kWgProbe & 4) return;
    // B chunk idx: k row 8 * (idx / BN) + idx % 8, columns 8 * ((idx / 8)
    // % (BN / 8)), at byte 16 * idx
#pragma unroll
    for (int i = 0; i < (kBChunks + kWgThreads - 1) / kWgThreads; ++i) {
      const int idx = t + kWgThreads * i;
      if (kBChunks % kWgThreads == 0 || idx < kBChunks) {
        const int kr = (idx / BN) * 8 + (idx & 7), j = (idx >> 3) % (BN / 8);
        const int kg = kt * BK + kr, n = n0 + 8 * j;
        const bool ok = kg < K && n < Cout;
        if (kWgProbe & 8)
          cp_async16(sb + 16 * idx, ok ? w + (int64_t)kg * Cout + n : w, ok);
        else
          cp_async16_ca(sb + 16 * idx, ok ? w + (int64_t)kg * Cout + n : w,
                        ok);
      }
    }
  };

  float acc[MT][kNAcc];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < kNAcc; ++e) acc[i][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kP; ++st) {
    if (st < nk) load_slice(kt0 + st, st);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kP - 1>();   // slice it has landed (this thread's)
    fence_proxy_async();
    ring_sync<SPLIT>(wg);   // ... every thread's; and wgmma(it-2) is
                            // done in every warp of the warpgroup
    if (it + kP < nk) load_slice(kt0 + it + kP, (it + kP) % S);
    cp_async_commit();
    const uint32_t sa = ring_s + (it % S) * kStage, sb = sa + kABytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t db = wgmma_desc(sb + ks * 2 * BN * 16, BN * 16, kWgBSbo);
#pragma unroll
      for (int i = 0; i < MT && !(kWgProbe & 1); ++i)
        wgmma_bn<BN>(acc[i],
                     wgmma_desc(sa + i * 8 * kASbo + ks * 2 * kWgALbo,
                                kWgALbo, kASbo),
                     db);
    }
    wgmma_commit();
    wgmma_wait<1>();   // the group of slice it-1 is done
  }
  wgmma_wait<0>();
  cp_async_wait<0>();   // only empty groups can be pending here
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < kNAcc; ++e) reg_fence(acc[i][e]);
  __syncthreads();      // every ring is read: the epilogue reuses them

  float* red = reinterpret_cast<float*>(smem_wg);
  if (SPLIT > 1 && wg == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < kNAcc; ++e)
        red[(i * kNAcc + e) * kWgThreads + t] = acc[i][e];
  }
  if (SPLIT > 1) __syncthreads();
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem_wg + kRed);
  if (wg == 0) {
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, tt = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = 8 * j + 2 * tt;
        const bool nok = n0 + n < Cout;
        const float b0 = nok ? __bfloat162float(bias[n0 + n]) : 0.f;
        const float b1 = nok ? __bfloat162float(bias[n0 + n + 1]) : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 4 * j + 2 * half;
          float v0 = acc[i][e], v1 = acc[i][e + 1];
          if (SPLIT > 1) {   // the first half of K, then the second
            v0 += red[(i * kNAcc + e) * kWgThreads + t];
            v1 += red[(i * kNAcc + e + 1) * kWgThreads + t];
          }
          v0 += b0;
          v1 += b1;
          if (relu) {
            v0 = v0 > 0.f ? v0 : 0.f;
            v1 = v1 > 0.f ? v1 : 0.f;
          }
          const int r = 64 * i + 16 * warp + g + 8 * half;
          *reinterpret_cast<__nv_bfloat162*>(so + r * kOutStride + n) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < BM * (BN / 8); c += kWgThreads * SPLIT) {
    const int r = c / (BN / 8), j = c - r * (BN / 8);
    const int m = m0 + r, n = n0 + 8 * j;
    if (m < M && n < Cout)
      *reinterpret_cast<int4*>(y + (int64_t)m * Cout + n) =
          *reinterpret_cast<const int4*>(so + r * kOutStride + 8 * j);
  }
}

template <int BN, int MT, int BK, int S, int SPLIT, bool kAL1>
cudaError_t launch_bf16_wgmma(cudaStream_t stream, const __nv_bfloat16* x,
                              const __nv_bfloat16* w, const __nv_bfloat16* b,
                              __nv_bfloat16* y, int B, int H, int W, int Cin,
                              int Cout, int k, int s, int p, bool relu) {
  const int Ho = (H + 2 * p - k) / s + 1, Wo = (W + 2 * p - k) / s + 1;
  const int M = B * Ho * Wo;
  constexpr int smem = SPLIT * S * wgmma_stage_bytes<BN, MT, BK>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_bf16_wgmma_kernel<BN, MT, BK, S, SPLIT, kAL1>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((M + 64 * MT - 1) / (64 * MT), (Cout + BN - 1) / BN);
  conv2d_bf16_wgmma_kernel<BN, MT, BK, S, SPLIT, kAL1>
      <<<grid, kWgThreads * SPLIT, smem, stream>>>(
          x, w, b, y, H, W, Cin, Cout, k, s, p, Ho, Wo, M, k * k * Cin, relu);
  return cudaGetLastError();
}

// ---- tma ----
//
// "tma" (Cin % 64 == 0, x and y 16-byte aligned: the families' padded 3x3s
// and 1x1s, AlexNet's conv4). The "wgmma" kernel above spends its time
// taking in 16-byte cp.async copies, one per thread per 16 bytes of A's
// im2col rows and of w; this one issues no per-thread copy at all.
//  - Bound on this card: bytes at every shape it takes (PipeCNN's trunk
//    conv [64,56,56,64] -> 64, s1 p1: 25.7 MB in and out, 0.0154 ms, for
//    14.8 GFLOP). What it moves in practice is A's im2col rows (each input
//    pixel k*k/s^2 times) and w (read whole by every block) from L2 into
//    shared memory, now at the Tensor Memory Accelerator's rate.
//  - A: x is described once per call by an im2col tensor map over the 4-D
//    NHWC tensor (dims C, W, H, N, innermost first): a pixel box whose
//    lower corner is -pad and upper corner pad - (k-1) in W and H (the
//    positions of tap (0,0) of every output pixel), traversal strides
//    {1, s, s, 1}, 64 channels (128 bytes) per pixel, up to 128 pixels per
//    copy, the 128-byte swizzle. One copy per (tap, 64-channel slice)
//    starts at the tile's first output pixel (tap (0,0) at ox*s - pad,
//    oy*s - pad, image n) with the tap's (dx, dy) as im2col offsets: the
//    unit walks the pixels across rows and images, zero-fills a tap in the
//    padding and every pixel past the last image (rows past M). K slices
//    go in (dy, dx, 64-channel) order.
//  - B: w (HWIO as [K, Cout], N-contiguous) through a tiled tensor map,
//    boxes of 64 k rows x 64 columns with the 128-byte swizzle: an MN-major
//    operand read with wgmma's transpose-B, never transposed in memory.
//  - Each stage holds rows of 128 bytes written in the 128-byte swizzle
//    (16-byte chunk j of row r at chunk j ^ (r % 8)), 1024-byte aligned:
//    wgmma reads A through K-major B128 descriptors (8-row groups 1024
//    bytes apart, a k16 step 32 bytes further along the row) and B through
//    MN-major B128 ones (8 k-row groups 1024 bytes apart, 64-column boxes
//    8192 apart).
//  - A ring of S stages with mbarrier full / empty pairs: one producer
//    warp (one lane) waits for a stage to be empty, sets the bytes the
//    stage expects and issues its copies; NC consumer warpgroups wait for
//    it to be full, issue wgmma.mma_async m64nBNk16 on it (MT m64 tiles
//    each), and once wgmma_wait<1> shows the group of the slice before it
//    done, one thread of each arrives on that slice's empty barrier
//    (count NC). BM = 256 (two consumer warpgroups of m64 x 2) halves the
//    blocks that each read all of w.
//  - Epilogue, as "wgmma": bias, ReLU and one rounding into an output tile
//    in shared memory (over the ring, once every warpgroup's wgmmas are
//    done), then 16-byte stores masked at M and Cout.
//  - A K of fewer slices than stages (a 1x1 over 64 or 128 channels) asks
//    for only the stages it fills (tma_smem_bytes), so more blocks share
//    an SM and one's epilogue hides behind another's copies.
//  - What bounds it now (tools/conv_bf16_probe.py on an H100 SXM at 700 W,
//    PipeCNN's trunk conv): A's copies first, then the block's skeleton
//    (barriers, epilogue, stores: 0.38 of its time with no copies and no
//    wgmmas), the wgmmas last.
//  - No split of K and no atomics: two launches are bit-identical.
//  - (BN, BM, S, NC) are template arguments; the switch maps ids to them in
//    the order of TMA_TILES in ops/hopper/conv.py, whose plan
//    (tma_tile_for) picks one by shape. The tensor maps are encoded on the
//    host for each call (cuTensorMapEncodeIm2col / Tiled, looked up by the
//    runtime's entry-point query: no link to libcuda) and passed by
//    value as __grid_constant__ parameters, so a CUDA graph captures them
//    with the launch.
//  - CONV_WG_PROBE bits 1, 2 and 4 skip the wgmmas, A's copies and B's
//    copies here too (tools/conv_bf16_probe.py).
//
// Tests. On the CPU, a numpy emulation of this walk (the im2col box as the
// unit walks it, the swizzle, the descriptors decoded as the hardware reads
// them, the epilogue) against the plain bf16 conv and the Pallas kernel in
// interpret mode, and the ring's barrier protocol under random
// interleavings:
//   JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_bf16_conv_tma.py
// On the card, python3 chip_smoke.py holds every tile against the plain
// bf16 conv and times the plan against "wgmma" at every family shape.

constexpr int kTmaCh = 64;       // channels of a K slice: one 128-byte row
constexpr int kTmaPix = 128;     // pixels of one im2col copy (BM 64: 64)
constexpr int kTmaRow = 128;     // bytes of a stage's row
constexpr int kTmaSw = 1024;     // the 128-byte swizzle's period: 8 rows
constexpr int kTmaBox = kTmaCh * kTmaRow;   // a 64 x 64 box of w: 8192 B

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// spins until the phase of parity `parity` has completed; a wait that
// outlasts kTmaWaitCycles (about 2 s: a fault in the ring's protocol)
// traps, so the launch fails instead of hanging the card
constexpr long long kTmaWaitCycles = 4000000000LL;
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > kTmaWaitCycles) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// pixels of A: channels [c, c+64) of the pixels the im2col map walks from
// tap (0,0) at (w, h) of image n, each shifted by the tap (dx, dy)
__device__ __forceinline__ void tma_im2col(uint32_t dst, const CUtensorMap* map,
                                           uint32_t bar, int c, int w, int h,
                                           int n, uint16_t dx, uint16_t dy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h),
      "r"(n), "h"(dx), "h"(dy)
      : "memory");
}
// a 64 x 64 box of w: columns [c0, c0+64) of k rows [c1, c1+64)
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// a shared-memory matrix descriptor of a 128-byte-swizzled operand: layout
// type B128 (bits 62-63 = 1), base offset 0 (the stages are 1024-aligned)
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t saddr,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  return wgmma_desc(saddr, lbo, sbo) | (1ull << 62);
}

template <int BN, int BM>
__host__ __device__ constexpr int tma_stage_bytes() {
  return BM * kTmaRow + (BN / kTmaCh) * kTmaBox;
}
// the ring's stages that a K of `kt` slices uses (a 1x1 over 64 channels
// fills one), at least the output tile that aliases them, and the slack
// that aligns them to 1024 bytes: fewer stages let more blocks share an SM
template <int BN, int BM, int S>
__host__ __device__ constexpr int tma_smem_bytes(int kt) {
  return (kt < S ? (kt * tma_stage_bytes<BN, BM>() > BM * (BN + 8) * 2
                        ? kt * tma_stage_bytes<BN, BM>()
                        : BM * (BN + 8) * 2)
                 : S * tma_stage_bytes<BN, BM>()) +
         kTmaSw;
}

template <int BN, int BM, int S, int NC>
__global__ void __launch_bounds__(kWgThreads * NC + 32)
    conv2d_bf16_tma_kernel(const __grid_constant__ CUtensorMap tmx,
                           const __grid_constant__ CUtensorMap tmw,
                           const __nv_bfloat16* __restrict__ bias,
                           __nv_bfloat16* __restrict__ y, int Ho, int Wo,
                           int M, int Cout, int k, int s, int p, int cc,
                           bool relu) {
  constexpr int MT = BM / 64 / NC;     // m64 tiles of a consumer warpgroup
  constexpr int kPix = BM < kTmaPix ? BM : kTmaPix;
  constexpr int kA = BM * kTmaRow;
  constexpr int kStage = tma_stage_bytes<BN, BM>();
  constexpr int kNAcc = BN / 2;
  constexpr int kOutStride = BN + 8;   // bf16 per row of the output tile
  constexpr uint32_t kTx = ((kWgProbe & 2) ? 0 : kA) +
                           ((kWgProbe & 4) ? 0 : kStage - kA);
  static_assert((BN == 64 || BN == 128) && MT >= 1 && MT * 64 * NC == BM &&
                    (NC == 1 || NC == 2) && S >= 3 && S <= 8,
                "tile");
  static_assert(BM * kOutStride * 2 <= S * kStage,
                "the output tile aliases the ring");
  static_assert(kTmaSw + S * kStage <= 227 * 1024, "shared memory");
  extern __shared__ unsigned char smem_tma[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  unsigned char* smem =
      smem_tma + (kTmaSw - smem_u32(smem_tma) % kTmaSw) % kTmaSw;
  const uint32_t ring = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = k * k * cc;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {   // the producer warp: one lane issues every copy
    if ((tid & 31) == 0) {
      // tap (0,0) of each copy's first pixel; a copy wholly past M starts
      // in an image past the last, all zero-filled
      int cw[BM / kPix], ch[BM / kPix], cn[BM / kPix];
#pragma unroll
      for (int j = 0; j < BM / kPix; ++j) {
        const int m = m0 + j * kPix, ox = m % Wo, q = m / Wo;
        cw[j] = ox * s - p;
        ch[j] = (q % Ho) * s - p;
        cn[j] = q / Ho;
      }
      for (int kt = 0; kt < KT; ++kt) {
        const int st = kt % S;
        mbar_wait(smem_u32(&empty[st]), ((kt / S) & 1) ^ 1);
        const int tap = kt / cc, c = (kt - tap * cc) * kTmaCh;
        const int dy = tap / k, dx = tap - dy * k;
        const uint32_t sa = ring + st * kStage, sb = sa + kA;
        const uint32_t bar = smem_u32(&full[st]);
        mbar_expect_tx(bar, kTx);
        if (!(kWgProbe & 2)) {
#pragma unroll
          for (int j = 0; j < BM / kPix; ++j)
            tma_im2col(sa + j * kPix * kTmaRow, &tmx, bar, c, cw[j], ch[j],
                       cn[j], (uint16_t)dx, (uint16_t)dy);
        }
        if (!(kWgProbe & 4)) {
#pragma unroll
          for (int j = 0; j < BN / kTmaCh; ++j)
            tma_tile(sb + j * kTmaBox, &tmw, bar, n0 + j * kTmaCh,
                     kt * kTmaCh);
        }
      }
    }
  } else {   // NC consumer warpgroups, MT m64 tiles each
    const int wg = warp >> 2, t = tid & (kWgThreads - 1);
    float acc[MT][kNAcc];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < kNAcc; ++e) acc[i][e] = 0.f;
    for (int kt = 0; kt < KT; ++kt) {
      const int st = kt % S;
      mbar_wait(smem_u32(&full[st]), (kt / S) & 1);
      const uint32_t sa = ring + st * kStage + wg * MT * 64 * kTmaRow;
      const uint32_t sb = ring + st * kStage + kA;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kTmaCh / 16; ++ks) {
        const uint64_t db =
            wgmma_desc_sw128(sb + ks * 16 * kTmaRow, kTmaBox, kTmaSw);
#pragma unroll
        for (int i = 0; i < MT && !(kWgProbe & 1); ++i)
          wgmma_bn<BN>(acc[i],
                       wgmma_desc_sw128(sa + i * 64 * kTmaRow + ks * 32, 16,
                                        kTmaSw),
                       db);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the group of slice kt-1 is done: free its stage
      if (kt > 0 && t == 0) mbar_arrive(smem_u32(&empty[(kt - 1) % S]));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < kNAcc; ++e) reg_fence(acc[i][e]);
    // every consumer's wgmmas are done (and every copy landed: each stage
    // was waited for): the output tile may overwrite the ring
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWgThreads * NC) : "memory");
    __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem);
    const int wp = (t >> 5), lane = t & 31, g = lane >> 2, tt = lane & 3;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * tt;
      const bool nok = n0 + n < Cout;
      const float b0 = nok ? __bfloat162float(bias[n0 + n]) : 0.f;
      const float b1 = nok ? __bfloat162float(bias[n0 + n + 1]) : 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 4 * j + 2 * half;
          float v0 = acc[i][e] + b0, v1 = acc[i][e + 1] + b1;
          if (relu) {
            v0 = v0 > 0.f ? v0 : 0.f;
            v1 = v1 > 0.f ? v1 : 0.f;
          }
          const int r = (wg * MT + i) * 64 + 16 * wp + g + 8 * half;
          *reinterpret_cast<__nv_bfloat162*>(so + r * kOutStride + n) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWgThreads * NC) : "memory");
    for (int c = tid; c < BM * (BN / 8); c += kWgThreads * NC) {
      const int r = c / (BN / 8), j = c - r * (BN / 8);
      const int m = m0 + r, n = n0 + 8 * j;
      if (m < M && n < Cout)
        *reinterpret_cast<int4*>(y + (int64_t)m * Cout + n) =
            *reinterpret_cast<const int4*>(so + r * kOutStride + 8 * j);
    }
  }
}

// libcuda's tensor-map encoders (CUDA 12's signatures), looked up once
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

void* cuda_entry_point(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault,
                                       &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return fn;
}

// x's im2col map (BM-row copies of `pix` pixels) and w's tiled map
cudaError_t tma_maps(CUtensorMap* mx, CUtensorMap* mw,
                     const __nv_bfloat16* x, const __nv_bfloat16* w, int B,
                     int H, int W, int Cin, int Cout, int k, int s, int p,
                     int pix) {
  static EncodeIm2col im2col = reinterpret_cast<EncodeIm2col>(
      cuda_entry_point("cuTensorMapEncodeIm2col"));
  static EncodeTiled tiled = reinterpret_cast<EncodeTiled>(
      cuda_entry_point("cuTensorMapEncodeTiled"));
  if (!im2col || !tiled) return cudaErrorSymbolNotFound;
  const cuuint64_t xdim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t xstride[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                 (cuuint64_t)H * W * Cin * 2};
  const int lower[2] = {-p, -p}, upper[2] = {p - (k - 1), p - (k - 1)};
  const cuuint32_t xes[4] = {1, (cuuint32_t)s, (cuuint32_t)s, 1};
  if (im2col(mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<__nv_bfloat16*>(x), xdim, xstride, lower, upper,
             kTmaCh, pix, xes, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t wdim[2] = {(cuuint64_t)Cout, (cuuint64_t)k * k * Cin};
  const cuuint64_t wstride[1] = {(cuuint64_t)Cout * 2};
  const cuuint32_t box[2] = {kTmaCh, kTmaCh}, wes[2] = {1, 1};
  if (tiled(mw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<__nv_bfloat16*>(w), wdim, wstride, box, wes,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int BN, int BM, int S, int NC>
cudaError_t launch_bf16_tma(cudaStream_t stream, const __nv_bfloat16* x,
                            const __nv_bfloat16* w, const __nv_bfloat16* b,
                            __nv_bfloat16* y, int B, int H, int W, int Cin,
                            int Cout, int k, int s, int p, bool relu) {
  const int Ho = (H + 2 * p - k) / s + 1, Wo = (W + 2 * p - k) / s + 1;
  const int M = B * Ho * Wo;
  CUtensorMap mx, mw;
  const cudaError_t e = tma_maps(&mx, &mw, x, w, B, H, W, Cin, Cout, k, s, p,
                                 BM < kTmaPix ? BM : kTmaPix);
  if (e != cudaSuccess) return e;
  // the attribute allows the whole ring (a graph may hold launches of
  // either size); the launch asks for what this K uses
  const int smem = tma_smem_bytes<BN, BM, S>(k * k * (Cin / kTmaCh));
  constexpr int kMax = tma_smem_bytes<BN, BM, S>(S);
  if (kMax > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        conv2d_bf16_tma_kernel<BN, BM, S, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMax);
    if (a != cudaSuccess) return a;
  }
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv2d_bf16_tma_kernel<BN, BM, S, NC>
      <<<grid, kWgThreads * NC + 32, smem, stream>>>(
          mx, mw, b, y, Ho, Wo, M, Cout, k, s, p, Cin / kTmaCh, relu);
  return cudaGetLastError();
}

}  // namespace

// variant: the order of BF16_VARIANTS in ops/hopper/conv.py (0 gather, 1
// vec, 2 strip, 3 wgmma, 4 tma); tile: an id into that variant's table
// (BF16_TILES, BF16_STRIP_TILES, WGMMA_TILES or TMA_TILES)
extern "C" int cnn_conv2d_bias_relu_bf16(void* stream, const void* x,
                                         const void* w, const void* b,
                                         void* y, int B, int H, int W,
                                         int Cin, int Cout, int k,
                                         int stride, int pad, int relu,
                                         int variant, int tile) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  if (Cout % 8 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      ya % 4 != 0 || !pad_ok(H, W, k, pad) ||
      (variant == 1 && (Cin % 8 != 0 || xa % 16 != 0)) ||
      (variant == 2 && (B > 65535 || xa % 16 != 0 || ya % 16 != 0)) ||
      (variant == 3 && (Cin % 8 != 0 || xa % 16 != 0 || ya % 16 != 0 ||
                        (Cout + 15) / 16 > 65535)) ||
      (variant == 4 && (Cin % kTmaCh != 0 || xa % 16 != 0 || ya % 16 != 0 ||
                        stride > 8 || (Cout + 63) / 64 > 65535)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(b);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  const bool r = relu != 0;
  switch (variant) {
    case 0: return (int)launch_bf16_tile<false>(tile, st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
    case 1: return (int)launch_bf16_tile<true>(tile, st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
    case 2:
      switch (tile) {   // (R, widened), in the order of BF16_STRIP_TILES
        case 0: return (int)launch_bf16_strip<1, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 1: return (int)launch_bf16_strip<2, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 2: return (int)launch_bf16_strip<4, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 3: return (int)launch_bf16_strip<8, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 4: return (int)launch_bf16_strip<1, true>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 5: return (int)launch_bf16_strip<2, true>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 6: return (int)launch_bf16_strip<4, true>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 7: return (int)launch_bf16_strip<8, true>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        default: return (int)cudaErrorInvalidValue;
      }
    case 3:
      switch (tile) {   // (BN, MT, BK, S, SPLIT, A via L1), in the order of WGMMA_TILES
        case 0: return (int)launch_bf16_wgmma<16, 1, 32, 4, 1, true>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 1: return (int)launch_bf16_wgmma<32, 1, 32, 4, 1, true>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 2: return (int)launch_bf16_wgmma<32, 2, 32, 4, 1, true>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 3: return (int)launch_bf16_wgmma<32, 2, 32, 6, 1, true>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 4: return (int)launch_bf16_wgmma<64, 1, 32, 4, 1, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 5: return (int)launch_bf16_wgmma<64, 1, 32, 8, 1, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 6: return (int)launch_bf16_wgmma<64, 1, 32, 4, 2, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 7: return (int)launch_bf16_wgmma<64, 2, 32, 4, 1, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 8: return (int)launch_bf16_wgmma<64, 2, 32, 6, 1, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 9: return (int)launch_bf16_wgmma<128, 1, 32, 8, 1, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 10: return (int)launch_bf16_wgmma<128, 1, 32, 4, 2, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 11: return (int)launch_bf16_wgmma<128, 2, 32, 4, 1, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 12: return (int)launch_bf16_wgmma<128, 2, 32, 6, 2, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 13: return (int)launch_bf16_wgmma<128, 2, 64, 4, 1, false>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        default: return (int)cudaErrorInvalidValue;
      }
    case 4:
      switch (tile) {   // (BN, BM, S, NC), in the order of TMA_TILES
        case 0: return (int)launch_bf16_tma<64, 64, 6, 1>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 1: return (int)launch_bf16_tma<64, 128, 4, 1>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 2: return (int)launch_bf16_tma<64, 128, 4, 2>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 3: return (int)launch_bf16_tma<64, 128, 6, 1>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 4: return (int)launch_bf16_tma<64, 256, 4, 2>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 5: return (int)launch_bf16_tma<128, 64, 6, 1>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 6: return (int)launch_bf16_tma<128, 128, 4, 1>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 7: return (int)launch_bf16_tma<128, 128, 4, 2>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        case 8: return (int)launch_bf16_tma<128, 256, 3, 2>(st, xb, wb, bb, yb, B, H, W, Cin, Cout, k, stride, pad, r);
        default: return (int)cudaErrorInvalidValue;
      }
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The float32 pointwise kernel (cnn_conv2d_bias_relu_pw): a 1x1 conv with no
// padding (MobileNet's pw_1-pw_6, ResNet's stride-2 projections), the k = 1
// case of conv2d_bias_relu_pallas: y[m, n] = ReLU(sum over ci of x[m, ci] *
// w[0,0,ci,n] + b[n]), M = B*Ho*Wo output pixels, K = Cin, N = Cout.
//
//  - Bound on this card: bytes and float32 operations about equally at
//    MobileNet's pw_2 ([64,56,56,64] -> 128: x 51.4 MB, y 102.8 MB, 0.046
//    ms at 3.35 TB/s; 3.29 GFLOP, 0.049 ms at 67 TFLOP/s), bytes for
//    K = 16-32, operations for K = 128-256. So an SM has to multiply one
//    tile while the tile before it drains to memory and the tile after it
//    arrives. The tiled kernel above runs each BM x BN tile through a
//    prologue, a K loop of 8-float slices and a store from registers, one
//    tile a block: at K = 64 the fill, the drain and the store are a large
//    share of every block, and every block fetches its weight slice again.
//  - A persistent grid: each block owns one N range of BN columns
//    (blockIdx.y) and walks the M tiles blockIdx.x, blockIdx.x + gridDim.x,
//    ... (ops/hopper/conv.py:conv_tile_plan gives gridDim.x: the 132 SMs
//    over the N ranges, one block each).
//  - Weights resident: the block's [Cin x BN] slice of w (zero past Cout)
//    goes into shared memory once, before its first tile; every M tile
//    reads it there.
//  - A ring of S stages that runs on across tiles: one producer lane
//    copies each K slice of A (BM pixels x 32 channels, one 128-byte row a
//    pixel, the 128-byte swizzle) with cp.async.bulk.tensor under full /
//    empty mbarriers; the slices of the next tiles are in flight while the
//    consumers finish a tile and run its epilogue. Stride 1: x is a
//    row-major [M, Cin] matrix, a 2-D tiled map. Stride s > 1: an im2col
//    map over NHWC (C, W, H, N) with traversal strides {1, s, s, 1}, corners
//    0 (a 1x1 window), copies of up to 128 pixels that walk across rows
//    and images. Rows past M and channels past Cin are zero-filled.
//  - 256 consumer threads, each a TM x TN micro-tile as in the tiled
//    kernel (rows tm + i*BM/TM, column groups of 4 at tn*4 + g*BN/(TN/4));
//    a warp is 4 values of tm by 8 of tn. A row's 16-byte chunk c sits at
//    chunk c ^ (row % 8) of its 128-byte row, and a warp's 4 rows differ
//    in row % 8, so a read of A is one wavefront, as is a read of 8
//    neighbouring 16-byte words of w. The sum over ci = 0 .. Cin-1 is one
//    fmaf chain from 0 in ci order, then + bias, then the optional ReLU:
//    the direct kernel's arithmetic, so the two give the same bits. No
//    split of K, no atomics: two launches are bit-identical.
//  - Epilogue: bias and ReLU in registers, the tile into a staging buffer
//    in shared memory, then one bulk tensor store (clipped at M and Cout)
//    that drains while the block computes its next tile; before the next
//    tile overwrites the staging, the thread that issued the store waits
//    for it to have been read (cp.async.bulk.wait_group.read).
//  - (BM, BN, TM, TN, S) are template arguments; the switch maps ids to
//    them in the order of PW_TILES in ops/hopper/conv.py, whose plan
//    (pw_tile_for) picks one by shape and checks the shared memory
//    (pw_smem_bytes: the ring, the staging, the weights, 1 KB of
//    alignment) against kPwSmemMax. The tensor maps are encoded per call
//    and passed as __grid_constant__ parameters, as for the tma kernel.
//
// Tests. On the CPU, the plan and a torch emulation of this walk (the
// persistent order of tiles, the swizzled stages, the fmaf order, the
// staged epilogue and the clipped store) against the plain conv and the
// Pallas kernel in interpret mode:
//   JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_conv_plan.py
// On the card, python3 chip_smoke.py holds it bit for bit against the direct
// kernel at every 1x1 of the families.

namespace {

// CONV_PW_PROBE (tools/conv_bf16_probe.py): bit 1 skips the FMAs (and
// their shared-memory reads), 2 the copies of A (the producer arrives on
// the stage's barrier instead), 4 the stores of the output tiles
#ifndef CONV_PW_PROBE
#define CONV_PW_PROBE 0
#endif
constexpr int kPwProbe = CONV_PW_PROBE;

constexpr int kPwCh = 32;             // channels of a K slice: 128 bytes
constexpr int kPwRow = kPwCh * 4;     // bytes of a staged pixel
constexpr int kPwPix = 128;           // pixels of one im2col copy
constexpr int kPwConsumers = 256;     // consumer threads of a block
constexpr int kPwSmemMax = 226 * 1024;

__host__ __device__ inline int pw_smem_bytes(int BM, int BN, int S,
                                             int Cin) {
  return kTmaSw + S * BM * kPwRow + BM * BN * 4 + Cin * BN * 4;
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void pw_sync() {   // the consumers only
  asm volatile("bar.sync 1, %0;\n" ::"n"(kPwConsumers) : "memory");
}

// kFull: Cin % 32 == 0, every K slice whole (no test of the chunks left)
template <int BM, int BN, int TM, int TN, int S, bool kFull>
__global__ void __launch_bounds__(kPwConsumers + 32, 1)
    conv2d_pw_kernel(const __grid_constant__ CUtensorMap tmx,
                     const __grid_constant__ CUtensorMap tmy,
                     const float* __restrict__ w,
                     const float* __restrict__ bias, int M, int Cin,
                     int Cout, int Ho, int Wo, int s, bool relu) {
  constexpr int kGroups = TN / 4;          // column groups of 4 per thread
  constexpr int kGroupStride = BN / kGroups;
  constexpr int kRowStep = BM / TM;        // a thread's rows: tm + i*kRowStep
  constexpr int kStage = BM * kPwRow;
  constexpr int kPix = BM < kPwPix ? BM : kPwPix;
  constexpr int kWarpsN = BN / TN / 8;     // warps across a row of threads
  static_assert((BM / TM) * (BN / TN) == kPwConsumers && TN % 4 == 0 &&
                    kRowStep % 8 == 0 && (BN / TN) % 8 == 0 &&
                    BM % kPix == 0 && BM <= 256 && BN <= 256 && S >= 2,
                "tile");
  extern __shared__ unsigned char smem_pw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  unsigned char* smem =
      smem_pw + (kTmaSw - smem_u32(smem_pw) % kTmaSw) % kTmaSw;
  const uint32_t ring = smem_u32(smem);
  float* so = reinterpret_cast<float*>(smem + S * kStage);   // output tile
  float* sw = so + BM * BN;                                  // [Cin][BN]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const int KT = (Cin + kPwCh - 1) / kPwCh;
  const int tiles = (M + BM - 1) / BM;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(smem_u32(&full[i]), 1);
      mbar_init(smem_u32(&empty[i]), kPwConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kPwConsumers) {   // the producer warp: one lane copies
    if (tid == kPwConsumers) {
      int q = 0;   // slices issued, over every tile of this block
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t * BM;
        for (int kt = 0; kt < KT; ++kt, ++q) {
          const int st = q % S;
          mbar_wait(smem_u32(&empty[st]), ((q / S) & 1) ^ 1);
          const uint32_t dst = ring + st * kStage;
          const uint32_t bar = smem_u32(&full[st]);
          if (kPwProbe & 2) {
            mbar_arrive(bar);
            continue;
          }
          mbar_expect_tx(bar, kStage);
          if (s == 1) {
            tma_tile(dst, &tmx, bar, kt * kPwCh, m0);
          } else {
            for (int j = 0; j < BM / kPix; ++j) {
              // a copy wholly past M starts in an image past the last
              const int m = m0 + j * kPix, ox = m % Wo, r = m / Wo;
              tma_im2col(dst + j * kPix * kPwRow, &tmx, bar, kt * kPwCh,
                         ox * s, (r % Ho) * s, r / Ho, 0, 0);
            }
          }
        }
      }
    }
    return;
  }

  // a warp holds 4 rows x 8 column groups of threads, so that its reads
  // of A hit 4 rows (row % 8 apart: one wavefront) and its reads of w 8
  // neighbouring 16-byte words (one wavefront)
  const int warp = tid >> 5, lane = tid & 31;
  const int tm = (warp / kWarpsN) * 4 + (lane >> 3);
  const int tn = (warp % kWarpsN) * 8 + (lane & 7);
  // the block's weight slice, zero past Cout, and this thread's biases
  for (int c = tid; c < Cin * (BN / 4); c += kPwConsumers) {
    const int r = c / (BN / 4), j = (c % (BN / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n0 + j < Cout)
      v = __ldg(reinterpret_cast<const float4*>(w + (int64_t)r * Cout + n0 +
                                                j));
    *reinterpret_cast<float4*>(sw + r * BN + j) = v;
  }
  float bv[TN];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + g * kGroupStride + tn * 4 + j;
      bv[g * 4 + j] = n < Cout ? __ldg(bias + n) : 0.f;
    }
  pw_sync();

  const int sx = tm & 7;   // row % 8 of every row this thread reads
  int q = 0;               // slices consumed
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++q) {
      const int st = q % S;
      mbar_wait(smem_u32(&full[st]), (q / S) & 1);
      const float* As = reinterpret_cast<const float*>(smem + st * kStage);
      const float* Ws = sw + kt * kPwCh * BN;
      const int chunks =
          kFull ? kPwCh / 4 : min(kPwCh, Cin - kt * kPwCh) / 4;
#pragma unroll
      for (int c = 0; c < kPwCh / 4; ++c) {
        if (c >= chunks || (kPwProbe & 1)) break;
        float a[TM][4];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              As + (tm + i * kRowStep) * kPwCh + ((c ^ sx) * 4));
          a[i][0] = v.x;
          a[i][1] = v.y;
          a[i][2] = v.z;
          a[i][3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float b[TN];
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(
                Ws + (c * 4 + e) * BN + g * kGroupStride + tn * 4);
            b[g * 4 + 0] = v.x;
            b[g * 4 + 1] = v.y;
            b[g * 4 + 2] = v.z;
            b[g * 4 + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a[i][e], b[j], acc[i][j]);
        }
      }
      __syncwarp();   // the warp's reads of the stage are done: free it
      if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
    }

    // epilogue: the previous tile's store has read the staging, then this
    // tile goes there, then one store of it
    if (tid == 0) bulk_wait_read();
    pw_sync();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float u = acc[i][g * 4 + j] + bv[g * 4 + j];
          v[j] = relu ? (u > 0.f ? u : 0.f) : u;
        }
        *reinterpret_cast<float4*>(so + (tm + i * kRowStep) * BN +
                                   g * kGroupStride + tn * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    // the staging's writes, seen by the bulk copy (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    pw_sync();
    if (tid == 0) {
      if (!(kPwProbe & 4)) tma_store_2d(&tmy, smem_u32(so), n0, t * BM);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();
}

// x's map (stride 1: [M, Cin] tiled, boxes of 32 channels x BM rows;
// stride s: im2col over NHWC, 32 channels x kPix pixels a copy), both with
// the 128-byte swizzle, and y's [M, Cout] tiled map, boxes of BN x BM
cudaError_t pw_maps(CUtensorMap* mx, CUtensorMap* my, const float* x,
                    const float* y, int B, int H, int W, int Cin, int Cout,
                    int s, int M, int BM, int BN) {
  static EncodeIm2col im2col = reinterpret_cast<EncodeIm2col>(
      cuda_entry_point("cuTensorMapEncodeIm2col"));
  static EncodeTiled tiled = reinterpret_cast<EncodeTiled>(
      cuda_entry_point("cuTensorMapEncodeTiled"));
  if (!im2col || !tiled) return cudaErrorSymbolNotFound;
  const cuuint32_t one[4] = {1, 1, 1, 1};
  if (s == 1) {
    const cuuint64_t dim[2] = {(cuuint64_t)Cin, (cuuint64_t)M};
    const cuuint64_t stride[1] = {(cuuint64_t)Cin * 4};
    const cuuint32_t box[2] = {kPwCh, (cuuint32_t)BM};
    if (tiled(mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x),
              dim, stride, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  } else {
    const cuuint64_t dim[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
    const cuuint64_t stride[3] = {(cuuint64_t)Cin * 4,
                                  (cuuint64_t)W * Cin * 4,
                                  (cuuint64_t)H * W * Cin * 4};
    const int lower[2] = {0, 0}, upper[2] = {0, 0};
    const cuuint32_t es[4] = {1, (cuuint32_t)s, (cuuint32_t)s, 1};
    if (im2col(mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x),
               dim, stride, lower, upper, kPwCh, BM < kPwPix ? BM : kPwPix,
               es, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  const cuuint64_t ydim[2] = {(cuuint64_t)Cout, (cuuint64_t)M};
  const cuuint64_t ystride[1] = {(cuuint64_t)Cout * 4};
  const cuuint32_t ybox[2] = {(cuuint32_t)BN, (cuuint32_t)BM};
  if (tiled(my, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(y),
            ydim, ystride, ybox, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int BM, int BN, int TM, int TN, int S>
cudaError_t launch_pw(cudaStream_t stream, const float* x, const float* w,
                      const float* b, float* y, int B, int H, int W, int Cin,
                      int Cout, int s, bool relu, int blocks) {
  const int Ho = (H - 1) / s + 1, Wo = (W - 1) / s + 1;
  const int M = B * Ho * Wo;
  const int smem = pw_smem_bytes(BM, BN, S, Cin);
  if (smem > kPwSmemMax) return cudaErrorInvalidValue;
  CUtensorMap mx, my;
  const cudaError_t e = pw_maps(&mx, &my, x, y, B, H, W, Cin, Cout, s, M,
                                BM, BN);
  if (e != cudaSuccess) return e;
  // the attribute allows the largest launch (a graph may hold several)
  auto kernel = Cin % kPwCh == 0 ? conv2d_pw_kernel<BM, BN, TM, TN, S, true>
                                 : conv2d_pw_kernel<BM, BN, TM, TN, S, false>;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPwSmemMax);
  if (a != cudaSuccess) return a;
  const dim3 grid(blocks, (Cout + BN - 1) / BN);
  kernel<<<grid, kPwConsumers + 32, smem, stream>>>(mx, my, w, b, M, Cin,
                                                    Cout, Ho, Wo, s, relu);
  return cudaGetLastError();
}

}  // namespace

// x, w, b, y, B, H, W, Cin, Cout, k, stride, pad, relu as the other float32
// entry points (k must be 1 and pad 0), then the tile id of PW_TILES in
// ops/hopper/conv.py and the grid's x (blocks a column range)
extern "C" int cnn_conv2d_bias_relu_pw(void* stream, const void* x,
                                       const void* w, const void* b, void* y,
                                       int B, int H, int W, int Cin, int Cout,
                                       int k, int stride, int pad, int relu,
                                       int tile, int blocks) {
  if (k != 1 || pad != 0 || Cin % 4 != 0 || Cout % 4 != 0 || stride < 1 ||
      stride > 8 || blocks < 1 || B < 1 || H > kExtentMax ||
      W > kExtentMax || (Cout + 63) / 64 > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  const bool r = relu != 0;
  switch (tile) {   // (BM, BN, TM, TN, S), in the order of PW_TILES
    case 0: return (int)launch_pw<128, 128, 8, 8, 4>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, stride, r, blocks);
    case 1: return (int)launch_pw<128, 128, 8, 8, 2>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, stride, r, blocks);
    case 2: return (int)launch_pw<256, 64, 8, 8, 3>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, stride, r, blocks);
    case 3: return (int)launch_pw<128, 64, 8, 4, 4>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, stride, r, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}
