// VALID k x k convolution + bias (+ ReLU), NHWC / HWIO, for Hopper: three
// float32 kernels, chosen by shape in ops/hopper/conv.py:conv_tile_plan, and
// one bf16 tensor-core kernel (the last section of this file), planned by
// ops/hopper/conv.py:conv_bf16_plan.
//
// Replaces: cnn_tpu/ops/pallas/conv.py, conv2d_bias_relu_pallas -> _forward
// (kernel body _conv_kernel): k*k shifted [Ho*Wo, Cin] x [Cin, Cout]
// products summed in f32, then + bias, then an optional ReLU, any stride,
// output extent (H - k) / stride + 1.
//
// All three are implicit GEMMs: M = B*Ho*Wo output pixels, N = Cout,
// K = k*k*Cin in (dy, dx, ci) order, in which the HWIO weights are already a
// row-major [K, N] matrix. No TF32 and no tensor cores: every sum is a chain
// of full float32 FMAs in k order, one thread per output, as the 1e-5 parity
// with the plain version and JAX's Precision.HIGHEST need. No split-K and no
// atomics, so a launch is bit-identical to the next, and the three kernels
// sum in the same order: on the same inputs they give the same bits.
//
// Bound on this card: on the AlexNet shapes, bytes for conv1 (Cin = 3, so
// K = 27 multiply-adds per output) and float32 operations for conv2-4
// (K = 144..576, 67 TFLOP/s).
//
// The strip kernel (conv1: Cin <= 4, Cout % 4 == 0 and <= 32, W*Cin % 4 ==
// 0, x 16-byte aligned). The direct kernel below holds conv1 to 5x its byte
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
//    beside them once per block.
//  - one warp per output row. Lane l owns pixels l, l+32, l+64 and l+96 of
//    a 128-pixel chunk of the row and 16 output channels of each (64
//    accumulators; wider Cout takes more passes over the chunk). Lanes sit
//    on neighbouring pixels, so their shared-memory reads of one tap are
//    s*Cin words apart (6 for conv1: a 2-way bank conflict at most; four
//    adjacent pixels a lane would put 24 words between lanes, 8-way). Each
//    weight read is a warp-wide broadcast of 16 bytes that feeds 4 pixels
//    x 4 FMAs; each input value read feeds 16 FMAs. Index math is 32-bit
//    except for the base pointers.
//  - epilogue: bias, the optional ReLU, 16-byte stores; for one pixel slot
//    the warp's stores cover 32 consecutive pixels, one contiguous run.
//  - R is a template argument; the entry point's switch maps ids to R in
//    the order of STRIP_ROWS in ops/hopper/conv.py, whose plan takes the R
//    with the most blocks (a block stages all its rows before it sums, so
//    more, shorter blocks on an SM overlap staging with sums better) and
//    checks that the staged rows and the weights fit in 48 KB of (dynamic)
//    shared memory.
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
// On the card, python3 chip_smoke.py builds the three kernels and holds
// each against the plain conv, and the strip and tiled kernels bit for bit
// against the direct one.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCoPerThread = 4;

template <bool kVec>
__global__ void conv2d_bias_relu_kernel(const float* __restrict__ x,
                                        const float* __restrict__ w,
                                        const float* __restrict__ bias,
                                        float* __restrict__ y, int B, int H,
                                        int W, int Cin, int Cout, int k, int s,
                                        int Ho, int Wo, bool relu) {
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
      const float* xrow = x + ((b * H + (int64_t)oy * s + dy) * W +
                               (int64_t)ox * s) * Cin;
      for (int dx = 0; dx < k; ++dx) {
        const float* xp = xrow + (int64_t)dx * Cin;
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
                                    int relu) {
  const int Ho = (H - k) / stride + 1, Wo = (W - k) / stride + 1;
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
        xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, Ho, Wo, relu != 0);
  else
    conv2d_bias_relu_kernel<false><<<(unsigned)blocks, threads, 0,
                                     (cudaStream_t)stream>>>(
        xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, Ho, Wo, relu != 0);
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
                        int Cout, int k, int s, int Ho, int Wo, int M,
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

  // the rows this thread copies, and their int64 bases in x
  int64_t a_base[kAIters];
  bool a_valid[kAIters];
#pragma unroll
  for (int i = 0; i < kAIters; ++i) {
    const int c = tid + i * kThreads;
    const int m = m0 + c / 2;
    a_valid[i] = c < kAChunks && m < M;
    const int mm = a_valid[i] ? m : 0;
    const int ox = mm % Wo;
    const int t = mm / Wo;
    const int oy = t % Ho;
    const int64_t b = t / Ho;
    a_base[i] = ((b * H + (int64_t)oy * s) * W + (int64_t)ox * s) * Cin +
                (c % 2) * 4;
  }

  // slices are loaded in k order: the offset of slice kt in x,
  // (dy*W + dx)*Cin + ci0, grows by 8 within a row of taps (the next dx
  // starts where the last one's channels end) and jumps by (W - k)*Cin to
  // the next dy
  int64_t koff = 0;
  int row_left = k * Cin / kBK;   // slices left in this row of taps
  auto load_slice = [&](int buf, int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kAIters; ++i) {
      const int c = tid + i * kThreads;
      if (c < kAChunks)
        cp_async16(&sa[buf][(c / 2) * kBKPad + (c % 2) * 4],
                   a_valid[i] ? x + a_base[i] + koff : x, a_valid[i]);
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
    if (--row_left == 0) {
      row_left = k * Cin / kBK;
      koff += (int64_t)(W - k) * Cin;
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
                         int Cin, int Cout, int k, int s, bool relu) {
  const int Ho = (H - k) / s + 1, Wo = (W - k) / s + 1;
  const int M = B * Ho * Wo;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv2d_tiled_kernel<BM, BN, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(x, w, b, y, H, W, Cin,
                                                   Cout, k, s, Ho, Wo, M,
                                                   relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cnn_conv2d_bias_relu_tiled(void* stream, const void* x,
                                          const void* w, const void* b,
                                          void* y, int B, int H, int W,
                                          int Cin, int Cout, int k,
                                          int stride, int relu, int tile) {
  if (Cin % kBK != 0 || Cout % 4 != 0 ||
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
    case 0: return (int)launch_tiled<128, 128, 8, 8>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, r);
    case 1: return (int)launch_tiled<64, 128, 8, 8>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, r);
    case 2: return (int)launch_tiled<128, 64, 8, 8>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, r);
    case 3: return (int)launch_tiled<64, 64, 8, 4>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, r);
    case 4: return (int)launch_tiled<128, 32, 8, 4>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, r);
    case 5: return (int)launch_tiled<64, 32, 4, 4>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, r);
    default: return (int)cudaErrorInvalidValue;
  }
}


namespace {

constexpr int kStripSlots = 4;   // pixels a lane holds: l, l+32, l+64, l+96
constexpr int kStripCo = 16;     // output channels a lane holds at once

// floats of shared memory before the staged rows: weights and bias,
// rounded up to keep the rows 16-byte aligned
__host__ __device__ inline int strip_weight_floats(int k, int Cin, int Cout) {
  return (k * k * Cin * Cout + Cout + 3) / 4 * 4;
}

template <int R>
__global__ void __launch_bounds__(R * 32)
    conv2d_strip_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ y, int H, int W, int Cin,
                        int Cout, int k, int s, int Ho, int Wo, bool relu) {
  extern __shared__ __align__(16) float smem[];
  const int nw = k * k * Cin * Cout;
  float* sw = smem;                                   // [K, Cout], then bias
  float* sx = smem + strip_weight_floats(k, Cin, Cout);
  const int oy0 = blockIdx.x * R;
  const int rows = min(R, Ho - oy0);
  const int b = blockIdx.y;
  const int rowlen = W * Cin;   // floats of one input row, a multiple of 4

  // stage the strip's input rows (one contiguous run of x) and the weights
  const int n4 = ((rows - 1) * s + k) * rowlen / 4;
  const float4* src = reinterpret_cast<const float4*>(
      x + ((int64_t)b * H + (int64_t)oy0 * s) * rowlen);
  for (int i = threadIdx.x; i < n4; i += R * 32)
    cp_async16(sx + 4 * i, src + i, true);
  cp_async_commit();
  for (int i = threadIdx.x; i < nw + Cout; i += R * 32)
    sw[i] = i < nw ? __ldg(w + i) : __ldg(bias + (i - nw));
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= rows) return;   // the last strip of an image may be short
  const float* xrow = sx + warp * s * rowlen;   // tap row dy = 0
  float* yrow = y + ((int64_t)b * Ho + oy0 + warp) * Wo * Cout;
  const float* sb = sw + nw;
  for (int c0 = 0; c0 < Wo; c0 += 32 * kStripSlots) {
    int base[kStripSlots];
    bool valid[kStripSlots];
#pragma unroll
    for (int j = 0; j < kStripSlots; ++j) {
      const int ox = c0 + 32 * j + lane;
      valid[j] = ox < Wo;
      base[j] = (valid[j] ? ox : 0) * s * Cin;   // a masked slot reads pixel 0
    }
    for (int co0 = 0; co0 < Cout; co0 += kStripCo) {
      float acc[kStripSlots][kStripCo];
#pragma unroll
      for (int j = 0; j < kStripSlots; ++j)
#pragma unroll
        for (int c = 0; c < kStripCo; ++c) acc[j][c] = 0.f;
      const float* wp = sw + co0;   // row (dy*k + dx)*Cin + ci of [K, Cout]
      for (int dy = 0; dy < k; ++dy) {
        for (int dx = 0; dx < k; ++dx) {
          const float* xp = xrow + dy * rowlen + dx * Cin;
          for (int ci = 0; ci < Cin; ++ci, wp += Cout) {
            float xv[kStripSlots];
#pragma unroll
            for (int j = 0; j < kStripSlots; ++j) xv[j] = xp[base[j] + ci];
#pragma unroll
            for (int g = 0; g < kStripCo / 4; ++g) {
              if (co0 + 4 * g >= Cout) break;
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
        if (!valid[j]) continue;
        float* yp = yrow + (int64_t)(c0 + 32 * j + lane) * Cout + co0;
#pragma unroll
        for (int g = 0; g < kStripCo / 4; ++g) {
          if (co0 + 4 * g >= Cout) break;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float t = acc[j][4 * g + e] + sb[co0 + 4 * g + e];
            v[e] = relu ? (t > 0.f ? t : 0.f) : t;
          }
          *reinterpret_cast<float4*>(yp + 4 * g) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
}

template <int R>
cudaError_t launch_strip(cudaStream_t stream, const float* x, const float* w,
                         const float* b, float* y, int B, int H, int W,
                         int Cin, int Cout, int k, int s, bool relu) {
  const int Ho = (H - k) / s + 1, Wo = (W - k) / s + 1;
  const int rows = Ho < R ? Ho : R;
  const size_t smem = 4 * ((size_t)strip_weight_floats(k, Cin, Cout) +
                           (size_t)((rows - 1) * s + k) * W * Cin);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((Ho + R - 1) / R, B);
  conv2d_strip_kernel<R><<<grid, R * 32, smem, stream>>>(
      x, w, b, y, H, W, Cin, Cout, k, s, Ho, Wo, relu);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cnn_conv2d_bias_relu_strip(void* stream, const void* x,
                                          const void* w, const void* b,
                                          void* y, int B, int H, int W,
                                          int Cin, int Cout, int k,
                                          int stride, int relu, int rows) {
  if (Cin < 1 || Cin > 4 || Cout % 4 != 0 || (W * Cin) % 4 != 0 ||
      B > 65535 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* yf = static_cast<float*>(y);
  const bool r = relu != 0;
  switch (rows) {
    case 0: return (int)launch_strip<2>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, r);
    case 1: return (int)launch_strip<4>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, r);
    case 2: return (int)launch_strip<8>(st, xf, wf, bf, yf, B, H, W, Cin, Cout, k, stride, r);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bf16: cnn_conv2d_bias_relu_bf16, an implicit GEMM on the tensor cores.
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

// the offset in x of k = (dy*k + dx)*Cin + ci from a row's base
__device__ __forceinline__ int64_t tap_offset(int kg, int Cin, int k, int W) {
  const int tap = kg / Cin, ci = kg - tap * Cin;
  const int dy = tap / k, dx = tap - dy * k;
  return (int64_t)(dy * W + dx) * Cin + ci;
}

template <int MT, int NT, bool kVecA>
__global__ void __launch_bounds__(kBfThreads)
    conv2d_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const __nv_bfloat16* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, int H, int W, int Cin,
                       int Cout, int k, int s, int Ho, int Wo, int M, int K,
                       bool relu) {
  constexpr int BM = kBfWarps * 16 * MT;
  constexpr int BN = 8 * NT;
  constexpr int kBStride = BN + 8;
  static_assert(2 * (BM * kBfAStride + kBfBK * kBStride) * 2 + BM * 8 <=
                    48 * 1024, "static shared memory");

  __shared__ __align__(16) __nv_bfloat16 sa[2][BM * kBfAStride];
  __shared__ __align__(16) __nv_bfloat16 sb[2][kBfBK * kBStride];
  __shared__ int64_t rowbase[BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  for (int r = tid; r < BM; r += kBfThreads) {
    const int m = m0 + r;
    int64_t base = -1;
    if (m < M) {
      const int ox = m % Wo, t = m / Wo;
      const int oy = t % Ho;
      const int64_t b = t / Ho;
      base = ((b * H + (int64_t)oy * s) * W + (int64_t)ox * s) * Cin;
    }
    rowbase[r] = base;
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
      const int64_t off = kok ? tap_offset(kc, Cin, k, W) : 0;
      for (int r = tid >> 2; r < BM; r += kBfThreads / 4) {
        const int64_t base = rowbase[r];
        const bool ok = kok && base >= 0;
        cp_async16(&sa[buf][r * kBfAStride + 8 * c], ok ? x + base + off : x,
                   ok);
      }
    } else {
      const int kg = k0 + lane;         // this lane's column
      const bool kok = kg < K;
      const int64_t off = kok ? tap_offset(kg, Cin, k, W) : 0;
      unsigned short* dst = reinterpret_cast<unsigned short*>(sa[buf]);
      for (int r = warp; r < BM; r += kBfWarps) {
        const int64_t base = rowbase[r];
        dst[r * kBfAStride + lane] =
            kok && base >= 0 ? xs[base + off] : (unsigned short)0;
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
                        int Cout, int k, int s, bool relu) {
  const int Ho = (H - k) / s + 1, Wo = (W - k) / s + 1;
  const int M = B * Ho * Wo;
  constexpr int BM = kBfWarps * 16 * MT, BN = 8 * NT;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv2d_bf16_kernel<MT, NT, kVecA><<<grid, kBfThreads, 0, stream>>>(
      x, w, b, y, H, W, Cin, Cout, k, s, Ho, Wo, M, k * k * Cin, relu);
  return cudaGetLastError();
}

template <bool kVecA>
cudaError_t launch_bf16_tile(int tile, cudaStream_t st,
                             const __nv_bfloat16* x, const __nv_bfloat16* w,
                             const __nv_bfloat16* b, __nv_bfloat16* y, int B,
                             int H, int W, int Cin, int Cout, int k, int s,
                             bool r) {
  switch (tile) {   // (MT, NT), in the order of BF16_TILES
    case 0: return launch_bf16<1, 2, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, r);
    case 1: return launch_bf16<1, 4, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, r);
    case 2: return launch_bf16<1, 8, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, r);
    case 3: return launch_bf16<1, 16, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, r);
    case 4: return launch_bf16<2, 2, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, r);
    case 5: return launch_bf16<2, 4, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, r);
    case 6: return launch_bf16<2, 8, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, r);
    case 7: return launch_bf16<2, 16, kVecA>(st, x, w, b, y, B, H, W, Cin, Cout, k, s, r);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int cnn_conv2d_bias_relu_bf16(void* stream, const void* x,
                                         const void* w, const void* b,
                                         void* y, int B, int H, int W,
                                         int Cin, int Cout, int k,
                                         int stride, int relu, int vec,
                                         int tile) {
  if (Cout % 8 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 4 != 0 ||
      (vec && (Cin % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(b);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  const bool r = relu != 0;
  return (int)(vec ? launch_bf16_tile<true>(tile, st, xb, wb, bb, yb, B, H, W,
                                            Cin, Cout, k, stride, r)
                   : launch_bf16_tile<false>(tile, st, xb, wb, bb, yb, B, H,
                                             W, Cin, Cout, k, stride, r));
}
