// uint8 -> float32 normalize, x / 255 (true division), for NVIDIA Hopper.
//
// Replaces: cnn_tpu/ops/pallas/normalize.py, uint8_normalize_pallas
// (kernel body _normalize_kernel), which converts a [B,H,W,C] uint8 batch
// over a flat (rows, 128) view.
//
// Bound on this card: bytes. Each element reads 1 byte and writes 4; at the
// serving batch [64,224,224,3] that is 48.2 MB, 0.0144 ms at 3.35 TB/s.
// Reaching it takes wide accesses and enough of them in flight.
//
// Design (cnn_normalize_u8): the buffer is cut into 16-element chunks. A
// thread reads a chunk with one 16-byte read-only load and writes 64 bytes
// with four 16-byte stores, and has two chunks in flight a trip of a
// grid-stride loop, both loads issued before any store. Stores by the
// thread that loaded would leave 48 bytes between neighbouring lanes, two
// L2 sector writes of 16 bytes where one of 32 would do (the first build
// of this design ran at half the previous kernel's speed so); so each warp
// stages its 32 loaded chunks in shared memory (1 KB a warp, conflict-free)
// and store j of lane l takes staged word 32 j + l: each store instruction
// writes 512 consecutive bytes. The chunks start at the first element
// whose input byte and output float are both 16-byte aligned; the `head`
// elements before it and the 0-15 after the last chunk are converted one a
// thread by the grid's first threads, in the same launch, so any length and
// alignment works. Where no element has both aligned ((4 * x - y) % 16 !=
// 0), the plan takes the `bytes` variant: chunks aligned on the output
// (four fifths of the bytes), each read as the 4-byte words that hold it,
// funnel-shifted into place. The grid comes from
// ops/hopper/normalize.py:normalize_plan: whole waves of 8 blocks of 256
// threads on each of the 132 SMs (__launch_bounds__ holds the registers to
// that), or fewer blocks where the work is less than one wave.
//
// The division: q = x * r with r = float(1/255), then one fmaf correction,
// q + fmaf(-q, 255, x) * r. That is correctly rounded for all 256 bytes
// (tests/test_torch_normalize_plan.py checks it in exact arithmetic), so the
// result is bit-identical to the plain version's IEEE x.float() / 255. The
// library is built without --use_fast_math.
//
// cnn_normalize_u8_direct is the previous design, on no path: a grid-stride
// loop of one 4-byte load and one 16-byte store a step (when x % 4 == 0 and
// y % 16 == 0, else scalar), at most 132 x 16 blocks, IEEE division.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;   // normalize.py:BLOCKS_PER_SM
constexpr int kChunk = 16;        // elements (input bytes) a chunk

__device__ __forceinline__ float div255(float v) {
  const float r = 0x1.010102p-8f;  // float(1/255)
  const float q = __fmul_rn(v, r);
  return __fmaf_rn(__fmaf_rn(-q, 255.0f, v), r, q);
}

__device__ __forceinline__ float4 convert4(uint32_t w) {
  return make_float4(div255((float)(w & 0xffu)),
                     div255((float)((w >> 8) & 0xffu)),
                     div255((float)((w >> 16) & 0xffu)),
                     div255((float)(w >> 24)));
}

template <bool kAlignedIn>
__device__ __forceinline__ uint4 load_chunk(const uint8_t* p) {
  if constexpr (kAlignedIn) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    // the 4-byte words that hold the 16 bytes (a fifth only when p is off
    // a word: every word read holds a byte of the chunk), funnel-shifted
    // into place; the shift is one for the whole launch
    const uintptr_t at = reinterpret_cast<uintptr_t>(p);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(at & ~uintptr_t(3));
    const unsigned shift = (unsigned)(at & 3u) * 8u;
    const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2),
                   w3 = __ldg(w + 3), w4 = shift ? __ldg(w + 4) : 0u;
    return make_uint4(__funnelshift_r(w0, w1, shift),
                      __funnelshift_r(w1, w2, shift),
                      __funnelshift_r(w2, w3, shift),
                      __funnelshift_r(w3, w4, shift));
  }
}

template <bool kAlignedIn>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
normalize_u8_wide_kernel(const uint8_t* __restrict__ x, float* __restrict__ y,
                         int64_t n, int64_t head, int64_t chunks) {
  // each warp stages the 32 chunks it loads, for each of its two in
  // flight, so that its stores run over consecutive float4s
  __shared__ uint4 stage[kThreads / 32][2][32];
  const int lane = threadIdx.x & 31;
  uint4(&mine)[2][32] = stage[threadIdx.x >> 5];
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const uint8_t* xc = x + head;
  float* yc = y + head;
  // c0: the warp's first chunk (warp-uniform, so every lane reaches the
  // __syncwarp()s); lane l loads chunk c0 + l, and c0 + stride + l
  for (int64_t c0 = tid - lane; c0 < chunks; c0 += 2 * stride) {
    const int64_t base[2] = {c0, c0 + stride};
    uint4 v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (base[u] + lane < chunks)
        v[u] = load_chunk<kAlignedIn>(xc + (base[u] + lane) * kChunk);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) mine[u][lane] = v[u];
    __syncwarp();
    // store j of lane l: word 32 j + l of the 128 staged, i.e. word l % 4
    // of chunk base + 8 j + l / 4, as the float4 at that word's elements
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t* words = reinterpret_cast<const uint32_t*>(mine[u]);
      float4* out = reinterpret_cast<float4*>(yc + base[u] * kChunk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (base[u] + 8 * j + (lane >> 2) < chunks)
          out[32 * j + lane] = convert4(words[32 * j + lane]);
      }
    }
    __syncwarp();
  }
  const int64_t end = head + chunks * kChunk;   // the tail: n - end < 16
  if (tid < head) y[tid] = div255((float)x[tid]);
  if (tid < n - end) y[end + tid] = div255((float)x[end + tid]);
}

__global__ void normalize_u8_direct_kernel(const uint8_t* __restrict__ x,
                                           float* __restrict__ y, int64_t n,
                                           bool vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const uchar4* x4 = reinterpret_cast<const uchar4*>(x);
    float4* y4 = reinterpret_cast<float4*>(y);
    for (int64_t i = tid; i < n4; i += stride) {
      const uchar4 v = x4[i];
      y4[i] = make_float4((float)v.x / 255.0f, (float)v.y / 255.0f,
                          (float)v.z / 255.0f, (float)v.w / 255.0f);
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) y[i] = (float)x[i] / 255.0f;
}

}  // namespace

// variant: 0 wide (16-byte loads), 1 bytes (word loads, shifted); blocks
// and head from normalize_plan. Refuses a plan whose chunks the variant
// cannot access aligned.
extern "C" int cnn_normalize_u8(void* stream, const void* x, void* y,
                                int64_t n, int variant, int blocks,
                                int64_t head) {
  if (n < 0 || head < 0 || head > n || blocks < 1 ||
      (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  const int64_t chunks = (n - head) / kChunk;
  const uintptr_t xc = reinterpret_cast<uintptr_t>(x) + head;
  const uintptr_t yc = reinterpret_cast<uintptr_t>(y) + 4 * head;
  if (chunks > 0 && (yc % 16 != 0 || (variant == 0 && xc % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  float* yp = static_cast<float*>(y);
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0) {
    normalize_u8_wide_kernel<true><<<blocks, kThreads, 0, s>>>(xp, yp, n, head,
                                                                chunks);
  } else {
    normalize_u8_wide_kernel<false><<<blocks, kThreads, 0, s>>>(xp, yp, n,
                                                                 head, chunks);
  }
  return (int)cudaGetLastError();
}

extern "C" int cnn_normalize_u8_direct(void* stream, const void* x, void* y,
                                       int64_t n) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const int threads = 256;
  const int64_t work = vec ? (n / 4 > 0 ? n / 4 : 1) : n;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride covers the rest
  if (blocks < 1) blocks = 1;
  normalize_u8_direct_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(x), static_cast<float*>(y), n, vec);
  return (int)cudaGetLastError();
}
