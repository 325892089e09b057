// uint8 -> float32 normalize, x / 255 (true division), for NVIDIA Hopper.
//
// Replaces: cnn_tpu/ops/pallas/normalize.py, uint8_normalize_pallas
// (kernel body _normalize_kernel), which converts a [B,H,W,C] uint8 batch
// over a flat (rows, 128) view.
//
// Bound on this card: bytes. Each element reads 1 byte and writes 4 and
// does one division, far below the H100's operations-per-byte line.
//
// Design: a grid-stride loop over the flat buffer, four elements per step
// (one 4-byte load, one 16-byte store) when both pointers allow it, then a
// scalar tail, so any element count works (no multiple-of-128 rule). The
// division is the IEEE one (this file is built without --use_fast_math), so
// the result is bit-identical to the plain version's x.float() / 255.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void normalize_u8_kernel(const uint8_t* __restrict__ x,
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

extern "C" int cnn_normalize_u8(void* stream, const void* x, void* y,
                                int64_t n) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const int threads = 256;
  const int64_t work = vec ? (n / 4 > 0 ? n / 4 : 1) : n;
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride covers the rest
  if (blocks < 1) blocks = 1;
  normalize_u8_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(x), static_cast<float*>(y), n, vec);
  return (int)cudaGetLastError();
}
