// 2x2 stride-2 max pool, NHWC, for Hopper: the forward with a 2-bit tap
// index, and the backward that routes the cotangent through that tap.
//
// Replaces: cnn_tpu/ops/pallas/pool.py, _fwd_call (kernel body _fwd_kernel)
// and _bwd_call (kernel body _bwd_kernel).
// Taps are numbered 0..3 in row-major window order (00, 01, 10, 11). An
// earlier tap wins a tie: every comparison is a strict '>', exactly as in
// _fwd_kernel. Odd extents crop the last row/col (111 -> 55).
//
// Bound on this card: bytes. Each output reads four inputs and does three
// comparisons.
//
// Design: one thread per output element, channel fastest, so a warp reads
// runs of neighbouring channels and writes one contiguous run. The four
// taps of a window share cache lines with the neighbouring windows' taps,
// so each input line comes from device memory about once. The tap index is
// written as uint8 only when its pointer is not null (the serving path does
// not need it; training keeps it for the backward).
//
// Backward: dx[b, y, x, c] = g[b, y/2, x/2, c] where the window's tap is
// (y%2)*2 + x%2, else 0; the row and column that an odd extent cropped get
// 0. Bound on this card: bytes (it reads g and the tap once and writes dx
// once; no arithmetic). One thread per dx element, channel fastest: every
// element of dx is written, so the cropped row and column of the
// torch.empty output are zeros and no memset is needed. The four threads
// that read one g / tap element are neighbours in the same or the next warp
// row, so g and the tap come from device memory about once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void maxpool2x2_fwd_kernel(const float* __restrict__ x,
                                      float* __restrict__ y,
                                      uint8_t* __restrict__ tap, int B, int H,
                                      int W, int C) {
  const int H2 = H / 2, W2 = W / 2;
  const int64_t total = (int64_t)B * H2 * W2 * C;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int c = (int)(idx % C);
    int64_t t = idx / C;
    const int j = (int)(t % W2);
    t /= W2;
    const int i = (int)(t % H2);
    const int64_t b = t / H2;
    const int64_t base = ((b * H + 2 * i) * W + 2 * j) * C + c;
    const float x00 = x[base], x01 = x[base + C];
    const float x10 = x[base + (int64_t)W * C];
    const float x11 = x[base + (int64_t)W * C + C];
    const bool r0 = x01 > x00, r1 = x11 > x10;
    const float m0 = r0 ? x01 : x00, m1 = r1 ? x11 : x10;
    const bool down = m1 > m0;
    y[idx] = down ? m1 : m0;
    if (tap != nullptr) tap[idx] = down ? (r1 ? 3 : 2) : (r0 ? 1 : 0);
  }
}

__global__ void maxpool2x2_bwd_kernel(const uint8_t* __restrict__ tap,
                                      const float* __restrict__ g,
                                      float* __restrict__ dx, int B, int H,
                                      int W, int C) {
  const int H2 = H / 2, W2 = W / 2;
  const int64_t total = (int64_t)B * H * W * C;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int c = (int)(idx % C);
    int64_t t = idx / C;
    const int x = (int)(t % W);
    t /= W;
    const int y = (int)(t % H);
    const int64_t b = t / H;
    float v = 0.f;
    if (y < 2 * H2 && x < 2 * W2) {
      const int64_t o = ((b * H2 + (y >> 1)) * W2 + (x >> 1)) * C + c;
      if (__ldg(tap + o) == ((y & 1) << 1) + (x & 1)) v = __ldg(g + o);
    }
    dx[idx] = v;
  }
}

}  // namespace

extern "C" int cnn_maxpool2x2_bwd(void* stream, const void* tap, const void* g,
                                  void* dx, int B, int H, int W, int C) {
  const int64_t total = (int64_t)B * H * W * C;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  maxpool2x2_bwd_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(tap), static_cast<const float*>(g),
      static_cast<float*>(dx), B, H, W, C);
  return (int)cudaGetLastError();
}

extern "C" int cnn_maxpool2x2_fwd(void* stream, const void* x, void* y,
                                  void* tap, int B, int H, int W, int C) {
  const int64_t total = (int64_t)B * (H / 2) * (W / 2) * C;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  maxpool2x2_fwd_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<uint8_t*>(tap), B, H, W, C);
  return (int)cudaGetLastError();
}
