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
// once; no arithmetic). Two kernels, chosen by shape in ops/hopper/pool.py:
//  - the window kernel (C % 4 == 0, g 16-byte and tap 4-byte aligned): one
//    block per pooled row (blockIdx.x = b*H2 + i, so B*H2 may pass 65,535),
//    one thread per pooled pixel j and group of 4 channels. A thread makes
//    one 16-byte load of g and one 4-byte load of the four uint8 taps, and
//    four 16-byte stores of its 2x2 window into dx rows 2i and 2i+1, each
//    g where the tap matches, else 0. At C = 16 a warp covers 8 windows, 1
//    KB contiguous in each of its two dx rows. The one block-uniform
//    division splits the row index; the rest of the index math is 32-bit
//    but for the base pointers. The threads of the last pooled row and
//    column also write the cropped row and column of an odd extent (and
//    their corner) as zeros, so every element of the torch.empty output is
//    written and no memset is needed.
//  - the element kernel, the previous design (any C, any alignment): one
//    thread per dx element, channel fastest, with 64-bit index math; the
//    four threads that read one g / tap element are neighbours in the same
//    or the next warp row. It is bound by instruction issue, not bytes:
//    three 64-bit divisions and three modulos a thread, and g and the tap
//    loaded again by each of the four threads of a window.
//
// Tests. On the CPU, the backward's variant choice and a torch emulation
// of the window kernel's stores, held against the plain backward and the
// Pallas kernel in interpret mode:
//   JAX_PLATFORMS=cpu python -m pytest -q (one command)
//       tests/test_torch_pool_plan.py tests/test_torch_ops.py
// On the card, python3 chip_smoke.py builds the three kernels and holds
// each against its plain version, and the two backward kernels against
// each other, bit for bit.
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

__global__ void maxpool2x2_bwd_window_kernel(const uint8_t* __restrict__ tap,
                                             const float* __restrict__ g,
                                             float* __restrict__ dx, int H,
                                             int W, int C, int H2, int W2) {
  const int row = blockIdx.x;   // b * H2 + i
  const int b = row / H2, i = row - b * H2;
  const int C4 = C >> 2, n = W2 * C4;
  const int WC = W * C;
  // g and the tap of one pooled row are W2*C contiguous elements, and
  // thread t's four channels are the t-th group of 4 in that run
  const float4* grow =
      reinterpret_cast<const float4*>(g + (int64_t)row * W2 * C);
  const uint32_t* trow =
      reinterpret_cast<const uint32_t*>(tap + (int64_t)row * W2 * C);
  float* drow = dx + ((int64_t)b * H + 2 * i) * WC;   // dx row 2i
  const bool crop_row = (H & 1) && i == H2 - 1;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int j = t / C4;
    const float4 gv = __ldg(grow + t);
    const uint32_t tp = __ldg(trow + t);   // tap of channel c+e in byte e
    float4 o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o[q].x = (tp & 0xff) == (uint32_t)q ? gv.x : 0.f;
      o[q].y = ((tp >> 8) & 0xff) == (uint32_t)q ? gv.y : 0.f;
      o[q].z = ((tp >> 16) & 0xff) == (uint32_t)q ? gv.z : 0.f;
      o[q].w = (tp >> 24) == (uint32_t)q ? gv.w : 0.f;
    }
    float* p = drow + 2 * j * C + (t - j * C4) * 4;   // (2i, 2j, c)
    *reinterpret_cast<float4*>(p) = o[0];
    *reinterpret_cast<float4*>(p + C) = o[1];
    *reinterpret_cast<float4*>(p + WC) = o[2];
    *reinterpret_cast<float4*>(p + WC + C) = o[3];
    if (crop_row) {   // row H-1
      *reinterpret_cast<float4*>(p + 2 * WC) = zero;
      *reinterpret_cast<float4*>(p + 2 * WC + C) = zero;
    }
    if ((W & 1) && j == W2 - 1) {   // column W-1, and the corner
      *reinterpret_cast<float4*>(p + 2 * C) = zero;
      *reinterpret_cast<float4*>(p + WC + 2 * C) = zero;
      if (crop_row) *reinterpret_cast<float4*>(p + 2 * WC + 2 * C) = zero;
    }
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

extern "C" int cnn_maxpool2x2_bwd_window(void* stream, const void* tap,
                                         const void* g, void* dx, int B,
                                         int H, int W, int C) {
  const int H2 = H / 2, W2 = W / 2;
  if (C % 4 != 0 || H2 < 1 || W2 < 1 || B < 1 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(tap) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(dx) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n = W2 * (C / 4);
  const int threads = n >= 256 ? 256 : (n + 31) / 32 * 32;
  maxpool2x2_bwd_window_kernel<<<(unsigned)((int64_t)B * H2), threads, 0,
                                 (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(tap), static_cast<const float*>(g),
      static_cast<float*>(dx), H, W, C, H2, W2);
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
