// 2x2 stride-2 max pool, NHWC, for Hopper: the forward with a 2-bit tap
// index, and the backward that routes the cotangent through that tap, in
// float32 and (the forward and the window backward) in bf16.
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
// bf16 (cnn_maxpool2x2_fwd_bf16, cnn_maxpool2x2_bwd_window_bf16): the same
// two designs, templated on the element type (Elem<T> below), because
// _fwd_call and _bwd_call keep x.dtype and g.dtype. A maximum and a route
// are exact in any type: the forward compares the bf16 values themselves
// (widened to float, exactly), so its ties and taps are the float32
// kernel's; the window backward moves 4 channels as 8 bytes (g 8-byte
// aligned) and selects each 16-bit half by its tap. Bound on this card:
// bytes, half the float32 kernels' (at batch 256 the forward with tap and
// the backward each move about 138 MB: 0.041 ms at 3.35 TB/s).
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// float and bf16 values: loaded and compared as float (exact), stored back
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float get(float v) { return v; }
  // 4 channels: one 16-byte vector
  using Vec4 = float4;
  static __device__ __forceinline__ float4 select(float4 g, uint32_t tp,
                                                  uint32_t q) {
    float4 o;
    o.x = (tp & 0xff) == q ? g.x : 0.f;
    o.y = ((tp >> 8) & 0xff) == q ? g.y : 0.f;
    o.z = ((tp >> 16) & 0xff) == q ? g.z : 0.f;
    o.w = (tp >> 24) == q ? g.w : 0.f;
    return o;
  }
  static __device__ __forceinline__ float4 zero4() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float get(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  // 4 channels: 8 bytes, channel c+e in 16-bit half e of the pair of words
  using Vec4 = uint2;
  static __device__ __forceinline__ uint2 select(uint2 g, uint32_t tp,
                                                 uint32_t q) {
    const uint32_t m0 = ((tp & 0xff) == q ? 0xffffu : 0u) |
                        (((tp >> 8) & 0xff) == q ? 0xffff0000u : 0u);
    const uint32_t m1 = (((tp >> 16) & 0xff) == q ? 0xffffu : 0u) |
                        ((tp >> 24) == q ? 0xffff0000u : 0u);
    return make_uint2(g.x & m0, g.y & m1);
  }
  static __device__ __forceinline__ uint2 zero4() { return make_uint2(0, 0); }
};

template <typename T>
__global__ void maxpool2x2_fwd_kernel(const T* __restrict__ x,
                                      T* __restrict__ y,
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
    const T v00 = x[base], v01 = x[base + C];
    const T v10 = x[base + (int64_t)W * C];
    const T v11 = x[base + (int64_t)W * C + C];
    const float x00 = Elem<T>::get(v00), x01 = Elem<T>::get(v01);
    const float x10 = Elem<T>::get(v10), x11 = Elem<T>::get(v11);
    const bool r0 = x01 > x00, r1 = x11 > x10;
    const float m0 = r0 ? x01 : x00, m1 = r1 ? x11 : x10;
    const bool down = m1 > m0;
    // store the winning input itself: its bits, not a float round trip
    y[idx] = down ? (r1 ? v11 : v10) : (r0 ? v01 : v00);
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

template <typename T>
__global__ void maxpool2x2_bwd_window_kernel(const uint8_t* __restrict__ tap,
                                             const T* __restrict__ g,
                                             T* __restrict__ dx, int H,
                                             int W, int C, int H2, int W2) {
  using V = typename Elem<T>::Vec4;
  const int row = blockIdx.x;   // b * H2 + i
  const int b = row / H2, i = row - b * H2;
  const int C4 = C >> 2, n = W2 * C4;
  const int WC = W * C;
  // g and the tap of one pooled row are W2*C contiguous elements, and
  // thread t's four channels are the t-th group of 4 in that run
  const V* grow = reinterpret_cast<const V*>(g + (int64_t)row * W2 * C);
  const uint32_t* trow =
      reinterpret_cast<const uint32_t*>(tap + (int64_t)row * W2 * C);
  T* drow = dx + ((int64_t)b * H + 2 * i) * WC;   // dx row 2i
  const bool crop_row = (H & 1) && i == H2 - 1;
  const V zero = Elem<T>::zero4();
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int j = t / C4;
    const V gv = __ldg(grow + t);
    const uint32_t tp = __ldg(trow + t);   // tap of channel c+e in byte e
    V o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = Elem<T>::select(gv, tp, (uint32_t)q);
    T* p = drow + 2 * j * C + (t - j * C4) * 4;   // (2i, 2j, c)
    *reinterpret_cast<V*>(p) = o[0];
    *reinterpret_cast<V*>(p + C) = o[1];
    *reinterpret_cast<V*>(p + WC) = o[2];
    *reinterpret_cast<V*>(p + WC + C) = o[3];
    if (crop_row) {   // row H-1
      *reinterpret_cast<V*>(p + 2 * WC) = zero;
      *reinterpret_cast<V*>(p + 2 * WC + C) = zero;
    }
    if ((W & 1) && j == W2 - 1) {   // column W-1, and the corner
      *reinterpret_cast<V*>(p + 2 * C) = zero;
      *reinterpret_cast<V*>(p + WC + 2 * C) = zero;
      if (crop_row) *reinterpret_cast<V*>(p + 2 * WC + 2 * C) = zero;
    }
  }
}

template <typename T>
int launch_bwd_window(void* stream, const void* tap, const void* g, void* dx,
                      int B, int H, int W, int C) {
  const int H2 = H / 2, W2 = W / 2;
  constexpr uintptr_t kVec = sizeof(typename Elem<T>::Vec4);
  if (C % 4 != 0 || H2 < 1 || W2 < 1 || B < 1 ||
      reinterpret_cast<uintptr_t>(g) % kVec != 0 ||
      reinterpret_cast<uintptr_t>(tap) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(dx) % kVec != 0)
    return (int)cudaErrorInvalidValue;
  const int n = W2 * (C / 4);
  const int threads = n >= 256 ? 256 : (n + 31) / 32 * 32;
  maxpool2x2_bwd_window_kernel<T><<<(unsigned)((int64_t)B * H2), threads, 0,
                                    (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(tap), static_cast<const T*>(g),
      static_cast<T*>(dx), H, W, C, H2, W2);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fwd(void* stream, const void* x, void* y, void* tap, int B, int H,
               int W, int C) {
  const int64_t total = (int64_t)B * (H / 2) * (W / 2) * C;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  maxpool2x2_fwd_kernel<T><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<uint8_t*>(tap), B, H, W, C);
  return (int)cudaGetLastError();
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
  return launch_bwd_window<float>(stream, tap, g, dx, B, H, W, C);
}

extern "C" int cnn_maxpool2x2_bwd_window_bf16(void* stream, const void* tap,
                                              const void* g, void* dx, int B,
                                              int H, int W, int C) {
  return launch_bwd_window<__nv_bfloat16>(stream, tap, g, dx, B, H, W, C);
}

extern "C" int cnn_maxpool2x2_fwd(void* stream, const void* x, void* y,
                                  void* tap, int B, int H, int W, int C) {
  return launch_fwd<float>(stream, x, y, tap, B, H, W, C);
}

extern "C" int cnn_maxpool2x2_fwd_bf16(void* stream, const void* x, void* y,
                                       void* tap, int B, int H, int W,
                                       int C) {
  return launch_fwd<__nv_bfloat16>(stream, x, y, tap, B, H, W, C);
}
