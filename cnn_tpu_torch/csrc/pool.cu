// 2x2 stride-2 max pool, NHWC, for Hopper: the forward with a 2-bit tap
// index, and the backward that routes the cotangent through that tap, in
// float32 and bf16 (the backward's element kernel in float32 only).
//
// Replaces: cnn_tpu/ops/pallas/pool.py, _fwd_call (kernel body _fwd_kernel)
// and _bwd_call (kernel body _bwd_kernel).
// Taps are numbered 0..3 in row-major window order (00, 01, 10, 11). An
// earlier tap wins a tie: every comparison is a strict '>', exactly as in
// _fwd_kernel. Odd extents crop the last row/col (111 -> 55).
//
// Forward. Bound on this card: bytes. It reads the 2*H2 rows and 2*W2
// columns of x that the windows cover once, and writes y and (training) the
// uint8 tap once; three comparisons an output are nothing beside that. At
// AlexNet's [256,111,111,16] with the tap: 260 MB in float32 (0.078 ms at
// 3.35 TB/s), 136 MB in bf16 (0.041 ms). Two kernels, chosen by shape,
// dtype and alignment in ops/hopper/pool.py (pool_fwd_variant):
//  - the window kernel (C a multiple of the channels in 16 bytes: 4 float32
//    or 8 bf16; x and y 16-byte aligned): a 2-D block of (tx, ty) threads,
//    row y of the block on pooled row b*H2 + i (the one division of the
//    thread splits it; the rest of the index math is 32-bit but for the
//    row bases), thread x on pooled pixels j and 16-byte channel groups t =
//    j*G + g of that row (G = C*sizeof(T)/16), striding by tx. A thread
//    issues its window's four 16-byte read-only loads (rows 2i and 2i+1,
//    columns 2j and 2j+1) before any comparison, so 64 bytes a thread are
//    in flight, then one 16-byte store of y and, where the tap pointer is
//    not null, one 4-byte (float32) or 8-byte (bf16) store of its taps.
//    y and the tap of one pooled row are contiguous in t, so a warp's
//    stores are one run. Its loads are not: at C = 16 in bf16 the two
//    columns of a window are 32 bytes apart, so one load instruction of a
//    warp takes every other 32-byte sector of 1 KB and the next one the
//    sectors between. Each sector still comes from L2 once and from device
//    memory once, and an instruction moves 512 bytes, as a contiguous one
//    would: tools/pool_probe.py, which reads the same bytes as contiguous
//    runs, times no difference on this card (PERF.md, row 3b), so the
//    loads are not staged through shared memory or shuffles. The block
//    shape (ops/hopper/pool.py:pool_fwd_block): tx the row's groups
//    rounded up to a warp, at most 512, and ty rows so that a block has
//    about 256 threads (AlexNet's bf16 row is 110 groups: 128 x 2). Values
//    are compared as float (bf16 widened exactly, by its bits shifted) and
//    the stored value is the winning input's own bits, picked by integer
//    selects, so ties, +-0 and NaN give the element kernel's and
//    ops/pool.py:max_pool2d_taps's bits.
//  - the element kernel, the previous design (any C, any alignment): one
//    thread per output element, channel fastest, with 64-bit index math and
//    a grid-stride loop. It is bound by instruction issue, not bytes: three
//    64-bit divisions and modulos, four scalar loads and a one-byte store
//    per output element.
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
// bf16 (the _bf16 entry points): the same designs, templated on the element
// type, because _fwd_call and _bwd_call keep x.dtype and g.dtype. A maximum
// and a route are exact in any type: the forward compares the bf16 values
// widened to float, exactly, so its ties and taps are the float32
// kernels'; the window backward moves 4 channels as 8 bytes (g 8-byte
// aligned) and selects each 16-bit half by its tap. Bound on this card:
// bytes, about half the float32 kernels' (at batch 256 the forward with tap
// and the backward each move about 138 MB: 0.041 ms at 3.35 TB/s).
//
// Tests. On the CPU, the variant choices, the forward's block shape and a
// torch emulation of both window kernels' walks, held against the plain
// versions and the Pallas kernels in interpret mode:
//   JAX_PLATFORMS=cpu python -m pytest -q (one command)
//       tests/test_torch_pool_plan.py tests/test_torch_ops.py
// On the card, python3 chip_smoke.py builds the kernels and holds each
// against its plain version, and each window kernel against its element
// kernel, bit for bit.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// tools/pool_probe.py compiles this file with POOL_FWD_PROBE set to time
// the window forward without parts of its work (wrong results, timing only):
// bit 1 reads the same bytes in contiguous runs, bit 2 stores nothing
#ifndef POOL_FWD_PROBE
#define POOL_FWD_PROBE 0
#endif

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

// The window forward's arithmetic on one channel: the four inputs as the
// float bits of their values (a bf16 value widened: its 16 bits on top),
// compared as float; returns the winner's bits, picked by integer selects
// (never a float max, which would not keep -0 against +0 or a NaN's place),
// and its tap.
__device__ __forceinline__ uint32_t window1(uint32_t a, uint32_t b,
                                            uint32_t c, uint32_t d,
                                            uint32_t& tap) {
  const bool r0 = __uint_as_float(b) > __uint_as_float(a);
  const bool r1 = __uint_as_float(d) > __uint_as_float(c);
  const uint32_t m0 = r0 ? b : a, m1 = r1 ? d : c;
  const bool down = __uint_as_float(m1) > __uint_as_float(m0);
  tap = down ? (r1 ? 3u : 2u) : (r0 ? 1u : 0u);
  return down ? m1 : m0;
}

// 16 bytes of channels of the four window inputs -> 16 bytes of y and the
// channels' taps, one byte each (channel order)
template <typename T>
struct Window;

template <>
struct Window<float> {
  using Taps = uint32_t;   // 4 channels
  static __device__ __forceinline__ uint4 pool(uint4 a, uint4 b, uint4 c,
                                               uint4 d, Taps& taps) {
    uint32_t t0, t1, t2, t3;
    uint4 o;
    o.x = window1(a.x, b.x, c.x, d.x, t0);
    o.y = window1(a.y, b.y, c.y, d.y, t1);
    o.z = window1(a.z, b.z, c.z, d.z, t2);
    o.w = window1(a.w, b.w, c.w, d.w, t3);
    taps = t0 | t1 << 8 | t2 << 16 | t3 << 24;
    return o;
  }
};

template <>
struct Window<__nv_bfloat16> {
  using Taps = uint2;      // 8 channels
  // word k of a load holds channel 2k in its low half and 2k+1 in its high
  static __device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b,
                                                  uint32_t c, uint32_t d,
                                                  uint32_t& taps) {
    constexpr uint32_t kHi = 0xffff0000u;
    uint32_t tl, th;
    const uint32_t lo = window1(a << 16, b << 16, c << 16, d << 16, tl);
    const uint32_t hi = window1(a & kHi, b & kHi, c & kHi, d & kHi, th);
    taps = tl | th << 8;
    return lo >> 16 | hi;
  }
  static __device__ __forceinline__ uint4 pool(uint4 a, uint4 b, uint4 c,
                                               uint4 d, Taps& taps) {
    uint32_t p0, p1, p2, p3;
    uint4 o;
    o.x = pair(a.x, b.x, c.x, d.x, p0);
    o.y = pair(a.y, b.y, c.y, d.y, p1);
    o.z = pair(a.z, b.z, c.z, d.z, p2);
    o.w = pair(a.w, b.w, c.w, d.w, p3);
    taps = make_uint2(p0 | p1 << 16, p2 | p3 << 16);
    return o;
  }
};

template <typename T>
__global__ void maxpool2x2_fwd_window_kernel(const T* __restrict__ x,
                                             T* __restrict__ y,
                                             uint8_t* __restrict__ tap,
                                             int rows, int H, int W, int C,
                                             int H2, int W2) {
  using Taps = typename Window<T>::Taps;
  constexpr int kV = 16 / sizeof(T);   // channels in 16 bytes
  const int row = blockIdx.x * blockDim.y + threadIdx.y;   // b * H2 + i
  if (row >= rows) return;
  const int b = row / H2, i = row - b * H2;
  const int G = C / kV, n = W2 * G;
  // rows 2i and 2i+1 of x and pooled row i of y, in 16-byte groups: group
  // t = j*G + g of y pools groups 2j*G + g and (2j+1)*G + g of both rows
  const uint4* x0 = reinterpret_cast<const uint4*>(
      x + ((int64_t)b * H + 2 * i) * W * C);
  const uint4* x1 = x0 + W * G;
  uint4* yrow = reinterpret_cast<uint4*>(y + (int64_t)row * W2 * C);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
#if POOL_FWD_PROBE & 1
    // the same 2n groups of each row, one contiguous run an instruction
    const int qa = t, qb = t + n;
#else
    const int qa = 2 * t - t % G, qb = qa + G;
#endif
    const uint4 v00 = __ldg(x0 + qa), v01 = __ldg(x0 + qb);
    const uint4 v10 = __ldg(x1 + qa), v11 = __ldg(x1 + qb);
    Taps taps;
    const uint4 o = Window<T>::pool(v00, v01, v10, v11, taps);
#if POOL_FWD_PROBE & 2
    // no stores: a store that no value of the probe's inputs reaches
    if ((o.x & o.y & o.z & o.w) != 0xffffffffu) continue;
#endif
    yrow[t] = o;
    if (tap != nullptr)
      reinterpret_cast<Taps*>(tap + (int64_t)row * W2 * C)[t] = taps;
  }
}

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

// (tx, ty): ops/hopper/pool.py:pool_fwd_block
template <typename T>
int launch_fwd_window(void* stream, const void* x, void* y, void* tap, int B,
                      int H, int W, int C, int tx, int ty) {
  constexpr int kV = 16 / sizeof(T);
  const int H2 = H / 2, W2 = W / 2;
  if (C % kV != 0 || H2 < 1 || W2 < 1 || B < 1 || tx < 32 || tx % 32 != 0 ||
      ty < 1 || tx * ty > 1024 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(tap) % sizeof(typename Window<T>::Taps))
    return (int)cudaErrorInvalidValue;
  const int rows = B * H2;
  maxpool2x2_fwd_window_kernel<T><<<(unsigned)((rows + ty - 1) / ty),
                                    dim3(tx, ty), 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<uint8_t*>(tap), rows, H, W, C, H2, W2);
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

extern "C" int cnn_maxpool2x2_fwd_window(void* stream, const void* x, void* y,
                                         void* tap, int B, int H, int W,
                                         int C, int tx, int ty) {
  return launch_fwd_window<float>(stream, x, y, tap, B, H, W, C, tx, ty);
}

extern "C" int cnn_maxpool2x2_fwd_window_bf16(void* stream, const void* x,
                                              void* y, void* tap, int B,
                                              int H, int W, int C, int tx,
                                              int ty) {
  return launch_fwd_window<__nv_bfloat16>(stream, x, y, tap, B, H, W, C, tx,
                                          ty);
}
