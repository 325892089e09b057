// Batched bilinear resize of uint8 BGR images, cv2's INTER_LINEAR in its
// fixed-point arithmetic, for NVIDIA Hopper.
//
// Replaces: no Pallas kernel. It is the cv::resize of the native loader,
// csrc/dataloader.cpp:28 (cnn_decode_resize), which cnn_tpu runs on the host
// after cv::imread; the port decodes on the host (data/image.py) and resizes
// the whole batch here in one launch (data/native.py).
//
// Inputs: n source images of any sizes, HWC uint8, packed back to back in
// `src`; per image `meta` (int64 offset into src, height, width); per image
// the column taps `xtab` [4, s] and the row taps `ytab` [4, s], each row of
// a table (i0, i1, c0, c1) as int32, from data/image.py:tap_tables (the
// float arithmetic that picks the taps and their 11-bit weights, and the
// clamping at the edges, are done there once, on the host). Output: uint8
// [n, s, s, 3].
//
// Per output pixel and channel, the arithmetic of data/image.py:resize:
//   H_r = S[y_r][x0] * c0 + S[y_r][x1] * c1            (r = 0, 1)
//   v   = ((H_0 >> 4) * b0 >> 16) + ((H_1 >> 4) * b1 >> 16)
//   out = (v + 2) >> 2
// in int32 (H < 2^20, (H >> 4) * b < 2^27, v <= 1020: no overflow and no
// saturation). The row taps keep their fraction where both rows clamp to
// one edge row of an upscale, as cv2's do; the tables carry that, and the
// kernel applies them as they are.
//
// Design: one thread per output pixel and its three channels; a block is
// 128 pixels of one output row of one image (grid x: the row's blocks, y:
// the row, z: the image), so a block reads one pair of row taps and two
// source rows. Bound on this card: bytes (the taps' source pixels and the
// output); a simple kernel, not tuned.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
resize_linear_u8_kernel(const uint8_t* __restrict__ src,
                        const int64_t* __restrict__ meta,
                        const int32_t* __restrict__ xtab,
                        const int32_t* __restrict__ ytab,
                        uint8_t* __restrict__ out, int s) {
  const int ox = blockIdx.x * kThreads + threadIdx.x;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;
  if (ox >= s) return;
  const int64_t off = meta[3 * b];
  const int64_t row = meta[3 * b + 2] * 3;   // bytes a source row
  const int32_t* xt = xtab + (int64_t)b * 4 * s;
  const int32_t* yt = ytab + (int64_t)b * 4 * s;
  const int x0 = 3 * xt[ox], x1 = 3 * xt[s + ox];
  const int a0 = xt[2 * s + ox], a1 = xt[3 * s + ox];
  const int b0 = yt[2 * s + oy], b1 = yt[3 * s + oy];
  const uint8_t* r0 = src + off + yt[oy] * row;
  const uint8_t* r1 = src + off + yt[s + oy] * row;
  uint8_t* o = out + (((int64_t)b * s + oy) * s + ox) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int h0 = (r0[x0 + c] * a0 + r0[x1 + c] * a1) >> 4;
    const int h1 = (r1[x0 + c] * a0 + r1[x1 + c] * a1) >> 4;
    const int v = ((h0 * b0) >> 16) + ((h1 * b1) >> 16);
    o[c] = (uint8_t)((v + 2) >> 2);
  }
}

}  // namespace

// n images (n <= 65535) to s x s (s <= 65535); returns the launch's
// cudaError_t.
extern "C" int cnn_resize_linear_u8(void* stream, const void* src,
                                    const void* meta, const void* xtab,
                                    const void* ytab, void* out, int n,
                                    int s) {
  if (n < 1 || s < 1) return 0;
  const dim3 grid((s + kThreads - 1) / kThreads, s, n);
  resize_linear_u8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(src), static_cast<const int64_t*>(meta),
      static_cast<const int32_t*>(xtab), static_cast<const int32_t*>(ytab),
      static_cast<uint8_t*>(out), s);
  return (int)cudaGetLastError();
}
