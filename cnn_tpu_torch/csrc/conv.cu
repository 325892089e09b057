// VALID k x k convolution + bias (+ ReLU), NHWC / HWIO, float32, for Hopper.
//
// Replaces: cnn_tpu/ops/pallas/conv.py, conv2d_bias_relu_pallas -> _forward
// (kernel body _conv_kernel): k*k shifted [Ho*Wo, Cin] x [Cin, Cout]
// products summed in f32, then + bias, then an optional ReLU, any stride,
// output extent (H - k) / stride + 1.
//
// Bound on this card: on the AlexNet shapes, bytes for conv1 (Cin = 3, so
// K = 27 multiply-adds per output) and float32 operations for conv2-4
// (K = 144..576). No TF32: the sums are full float32 FMAs, as the 1e-5
// parity with the plain version and the JAX reference needs.
//
// Design: a direct implicit GEMM (M = B*Ho*Wo pixels, N = Cout, K = k*k*Cin)
// with no staging. Each thread owns one output pixel and four neighbouring
// output channels, so one input load feeds four FMAs and the four weights
// come in one 16-byte load. Neighbouring threads take neighbouring channel
// groups of the same pixel, then the next pixel: the weight loads of a warp
// are one contiguous run (shared by every pixel of the warp), its input
// loads are broadcast, and its stores are one contiguous run. Weights are
// read through the read-only cache instead of being staged in shared
// memory: conv4's HWIO tensor (3*3*64*128 floats, 295 KB) is larger than
// the 227 KB a block can have. Bias and ReLU are applied before the one
// store, so the activation makes a single trip to device memory. Conv1's
// 3-channel pixels give unaligned 4-byte input loads; that is fine here.
#include <cstdint>
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
