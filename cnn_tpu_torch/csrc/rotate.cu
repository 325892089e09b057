// Rotation of [B,S,S,C] canvases by three Paeth shears, float32 and bf16,
// for Hopper.
//
// Replaces: cnn_tpu/ops/pallas/augment.py, rotate_shear_pallas (kernel body
// _kernel -> _rotate_core). The rotation of the sampling coordinates by
// theta[b] is Sx(m) Sy(n) Sx(m), m = -tan(theta/2), n = sin(theta); each
// shear shifts one row (or column) by a fractional amount: an integer shift
// k = floor(shift), then the 2-tap blend x[k]*(1-a) + x[k+1]*a, a = shift-k.
// The caller passes the per-row shifts s1, s3 [B,S] and the per-lane shifts
// s2 [B,L] from _shift_vectors (ops/augment.py:shift_vectors), where the
// padded lane extent L and the left pad pad_l come from _geometry.
//
// What the TPU kernel computes, in the coordinates of the S image rows and
// the L padded lanes (lane u holds pixel (u - pad_l*C) / C, channel u % C):
//   T1(q,u)  = blend(X(q, u+C*k1[q]), X(q, u+C*k1[q]+C), a1[q]) if the two
//              taps lie in [0, L), else 0 (the TPU masks only circular-wrap
//              junk, not the S window: past 45 degrees the first shear's
//              content overflows into the padding and must reach the next
//              shear);
//   T2(r,u)  = blend(T1(r+k2[u], u), T1(r+k2[u]+1, u), a2[u]), with T1 = 0
//              outside the S rows (the padding rows hold zeros; s2 spans all
//              L lanes, by their true pixel coordinate);
//   out(r,v) = blend(T2(r, u+C*k3[r]), T2(r, u+C*k3[r]+C), a3[r]) at
//              u = pad_l*C + v, again 0 where a tap leaves [0, L).
// X is the canvas placed at lane pad_l*C, zero elsewhere.
//
// Bound on this card: bytes (one read of the canvas, one write of the
// result; about a dozen operations per element).
//
// Design: the TPU kernel keeps a padded 624 x 1408 working canvas (3.35 MiB
// in float32 at S = 256) in VMEM; a block's shared memory holds 227 KB, and
// the middle shear moves rows by up to 180 (a halo the size of the canvas).
// So the three shears are fused by recomputation instead: one thread per
// output element evaluates its two T2 taps, each from two T1 taps, each
// from two canvas loads, all in registers. No intermediate touches device
// memory and the kernel is one launch; the up to eight canvas loads per
// element are gathers along rows (lanes) and short diagonals (the middle
// shear), served from L1/L2. Every blend rounds its two products and its
// sum separately (__fmul_rn / __fadd_rn, so nvcc contracts nothing into an
// FMA), as the plain PyTorch version does; in bf16 every operation rounds
// to bf16, as JAX's and PyTorch's bf16 arithmetic do. The result is
// bit-identical to the plain version on the same shift vectors.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// x0 * (1 - a) + x1 * a, each operation rounded to T
template <typename T>
__device__ __forceinline__ float blend(float x0, float x1, float a) {
  const float om = Num<T>::round(__fsub_rn(1.0f, a));
  return Num<T>::round(__fadd_rn(Num<T>::round(__fmul_rn(x0, om)),
                                 Num<T>::round(__fmul_rn(x1, a))));
}

// integer part and the blend weight (rounded to T) of a shift
template <typename T>
__device__ __forceinline__ int split(float shift, float* a) {
  const float k = floorf(shift);
  *a = Num<T>::round(__fsub_rn(shift, k));
  return (int)k;
}

template <typename T>
struct Canvas {
  const T* img;      // [S, S*C] of this image
  const float* s1;   // [S]
  const float* s2;   // [L]
  int S, C, L, plc;

  __device__ __forceinline__ float x(int q, int w) const {
    w -= plc;
    return (w >= 0 && w < S * C) ? Num<T>::load(img + (int64_t)q * S * C + w)
                                 : 0.f;
  }
  // first (lane) shear, row q of the S image rows
  __device__ __forceinline__ float t1(int q, int u) const {
    if (q < 0 || q >= S) return 0.f;
    float a;
    const int src = u + C * split<T>(__ldg(s1 + q), &a);
    if (src < 0 || src + C >= L) return 0.f;
    return blend<T>(x(q, src), x(q, src + C), a);
  }
  // second (row) shear
  __device__ __forceinline__ float t2(int r, int u) const {
    float a;
    const int q = r + split<T>(__ldg(s2 + u), &a);
    return blend<T>(t1(q, u), t1(q + 1, u), a);
  }
};

template <typename T>
__global__ void rotate_shear_kernel(const T* __restrict__ img,
                                    const float* __restrict__ s1,
                                    const float* __restrict__ s2,
                                    const float* __restrict__ s3,
                                    T* __restrict__ out, int B, int S, int C,
                                    int L, int pad_l) {
  const int row = S * C;
  const int64_t total = (int64_t)B * S * row;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int v = (int)(idx % row);
    const int64_t t = idx / row;
    const int r = (int)(t % S);
    const int64_t b = t / S;
    const Canvas<T> cv{img + b * S * row, s1 + b * S, s2 + b * L, S, C, L,
                       pad_l * C};
    float a;
    const int src = pad_l * C + v + C * split<T>(__ldg(s3 + b * S + r), &a);
    float y = 0.f;
    if (src >= 0 && src + C < L) y = blend<T>(cv.t2(r, src), cv.t2(r, src + C), a);
    out[idx] = Num<T>::store(y);
  }
}

template <typename T>
int launch(void* stream, const void* img, const void* s1, const void* s2,
           const void* s3, void* out, int B, int S, int C, int L, int pad_l) {
  const int64_t total = (int64_t)B * S * S * C;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  rotate_shear_kernel<T><<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(s1),
      static_cast<const float*>(s2), static_cast<const float*>(s3),
      static_cast<T*>(out), B, S, C, L, pad_l);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 != 0: img and out are bf16, else float32; the shifts are float32
extern "C" int cnn_rotate_shear(void* stream, const void* img, const void* s1,
                                const void* s2, const void* s3, void* out,
                                int B, int S, int C, int L, int pad_l,
                                int bf16) {
  if (bf16)
    return launch<__nv_bfloat16>(stream, img, s1, s2, s3, out, B, S, C, L,
                                 pad_l);
  return launch<float>(stream, img, s1, s2, s3, out, B, S, C, L, pad_l);
}
