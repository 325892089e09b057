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
// Design (cnn_rotate_shear, the tiled kernel): the TPU kernel keeps a
// padded 624 x 1408 working canvas (3.35 MiB in float32 at S = 256) in
// VMEM, which no block's shared memory holds. But a tile of the output
// needs little of it. The middle shear moves lane u by k2[u] rows, up to
// 180 at S = 256, yet that shift is a base each lane carries, not a spread
// across the tile: for the R output rows r0..r0+R-1 of a tile, lane u of T2
// reads only the R+1 rows r0+k2[u] .. r0+k2[u]+R of T1. So one block takes
// one tile of R rows x P pixels of one image and stages the shears once
// each in shared memory, T1 stored skewed by its own shift:
//   T1s[j][i] = T1(r0 + k2[u] + j, u),  u = u_lo + i,  j = 0..R,
// over the tile's T2 lane window [u_lo, u_hi]: the lanes the last shear
// reads, (P+1)*C plus C times the spread of k3 over the R rows (at most R
// for |theta| <= 90 degrees, where |tan(theta/2)| <= 1). The only halos are
// that spread and the second tap of each blend.
//   (a) the tile's shifts are split once: k3, a3 of its rows, k2, a2 of its
//       window lanes, k1, a1 of the T1 rows it reaches;
//   (b,c) k2 is monotone in u, so the lanes that need T1 row q form one
//       contiguous range, and the canvas taps they read are one contiguous
//       run of row q. Every thread first asks L2 for the canvas lines of
//       its T1 rows (prefetch.global.L2), so the block pays the latency of
//       device memory about once. Each row's range is cut into segments of
//       128 lanes; a warp takes every eighth segment, decodes it once (row,
//       shift, weight, whether every tap lies inside the canvas row) and
//       then does per value only two coalesced loads off one base pointer
//       (the second tap, C lanes on, from L1), one blend and one store to
//       the value's skewed slot, each lane's four loads in flight together;
//   (d) T2 is computed in place, T1s[j][i] = blend(T1s[j][i], T1s[j+1][i]),
//       down each lane's column, the R rows cut into groups so that a
//       thread walks kT2Tasks columns side by side, not one 32-step chain;
//   (e) each output is one blend of two T2 values of its row: a warp takes
//       an output row, decoded once, and writes it in order.
// The kernel is bound by latency and instruction issue, not by bytes
// (PERF.md, section 5): hence one decode per segment and per output row, four
// loads in flight a lane, the prefetch, and the register cap (kMinBlocks)
// that keeps five blocks resident per SM. The plan's tiles (16 x 128 in
// float32, 32 x 128 in bf16, about 40 KB of shared memory each) were the
// fastest of the smoke's sweep on the H100.
// Row stride of T1s is a multiple of 64 elements, so a warp's 32
// consecutive lanes fall in distinct banks whatever rows they write. Every
// zero of the plain version stays (a T1 row outside [0, S), a tap outside
// [0, L) in the first and third shears, the canvas outside its S*C window).
// A tile whose window exceeds the plan's buffer (only for |theta| > 90
// degrees, which the augmentation policy never draws) computes its outputs
// one by one with the direct kernel's arithmetic (below), in the same
// kernel. The tile plan (rows, pixels, buffer sizes) comes from
// ops/hopper/augment.py:rotate_tile_plan.
//
// Design (cnn_rotate_shear_direct, the previous kernel, on no path): one
// thread per output element evaluates its two T2 taps, each from two T1
// taps, each from two canvas loads, all in registers: 7 blends and up to 8
// gathered loads per element, each T1 value computed about four times.
//
// Both kernels round every blend's two products and its sum separately
// (__fmul_rn / __fadd_rn, so nvcc contracts nothing into an FMA), as the
// plain PyTorch version does; in bf16 every operation rounds to bf16, as
// JAX's and PyTorch's bf16 arithmetic do (the tiled kernel stores bf16
// values in shared memory at 2 bytes, exactly). Both are bit-identical to
// the plain version on the same shift vectors.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;     // values a lane loads before it uses any
constexpr int kSeg = 32 * kBatch;   // lanes of a T1 segment
constexpr int kT2Tasks = 4;   // T2 columns a thread walks side by side
constexpr int kMinBlocks = 5;   // blocks an SM keeps resident: 48 registers
constexpr int kMaxImagesPerLaunch = 65535;   // gridDim.y
// Compiled with -DROTATE_SKIP_PHASES=m, the tiled kernel skips T1 (bit 1),
// T2 (bit 2) or the output (bit 4), so that
// cnn_tpu_torch/tools/rotate_phases.py can time each phase by difference;
// the build never sets it.
#ifndef ROTATE_SKIP_PHASES
#define ROTATE_SKIP_PHASES 0
#endif
constexpr int kSkip = ROTATE_SKIP_PHASES;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float get(float v) { return v; }
  static constexpr int kLine = 32;   // values in a 128-byte line
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
  static __device__ __forceinline__ float get(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static constexpr int kLine = 64;
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

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

// one image's canvas and shifts, read element by element from global memory
template <typename T>
struct Canvas {
  const T* img;      // [S, S*C] of this image
  const float* s1;   // [S]
  const float* s2;   // [L]
  const float* s3;   // [S]
  int S, C, L, plc;

  __device__ __forceinline__ float x(int q, int w) const {
    w -= plc;
    return (w >= 0 && w < S * C) ? Num<T>::load(img + q * S * C + w) : 0.f;
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
  // third (lane) shear: output element (r, v), v in [0, S*C)
  __device__ __forceinline__ float out(int r, int v) const {
    float a;
    const int src = plc + v + C * split<T>(__ldg(s3 + r), &a);
    if (src < 0 || src + C >= L) return 0.f;
    return blend<T>(t2(r, src), t2(r, src + C), a);
  }
};

template <typename T>
__device__ __forceinline__ Canvas<T> canvas_of(const T* img, const float* s1,
                                               const float* s2,
                                               const float* s3, int b, int S,
                                               int C, int L, int pad_l) {
  return Canvas<T>{img + (int64_t)b * S * S * C, s1 + (int64_t)b * S,
                   s2 + (int64_t)b * L, s3 + (int64_t)b * S, S, C, L,
                   pad_l * C};
}

// ---------------------------------------------------------------------------
// the previous design: one thread per output element
// ---------------------------------------------------------------------------

template <typename T>
__global__ void rotate_shear_direct_kernel(const T* __restrict__ img,
                                           const float* __restrict__ s1,
                                           const float* __restrict__ s2,
                                           const float* __restrict__ s3,
                                           T* __restrict__ out, int B, int S,
                                           int C, int L, int pad_l) {
  const int row = S * C;
  const int64_t total = (int64_t)B * S * row;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int v = (int)(idx % row);
    const int64_t t = idx / row;
    const int r = (int)(t % S);
    const int b = (int)(t / S);
    const Canvas<T> cv = canvas_of(img, s1, s2, s3, b, S, C, L, pad_l);
    out[idx] = Num<T>::store(cv.out(r, v));
  }
}

// ---------------------------------------------------------------------------
// the tiled design: one block per output tile, the shears staged in shared
// memory
// ---------------------------------------------------------------------------

// Shared memory, dynamic (ops/hopper/augment.py:rotate_tile_plan sizes it;
// lanes_max is a multiple of 64, rows_cap = table_max + R bounds the T1
// rows a staged tile reaches):
//   T1s   [R+1][lanes_max] T   the first shear, skewed; then the second
//   k2s   [lanes_max] int      integer shift of each window lane
//   a2s   [lanes_max] float    its blend weight
//   first [table_max] int      lane-range table (below)
//   i0s, i1s [rows_cap] int    each T1 row's window lanes [i0, i1)
//   shs   [rows_cap] int       each T1 row's canvas offset, C*k1 - pad_l*C
//   a1s   [rows_cap] float     its blend weight
//   cpre  [rows_cap+1] int     prefix count of segments over the rows
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rotate_shear_tiled_kernel(const T* __restrict__ img,
                          const float* __restrict__ s1,
                          const float* __restrict__ s2,
                          const float* __restrict__ s3, T* __restrict__ out,
                          int S, int C, int L, int pad_l, int R, int P,
                          int lanes_max, int table_max, int tiles_p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows_cap = table_max + R;
  T* t1s = reinterpret_cast<T*>(smem);
  int* k2s = reinterpret_cast<int*>(smem + sizeof(T) * (R + 1) * lanes_max);
  float* a2s = reinterpret_cast<float*>(k2s + lanes_max);
  int* first = reinterpret_cast<int*>(a2s + lanes_max);
  int* i0s = first + table_max;
  int* i1s = i0s + rows_cap;
  int* shs = i1s + rows_cap;
  float* a1s = reinterpret_cast<float*>(shs + rows_cap);
  int* cpre = reinterpret_cast<int*>(a1s + rows_cap);
  __shared__ int k3s[64], lim[2];
  __shared__ float a3s[64];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int b = blockIdx.y;
  const int r0 = (blockIdx.x / tiles_p) * R, p0 = (blockIdx.x % tiles_p) * P;
  const int rows = min(R, S - r0), pix = min(P, S - p0);
  const int row = S * C, span = pix * C;
  const Canvas<T> cv = canvas_of(img, s1, s2, s3, b, S, C, L, pad_l);
  T* ob = out + (int64_t)b * S * row + r0 * row + p0 * C;

  // (a) the rows' third-shear shifts and their extent
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int rr = lane; rr < rows; rr += 32) {
      float a;
      const int k = split<T>(__ldg(cv.s3 + r0 + rr), &a);
      k3s[rr] = k;
      a3s[rr] = a;
      lo = min(lo, k);
      hi = max(hi, k);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      lim[0] = lo;
      lim[1] = hi;
    }
  }
  __syncthreads();
  // the T2 lanes the last shear reads, clipped to [0, L)
  const int u_lo = max(cv.plc + (p0 + lim[0]) * C, 0);
  const int u_hi = min(cv.plc + (p0 + pix + 1 + lim[1]) * C - 1, L - 1);
  const int W = u_hi - u_lo + 1;   // may be <= 0: every output is then 0
  const int Wp = (W + 63) & ~63;   // row stride of T1s

  bool staged = W <= lanes_max;
  if (staged && W > 0) {
    for (int i = tid; i < W; i += kThreads) {
      float a;
      k2s[i] = split<T>(__ldg(cv.s2 + u_lo + i), &a);
      a2s[i] = a;
    }
    __syncthreads();
    // k2 is monotone in u (shift_vectors: a clamped product of sin(theta)
    // and the lane's pixel coordinate, floored), so its extremes are at the
    // ends of the window
    const int ka = k2s[0], kb = k2s[W - 1];
    const bool up = kb >= ka;
    const int kmin = min(ka, kb), spread = up ? kb - ka : ka - kb;
    const int Q = spread + rows + 1;    // T1 rows q = r0 + kmin + t
    staged = spread + 2 <= table_max;   // block-uniform
    if (staged) {
      // first[k]: the first position, in ascending order of k2, whose
      // k2 - kmin >= k; position p is lane p (k2 rising) or W-1-p
      for (int i = tid; i < W; i += kThreads) {
        const int pos = up ? i : W - 1 - i;
        const int kcur = min(k2s[i] - kmin, spread);
        const int kprev = pos == 0 ? -1 : k2s[up ? i - 1 : i + 1] - kmin;
        for (int k = kprev + 1; k <= kcur; ++k) first[k] = pos;
      }
      if (tid == 0) first[spread + 1] = W;
      // each T1 row's first-shear shift, split once
      for (int t = tid; t < Q; t += kThreads) {
        const int q = r0 + kmin + t;
        float a = 0.f;
        int sh = 0;
        if (q >= 0 && q < S) sh = C * split<T>(__ldg(cv.s1 + q), &a) - cv.plc;
        shs[t] = sh;
        a1s[t] = a;
      }
      __syncthreads();
      // row t feeds the lanes whose k2 - kmin lies in [t - rows, t]; cut
      // into segments of kSeg lanes, counted by a prefix over the rows
      if (warp == 0) {
        int carry = 0;
        for (int base = 0; base < Q; base += 32) {
          const int t = base + lane;
          int n = 0;
          if (t < Q) {
            const int ka_ = max(t - rows, 0), kb_ = min(t, spread);
            const int i0 = up ? first[ka_] : W - first[kb_ + 1];
            const int i1 = up ? first[kb_ + 1] : W - first[ka_];
            i0s[t] = i0;
            i1s[t] = i1;
            n = (i1 - i0 + kSeg - 1) / kSeg;
          }
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, n, o);
            if (lane >= o) n += y;
          }
          if (t < Q) cpre[t + 1] = carry + n;
          carry += __shfl_sync(0xffffffffu, n, 31);
        }
        if (lane == 0) cpre[0] = 0;
      }
      __syncthreads();

      // the canvas lines of every T1 row, asked of L2 at once, so that a
      // warp's segments wait on L2 and not each on device memory
      for (int t = tid; t < Q; t += kThreads) {
        const int q = r0 + kmin + t, i0 = i0s[t], i1 = i1s[t];
        if (q < 0 || q >= S || i0 >= i1) continue;
        const int lo = max(u_lo + i0 + shs[t], 0);
        const int hi = min(u_lo + i1 - 1 + shs[t] + C, row - 1);
        const T* x = cv.img + q * row;
        for (int w = lo; w <= hi; w += Num<T>::kLine) prefetch_l2(x + w);
        if (lo <= hi) prefetch_l2(x + hi);
      }

      // (b, c) T1: warp w takes segments w, w + kWarps, ...; a segment is
      // kSeg consecutive lanes of one row q, whose canvas taps are one
      // contiguous run of row q: lane l takes lanes l, l+32, ..., its
      // kBatch loads of each tap issued before any is used. A segment whose
      // taps all lie inside the canvas row needs no per-element check. Each
      // value goes to its skewed slot j = t - (k2 - kmin).
      const int segs = cpre[Q];
      int t = 0;
      for (int g = warp; g < (kSkip & 1 ? 0 : segs); g += kWarps) {
        while (cpre[t + 1] <= g) ++t;   // warp-uniform
        const int i1 = i1s[t], ia = i0s[t] + (g - cpre[t]) * kSeg;
        const int n = min(i1 - ia, kSeg);   // lanes of this segment
        const int q = r0 + kmin + t, jt = t + kmin;
        T* slot = t1s + ia + lane;
        const int* k2 = k2s + ia + lane;
        if (q < 0 || q >= S) {   // a padding row: T1 is 0
#pragma unroll
          for (int m = 0; m < kBatch; ++m)
            if (lane + 32 * m < n)
              slot[(jt - k2[32 * m]) * Wp + 32 * m] = Num<T>::store(0.f);
          continue;
        }
        const float a = a1s[t];
        const int src = u_lo + ia + shs[t];   // canvas offset of lane ia
        const T* x = cv.img + (q * row + src + lane);
        float x0[kBatch], x1[kBatch];
        if (n == kSeg && src >= 0 && src + n - 1 + C < row) {   // uniform
          // a full segment, every tap inside the canvas row
          const T* xc = x + C;
#pragma unroll
          for (int m = 0; m < kBatch; ++m) {
            x0[m] = Num<T>::load(x + 32 * m);
            x1[m] = Num<T>::load(xc + 32 * m);
          }
#pragma unroll
          for (int m = 0; m < kBatch; ++m)
            slot[(jt - k2[32 * m]) * Wp + 32 * m] =
                Num<T>::store(blend<T>(x0[m], x1[m], a));
        } else if (src >= 0 && src + n - 1 + C < row) {   // warp-uniform
#pragma unroll
          for (int m = 0; m < kBatch; ++m) {
            x0[m] = x1[m] = 0.f;
            if (lane + 32 * m < n) {
              x0[m] = Num<T>::load(x + 32 * m);
              x1[m] = Num<T>::load(x + 32 * m + C);
            }
          }
#pragma unroll
          for (int m = 0; m < kBatch; ++m)
            if (lane + 32 * m < n)
              slot[(jt - k2[32 * m]) * Wp + 32 * m] =
                  Num<T>::store(blend<T>(x0[m], x1[m], a));
        } else {   // the segment reaches past the canvas row or the lanes
#pragma unroll
          for (int m = 0; m < kBatch; ++m) {
            const int w = src + lane + 32 * m;   // canvas offset of tap 0
            x0[m] = x1[m] = 0.f;
            if (lane + 32 * m < n) {
              if (w >= 0 && w < row) x0[m] = Num<T>::load(x + 32 * m);
              if (w + C >= 0 && w + C < row)
                x1[m] = Num<T>::load(x + 32 * m + C);
            }
          }
#pragma unroll
          for (int m = 0; m < kBatch; ++m) {
            const int w = src + lane + 32 * m + cv.plc;   // padded lane
            if (lane + 32 * m < n)
              slot[(jt - k2[32 * m]) * Wp + 32 * m] = Num<T>::store(
                  w >= 0 && w + C < L ? blend<T>(x0[m], x1[m], a) : 0.f);
          }
        }
      }
      __syncthreads();

      // (d) T2 in place: T1s[j][i] = blend(T1s[j][i], T1s[j+1][i]). The
      // rows are cut into G groups so that each thread walks up to kT2Tasks
      // (lane, group) columns side by side; every thread reads the first
      // row of each of its groups and the row past it before any writes.
      const int G = min(rows, max(1, kT2Tasks * kThreads / W));
      const int h = (rows + G - 1) / G;
      float y0[kT2Tasks], yend[kT2Tasks], a2[kT2Tasks];
      int col[kT2Tasks], jb[kT2Tasks], je[kT2Tasks];
#pragma unroll
      for (int k = 0; k < kT2Tasks; ++k) {
        const int task = tid + k * kThreads;
        col[k] = jb[k] = je[k] = 0;
        y0[k] = yend[k] = a2[k] = 0.f;
        if (task < W * G) {
          col[k] = task % W;
          jb[k] = (task / W) * h;
          je[k] = max(jb[k], min(jb[k] + h, rows));
          if (jb[k] < je[k]) {
            y0[k] = Num<T>::get(t1s[jb[k] * Wp + col[k]]);
            yend[k] = Num<T>::get(t1s[je[k] * Wp + col[k]]);
            a2[k] = a2s[col[k]];
          }
        }
      }
      __syncthreads();
      for (int s = 0; s < (kSkip & 2 ? 0 : h); ++s) {
#pragma unroll
        for (int k = 0; k < kT2Tasks; ++k) {
          const int j = jb[k] + s;
          if (j < je[k]) {
            const float y1 = j + 1 == je[k]
                                 ? yend[k]
                                 : Num<T>::get(t1s[(j + 1) * Wp + col[k]]);
            t1s[j * Wp + col[k]] = Num<T>::store(blend<T>(y0[k], y1, a2[k]));
            y0[k] = y1;
          }
        }
      }
      __syncthreads();
    }
  }

  if (staged) {
    // (e) the third shear from T2: warp w takes output rows w, w + kWarps,
    // ...; a row whose taps all lie in [0, L) needs no per-element check
    for (int rr = warp; rr < (kSkip & 4 ? 0 : rows); rr += kWarps) {
      const float a = a3s[rr];
      const int src = cv.plc + p0 * C + C * k3s[rr];   // padded lane of v = 0
      const T* t2 = t1s + rr * Wp + (src - u_lo);
      T* o = ob + rr * row;
      if (src >= 0 && src + span - 1 + C < L) {   // warp-uniform
        for (int v0 = 0; v0 < span; v0 += 32 * kBatch) {
          float y0[kBatch], y1[kBatch];
#pragma unroll
          for (int m = 0; m < kBatch; ++m) {
            const int v = v0 + lane + 32 * m;
            y0[m] = y1[m] = 0.f;
            if (v < span) {
              y0[m] = Num<T>::get(t2[v]);
              y1[m] = Num<T>::get(t2[v + C]);
            }
          }
#pragma unroll
          for (int m = 0; m < kBatch; ++m) {
            const int v = v0 + lane + 32 * m;
            if (v < span) o[v] = Num<T>::store(blend<T>(y0[m], y1[m], a));
          }
        }
      } else {
        for (int v = lane; v < span; v += 32) {
          float y = 0.f;
          if (src + v >= 0 && src + v + C < L)
            y = blend<T>(Num<T>::get(t2[v]), Num<T>::get(t2[v + C]), a);
          o[v] = Num<T>::store(y);
        }
      }
    }
  } else {
    // the window exceeds the buffer (|theta| > 90 degrees): element by
    // element, as the direct kernel computes
    for (int e = tid; e < rows * span; e += kThreads) {
      const int rr = e / span, v = e % span;
      ob[rr * row + v] = Num<T>::store(cv.out(r0 + rr, p0 * C + v));
    }
  }
}

template <typename T>
int launch_direct(void* stream, const void* img, const void* s1,
                  const void* s2, const void* s3, void* out, int B, int S,
                  int C, int L, int pad_l) {
  const int64_t total = (int64_t)B * S * S * C;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  rotate_shear_direct_kernel<T><<<(unsigned)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(s1),
      static_cast<const float*>(s2), static_cast<const float*>(s3),
      static_cast<T*>(out), B, S, C, L, pad_l);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tiled(void* stream, const void* img, const void* s1,
                 const void* s2, const void* s3, void* out, int B, int S,
                 int C, int L, int pad_l, int R, int P, int lanes_max,
                 int table_max, int smem_bytes) {
  if (R < 1 || R > 64 || P < 1 || lanes_max % 64 ||
      lanes_max > kT2Tasks * kThreads)
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rotate_shear_tiled_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles_p = (S + P - 1) / P, tiles = ((S + R - 1) / R) * tiles_p;
  const int64_t image = (int64_t)S * S * C;
  for (int b0 = 0; b0 < B; b0 += kMaxImagesPerLaunch) {
    const int nb = B - b0 < kMaxImagesPerLaunch ? B - b0 : kMaxImagesPerLaunch;
    rotate_shear_tiled_kernel<T><<<dim3(tiles, nb), kThreads, smem_bytes,
                                   (cudaStream_t)stream>>>(
        static_cast<const T*>(img) + b0 * image,
        static_cast<const float*>(s1) + (int64_t)b0 * S,
        static_cast<const float*>(s2) + (int64_t)b0 * L,
        static_cast<const float*>(s3) + (int64_t)b0 * S,
        static_cast<T*>(out) + b0 * image, S, C, L, pad_l, R, P, lanes_max,
        table_max, tiles_p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// bf16 != 0: img and out are bf16, else float32; the shifts are float32.
// R x P: the tile; lanes_max, table_max, smem_bytes: its buffers
// (ops/hopper/augment.py:rotate_tile_plan).
extern "C" int cnn_rotate_shear(void* stream, const void* img, const void* s1,
                                const void* s2, const void* s3, void* out,
                                int B, int S, int C, int L, int pad_l,
                                int bf16, int R, int P, int lanes_max,
                                int table_max, int smem_bytes) {
  if (bf16)
    return launch_tiled<__nv_bfloat16>(stream, img, s1, s2, s3, out, B, S, C,
                                       L, pad_l, R, P, lanes_max, table_max,
                                       smem_bytes);
  return launch_tiled<float>(stream, img, s1, s2, s3, out, B, S, C, L, pad_l,
                             R, P, lanes_max, table_max, smem_bytes);
}

// the previous design, one thread per element; on no path
extern "C" int cnn_rotate_shear_direct(void* stream, const void* img,
                                       const void* s1, const void* s2,
                                       const void* s3, void* out, int B,
                                       int S, int C, int L, int pad_l,
                                       int bf16) {
  if (bf16)
    return launch_direct<__nv_bfloat16>(stream, img, s1, s2, s3, out, B, S,
                                        C, L, pad_l);
  return launch_direct<float>(stream, img, s1, s2, s3, out, B, S, C, L,
                              pad_l);
}
