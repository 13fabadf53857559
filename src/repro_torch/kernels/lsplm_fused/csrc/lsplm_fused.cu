// Dense fused LS-PLM forward (Eq. 2) for Hopper (sm_90a):
//   zu = x U, zw = x W (fp32 accumulation over d),
//   p  = sum_j softmax(zu)_j * sigmoid(zw)_j,  written in x's dtype.
// Replaces the Pallas kernel src/repro/kernels/lsplm_fused/lsplm_fused.py
// `_kernel` (launched by `lsplm_fused_forward`). x is (B, d); U and W
// (d, m), 1 <= m <= 128, arrive packed as one row-major Theta = [U | W]
// (d, ldt) with ldt = 2m rounded up to 16 bytes; x and Theta are both
// fp32 or both bf16.
//
// What bounds it on this card. Each x element is read once and feeds 2m
// FMAs (48 FLOP at m = 12). In fp32 that is 12 FLOP per byte, below the
// H100's fp32 CUDA-core balance (67e12 / 3.35e12 = 20 FLOP/B): the byte
// bound rules, by not far. In bf16 it is 24 FLOP/B: the fp32 FMA rate
// rules (no tensor cores here). Theta is small ((d, 2m), 3 MB at
// d = 32,768) and comes from L2 after the first CTA.
//
// Design (the first one: simple and right, not yet at its bound).
//  * A CTA of 16 warps owns 32 rows (one per lane) x all 2m columns and
//    walks d in tiles of DT. Each tile of x (32 x DT) and of Theta
//    (DT x ldt) is staged in shared memory in fp32 by coalesced 16-byte
//    loads (x falls back to element loads when its rows are not 16-byte
//    aligned), so the Theta tile is read from L2 once per 32 rows (one
//    warp per row would read it once per row: 24x the bytes of x at
//    m = 12). The next tile's loads are issued into registers before the
//    current tile is used, so one tile of loads is in flight while the
//    warps compute.
//  * A thread accumulates one row x NC columns in fp32 registers. The
//    column chunk NC (4, 8, 16, 24 or 32) is a template parameter; with
//    2m > 32 there are G = ceil(2m / 32) column groups. The 16 warps split
//    as G column groups x S k-slices: within each tile, slice s owns the
//    fixed k range [16 s, 16 s + 16). Per 4 k a lane reads its x values
//    as one float4 (rows padded to DT + 4 floats: conflict-free) and each
//    Theta row as float4 broadcasts, then does 4 NC FMAs.
//  * The S partial sums of a row are added in slice order through shared
//    memory (all warps, one column each), then lane r of warp 0 runs the
//    head for row r: max-shifted softmax over the m gate columns, sigmoid
//    of the m fit columns, their dot product, all in fp32 (expf, IEEE
//    division; build without --use_fast_math).
//  * No atomics and no split of d across CTAs. Every row's sum runs in an
//    order fixed by d and m alone -- never by B, the grid or the row's
//    place in its CTA -- so two identical calls are bitwise equal and a
//    row scores the same bits alone or inside any batch. Columns past d
//    and rows past B are staged as zeros (they add exact zeros); rows past
//    B are not written. No padded copies of x.
//
// Known to be slow where it is: 32-row CTAs leave SMs idle at small B
// (512 rows = 16 CTAs) and every FMA waits on a shared-memory broadcast
// of its Theta operand; wgmma, TMA and a deterministic split of d are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;      // rows per CTA: one per lane
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = 16;     // k per warp slice within a tile
constexpr int kMaxTile = 256;  // DT <= this
constexpr int kThetaTile = 8192;  // DT * ldt <= this (floats)

// 16 bytes of T, and how many elements they hold
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int n = 8;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of T -> fp32 in shared memory (dst 16-byte aligned)
__device__ __forceinline__ void put(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void put(float* dst, uint4 v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]);
  const float2 e = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, e.x, e.y);
}

template <int NC>
__device__ __forceinline__ void fma_row(float (&acc)[NC], float xv,
                                        const float* t) {
  const float4* t4 = reinterpret_cast<const float4*>(t);
#pragma unroll
  for (int q = 0; q < NC / 4; ++q) {
    const float4 tv = t4[q];
    acc[4 * q + 0] = __fmaf_rn(xv, tv.x, acc[4 * q + 0]);
    acc[4 * q + 1] = __fmaf_rn(xv, tv.y, acc[4 * q + 1]);
    acc[4 * q + 2] = __fmaf_rn(xv, tv.z, acc[4 * q + 2]);
    acc[4 * q + 3] = __fmaf_rn(xv, tv.w, acc[4 * q + 3]);
  }
}

struct Shape {
  int B, d, m;
  int ldt;      // Theta's row stride: 2m rounded up to 16 bytes
  int G;        // column groups of NC columns
  int S;        // k slices per tile (DT = S * kSlice)
  int log2_dt;  // DT = 1 << log2_dt
  long long ldx;  // x's row stride (elements)
};

template <typename T, int NC, bool kVecX>
__global__ void __launch_bounds__(kThreads, 1)
lsplm_fused_kernel(const T* __restrict__ x, const T* __restrict__ theta,
                   T* __restrict__ p, Shape s) {
  using V = typename Vec<T>::type;
  constexpr int kV = Vec<T>::n;
  constexpr int kXElems = kRows * kMaxTile / kThreads;  // per thread
  constexpr int kXVecs = kXElems / kV;
  constexpr int kTVecs = kThetaTile / kV / kThreads;
  extern __shared__ __align__(16) float smem[];
  const int DT = 1 << s.log2_dt;
  const int ldt = s.ldt;
  const int xld = DT + 4;
  float* th_s = smem;            // [DT][ldt]
  float* x_s = smem + DT * ldt;  // [kRows][DT + 4]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = warp % s.G;
  const int slice = warp / s.G;
  const bool computes = slice < s.S;
  const int row0 = blockIdx.x * kRows;
  const int t_vecs = DT * ldt / kV;  // ldt is a multiple of kV
  const V zero = {};

  V tr[kTVecs];
  V xv[kVecX ? kXVecs : 1];
  T xe[kVecX ? 1 : kXElems];
  auto load = [&](int k0) {
    // Theta rows [k0, k0 + DT) are one contiguous run; zeros past row d
    const T* t_src = theta + static_cast<long long>(k0) * ldt;
    const int t_valid = min(DT, s.d - k0) * ldt / kV;
#pragma unroll
    for (int i = 0; i < kTVecs; ++i) {
      const int q = tid + i * kThreads;
      tr[i] = q < t_valid ? *reinterpret_cast<const V*>(t_src + q * kV)
                          : zero;
    }
    if constexpr (kVecX) {
      const int per_row = DT / kV;  // vectors per tile row
#pragma unroll
      for (int i = 0; i < kXVecs; ++i) {
        const int q = tid + i * kThreads;
        const int r = q / per_row;
        const int k = k0 + (q - r * per_row) * kV;
        const bool ok = q < kRows * per_row && row0 + r < s.B && k < s.d;
        xv[i] = ok ? *reinterpret_cast<const V*>(
                         x + static_cast<long long>(row0 + r) * s.ldx + k)
                   : zero;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kXElems; ++i) {
        const int e = tid + i * kThreads;
        const int r = e >> s.log2_dt;
        const int k = k0 + (e & (DT - 1));
        const bool ok = e < kRows * DT && row0 + r < s.B && k < s.d;
        xe[i] = ok ? x[static_cast<long long>(row0 + r) * s.ldx + k]
                   : from_f32<T>(0.0f);
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < kTVecs; ++i) {
      const int q = tid + i * kThreads;
      if (q < t_vecs) put(th_s + q * kV, tr[i]);
    }
    if constexpr (kVecX) {
      const int per_row = DT / kV;
#pragma unroll
      for (int i = 0; i < kXVecs; ++i) {
        const int q = tid + i * kThreads;
        const int r = q / per_row;
        if (q < kRows * per_row)
          put(x_s + r * xld + (q - r * per_row) * kV, xv[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kXElems; ++i) {
        const int e = tid + i * kThreads;
        if (e < kRows * DT)
          x_s[(e >> s.log2_dt) * xld + (e & (DT - 1))] = to_f32(xe[i]);
      }
    }
  };

  float acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = 0.0f;

  // a group's columns may run past ldt into the next Theta row (or, for
  // the tile's last row, into x_s): they feed accumulators no one reads
  const float* xrow = x_s + lane * xld + slice * kSlice;
  const float* trow = th_s + slice * kSlice * ldt + g * NC;
  load(0);
  for (int k0 = 0; k0 < s.d; k0 += DT) {
    __syncthreads();  // the previous tile's reads are done
    store();
    __syncthreads();
    if (k0 + DT < s.d) load(k0 + DT);  // in flight while this tile is used
    if (computes) {
#pragma unroll
      for (int k4 = 0; k4 < kSlice; k4 += 4) {
        const float4 xk = *reinterpret_cast<const float4*>(xrow + k4);
        fma_row<NC>(acc, xk.x, trow + (k4 + 0) * ldt);
        fma_row<NC>(acc, xk.y, trow + (k4 + 1) * ldt);
        fma_row<NC>(acc, xk.z, trow + (k4 + 2) * ldt);
        fma_row<NC>(acc, xk.w, trow + (k4 + 3) * ldt);
      }
    }
  }
  __syncthreads();

  // partial sums -> [S][kRows][CP + 1]; slice 0's row collects the sum
  const int m2 = 2 * s.m;
  const int rld = s.G * NC + 1;
  float* red = smem;
  if (computes) {
    float* dst = red + (slice * kRows + lane) * rld + g * NC;
#pragma unroll
    for (int j = 0; j < NC; ++j) dst[j] = acc[j];
  }
  __syncthreads();
  for (int c = warp; c < m2; c += kWarps) {  // slice order, per column
    float v = red[lane * rld + c];
    for (int t = 1; t < s.S; ++t)
      v = __fadd_rn(v, red[(t * kRows + lane) * rld + c]);
    red[lane * rld + c] = v;
  }
  __syncthreads();
  if (warp != 0) return;

  const float* z = red + lane * rld;
  const int m = s.m;
  float mx = -INFINITY;
  for (int j = 0; j < m; ++j) mx = fmaxf(mx, z[j]);
  float denom = 0.0f;
  for (int j = 0; j < m; ++j) denom += expf(z[j] - mx);
  float out = 0.0f;
  for (int j = 0; j < m; ++j) {
    const float gate = expf(z[j] - mx) / denom;
    const float fit = 1.0f / (1.0f + expf(-z[m + j]));
    out += gate * fit;
  }
  if (row0 + lane < s.B) p[row0 + lane] = from_f32<T>(out);
}

template <typename T, int NC, bool kVecX>
int launch_nc(const T* x, const T* theta, T* p, const Shape& s,
              cudaStream_t stream) {
  const int DT = 1 << s.log2_dt;
  const size_t tile = static_cast<size_t>(DT) * s.ldt + kRows * (DT + 4);
  const size_t red = static_cast<size_t>(s.S) * kRows * (s.G * NC + 1);
  const size_t smem = (tile > red ? tile : red) * sizeof(float);
  static size_t opted_in = 48 * 1024;  // per instantiation
  if (smem > opted_in) {
    const cudaError_t rc = cudaFuncSetAttribute(
        lsplm_fused_kernel<T, NC, kVecX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    opted_in = smem;
  }
  const dim3 grid((s.B + kRows - 1) / kRows);
  lsplm_fused_kernel<T, NC, kVecX><<<grid, kThreads, smem, stream>>>(
      x, theta, p, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NC>
int launch_vec(const T* x, const T* theta, T* p, const Shape& s,
               bool vec_x, cudaStream_t stream) {
  return vec_x ? launch_nc<T, NC, true>(x, theta, p, s, stream)
               : launch_nc<T, NC, false>(x, theta, p, s, stream);
}

template <typename T>
int launch(const void* x, const void* theta, void* p, int B, int d, int m,
           long long ldx, int ldt, bool vec_x, cudaStream_t stream) {
  constexpr int kV = Vec<T>::n;
  const int m2 = 2 * m;
  if (B < 1 || d < 0 || m < 1 || m > 128 || ldx < d || ldt < m2 ||
      ldt % kV != 0 || ldt > m2 + kV - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_x && (ldx % kV != 0 || d % kV != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = m2 <= 4 ? 4 : m2 <= 8 ? 8 : m2 <= 16 ? 16 : m2 <= 24 ? 24
                                                                      : 32;
  Shape s;
  s.B = B;
  s.d = d;
  s.m = m;
  s.ldt = ldt;
  s.ldx = ldx;
  s.G = (m2 + nc - 1) / nc;
  s.S = s.G == 1 ? 16 : s.G == 2 ? 8 : s.G <= 4 ? 4 : 2;
  s.log2_dt = 0;
  while ((1 << s.log2_dt) < s.S * kSlice) ++s.log2_dt;
  // DT * ldt <= kThetaTile holds: ldt <= 32, 64, 128, 256 for G = 1, 2,
  // <= 4, <= 8 and DT = 256, 128, 64, 32
  const T* xt = static_cast<const T*>(x);
  const T* tt = static_cast<const T*>(theta);
  T* pt = static_cast<T*>(p);
  switch (nc) {
    case 4: return launch_vec<T, 4>(xt, tt, pt, s, vec_x, stream);
    case 8: return launch_vec<T, 8>(xt, tt, pt, s, vec_x, stream);
    case 16: return launch_vec<T, 16>(xt, tt, pt, s, vec_x, stream);
    case 24: return launch_vec<T, 24>(xt, tt, pt, s, vec_x, stream);
    default: return launch_vec<T, 32>(xt, tt, pt, s, vec_x, stream);
  }
}

}  // namespace

extern "C" {

// p (B,) <- Eq. 2 of x (B, d) against Theta = [U | W] (d, ldt), U and W
// (d, m) in its first 2m columns. dtype 0 = float32, 1 = bfloat16 (x,
// theta and p share it). ldx and ldt in elements; Theta and, when vec_x
// is set, x's rows are 16-byte aligned (vec_x also needs d and ldx to be
// multiples of 16 bytes). Returns cudaGetLastError() after the launch
// (0 = launched).
int lsplm_fused_forward(const void* x, const void* theta, void* p, int B,
                        int d, int m, long long ldx, int ldt, int vec_x,
                        int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, theta, p, B, d, m, ldx, ldt, vec_x != 0, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, theta, p, B, d, m, ldx, ldt, vec_x != 0,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* lsplm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
