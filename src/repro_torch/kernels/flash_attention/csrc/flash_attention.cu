// Flash attention forward (B6) for Hopper (sm_90a): online-softmax
// attention over (B, S, H, hd), causal or not, that never forms the
// S x S score matrix.
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / rep] * hd^-0.5)
//                      v[b, j, h / rep]        (j <= i when causal)
// Replaces the Pallas kernel src/repro/kernels/flash_attention/
// flash_attention.py `_kernel` (launched by `flash_attention`). q is
// (B, S, H, hd); k and v are (B, S, KVH, hd) with H % KVH == 0 and are
// read as they are: query head h reads KV head h / rep (rep = H / KVH),
// the order in which the reference's repeat_kv broadcasts, so no
// repeated copy of k and v is made. All three are read through their
// batch, position and head strides (the head dim is unit-stride), so the
// (B, S, H, hd) views of the model's projections go as they lie. The
// output is a contiguous (B, S, H, hd) tensor in q's dtype.
//
// Numerics, as the reference: q, k and v widened to fp32; scores
// q.k * hd^-0.5 in fp32; masked scores -1e30 (not -inf); the running max
// m, the running sum l and the output accumulator in fp32; l == 0 read
// as 1 before the divide; the output rounded to nearest even in q's
// dtype. IEEE expf and division (no --use_fast_math).
//
// What bounds it on this card. Causal attention does 2 B H S^2 hd
// operations (QK^T and PV over the lower triangle) on 4 B S (H + 2 KVH)
// hd bytes of bf16 inputs and output: at S = 4,096, hd = 64, ~640
// operations per byte, far above the H100's balance, so the bound is
// operations (at the bf16 tensor-core peak: 0.278 ms at B = 4, H = 32).
// This first kernel computes in fp32 on the CUDA cores (67 TFLOP/s
// peak), so it cannot come within 15x of that bound; bf16 mma / wgmma
// with TMA-fed K/V stages are later work.
//
// Design (simple and right first).
//  * One CTA of 256 threads per (64-query tile, head, batch). Causal
//    CTAs are issued longest-first (the tile with the most KV tiles
//    first), so the short ones fill the tail of the grid.
//  * The q tile is staged once in shared memory in fp32, transposed
//    ([hd][64]); each KV tile of 64 keys is staged the same way (k
//    transposed, v row-major), zero past S. The loop over KV tiles stops
//    at the diagonal tile when causal; elements past the diagonal, and
//    keys past S (a ragged last tile: any S works), get the -1e30 mask.
//  * Scores: thread (ty, tx) of a 16 x 16 grid owns a 4 x 4 block of the
//    64 x 64 score tile, 16 fp32 FMAs per pair of 16-byte shared loads.
//    Row max and row sum over the 16 threads of a row are shuffles within
//    a half warp. The running m, l and the rescale are per row.
//  * p goes to shared memory key-major; then thread (ty, tx) adds p v
//    into its 4 rows x hd/16 output columns (one column per thread at
//    hd = 16; half the threads idle at hd = 8), again from 16-byte
//    shared loads.
//  * No atomics: every output element is summed in an order fixed by S
//    and hd alone, so two identical calls are bitwise equal.
// Templated on hd in {8, 16, 64, 128} and on the dtype (fp32, bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLd = kBlockQ + 4;  // row stride of the [hd][64] tiles
constexpr float kNegInf = -1e30f;

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

struct Args {
  int B, S, H, KVH;
  long long q_sb, q_ss, q_sh;  // element strides of q, k, v
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

template <int HD>
constexpr size_t smem_floats() {
  return 2 * HD * kLd + kBlockK * (HD + 4) + kBlockK * kLd;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, Args a) {
  constexpr int kVld = HD + 4;                    // v tile row stride
  constexpr int kCols = HD >= 16 ? HD / 16 : 1;   // output columns / thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [HD][kLd]      q tile, transposed
  float* ks = qs + HD * kLd;         // [HD][kLd]      k tile, transposed
  float* vs = ks + HD * kLd;         // [kBlockK][kVld] v tile
  float* ps = vs + kBlockK * kVld;   // [kBlockK][kLd] p, key-major

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_qt = (a.S + kBlockQ - 1) / kBlockQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const int q0 = qt * kBlockQ;
  const T* qb = q + b * a.q_sb + h * a.q_sh;
  const T* kb = k + b * a.k_sb + kvh * a.k_sh;
  const T* vb = v + b * a.v_sb + kvh * a.v_sh;

  for (int e = tid; e < kBlockQ * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e - r * HD;
    const int pos = q0 + r;
    qs[d * kLd + r] = pos < a.S ? to_f32(qb[pos * a.q_ss + d]) : 0.0f;
  }

  float m_i[4], l_i[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int n_kt = a.causal ? qt + 1 : (a.S + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's reads of ks, vs, ps are done
    for (int e = tid; e < kBlockK * HD; e += kThreads) {
      const int r = e / HD;
      const int d = e - r * HD;
      const int pos = k0 + r;
      const bool ok = pos < a.S;
      ks[d * kLd + r] = ok ? to_f32(kb[pos * a.k_ss + d]) : 0.0f;
      vs[r * kVld + d] = ok ? to_f32(vb[pos * a.v_ss + d]) : 0.0f;
    }
    __syncthreads();

    // scores of rows 4 ty + i against keys 4 tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * kLd + 4 * ty);
      const float4 kv = *reinterpret_cast<const float4*>(ks + d * kLd + 4 * tx);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        const bool ok = kpos < a.S && (!a.causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (4 * tx + j) * kLd + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += p v over the tile's keys
    if (tx * kCols < HD) {
#pragma unroll 4
      for (int key = 0; key < kBlockK; ++key) {
        const float4 pv =
            *reinterpret_cast<const float4*>(ps + key * kLd + 4 * ty);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        const float* vrow = vs + key * kVld + tx * kCols;
        float vv[kCols];
        if constexpr (kCols % 4 == 0) {
#pragma unroll
          for (int c = 0; c < kCols; c += 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(vrow + c);
            vv[c] = v4.x;
            vv[c + 1] = v4.y;
            vv[c + 2] = v4.z;
            vv[c + 3] = v4.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) vv[c] = vrow[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[i][c] = fmaf(pa[i], vv[c], acc[i][c]);
      }
    }
  }

  if (tx * kCols >= HD) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.S) continue;
    const float l = l_i[i] == 0.0f ? 1.0f : l_i[i];
    T* dst = o + ((static_cast<long long>(b) * a.S + row) * a.H + h) * HD +
             tx * kCols;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[c] = from_f32<T>(acc[i][c] / l);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  // The opt-in above 48 KB holds per device, so it is made on every
  // launch (it is cheap) rather than remembered once per process.
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.H, a.B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int hd,
           const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch_hd<T, 8>(q, k, v, o, a, stream);
    case 16: return launch_hd<T, 16>(q, k, v, o, a, stream);
    case 64: return launch_hd<T, 64>(q, k, v, o, a, stream);
    case 128: return launch_hd<T, 128>(q, k, v, o, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o (B, S, H, hd), contiguous, <- attention of q (B, S, H, hd) over k, v
// (B, S, KVH, hd), each read through its (batch, position, head) element
// strides with a unit-stride head dim. hd in {8, 16, 64, 128};
// H % KVH == 0; dtype 0 = float32, 1 = bfloat16 (q, k, v and o share
// it); causal 0 or 1. Returns cudaGetLastError() after the launch
// (0 = launched).
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int B, int S, int H, int KVH, int hd,
                            long long q_sb, long long q_ss, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            float scale, int causal, int dtype,
                            void* stream) {
  if (B < 1 || S < 1 || H < 1 || KVH < 1 || H % KVH != 0 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{B,    S,    H,    KVH,  q_sb,  q_ss,        q_sh,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, hd, a, st);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, o, hd, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
