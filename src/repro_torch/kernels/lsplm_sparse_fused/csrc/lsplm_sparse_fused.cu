// Fused sparse LS-PLM forward for Hopper (sm_90a): padded-COO gather-matmul
// z[n] = sum_k vals[n,k] * Theta[ids[n,k]] with the Eq. 2 head
// p[n] = sum_j softmax(z_u)[j] * sigmoid(z_w)[j] fused in, in two variants:
//
//   lsplm_sparse_fused_forward       fp32 Theta rows. Replaces the Pallas
//       kernel src/repro/kernels/lsplm_sparse_fused/lsplm_sparse_fused.py
//       `_kernel` (launched by `lsplm_sparse_fused_forward`).
//   lsplm_sparse_fused_int8_forward  int8 code rows + one fp32 scale per
//       row, dequantised in registers before the fp32 contraction. Replaces
//       `_kernel_int8` of the same file (`lsplm_sparse_fused_int8_forward`).
//
// What bounds it on this card: device-memory bytes. Each live slot moves one
// Theta row (2m fp32 = 96 B at m = 12, or 2m int8 + one fp32 scale = 24 B +
// 4 B) and does one FMA per loaded float, so the work is far below the
// H100's operations-per-byte balance. The bytes a call must move are
// N*K*8 B of ids and vals, plus the live rows, plus N*(2m+1)*4 B written.
//
// Design (the first one: simple and right, not yet fast): ONE WARP PER
// SAMPLE ROW. Lane j owns column j (columns j + 32c when 2m > 32). The warp
// reads its row's ids and vals 32 slots at a time (one coalesced load each)
// and walks the slots IN SLOT ORDER, broadcasting each (id, val) by shuffle;
// a pad slot (id == D-1) issues no row load at all, and a 96-byte row is
// one coalesced warp load. The accumulation order depends only on the row's
// own slots -- never on N, the grid or the block -- which is what keeps
// single-vs-batched scoring, coalesced-vs-per-envelope dispatch and
// pruned-vs-full Theta bitwise equal on the card. Do not split K across
// warps. The int8 variant forms row = code * scale with one rounded multiply
// (__fmul_rn) and then the same FMA, so it matches the fp32 kernel run on
// the dequantised Theta.
//
// Head: softmax max and sum by warp shuffles (expf, not __expf), the gate
// and fit columns paired through a 4*2m-byte per-warp shared buffer, the
// gate*fit sum by a warp shuffle. Build without --use_fast_math.
//
// Ids outside [0, D) are treated like the pad id: the kernel never reads
// outside Theta (callers pass ids in range; the plain version raises).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChunks = 4;  // 2m <= 128 columns
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

template <int C, bool kInt8>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_forward_kernel(const int32_t* __restrict__ ids,
                     const float* __restrict__ vals,
                     const float* __restrict__ theta,
                     const int8_t* __restrict__ codes,
                     const float* __restrict__ scales,
                     float* __restrict__ p, float* __restrict__ z,
                     int N, int K, int D, int m) {
  extern __shared__ float zs_block[];  // kWarpsPerBlock * 2m floats
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kWarpsPerBlock + warp;
  if (n >= N) return;  // n is warp-uniform: whole warps leave together
  const int m2 = 2 * m;
  const int skip_id = D - 1;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  const int32_t* row_ids = ids + static_cast<size_t>(n) * K;
  const float* row_vals = vals + static_cast<size_t>(n) * K;
  for (int k0 = 0; k0 < K; k0 += 32) {
    int my_id = skip_id;
    float my_val = 0.0f;
    if (k0 + lane < K) {
      my_id = row_ids[k0 + lane];
      my_val = row_vals[k0 + lane];
    }
    const int count = min(32, K - k0);
    for (int t = 0; t < count; ++t) {  // slot order
      const int id = __shfl_sync(kFullMask, my_id, t);
      const float v = __shfl_sync(kFullMask, my_val, t);
      if (id == skip_id || static_cast<unsigned>(id) >= static_cast<unsigned>(D))
        continue;  // warp-uniform: a pad slot loads nothing
      if constexpr (kInt8) {
        const float s = __ldg(scales + id);
        const int8_t* row = codes + static_cast<size_t>(id) * m2;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = c * 32 + lane;
          if (j < m2) {
            const float r = __fmul_rn(static_cast<float>(__ldg(row + j)), s);
            acc[c] = __fmaf_rn(v, r, acc[c]);
          }
        }
      } else {
        const float* row = theta + static_cast<size_t>(id) * m2;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = c * 32 + lane;
          if (j < m2) acc[c] = __fmaf_rn(v, __ldg(row + j), acc[c]);
        }
      }
    }
  }

  // z out, and the warp's copy for pairing gate column j with fit column j+m
  float* zs = zs_block + warp * m2;
  float* z_row = z + static_cast<size_t>(n) * m2;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    if (j < m2) {
      z_row[j] = acc[c];
      zs[j] = acc[c];
    }
  }
  __syncwarp();

  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c * 32 + lane < m) mx = fmaxf(mx, acc[c]);
  }
  mx = warp_max(mx);
  float e[C];
  float denom = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    e[c] = 0.0f;
    if (c * 32 + lane < m) {
      e[c] = expf(acc[c] - mx);
      denom += e[c];
    }
  }
  denom = warp_sum(denom);
  float part = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    if (j < m) {
      const float gate = e[c] / denom;
      const float fit = 1.0f / (1.0f + expf(-zs[j + m]));
      part += gate * fit;
    }
  }
  part = warp_sum(part);
  if (lane == 0) p[n] = part;
}

template <bool kInt8>
int launch(const int32_t* ids, const float* vals, const float* theta,
           const int8_t* codes, const float* scales, float* p, float* z,
           int N, int K, int D, int m, cudaStream_t stream) {
  const int m2 = 2 * m;
  const int chunks = (m2 + 31) / 32;
  if (N <= 0 || K < 0 || D < 1 || m < 1 || chunks > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * m2 * sizeof(float);
  switch (chunks) {
    case 1:
      fused_forward_kernel<1, kInt8><<<grid, block, smem, stream>>>(
          ids, vals, theta, codes, scales, p, z, N, K, D, m);
      break;
    case 2:
      fused_forward_kernel<2, kInt8><<<grid, block, smem, stream>>>(
          ids, vals, theta, codes, scales, p, z, N, K, D, m);
      break;
    case 3:
      fused_forward_kernel<3, kInt8><<<grid, block, smem, stream>>>(
          ids, vals, theta, codes, scales, p, z, N, K, D, m);
      break;
    default:
      fused_forward_kernel<4, kInt8><<<grid, block, smem, stream>>>(
          ids, vals, theta, codes, scales, p, z, N, K, D, m);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int lsplm_sparse_fused_forward(const void* ids, const void* vals,
                               const void* theta, void* p, void* z, int N,
                               int K, int D, int m, void* stream) {
  return launch<false>(static_cast<const int32_t*>(ids),
                       static_cast<const float*>(vals),
                       static_cast<const float*>(theta), nullptr, nullptr,
                       static_cast<float*>(p), static_cast<float*>(z), N, K, D,
                       m, static_cast<cudaStream_t>(stream));
}

int lsplm_sparse_fused_int8_forward(const void* ids, const void* vals,
                                    const void* codes, const void* scales,
                                    void* p, void* z, int N, int K, int D,
                                    int m, void* stream) {
  return launch<true>(static_cast<const int32_t*>(ids),
                      static_cast<const float*>(vals), nullptr,
                      static_cast<const int8_t*>(codes),
                      static_cast<const float*>(scales),
                      static_cast<float*>(p), static_cast<float*>(z), N, K, D,
                      m, static_cast<cudaStream_t>(stream));
}

const char* lsplm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
