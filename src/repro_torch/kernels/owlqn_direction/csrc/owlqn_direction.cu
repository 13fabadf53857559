// Eq. 9 descent direction of OWLQN+ for Hopper (sm_90a). Replaces the
// Pallas kernel src/repro/kernels/owlqn_direction/owlqn_direction.py
// `_kernel` (launched by `owlqn_direction`).
//
// Per feature row i of the (D, 2m) Theta and its smooth gradient:
//   g = -grad, rn = ||Theta_i.||, s = g - lam * Theta / rn,
//   d = s - beta*sign(Theta)              where Theta_ij != 0      (case a)
//     = max(|s| - beta, 0) * sign(s)      where Theta_ij == 0 but
//                                          the row is live (rn > 0)   (case b)
//     = max(||v|| - lam, 0) / ||v|| * v,  v = max(|g| - beta, 0) * sign(g),
//                                          when the whole row is zero (case c)
//
// What bounds it on this card: device-memory bytes. It reads Theta and
// grad once and writes d once (3 * D * 2m * 4 B, 288 MB at D = 10^6,
// m = 12, about 0.086 ms at 3.35 TB/s) and does a few dozen operations per
// element, far below the operations-per-byte balance.
//
// Design: ONE WARP PER FEATURE ROW, lane j owning column j (and j + 32c
// when 2m > 32), so a 96-byte row is one coalesced warp load. The two row
// norms (||Theta_i.|| and ||v_i.||) are warp-shuffle sums; the three-case
// select then runs in registers and d is written once. The TPU kernel's
// (block_rows, 2m) VMEM tile becomes the block's 8 rows; nothing carries
// across blocks.
//
// Exact-sign semantics, as core/direction.py: sign(+-0) = 0, the element
// test is `theta != 0.0f` (so -0.0 counts as zero), a row is live iff
// rn > 0. sqrt and division are IEEE round-to-nearest (__fsqrt_rn,
// __fdiv_rn), products and sums __fmul_rn / __fadd_rn, so nvcc contracts
// nothing into an FMA. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChunks = 4;  // 2m <= 128 columns
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

template <int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
owlqn_direction_kernel(const float* __restrict__ theta,
                       const float* __restrict__ grad,
                       float* __restrict__ out, int D, int m2, float lam,
                       float beta) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= D) return;  // warp-uniform
  const size_t base = static_cast<size_t>(row) * m2;

  float th[C], g[C], v[C];
  float ss = 0.0f;  // sum of Theta^2 over this lane's columns
  float vs = 0.0f;  // sum of v^2
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    th[c] = 0.0f;
    g[c] = 0.0f;
    if (j < m2) {
      th[c] = __ldg(theta + base + j);
      g[c] = -__ldg(grad + base + j);
    }
    ss = __fadd_rn(ss, __fmul_rn(th[c], th[c]));
    v[c] = __fmul_rn(fmaxf(__fsub_rn(fabsf(g[c]), beta), 0.0f),
                     sign_of(g[c]));
    vs = __fadd_rn(vs, __fmul_rn(v[c], v[c]));
  }
  const float rn = __fsqrt_rn(warp_sum(ss));
  const float vn = __fsqrt_rn(warp_sum(vs));
  const bool row_nonzero = rn > 0.0f;
  const float safe_rn = row_nonzero ? rn : 1.0f;
  const float shrink =
      __fdiv_rn(fmaxf(__fsub_rn(vn, lam), 0.0f), vn > 0.0f ? vn : 1.0f);

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    if (j >= m2) continue;
    float d;
    if (row_nonzero) {
      const float s = __fsub_rn(g[c], __fdiv_rn(__fmul_rn(lam, th[c]), safe_rn));
      if (th[c] != 0.0f) {
        d = __fsub_rn(s, __fmul_rn(beta, sign_of(th[c])));  // case a
      } else {
        d = __fmul_rn(fmaxf(__fsub_rn(fabsf(s), beta), 0.0f),
                      sign_of(s));  // case b
      }
    } else {
      d = __fmul_rn(shrink, v[c]);  // case c
    }
    out[base + j] = d;
  }
}

}  // namespace

extern "C" {

// out (D, m2) <- Eq. 9 direction. Returns cudaGetLastError() after the
// launch (0 = launched).
int owlqn_direction(const void* theta, const void* grad, void* out, int D,
                    int m2, float lam, float beta, void* stream) {
  const int chunks = (m2 + 31) / 32;
  if (D < 1 || m2 < 1 || chunks > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((D + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto kernel = chunks == 1   ? owlqn_direction_kernel<1>
                      : chunks == 2 ? owlqn_direction_kernel<2>
                      : chunks == 3 ? owlqn_direction_kernel<3>
                                    : owlqn_direction_kernel<4>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(grad),
      static_cast<float*>(out), D, m2, lam, beta);
  return static_cast<int>(cudaGetLastError());
}

const char* owlqn_direction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
