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
// element, far below the operations-per-byte balance. So the loads must
// use every lane and keep enough bytes in flight to cover the memory
// latency, and the arithmetic must stay off the critical path.
//
// Design (2m a multiple of 4 up to 32, 16-byte aligned tensors: the
// training paths' 2m = 24): A TILE OF 64 ROWS PER BLOCK, FOUR THREADS PER
// ROW. The block copies its tile of Theta and grad (2 x 6 KB at 2m = 24)
// into shared memory with 16-byte cp.async copies, contiguous across the
// block so that no lane idles, all in flight before one wait. Lane t of a
// row's four then takes columns t, t + 4, t + 8, ... (rows sit at an odd
// stride of 16-byte chunks, so these reads meet no bank conflict), forms
// the two row norms (in-lane adds, then two shuffles), the three-case
// select in registers, writes d over its Theta columns in shared memory,
// and the block stores the tile with coalesced 16-byte stores. Four lanes a
// row keep each thread's chain of IEEE divisions short (one thread a row
// ran 1.2x slower than a warp a row); several blocks per SM overlap one
// tile's copies with another's arithmetic.
//
// Other shapes (2m not a multiple of 4, 2m > 32, unaligned views): ONE
// WARP PER ROW, lane j owning column j (and j + 32c when 2m > 32); the
// norms are warp-shuffle sums.
//
// Both designs give the same bits. A row norm is the xor-16..1 butterfly
// of warp_sum over per-lane sums of squares (columns j + 32c, c in order);
// the tile design builds the same tree over four lanes (quad_sum), leaving
// out only adds of leaves past 2m, whose +0.0 changes nothing (a sum of
// squares is >= +0.0). Float addition is commutative, so every lane of a
// butterfly holds that tree's value.
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
constexpr int kTileRows = 64;   // rows of a tile of the tile design
constexpr int kRowLanes = 4;    // its threads a row
constexpr int kTileThreads = kTileRows * kRowLanes;
constexpr int kMaxTileQuads = 8;  // the tile design: 2m <= 32 columns
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

// warp_sum's tree over a row held by kRowLanes = 4 neighbouring lanes:
// lane t holds the leaves of columns t + 4i (i < NQ). The tree's levels 16,
// 8 and 4 pair leaves of one lane, levels 2 and 1 neighbouring lanes. A
// leaf past 2m is +0.0: its add is left out where every lane's is one.
template <int NQ>
__device__ __forceinline__ float quad_sum(float (&s)[NQ]) {
#pragma unroll
  for (int h = 4; h > 0; h >>= 1) {  // tree level 4h
#pragma unroll
    for (int i = 0; i < h; ++i)
      if (i + h < NQ) s[i] = __fadd_rn(s[i], s[i + h]);
  }
  float v = s[0];
  v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, 2));
  return __fadd_rn(v, __shfl_xor_sync(kFullMask, v, 1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(smem))),
               "l"(gmem));
}

template <int NQ>  // 16-byte chunks a row: 2m = 4 NQ
__global__ void __launch_bounds__(kTileThreads)
owlqn_direction_tile_kernel(const float4* __restrict__ theta,
                            const float4* __restrict__ grad,
                            float4* __restrict__ out, int D, float lam,
                            float beta) {
  constexpr int kStride = NQ | 1;  // odd: conflict-free column reads
  __shared__ float4 th_s[kTileRows * kStride];
  __shared__ float4 g_s[kTileRows * kStride];
  const int r0 = blockIdx.x * kTileRows;
  const int chunks = min(kTileRows, D - r0) * NQ;
  const size_t base = static_cast<size_t>(r0) * NQ;
  for (int f = threadIdx.x; f < chunks; f += kTileThreads) {
    const int slot = (f / NQ) * kStride + f % NQ;
    cp_async16(th_s + slot, theta + base + f);
    cp_async16(g_s + slot, grad + base + f);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // lane t of the row's four: columns t + 4i. Rows past D (the last
  // tile) compute on whatever the buffer holds and write nothing.
  const int r = threadIdx.x / kRowLanes;
  const int t = threadIdx.x % kRowLanes;
  float* th_row = reinterpret_cast<float*>(th_s + r * kStride) + t;
  const float* g_row = reinterpret_cast<const float*>(g_s + r * kStride) + t;
  float th[NQ], g[NQ], v[NQ], ss[NQ], vs[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    th[i] = th_row[4 * i];
    g[i] = -g_row[4 * i];
    ss[i] = __fmul_rn(th[i], th[i]);
    v[i] = __fmul_rn(fmaxf(__fsub_rn(fabsf(g[i]), beta), 0.0f),
                     sign_of(g[i]));
    vs[i] = __fmul_rn(v[i], v[i]);
  }
  const float rn = __fsqrt_rn(quad_sum<NQ>(ss));
  const float vn = __fsqrt_rn(quad_sum<NQ>(vs));
  if (rn > 0.0f) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const float s = __fsub_rn(g[i], __fdiv_rn(__fmul_rn(lam, th[i]), rn));
      th[i] = th[i] != 0.0f
                  ? __fsub_rn(s, __fmul_rn(beta, sign_of(th[i])))  // case a
                  : __fmul_rn(fmaxf(__fsub_rn(fabsf(s), beta), 0.0f),
                              sign_of(s));  // case b
    }
  } else {
    const float shrink =
        __fdiv_rn(fmaxf(__fsub_rn(vn, lam), 0.0f), vn > 0.0f ? vn : 1.0f);
#pragma unroll
    for (int i = 0; i < NQ; ++i) th[i] = __fmul_rn(shrink, v[i]);  // case c
  }
  if (r0 + r < D) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) th_row[4 * i] = th[i];
  }
  __syncthreads();
  for (int f = threadIdx.x; f < chunks; f += kTileThreads)
    out[base + f] = th_s[(f / NQ) * kStride + f % NQ];
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
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(theta) |
                         reinterpret_cast<uintptr_t>(grad) |
                         reinterpret_cast<uintptr_t>(out);
  if (m2 % 4 == 0 && m2 / 4 <= kMaxTileQuads && addr % 16 == 0) {
    const auto tile = (m2 == 4    ? owlqn_direction_tile_kernel<1>
                       : m2 == 8  ? owlqn_direction_tile_kernel<2>
                       : m2 == 12 ? owlqn_direction_tile_kernel<3>
                       : m2 == 16 ? owlqn_direction_tile_kernel<4>
                       : m2 == 20 ? owlqn_direction_tile_kernel<5>
                       : m2 == 24 ? owlqn_direction_tile_kernel<6>
                       : m2 == 28 ? owlqn_direction_tile_kernel<7>
                                  : owlqn_direction_tile_kernel<8>);
    tile<<<(D + kTileRows - 1) / kTileRows, kTileThreads, 0, s>>>(
        static_cast<const float4*>(theta), static_cast<const float4*>(grad),
        static_cast<float4*>(out), D, lam, beta);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((D + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto kernel = chunks == 1   ? owlqn_direction_kernel<1>
                      : chunks == 2 ? owlqn_direction_kernel<2>
                      : chunks == 3 ? owlqn_direction_kernel<3>
                                    : owlqn_direction_kernel<4>;
  kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(theta), static_cast<const float*>(grad),
      static_cast<float*>(out), D, m2, lam, beta);
  return static_cast<int>(cudaGetLastError());
}

const char* owlqn_direction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
