// Run-length dTheta scatter of the sparse LS-PLM backward, for Hopper
// (sm_90a). Replaces the Pallas kernel
// src/repro/kernels/lsplm_sparse_scatter/lsplm_sparse_scatter.py `_kernel`
// (launched by `lsplm_sparse_scatter_compact`).
//
// The transpose plan sorts the batch's kept entries by column id, so the
// scatter dTheta[r] = sum_{ids[n,k]=r} vals[n,k] * dz[n] becomes a
// RUN-LENGTH SEGMENT SUM over the sorted entries:
//
//   compact[u] = sum_{e in run u} vals_sorted[e] * dz[sample_sorted[e]]
//
// for each of the U runs (distinct ids, in id order), plus a trailing row
// compact[U] that is exactly zero; the caller densifies with one gather
// through plan.inv_sorted (untouched ids point at row U).
//
// What bounds it on this card: device-memory bytes. Each sorted entry
// moves 12 B (sample, value, and its 2m-float dz row, which L2 mostly
// serves: N*2m*4 B of dz is 1.5 MB at the launch defaults) and does one
// multiply-add per column, far below the operations-per-byte balance.
//
// Design. The TPU walks the sorted entries in one sequential grid and
// flushes a VMEM accumulator per run; blocks on this card run in parallel
// and in no order. Runs are very uneven: generate_sparse's u**10 Zipf draw
// gives one id a quarter of a side's entries (51,099 of 192,000 at the
// launch defaults), so one warp per run would leave that warp serial
// while the rest of the card idles. The plan therefore cuts every run
// into PIECES of at most 256 entries (plan.run_pieces, built once per
// batch), and the kernel runs in two passes:
//
//   pass 1: one warp per piece sums its entries IN ENTRY ORDER, lane j
//           owning column j (columns j + 32c when 2m > 32). The (sample,
//           value) pairs are read 32 at a time, coalesced, and broadcast
//           by shuffle. A run of one piece is written to compact[u]
//           directly; otherwise the sum goes to partial[p].
//   pass 2: one warp per run of several pieces adds its partials IN
//           PIECE ORDER and writes compact[u]; the warp for row U writes
//           the zero row.
//
// Every compact row has exactly one writer and every sum has a fixed
// order, so there are no atomics and two identical calls give bitwise
// equal results. Products and sums use __fmul_rn / __fadd_rn, so nvcc
// contracts nothing into an FMA (the plain version rounds each product).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxChunks = 4;  // 2m <= 128 columns
constexpr unsigned kFullMask = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
piece_sums_kernel(const int32_t* __restrict__ piece_start,
                  const int32_t* __restrict__ piece_run,
                  const int32_t* __restrict__ run_piece_start,
                  const int32_t* __restrict__ sample_sorted,
                  const float* __restrict__ vals_sorted,
                  const float* __restrict__ dz,
                  float* __restrict__ partial,
                  float* __restrict__ compact,
                  int num_pieces, int m2) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= num_pieces) return;  // warp-uniform
  const int begin = piece_start[p];
  const int end = piece_start[p + 1];
  const int run = piece_run[p];
  const bool whole_run = run_piece_start[run + 1] - run_piece_start[run] == 1;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  for (int e0 = begin; e0 < end; e0 += 32) {
    int my_n = 0;
    float my_v = 0.0f;
    if (e0 + lane < end) {
      my_n = sample_sorted[e0 + lane];
      my_v = vals_sorted[e0 + lane];
    }
    const int count = min(32, end - e0);
#pragma unroll 4
    for (int t = 0; t < count; ++t) {  // entry order
      const int n = __shfl_sync(kFullMask, my_n, t);
      const float v = __shfl_sync(kFullMask, my_v, t);
      const float* row = dz + static_cast<size_t>(n) * m2;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = c * 32 + lane;
        if (j < m2) acc[c] = __fadd_rn(acc[c], __fmul_rn(v, __ldg(row + j)));
      }
    }
  }

  float* out = whole_run ? compact + static_cast<size_t>(run) * m2
                         : partial + static_cast<size_t>(p) * m2;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    if (j < m2) out[j] = acc[c];
  }
}

template <int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
run_sums_kernel(const int32_t* __restrict__ run_piece_start,
                const float* __restrict__ partial,
                float* __restrict__ compact, int num_unique, int m2) {
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (u > num_unique) return;  // warp-uniform; u == num_unique: zero row

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  if (u < num_unique) {
    const int first = run_piece_start[u];
    const int last = run_piece_start[u + 1];
    if (last - first == 1) return;  // pass 1 wrote this run whole
#pragma unroll 4
    for (int q = first; q < last; ++q) {  // piece order
      const float* row = partial + static_cast<size_t>(q) * m2;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = c * 32 + lane;
        if (j < m2) acc[c] = __fadd_rn(acc[c], row[j]);
      }
    }
  }
  float* out = compact + static_cast<size_t>(u) * m2;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    if (j < m2) out[j] = acc[c];
  }
}

template <int C>
int launch(const int32_t* piece_start, const int32_t* piece_run,
           const int32_t* run_piece_start, const int32_t* sample_sorted,
           const float* vals_sorted, const float* dz, float* partial,
           float* compact, int num_pieces, int num_unique, int m2,
           cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  if (num_pieces > 0) {
    const dim3 grid((num_pieces + kWarpsPerBlock - 1) / kWarpsPerBlock);
    piece_sums_kernel<C><<<grid, block, 0, stream>>>(
        piece_start, piece_run, run_piece_start, sample_sorted, vals_sorted,
        dz, partial, compact, num_pieces, m2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((num_unique + 1 + kWarpsPerBlock - 1) / kWarpsPerBlock);
  run_sums_kernel<C><<<grid, block, 0, stream>>>(run_piece_start, partial,
                                                 compact, num_unique, m2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// compact (num_unique + 1, m2) <- run sums; partial is (num_pieces, m2)
// scratch. Returns cudaGetLastError() after the launches (0 = launched).
int lsplm_sparse_scatter_compact(const void* piece_start,
                                 const void* piece_run,
                                 const void* run_piece_start,
                                 const void* sample_sorted,
                                 const void* vals_sorted, const void* dz,
                                 void* partial, void* compact, int num_pieces,
                                 int num_unique, int m2, void* stream) {
  const int chunks = (m2 + 31) / 32;
  if (num_pieces < 0 || num_unique < 0 || m2 < 1 || chunks > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fn = chunks == 1 ? launch<1>
                  : chunks == 2 ? launch<2>
                  : chunks == 3 ? launch<3>
                                : launch<4>;
  return fn(static_cast<const int32_t*>(piece_start),
            static_cast<const int32_t*>(piece_run),
            static_cast<const int32_t*>(run_piece_start),
            static_cast<const int32_t*>(sample_sorted),
            static_cast<const float*>(vals_sorted),
            static_cast<const float*>(dz), static_cast<float*>(partial),
            static_cast<float*>(compact), num_pieces, num_unique, m2,
            static_cast<cudaStream_t>(stream));
}

const char* lsplm_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
