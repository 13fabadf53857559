// Run-length dTheta scatter of the sparse LS-PLM backward, for Hopper
// (sm_90a). Replaces the Pallas kernel
// src/repro/kernels/lsplm_sparse_scatter/lsplm_sparse_scatter.py `_kernel`
// (launched by `lsplm_sparse_scatter`).
//
// The transpose plan sorts the batch's kept entries by column id, so the
// scatter dTheta[r] = sum_{ids[n,k]=r} vals[n,k] * dz[n] becomes a
// RUN-LENGTH SEGMENT SUM over the sorted entries,
//
//   dTheta[row of run u] = sum_{e in run u} vals[order[e]] * dz[sample[e]],
//
// and the kernel writes the whole dense (D, 2m) dTheta: every touched row
// its run's sum, every other row (the pad row included) exactly 0.
//
// What bounds it on this card: device-memory bytes, and most of them are
// the zeros. At D = 10^6 + 1, 2m = 24 the dense write is 96 MB against
// ~8 MB of entries, dz rows and the (D,) inv_sorted that says which rows
// are untouched (~0.031 ms at 3.35 TB/s); the sums do one multiply-add per
// column and entry, far below the operations-per-byte balance. Beside the
// sweep, the hot run's chain of ~20 dependent memory round trips (8 batches
// of one piece, then 7 chunks of its 200 partials) is the critical path,
// and the sweep's writes lengthen each of its trips.
//
// Design. ONE LAUNCH of two kinds of blocks, task blocks first:
//
//   task blocks: a task is a window of 32 sorted entries holding a piece
//       start (plan.task_piece_start); its warp takes the pieces that
//       start in it -- at most 32 pieces of at most 256 entries
//       (plan.run_pieces), so a hot id's 51,099-entry run (generate_sparse's
//       u**10 Zipf draw at the launch defaults) is 200 pieces summed by 200
//       warps at once, and those tasks (small ids sort first) start first.
//       The warp walks its entries 32 at a time: cp.async copies of the
//       batch's 32 dz rows into a per-warp buffer (16 bytes a copy when the
//       row width and dz's address allow, else 4) and ONE wait; samples
//       and orders come two batches ahead and values (vals[order]) one
//       batch ahead, so that wait is the batch's only one. Lane j (columns
//       j + 32c) forms 8 rounded products at a time and adds them IN ENTRY
//       ORDER; a group of 8 without a piece end takes a branch-free path.
//       At a piece end, a run of one piece is written to its dTheta row;
//       otherwise the sum goes to partial[p] and an integer ticket on the
//       run (atomicAdd after a __threadfence) picks the warp that finished
//       last. That step is out of line: inlined after each unrolled add, it
//       made a batch fetch ~90 KB of code. The last warp, after its walk,
//       copies the run's partials 32 at a time (cp.async.cg: L2, never a
//       stale L1 line), adds them IN PIECE ORDER from 0, writes the run's
//       row and sets the ticket back to 0, so tickets start every call at
//       0 without a memset (the wrapper keeps one zeroed buffer per
//       stream).
//   zero blocks (after them): a coalesced pass over dTheta in 16-byte
//       stores (4-byte when 2m % 4 != 0) writes 0 to every row whose
//       inv_sorted entry is U (untouched). Their rows are disjoint from
//       the tasks' rows, so zero blocks fill the card as task blocks
//       retire, and the latency-bound hot runs finish under the sweep.
//
// Block size: `warps` task warps a block (4, 8 or 16, so 128, 256 or 512
// sorted entries a task block: the tune table's `block_e`; 8 by default),
// one kernel instantiation each. It decides only which warp takes which
// task and how the zero sweep is cut, never an operation's order.
//
// Bits: each piece sums from 0 in entry order with __fmul_rn then
// __fadd_rn (nvcc contracts nothing into an FMA), and a run's partials
// are added from 0 in piece order, whichever warp finishes the run. Every
// dTheta row has exactly one writer, there are no float atomics, and two
// identical calls give bitwise equal results (ref.scatter_runs_ref
// repeats this association in plain PyTorch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSweepPerThread = 4;  // stores per zero-block thread
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may use
constexpr int kOverBudget = -1;     // a block whose buffers exceed kMaxSmem
                                    // (OVER_BUDGET of the Python wrapper)
constexpr int kMaxChunks = 4;       // 2m <= 128 columns
constexpr int kBatch = 32;          // dz rows / partials per cp.async wait
constexpr int kUnroll = 8;          // terms formed ahead of their adds
constexpr unsigned kFullMask = 0xffffffffu;

struct Args {
  const int32_t* task_piece_start;  // (T+1,)
  const int32_t* piece_start;       // (P+1,)
  const int32_t* piece_run;         // (P,)
  const int32_t* run_piece_start;   // (U+1,)
  const int32_t* row_ids;           // (E',) sorted column ids
  const int32_t* order;             // (E',) sorted position -> flat entry
  const int32_t* sample_sorted;     // (E',) sorted position -> sample
  const int32_t* inv_sorted;        // (D,) column id -> run, U: untouched
  const float* vals;                // (N*K,) flat
  const float* dz;                  // (N, m2)
  float* partial;                   // (P, m2) scratch
  int32_t* ticket;                  // (U,) all 0 at the start and the end
  float* out;                       // (D, m2)
  int num_tasks, task_blocks, num_rows, num_unique, m2;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// End the warp's copies in flight and share the landed rows.
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Start copying `rows` rows of m2 floats into buf (row t at buf + t * m2):
// row t comes from src + src_row(t) * m2. kVec: 16-byte cp.async pieces;
// else 4-byte ones. kL2: through L2 only (.cg; the 4-byte path loads with
// __ldcg), for data other warps wrote during this launch. wait_copies()
// ends them.
template <bool kVec, bool kL2, class SrcRow>
__device__ __forceinline__ void copy_rows(float* buf, const float* src,
                                          int rows, int m2, int lane,
                                          SrcRow src_row) {
  const int per_row = kVec ? m2 / 4 : m2;
  const int total = rows * per_row;
  for (int f0 = 0; f0 < total; f0 += 32) {  // warp-uniform trip count
    const int f = f0 + lane;
    const int t = f / per_row;
    const int r = src_row(t < 32 ? t : 0);  // every lane shuffles
    if (f < total) {
      const int q = f - t * per_row;
      if (kVec) {
        const float* g = src + static_cast<size_t>(r) * m2 + 4 * q;
        const unsigned d = smem_addr(buf + 4 * f);
        if (kL2)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                       "l"(g));
        else
          asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
                       "l"(g));
      } else {
        const float* g = src + static_cast<size_t>(r) * m2 + q;
        if (kL2)
          buf[f] = __ldcg(g);
        else
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                           smem_addr(buf + f)),
                       "l"(g));
      }
    }
  }
}

// kUnroll rows of the buffer from row t0, times vt(t) when kScale: the
// terms of the next kUnroll ordered adds, formed before any of them (rows
// past the copied ones give unused values)
template <int C, bool kScale, class Scale>
__device__ __forceinline__ void load_terms(float (&p)[kUnroll][C],
                                           const float* buf, int t0, int m2,
                                           int lane, Scale vt) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const float s = kScale ? vt(t0 + u) : 1.0f;  // every lane shuffles
    const float* row = buf + (t0 + u) * m2;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      p[u][c] = 0.0f;
      if (j < m2) p[u][c] = kScale ? __fmul_rn(s, row[j]) : row[j];
    }
  }
}

template <int C>
__device__ __forceinline__ void store_row(float* dst, const float (&acc)[C],
                                          int m2, int lane) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    if (j < m2) dst[j] = acc[c];
  }
}

// The run's partials [first, first + count) added from 0 in piece order,
// 32 at a time, written to its dTheta row.
template <int C, bool kVec>
__device__ void finish_run(const Args& a, int first, int count, int row,
                           int lane, float* buf) {
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  for (int q0 = first; q0 < first + count; q0 += kBatch) {
    const int cnt = min(kBatch, first + count - q0);
    copy_rows<kVec, true>(buf, a.partial, cnt, a.m2, lane,
                          [q0](int t) { return q0 + t; });
    wait_copies();
    for (int t0 = 0; t0 < cnt; t0 += kUnroll) {  // piece order
      float p[kUnroll][C];
      load_terms<C, false>(p, buf, t0, a.m2, lane, [](int) { return 1.0f; });
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t0 + u < cnt) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], p[u][c]);
        }
      }
    }
    __syncwarp();  // the buffer is refilled next
  }
  store_row<C>(a.out + static_cast<size_t>(row) * a.m2, acc, a.m2, lane);
}

template <int C>
struct Sums {
  float v[C];
};

// A piece of a multi-piece run is summed: its partial, then the run's
// ticket. Returns whether this warp came last in the run. Kept out of
// line (see the header).
template <int C>
__device__ __noinline__ bool flush_partial(float* partial, int32_t* ticket,
                                           int m2, Sums<C> acc, int p,
                                           int run, int count, int lane) {
  store_row<C>(partial + static_cast<size_t>(p) * m2, acc.v, m2, lane);
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(ticket + run, 1) == count - 1;
  return __shfl_sync(kFullMask, last, 0) != 0;
}

template <int C, bool kVec>
__device__ void run_task(const Args& a, int task, int lane, float* buf) {
  const int p0 = a.task_piece_start[task];
  const int np = a.task_piece_start[task + 1] - p0;  // 1..32 pieces
  // lane i: piece p0 + i's end, run, run length in pieces and dTheta row
  int my_end = 0, my_run = 0, my_count = 0, my_row = 0;
  const int e_begin = a.piece_start[p0];
  if (lane < np) {
    my_end = a.piece_start[p0 + lane + 1];
    my_run = a.piece_run[p0 + lane];
  }
  const int my_begin = __shfl_up_sync(kFullMask, my_end, 1);
  if (lane < np) {
    my_row = a.row_ids[lane == 0 ? e_begin : my_begin];
    my_count = a.run_piece_start[my_run + 1] - a.run_piece_start[my_run];
  }
  const int e_end = __shfl_sync(kFullMask, my_end, np - 1);

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  int cur = 0;  // the piece being summed, within the task
  int boundary = __shfl_sync(kFullMask, my_end, 0);
  unsigned won = 0;  // pieces whose ticket came last in their run
  // lane t: entry t of a batch. Samples and orders are loaded two batches
  // ahead and values one, so a batch waits only for its dz copies.
  int n = 0, n1 = 0, o1 = 0;
  float v = 0.0f;
  {
    const int e = e_begin + lane;
    int o = 0;
    if (e < e_end) {
      n = a.sample_sorted[e];
      o = a.order[e];
    }
    if (e + kBatch < e_end) {
      n1 = a.sample_sorted[e + kBatch];
      o1 = a.order[e + kBatch];
    }
    if (e < e_end) v = a.vals[o];
  }
  for (int e0 = e_begin; e0 < e_end; e0 += kBatch) {
    const int cnt = min(kBatch, e_end - e0);
    copy_rows<kVec, false>(buf, a.dz, cnt, a.m2, lane, [n](int t) {
      return __shfl_sync(kFullMask, n, t);
    });
    const int e2 = e0 + 2 * kBatch + lane;
    int n2 = 0, o2 = 0;
    if (e2 < e_end) {
      n2 = a.sample_sorted[e2];
      o2 = a.order[e2];
    }
    wait_copies();
    const float vt = v;
    if (e2 - kBatch < e_end) v = a.vals[o1];  // in flight during the adds
    n = n1;
    n1 = n2;
    o1 = o2;
    for (int t0 = 0; t0 < cnt; t0 += kUnroll) {  // entry order
      float p[kUnroll][C];
      load_terms<C, true>(p, buf, t0, a.m2, lane, [vt](int t) {
        return __shfl_sync(kFullMask, vt, t);
      });
      if (boundary > e0 + min(t0 + kUnroll, cnt)) {  // no piece ends here
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t0 + u < cnt) {
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], p[u][c]);
          }
        }
        continue;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (t0 + u < cnt) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], p[u][c]);
          if (e0 + t0 + u + 1 == boundary) {  // piece `cur` ends here
            const int count = __shfl_sync(kFullMask, my_count, cur);
            if (count == 1) {
              const int r = __shfl_sync(kFullMask, my_row, cur);
              store_row<C>(a.out + static_cast<size_t>(r) * a.m2, acc, a.m2,
                           lane);
            } else {
              Sums<C> s;
#pragma unroll
              for (int c = 0; c < C; ++c) s.v[c] = acc[c];
              if (flush_partial<C>(a.partial, a.ticket, a.m2, s, p0 + cur,
                                   __shfl_sync(kFullMask, my_run, cur),
                                   count, lane))
                won |= 1u << cur;
            }
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = 0.0f;
            ++cur;
            boundary = __shfl_sync(kFullMask, my_end, cur & 31);
          }
        }
      }
    }
    __syncwarp();  // the buffer is refilled next
  }

  while (won) {  // the runs this warp finished last
    const int i = __ffs(won) - 1;
    won &= won - 1;
    const int run = __shfl_sync(kFullMask, my_run, i);
    const int count = __shfl_sync(kFullMask, my_count, i);
    const int row = __shfl_sync(kFullMask, my_row, i);
    __threadfence();
    finish_run<C, kVec>(a, a.run_piece_start[run], count, row, lane, buf);
    if (lane == 0) a.ticket[run] = 0;  // ready for the next call
  }
}

// Zeros to every untouched row, block b's slice of kThreads *
// kSweepPerThread stores (16 bytes each when kVec).
template <bool kVec, int kThreads>
__device__ void zero_rows(const Args& a, int b) {
  const int per_row = kVec ? a.m2 / 4 : a.m2;
  const int total = a.num_rows * per_row;
  const int base = b * kThreads * kSweepPerThread + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kSweepPerThread; ++i) {
    const int k = base + i * kThreads;
    if (k < total && __ldg(a.inv_sorted + k / per_row) == a.num_unique) {
      if (kVec)
        reinterpret_cast<float4*>(a.out)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        a.out[k] = 0.0f;
    }
  }
}

template <int C, bool kVec, int kWarps>
__global__ void __launch_bounds__(kWarps * 32) scatter_runs_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  if (b >= a.task_blocks) {
    zero_rows<kVec, kWarps * 32>(a, b - a.task_blocks);
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int task = b * kWarps + warp;
  if (task >= a.num_tasks) return;  // warp-uniform
  run_task<C, kVec>(a, task, threadIdx.x & 31, smem + warp * kBatch * a.m2);
}

// A block's dz row buffers: kBatch rows of 2m floats a task warp.
size_t block_smem(int warps, int m2) {
  return sizeof(float) * warps * kBatch * m2;
}

template <int C, bool kVec, int kWarps>
int launch(Args a, cudaStream_t stream) {
  constexpr int kThreads = kWarps * 32;
  const auto kernel = scatter_runs_kernel<C, kVec, kWarps>;
  const size_t smem = block_smem(kWarps, a.m2);
  if (smem > kMaxSmem) return kOverBudget;
  a.task_blocks = (a.num_tasks + kWarps - 1) / kWarps;
  if (smem > 48 * 1024) {  // past the default dynamic limit
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_block = kThreads * kSweepPerThread;
  const int zero_blocks =
      (a.num_rows * (kVec ? a.m2 / 4 : a.m2) + per_block - 1) / per_block;
  kernel<<<a.task_blocks + zero_blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = int (*)(Args, cudaStream_t);

template <int kWarps>
LaunchFn pick(bool vec, int chunks) {
  return vec ? (chunks == 1   ? launch<1, true, kWarps>
                : chunks == 2 ? launch<2, true, kWarps>
                : chunks == 3 ? launch<3, true, kWarps>
                              : launch<4, true, kWarps>)
             : (chunks == 1   ? launch<1, false, kWarps>
                : chunks == 2 ? launch<2, false, kWarps>
                : chunks == 3 ? launch<3, false, kWarps>
                              : launch<4, false, kWarps>);
}

}  // namespace

extern "C" {

// out (num_rows, m2) <- dense dTheta; partial (num_pieces, m2) is
// scratch, ticket (num_unique,) must be all 0 and is all 0 again after
// the kernel; warps: task warps a block (4, 8 or 16). Returns
// cudaGetLastError() after the launch (0 = launched), or kOverBudget.
int lsplm_sparse_scatter(const void* task_piece_start, const void* piece_start,
                         const void* piece_run, const void* run_piece_start,
                         const void* row_ids, const void* order,
                         const void* sample_sorted, const void* inv_sorted,
                         const void* vals, const void* dz, void* partial,
                         void* ticket, void* out, int num_tasks,
                         int num_rows, int num_unique, int m2, int warps,
                         void* stream) {
  const int chunks = (m2 + 31) / 32;
  if (num_tasks < 0 || num_rows < 1 || num_unique < 0 || m2 < 1 ||
      chunks > kMaxChunks || (warps != 4 && warps != 8 && warps != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies and stores: whole float4s per row, dz's rows aligned
  // (partial and out are the wrapper's own allocations)
  const bool vec = m2 % 4 == 0 && reinterpret_cast<uintptr_t>(dz) % 16 == 0;
  const Args a{static_cast<const int32_t*>(task_piece_start),
               static_cast<const int32_t*>(piece_start),
               static_cast<const int32_t*>(piece_run),
               static_cast<const int32_t*>(run_piece_start),
               static_cast<const int32_t*>(row_ids),
               static_cast<const int32_t*>(order),
               static_cast<const int32_t*>(sample_sorted),
               static_cast<const int32_t*>(inv_sorted),
               static_cast<const float*>(vals),
               static_cast<const float*>(dz),
               static_cast<float*>(partial),
               static_cast<int32_t*>(ticket),
               static_cast<float*>(out),
               num_tasks,
               0,  // task_blocks: set by launch() for its block size
               num_rows,
               num_unique,
               m2};
  const auto fn = warps == 4 ? pick<4>(vec, chunks)
                  : warps == 8 ? pick<8>(vec, chunks)
                               : pick<16>(vec, chunks);
  return fn(a, static_cast<cudaStream_t>(stream));
}

// The most task warps a block (16, 8 or 4) whose buffers fit at 2m
// columns, or 0.
int lsplm_sparse_scatter_max_warps(int m2) {
  for (int warps = 16; warps >= 4; warps >>= 1)
    if (block_smem(warps, m2) <= kMaxSmem) return warps;
  return 0;
}

const char* lsplm_scatter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
