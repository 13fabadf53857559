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
// What bounds it on this card: device-memory bytes at large N, latency at
// the serving shapes. Each live row moves one Theta row (2m fp32 = 96 B at
// m = 12, or 2m int8 + one fp32 scale = 24 B + 4 B) and does one FMA per
// loaded float, far below the H100's operations-per-byte balance. At a
// dispatch of 1-1,024 rows the card is nearly empty and a row's time is its
// chain of dependent memory round trips, so the design cuts that chain.
//
// Design: ONE WARP PER SAMPLE ROW; lane j owns column j (columns j + 32c
// when 2m > 32).
//   1. The row's (id, val) slots are read in one coalesced pass.
//   2. dedup = 1 (the reference's per-sample dedup, "hot features are
//      fetched once per sample"): the warp sorts its row stably by (id,
//      slot) -- a rank count, in registers by shuffles for K <= 32, in
//      shared memory up to K = 1,024 -- and sums each run of equal ids by
//      the SAME Hillis-Steele segmented scan as ops.dedup_tile_ids: steps s
//      = 1, 2, 4, ..., the element r places into its run (slot order) adds
//      the element r - s places in, as acc[r-s] + acc[r], when r >= s. That
//      association depends only on the run's length and values.
//   3. The live rows (distinct ids, ascending, when deduplicated; the
//      live slots in slot order otherwise) are taken 32 at a time and
//      copied into a per-warp shared-memory buffer with cp.async (16, 8 or
//      4 bytes a copy, the widest the row width and the rows' base address
//      allow), so every row load of the group is in flight before one
//      wait, and a row pays one memory round trip per group and not one
//      per slot. Lane t copies entry t's row, or (fp32 rows only)
//      neighbouring lanes copy one row's pieces (whole rows per
//      instruction, half the L2 requests), as the caller's `by_piece`
//      says: the tune table's entry, or the rule (by piece at N >= 2,048).
//      Lane j then walks the group in order,
//      one __fmaf_rn(v, row[j], acc) per live row, from acc = 0.
//   4. Optional addend (the bundle head): z = z_add[session[n]] + acc with
//      one __fadd_rn, the bits of `z_user.index_select(0, session) + z_ad`.
//      A session outside [0, G) adds a zero row, like the pad.
//   5. Head (skipped when p is null): softmax max and sum by warp shuffles
//      (expf, not __expf), the gate and fit columns paired through a
//      per-warp shared buffer, the gate*fit sum by a warp shuffle.
//
// Bitwise contract. With dedup = 1, (z, p) equal bit for bit those of
// dedup = 0 run on ops.dedup_tile_ids' output: its rows hold the distinct
// ids ascending with the scan's sums, then pad slots, and dedup = 0 adds
// live slots in slot order. With dedup = 0 the FMA sequence is the slot
// order, so z keeps the bits of the first (one slot at a time) design. A
// row's bits never depend on N, the grid, the block or its neighbours:
// single-vs-batched scoring, coalesced-vs-per-envelope dispatch and
// pruned-vs-full Theta stay bitwise equal on the card. Do not split K
// across warps. The int8 variant forms row = code * scale with one rounded
// multiply (__fmul_rn) and then the same FMA, so it matches the fp32 kernel
// run on the dequantised Theta. Build without --use_fast_math.
//
// Ids outside [0, D) are treated like the pad id D-1: the kernel never reads
// outside Theta (callers pass ids in range; the plain version raises).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarpsPerBlock = 8;
constexpr int kMaxChunks = 4;        // 2m <= 128 columns
constexpr int kMaxDedupK = 1024;     // slots a row may carry with dedup = 1
                                     // (MAX_DEDUP_K of the Python wrapper)
constexpr int kSmemBudget = 48 * 1024;
constexpr int kOverBudget = -1;      // launch(): an explicit `warps` the
                                     // budget cannot hold (OVER_BUDGET of
                                     // the Python wrapper)
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kLast = 1 << 30;       // "last slot of its run" in a rank word

enum Dedup { kNoDedup = 0, kDedupRegs = 1, kDedupShared = 2 };

struct Args {
  const int32_t* ids;
  const float* vals;
  const float* theta;     // fp32 rows (fp32 variant)
  const int8_t* codes;    // int8 rows (int8 variant)
  const float* scales;
  const float* z_add;     // (G, 2m) addend rows, or null
  const void* session;    // (N,) int32 or int64 row of z_add per sample
  int session_wide;       // 1: session is int64
  int G;
  float* p;               // (N,), or null: skip the head
  float* z;               // (N, 2m)
  int N, K, D, m;
  // shared-memory layout, set by launch()
  int row_bytes;          // one Theta row: 2m * 4 (fp32) or 2m (int8)
  int row_stride;         // its slot in the per-warp row buffer, 16-aligned
  int copy_bytes;         // copy width: 16, 8 or 4 (cp.async); 2 (plain)
  int warp_bytes;         // one warp's region: rows, head buffer, dedup work
};

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

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// a row id that loads: not the pad D-1, not outside [0, D)
__device__ __forceinline__ bool live(int id, int D) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(D - 1);
}

// One copy of `width` bytes (16, 8 or 4 with cp.async; 2 with a plain load
// and store, for int8 rows only 2-byte aligned).
__device__ __forceinline__ void copy_piece(char* dst, const char* src,
                                          int width) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (width == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else if (width == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else if (width == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  else
    *reinterpret_cast<short*>(dst) = __ldg(reinterpret_cast<const short*>(src));
}

// Adds up to 32 rows into acc. Lane t holds entry t (its id and value);
// bit t of the warp-uniform `mask` says whether entry t is added. Entries
// are added in lane order. The group's rows are copied into the warp's row
// buffer with cp.async, all in flight before one wait: lane t copies entry
// t's row (the shortest path to the wait), or, with kByPiece,
// neighbouring lanes copy one row's pieces (one copy instruction reads
// whole rows: full sectors, half the L2 requests of 16-byte pieces from 32
// rows). The int8 variant's scales are loaded by the entry's own lane.
// Then lane j walks the group reading column j.
template <int C, bool kInt8, bool kByPiece>
__device__ __forceinline__ void add_rows(const Args& a, char* rows, int lane,
                                         int my_id, float my_v, unsigned mask,
                                         float (&acc)[C]) {
  if (mask == 0u) return;  // warp-uniform
  const int m2 = 2 * a.m;
  const char* base = kInt8 ? reinterpret_cast<const char*>(a.codes)
                           : reinterpret_cast<const char*>(a.theta);
  const int w = a.copy_bytes;
  if constexpr (kByPiece) {
    // piece e = lane + 32 i of the group is piece q of row r
    const int pieces = a.row_bytes / w;
    int r = lane / pieces, q = lane - r * pieces;
    const int dr = 32 / pieces, dq = 32 - dr * pieces;
    for (int e = lane; e < 32 * pieces; e += 32) {
      const int id = __shfl_sync(kFullMask, my_id, r);
      if ((mask >> r) & 1u)
        copy_piece(rows + r * a.row_stride + q * w,
                   base + static_cast<size_t>(id) * a.row_bytes + q * w, w);
      r += dr;
      q += dq;
      if (q >= pieces) {
        q -= pieces;
        ++r;
      }
    }
  } else if ((mask >> lane) & 1u) {  // lane t copies entry t's row
    const char* src = base + static_cast<size_t>(my_id) * a.row_bytes;
    char* dst = rows + lane * a.row_stride;
    for (int o = 0; o < a.row_bytes; o += w) copy_piece(dst + o, src + o, w);
  }
  float my_s = 0.0f;
  if constexpr (kInt8) {
    if ((mask >> lane) & 1u) my_s = __ldg(a.scales + my_id);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const float v = __shfl_sync(kFullMask, my_v, t);
    float s = 0.0f;
    if constexpr (kInt8) s = __shfl_sync(kFullMask, my_s, t);
    if ((mask >> t) & 1u) {
      const char* row = rows + t * a.row_stride;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = c * 32 + lane;
        if (j < m2) {
          float x;
          if constexpr (kInt8) {
            x = __fmul_rn(
                static_cast<float>(reinterpret_cast<const int8_t*>(row)[j]),
                s);
          } else {
            x = reinterpret_cast<const float*>(row)[j];
          }
          acc[c] = __fmaf_rn(v, x, acc[c]);
        }
      }
    }
  }
  __syncwarp();  // the buffer is refilled by the next group
}

template <int C, bool kInt8, int kMode, bool kByPiece>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
fused_forward_kernel(const Args a) {
  // per warp: the row buffer (32 rows), the head's 2m floats, dedup work
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= a.N) return;  // n is warp-uniform: whole warps leave together
  const int m2 = 2 * a.m;
  const int K = a.K;
  const int D = a.D;
  char* rows = smem + static_cast<size_t>(warp) * a.warp_bytes;
  float* zs = reinterpret_cast<float*>(rows + 32 * a.row_stride);
  int* work = reinterpret_cast<int*>(zs + m2);

  // The session id is loaded first; its addend row right after the row's
  // first slots, so that it lands while the row is sorted and gathered (a
  // load is issued in order and waits on its address).
  long long session = -1;
  if (a.z_add != nullptr)
    session = a.session_wide ? static_cast<const int64_t*>(a.session)[n]
                             : static_cast<const int32_t*>(a.session)[n];
  float add[C];
  auto load_addend = [&]() {
    const bool in = session >= 0 && session < a.G;
    const float* row = a.z_add + static_cast<size_t>(in ? session : 0) * m2;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      add[c] = (in && j < m2) ? __ldg(row + j) : 0.0f;
    }
  };

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  const int32_t* row_ids = a.ids + static_cast<size_t>(n) * K;
  const float* row_vals = a.vals + static_cast<size_t>(n) * K;

  if constexpr (kMode == kNoDedup) {
    // live slots in slot order, 32 slots at a time (once for K = 0, so
    // that the addend is loaded)
    for (int k0 = 0; k0 == 0 || k0 < K; k0 += 32) {
      int id = D - 1;
      float v = 0.0f;
      if (k0 + lane < K) {
        id = row_ids[k0 + lane];
        v = row_vals[k0 + lane];
      }
      if (k0 == 0 && a.z_add != nullptr) load_addend();
      add_rows<C, kInt8, kByPiece>(a, rows, lane, id, v,
                                   __ballot_sync(kFullMask, live(id, D)), acc);
    }
  } else if constexpr (kMode == kDedupRegs) {
    // K <= 32: lane i holds slot i; rank by (id, slot) with shuffles
    const bool active = lane < K;
    int id = 0;
    float v = 0.0f;
    if (active) {
      id = row_ids[lane];
      v = row_vals[lane];
    }
    if (a.z_add != nullptr) load_addend();
    int less = 0, before = 0, total = 0;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int x = __shfl_sync(kFullMask, id, t);
      if (t < K) {
        less += x < id;
        total += x == id;
        before += (x == id) & (t < lane);
      }
    }
    int* w_id = work;
    float* w_v = reinterpret_cast<float*>(work + 32);
    int* w_r = work + 64;
    if (active) {
      const int pos = less + before;
      w_id[pos] = id;
      w_v[pos] = v;
      w_r[pos] = before | (before == total - 1 ? kLast : 0);
    }
    __syncwarp();
    int r = 0;
    if (active) {  // lane p now holds sorted position p
      id = w_id[lane];
      v = w_v[lane];
      r = w_r[lane];
    }
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float up = __shfl_up_sync(kFullMask, v, s);
      if ((r & ~kLast) >= s) v = __fadd_rn(up, v);
    }
    add_rows<C, kInt8, kByPiece>(
        a, rows, lane, id, v,
        __ballot_sync(kFullMask, active && (r & kLast) && live(id, D)), acc);
  } else {
    // 32 < K <= 1,024: the same sort and scan in shared memory
    int* s_id = work;
    float* s_v = reinterpret_cast<float*>(work + K);
    int* t_id = work + 2 * K;
    float* t_v = reinterpret_cast<float*>(work + 3 * K);
    int* t_r = work + 4 * K;
    for (int i = lane; i < K; i += 32) {
      s_id[i] = row_ids[i];
      s_v[i] = row_vals[i];
    }
    if (a.z_add != nullptr) load_addend();
    __syncwarp();
    int longest = 0;
    for (int i = lane; i < K; i += 32) {
      const int id = s_id[i];
      int less = 0, before = 0, total = 0;
      for (int j = 0; j < K; ++j) {
        const int x = s_id[j];
        less += x < id;
        total += x == id;
        before += (x == id) & (j < i);
      }
      const int pos = less + before;
      t_id[pos] = id;
      t_v[pos] = s_v[i];
      t_r[pos] = before | (before == total - 1 ? kLast : 0);
      longest = max(longest, total);
    }
    longest = warp_max_int(longest);
    __syncwarp();
    // steps s >= the longest run change nothing, so they are not taken
    float* cur = t_v;
    float* nxt = s_v;
    for (int s = 1; s < longest; s <<= 1) {
      for (int i = lane; i < K; i += 32) {
        float x = cur[i];
        if ((t_r[i] & ~kLast) >= s) x = __fadd_rn(cur[i - s], x);
        nxt[i] = x;
      }
      __syncwarp();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    // the live run ends, ascending, packed into (s_id, nxt)
    int count = 0;
    const unsigned below = (1u << lane) - 1u;
    for (int p0 = 0; p0 < K; p0 += 32) {
      const int pos = p0 + lane;
      const bool take = pos < K && (t_r[pos] & kLast) && live(t_id[pos], D);
      const unsigned bal = __ballot_sync(kFullMask, take);
      if (take) {
        const int q = count + __popc(bal & below);
        s_id[q] = t_id[pos];
        nxt[q] = cur[pos];
      }
      count += __popc(bal);
    }
    __syncwarp();
    for (int b = 0; b < count; b += 32) {
      const int cnt = min(32, count - b);
      int id = 0;
      float v = 0.0f;
      if (lane < cnt) {
        id = s_id[b + lane];
        v = nxt[b + lane];
      }
      add_rows<C, kInt8, kByPiece>(a, rows, lane, id, v,
                                   cnt == 32 ? kFullMask : (1u << cnt) - 1u,
                                   acc);
    }
  }

  if (a.z_add != nullptr) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(add[c], acc[c]);
  }

  // z out, and the warp's copy for pairing gate column j with fit column j+m
  float* z_row = a.z + static_cast<size_t>(n) * m2;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    if (j < m2) {
      z_row[j] = acc[c];
      zs[j] = acc[c];
    }
  }
  if (a.p == nullptr) return;  // warp-uniform
  __syncwarp();

  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c * 32 + lane < a.m) mx = fmaxf(mx, acc[c]);
  }
  mx = warp_max(mx);
  float e[C];
  float denom = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    e[c] = 0.0f;
    if (c * 32 + lane < a.m) {
      e[c] = expf(acc[c] - mx);
      denom += e[c];
    }
  }
  denom = warp_sum(denom);
  float part = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * 32 + lane;
    if (j < a.m) {
      const float gate = e[c] / denom;
      const float fit = 1.0f / (1.0f + expf(-zs[j + a.m]));
      part += gate * fit;
    }
  }
  part = warp_sum(part);
  if (lane == 0) a.p[n] = part;
}

template <int C, bool kInt8, bool kByPiece>
void launch_mode(int mode, dim3 grid, dim3 block, size_t smem,
                 cudaStream_t stream, const Args& a) {
  if (mode == kNoDedup)
    fused_forward_kernel<C, kInt8, kNoDedup, kByPiece>
        <<<grid, block, smem, stream>>>(a);
  else if (mode == kDedupRegs)
    fused_forward_kernel<C, kInt8, kDedupRegs, kByPiece>
        <<<grid, block, smem, stream>>>(a);
  else
    fused_forward_kernel<C, kInt8, kDedupShared, kByPiece>
        <<<grid, block, smem, stream>>>(a);
}

// the copy scheme is a template argument: one kernel holding both ran the
// lane-per-row path slower than a kernel with that path alone
template <int C, bool kInt8>
void launch_copy(bool by_piece, int mode, dim3 grid, dim3 block, size_t smem,
                 cudaStream_t stream, const Args& a) {
  if constexpr (kInt8) {
    launch_mode<C, true, false>(mode, grid, block, smem, stream, a);
  } else if (by_piece) {
    launch_mode<C, false, true>(mode, grid, block, smem, stream, a);
  } else {
    launch_mode<C, false, false>(mode, grid, block, smem, stream, a);
  }
}

// One warp's region of shared memory: its buffer of 32 rows (each slot
// 16-aligned), the head's 2m floats and the dedup's work area. launch()
// lays it out; lsplm_sparse_fused_max_warps reports what the budget holds.
int warp_region_bytes(int K, int m2, bool int8, int dedup) {
  const int row_stride = ((int8 ? m2 : m2 * 4) + 15) / 16 * 16;
  const int work = !dedup ? 0 : K <= 32 ? 96 : 5 * K;
  return (32 * row_stride + (m2 + work) * 4 + 15) / 16 * 16;
}

// The most rows a block (1, 2, 4 or 8) whose regions fit the budget.
int max_warps(int warp_bytes) {
  int warps = kMaxWarpsPerBlock;
  while (warps > 1 && static_cast<size_t>(warps) * warp_bytes > kSmemBudget)
    warps >>= 1;
  return warps;
}

// The rule every launch took before the tune table. Small N spreads the
// rows over the SMs, large N takes full blocks, halved while over the
// budget. Lane-per-row copies reach the wait sooner and win at the serving
// shapes and for int8 rows; fp32 rows at training sizes and above are
// bandwidth-bound and take the coalesced copies (set by a same-call probe).
int rule_warps(int N, int warp_bytes) {
  const int want = N <= 132 ? 1 : N <= 264 ? 2 : N <= 528 ? 4
                                                          : kMaxWarpsPerBlock;
  const int fit = max_warps(warp_bytes);
  return want < fit ? want : fit;
}

bool rule_by_piece(int N, bool int8) { return !int8 && N >= 2048; }

// `warps` (rows a block, one warp a row: 1, 2, 4 or 8) and `by_piece` are
// the tune table's entry, or 0 and -1 for the rule. Neither changes a
// row's bits (see the header). An explicit block over the shared-memory
// budget is refused (kOverBudget), never shrunk.
template <bool kInt8>
int launch(Args a, int dedup, int warps, int by_piece, cudaStream_t stream) {
  const int m2 = 2 * a.m;
  const int chunks = (m2 + 31) / 32;
  if (a.N <= 0 || a.K < 0 || a.D < 1 || a.m < 1 || chunks > kMaxChunks ||
      (dedup && a.K > kMaxDedupK) ||
      (a.z_add != nullptr && (a.session == nullptr || a.G < 1)) ||
      (warps != 0 && warps != 1 && warps != 2 && warps != 4 &&
       warps != kMaxWarpsPerBlock) ||
      (kInt8 && by_piece > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mode = !dedup ? kNoDedup : a.K <= 32 ? kDedupRegs : kDedupShared;
  // cp.async width: the widest of 16, 8, 4 bytes that divides the row and
  // the rows' base address (every row start is then aligned to it)
  a.row_bytes = kInt8 ? m2 : m2 * 4;
  a.row_stride = (a.row_bytes + 15) / 16 * 16;
  const uintptr_t base = reinterpret_cast<uintptr_t>(
      kInt8 ? static_cast<const void*>(a.codes)
            : static_cast<const void*>(a.theta));
  a.copy_bytes = 16;
  while (a.copy_bytes > 2 &&
         (a.row_bytes % a.copy_bytes || base % a.copy_bytes))
    a.copy_bytes >>= 1;
  if (base % a.copy_bytes) return static_cast<int>(cudaErrorMisalignedAddress);
  a.warp_bytes = warp_region_bytes(a.K, m2, kInt8, dedup);
  if (warps == 0) {
    warps = rule_warps(a.N, a.warp_bytes);
  } else if (static_cast<size_t>(warps) * a.warp_bytes > kSmemBudget) {
    return kOverBudget;
  }
  if (by_piece < 0) by_piece = rule_by_piece(a.N, kInt8);
  const dim3 block(warps * 32);
  const dim3 grid((a.N + warps - 1) / warps);
  const size_t smem = static_cast<size_t>(warps) * a.warp_bytes;
  switch (chunks) {
    case 1:
      launch_copy<1, kInt8>(by_piece != 0, mode, grid, block, smem, stream,
                             a);
      break;
    case 2:
      launch_copy<2, kInt8>(by_piece != 0, mode, grid, block, smem, stream,
                             a);
      break;
    case 3:
      launch_copy<3, kInt8>(by_piece != 0, mode, grid, block, smem, stream,
                             a);
      break;
    default:
      launch_copy<4, kInt8>(by_piece != 0, mode, grid, block, smem, stream,
                             a);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* ids, const void* vals, const void* z_add,
               const void* session, int session_wide, int G, void* p, void* z,
               int N, int K, int D, int m) {
  Args a{};
  a.ids = static_cast<const int32_t*>(ids);
  a.vals = static_cast<const float*>(vals);
  a.z_add = static_cast<const float*>(z_add);
  a.session = session;
  a.session_wide = session_wide;
  a.G = G;
  a.p = static_cast<float*>(p);
  a.z = static_cast<float*>(z);
  a.N = N;
  a.K = K;
  a.D = D;
  a.m = m;
  return a;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched), or
// kOverBudget. z_add (G, 2m) and session (N,) are optional (null: no
// addend); p may be null (no head). warps: rows a block (1, 2, 4, 8; 0:
// the rule); by_piece: 1 copies fp32 rows by piece, 0 lane per row, -1
// the rule.
int lsplm_sparse_fused_forward(const void* ids, const void* vals,
                               const void* theta, const void* z_add,
                               const void* session, int session_wide, int G,
                               void* p, void* z, int N, int K, int D, int m,
                               int dedup, int warps, int by_piece,
                               void* stream) {
  Args a = make_args(ids, vals, z_add, session, session_wide, G, p, z, N, K,
                     D, m);
  a.theta = static_cast<const float*>(theta);
  return launch<false>(a, dedup, warps, by_piece,
                       static_cast<cudaStream_t>(stream));
}

int lsplm_sparse_fused_int8_forward(const void* ids, const void* vals,
                                    const void* codes, const void* scales,
                                    const void* z_add, const void* session,
                                    int session_wide, int G, void* p, void* z,
                                    int N, int K, int D, int m, int dedup,
                                    int warps, int by_piece, void* stream) {
  Args a = make_args(ids, vals, z_add, session, session_wide, G, p, z, N, K,
                     D, m);
  a.codes = static_cast<const int8_t*>(codes);
  a.scales = static_cast<const float*>(scales);
  return launch<true>(a, dedup, warps, by_piece,
                      static_cast<cudaStream_t>(stream));
}

// The most rows a block the shared-memory budget holds at K slots and m
// regions (the explicit `warps` a launch takes).
int lsplm_sparse_fused_max_warps(int K, int m, int int8, int dedup) {
  return max_warps(warp_region_bytes(K, 2 * m, int8 != 0, dedup));
}

// The rule's launch config at N rows: rows a block and by_piece (0, 1).
void lsplm_sparse_fused_rule(int N, int K, int m, int int8, int dedup,
                             int* warps, int* by_piece) {
  *warps = rule_warps(N, warp_region_bytes(K, 2 * m, int8 != 0, dedup));
  *by_piece = rule_by_piece(N, int8 != 0);
}

const char* lsplm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
