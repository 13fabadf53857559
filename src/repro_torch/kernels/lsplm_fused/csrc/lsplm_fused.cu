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
// multiply-adds (48 FLOP at m = 12). In fp32 that is 12 FLOP per byte,
// below the H100's fp32 CUDA-core balance (67e12 / 3.35e12 = 20 FLOP/B):
// the byte bound rules, with the FMA rate not far behind. In bf16 the
// products run on the tensor cores and the bytes rule by far. Theta is
// small ((d, 2m), 3 MB at d = 32,768 in fp32) and comes from L2.
//
// Design: d split into chunks, then a second pass.
//  * The columns of d are cut into chunks of `chunk` columns (the wrapper
//    passes 2,048: 16 chunks at d = 32,768), a number that depends on d
//    alone. The grid is (row tiles, chunks, column tiles of Theta), so
//    512 rows make 256 CTAs, not 16. Each CTA writes its rows' fp32
//    partial sums of its chunk to scratch (chunks, B, 2m) that the
//    wrapper allocates (5 MB at B = 3,276, m = 12: it stays in L2). Row
//    tiles are 32 rows.
//  * Tiles of x and Theta stream through a ring of 3 shared-memory stages
//    by cp.async (16 bytes, zero-filled past d, B and Theta's width), 2
//    tiles in flight while one is used; x's rows go element by element
//    when they are not 16-byte aligned.
//  * fp32 (`partial_f32`, the CUDA cores: fp32's 1e-5 bar rules out
//    TF32): 8 warps, tiles of 64 columns. Warp w owns columns
//    [8 w, 8 w + 8) of every tile; lane (rg, cg) owns rows rg + 8 j x NC
//    columns cg NC + c, so each 16-byte x load feeds 4 NC FMAs and each
//    8-byte Theta load 2 per row. W = 4 NC columns: 24 at m = 12.
//  * bf16 (`partial_bf16`, the tensor cores): 4 warps, tiles of 128
//    columns. Warp w owns columns [32 w, 32 w + 32) of every tile: two
//    k16 steps of mma.sync.m16n8k16 (bf16 in, fp32 accumulate) over the
//    row tiles of 16 x NT column tiles of 8 (2m = 24 is three), A from
//    ldmatrix, B from ldmatrix.trans of Theta's row-major tile.
//  * In both, the warps' partial sums are added in warp order through
//    shared memory before the write.
//  * `head` (a second launch, one warp per row) adds a row's chunks in
//    chunk order, then runs the head: max-shifted softmax over the m
//    gate columns, sigmoid of the m fit columns, their dot product, in
//    fp32 with expf and IEEE division (no --use_fast_math); the warp's
//    sums are a fixed butterfly.
//  * No atomics. Every row's sum runs in an order fixed by d and m alone
//    -- never by B, the grid or the row's place in its tile -- so two
//    identical calls are bitwise equal and a row scores the same bits
//    alone or inside any batch. Columns past d and rows past B are staged
//    as zeros (they add exact zeros); rows past B are not written. No
//    padded copies of x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Shape {
  int B, d, m2;
  int ldt;        // Theta's row stride (elements)
  long long ldx;  // x's row stride (elements)
  int chunk;      // columns per chunk, a multiple of 128
};

// a CTA's partial sums red[warp][row][col] (row stride W + 1), added in
// warp order and written to scratch[chunk][row][col] for the valid rows
// and columns
template <int kWarps, int R, int W>
__device__ __forceinline__ void write_partials(const float* red, int tid,
                                               int nthreads, int row0,
                                               int col0, int chunk,
                                               float* scratch,
                                               const Shape& s) {
  for (int e = tid; e < R * W; e += nthreads) {
    const int r = e / W;
    const int c = e - r * W;
    float v = red[r * (W + 1) + c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      v = __fadd_rn(v, red[(w * R + r) * (W + 1) + c]);
    const int row = row0 + r;
    const int col = col0 + c;
    if (row < s.B && col < s.m2)
      scratch[(static_cast<long long>(chunk) * s.B + row) * s.m2 + col] = v;
  }
}

// ---------------------------------------------------------------------------
// The staging pipeline both bodies share: tiles of x and Theta go into a
// ring of kStages shared-memory stages by cp.async (16 bytes, zero-filled
// past d, B and ldt), kStages - 1 tiles in flight while one is used.

constexpr int kStages = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows of x and Theta of one tile into shared memory: Theta's W columns
// from col0 of rows [k0, k0 + TILE) by cp.async; x's R rows from row0 of
// the same columns by cp.async when its rows are 16-byte aligned, else
// element by element (plain loads and stores).
template <typename T, int R, int TILE, int XLD, int W, int TLD, int NTHREADS,
          bool kVecX>
__device__ __forceinline__ void stage_tile(T* xs, T* ts, const T* x,
                                           const T* theta, int row0,
                                           int col0, int k0, int k_end,
                                           const Shape& s, int tid) {
  constexpr int kV = 16 / sizeof(T);  // elements per 16 bytes
  for (int q = tid; q < TILE * W / kV; q += NTHREADS) {
    const int r = q / (W / kV);
    const int c = (q - r * (W / kV)) * kV;
    const bool ok = k0 + r < k_end && col0 + c < s.ldt;
    cp_async16(ts + r * TLD + c,
               ok ? theta + static_cast<long long>(k0 + r) * s.ldt + col0 + c
                  : theta,
               ok);
  }
  if constexpr (kVecX) {
    for (int q = tid; q < R * TILE / kV; q += NTHREADS) {
      const int r = q / (TILE / kV);
      const int k = (q - r * (TILE / kV)) * kV;
      const bool ok = row0 + r < s.B && k0 + k < k_end;
      cp_async16(xs + r * XLD + k,
                 ok ? x + static_cast<long long>(row0 + r) * s.ldx + k0 + k
                    : x,
                 ok);
    }
  } else {
    for (int e = tid; e < R * TILE; e += NTHREADS) {
      const int r = e / TILE;
      const int k = e - r * TILE;
      xs[r * XLD + k] =
          row0 + r < s.B && k0 + k < k_end
              ? x[static_cast<long long>(row0 + r) * s.ldx + k0 + k]
              : from_f32<T>(0.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 partial sums on the CUDA cores.

constexpr int kF32Warps = 8;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32Tile = 64;            // columns per staged tile
constexpr int kF32Xld = kF32Tile + 4;   // x tile row stride (floats)
constexpr int kRT = 4;  // row groups of 8 per CTA: 32 rows

template <int NC>
struct F32Smem {
  static constexpr int R = 8 * kRT;  // rows per CTA
  static constexpr int W = 4 * NC;  // Theta columns per CTA
  static constexpr int kStage = R * kF32Xld + kF32Tile * W;  // floats
  static constexpr int kRed = kF32Warps * R * (W + 1);
  static constexpr int kBytes =
      4 * (kStages * kStage > kRed ? kStages * kStage : kRed);
};

// grid (row tiles of 8 kRT, chunks, column tiles of 4 NC); lane (rg, cg)
// of warp w owns rows rg + 8 j (j < kRT), columns cg NC + c (c < NC), and
// columns [8 w, 8 w + 8) of every tile
template <int NC, bool kVecX>
__global__ void __launch_bounds__(kF32Threads)
partial_f32(const float* __restrict__ x, const float* __restrict__ theta,
            float* __restrict__ scratch, Shape s) {
  using L = F32Smem<NC>;
  constexpr int R = L::R;
  constexpr int W = L::W;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane & 7;
  const int cg = lane >> 3;
  const int row0 = blockIdx.x * R;
  const int chunk = blockIdx.y;
  const int col0 = blockIdx.z * W;
  const int k_begin = chunk * s.chunk;
  const int k_end = min(s.d, k_begin + s.chunk);
  const int n_tiles = (k_end - k_begin + kF32Tile - 1) / kF32Tile;

  auto issue = [&](int t) {  // tile t into stage t % kStages
    if (t < n_tiles) {
      float* xs = smem + (t % kStages) * L::kStage;
      stage_tile<float, R, kF32Tile, kF32Xld, W, W, kF32Threads, kVecX>(
          xs, xs + R * kF32Xld, x, theta, row0, col0,
          k_begin + t * kF32Tile, k_end, s, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[kRT][NC];
#pragma unroll
  for (int j = 0; j < kRT; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[j][c] = 0.0f;

  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();  // for every thread, and tile t - 1 is used up
    issue(t + kStages - 1);
    const float* xs = smem + (t % kStages) * L::kStage;
    const float* xrow = xs + rg * kF32Xld + 8 * warp;
    const float* trow = xs + R * kF32Xld + 8 * warp * W + cg * NC;
#pragma unroll
    for (int kk = 0; kk < 8; kk += 4) {
      float4 xq[kRT];
#pragma unroll
      for (int j = 0; j < kRT; ++j)
        xq[j] = *reinterpret_cast<const float4*>(xrow + 8 * j * kF32Xld + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float th[NC];
#pragma unroll
        for (int c = 0; c < NC; c += 2) {
          const float2 t2 =
              *reinterpret_cast<const float2*>(trow + (kk + e) * W + c);
          th[c] = t2.x;
          th[c + 1] = t2.y;
        }
#pragma unroll
        for (int j = 0; j < kRT; ++j) {
          const float xk = e == 0 ? xq[j].x : e == 1 ? xq[j].y
                         : e == 2 ? xq[j].z : xq[j].w;
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[j][c] = __fmaf_rn(xk, th[c], acc[j][c]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* red = smem;  // [kF32Warps][R][W + 1]
#pragma unroll
  for (int j = 0; j < kRT; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      red[(warp * R + rg + 8 * j) * (W + 1) + cg * NC + c] = acc[j][c];
  __syncthreads();
  write_partials<kF32Warps, R, W>(red, tid, kF32Threads, row0, col0, chunk,
                                  scratch, s);
}

// ---------------------------------------------------------------------------
// bf16 partial sums on the tensor cores (mma.sync m16n8k16).

constexpr int kB16Warps = 4;
constexpr int kB16Threads = 32 * kB16Warps;
constexpr int kB16Tile = 128;           // columns per staged tile
constexpr int kB16Xld = kB16Tile + 8;   // 272-byte rows: 17 16-byte units
constexpr int kMT = 2;  // MMA row tiles of 16 per CTA: 32 rows

template <int NT>
struct B16Smem {
  static constexpr int R = 16 * kMT;  // rows per CTA
  static constexpr int W = 8 * NT;   // Theta columns per CTA
  static constexpr int kTld = ((W / 8) | 1) * 8;  // odd 16-byte units
  static constexpr int kStage = R * kB16Xld + kB16Tile * kTld;  // bf16
  static constexpr int kRed = kB16Warps * R * (W + 1);  // floats
  static constexpr int kBytes = 2 * kStages * kStage > 4 * kRed
                                    ? 2 * kStages * kStage
                                    : 4 * kRed;
};

// grid (row tiles of 16 kMT, chunks, column tiles of 8 NT); warp w owns
// columns [32 w, 32 w + 32) of every tile: two k16 steps over kMT row
// tiles of 16 and NT column tiles of 8
template <int NT, bool kVecX>
__global__ void __launch_bounds__(kB16Threads)
partial_bf16(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ theta,
             float* __restrict__ scratch, Shape s) {
  using L = B16Smem<NT>;
  constexpr int R = L::R;
  constexpr int W = L::W;
  constexpr int kTld = L::kTld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * R;
  const int chunk = blockIdx.y;
  const int col0 = blockIdx.z * W;
  const int k_begin = chunk * s.chunk;
  const int k_end = min(s.d, k_begin + s.chunk);
  const int n_tiles = (k_end - k_begin + kB16Tile - 1) / kB16Tile;

  auto issue = [&](int t) {  // tile t into stage t % kStages
    if (t < n_tiles) {
      __nv_bfloat16* xs = smem + (t % kStages) * L::kStage;
      stage_tile<__nv_bfloat16, R, kB16Tile, kB16Xld, W, kTld, kB16Threads,
                 kVecX>(xs, xs + R * kB16Xld, x, theta, row0, col0,
                        k_begin + t * kB16Tile, k_end, s, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[kMT][NT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  // ldmatrix row addresses: A rows (lane % 16) at k + 8 (lane / 16); B
  // (Theta, row-major [k][n]) rows k + (lane % 16), read transposed
  const uint32_t a_off =
      ((lane & 15) * kB16Xld + 32 * warp + 8 * (lane >> 4)) * 2;
  const uint32_t b_off = (R * kB16Xld + (32 * warp + (lane & 15)) * kTld) * 2;
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();  // for every thread, and tile t - 1 is used up
    issue(t + kStages - 1);
    const uint32_t base = smem_u32(smem + (t % kStages) * L::kStage);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];"
            : "=r"(a[mt][0]), "=r"(a[mt][1]), "=r"(a[mt][2]), "=r"(a[mt][3])
            : "r"(base + a_off + (mt * 16 * kB16Xld + ks * 16) * 2));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
            : "=r"(b0), "=r"(b1)
            : "r"(base + b_off + (ks * 16 * kTld + nt * 8) * 2));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};"
              : "+f"(acc[mt][nt][0]), "+f"(acc[mt][nt][1]),
                "+f"(acc[mt][nt][2]), "+f"(acc[mt][nt][3])
              : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
                "r"(b0), "r"(b1));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // acc[mt][nt][e]: row 16 mt + lane / 4 (+ 8 for e >= 2), column
  // 8 nt + 2 (lane % 4) + (e & 1)
  float* red = reinterpret_cast<float*>(smem_raw);  // [warps][R][W + 1]
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * mt + (lane >> 2) + 8 * (e >> 1);
        const int c = 8 * nt + 2 * (lane & 3) + (e & 1);
        red[(warp * R + r) * (W + 1) + c] = acc[mt][nt][e];
      }
  __syncthreads();
  write_partials<kB16Warps, R, W>(red, tid, kB16Threads, row0, col0, chunk,
                                  scratch, s);
}

// ---------------------------------------------------------------------------
// The head: one warp per row, chunks added in chunk order.

constexpr int kHeadWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * kHeadWarps)
head(const float* __restrict__ scratch, T* __restrict__ p, int B, int m,
     int n_chunks) {
  __shared__ float zs[kHeadWarps][256];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kHeadWarps + warp;
  if (row >= B) return;
  const int m2 = 2 * m;
  float* z = zs[warp];
  for (int j = lane; j < m2; j += 32) {
    const float* src = scratch + static_cast<long long>(row) * m2 + j;
    float v = src[0];
    for (int c = 1; c < n_chunks; ++c)
      v = __fadd_rn(v, src[static_cast<long long>(c) * B * m2]);
    z[j] = v;
  }
  __syncwarp();
  float mx = -INFINITY;
  for (int j = lane; j < m; j += 32) mx = fmaxf(mx, z[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float denom = 0.0f;
  for (int j = lane; j < m; j += 32) denom += expf(z[j] - mx);
  denom = warp_sum(denom);
  float out = 0.0f;
  for (int j = lane; j < m; j += 32) {
    const float gate = expf(z[j] - mx) / denom;
    const float fit = 1.0f / (1.0f + expf(-z[m + j]));
    out += gate * fit;
  }
  out = warp_sum(out);
  if (lane == 0) p[row] = from_f32<T>(out);
}

// ---------------------------------------------------------------------------
// Launches.

template <typename T>
int launch_head(float* scratch, void* p, const Shape& s, int m,
                int n_chunks, cudaStream_t stream) {
  head<T><<<(s.B + kHeadWarps - 1) / kHeadWarps, 32 * kHeadWarps, 0,
            stream>>>(scratch, static_cast<T*>(p), s.B, m, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// the >48 KB shared-memory opt-in holds per device, so it is made on
// every launch (it is cheap) rather than remembered once per process
template <typename K>
int opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int NC, bool kVecX>
int launch_f32(const void* x, const void* theta, float* scratch,
               const Shape& s, int n_chunks, cudaStream_t stream) {
  using L = F32Smem<NC>;
  const auto kernel = partial_f32<NC, kVecX>;
  const int rc = opt_in(kernel, L::kBytes);
  if (rc != 0) return rc;
  const dim3 grid((s.B + L::R - 1) / L::R, n_chunks,
                  (s.m2 + L::W - 1) / L::W);
  kernel<<<grid, kF32Threads, L::kBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(theta),
      scratch, s);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, bool kVecX>
int launch_bf16(const void* x, const void* theta, float* scratch,
                const Shape& s, int n_chunks, cudaStream_t stream) {
  using L = B16Smem<NT>;
  const auto kernel = partial_bf16<NT, kVecX>;
  const int rc = opt_in(kernel, L::kBytes);
  if (rc != 0) return rc;
  const dim3 grid((s.B + L::R - 1) / L::R, n_chunks,
                  (s.m2 + L::W - 1) / L::W);
  kernel<<<grid, kB16Threads, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(theta), scratch, s);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int run_f32(const void* x, const void* theta, float* scratch,
            const Shape& s, bool vec_x, int n_chunks, cudaStream_t stream) {
  return vec_x ? launch_f32<NC, true>(x, theta, scratch, s, n_chunks, stream)
               : launch_f32<NC, false>(x, theta, scratch, s, n_chunks,
                                       stream);
}

template <int NT>
int run_bf16(const void* x, const void* theta, float* scratch,
             const Shape& s, bool vec_x, int n_chunks, cudaStream_t stream) {
  return vec_x ? launch_bf16<NT, true>(x, theta, scratch, s, n_chunks, stream)
               : launch_bf16<NT, false>(x, theta, scratch, s, n_chunks,
                                        stream);
}

}  // namespace

extern "C" {

// p (B,) <- Eq. 2 of x (B, d) against Theta = [U | W] (d, ldt), U and W
// (d, m) in its first 2m columns (the rest zeros). dtype 0 = float32,
// 1 = bfloat16 (x, theta and p share it). ldx and ldt in elements;
// Theta's rows and, when vec_x is set, x's rows are 16-byte aligned
// (vec_x also needs d and ldx to be multiples of 16 bytes). scratch is
// fp32 (ceil(d / chunk) or 1, B, 2m); chunk a positive multiple of 128.
// Two launches (partial sums, head). Returns cudaGetLastError() after
// them (0 = launched).
int lsplm_fused_forward(const void* x, const void* theta, void* p,
                        void* scratch, int B, int d, int m, long long ldx,
                        int ldt, int chunk, int vec_x, int dtype,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m2 = 2 * m;
  const int vec = dtype == 0 ? 4 : 8;
  if (B < 1 || d < 0 || m < 1 || m > 128 || ldx < d || ldt < m2 ||
      ldt % vec != 0 || ldt > m2 + vec - 1 || chunk < 128 ||
      chunk % 128 != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec_x && (ldx % vec != 0 || d % vec != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = d > 0 ? (d + chunk - 1) / chunk : 1;
  if (n_chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, d, m2, ldt, ldx, chunk};
  float* sc = static_cast<float*>(scratch);
  const bool vx = vec_x != 0;
  int rc;
  if (dtype == 0) {
    const int nc = m2 <= 8 ? 2 : m2 <= 16 ? 4 : m2 <= 24 ? 6 : 8;
    switch (nc) {
      case 2: rc = run_f32<2>(x, theta, sc, s, vx, n_chunks, st); break;
      case 4: rc = run_f32<4>(x, theta, sc, s, vx, n_chunks, st); break;
      case 6: rc = run_f32<6>(x, theta, sc, s, vx, n_chunks, st); break;
      default: rc = run_f32<8>(x, theta, sc, s, vx, n_chunks, st);
    }
    if (rc != 0) return rc;
    return launch_head<float>(sc, p, s, m, n_chunks, st);
  }
  const int nt = m2 <= 8 ? 1 : m2 <= 16 ? 2 : m2 <= 24 ? 3 : 4;
  switch (nt) {
    case 1: rc = run_bf16<1>(x, theta, sc, s, vx, n_chunks, st); break;
    case 2: rc = run_bf16<2>(x, theta, sc, s, vx, n_chunks, st); break;
    case 3: rc = run_bf16<3>(x, theta, sc, s, vx, n_chunks, st); break;
    default: rc = run_bf16<4>(x, theta, sc, s, vx, n_chunks, st);
  }
  if (rc != 0) return rc;
  return launch_head<__nv_bfloat16>(sc, p, s, m, n_chunks, st);
}

const char* lsplm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
