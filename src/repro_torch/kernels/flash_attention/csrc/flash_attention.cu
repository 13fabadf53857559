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
// Numerics, as the reference: scores q.k * hd^-0.5 summed in fp32;
// masked scores -1e30 (not -inf); the running max m, the running sum l
// and the output accumulator in fp32; l == 0 read as 1 before the
// divide; the output rounded to nearest even in q's dtype. IEEE expf
// and division (no --use_fast_math).
//
// What bounds it on this card. Causal attention does 2 B H S^2 hd
// operations (QK^T and PV over the lower triangle) on 4 B S (H + 2 KVH)
// hd bytes of bf16 inputs and output: at S = 4,096, hd = 64, ~640
// operations per byte, far above the H100's balance, so the bound is
// operations at the bf16 tensor-core peak (0.278 ms at B = 4, H = 32).
//
// Two bodies; which inputs take which:
//  * bf16 with hd in {16, 64, 80, 128} -- what the models run -- takes
//    the tensor-core body (`wgmma_attention_kernel`):
//     - A CTA owns 128 query rows of one (batch, head): two consumer
//       warpgroups of 64 rows each, and one producer warp. Causal CTAs
//       are issued longest first (the query-tile index is the slowest
//       grid dimension, walked from the last tile down).
//     - Copies: the q tile once, then K and V tiles of 64 keys through a
//       two-stage ring in shared memory, each loaded by TMA (one 4-D
//       tensor map per operand, built on the host from the strides, so
//       strided views are read in place) and announced by an mbarrier
//       per stage; a second mbarrier per stage hands the stage back once
//       both warpgroups' products are done. The producer warp keeps the
//       next tile in flight while the warpgroups compute.
//     - Every operand is laid out in shared memory as column blocks of
//       16 head dims (32 bytes per row, TMA's 32-byte swizzle), which
//       tiles any hd that is a multiple of 16 (80 included: 160-byte
//       rows do not fit a 64- or 128-byte swizzle atom).
//     - S = Q K^T is a wgmma m64n64k16 (bf16 in, fp32 accumulators in
//       registers), Q and K both read from shared memory (K-major). The
//       scale, the masks (-1e30), the running m and l and the rescale of
//       the output stay in fp32 registers, with IEEE expf. P is rounded
//       to bf16 in registers and fed as the register A operand of a
//       second wgmma m64n{hd}k16 against V in shared memory (B
//       transposed: V is [keys][hd], MN-major). l sums the fp32 P.
//     - A warpgroup runs its tile's products and softmax in turn; up to
//       hd 64 two CTAs share an SM, so one CTA's softmax overlaps the
//       other's products. (Issuing tile t + 1's S before tile t's
//       softmax, as FlashAttention-3 does, was slower on this card at
//       every hd: at hd 64 its live registers no longer fit two CTAs per
//       SM without spills, and at hd 80 and 128 it lost to this order.)
//     - The mask is applied on the diagonal tile and on the ragged last
//       tile only; keys past S arrive as TMA's zero fill, query rows
//       past S are computed and not stored.
//  * fp32 at hd in {8, 16, 64, 80, 128}, and bf16 at hd 8, keep the
//    CUDA-core body (`fma_attention_kernel`): fp32's 2e-5 bar cannot be
//    held in TF32, and hd 8 is below the k16 step of a bf16 product.
//    One CTA of 256 threads per (64-query tile, head, batch); q, k and v
//    staged in shared memory in fp32; thread (ty, tx) of a 16 x 16 grid
//    owns a 4 x 4 block of the 64 x 64 score tile and 4 rows of the
//    output; causal CTAs issued longest first.
// No atomics in either: every output element is summed in an order
// fixed by S and hd alone, so two identical calls are bitwise equal.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// The CUDA-core body: fp32 at any hd, and hd 8 in bf16.

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kLd = kBlockQ + 4;  // row stride of the [hd][64] tiles

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
fma_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
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


// ---------------------------------------------------------------------------
// The tensor-core body: bf16, hd in {16, 64, 80, 128}.

constexpr int kTcRows = 128;    // query rows per CTA
constexpr int kTcKeys = 64;     // keys per K/V tile
constexpr int kTcStages = 2;
constexpr int kTcConsumers = 256;  // two warpgroups
constexpr int kTcThreads = kTcConsumers + 32;  // and one producer warp
constexpr int kBlockBytes = 32;  // a row of one 16-column block
constexpr int kEmptyArrivals = kTcConsumers / 32;  // a lane per warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of parity `parity` has completed; a
// phase that never completes (a fault) traps after ~10 s instead of
// holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

// one TMA box of a 4-D map (hd, heads, positions, batch) into shared
// memory, completing `bytes` on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: 32-byte swizzle, byte offsets
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 | 3ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator
// registers across the asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64 x n64, fp32) += A (smem, K-major) . B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64 x n16, fp32) += A (registers, bf16 pairs) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n64, fp32) += A (registers, bf16 pairs) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n80, fp32) += A (registers, bf16 pairs) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39},"
      " {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n128, fp32) += A (registers, bf16 pairs) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 16) wgmma_rs_n16(d, a, db);
  if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  if constexpr (HD == 80) wgmma_rs_n80(d, a, db);
  if constexpr (HD == 128) wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct TcArgs {
  int S, H, KVH;
  float scale;
  int causal;
};

template <int HD>
struct TcSmem {
  static constexpr int kBlocks = HD / 16;
  static constexpr int kQBytes = kBlocks * kTcRows * kBlockBytes;
  static constexpr int kKVBytes = kBlocks * kTcKeys * kBlockBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;                  // [stage]
  static constexpr int kV = kK + kTcStages * kKVBytes;     // [stage]
  static constexpr int kBars = kV + kTcStages * kKVBytes;  // 8-byte each
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kTcStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align the base
};

// grid (H, B, ceil(S / 128)); 288 threads: warpgroups 0 and 1 compute
// query rows [64 w, 64 w + 64) of the tile, warp 8 loads. Up to hd 64
// two CTAs share an SM (at most 113 registers a thread), so one CTA's
// softmax overlaps the other's products.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, HD <= 64 ? 2 : 1)
wgmma_attention_kernel(__grid_constant__ const CUtensorMap qmap,
                       __grid_constant__ const CUtensorMap kmap,
                       __grid_constant__ const CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, TcArgs a) {
  using L = TcSmem<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t q_s = base + L::kQ;
  const uint32_t bar_q = base + L::kBars;
  auto k_s = [&](int st) { return base + L::kK + st * L::kKVBytes; };
  auto v_s = [&](int st) { return base + L::kV + st * L::kKVBytes; };
  auto bar_full = [&](int st) { return bar_q + 8 * (1 + st); };
  auto bar_empty = [&](int st) { return bar_q + 8 * (1 + kTcStages + st); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_qt = (a.S + kTcRows - 1) / kTcRows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.z);
  const int q0 = qt * kTcRows;
  const int kvh = h / (a.H / a.KVH);
  const int s_tiles = (a.S + kTcKeys - 1) / kTcKeys;
  // K/V tiles the CTA streams: up to the diagonal of its last row
  const int n_kt = a.causal ? min(s_tiles, 2 * qt + 2) : s_tiles;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kTcStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kTcConsumers / 32) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int j = 0; j < L::kBlocks; ++j)
        tma_load(q_s + j * kTcRows * kBlockBytes, &qmap, bar_q, 16 * j, h,
                 q0, b);
      for (int t = 0; t < n_kt; ++t) {
        const int st = t % kTcStages;
        if (t >= kTcStages)
          mbar_wait(bar_empty(st), (t / kTcStages - 1) & 1);
        mbar_expect_tx(bar_full(st), 2 * L::kKVBytes);
        for (int j = 0; j < L::kBlocks; ++j) {
          const uint32_t off = j * kTcKeys * kBlockBytes;
          tma_load(k_s(st) + off, &kmap, bar_full(st), 16 * j, kvh,
                   t * kTcKeys, b);
          tma_load(v_s(st) + off, &vmap, bar_full(st), 16 * j, kvh,
                   t * kTcKeys, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows r0 = 16 wi + g and r0 + 8 of its 64
  const int wg = warp >> 2;
  const int wi = warp & 3;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row0 = q0 + 64 * wg + 16 * wi + g;  // sequence position
  const int diag = 2 * qt + wg;  // the K/V tile on this warpgroup's diagonal
  const int my_kt = a.causal ? min(n_kt, diag + 1) : n_kt;

  float o_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o_acc[i] = 0.0f;
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.0f, 0.0f};  // this thread's share of the row sums

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_kt; ++t) {
    const int st = t % kTcStages;
    mbar_wait(bar_full(st), (t / kTcStages) & 1);
    if (t < my_kt) {
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < L::kBlocks; ++j)
        wgmma_ss_n64(s,
                     smem_desc(q_s + j * kTcRows * kBlockBytes +
                                   wg * 64 * kBlockBytes,
                               16, 8 * kBlockBytes),
                     smem_desc(k_s(st) + j * kTcKeys * kBlockBytes, 16,
                               8 * kBlockBytes));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);

      // s[4 i + e]: row r0 (e < 2) or r0 + 8, key 64 t + 8 i + 2 tig + (e & 1)
      const bool masked = (a.causal && t == diag) || t == s_tiles - 1;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * i + e] * a.scale;
          if (masked) {
            const int key = t * kTcKeys + 8 * i + 2 * tig + (e & 1);
            const int row = row0 + (e >> 1) * 8;
            if (key >= a.S || (a.causal && key > row)) x = kNegInf;
          }
          s[4 * i + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[r], mx[r]);
        alpha[r] = expf(m_i[r] - m_new);
        m_i[r] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = expf(s[i] - m_i[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[i];
      }
      l_i[0] = l_i[0] * alpha[0] + sum[0];
      l_i[1] = l_i[1] * alpha[1] + sum[1];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];

      // P (bf16) as the register A operand: keys [16 kk, 16 kk + 16)
      uint32_t p[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      reg_fence(o_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<HD>(o_acc, p[kk],
                     smem_desc(v_s(st) + kk * 16 * kBlockBytes,
                               kTcKeys * kBlockBytes, 8 * kBlockBytes));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(st));
  }

  // the row sums: the quad's four shares, in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    if (l_i[r] == 0.0f) l_i[r] = 1.0f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.S) continue;
    __nv_bfloat16* dst =
        o + ((static_cast<long long>(b) * a.S + row) * a.H + h) * HD +
        2 * tig;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(
          o_acc[4 * i + 2 * r] / l_i[r], o_acc[4 * i + 2 * r + 1] / l_i[r]);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) = v2;
    }
  }
}


// ---------------------------------------------------------------------------
// Launches.

template <typename T, int HD>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  // The opt-in above 48 KB holds per device, so it is made on every
  // launch (it is cheap) rather than remembered once per process.
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fma_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.H, a.B);
  fma_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fma_hd(const void* q, const void* k, const void* v, void* o,
                  int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch_fma<T, 8>(q, k, v, o, a, stream);
    case 16: return launch_fma<T, 16>(q, k, v, o, a, stream);
    case 64: return launch_fma<T, 64>(q, k, v, o, a, stream);
    case 80: return launch_fma<T, 80>(q, k, v, o, a, stream);
    case 128: return launch_fma<T, 128>(q, k, v, o, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the
// library needs no -lcuda
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a 4-D map (hd, heads, positions, batch) of a bf16 tensor read through
// its element strides, boxes of 16 head dims x `rows` positions, 32-byte
// swizzle; positions past S read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int S,
              int B, long long s_h, long long s_s, long long s_b, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_s) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {16, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              const Args& a, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, HD, a.H, a.S, a.B, a.q_sh, a.q_ss, a.q_sb,
                kTcRows) ||
      !make_map(&kmap, k, HD, a.KVH, a.S, a.B, a.k_sh, a.k_ss, a.k_sb,
                kTcKeys) ||
      !make_map(&vmap, v, HD, a.KVH, a.S, a.B, a.v_sh, a.v_ss, a.v_sb,
                kTcKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = TcSmem<HD>::kAlloc;
  const cudaError_t rc = cudaFuncSetAttribute(
      wgmma_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const TcArgs t{a.S, a.H, a.KVH, a.scale, a.causal};
  const dim3 grid(a.H, a.B, (a.S + kTcRows - 1) / kTcRows);
  wgmma_attention_kernel<HD><<<grid, kTcThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), t);
  return static_cast<int>(cudaGetLastError());
}

// the tensor-core body's conditions on top of the common ones: every
// base 16-byte aligned and every (batch, position, head) stride a
// multiple of 16 bytes (TMA's rules)
bool tc_aligned(const void* p, long long sb, long long ss, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0 && sb > 0 && ss > 0 && sh > 0;
}

int launch_tc_hd(const void* q, const void* k, const void* v, void* o,
                 int hd, const Args& a, cudaStream_t stream) {
  if (!tc_aligned(q, a.q_sb, a.q_ss, a.q_sh) ||
      !tc_aligned(k, a.k_sb, a.k_ss, a.k_sh) ||
      !tc_aligned(v, a.v_sb, a.v_ss, a.v_sh))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16: return launch_tc<16>(q, k, v, o, a, stream);
    case 64: return launch_tc<64>(q, k, v, o, a, stream);
    case 80: return launch_tc<80>(q, k, v, o, a, stream);
    case 128: return launch_tc<128>(q, k, v, o, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o (B, S, H, hd), contiguous, <- attention of q (B, S, H, hd) over k, v
// (B, S, KVH, hd), each read through its (batch, position, head) element
// strides with a unit-stride head dim. hd in {8, 16, 64, 80, 128};
// H % KVH == 0; dtype 0 = float32, 1 = bfloat16 (q, k, v and o share
// it); causal 0 or 1. bf16 at hd != 8 takes the tensor-core body, which
// also needs 16-byte aligned bases and strides that are multiples of 8
// elements (every stride > 0). Returns cudaGetLastError() after the
// launch (0 = launched).
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
  if (dtype == 0) return launch_fma_hd<float>(q, k, v, o, hd, a, st);
  if (dtype == 1 && hd == 8)
    return launch_fma<__nv_bfloat16, 8>(q, k, v, o, a, st);
  if (dtype == 1) return launch_tc_hd(q, k, v, o, hd, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
