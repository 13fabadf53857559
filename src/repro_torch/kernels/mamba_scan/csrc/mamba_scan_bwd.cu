// Backward of B7's gated mode (the Mamba1 selective scan with dt =
// softplus(dt_raw + dt_bias), A = -exp(A_log) and the silu(z) gate) for
// Hopper (sm_90a): the gradients of every input for the output gradients
// dy (B, S, di) and dhT (B, di, N).
// The reference has no backward kernel: its Pallas scan
// (src/repro/kernels/mamba_scan/mamba_scan.py `_kernel`, launched by
// `mamba1_scan`) defines no VJP, and its model trains through its own
// lax.scan (src/repro/models/ssm.py `_mamba1_inner`), which JAX turns into
// one compiled reverse loop. This kernel is that reverse loop on the card.
//
// The forward, recomputed in fp32 with mamba_scan.cu's own formulas and
// op order (v = dt_raw + bias, dt = softplus(v), A = -expf(A_log),
// da = expf(dt A), h_t = da h_{t-1} + (dt x) B_t, u_t = sum_n h_t C_t +
// D x, y = u silu(z)), then, walking t from S - 1 down to 0:
//   s = silu(z), dys = dy s, dz = (dy u) (sig (1 + z (1 - sig))),
//     sig = 1 / (1 + expf(-z));
//   g_t = dys C_t + r_t, the adjoint of h_t, where r_{S-1} = dhT (0 when
//     none is given) and r_{t-1} = da_t g_t;
//   gB = sum_n g B_t; dx = dys D + dt gB;
//   ddt = sum_n A (g (da h_{t-1})) + x gB; ddt_raw = ddt where v > 20
//     (torch's softplus gradient), else ddt (e / (e + 1)), e = expf(v);
//   dh0 = r_{-1} = da_0 g_0;
//   over (b, t), per channel: dA_log = A sum dt (g (da h_{t-1})),
//     ddt_bias = sum ddt_raw, dD = sum dys x;
//   over channels, per (b, t): dB_t = sum_c g (dt x), dC_t = sum_c dys h_t.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// FMA contraction, IEEE expf / log1pf / division), and the sums over n
// fold halves as the forward's do, so ops.plain_gated_scan_backward, which
// does the same operations in the same order with PyTorch's elementwise
// ops, gives the same bits for dx, dz, ddt_raw and dh0 at every G. The
// reductions over channels are summed in another order than the plain
// version's (bars in chip_smoke.py phase 42 and the card tests).
//
// Design: two kernels a launch, G lanes a channel (G in {1, 2, 4}). Lane
// g of a channel holds the M = N / G states {g, g + G, g + 2G, ...} in
// registers, the forward's layout; a sum over n folds the lane's own
// registers, then log2 G xor shuffles, ref._fold_sum's fold of halves. No
// float atomics: the results repeat bit for bit.
//  * Pass 1 (mamba1_scan_gated_bwd_ckpt_kernel) is mamba_scan.cu's forward
//    scan in small blocks (128 / G channels of one row) with no y: it
//    writes the state entering every TC-th step to a workspace, ckpt (B,
//    ceil(S / TC), di, N) fp32. Lane g computes softplus for steps g, g +
//    G, ... of a group and the lanes swap the values by shuffles.
//  * Pass 2 (mamba1_scan_gated_bwd_kernel): a block covers 128
//    neighbouring channels of one row (grid (ceil(di / 128), B)), 128 G
//    threads, and takes the chunks of TC steps from the last. At a chunk's
//    head the block computes the chunk's per-(channel, step) values once
//    (softplus and its e, silu, sigma(z), dsilu, sigma(v), dt x, D x, dy
//    silu(z)): thread i takes channel i % 128 and steps i / 128 + G k, from
//    coalesced loads issued one chunk ahead, into shared memory, where the
//    G lanes of a channel read them as broadcasts; B_t and C_t are staged
//    beside them. The chunk is recomputed from its checkpoint: each step
//    keeps h_t and da_t in shared memory (2 x TC x N x 128 fp32), so the
//    walk back reads da instead of a third expf and forms da h_{t-1} from
//    the kept state. A step past S has zero values, which leave the state
//    and the adjoint as they are, so every chunk runs all TC steps.
//  * A step's outputs go into its slot of per-step values and are stored
//    after the walk, one coalesced row of 128 channels a (step, output).
//  * The sums over channels: at each step a lane writes its M dB terms
//    into the slots of da_t it has just read; dC's terms, dy silu(z) h_t,
//    are formed from the kept h_t. After the chunk's walk one warp a (step,
//    dB or dC) row adds the block's 128 channels in a fixed order (four
//    interleaved runs over each lane's channels, then xor shuffles across
//    the lanes) and writes one partial (B, S, ceil(di / 128), 2N) fp32.
//    The sums over (b, t) are carried in registers in reverse time and
//    written as (B, di, N) and (B, di) partials. The wrapper sums the
//    partials' block and batch dims with torch's sum (glue outside the
//    kernel).
//  * Channels past di (a ragged di) read the last channel's values, are
//    left out of the channel sums and write nothing.
//
// What bounds it on this card. Per (batch, step, channel) the function
// needs N exponentials (da) and 5 more SFU operations (softplus's exp and
// log, sigma(v)'s reciprocal, sigma(z)'s exp and reciprocal), and it
// must read dt_raw, x, z, dy, B and C once and write ddt_raw, dx, dz, dB
// and dC once. At the training path's (4, 4,096, 8,192, 16) in bf16 that
// is 2.82e9 SFU operations (0.67 ms at 16 a clock per SM x 132 SMs x 1.98
// GHz) against 1.88 GB (0.56 ms at 3.35 TB/s): the SFU bound. This design
// runs 2 exponentials a state-step (pass 1 and the recompute) and ~60
// instructions a state-step in all (~3.9 ms of issue at that shape), and
// moves ~0.5 KB of shared memory a (channel, step) (~1.9 ms at 128 B a
// clock an SM); it reaches about 40% of its issue rate. Pass 2's shared
// memory (169 KB a block at N = 16) holds one block an SM, so G sets its
// resident warps, 16 at G = 4, and its two block barriers a chunk stall
// the whole SM. chip_smoke.py phase 42 prints the registers, spills,
// resident warps, the walk's SASS count and the times at every G;
// tools/b7_backward_ablation.py times copies with a part cut out (PERF.md
// holds the numbers).
// Templated on N (4, 8, 16, 32), G and the type of dt_raw, x, z, B, C and
// dy (fp32, bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 128;       // channels a block
constexpr int kStateFloats = 16384;  // h kept for a chunk: TC x N x 128
constexpr int kPerStep = 8;          // per-(channel, step) values kept

// steps a chunk holds: the kept states fill kStateFloats, at most 16
template <int N>
__host__ __device__ constexpr int chunk_steps() {
  return kStateFloats / (kChannels * N) < 16 ? kStateFloats / (kChannels * N)
                                              : 16;
}

template <int N>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int TC = chunk_steps<N>();
  return sizeof(float) *
         (2 * static_cast<size_t>(TC) * kChannels * N  // s_h, s_da
          + TC * kChannels * kPerStep                    // s_p
          + 2 * TC * kChannels                           // s_dys
          + TC * 2 * N);                                 // s_bc
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* out) { *out = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

struct Params {
  const void* dt_raw;  // (B, S, di), strided, in x's type
  const void* x;
  const void* z;
  const void* Bm;  // (B, S, N), strided
  const void* Cm;
  const void* dy;  // (B, S, di), strided
  const float* dt_bias;  // (di,)
  const float* A_log;    // (di, N)
  const float* D;        // (di,)
  const float* h0;       // (B, di, N), null for zeros
  const float* dhT;      // (B, di, N), null for zeros
  float* ckpt;           // (B, chunks, di, N) workspace
  void* ddt_raw;         // (B, S, di) contiguous, x's type; null: skipped
  void* dx;
  void* dz;
  float* dh0;            // (B, di, N); null: skipped
  float* part_bc;        // (B, S, blocks, 2N): dB then dC; null: skipped
  float* part_A;         // (B, di, N); null: skipped
  float* part_D;         // (B, di)
  float* part_bias;      // (B, di)
  int B, S, di;
  long long dt_sb, dt_ss, x_sb, x_ss, z_sb, z_ss, b_sb, b_ss, c_sb, c_ss,
      dy_sb, dy_ss;
};

// V consecutive floats of shared memory (16-byte aligned for V = 4)
template <int V>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
    dst[0] = src[0];
  }
}
template <int V>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    dst[0] = src[0];
  }
}

// A lane's M floats of one step's row, kept as [M / V][threads][V] so a
// warp's vector accesses are one contiguous run
template <int M, int kThreads>
__device__ __forceinline__ void load_row(const float* row, int tid,
                                         float (&dst)[M]) {
  constexpr int V = M < 4 ? M : 4;
#pragma unroll
  for (int k4 = 0; k4 < M / V; ++k4)
    load_vec<V>(row + (k4 * kThreads + tid) * V, dst + k4 * V);
}
template <int M, int kThreads>
__device__ __forceinline__ void store_row(float* row, int tid,
                                          const float (&src)[M]) {
  constexpr int V = M < 4 ? M : 4;
#pragma unroll
  for (int k4 = 0; k4 < M / V; ++k4)
    store_vec<V>(row + (k4 * kThreads + tid) * V, src + k4 * V);
}

// q[k] += q[k + W] for k < W, then W / 2, ... 1: the fold of halves
template <int W, int M>
__device__ __forceinline__ void fold(float (&q)[M]) {
  if constexpr (W > 0) {
#pragma unroll
    for (int k = 0; k < W; ++k) q[k] = __fadd_rn(q[k], q[k + W]);
    fold<W / 2, M>(q);
  }
}

// the fold's last levels across the G lanes of a channel (xor OFF, then
// OFF / 2, ... 1); every lane ends with the same sum
template <int OFF>
__device__ __forceinline__ float lane_fold(float v) {
  if constexpr (OFF > 0) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, OFF));
    return lane_fold<OFF / 2>(v);
  } else {
    return v;
  }
}

// a sum over the N states of one channel: the lane's M values folded in
// halves, then across the channel's G lanes
template <int M, int G>
__device__ __forceinline__ float state_sum(float (&q)[M]) {
  fold<M / 2, M>(q);
  return lane_fold<G / 2>(q[0]);
}

// dt = softplus(v) as the forward computes it (torch's CUDA softplus,
// threshold 20), with e = expf(v) for the gradient's sigma(v)
__device__ __forceinline__ float softplus_e(float v, float* e) {
  *e = expf(v);
  const float s = log1pf(*e);
  return v > 20.f ? v : s;
}

// The gated mode's dt = softplus(dt_raw + bias) and dt x of a group of K
// steps, in place of dt_raw and x. With G lanes on a channel, lane g
// computes steps g, g + G, ... and the lanes swap them by shuffles (the
// forward's gate_prologue), so no lane repeats another's softplus.
template <int G, int K>
__device__ __forceinline__ void softplus_lanes(float (&dt)[K],
                                               float (&x)[K], float bias,
                                               int g) {
  static_assert(K % G == 0, "a group's steps split evenly over the lanes");
  constexpr int kOwn = K / G;
  float od[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    float vd = dt[i * G];
#pragma unroll
    for (int l = 1; l < G; ++l)
      if (g == l) vd = dt[i * G + l];
    float e;
    od[i] = softplus_e(__fadd_rn(vd, bias), &e);
  }
  const int base = (threadIdx.x & 31) & ~(G - 1);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if constexpr (G == 1)
      dt[j] = od[j];
    else
      dt[j] = __shfl_sync(0xffffffffu, od[j / G], base + j % G);
    x[j] = __fmul_rn(dt[j], x[j]);
  }
}

constexpr int kCkThreads = 128;  // pass 1's block: 128 / G channels
constexpr int kCkStage = 32;     // steps of B_t staged at once

// Pass 1: the forward scan of the gated mode (mamba_scan.cu's layout and
// op order: G lanes a channel, a lane's M states in registers, B_t staged
// in shared memory, dt_raw and x loaded a group of K steps ahead),
// writing the state entering every TC-th step to the workspace instead
// of y. Its blocks are small, so many fill an SM.
template <int N, int G, typename T>
__global__ void __launch_bounds__(kCkThreads)
    mamba1_scan_gated_bwd_ckpt_kernel(const Params p) {
  constexpr int M = N / G;
  constexpr int kCh = kCkThreads / G;
  constexpr int TC = chunk_steps<N>();
  constexpr int K = M >= 8 ? 4 : 8;  // steps a group
  constexpr int VL = M < 4 ? M : 4;
  constexpr int kStage = kCkStage * N / kCkThreads;  // staged a thread
  static_assert(TC % K == 0 && kCkStage % K == 0, "groups fill a chunk");
  static_assert(kCkStage * N % kCkThreads == 0, "whole staging rounds");
  // [buffer][step][g * M + k] = B_t of state g + G k
  __shared__ __align__(16) float s_b[2][kCkStage][N];

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int c = blockIdx.x * kCh + tid / G;
  const int b = blockIdx.y;
  const bool valid = c < p.di;
  const int cl = valid ? c : p.di - 1;
  const long long S = p.S;
  const long long chunks = (S + TC - 1) / TC;
  const long long steps_run = (chunks - 1) * TC;  // to the last checkpoint

  float a[M], h[M];
  const long long state0 = (static_cast<long long>(b) * p.di + cl) * N;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    a[k] = -expf(p.A_log[static_cast<long long>(cl) * N + g + G * k]);
    h[k] = p.h0 != nullptr ? p.h0[state0 + g + G * k] : 0.f;
  }
  const float bias = p.dt_bias[cl];
  float* ck = p.ckpt + (static_cast<long long>(b) * chunks * p.di + cl) * N
              + g;
  const long long ck_stride = static_cast<long long>(p.di) * N;
  const T* dt_c = static_cast<const T*>(p.dt_raw) + b * p.dt_sb + cl;
  const T* x_c = static_cast<const T*>(p.x) + b * p.x_sb + cl;
  const T* b_row = static_cast<const T*>(p.Bm) + b * p.b_sb;

  T r_dt[K], r_x[K];
  auto load_group = [&](long long s0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool in = s0 + j < steps_run;
      r_dt[j] = in ? dt_c[(s0 + j) * p.dt_ss] : T(0.f);
      r_x[j] = in ? x_c[(s0 + j) * p.x_ss] : T(0.f);
    }
  };
  auto stage = [&](long long t0, int buf) {
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int e = tid + i * kCkThreads;
      const int t = e / N, n = e % N;
      const long long s = t0 + t;
      s_b[buf][t][(n % G) * M + n / G] =
          s < steps_run ? widen(b_row[s * p.b_ss + n]) : 0.f;
    }
  };

  load_group(0);
  stage(0, 0);
  __syncthreads();
  int buf = 0;
  for (long long t0 = 0; t0 < steps_run; t0 += kCkStage) {
    const bool more = t0 + kCkStage < steps_run;
    if (more && tid < kCkStage && t0 + kCkStage + tid < steps_run)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          b_row + (t0 + kCkStage + tid) * p.b_ss));
    const int steps = steps_run - t0 < kCkStage
                          ? static_cast<int>(steps_run - t0) : kCkStage;
    for (int t = 0; t < steps; t += K) {  // steps_run is a multiple of K
      const long long s0 = t0 + t;
      if (s0 % TC == 0 && valid) {
#pragma unroll
        for (int kk = 0; kk < M; ++kk)
          ck[(s0 / TC) * ck_stride + G * kk] = h[kk];
      }
      float v_dt[K], v_x[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        v_dt[j] = widen(r_dt[j]);
        v_x[j] = widen(r_x[j]);
      }
      load_group(s0 + K);
      softplus_lanes<G, K>(v_dt, v_x, bias, g);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float bv[M];
#pragma unroll
        for (int k4 = 0; k4 < (M + 3) / 4; ++k4)
          load_vec<VL>(&s_b[buf][t + j][g * M + 4 * k4], bv + 4 * k4);
#pragma unroll
        for (int kk = 0; kk < M; ++kk) {
          const float da = expf(__fmul_rn(v_dt[j], a[kk]));
          h[kk] = __fadd_rn(__fmul_rn(da, h[kk]), __fmul_rn(v_x[j], bv[kk]));
        }
      }
    }
    if (more) stage(t0 + kCkStage, buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  if (valid) {
#pragma unroll
    for (int kk = 0; kk < M; ++kk)
      ck[(chunks - 1) * ck_stride + G * kk] = h[kk];
  }
}

template <int N, int G, typename T>
__global__ void __launch_bounds__(kChannels * G, 1)
    mamba1_scan_gated_bwd_kernel(const Params p) {
  constexpr int M = N / G;                 // states a lane holds
  constexpr int kThreads = kChannels * G;  // threads a block
  constexpr int kWarps = kThreads / 32;
  constexpr int TC = chunk_steps<N>();
  constexpr int V = 2 * N;
  constexpr int kOwn = TC / G;  // (channel, step)s of a thread's prologue
  constexpr int kStage = (TC * V + kThreads - 1) / kThreads;
  constexpr int VL = M < 4 ? M : 4;  // floats of a lane's vector loads
  static_assert(N % G == 0 && 32 % G == 0 && TC % G == 0, "G lanes");
  extern __shared__ __align__(16) float smem[];
  float* s_h = smem;                         // [TC][M/VL][kThreads][VL]
  float* s_da = s_h + TC * kChannels * N;    // the same
  float* s_p = s_da + TC * kChannels * N;    // [TC][kChannels][kPerStep]
  float* s_dys = s_p + TC * kChannels * kPerStep;  // [2][TC][kChannels]
  float* s_bc = s_dys + 2 * TC * kChannels;        // [TC][2][N]
  constexpr int kRow = kChannels * N;        // floats of one step's row

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = tid % G;
  const int cb = tid / G;  // the lane's channel in the block
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + cb;
  const int b = blockIdx.y;
  const bool valid = c < p.di;
  const int cl = valid ? c : p.di - 1;  // a ragged block reads in bounds
  const int nvalid = p.di - c0 < kChannels ? p.di - c0 : kChannels;
  const long long S = p.S;
  const long long chunks = (S + TC - 1) / TC;
  const long long row0 = static_cast<long long>(b) * S;

  float a[M];
  const long long state0 = (static_cast<long long>(b) * p.di + cl) * N;
#pragma unroll
  for (int k = 0; k < M; ++k)
    a[k] = -expf(p.A_log[static_cast<long long>(cl) * N + g + G * k]);
  const float dv = p.D[cl];
  // chunk k's checkpoint of this lane's states: ck[k * ck_stride + G kk]
  float* ck = p.ckpt + (static_cast<long long>(b) * chunks * p.di + cl) * N
              + g;
  const long long ck_stride = static_cast<long long>(p.di) * N;

  // the prologue's channel and steps: channel pc, steps pj + G i
  const int pc = tid % kChannels, pj = tid / kChannels;
  const int pcl = c0 + pc < p.di ? c0 + pc : p.di - 1;
  const float p_bias = p.dt_bias[pcl];
  const float p_dv = p.D[pcl];
  const T* dt_c = static_cast<const T*>(p.dt_raw) + b * p.dt_sb + pcl;
  const T* x_c = static_cast<const T*>(p.x) + b * p.x_sb + pcl;
  const T* z_c = static_cast<const T*>(p.z) + b * p.z_sb + pcl;
  const T* dy_c = static_cast<const T*>(p.dy) + b * p.dy_sb + pcl;
  const T* b_row = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* c_row = static_cast<const T*>(p.Cm) + b * p.c_sb;

  // a chunk's raw per-channel values and B, C rows, loaded one chunk
  // ahead and kept as loaded until the chunk's head
  T r_dt[kOwn], r_x[kOwn], r_z[kOwn], r_dy[kOwn];
  float r_bc[kStage];
  auto load_chunk = [&](long long t0) {
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const long long s = t0 + pj + G * i;
      const bool in = s < S;
      r_dt[i] = in ? dt_c[s * p.dt_ss] : T(0.f);
      r_x[i] = in ? x_c[s * p.x_ss] : T(0.f);
      r_z[i] = in ? z_c[s * p.z_ss] : T(0.f);
      r_dy[i] = in ? dy_c[s * p.dy_ss] : T(0.f);
    }
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int e = tid + i * kThreads;
      const long long s = t0 + e / V;
      const int k = e % V;
      float val = 0.f;
      if (e < TC * V && s < S)
        val = widen(k < N ? b_row[s * p.b_ss + k]
                          : c_row[s * p.c_ss + (k - N)]);
      r_bc[i] = val;
    }
  };
  // B_t and C_t into s_bc as fp32, state n at (n % G) M + n / G of its
  // half, so a lane reads its M states as one vector
  auto stage_bc = [&]() {
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int e = tid + i * kThreads;
      if (e < TC * V) {
        const int j = e / V, k = e % V, n = k % N;
        s_bc[j * V + (k / N) * N + (n % G) * M + n / G] = r_bc[i];
      }
    }
  };

  // the chunks from the last, recomputed, then walked back; r the
  // adjoint, acc_a, acc_d and acc_bias the sums over (b, t)
  float h[M], r[M], acc_a[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    r[k] = p.dhT != nullptr ? p.dhT[state0 + g + G * k] : 0.f;
    acc_a[k] = 0.f;
  }
  float acc_d = 0.f, acc_bias = 0.f;
  load_chunk((chunks - 1) * TC);

  for (long long k = chunks - 1; k >= 0; --k) {
    const long long t0 = k * TC;
    const int steps = S - t0 < TC ? static_cast<int>(S - t0) : TC;
    // the chunk's per-(channel, step) values, once each: (dt, dt x, D x,
    // dy silu(z)) and (dy, dsilu, sigma(v) or 1 where v > 20, x); zeros
    // past S, which make a step the identity (da = 1, nothing added)
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const bool in = t0 + pj + G * i < S;
      const float vraw = __fadd_rn(widen(r_dt[i]), p_bias);
      float ev;
      const float dtv = softplus_e(vraw, &ev);
      const float xv = widen(r_x[i]), zv = widen(r_z[i]);
      const float dyv = widen(r_dy[i]);
      const float en = expf(-zv);
      const float s = __fdiv_rn(zv, __fadd_rn(1.f, en));
      const float sig = __frcp_rn(__fadd_rn(1.f, en));
      const float dsilu = __fmul_rn(
          sig, __fadd_rn(1.f, __fmul_rn(zv, __fsub_rn(1.f, sig))));
      const float sgv = vraw > 20.f ? 1.f : __fdiv_rn(ev, __fadd_rn(ev, 1.f));
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float* pp = s_p + ((pj + G * i) * kChannels + pc) * kPerStep;
      *reinterpret_cast<float4*>(pp) =
          in ? make_float4(dtv, __fmul_rn(dtv, xv), __fmul_rn(p_dv, xv),
                           __fmul_rn(dyv, s))
             : zero;
      *reinterpret_cast<float4*>(pp + 4) =
          in ? make_float4(dyv, dsilu, sgv, xv) : zero;
      // dy silu(z) again for the chunk's dC sums, in a buffer of the
      // chunk's parity (the next chunk's prologue writes the other)
      s_dys[((k & 1) * TC + pj + G * i) * kChannels + pc] =
          in ? __fmul_rn(dyv, s) : 0.f;
    }
    stage_bc();
    if (k > 0) load_chunk(t0 - TC);
    float hck[M];
#pragma unroll
    for (int kk = 0; kk < M; ++kk) hck[kk] = ck[k * ck_stride + G * kk];
    __syncthreads();  // s_p and s_bc written; the last chunk's sums read
    // the recompute from the checkpoint: h_t and da_t of each step into
    // s_h and s_da. A chunk runs all TC steps straight through: a step
    // past S leaves h and the adjoint as they are and writes nothing
#pragma unroll
    for (int kk = 0; kk < M; ++kk) h[kk] = hck[kk];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const float4 p0 = *reinterpret_cast<const float4*>(
          s_p + (j * kChannels + cb) * kPerStep);
      float bv[M], dav[M];
#pragma unroll
      for (int k4 = 0; k4 < (M + 3) / 4; ++k4)
        load_vec<VL>(s_bc + j * V + g * M + 4 * k4, bv + 4 * k4);
#pragma unroll
      for (int kk = 0; kk < M; ++kk) {
        dav[kk] = expf(__fmul_rn(p0.x, a[kk]));
        h[kk] = __fadd_rn(__fmul_rn(dav[kk], h[kk]),
                          __fmul_rn(p0.y, bv[kk]));
      }
      store_row<M, kThreads>(s_h + j * kRow, tid, h);
      store_row<M, kThreads>(s_da + j * kRow, tid, dav);
    }
    // the walk: hn = h_t (from the recompute's registers, then from the
    // row read a step before), hp = h_{t-1}. A loop, not unrolled: the
    // unrolled walk holds the next steps' loads in registers and spills
    float hn[M];
#pragma unroll
    for (int kk = 0; kk < M; ++kk) hn[kk] = h[kk];
#pragma unroll 1
    for (int j = TC - 1; j >= 0; --j) {
      float hp[M], dav[M], bv[M], cv[M];
      if (j > 0) {
        load_row<M, kThreads>(s_h + (j - 1) * kRow, tid, hp);
      } else {
#pragma unroll
        for (int kk = 0; kk < M; ++kk) hp[kk] = hck[kk];
      }
      load_row<M, kThreads>(s_da + j * kRow, tid, dav);
      const float* pp = s_p + (j * kChannels + cb) * kPerStep;
      const float4 p0 = *reinterpret_cast<const float4*>(pp);
      const float4 p1 = *reinterpret_cast<const float4*>(pp + 4);
      const float dtv = p0.x, dtx = p0.y, d_x = p0.z, dys = p0.w;
      const float dyv = p1.x, dsilu = p1.y, sgv = p1.z, xv = p1.w;
#pragma unroll
      for (int k4 = 0; k4 < (M + 3) / 4; ++k4) {
        load_vec<VL>(s_bc + j * V + g * M + 4 * k4, bv + 4 * k4);
        load_vec<VL>(s_bc + j * V + N + g * M + 4 * k4, cv + 4 * k4);
      }
      float q[M], gb[M], w[M], tb[M];
#pragma unroll
      for (int kk = 0; kk < M; ++kk) {
        const float eh = __fmul_rn(dav[kk], hp[kk]);  // da h_{t-1}
        q[kk] = __fmul_rn(hn[kk], cv[kk]);
        const float gv = __fadd_rn(__fmul_rn(dys, cv[kk]), r[kk]);
        gb[kk] = __fmul_rn(gv, bv[kk]);
        const float ge = __fmul_rn(gv, eh);
        w[kk] = __fmul_rn(a[kk], ge);
        acc_a[kk] = __fadd_rn(acc_a[kk], __fmul_rn(dtv, ge));
        tb[kk] = __fmul_rn(gv, dtx);  // dB_t's term
        r[kk] = __fmul_rn(dav[kk], gv);
        hn[kk] = hp[kk];
      }
      // dB_t's terms into the slots of da_t, just read (h_t stays for
      // dC_t's terms, dy silu(z) h_t, which the chunk's sums form)
      store_row<M, kThreads>(s_da + j * kRow, tid, tb);
      const float u = __fadd_rn(state_sum<M, G>(q), d_x);
      const float gbs = state_sum<M, G>(gb);
      const float ws = state_sum<M, G>(w);
      const float dzv = __fmul_rn(__fmul_rn(dyv, u), dsilu);
      const float dxv = __fadd_rn(__fmul_rn(dys, dv), __fmul_rn(dtv, gbs));
      const float ddt = __fadd_rn(ws, __fmul_rn(xv, gbs));
      const float ddt_raw = __fmul_rn(ddt, sgv);  // sgv = 1 where v > 20
      acc_bias = __fadd_rn(acc_bias, ddt_raw);
      acc_d = __fadd_rn(acc_d, __fmul_rn(dys, xv));
      // the step's outputs into its second (dy, dsilu, sigma, x) slot,
      // read by every lane of the channel above; stored after the walk
      __syncwarp();
      if (g == 0)
        *reinterpret_cast<float4*>(s_p + (j * kChannels + cb) * kPerStep +
                                   4) = make_float4(ddt_raw, dxv, dzv, 0.f);
    }
    __syncthreads();  // the chunk's terms and outputs written
    // the outputs, one row of 128 channels a (step, output): thread i
    // stores channel i % 128 of steps i / 128 + G k
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int j = pj + G * i;
      const float4 o = *reinterpret_cast<const float4*>(
          s_p + (j * kChannels + pc) * kPerStep + 4);
      if (j < steps && c0 + pc < p.di) {
        const long long at = (row0 + t0 + j) * p.di + c0 + pc;
        if (p.ddt_raw != nullptr)
          narrow(o.x, static_cast<T*>(p.ddt_raw) + at);
        if (p.dx != nullptr) narrow(o.y, static_cast<T*>(p.dx) + at);
        if (p.dz != nullptr) narrow(o.z, static_cast<T*>(p.dz) + at);
      }
    }
    // the chunk's sums of dB and dC over the block's channels: one warp a
    // (step, dB or dC) row; lane l adds the vectors l + 32 m of the row
    // (channels (l + 32 m) / G, states of lane l % G; dC's terms formed
    // here, dy silu(z) h_t) in four interleaved runs, then the lanes that
    // hold the same states are added by xor shuffles; a fixed order, the
    // same at every launch
    if (p.part_bc != nullptr) {
      for (int rho = warp; rho < 2 * steps; rho += kWarps) {
        const int j = rho >> 1, term = rho & 1;
        const float* row = (term ? s_h : s_da) + j * kRow;
        float res[M];
#pragma unroll
        for (int k4 = 0; k4 < M / VL; ++k4) {
          float run[4][VL];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < VL; ++e) run[i][e] = 0.f;
#pragma unroll
          for (int m = 0; m < kThreads / 32; ++m) {
            const int tq = lane + 32 * m;
            if (tq / G < nvalid) {
              float v[VL];
              load_vec<VL>(row + (k4 * kThreads + tq) * VL, v);
              const float dys = s_dys[((k & 1) * TC + j) * kChannels + tq / G];
#pragma unroll
              for (int e = 0; e < VL; ++e)
                run[m % 4][e] = __fadd_rn(
                    run[m % 4][e], term ? __fmul_rn(dys, v[e]) : v[e]);
            }
          }
#pragma unroll
          for (int e = 0; e < VL; ++e)
            res[k4 * VL + e] = __fadd_rn(__fadd_rn(run[0][e], run[1][e]),
                                         __fadd_rn(run[2][e], run[3][e]));
        }
#pragma unroll
        for (int off = G; off < 32; off *= 2) {
#pragma unroll
          for (int kk = 0; kk < M; ++kk)
            res[kk] = __fadd_rn(res[kk],
                                __shfl_xor_sync(0xffffffffu, res[kk], off));
        }
        if (lane < G) {
          float* out = p.part_bc +
                       ((row0 + t0 + j) * gridDim.x + blockIdx.x) * V +
                       term * N + lane;
#pragma unroll
          for (int kk = 0; kk < M; ++kk) out[G * kk] = res[kk];
        }
      }
    }
  }
  if (valid) {
    const long long pcd = static_cast<long long>(b) * p.di + c;
#pragma unroll
    for (int kk = 0; kk < M; ++kk) {
      if (p.dh0 != nullptr) p.dh0[state0 + g + G * kk] = r[kk];
      if (p.part_A != nullptr) p.part_A[state0 + g + G * kk] = acc_a[kk];
    }
    if (g == 0) {
      if (p.part_D != nullptr) p.part_D[pcd] = acc_d;
      if (p.part_bias != nullptr) p.part_bias[pcd] = acc_bias;
    }
  }
}

template <typename T, int N, int G>
int launch_one(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<N>();
  constexpr int kCh = kCkThreads / G;
  cudaError_t err = cudaFuncSetAttribute(
      mamba1_scan_gated_bwd_kernel<N, G, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1((p.di + kCh - 1) / kCh, p.B);
  mamba1_scan_gated_bwd_ckpt_kernel<N, G, T>
      <<<grid1, kCkThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.di + kChannels - 1) / kChannels, p.B);
  mamba1_scan_gated_bwd_kernel<N, G, T>
      <<<grid, kChannels * G, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// what the compiler gave one instantiation, into out[0..8): the walk's
// kernel's registers and local (spill) bytes a thread, dynamic shared
// bytes, threads and resident blocks an SM, then pass 1's registers,
// spill bytes and resident blocks an SM (kCkThreads threads each)
template <typename T, int N, int G>
int resources_one(int* out) {
  constexpr size_t bytes = smem_bytes<N>();
  auto kernel = mamba1_scan_gated_bwd_kernel<N, G, T>;
  auto ckpt = mamba1_scan_gated_bwd_ckpt_kernel<N, G, T>;
  cudaFuncAttributes attr, attr1;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr1, ckpt);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  int blocks = 0, blocks1 = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kChannels * G, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks1, ckpt,
                                                        kCkThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(bytes);
  out[3] = kChannels * G;
  out[4] = blocks;
  out[5] = attr1.numRegs;
  out[6] = static_cast<int>(attr1.localSizeBytes);
  out[7] = blocks1;
  return 0;
}

// f.run<T, N, G>() for the runtime (dtype, N, G), or
// cudaErrorInvalidValue
template <typename T, int N, typename F>
int by_g(int G, const F& f) {
  switch (G) {
    case 1: return f.template run<T, N, 1>();
    case 2: return f.template run<T, N, 2>();
    case 4: return f.template run<T, N, 4>();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
template <typename T, typename F>
int by_n(int N, int G, const F& f) {
  switch (N) {
    case 4: return by_g<T, 4>(G, f);
    case 8: return by_g<T, 8>(G, f);
    case 16: return by_g<T, 16>(G, f);
    case 32: return by_g<T, 32>(G, f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
template <typename F>
int dispatch(int dtype, int N, int G, const F& f) {
  if (dtype == 0) return by_n<float>(N, G, f);
  if (dtype == 1) return by_n<__nv_bfloat16>(N, G, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Launch {
  const Params& p;
  cudaStream_t stream;
  template <typename T, int N, int G>
  int run() const { return launch_one<T, N, G>(p, stream); }
};
struct Resources {
  int* out;
  template <typename T, int N, int G>
  int run() const { return resources_one<T, N, G>(out); }
};

}  // namespace

extern "C" {

// Steps a chunk holds for state size N (the workspace has ceil(S / this)
// checkpoints), or 0 for an N without an instantiation.
int mamba1_scan_gated_backward_chunk(int N) {
  switch (N) {
    case 4: return chunk_steps<4>();
    case 8: return chunk_steps<8>();
    case 16: return chunk_steps<16>();
    case 32: return chunk_steps<32>();
    default: return 0;
  }
}

// The gradients of the gated scan (see the header). dt_raw, x, z, B, C
// and dy share one type (dtype 0 = float32, 1 = bfloat16) and are read
// through their (batch, position) element strides with a unit-stride
// last dim; dt_bias, A_log, D, h0 and dhT contiguous fp32, h0 and dhT
// null for zeros. ckpt is the (B, ceil(S / chunk), di, N) fp32
// workspace. Outputs, each skipped when null: ddt_raw, dx, dz (B, S, di)
// contiguous in that type; dh0 (B, di, N), part_A (B, di, N), part_D and
// part_bias (B, di), part_bc (B, S, ceil(di / 128), 2N), all fp32 and
// contiguous. N in {4, 8, 16, 32}, G (lanes a channel) in {1, 2, 4}.
// Returns cudaGetLastError() after the launch (0 = launched).
int mamba1_scan_gated_backward(
    const void* dt_raw, const void* dt_bias, const void* x, const void* Bm,
    const void* Cm, const void* A_log, const void* Dv, const void* z,
    const void* h0, const void* dy, const void* dhT, void* ckpt,
    void* ddt_raw, void* dx, void* dz, void* dh0, void* part_bc,
    void* part_A, void* part_D, void* part_bias, int B, int S, int di, int N,
    int G, long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
    long long z_sb, long long z_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, long long dy_sb, long long dy_ss,
    int dtype, void* stream) {
  if (B < 1 || S < 1 || di < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{dt_raw, x, z, Bm, Cm, dy,
                 static_cast<const float*>(dt_bias),
                 static_cast<const float*>(A_log),
                 static_cast<const float*>(Dv),
                 static_cast<const float*>(h0),
                 static_cast<const float*>(dhT), static_cast<float*>(ckpt),
                 ddt_raw, dx, dz, static_cast<float*>(dh0),
                 static_cast<float*>(part_bc), static_cast<float*>(part_A),
                 static_cast<float*>(part_D), static_cast<float*>(part_bias),
                 B, S, di, dt_sb, dt_ss, x_sb, x_ss, z_sb, z_ss, b_sb, b_ss,
                 c_sb, c_ss, dy_sb, dy_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, N, G, Launch{p, st});
}

// The instantiation's resources into out[0..8) (see resources_one).
// Returns 0, or the CUDA error.
int mamba1_scan_gated_backward_resources(int N, int G, int dtype, int* out) {
  return dispatch(dtype, N, G, Resources{out});
}

const char* mamba1_scan_gated_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
