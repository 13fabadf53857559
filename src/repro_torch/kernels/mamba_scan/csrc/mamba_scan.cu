// Mamba1 selective scan (B7) for Hopper (sm_90a), with carried state:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t      (per channel c,
//   y_t = h_t . C_t + D * x_t                               state n)
// from h0 (zeros when none is given) to hT.
// Replaces the Pallas kernel src/repro/kernels/mamba_scan/mamba_scan.py
// `_kernel` (launched by `mamba1_scan`). dt, x (and z) are (B, S, di),
// B_t and C_t (B, S, N), A (di, N), D (di,), h0 and hT (B, di, N). x, B
// and C share one type, fp32 or bf16, widened (exactly) before use; every
// (B, S, .) operand is read through its batch and position strides with
// a unit-stride last dim, so a bf16 activation, the column slices of the
// x_proj output and the z half of the in_proj output go as they lie.
//
// Two modes of one kernel, chosen at compile time:
//  * the reference's contract: dt fp32 (after softplus), A given, y the
//    fp32 scan output;
//  * gated (the model's composition around the scan, fused): dt_raw in
//    x's type, dt = softplus(dt_raw + dt_bias) as torch's CUDA softplus
//    computes it (beta 1, threshold 20: v > 20 ? v : log1pf(expf(v))),
//    A = -expf(A_log) once per thread, and
//    y = round_to_x_type(y_scan * silu(z)) with silu(u) =
//    u / (1 + expf(-u)) (IEEE division), torch's silu. y is written in
//    x's type: dt, the ungated y and silu(z) never reach device memory.
//
// Numerics, in the reference's op order: da = expf(dt * A) (IEEE expf,
// no --use_fast_math); h = da * h + (dt * x) * B with every product and
// sum rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction);
// y = sum_n h * C + D * x, the sum over n folded in halves (state n + N/2
// onto n, then N/4, ...), the plain version's order (ref.py _fold_sum).
// Each state's recurrence runs in time order, so the bits do not depend
// on the thread layout: they repeat from run to run, two chained halves
// (the first half's hT as the second's h0) give the y and hT of one full
// call, and decode at S = 1 from the carried state continues a prefill.
//
// Design.
//  * G threads per (batch row, channel), G in {1, 2, 4},
//    picked by the wrapper from B * di and S so the grid fills the card.
//    Thread g of a channel holds the M = N / G states {g, g + G, g + 2G,
//    ...} and their A in registers for the whole sequence. The sum over n
//    folds the thread's own registers first (k + M/2 onto k, ...: states
//    n + N/2 onto n down to n + G onto n), then log2(G) xor shuffles (G/2,
//    ..., 1) finish the fold; every lane of the channel ends with the same
//    sum, and lane g = 0 writes y.
//  * The G lanes of a channel are adjacent, a 128-thread block covers
//    128 / G neighbouring channels of one batch row: a warp's loads of
//    dt, x and z at one step are one coalesced row segment. Time runs in
//    straight-line groups of K steps (4 for M >= 8, else 8); each group's
//    dt, x and z are loaded once per step per channel (not per state) a
//    whole group ahead, and kept as loaded until used (widening a bf16
//    value right after its load would wait for the load).
//  * The gated mode's softplus and silu are computed once per (channel,
//    step) at the head of each group, split over the G lanes (lane g
//    takes steps g, g + G, ...) and swapped by shuffles.
//  * B_t and C_t are the same for every channel of a row: the block
//    stages kChunk steps of them in shared memory as fp32, thread g's M
//    states contiguous, and reads them as broadcast float4s. The next
//    chunk's rows are asked into L2 while the current one is scanned and
//    staged after it, one barrier a chunk.
//  * Channels past di (a ragged di) read the last channel's values, take
//    part in the shuffles and write nothing.
//
// What bounds it on this card. Per (batch, step, channel) the scan takes
// N exponentials (the gated mode 4 more SFU operations: softplus's exp
// and log, silu's exp and the reciprocal of its division) and moves the
// per-channel values once. At the main path's (4, 4,096, 8,192, 16) in
// bf16 the contract mode moves 1.35 GB (0.40 ms at 3.35 TB/s) and takes
// 2.15e9 exponentials (0.51 ms at 16 a clock per SM x 132 SMs x 1.98
// GHz); the gated mode moves 1.08 GB (0.32 ms) and takes 2.68e9 SFU
// operations (0.64 ms). Both are held to that SFU bound. What the kernel
// pays is instruction issue: IEEE expf is 8 instructions (1 on the SFU),
// and the straight-line block of one group (4 steps x 16 states, G = 1)
// is 956 instructions, 14.9 per (channel, state, step), from
// cuobjdump -sass (chip_smoke.py phase 20 prints it for every G). G = 1
// at (4, 4,096) [B di = 32,768], G = 4 at (1, 32,768) [8,192], G = 2 at
// the decode step (4, 1), as phase 20's timing of every G chose (PERF.md
// holds the times).
// Templated on N, G, the mode and the type of x, B and C (fp32, bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>


namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;  // steps of B_t and C_t staged at once

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float v, float* out) { *out = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

struct Params {
  const void* dt;     // fp32 dt (contract mode) or dt_raw (gated, x's type)
  const void* x;
  const void* z;      // gated mode only
  const void* Bm;
  const void* Cm;
  const float* A;     // A (contract mode) or A_log (gated), (di, N)
  const float* D;
  const float* dt_bias;  // gated mode only
  const float* h0;    // null for zeros
  void* y;            // (B, S, di) contiguous: fp32, or x's type if gated
  float* hT;          // (B, di, N) contiguous
  int B, S, di;
  long long dt_sb, dt_ss, x_sb, x_ss, z_sb, z_ss, b_sb, b_ss, c_sb, c_ss;
};

// M consecutive floats of shared memory into registers, as float4s where
// the count allows (the source is 16-byte aligned then)
template <int M>
__device__ __forceinline__ void load_row(const float* src, float (&dst)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int k = 0; k < M; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + k);
      dst[k] = v.x;
      dst[k + 1] = v.y;
      dst[k + 2] = v.z;
      dst[k + 3] = v.w;
    }
  } else if constexpr (M == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < M; ++k) dst[k] = src[k];
  }
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

// torch's CUDA softplus (beta 1, threshold 20) and silu, in fp32; both
// sides of softplus's select are computed, so no branch splits the scan
__device__ __forceinline__ float softplus(float v) {
  const float e = log1pf(expf(v));
  return v > 20.f ? v : e;
}
__device__ __forceinline__ float silu(float u) {
  return __fdiv_rn(u, __fadd_rn(1.f, expf(-u)));
}

// The gated mode's per-channel values of a group of K steps: dt =
// softplus(dt_raw + bias) and silu(z), in place. With G lanes on a
// channel, lane g computes steps g, g + G, ... and the lanes swap them
// by shuffles, so no lane repeats another's work.
template <int G, int K>
__device__ __forceinline__ void gate_prologue(float (&dt)[K], float (&z)[K],
                                              float bias, int g) {
  static_assert(K % G == 0, "a group's steps split evenly over the lanes");
  if constexpr (G == 1) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      dt[j] = softplus(__fadd_rn(dt[j], bias));
      z[j] = silu(z[j]);
    }
  } else {
    constexpr int kOwn = K / G;
    float od[kOwn], oz[kOwn];
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      float vd = dt[i * G], vz = z[i * G];
#pragma unroll
      for (int l = 1; l < G; ++l) {
        if (g == l) {
          vd = dt[i * G + l];
          vz = z[i * G + l];
        }
      }
      od[i] = softplus(__fadd_rn(vd, bias));
      oz[i] = silu(vz);
    }
    const int base = (threadIdx.x & 31) & ~(G - 1);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      dt[j] = __shfl_sync(0xffffffffu, od[j / G], base + j % G);
      z[j] = __shfl_sync(0xffffffffu, oz[j / G], base + j % G);
    }
  }
}

// One step of one thread: its M states of one channel, and y when
// ``store``; dtv is dt after softplus, gate silu(z) (gated mode). bc
// points at the step's staged row (B then C, N each).
template <int N, int G, bool kGated, typename TY>
__device__ __forceinline__ void scan_step(float (&h)[N / G],
                                          const float (&a)[N / G],
                                          const float* bc, int g, float dtv,
                                          float xv, float gate, float dv,
                                          TY* y, bool store) {
  constexpr int M = N / G;
  const float dtx = __fmul_rn(dtv, xv);
  float bv[M], cv[M], q[M];
  load_row<M>(bc + g * M, bv);
  load_row<M>(bc + N + g * M, cv);
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float da = expf(__fmul_rn(dtv, a[k]));
    h[k] = __fadd_rn(__fmul_rn(da, h[k]), __fmul_rn(dtx, bv[k]));
    q[k] = __fmul_rn(h[k], cv[k]);
  }
  fold<M / 2, M>(q);
  float yv = __fadd_rn(lane_fold<G / 2>(q[0]), __fmul_rn(dv, xv));
  if constexpr (kGated) yv = __fmul_rn(yv, gate);
  if (store) narrow(yv, y);
}

// steps scanned as one straight-line group, and loaded one group ahead:
// more when a thread holds few states, so the loads have time to land
template <int M>
__host__ __device__ constexpr int group_steps() {
  return M >= 8 ? 4 : 8;
}

// blocks an SM must hold at once: G > 1 is picked for grids of ~4
// blocks an SM, so its registers are capped at 128 a thread
template <int G>
__host__ __device__ constexpr int min_blocks() {
  return G == 1 ? 1 : 4;
}

template <int N, int G, bool kGated, typename T>
__global__ void __launch_bounds__(kThreads, min_blocks<G>())
    mamba1_scan_kernel(const Params p) {
  static_assert(N % G == 0 && 32 % G == 0, "G lanes share a channel");
  constexpr int M = N / G;                 // states a thread holds
  constexpr int kChannels = kThreads / G;  // channels a block covers
  constexpr int K = group_steps<M>();
  static_assert(kChunk % K == 0, "a group must not straddle two chunks");
  constexpr int kStage = kChunk * 2 * N / kThreads;  // staged per thread
  static_assert(kChunk * 2 * N % kThreads == 0, "whole staging rounds");
  using TDT = typename std::conditional<kGated, T, float>::type;
  using TY = typename std::conditional<kGated, T, float>::type;
  // [buffer][step][B or C][g * M + k] = state g + G k of that step
  __shared__ __align__(16) float s_bc[2][kChunk][2][N];

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int c = blockIdx.x * kChannels + tid / G;
  const int b = blockIdx.y;
  const bool valid = c < p.di;
  const int cl = valid ? c : p.di - 1;  // a ragged block reads in bounds
  const bool store = valid && g == 0;
  const long long S = p.S;

  float a[M], h[M];
  const long long state0 = (static_cast<long long>(b) * p.di + cl) * N;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const int n = g + G * k;
    const float av = p.A[static_cast<long long>(cl) * N + n];
    a[k] = kGated ? -expf(av) : av;
    h[k] = p.h0 != nullptr ? p.h0[state0 + n] : 0.f;
  }
  const float dv = p.D[cl];
  const float bias = kGated ? p.dt_bias[cl] : 0.f;

  // the per-channel streams, each pointing at the next step to load
  const TDT* dt_c = static_cast<const TDT*>(p.dt) + b * p.dt_sb + cl;
  const T* x_c = static_cast<const T*>(p.x) + b * p.x_sb + cl;
  const T* z_c = kGated ? static_cast<const T*>(p.z) + b * p.z_sb + cl
                        : nullptr;
  TY* y_c = static_cast<TY*>(p.y) + static_cast<long long>(b) * S * p.di + c;
  const T* b_row = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* c_row = static_cast<const T*>(p.Cm) + b * p.c_sb;

  // the per-channel values of the next group: r_*[j] = step s0 + j, kept
  // as loaded (a widening right after the load would wait for it)
  TDT r_dt[K];
  T r_x[K], r_z[K];
  auto load_group = [&](long long s0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool in = s0 + j < S;
      r_dt[j] = in ? *dt_c : TDT(0.f);
      r_x[j] = in ? *x_c : T(0.f);
      r_z[j] = (kGated && in) ? *z_c : T(0.f);
      dt_c += p.dt_ss;
      x_c += p.x_ss;
      if (kGated) z_c += p.z_ss;
    }
  };
  load_group(0);

  // B_t and C_t of steps [t0, t0 + kChunk) into buffer buf: thread tid
  // stages the values e = tid + i kThreads, e = (step, B or C, state),
  // neighbouring threads on neighbouring states of one row (L2 hits:
  // ``prefetch`` asked for the rows while the chunk before was scanned)
  auto stage = [&](long long t0, int buf) {
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int e = tid + i * kThreads;
      const int t = e / (2 * N), j = e % (2 * N);
      const int n = j % N;
      const long long s = t0 + t;
      float v = 0.f;
      if (s < S)
        v = widen(j < N ? b_row[s * p.b_ss + j]
                        : c_row[s * p.c_ss + (j - N)]);
      s_bc[buf][t][j / N][(n % G) * M + n / G] = v;
    }
  };
  // one thread a row of B and of C; no registers held
  auto prefetch = [&](long long t0) {
    const long long s = t0 + tid;
    if (tid < kChunk && s < S) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(b_row + s * p.b_ss));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(c_row + s * p.c_ss));
    }
  };

  stage(0, 0);
  __syncthreads();
  int buf = 0;
  for (long long t0 = 0; t0 < S; t0 += kChunk) {
    const bool more = t0 + kChunk < S;
    if (more) prefetch(t0 + kChunk);
    const int steps = S - t0 < kChunk ? static_cast<int>(S - t0) : kChunk;
    for (int t = 0; t < steps; t += K) {
      float v_dt[K], v_x[K], v_z[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        v_dt[j] = widen(r_dt[j]);
        v_x[j] = widen(r_x[j]);
        v_z[j] = widen(r_z[j]);
      }
      const long long s0 = t0 + t;
      if (s0 + 2 * K <= S) {  // the next group is whole: load it as such
#pragma unroll
        for (int j = 0; j < K; ++j) {
          r_dt[j] = *dt_c;
          r_x[j] = *x_c;
          if (kGated) r_z[j] = *z_c;
          dt_c += p.dt_ss;
          x_c += p.x_ss;
          if (kGated) z_c += p.z_ss;
        }
      } else {
        load_group(s0 + K);
      }
      if constexpr (kGated) gate_prologue<G, K>(v_dt, v_z, bias, g);
      if (t + K <= steps) {  // a whole group: K steps, straight-line
#pragma unroll
        for (int j = 0; j < K; ++j)
          scan_step<N, G, kGated, TY>(h, a, &s_bc[buf][t + j][0][0], g,
                                      v_dt[j], v_x[j], v_z[j], dv,
                                      y_c + j * p.di, store);
      } else {  // the sequence's last steps
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (t + j < steps)
            scan_step<N, G, kGated, TY>(h, a, &s_bc[buf][t + j][0][0], g,
                                        v_dt[j], v_x[j], v_z[j], dv,
                                        y_c + j * p.di, store);
      }
      y_c += K * p.di;
    }
    if (more) stage(t0 + kChunk, buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  if (valid) {
#pragma unroll
    for (int k = 0; k < M; ++k) p.hT[state0 + g + G * k] = h[k];
  }
}

template <bool kGated, typename T, int N, int G>
int launch_one(const Params& p, cudaStream_t stream) {
  constexpr int kChannels = kThreads / G;
  const dim3 grid((p.di + kChannels - 1) / kChannels, p.B);
  mamba1_scan_kernel<N, G, kGated, T><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kGated, typename T, int N>
int launch_g(const Params& p, int G, cudaStream_t stream) {
  switch (G) {
    case 1: return launch_one<kGated, T, N, 1>(p, stream);
    case 2: return launch_one<kGated, T, N, 2>(p, stream);
    case 4: return launch_one<kGated, T, N, 4>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kGated, typename T>
int launch_n(const Params& p, int N, int G, cudaStream_t stream) {
  switch (N) {
    case 4: return launch_g<kGated, T, 4>(p, G, stream);
    case 8: return launch_g<kGated, T, 8>(p, G, stream);
    case 16: return launch_g<kGated, T, 16>(p, G, stream);
    case 32: return launch_g<kGated, T, 32>(p, G, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kGated>
int launch(const Params& p, int N, int G, int dtype, void* stream) {
  if (p.B < 1 || p.S < 1 || p.di < 1 || p.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_n<kGated, float>(p, N, G, st);
  if (dtype == 1) return launch_n<kGated, __nv_bfloat16>(p, N, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The reference's contract. y (B, S, di) and hT (B, di, N), contiguous
// fp32, <- the selective scan of dt (fp32) and x, each read through its
// (batch, position) element strides with a unit-stride last dim; B and C
// (B, S, N) likewise; A (di, N), D (di,) and h0 (B, di, N) contiguous
// fp32, h0 null for zeros. x, B and C share one type: dtype 0 = float32,
// 1 = bfloat16. N in {4, 8, 16, 32}, G (threads per channel) in {1, 2,
// 4}. Returns cudaGetLastError() after the launch (0 = launched).
int mamba1_scan_forward(const void* dt, const void* x, const void* Bm,
                        const void* Cm, const void* A, const void* Dv,
                        const void* h0, void* y, void* hT, int B, int S,
                        int di, int N, int G, long long dt_sb,
                        long long dt_ss, long long x_sb, long long x_ss,
                        long long b_sb, long long b_ss, long long c_sb,
                        long long c_ss, int dtype, void* stream) {
  const Params p{dt, x, nullptr, Bm, Cm, static_cast<const float*>(A),
                 static_cast<const float*>(Dv), nullptr,
                 static_cast<const float*>(h0), y, static_cast<float*>(hT),
                 B, S, di, dt_sb, dt_ss, x_sb, x_ss, 0, 0, b_sb, b_ss, c_sb,
                 c_ss};
  return launch<false>(p, N, G, dtype, stream);
}

// The gated mode. y (B, S, di) contiguous in x's type and hT (B, di, N)
// contiguous fp32 <- silu(z) * the selective scan of softplus(dt_raw +
// dt_bias) and x with A = -exp(A_log). dt_raw, x, z, B and C share one
// type (dtype as above) and are read through their (batch, position)
// strides; dt_bias (di,), A_log (di, N), D (di,) and h0 contiguous fp32,
// h0 null for zeros. Returns cudaGetLastError() after the launch.
int mamba1_scan_gated_forward(
    const void* dt_raw, const void* dt_bias, const void* x, const void* Bm,
    const void* Cm, const void* A_log, const void* Dv, const void* z,
    const void* h0, void* y, void* hT, int B, int S, int di, int N, int G,
    long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
    long long z_sb, long long z_ss, long long b_sb, long long b_ss,
    long long c_sb, long long c_ss, int dtype, void* stream) {
  const Params p{dt_raw, x, z, Bm, Cm, static_cast<const float*>(A_log),
                 static_cast<const float*>(Dv),
                 static_cast<const float*>(dt_bias),
                 static_cast<const float*>(h0), y, static_cast<float*>(hT),
                 B, S, di, dt_sb, dt_ss, x_sb, x_ss, z_sb, z_ss, b_sb, b_ss,
                 c_sb, c_ss};
  return launch<true>(p, N, G, dtype, stream);
}

const char* mamba1_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
