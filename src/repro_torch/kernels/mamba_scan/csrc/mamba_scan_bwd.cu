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
// ops, gives the same bits for dx, dz, ddt_raw and dh0. The reductions
// are summed in another order than the plain version's (bars in
// chip_smoke.py phase 42 and the card tests).
//
// Design. One thread a (batch row, channel), its N states in registers,
// a 128-thread block over 128 neighbouring channels of one row (grid
// (ceil(di / 128), B)); no float atomics, so the results repeat bit for
// bit from run to run.
//  * Pass 1 runs the forward scan and writes the state entering every
//    TC-th step to a workspace, ckpt (B, ceil(S / TC), di, N) fp32.
//  * Pass 2 takes the chunks of TC steps from the last: the chunk's state
//    is recomputed from its checkpoint, the state entering each step kept
//    in shared memory (TC x N x 128 fp32, 64 KB), then walked backwards.
//    A chunk's per-channel values (dt_raw, x, z, dy) are loaded into
//    registers at its start, one latency a chunk; its B_t and C_t are
//    staged in shared memory as fp32 and read as broadcasts.
//  * The sums over channels: at each step a warp reduce-scatters its 32
//    lanes' N dB terms and N dC terms (butterfly: the partner's half of
//    the values is added, halving them at each xor stage), a chunk's
//    four warp sums are added in warp order, and the block writes one
//    partial (B, S, blocks, 2N) fp32. The sums over (b, t) are carried in
//    registers in reverse time and written as (B, di, N) and (B, di)
//    partials. The wrapper sums the partials' block and batch dims with
//    torch's sum (glue outside the kernel).
//
// What bounds it on this card. Per (batch, step, channel) the function
// needs N exponentials (da) and 5 more SFU operations (softplus's exp and
// log, sigma(v)'s reciprocal, sigma(z)'s exp and reciprocal), and it
// must read dt_raw, x, z, dy, B and C once and write ddt_raw, dx, dz, dB
// and dC once. At the training path's (4, 4,096, 8,192, 16) in bf16 that
// is 2.82e9 SFU operations (0.67 ms at 16 a clock per SM x 132 SMs x 1.98
// GHz) against 1.88 GB (0.56 ms at 3.35 TB/s): the SFU bound. This first
// design recomputes the forward twice (N exponentials each), spends ~30
// instructions a state-step in the walk, and moves the 1.07 GB workspace
// twice; chip_smoke.py phase 42 times it (PERF.md holds the numbers).
// Templated on N (4, 8, 16, 32) and the type of dt_raw, x, z, B, C and dy
// (fp32, bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels a block, one thread each
constexpr int kWarps = kThreads / 32;
constexpr int kStateFloats = 16384;  // the chunk's kept states: 64 KB

// steps a chunk holds: the kept states fill kStateFloats, at most 16
// steps (a chunk's per-channel values live in registers)
template <int N>
__host__ __device__ constexpr int chunk_steps() {
  return kStateFloats / (kThreads * N) < 16 ? kStateFloats / (kThreads * N)
                                            : 16;
}

template <int N>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr int TC = chunk_steps<N>();
  return sizeof(float) * (static_cast<size_t>(TC) * N * kThreads  // s_h
                          + TC * 2 * N                            // s_bc
                          + TC * kWarps * 2 * N);                 // s_red
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

// q[k] += q[k + W] for k < W, then W / 2, ... 1: the fold of halves
template <int W, int M>
__device__ __forceinline__ void fold(float (&q)[M]) {
  if constexpr (W > 0) {
#pragma unroll
    for (int k = 0; k < W; ++k) q[k] = __fadd_rn(q[k], q[k + W]);
    fold<W / 2, M>(q);
  }
}

// The butterfly reduce-scatter of V <= 32 values over a warp's 32 lanes,
// in place, from xor offset OFF down to 1: while more than one value is
// live, a lane keeps the half its OFF bit selects and adds its partner's
// copy of it; then single values are added across the remaining
// offsets. Lane l ends with v[0] = the warp's sum of value l / (32 / V),
// equal on the 32 / V lanes that share it.
template <int LIVE, int OFF, int V>
__device__ __forceinline__ void reduce_scatter(float (&v)[V], int lane) {
  if constexpr (OFF > 0) {
    if constexpr (LIVE > 1) {
      constexpr int H = LIVE / 2;
      const bool upper = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? v[i] : v[i + H];
        const float keep = upper ? v[i + H] : v[i];
        v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, OFF));
      }
      reduce_scatter<H, OFF / 2, V>(v, lane);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], OFF));
      reduce_scatter<1, OFF / 2, V>(v, lane);
    }
  }
}

// a warp's sums of V values into row[0..V): one lane writes each
template <int V>
__device__ __forceinline__ void warp_sums(float (&v)[V], int lane,
                                          float* row) {
  static_assert(V <= 32 && 32 % V == 0, "V divides a warp");
  reduce_scatter<V, 16, V>(v, lane);
  constexpr int kShare = 32 / V;  // lanes holding one sum
  if (lane % kShare == 0) row[lane / kShare] = v[0];
}

// dt = softplus(v) as the forward computes it (torch's CUDA softplus,
// threshold 20), with e = expf(v) for the gradient's sigma(v)
__device__ __forceinline__ float softplus_e(float v, float* e) {
  *e = expf(v);
  const float s = log1pf(*e);
  return v > 20.f ? v : s;
}

// the forward's state update for one step: h = da h + (dt x) B
template <int N>
__device__ __forceinline__ void forward_step(float (&h)[N],
                                             const float (&a)[N],
                                             const float* bv, float dtv,
                                             float dtx) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float da = expf(__fmul_rn(dtv, a[n]));
    h[n] = __fadd_rn(__fmul_rn(da, h[n]), __fmul_rn(dtx, bv[n]));
  }
}

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
    mamba1_scan_gated_bwd_kernel(const Params p) {
  static_assert(N <= 32 && 32 % N == 0, "N divides a warp");
  constexpr int TC = chunk_steps<N>();
  constexpr int V = 2 * N;
  extern __shared__ __align__(16) float smem[];
  float* s_h = smem;                               // [TC][N][kThreads]
  float* s_bc = s_h + TC * N * kThreads;           // [TC][2][N]
  float* s_red = s_bc + TC * V;                    // [TC][kWarps][2N]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x * kThreads + tid;
  const int b = blockIdx.y;
  const bool valid = c < p.di;
  const int cl = valid ? c : p.di - 1;  // a ragged block reads in bounds
  const long long S = p.S;
  const long long chunks = (S + TC - 1) / TC;

  float a[N];
  const long long state0 = (static_cast<long long>(b) * p.di + cl) * N;
#pragma unroll
  for (int n = 0; n < N; ++n)
    a[n] = -expf(p.A_log[static_cast<long long>(cl) * N + n]);
  const float dv = p.D[cl];
  const float bias = p.dt_bias[cl];

  const T* dt_c = static_cast<const T*>(p.dt_raw) + b * p.dt_sb + cl;
  const T* x_c = static_cast<const T*>(p.x) + b * p.x_sb + cl;
  const T* z_c = static_cast<const T*>(p.z) + b * p.z_sb + cl;
  const T* dy_c = static_cast<const T*>(p.dy) + b * p.dy_sb + cl;
  const T* b_row = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* c_row = static_cast<const T*>(p.Cm) + b * p.c_sb;
  // chunk k's checkpoint of this channel: ckpt[b][k][cl][:]
  float* ck = p.ckpt + (static_cast<long long>(b) * chunks * p.di + cl) * N;
  const long long ck_stride = static_cast<long long>(p.di) * N;

  // B_t and C_t of the chunk's steps into s_bc, as fp32 (zeros past S)
  auto stage = [&](long long t0) {
    for (int e = tid; e < TC * V; e += kThreads) {
      const int j = e / V, k = e % V;
      const long long s = t0 + j;
      float val = 0.f;
      if (s < S)
        val = widen(k < N ? b_row[s * p.b_ss + k]
                          : c_row[s * p.c_ss + (k - N)]);
      s_bc[e] = val;
    }
  };

  // ---- pass 1: the forward scan, the state entering each chunk kept
  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = p.h0 != nullptr ? p.h0[state0 + n] : 0.f;
  for (long long k = 0; k < chunks; ++k) {
    const long long t0 = k * TC;
    if (valid) {
#pragma unroll
      for (int n = 0; n < N; ++n) ck[k * ck_stride + n] = h[n];
    }
    if (k + 1 == chunks) break;  // the last chunk's end state is unused
    T r_dt[TC], r_x[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {  // whole chunk: t0 + TC < S here
      r_dt[j] = dt_c[(t0 + j) * p.dt_ss];
      r_x[j] = x_c[(t0 + j) * p.x_ss];
    }
    __syncthreads();  // the previous chunk's s_bc reads are done
    stage(t0);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      float e;
      const float dtv = softplus_e(__fadd_rn(widen(r_dt[j]), bias), &e);
      const float dtx = __fmul_rn(dtv, widen(r_x[j]));
      forward_step<N>(h, a, s_bc + j * V, dtv, dtx);
    }
  }

  // ---- pass 2: the chunks from the last, recomputed, then walked back
  float r[N], acc_a[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    r[n] = p.dhT != nullptr ? p.dhT[state0 + n] : 0.f;
    acc_a[n] = 0.f;
  }
  float acc_d = 0.f, acc_bias = 0.f;
  const long long row0 = static_cast<long long>(b) * S;
  for (long long k = chunks - 1; k >= 0; --k) {
    const long long t0 = k * TC;
    const int steps = S - t0 < TC ? static_cast<int>(S - t0) : TC;
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = ck[k * ck_stride + n];
    T r_dt[TC], r_x[TC], r_z[TC], r_dy[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const bool in = j < steps;
      r_dt[j] = in ? dt_c[(t0 + j) * p.dt_ss] : T(0.f);
      r_x[j] = in ? x_c[(t0 + j) * p.x_ss] : T(0.f);
      r_z[j] = in ? z_c[(t0 + j) * p.z_ss] : T(0.f);
      r_dy[j] = in ? dy_c[(t0 + j) * p.dy_ss] : T(0.f);
    }
    __syncthreads();  // the previous chunk's s_bc and s_red reads are done
    stage(t0);
    __syncthreads();
    // the state entering each step of the chunk, into s_h
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      if (j < steps) {
#pragma unroll
        for (int n = 0; n < N; ++n) s_h[(j * N + n) * kThreads + tid] = h[n];
        float e;
        const float dtv = softplus_e(__fadd_rn(widen(r_dt[j]), bias), &e);
        const float dtx = __fmul_rn(dtv, widen(r_x[j]));
        forward_step<N>(h, a, s_bc + j * V, dtv, dtx);
      }
    }
    // the walk back through the chunk
#pragma unroll
    for (int j = TC - 1; j >= 0; --j) {
      if (j < steps) {
        const float* bv = s_bc + j * V;
        const float* cv = bv + N;
        const float vraw = __fadd_rn(widen(r_dt[j]), bias);
        float ev;
        const float dtv = softplus_e(vraw, &ev);
        const float xv = widen(r_x[j]), zv = widen(r_z[j]);
        const float dyv = widen(r_dy[j]);
        const float dtx = __fmul_rn(dtv, xv);
        // h_t from the kept h_{t-1}; e = da h_{t-1}, its first product
        float da[N], eh[N], hn[N], q[N];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          da[n] = expf(__fmul_rn(dtv, a[n]));
          eh[n] = __fmul_rn(da[n], s_h[(j * N + n) * kThreads + tid]);
          hn[n] = __fadd_rn(eh[n], __fmul_rn(dtx, bv[n]));
          q[n] = __fmul_rn(hn[n], cv[n]);
        }
        fold<N / 2, N>(q);
        const float u = __fadd_rn(q[0], __fmul_rn(dv, xv));
        // the gate: y = u silu(z)
        const float en = expf(-zv);
        const float s = __fdiv_rn(zv, __fadd_rn(1.f, en));
        const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, en));
        const float dsilu = __fmul_rn(
            sig, __fadd_rn(1.f, __fmul_rn(zv, __fsub_rn(1.f, sig))));
        const float dys = __fmul_rn(dyv, s);
        const float dzv = __fmul_rn(__fmul_rn(dyv, u), dsilu);
        // dC_t's terms, dys h_t, summed over the warp's channels
        float red[N];
#pragma unroll
        for (int n = 0; n < N; ++n)
          red[n] = valid ? __fmul_rn(dys, hn[n]) : 0.f;
        warp_sums<N>(red, lane, s_red + (j * kWarps + warp) * V + N);
        // the adjoint of h_t
        float g[N], gb[N], w[N];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          g[n] = __fadd_rn(__fmul_rn(dys, cv[n]), r[n]);
          gb[n] = __fmul_rn(g[n], bv[n]);
          const float ge = __fmul_rn(g[n], eh[n]);
          w[n] = __fmul_rn(a[n], ge);
          acc_a[n] = __fadd_rn(acc_a[n], __fmul_rn(dtv, ge));
          red[n] = valid ? __fmul_rn(g[n], dtx) : 0.f;
          r[n] = __fmul_rn(da[n], g[n]);
        }
        warp_sums<N>(red, lane, s_red + (j * kWarps + warp) * V);
        fold<N / 2, N>(gb);
        fold<N / 2, N>(w);
        const float dxv = __fadd_rn(__fmul_rn(dys, dv), __fmul_rn(dtv, gb[0]));
        const float ddt = __fadd_rn(w[0], __fmul_rn(xv, gb[0]));
        const float sigv = __fdiv_rn(ev, __fadd_rn(ev, 1.f));
        const float ddt_raw = vraw > 20.f ? ddt : __fmul_rn(ddt, sigv);
        acc_bias = __fadd_rn(acc_bias, ddt_raw);
        acc_d = __fadd_rn(acc_d, __fmul_rn(dys, xv));
        if (valid) {
          const long long at = (row0 + t0 + j) * p.di + c;
          if (p.ddt_raw != nullptr)
            narrow(ddt_raw, static_cast<T*>(p.ddt_raw) + at);
          if (p.dx != nullptr) narrow(dxv, static_cast<T*>(p.dx) + at);
          if (p.dz != nullptr) narrow(dzv, static_cast<T*>(p.dz) + at);
        }
      }
    }
    __syncthreads();
    // the chunk's block sums of dB and dC, the warps added in order
    if (p.part_bc != nullptr) {
      for (int e = tid; e < steps * V; e += kThreads) {
        const int j = e / V, k2 = e % V;
        const float* w4 = s_red + j * kWarps * V + k2;
        float sum = w4[0];
#pragma unroll
        for (int wi = 1; wi < kWarps; ++wi) sum = __fadd_rn(sum, w4[wi * V]);
        p.part_bc[((row0 + t0 + j) * gridDim.x + blockIdx.x) * V + k2] = sum;
      }
    }
  }
  if (valid) {
    const long long pc = static_cast<long long>(b) * p.di + c;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (p.dh0 != nullptr) p.dh0[state0 + n] = r[n];
      if (p.part_A != nullptr) p.part_A[state0 + n] = acc_a[n];
    }
    if (p.part_D != nullptr) p.part_D[pc] = acc_d;
    if (p.part_bias != nullptr) p.part_bias[pc] = acc_bias;
  }
}

template <typename T, int N>
int launch_one(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<N>();
  const cudaError_t err = cudaFuncSetAttribute(
      mamba1_scan_gated_bwd_kernel<N, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.di + kThreads - 1) / kThreads, p.B);
  mamba1_scan_gated_bwd_kernel<N, T><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const Params& p, int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch_one<T, 4>(p, stream);
    case 8: return launch_one<T, 8>(p, stream);
    case 16: return launch_one<T, 16>(p, stream);
    case 32: return launch_one<T, 32>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
// contiguous. N in {4, 8, 16, 32}. Returns cudaGetLastError() after the
// launch (0 = launched).
int mamba1_scan_gated_backward(
    const void* dt_raw, const void* dt_bias, const void* x, const void* Bm,
    const void* Cm, const void* A_log, const void* Dv, const void* z,
    const void* h0, const void* dy, const void* dhT, void* ckpt,
    void* ddt_raw, void* dx, void* dz, void* dh0, void* part_bc,
    void* part_A, void* part_D, void* part_bias, int B, int S, int di, int N,
    long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
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
  if (dtype == 0) return launch_n<float>(p, N, st);
  if (dtype == 1) return launch_n<__nv_bfloat16>(p, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mamba1_scan_gated_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
