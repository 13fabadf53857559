// Mamba1 selective scan (B7) for Hopper (sm_90a), with carried state:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t      (per channel c,
//   y_t = h_t . C_t + D * x_t                               state n)
// from h0 (zeros when none is given) to hT.
// Replaces the Pallas kernel src/repro/kernels/mamba_scan/mamba_scan.py
// `_kernel` (launched by `mamba1_scan`). dt and x are (B, S, di), B_t and
// C_t (B, S, N), A (di, N), D (di,), h0 and hT (B, di, N); y is a
// contiguous (B, S, di) fp32 tensor and hT a contiguous fp32 one. dt is
// fp32; x, B and C are fp32 or bf16 (B and C share one type) and are
// widened on load, which is exact, so a bf16 activation and the bf16
// column slices of the x_proj output are read as they lie, through their
// batch and position strides (the last dim is unit-stride), and give the
// fp32 scan of the widened inputs bit for bit.
//
// Numerics, in the reference's op order: da = expf(dt * A) (IEEE expf,
// no --use_fast_math); h = da * h + (dt * x) * B with every product and
// sum rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction);
// y = sum_n h * C + D * x, the sum over n a butterfly of shuffles in a
// fixed order (lane n + N/2 onto n, then N/4, ...; the plain version
// folds halves in the same order, so on the card the two do the same
// fp32 operations). No atomics: the bits repeat from run to run, and two
// chained halves (the first half's hT as the second's h0) give bitwise
// the y and hT of one full call.
//
// What bounds it on this card. The scan reads dt and x and writes y once
// (3 x 4 B x B S di in fp32; B, C, A, D, h0 and hT are small) and takes
// B S di N exponentials. At the main path's (4, 4,096, 8,192, 16): 1.61
// GB of bytes, 0.48 ms at 3.35 TB/s, and 2.15e9 exponentials, 0.51 ms at
// the SFU rate (16 a clock per SM, CUDA C programming guide, compute
// capability 9.0, x 132 SMs x 1.98 GHz = 4.18e12/s). So the bound is the
// exponentials, with the bytes close behind. This first kernel spends
// ~30 instructions per (channel, state, step) (expf's range reduction,
// the update, the product and four shuffles) on one thread per state, so
// it is bound by instruction issue, several times above both; one thread
// per channel holding its N states in registers (no shuffles, dt and x
// loaded once) and a chunked parallel scan are later work.
//
// Design (simple and right first).
//  * One thread per (batch row, channel, state n), its h in a register
//    for the whole sequence. N in {4, 8, 16, 32} (a divisor of the warp):
//    the N lanes of a channel are adjacent lanes of one warp, and a
//    256-thread block covers 256 / N channels of one batch row.
//  * Grid (ceil(di / (256 / N)), B); channels past di (a ragged di) load
//    zeros, run the shuffles with their warp and write nothing.
//  * Time runs in chunks of 32 steps. The block stages the chunk's dt
//    and x for its channels, and B_t and C_t for its batch row, in
//    shared memory (fp32) with loads on neighbouring addresses, then
//    steps through the chunk; y is staged the same way and written out
//    once per chunk, a row of channels at a time.
//  * Lane n == 0 of a channel adds D * x to the sum and stores y.
// Templated on N and on the types of x and of B/C (fp32, bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // time steps staged at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Args {
  int B, S, di;
  long long dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss;
};

template <int N, typename TX, typename TBC>
__global__ void __launch_bounds__(kThreads)
    mamba1_scan_kernel(const float* __restrict__ dt,
                       const TX* __restrict__ x,
                       const TBC* __restrict__ Bm,
                       const TBC* __restrict__ Cm,
                       const float* __restrict__ A,
                       const float* __restrict__ Dv,
                       const float* __restrict__ h0, float* __restrict__ y,
                       float* __restrict__ hT, Args a) {
  constexpr int kChannels = kThreads / N;  // channels per block
  __shared__ float s_dt[kChunk][kChannels];
  __shared__ float s_x[kChunk][kChannels];
  __shared__ float s_y[kChunk][kChannels];
  __shared__ float s_b[kChunk][N];
  __shared__ float s_c[kChunk][N];

  const int tid = threadIdx.x;
  const int cl = tid / N;  // channel within the block
  const int n = tid % N;   // state index
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int c = c0 + cl;
  const bool valid = c < a.di;
  const long long state = (static_cast<long long>(b) * a.di + c) * N + n;

  const float av = valid ? A[static_cast<long long>(c) * N + n] : 0.f;
  const float dv = valid ? Dv[c] : 0.f;
  float h = (valid && h0 != nullptr) ? h0[state] : 0.f;

  const float* dt_b = dt + b * a.dt_sb;
  const TX* x_b = x + b * a.x_sb;
  const TBC* b_b = Bm + b * a.b_sb;
  const TBC* c_b = Cm + b * a.c_sb;
  float* y_b = y + static_cast<long long>(b) * a.S * a.di;

  for (int t0 = 0; t0 < a.S; t0 += kChunk) {
    const int steps = min(kChunk, a.S - t0);
    __syncthreads();  // the previous chunk's s_y is written out
    for (int e = tid; e < kChunk * kChannels; e += kThreads) {
      const int t = e / kChannels, ce = c0 + e % kChannels;
      const bool in = t < steps && ce < a.di;
      const long long tt = t0 + t;
      s_dt[t][e % kChannels] = in ? dt_b[tt * a.dt_ss + ce] : 0.f;
      s_x[t][e % kChannels] = in ? to_f32(x_b[tt * a.x_ss + ce]) : 0.f;
    }
    for (int e = tid; e < kChunk * N; e += kThreads) {
      const int t = e / N, ne = e % N;
      const bool in = t < steps;
      const long long tt = t0 + t;
      s_b[t][ne] = in ? to_f32(b_b[tt * a.b_ss + ne]) : 0.f;
      s_c[t][ne] = in ? to_f32(c_b[tt * a.c_ss + ne]) : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float dtv = s_dt[t][cl];
      const float xv = s_x[t][cl];
      const float da = expf(__fmul_rn(dtv, av));
      h = __fadd_rn(__fmul_rn(da, h),
                    __fmul_rn(__fmul_rn(dtv, xv), s_b[t][n]));
      float p = __fmul_rn(h, s_c[t][n]);
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
      if (n == 0) s_y[t][cl] = __fadd_rn(p, __fmul_rn(dv, xv));
    }
    __syncthreads();
    for (int e = tid; e < kChunk * kChannels; e += kThreads) {
      const int t = e / kChannels, ce = c0 + e % kChannels;
      if (t < steps && ce < a.di)
        y_b[static_cast<long long>(t0 + t) * a.di + ce] =
            s_y[t][e % kChannels];
    }
  }
  if (valid) hT[state] = h;
}

template <int N, typename TX, typename TBC>
int launch_n(const float* dt, const void* x, const void* Bm, const void* Cm,
             const float* A, const float* Dv, const float* h0, float* y,
             float* hT, const Args& a, cudaStream_t stream) {
  constexpr int kChannels = kThreads / N;
  const dim3 grid((a.di + kChannels - 1) / kChannels, a.B);
  mamba1_scan_kernel<N, TX, TBC><<<grid, kThreads, 0, stream>>>(
      dt, static_cast<const TX*>(x), static_cast<const TBC*>(Bm),
      static_cast<const TBC*>(Cm), A, Dv, h0, y, hT, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TBC>
int launch(int N, const float* dt, const void* x, const void* Bm,
           const void* Cm, const float* A, const float* Dv, const float* h0,
           float* y, float* hT, const Args& a, cudaStream_t stream) {
  switch (N) {
    case 4: return launch_n<4, TX, TBC>(dt, x, Bm, Cm, A, Dv, h0, y, hT, a,
                                        stream);
    case 8: return launch_n<8, TX, TBC>(dt, x, Bm, Cm, A, Dv, h0, y, hT, a,
                                        stream);
    case 16: return launch_n<16, TX, TBC>(dt, x, Bm, Cm, A, Dv, h0, y, hT,
                                          a, stream);
    case 32: return launch_n<32, TX, TBC>(dt, x, Bm, Cm, A, Dv, h0, y, hT,
                                          a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// y (B, S, di) and hT (B, di, N), contiguous fp32, <- the selective scan
// of dt (fp32) and x, each read through its (batch, position) element
// strides with a unit-stride last dim; B and C (B, S, N) likewise; A
// (di, N), D (di,) and h0 (B, di, N) contiguous fp32, h0 null for zeros.
// N in {4, 8, 16, 32}; x_dtype and bc_dtype 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 = launched).
int mamba1_scan_forward(const void* dt, const void* x, const void* Bm,
                        const void* Cm, const void* A, const void* Dv,
                        const void* h0, void* y, void* hT, int B, int S,
                        int di, int N, long long dt_sb, long long dt_ss,
                        long long x_sb, long long x_ss, long long b_sb,
                        long long b_ss, long long c_sb, long long c_ss,
                        int x_dtype, int bc_dtype, void* stream) {
  if (B < 1 || S < 1 || di < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{B, S, di, dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(Dv);
  const float* hf = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hTf = static_cast<float*>(hT);
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && bc_dtype == 0)
    return launch<float, float>(N, dtf, x, Bm, Cm, Af, Df, hf, yf, hTf, a,
                                st);
  if (x_dtype == 0 && bc_dtype == 1)
    return launch<float, bf16>(N, dtf, x, Bm, Cm, Af, Df, hf, yf, hTf, a,
                               st);
  if (x_dtype == 1 && bc_dtype == 0)
    return launch<bf16, float>(N, dtf, x, Bm, Cm, Af, Df, hf, yf, hTf, a,
                               st);
  if (x_dtype == 1 && bc_dtype == 1)
    return launch<bf16, bf16>(N, dtf, x, Bm, Cm, Af, Df, hf, yf, hTf, a,
                              st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mamba1_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
