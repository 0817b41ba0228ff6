// Mamba1 selective scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// (_scan_kernel, launched by mamba_scan through pl.pallas_call) and computes
// the same function.  For batch b, channel c and state n, from h = 0:
//
//   h_t[n] = exp(dt_t[c] A[c, n]) h_{t-1}[n] + (dt_t[c] x_t[c]) B_t[n]
//   y_t[c] = sum_n h_t[n] C_t[n] + D[c] x_t[c]
//
// x, dt: (b, S, d); B, C: (b, S, N), all float32 or all bfloat16; A: (d, N)
// and D: (d,) float32; y: (b, S, d) in x's type.  The state and all
// arithmetic are float32.
//
// What bounds it on the H100: per element of x it reads x and dt, writes y
// and does N exponentials and about 4 N other operations; B and C are shared
// by all d channels.  At falcon_mamba_7b's mixer (d = 8192, N = 16) the bytes
// at the memory rate and the exponentials at the special-function units'
// rate (16 per clock per SM) take about the same time.  The loop over time
// is a recurrence and stays sequential; it needs no tensor cores.
//
// Layout of the work.  The TPU grid (b, d / bd, S / chunk) runs the chunk
// axis in order and carries the (bd, N) state in VMEM scratch between grid
// steps.  Here the state lives in registers for the whole sequence: L = 4
// consecutive lanes own one (batch, channel) and N / L of its states each,
// and add their parts of y_t with xor shuffles; consecutive channels are
// consecutive in memory.  Four lanes per channel, not one, give 4x the
// threads: at b = 1 and d = 8192 one thread per channel fills 64 blocks of
// 128 on 132 SMs, and on the card 4 lanes were faster at every shape
// measured, b = 4 and 8 included.  A chunk of TC timesteps of x and dt for
// the block's channels, and of B and C (shared by all of them), is staged
// in shared memory, and the next chunk is loaded into registers while this
// one is scanned: the loop over time then waits on no load from device
// memory.  Any S and d: channels past d keep zeros and store nothing.  exp
// is expf, not the faster __expf: the reference tolerance is 2e-4 over
// sequences of thousands of steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NTS = 128;   // threads per block
constexpr int L = 4;       // lanes per (batch, channel)
constexpr int TC = 32;     // timesteps staged in shared memory at a time

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(NTS)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ Dv,
                  T* __restrict__ y, int S, int d) {
  constexpr int NL = N / L;      // states per thread
  constexpr int CH = NTS / L;    // channels per block
  constexpr int XL = TC * CH / NTS, BL = TC * N / NTS;   // loads per thread
  static_assert(N % L == 0 && 32 % L == 0, "L lanes split N states in a warp");
  static_assert(TC * CH % NTS == 0 && TC * N % NTS == 0, "whole loads");
  __shared__ float Xs[TC][CH], Ds[TC][CH], Bs[TC][N], Cs[TC][N];

  const int tid = threadIdx.x, part = tid % L, c = tid / L;
  const int ch0 = blockIdx.x * CH, ch = ch0 + c;
  const bool live = ch < d;
  const long long row0 = (long long)blockIdx.y * S;   // row (batch, t = 0)

  // the chunk of TC timesteps at t0 into registers: x and dt for the
  // block's channels, B and C; past S or d, zeros
  float rx[XL], rd[XL], rb[BL], rc[BL];
  auto load = [&](int t0) {
#pragma unroll
    for (int r = 0; r < XL; ++r) {
      const int i = tid + r * NTS, t = i / CH, cc = ch0 + i % CH;
      const bool in = t0 + t < S && cc < d;
      const long long g = (row0 + t0 + t) * d + cc;
      rx[r] = in ? to_f(x[g]) : 0.f;
      rd[r] = in ? to_f(dt[g]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < BL; ++r) {
      const int i = tid + r * NTS;
      const bool in = t0 + i / N < S;
      const long long g = (row0 + t0) * N + i;
      rb[r] = in ? to_f(Bm[g]) : 0.f;
      rc[r] = in ? to_f(Cm[g]) : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int r = 0; r < XL; ++r) {
      const int i = tid + r * NTS;
      Xs[i / CH][i % CH] = rx[r];
      Ds[i / CH][i % CH] = rd[r];
    }
#pragma unroll
    for (int r = 0; r < BL; ++r) {
      const int i = tid + r * NTS;
      Bs[i / N][i % N] = rb[r];
      Cs[i / N][i % N] = rc[r];
    }
  };

  float a[NL], h[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    a[j] = live ? A[(long long)ch * N + part * NL + j] : 0.f;
    h[j] = 0.f;
  }
  const float dv = live ? Dv[ch] : 0.f;

  load(0);
  store();
  __syncthreads();
  for (int t0 = 0; t0 < S; t0 += TC) {
    const bool more = t0 + TC < S;
    if (more) load(t0 + TC);     // in flight while this chunk is scanned
    const int tn = min(TC, S - t0);
#pragma unroll 4
    for (int t = 0; t < tn; ++t) {
      const float xv = Xs[t][c], dtv = Ds[t][c], dx = dtv * xv;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const int n = part * NL + j;
        h[j] = expf(dtv * a[j]) * h[j] + dx * Bs[t][n];
        acc += h[j] * Cs[t][n];
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (live && part == 0)
        y[(row0 + t0 + t) * d + ch] = from_f<T>(acc + dv * xv);
    }
    __syncthreads();             // every thread is done with this chunk
    if (more) {
      store();
      __syncthreads();
    }
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* dt, const void* B,
                   const void* C, const float* A, const float* D, void* y,
                   int b, int S, int d, cudaStream_t stream) {
  constexpr int CH = NTS / L;
  const dim3 grid((d + CH - 1) / CH, b);
  mamba_scan_kernel<T, N><<<grid, NTS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const T*>(B), static_cast<const T*>(C), A, D,
      static_cast<T*>(y), S, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(int N, const void* x, const void* dt, const void* B,
                     const void* C, const float* A, const float* D, void* y,
                     int b, int S, int d, cudaStream_t st) {
  if (N == 8) return launch<T, 8>(x, dt, B, C, A, D, y, b, S, d, st);
  if (N == 16) return launch<T, 16>(x, dt, B, C, A, D, y, b, S, d, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, dt: (b, S, d); B, C: (b, S, N); y: (b, S, d), all contiguous and of one
// type: dtype 0 is float32, 1 is bfloat16.  A: (d, N) and D: (d,) float32,
// contiguous.  N is 8 or 16.  b, S, d >= 1.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const void* B,
                              const void* C, const void* A, const void* D,
                              void* y, int b, int S, int d, int N, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || S < 1 || d < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  if (dtype == 0)
    return (int)launch_n<float>(N, x, dt, B, C, Af, Df, y, b, S, d, st);
  if (dtype == 1)
    return (int)launch_n<__nv_bfloat16>(N, x, dt, B, C, Af, Df, y, b, S, d,
                                        st);
  return (int)cudaErrorInvalidValue;
}
