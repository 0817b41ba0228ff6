// Mamba1 selective scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan.py
// (_scan_kernel, launched by mamba_scan through pl.pallas_call) and computes
// the same function.  For batch b, channel c and state n, from h_0 = h0
// (zeros where no h0 is given):
//
//   h_t[n] = exp(dt_t[c] A[c, n]) h_{t-1}[n] + (dt_t[c] x_t[c]) B_t[n]
//   y_t[c] = sum_n h_t[n] C_t[n] + D[c] x_t[c]
//
// x, dt: (b, S, d); B, C: (b, S, N), all float32 or all bfloat16; A: (d, N)
// and D: (d,) float32; y: (b, S, d) in x's type.  The state and all
// arithmetic are float32.  Beyond the Pallas kernel, which starts from zeros
// and returns y only, it takes a starting state h0 and returns the final
// state h_S (hT), each (b, d, N) float32 and each optional, as the model's
// mamba1_forward does: a prompt's state carries into decode.
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
// consecutive lanes own one (batch, channel) and N / L of its states each;
// consecutive channels are consecutive in memory (L = 2 was slower at every
// shape measured, PERF.md).  Several lanes per
// channel, not one, give L times the threads: at b = 1 and d = 8192 one
// thread per channel fills 64 blocks of 128 on 132 SMs.  A chunk of TC
// timesteps of x and dt for the block's channels, and of B and C (shared by
// all of them), is staged in shared memory, and the next chunk is loaded
// into registers while this one is scanned: the loop over time then waits
// on no load from device memory.  Each lane writes its part of y_t to
// shared memory; after the chunk, the block sums the L parts of each
// (t, channel) and stores y along the channels.  The block's channels (bd,
// L bd threads) and the chunk's timesteps (chunk) are the caller's to pick,
// as the reference's bd and chunk are: bd and chunk each 16, 32 or 64,
// (32, 32) by default; any other pair is refused, never replaced.  A block
// whose staging needs more than 48 KB (bd 64 with chunk 32 or 64, bd 32
// with chunk 64) takes it as dynamic shared memory.  Any S and d: channels
// past d keep zeros and store nothing; steps past S see x = dt = 0, which keeps
// the state, and store nothing.  The state enters the registers from h0
// before the first chunk and leaves them for hT after the last, so the loop
// over time is the same with or without them (its schedule is not: see the
// note where h0 is loaded).
//
// The state step.  The loop over time is bound by instruction issue and by
// the exponentials, not by memory.  The step's decay exp(dt A) is
// 2^(dt A log2 e) on the special-function unit (ex2.approx, about 2 ulp),
// with A scaled by log2 e once, where it is loaded: the precise expf it
// replaces added a range reduction to each state step.  Scaling A adds one
// float rounding to the exponent's argument, about 1e-6 relative at |dt A|
// near 13; the decayed terms shrink, so the error does not grow along the
// sequence (held at the reference tolerance 2e-4 over 2048 steps on the
// card and in tests/test_torch_mamba_scan.py).  The .ftz form flushes a
// decay below 2^-126 to zero: such a term weighs less than 1e-38 of the
// state, and the form without .ftz costs extra instructions to rescale
// subnormal results.  A lane reads its N / L consecutive values of B_t and
// C_t as float4 (or float2) vectors, and y_t leaves the loop as one shared
// store, with no shuffles and no device-memory store.  At L = 4 and N = 16
// the loop is 29 SASS instructions a (thread, timestep) against 77.75 with
// expf, shuffles and per-step stores (PERF.md, counted by chip_smoke.py):
// 4 exponentials, 18 multiplies and FMAs, 5 shared-memory accesses, 2 of
// loop control.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int L = 4;       // lanes per (batch, channel)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// NL consecutive floats of shared memory at p (16-byte aligned for NL % 4
// == 0, 8-byte for NL == 2) in vector reads
template <int NL>
__device__ __forceinline__ void read_vec(const float* p, float (&v)[NL]) {
  if constexpr (NL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NL / 4; ++i) {
      const float4 w = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = w.x;
      v[4 * i + 1] = w.y;
      v[4 * i + 2] = w.z;
      v[4 * i + 3] = w.w;
    }
  } else {
    static_assert(NL == 2, "N / L states a lane: 2 or a multiple of 4");
    const float2 w = *reinterpret_cast<const float2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A chunk of TC timesteps staged for CH channels: x, dt, B and C, and
// Ps[t][tid], each lane's part of y_t (lane part 0's holds D x_t too)
template <int N, int CH, int TC> struct Staged {
  static constexpr int NTS = L * CH;   // threads per block
  float Xs[TC][CH], Ds[TC][CH], Bs[TC][N], Cs[TC][N], Ps[TC][NTS];
  static constexpr bool DYNAMIC = sizeof(float) * TC * (2 * CH + 2 * N + NTS)
                                  > 48 * 1024;
};

// The scan of one block over the staged arrays it is given
template <typename T, int N, int CH, int TC>
__device__ __forceinline__ void scan_block(
    float (&Xs)[TC][CH], float (&Ds)[TC][CH], float (&Bs)[TC][N],
    float (&Cs)[TC][N], float (&Ps)[TC][L * CH], const T* __restrict__ x,
    const T* __restrict__ dt, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ A,
    const float* __restrict__ Dv, const float* __restrict__ h0,
    T* __restrict__ y, float* __restrict__ hT, int S, int d) {
  constexpr int NTS = L * CH;    // threads per block
  constexpr int NL = N / L;      // states per thread
  // loads per thread: x and dt exactly, B and C rounded up (the last
  // round's threads past TC * N load nothing where NTS does not divide it)
  constexpr int XL = TC * CH / NTS, BL = (TC * N + NTS - 1) / NTS;
  constexpr bool B_WHOLE = TC * N % NTS == 0;
  static_assert(N % L == 0 && 32 % L == 0, "L lanes split N states in a warp");
  static_assert(TC * CH % NTS == 0, "whole loads of x and dt");

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
      if (!B_WHOLE && i >= TC * N) break;
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
      if (!B_WHOLE && i >= TC * N) break;
      Bs[i / N][i % N] = rb[r];
      Cs[i / N][i % N] = rc[r];
    }
  };

  // this lane's N / L states of (batch, channel) in h0 and hT
  const long long hs = ((long long)blockIdx.y * d + ch) * N + part * NL;
  float a2[NL], h[NL];   // a2: A log2 e
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    a2[j] = live ? A[(long long)ch * N + part * NL + j] * LOG2E : 0.f;
    h[j] = 0.f;
  }
  const float dv = live && part == 0 ? Dv[ch] : 0.f;
  // h0 in a branch of its own: as a select in the loop above
  // (h = h0 ? h0[...] : 0), ptxas scheduled the loop over time's
  // exponentials later and the scan took 22% longer, with or without h0
  // (PERF.md)
  if (live && h0) {
#pragma unroll
    for (int j = 0; j < NL; ++j) h[j] = __ldg(h0 + hs + j);
  }

  load(0);
  store();
  __syncthreads();
  for (int t0 = 0; t0 < S; t0 += TC) {
    const bool more = t0 + TC < S;
    if (more) load(t0 + TC);     // in flight while this chunk is scanned
    // every step of the chunk: past S, x = dt = 0 keeps h and y is not
    // stored
#pragma unroll 4
    for (int t = 0; t < TC; ++t) {
      const float xv = Xs[t][c], dtv = Ds[t][c], dx = dtv * xv;
      float bv[NL], cv[NL], acc = dv * xv;
      read_vec<NL>(&Bs[t][part * NL], bv);
      read_vec<NL>(&Cs[t][part * NL], cv);
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        h[j] = ex2(dtv * a2[j]) * h[j] + dx * bv[j];
        acc += h[j] * cv[j];
      }
      Ps[t][tid] = acc;
    }
    __syncthreads();             // every thread is done with this chunk
    // y of the chunk: thread tid sums the L parts of channel ch0 + tid % CH
    // at steps tid / CH + (NTS / CH) r, stored along the channels
#pragma unroll
    for (int r = 0; r < XL; ++r) {
      const int i = tid + r * NTS, t = i / CH, cc = i % CH;
      float part_y[L];
      read_vec<L>(&Ps[t][cc * L], part_y);
      float yv = 0.f;
#pragma unroll
      for (int p = 0; p < L; ++p) yv += part_y[p];
      if (t0 + t < S && ch0 + cc < d)
        y[(row0 + t0 + t) * d + ch0 + cc] = from_f<T>(yv);
    }
    if (more) store();
    __syncthreads();             // Ps is read; the next chunk is staged
  }
  if (live && hT) {
#pragma unroll
    for (int j = 0; j < NL; ++j) hT[hs + j] = h[j];
  }
}

// The staged arrays: static shared memory where they fit its 48 KB, as the
// default tile's always did (the loop over time's schedule is sensitive to
// how they are addressed: see the note where h0 is loaded), else dynamic
template <typename T, int N, int CH, int TC>
__global__ void __launch_bounds__(L * CH)
mamba_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ A, const float* __restrict__ Dv,
                  const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ hT, int S, int d) {
  using Sm = Staged<N, CH, TC>;
  if constexpr (Sm::DYNAMIC) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Sm& sm = *reinterpret_cast<Sm*>(smem_raw);
    scan_block<T, N, CH, TC>(sm.Xs, sm.Ds, sm.Bs, sm.Cs, sm.Ps, x, dt, Bm,
                             Cm, A, Dv, h0, y, hT, S, d);
  } else {
    __shared__ __align__(16) float Xs[TC][CH], Ds[TC][CH], Bs[TC][N],
        Cs[TC][N], Ps[TC][L * CH];
    scan_block<T, N, CH, TC>(Xs, Ds, Bs, Cs, Ps, x, dt, Bm, Cm, A, Dv, h0, y,
                             hT, S, d);
  }
}

// A call of mamba_scan_fwd, its tile resolved
struct Args {
  const void *x, *dt, *B, *C;
  const float *A, *D, *h0;
  void* y;
  float* hT;
  int b, S, d;
  cudaStream_t stream;
};

template <typename T, int N, int CH, int TC>
cudaError_t launch(const Args& a) {
  using Sm = Staged<N, CH, TC>;
  auto kernel = mamba_scan_kernel<T, N, CH, TC>;
  const size_t smem = Sm::DYNAMIC ? sizeof(Sm) : 0;
  if (Sm::DYNAMIC) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.d + CH - 1) / CH, a.b);
  kernel<<<grid, Sm::NTS, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dt),
      static_cast<const T*>(a.B), static_cast<const T*>(a.C), a.A, a.D, a.h0,
      static_cast<T*>(a.y), a.hT, a.S, a.d);
  return cudaGetLastError();
}

// calls f(T, N, CH, TC as integral constants) for the instance of dtype
// (0 float32, 1 bfloat16), N and the tile (bd, chunk); (0, 0) is the
// default (32, 32); cudaErrorInvalidValue for any other
template <typename F>
cudaError_t with_instance(int dtype, int N, int bd, int chunk, F&& f) {
  if (bd == 0 && chunk == 0) bd = chunk = 32;
  auto tile = [&](auto t, auto n) -> cudaError_t {
#define SCAN_TILE(CH_, TC_)                            \
  if (bd == CH_ && chunk == TC_)                       \
    return f(t, n, std::integral_constant<int, CH_>{}, \
             std::integral_constant<int, TC_>{});
    SCAN_TILE(16, 16) SCAN_TILE(16, 32) SCAN_TILE(16, 64)
    SCAN_TILE(32, 16) SCAN_TILE(32, 32) SCAN_TILE(32, 64)
    SCAN_TILE(64, 16) SCAN_TILE(64, 32) SCAN_TILE(64, 64)
#undef SCAN_TILE
    return cudaErrorInvalidValue;
  };
  auto state = [&](auto t) -> cudaError_t {
    if (N == 8) return tile(t, std::integral_constant<int, 8>{});
    if (N == 16) return tile(t, std::integral_constant<int, 16>{});
    return cudaErrorInvalidValue;
  };
  if (dtype == 0) return state(float{});
  if (dtype == 1) return state(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

}  // namespace

// x, dt: (b, S, d); B, C: (b, S, N); y: (b, S, d), all contiguous and of one
// type: dtype 0 is float32, 1 is bfloat16.  A: (d, N) and D: (d,) float32,
// contiguous.  h0 (the starting state) and hT (the final state): (b, d, N)
// float32, contiguous, each null where it is not wanted (h0 null: the state
// starts at zeros).  N is 8 or 16.  b, S, d >= 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mamba_scan_fwd(const void* x, const void* dt, const void* B,
                              const void* C, const void* A, const void* D,
                              const void* h0, void* y, void* hT, int b, int S,
                              int d, int N, int dtype, int bd, int chunk,
                              void* stream) {
  if (b < 1 || S < 1 || d < 1 || b > 65535) return (int)cudaErrorInvalidValue;
  const Args a{x, dt, B, C, static_cast<const float*>(A),
               static_cast<const float*>(D), static_cast<const float*>(h0), y,
               static_cast<float*>(hT), b, S, d,
               static_cast<cudaStream_t>(stream)};
  return (int)with_instance(dtype, N, bd, chunk,
                            [&](auto t, auto n, auto ch, auto tc) {
    return launch<decltype(t), decltype(n)::value, decltype(ch)::value,
                  decltype(tc)::value>(a);
  });
}

// The instance of dtype, N and the tile (bd, chunk) ((0, 0): the default):
// out[0..3] = its threads a block, shared-memory bytes, registers a thread
// and local (spilled) bytes a thread, the last two from
// cudaFuncGetAttributes.  Returns cudaErrorInvalidValue for an instance
// the library does not have, as mamba_scan_fwd refuses it.
extern "C" int mamba_scan_tile(int dtype, int N, int bd, int chunk,
                               int* out) {
  return (int)with_instance(dtype, N, bd, chunk,
                            [&](auto t, auto n, auto ch, auto tc) {
    using Sm = Staged<decltype(n)::value, decltype(ch)::value,
                      decltype(tc)::value>;
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(
        &attr, mamba_scan_kernel<decltype(t), decltype(n)::value,
                                 decltype(ch)::value, decltype(tc)::value>);
    if (err == cudaSuccess) {
      out[0] = Sm::NTS;
      out[1] = (int)sizeof(Sm);
      out[2] = attr.numRegs;
      out[3] = (int)attr.localSizeBytes;
    }
    return err;
  });
}
