// The Mamba1 mixer's coefficients for Hopper (sm_90a), CUDA C++: the
// elementwise work of models/ssm.py::_ssm_coeffs1 around its two small
// products, as two kernels.
//
// Replaces no TPU kernel.  The JAX package leaves this chain to XLA, which
// fuses it; in plain PyTorch it ran as 16 launches a layer over
// (b, S, d_in): the causal conv as 11 (a multiply, three pads, multiplies
// and adds, the bias), silu, the float32 cast of dt's product, its bias,
// softplus and x's float32 widening for the scan, each a pass through
// device memory, about 82 bytes a channel-token.  These two kernels move
// 14: the least the chain's inputs and outputs allow.
//
// conv1d_silu: for batch b, step t and channel c,
//
//   y[b, t, c]  = bf16(silu(bias[c] + sum_{i<k} w[c, k-1-i] x[b, t-i, c]))
//   yf[b, t, c] = float(y[b, t, c])
//
// with x = 0 before t = 0.  The k taps and the bias are summed and silu
// taken in float32, and the result rounded once to bf16; yf is the float32
// widening of that same y, what the scan reads while x_proj reads y.  x is
// read in place from the in_proj product xz (b, S, 2 d_in): its first d_in
// columns at the row stride of xz, with no copy.  w: (d_in, k), bias:
// (d_in,), bf16; y bf16 and yf float32, (b, S, d_in) contiguous.
//
// dt_softplus: out = softplus(float(p) + bias), float32, with
// F.softplus's semantics (beta 1; above the threshold 20 the sum passes
// through).  p: the dt_proj product, (b, S, d_in) bf16 contiguous; bias:
// (d_in,) float32.
//
// What bounds them on the H100: bytes.  Per channel-token conv1d_silu reads
// 2 bytes and writes 6, dt_softplus reads 2 and writes 4; the arithmetic
// (k FMAs, an exp and a divide; an exp and a log1p) stays under the memory
// time at 3.35 TB/s.  So both read and write 16 bytes a thread and a
// vector (8 bf16 channels; yf and the softplus out as two float4), and
// neighbouring threads take neighbouring channels.  conv1d_silu's block
// walks CONV_CHUNK timesteps of CONV_THREADS x 8 channels, keeping the last
// k-1 rows in registers, so each row of x is loaded once but for the k-1
// halo rows a chunk reloads at its start (L2 hits, 3 of 32); the taps and
// the bias stay in registers.  Any S and d_in: channels past d_in and steps
// past S are masked; where d_in, the row strides or the base are not
// multiples of 8 elements, an instance of one channel a thread takes over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int K_MAX = 4;          // the conv's largest kernel width
constexpr int CONV_THREADS = 128;
constexpr int CONV_CHUNK = 32;    // timesteps a block
constexpr int DT_THREADS = 256;
constexpr float SOFTPLUS_THRESHOLD = 20.f;

// V bf16 at p (16-byte aligned for V == 8) as floats
template <int V>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p,
                                          float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

// V floats to q (16-byte aligned for V == 8)
template <int V>
__device__ __forceinline__ void store_f32(float* q, const float (&v)[V]) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(q)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(q)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) q[i] = v[i];
  }
}

// v rounded to bf16 (to nearest even) into y, and the rounded values
// widened back into v
template <int V>
__device__ __forceinline__ void round_bf16(__nv_bfloat16* y, float (&v)[V]) {
  if constexpr (V == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
    *reinterpret_cast<uint4*>(y) = u;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const __nv_bfloat16 h = __float2bfloat16(v[i]);
      y[i] = h;
      v[i] = __bfloat162float(h);
    }
  }
}

// K taps, V channels a thread; grid (channel blocks, step chunks, batch).
// x's rows are st elements apart and its batches sb; y and yf contiguous.
template <int K, int V>
__global__ void __launch_bounds__(CONV_THREADS)
conv1d_silu_kernel(const __nv_bfloat16* __restrict__ x, long long sb,
                   long long st, const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ bias,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ yf,
                   int S, int d) {
  const int c0 = (blockIdx.x * CONV_THREADS + threadIdx.x) * V;
  if (c0 >= d) return;
  const int t0 = blockIdx.y * CONV_CHUNK;
  const int t1 = min(t0 + CONV_CHUNK, S);
  // tap j multiplies x[t - (K-1) + j]: w[c, j]
  float wt[K][V], bv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      wt[j][v] = __bfloat162float(w[(c0 + v) * K + j]);
    bv[v] = __bfloat162float(bias[c0 + v]);
  }
  const __nv_bfloat16* xb = x + blockIdx.z * sb + c0;
  // hist[j] = x[t - (K-1) + j] before step t: the halo of zeros or of the
  // previous chunk's last rows
  float hist[K > 1 ? K - 1 : 1][V];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int t = t0 - (K - 1) + j;
    if (t >= 0) {
      load_bf16<V>(xb + t * st, hist[j]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) hist[j][v] = 0.f;
    }
  }
  const long long row0 = (long long)blockIdx.z * S;
#pragma unroll 4
  for (int t = t0; t < t1; ++t) {
    float cur[V], out[V];
    load_bf16<V>(xb + t * st, cur);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float a = wt[K - 1][v] * cur[v];
#pragma unroll
      for (int j = K - 2; j >= 0; --j) a = fmaf(wt[j][v], hist[j][v], a);
      a += bv[v];
      out[v] = a / (1.f + expf(-a));
    }
    if constexpr (K > 1) {
#pragma unroll
      for (int j = 0; j < K - 2; ++j) {
#pragma unroll
        for (int v = 0; v < V; ++v) hist[j][v] = hist[j + 1][v];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) hist[K - 2][v] = cur[v];
    }
    const long long o = (row0 + t) * d + c0;
    round_bf16<V>(y + o, out);
    store_f32<V>(yf + o, out);
  }
}

// V elements a thread of n = rows x d
template <int V>
__global__ void __launch_bounds__(DT_THREADS)
dt_softplus_kernel(const __nv_bfloat16* __restrict__ p,
                   const float* __restrict__ bias, float* __restrict__ out,
                   long long n, int d) {
  const long long i0 =
      ((long long)blockIdx.x * DT_THREADS + threadIdx.x) * V;
  if (i0 >= n) return;
  const int c0 = (int)(i0 % d);
  float v[V];
  load_bf16<V>(p + i0, v);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    // V == 8 only where d % 8 == 0: the vector lies in one row
    const float a = v[i] + bias[c0 + i];
    v[i] = a > SOFTPLUS_THRESHOLD ? a : log1pf(expf(a));
  }
  store_f32<V>(out + i0, v);
}

struct ConvArgs {
  const void* x;
  long long sb, st;
  const void *w, *bias;
  void *y, *yf;
  int b, S, d;
  cudaStream_t stream;
};

template <int K, int V>
cudaError_t launch_conv(const ConvArgs& a) {
  const int lanes = (a.d + V - 1) / V;
  const dim3 grid((lanes + CONV_THREADS - 1) / CONV_THREADS,
                  (a.S + CONV_CHUNK - 1) / CONV_CHUNK, a.b);
  conv1d_silu_kernel<K, V><<<grid, CONV_THREADS, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), a.sb, a.st,
      static_cast<const __nv_bfloat16*>(a.w),
      static_cast<const __nv_bfloat16*>(a.bias),
      static_cast<__nv_bfloat16*>(a.y), static_cast<float*>(a.yf), a.S, a.d);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_conv_k(int k, const ConvArgs& a) {
  static_assert(K_MAX == 4, "one case below for each k up to K_MAX");
  switch (k) {
    case 1: return launch_conv<1, V>(a);
    case 2: return launch_conv<2, V>(a);
    case 3: return launch_conv<3, V>(a);
    case 4: return launch_conv<4, V>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x at its batch stride sb and row stride st (elements), channels unit
// stride; vec 8 needs d, sb, st multiples of 8 and x 16-byte aligned (the
// wrapper picks it), else 1.  Returns the launch's cudaError_t.
extern "C" int conv1d_silu_fwd(const void* x, long long sb, long long st,
                               const void* w, const void* bias, void* y,
                               void* yf, int b, int S, int d, int k, int vec,
                               void* stream) {
  if (b < 1 || S < 1 || d < 1 || b > 65535
      || (S + CONV_CHUNK - 1) / CONV_CHUNK > 65535)
    return (int)cudaErrorInvalidValue;
  const ConvArgs a{x, sb, st, w, bias, y, yf, b, S, d,
                   static_cast<cudaStream_t>(stream)};
  if (vec == 8) return (int)launch_conv_k<8>(k, a);
  if (vec == 1) return (int)launch_conv_k<1>(k, a);
  return (int)cudaErrorInvalidValue;
}

// p and out n elements, rows of d; vec 8 needs d a multiple of 8 and p and
// out 16-byte aligned (the wrapper picks it), else 1.  Returns the launch's
// cudaError_t.
extern "C" int dt_softplus_fwd(const void* p, const void* bias, void* out,
                               long long n, int d, int vec, void* stream) {
  if (n < 1 || d < 1 || (vec != 8 && vec != 1))
    return (int)cudaErrorInvalidValue;
  const long long threads = (n + vec - 1) / vec;
  const unsigned blocks = (unsigned)((threads + DT_THREADS - 1) / DT_THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pp = static_cast<const __nv_bfloat16*>(p);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<float*>(out);
  if (vec == 8)
    dt_softplus_kernel<8><<<blocks, DT_THREADS, 0, s>>>(pp, bp, op, n, d);
  else
    dt_softplus_kernel<1><<<blocks, DT_THREADS, 0, s>>>(pp, bp, op, n, d);
  return (int)cudaGetLastError();
}
