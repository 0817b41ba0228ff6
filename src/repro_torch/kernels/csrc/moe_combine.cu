// The dropless MoE's combine for Hopper (sm_90a), CUDA C++: each token's
// k expert rows, times their gates, summed into the token's output row.
//
// Replaces no TPU kernel.  The JAX package has no dropless path: its MoE
// combines capacity buffers, one of the k assignments after the other, in
// plain jnp.  models/moe.py::_moe_dropless ran the combine in plain
// PyTorch as four passes over (T k, d): y widened to float32, each row
// times its gate, an index_add_ of the rows into a float32 (T, d) with
// atomics, and a cast of that to bf16.  That took as long as the experts'
// products, some 20x its byte bound.
//
// For token t and channel c, with the k assignments j in routing order
// (most probable expert first):
//
//   out[t, c] = bf16(sum_j w[t, j] * float(y[inv[t, j], c]))
//
// y: the (T k, d) bf16 rows of the experts' products in the expert-sorted
// order of the dispatch; w: the (T, k) float32 gates; inv: (T, k) int32,
// the place of each assignment in the sorted order (the inverse of the
// sort: unchecked here, a permutation of 0 .. T k - 1); out: (T, d) bf16.
// Each product and each sum rounds to float32 on its own (__fmul_rn,
// __fadd_rn: no FMA), the sum starts from 0 and runs in routing order,
// and the result rounds once to bf16.  So a token's output
// is the float32 loop over j that the capacity path's combine runs, bit
// for bit, whatever the other tokens hold, and the same in every run,
// where index_add_'s atomics summed in no fixed order.
//
// What bounds it on the H100: bytes.  It reads each row of y once (2 d
// bytes), the gates and indices (8 k bytes a token) and writes 2 d bytes a
// token, with k multiplies and adds an element: at k 6, d 2048 and 15,200
// tokens, 437 MB, 0.13 ms at 3.35 TB/s.  So a thread takes 8 channels of
// one token as 16-byte vectors, neighbouring threads neighbouring
// channels of the same rows, and issues all k row loads before it sums
// any, k x 16 bytes in flight a thread; a warp's threads read the same
// gates and indices, which the L1 broadcasts.  Blocks of 256 threads take
// 256 x 8 channels in order over (token, channel), so a block is one token
// at d 2048 and 8,192 tokens make 8,192 blocks, some eight waves of the
// 132 SMs.  Where d or a base is not a multiple of 8 elements (16 bytes),
// an instance of one channel a thread takes over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int K_MAX = 8;          // the most assignments a token
constexpr int THREADS = 256;

// a thread's V bf16 channels of one row, as loaded
template <int V>
using Bits = typename std::conditional<V == 8, uint4, __nv_bfloat16>::type;

// V bf16 at p, 16-byte aligned for V == 8
template <int V>
__device__ __forceinline__ Bits<V> load_bits(const __nv_bfloat16* p) {
  if constexpr (V == 8)
    return __ldg(reinterpret_cast<const uint4*>(p));
  else
    return *p;
}

__device__ __forceinline__ float channel(const uint4& u, int c) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&u)[c]);
}

__device__ __forceinline__ float channel(__nv_bfloat16 h, int) {
  return __bfloat162float(h);
}

// K assignments a token, V channels a thread; threads in order over
// (token, group of V channels)
template <int K, int V>
__global__ void __launch_bounds__(THREADS)
moe_combine_kernel(const __nv_bfloat16* __restrict__ y,
                   const float* __restrict__ w, const int* __restrict__ inv,
                   __nv_bfloat16* __restrict__ out, long long T, int d) {
  const int lanes = d / V;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= T * lanes) return;
  const long long t = i / lanes;
  const int c0 = (int)(i - t * lanes) * V;
  int row[K];
  float g[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    row[j] = __ldg(inv + t * K + j);
    g[j] = __ldg(w + t * K + j);
  }
  // every row's load in flight before the first sum
  Bits<V> v[K];
#pragma unroll
  for (int j = 0; j < K; ++j)
    v[j] = load_bits<V>(y + (long long)row[j] * d + c0);
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    acc[c] = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j)
      acc[c] = __fadd_rn(acc[c], __fmul_rn(g[j], channel(v[j], c)));
  }
  __nv_bfloat16* o = out + t * d + c0;
  if constexpr (V == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      h[c] = __floats2bfloat162_rn(acc[2 * c], acc[2 * c + 1]);
    *reinterpret_cast<uint4*>(o) = u;
  } else {
    o[0] = __float2bfloat16(acc[0]);
  }
}

struct Args {
  const void *y, *w, *inv;
  void* out;
  long long T;
  int d;
  cudaStream_t stream;
};

template <int K, int V>
cudaError_t launch(const Args& a) {
  const long long threads = a.T * (a.d / V);
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  moe_combine_kernel<K, V><<<(unsigned)blocks, THREADS, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.y), static_cast<const float*>(a.w),
      static_cast<const int*>(a.inv), static_cast<__nv_bfloat16*>(a.out),
      a.T, a.d);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_k(int k, const Args& a) {
  static_assert(K_MAX == 8, "one case below for each k up to K_MAX");
  switch (k) {
    case 1: return launch<1, V>(a);
    case 2: return launch<2, V>(a);
    case 3: return launch<3, V>(a);
    case 4: return launch<4, V>(a);
    case 5: return launch<5, V>(a);
    case 6: return launch<6, V>(a);
    case 7: return launch<7, V>(a);
    case 8: return launch<8, V>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// y (T k, d) bf16, w (T, k) float32, inv (T, k) int32 and out (T, d) bf16,
// all contiguous; vec 8 needs d a multiple of 8 and y and out 16-byte
// aligned (the wrapper picks it), else 1.  Returns the launch's
// cudaError_t.
extern "C" int moe_combine_fwd(const void* y, const void* w, const void* inv,
                               void* out, long long T, int k, int d, int vec,
                               void* stream) {
  if (T < 1 || d < 1 || T * k > 0x7fffffffLL || (vec == 8 && d % 8))
    return (int)cudaErrorInvalidValue;
  const Args a{y, w, inv, out, T, d, static_cast<cudaStream_t>(stream)};
  if (vec == 8) return (int)launch_k<8>(k, a);
  if (vec == 1) return (int)launch_k<1>(k, a);
  return (int)cudaErrorInvalidValue;
}
