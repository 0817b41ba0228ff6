// Flash attention forward for Hopper (sm_90a): the library's C interface
// and the TF32 split pass of the tf32x3 variant.  The kernels, what they
// compute, replace and are bound by, are in flash_attention.cuh; the
// parts flash_attention.d<D>.cu instantiate them, one head dim a part, and
// this file dispatches a call to its head dim's part.

#include "flash_attention.cuh"

namespace flash {

// The split pass.  ws holds, each part a TF32 "hi" and its TF32-rounded
// remainder "lo" (hopper::tf32_split):
//   q_hi, q_lo   (B*H, S, D)      nq = B*H*S*D elements each
//   k_hi, k_lo   (B*Hkv, S, D)    nk = B*Hkv*S*D elements each
//   vt_hi, vt_lo (B*Hkv, D, Sp)   V transposed, keys contiguous, Sp = S
//                                 rounded up to 4 (16-byte rows for TMA)
// TF32 wgmma takes both operands K-major only: in P V the reduction runs
// over keys, so V reaches shared memory with keys contiguous.  The first
// vt_tiles blocks each turn one 64 x 64 tile of V through shared memory
// (read along D, written along keys), ceil(D / 64) tiles across D with
// columns past D masked on the read and the write (D 16, 32, 80 and 96 are
// not whole tiles: at 80 the second tile holds columns 64-79); the others
// split q and k elementwise, 16 bytes a load.
// Keys past S in a row of V^T are never read (the tensor map ends at S)
// and are not written.
constexpr int SPLIT_T = 64;
constexpr int SPLIT_NT = 256;
constexpr int SPLIT_V4 = 4;   // float4s a thread of an elementwise block

__global__ void __launch_bounds__(SPLIT_NT)
flash_tf32_split_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ ws,
                        long long nq, long long nk, int S, int Sp, int D,
                        int vt_tiles) {
  __shared__ float t[SPLIT_T][SPLIT_T + 1];   // padded against bank conflicts
  constexpr int PER = SPLIT_T * SPLIT_T / SPLIT_NT;
  if ((int)blockIdx.x < vt_tiles) {
    const int ds = (D + SPLIT_T - 1) / SPLIT_T;
    const int ss = (S + SPLIT_T - 1) / SPLIT_T;
    int tile = blockIdx.x;
    const int d0 = tile % ds * SPLIT_T;
    tile /= ds;
    const int s0 = tile % ss * SPLIT_T, h = tile / ss;
    const float* src = v + (long long)h * S * D;
#pragma unroll
    for (int j = 0; j < PER; ++j) {   // t[key][d]
      const int e = threadIdx.x + SPLIT_NT * j, i = e / SPLIT_T,
                x = e % SPLIT_T;
      t[i][x] = s0 + i < S && d0 + x < D
                    ? src[(long long)(s0 + i) * D + d0 + x] : 0.f;
    }
    __syncthreads();
    const long long nv = nk / S * Sp;   // elements of vt_hi
    float* hi = ws + 2 * (nq + nk) + (long long)h * D * Sp;
    float* lo = hi + nv;
#pragma unroll
    for (int j = 0; j < PER; ++j) {   // row d0 + i of V^T, key s0 + x
      const int e = threadIdx.x + SPLIT_NT * j, i = e / SPLIT_T,
                x = e % SPLIT_T;
      if (s0 + x >= S || d0 + i >= D) continue;
      float hv, lv;
      hopper::tf32_split(t[x][i], hv, lv);
      const long long g = (long long)(d0 + i) * Sp + s0 + x;
      hi[g] = hv;
      lo[g] = lv;
    }
    return;
  }
  const long long n4 = (nq + nk) / 4;
  const long long e0 =
      (long long)(blockIdx.x - vt_tiles) * SPLIT_NT * SPLIT_V4 + threadIdx.x;
#pragma unroll
  for (int j = 0; j < SPLIT_V4; ++j) {
    const long long e = e0 + (long long)SPLIT_NT * j;
    if (e >= n4) break;
    const long long x = 4 * e;   // q and k are whole float4s (D % 4 == 0)
    const bool is_q = x < nq;
    const float4 in = *reinterpret_cast<const float4*>(
        is_q ? q + x : k + (x - nq));
    float* hi = is_q ? ws + x : ws + 2 * nq + (x - nq);
    float* lo = hi + (is_q ? nq : nk);
    float4 h4, l4;
    hopper::tf32_split(in.x, h4.x, l4.x);
    hopper::tf32_split(in.y, h4.y, l4.y);
    hopper::tf32_split(in.z, h4.z, l4.z);
    hopper::tf32_split(in.w, h4.w, l4.w);
    *reinterpret_cast<float4*>(hi) = h4;
    *reinterpret_cast<float4*>(lo) = l4;
  }
}

cudaError_t launch_tf32_split(const float* q, const float* k, const float* v,
                              float* ws, int B, int H, int Hkv, int S, int D,
                              cudaStream_t stream) {
  const long long nq = (long long)B * H * S * D;
  const long long nk = (long long)B * Hkv * S * D;
  const long long vt_tiles =
      (long long)B * Hkv * ((S + SPLIT_T - 1) / SPLIT_T) *
      ((D + SPLIT_T - 1) / SPLIT_T);
  const long long per_block = (long long)SPLIT_NT * SPLIT_V4 * 4;
  const long long blocks = vt_tiles + (nq + nk + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_tf32_split_kernel<<<(unsigned)blocks, SPLIT_NT, 0, stream>>>(
      q, k, v, ws, nq, nk, S, (int)vt_stride(S), D, (int)vt_tiles);
  return cudaGetLastError();
}

}  // namespace flash

// float32 elements of the workspace the tf32x3 variant needs (the split
// operands); the other variants need none.
extern "C" long long flash_attention_workspace(int B, int H, int Hkv, int S,
                                               int D) {
  if (B < 1 || H < 1 || Hkv < 1 || S < 1 || D < 1) return 0;
  return flash::tf32x3_workspace(B, H, Hkv, S, D);
}

// q: (B, H, S, D), k and v: (B, Hkv, S, D), o: (B, H, S, D), all contiguous
// and of one type: dtype 0 is float32 (variant 0 or 3), 1 is bfloat16
// (variant 1 or 2), 16-byte aligned.  D is one of 16, 32, 64, 80, 96,
// 128, 192, 256 (80 and 192: variants 2 and 3 only).  (bq, bk): the query
// rows and keys of a block's tile, one the variant instantiates at D, or
// (0, 0) for its default; any other is refused.  ws: n_ws float32
// elements, at least flash_attention_workspace(B, H, Hkv, S, D) for
// variant 3 (a shorter workspace is refused), else unused.  Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for what
// it refuses).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* ws, long long n_ws, int B,
                                   int H, int Hkv, int S, int D, int causal,
                                   int window, int dtype, int variant, int bq,
                                   int bk, void* stream) {
  flash::Args a{q, k, v, o, static_cast<float*>(ws), ws ? n_ws : 0,
                B, H, Hkv, S, causal, window, dtype, variant, bq, bk,
                static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return (int)flash::launch_16(a);
    case 32: return (int)flash::launch_32(a);
    case 64: return (int)flash::launch_64(a);
    case 80: return (int)flash::launch_80(a);
    case 96: return (int)flash::launch_96(a);
    case 128: return (int)flash::launch_128(a);
    case 192: return (int)flash::launch_192(a);
    case 256: return (int)flash::launch_256(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The instance of variant at head dim D and tile (bq, bk) ((0, 0): the
// default): out[0..4] = its ring's stages, dynamic shared-memory bytes,
// threads a block, registers a thread and local (spilled) bytes a thread,
// the last two from cudaFuncGetAttributes.  Returns cudaErrorInvalidValue
// for an instance the library does not have, as flash_attention_fwd
// refuses it.
extern "C" int flash_attention_tile(int variant, int D, int bq, int bk,
                                    int* out) {
  flash::TileInfo t{};
  cudaError_t err;
  switch (D) {
    case 16: err = flash::tile_info_16(variant, bq, bk, &t); break;
    case 32: err = flash::tile_info_32(variant, bq, bk, &t); break;
    case 64: err = flash::tile_info_64(variant, bq, bk, &t); break;
    case 80: err = flash::tile_info_80(variant, bq, bk, &t); break;
    case 96: err = flash::tile_info_96(variant, bq, bk, &t); break;
    case 128: err = flash::tile_info_128(variant, bq, bk, &t); break;
    case 192: err = flash::tile_info_192(variant, bq, bk, &t); break;
    case 256: err = flash::tile_info_256(variant, bq, bk, &t); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) {
    out[0] = t.stages;
    out[1] = t.smem_bytes;
    out[2] = t.threads;
    out[3] = t.regs;
    out[4] = t.local_bytes;
  }
  return (int)err;
}
