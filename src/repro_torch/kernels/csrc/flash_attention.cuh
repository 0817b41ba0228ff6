// Flash attention forward for Hopper (sm_90a), CUDA C++: the kernels and
// their launches, included by the parts csrc/flash_attention.d<D>.cu, which
// instantiate them for one head dim each (so that nvcc compiles the head
// dims in parallel), and by csrc/flash_attention.cu, the library's C
// interface, which instantiates none.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, launched by flash_attention through pl.pallas_call) and
// computes the same function: softmax(q k^T * D^-0.5 + mask) v with the
// causal mask qpos >= kpos, the sliding-window mask qpos - kpos < window
// (window > 0), masked scores set to the finite NEG_INF = -1e30, an online
// softmax with float32 running max, running sum and accumulator, and the
// output acc / max(l, 1e-30) in the input's type.  GQA/MQA: query head h of
// batch b reads KV head b*Hkv + h/(H/Hkv); KV is never copied to H heads.
//
// What bounds it on the H100: at the serving shapes (bf16, D = 256,
// S = 1024) the work is about 400 operations per byte of q, k, v and o,
// above the card's ~295 bf16 operations per byte, so the bound is the
// tensor cores' rate; at D <= 32 the one exponential of each (q, k) pair
// costs more than its 4 D operations on the tensor cores, and the
// special-function units' rate bounds it.  The bf16 kernel does both
// products on the tensor cores: its Hopper variant with wgmma, fed by TMA
// through a ring of K/V tiles, the only way to the card's full rate; the
// older variant with mma.sync m16n8k16 (bf16 in, float32 accumulate).  The
// float32 kernel must match the reference to 1e-4, which no single
// tensor-core type gives: its Hopper variant (tf32x3) does each product as
// three TF32 passes on wgmma (CUTLASS's 3xTF32), bound by 3 x the work at
// the TF32 rate; the older variant does float32 FMAs on the CUDA cores.
// The Hopper variants take every head dim (16, 32, 64, 80, 96, 128, 192,
// 256), the older ones all but 80 and 192; which one runs is the caller's
// choice, by head dim and type
// (flash_attention.py::variant, set by the card's times).  Against device
// memory, the other bound, all keep the score tile, the softmax statistics
// and the output accumulator on chip for the whole KV sweep, as the TPU
// kernel keeps them in VMEM: q is read once, each K/V tile once per query
// tile, o written once.
//
// Layout of the work.  The TPU grid (B*H, S/bq, S/bk) runs its KV axis in
// order on one core and carries the statistics in VMEM scratch between grid
// steps.  Here one block owns one query tile of one flat head and walks the
// KV tiles in a loop.  The caller picks the tile (bq query rows, bk keys),
// as the reference's caller does: the Hopper kernels instantiate bq 64 and
// 128 by bk 32, 64 and 128 where the block's shared memory fits the card's
// 227 KB (with_tile below), the older ones one tile each; 0, 0 takes the
// default, and a tile not instantiated is refused, never replaced.  Query
// tiles are issued last first, so that the long causal rows start early.
// KV tiles wholly above the causal diagonal, or wholly before every row's
// window, are skipped.  A ragged
// last tile (S not a multiple of the tile) is masked here: rows past S are
// loaded as zeros and never stored, keys past S are masked.  D = 256 needs
// more than the 48 KB of static shared memory, hence dynamic shared memory
// and cudaFuncSetAttribute before the launch.
//
// bf16 kernel: 4 warps, each owning 16 query rows.  A warp's scores for a
// KV tile are mma accumulators; their row max and row sum reduce over the
// 4 lanes that share a row (2 xor shuffles); the exponentials are rounded
// to bf16 and reused in registers as the A operand of the P.V product,
// whose float32 accumulators hold the warp's 16 x D output.  Tiles are kept
// in shared memory as bf16 with rows padded by 8 elements, so that the 8
// rows a fragment load touches start in 8 different banks.
//
// float32 FMA kernel: 256 threads; thread (ty, tx) = (tid / 16, tid % 16)
// owns query rows ty + 16 i (i < 4), score columns tx + 16 j and output
// columns tx + 16 e.  The 16 threads of a row are one half-warp, so row max
// and row sum reduce with 4 xor shuffles.  Q and K rows are padded to D + 1
// floats so that the 16 threads reading 16 K rows hit 16 banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace flash {

constexpr size_t SMEM_MAX = 232448;   // dynamic shared memory a block may have

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;         // query rows per block (older kernels)
constexpr int NT = 256;        // threads per block (float32 kernel)
constexpr int RPT = BQ / 16;   // query rows per thread

// reductions over the 16 lanes of a half-warp (xor offsets below 16 stay in it)
__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores

template <int D> struct TilesF32 {
  static constexpr int BK = D > 128 ? 32 : 64;   // keys per KV tile
  static constexpr int LD = D + 1;               // padded Q/K row stride
  static constexpr int LP = BK + 1;              // padded P row stride
  static constexpr size_t smem_bytes =
      sizeof(float) * (size_t(BQ) * LD + size_t(BK) * LD + size_t(BK) * D +
                       size_t(BQ) * LP);
};

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int H, int Hkv, int S, int causal, int window,
                     float scale) {
  using Tl = TilesF32<D>;
  constexpr int BK = Tl::BK, LD = Tl::LD, LP = Tl::LP;
  constexpr int CPT = BK / 16;   // score columns per thread
  constexpr int DPT = D / 16;    // output columns per thread

  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][LD]
  float* Ks = Qs + BQ * LD;      // [BK][LD]
  float* Vs = Ks + BK * LD;      // [BK][D]
  float* Ps = Vs + BK * D;       // [BQ][LP]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heavy tiles first
  const int bh = blockIdx.y;                          // flat head b*H + h
  const int b = bh / H, h = bh % H;
  const long long kvh = (long long)b * Hkv + h / (H / Hkv);
  const float* qp = q + (long long)bh * S * D;
  const float* kp = k + kvh * S * D;
  const float* vp = v + kvh * S * D;
  float* op = o + (long long)bh * S * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    Qs[r * LD + d] = q0 + r < S ? qp[(long long)(q0 + r) * D + d] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  // KV tiles with at least one live key for some row of this query tile
  int kt_begin = 0, kt_end = (S + BK - 1) / BK;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < BK * D; i += NT) {
      const int c = i / D, d = i % D;
      const bool in = k0 + c < S;
      const long long g = (long long)(k0 + c) * D + d;
      Ks[c * LD + d] = in ? kp[g] : 0.f;
      Vs[c * D + d] = in ? vp[g] : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = kpos < S && (!causal || qpos >= kpos) &&
                          (window <= 0 || qpos - kpos < window);
        s[i][j] = live ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const float vv = Vs[c * D + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      op[(long long)qpos * D + tx + 16 * e] = acc[i][e] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products (mma.sync m16n8k16)

constexpr int WARPS = 4;               // 16 query rows each
constexpr int NTB = 32 * WARPS;        // threads per block (bf16 kernel)

template <int D> struct TilesBf16 {
  static constexpr int BK = D > 128 ? 32 : 64;   // keys per KV tile
  static constexpr int LD = D + 8;               // padded bf16 row stride
  static constexpr size_t smem_bytes =
      sizeof(__nv_bfloat16) * size_t(BQ + 2 * BK) * LD;
};

// d += a * b for one 16x16 A (row-major fragment) and 16x8 B (column)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return pack(__float2bfloat16(lo), __float2bfloat16(hi));
}

// rows [r0, r0 + rows) of a (S, D) matrix into shared rows of stride LD, in
// 16-byte pieces; rows at or past S are zeros
template <int D, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int S) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += NTB) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTB)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int H, int Hkv, int S,
                      int causal, int window, float scale) {
  using Tl = TilesBf16<D>;
  constexpr int BK = Tl::BK, LD = Tl::LD;
  constexpr int NS = BK / 8;     // score n-tiles of 8 keys
  constexpr int NO = D / 8;      // output n-tiles of 8 columns

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* Ks = Qs + BQ * LD;                                 // [BK][LD]
  __nv_bfloat16* Vs = Ks + BK * LD;                                 // [BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // fragment row group, column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heavy tiles first
  const int bh = blockIdx.y;                          // flat head b*H + h
  const int b = bh / H, h = bh % H;
  const long long kvh = (long long)b * Hkv + h / (H / Hkv);
  const __nv_bfloat16* qp = q + (long long)bh * S * D;
  const __nv_bfloat16* kp = k + kvh * S * D;
  const __nv_bfloat16* vp = v + kvh * S * D;
  __nv_bfloat16* op = o + (long long)bh * S * D;

  load_rows<D, LD>(Qs, qp, q0, BQ, S);

  const int qw = q0 + 16 * warp;            // this warp's first query row
  const int rows[2] = {qw + g, qw + g + 8};  // the two rows this lane holds
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int kt_begin = 0, kt_end = (S + BK - 1) / BK;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's Ks/Vs are no longer read
    load_rows<D, LD>(Ks, kp, k0, BK, S);
    load_rows<D, LD>(Vs, vp, k0, BK, S);
    __syncthreads();
    // every key of the tile masked for all 16 rows of this warp
    if ((causal && k0 > qw + 15) ||
        (window > 0 && k0 + BK - 1 < qw - window + 1))
      continue;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      const __nv_bfloat16* qa = Qs + (16 * warp + g) * LD + kk + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8),
                             ld32(qa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* kb = Ks + (8 * j + g) * LD + kk + 2 * t;
        mma_16816(s[j], a, ld32(kb), ld32(kb + 8));
      }
    }

    // s[j][e] is row rows[e / 2], key k0 + 8 j + 2 t + (e & 1)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = rows[e / 2], kpos = k0 + 8 * j + 2 * t + (e & 1);
        const bool live = kpos < S && (!causal || qpos >= kpos) &&
                          (window <= 0 || qpos - kpos < window);
        s[j][e] = live ? s[j][e] * scale : NEG_INF;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e / 2]);
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: score tiles 2 kk and 2 kk + 1 form the A fragment of keys
    // 16 kk .. 16 kk + 15; the B fragment pairs two consecutive V rows
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                             pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vb = Vs + (16 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vn = vb + 8 * n;
        mma_16816(acc[n], a, pack(vn[0], vn[LD]),
                  pack(vn[8 * LD], vn[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = op + (long long)rows[r] * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: wgmma fed by TMA through a ring of K/V tiles

// The default tile: one warpgroup of 64 query rows a block, 64 keys a KV
// tile, one stage of K and one of V: 97 KB at D = 256, so that two blocks
// share an SM and one's softmax overlaps the other's products.  Measured at
// the serving shapes (H100, PERF.md), this beat 128-row blocks of two
// warpgroups with a 2-stage ring (192 KB, one block an SM) on both layers:
// the causal critical path is the heaviest block's KV sweep, which a 64-row
// block runs in half the work.  The other tiles (bq 64 or 128 by bk 32, 64
// or 128, all of which fit at every D with one stage: 193 KB at D 256, bq
// 128, bk 128) are the caller's to ask for; PERF.md's table of tiles times
// each beside the default.  At bq 128 the block is two consumer
// warpgroups of 64 rows each, which share every K/V tile of the ring and
// each keep their own O accumulator and softmax state.
//
// Rows of Q, K and V arrive in whole 128-byte boxes of 64 columns, NB = DP
// / 64 of them, DP being D rounded up to 64 (64 at D 16 and 32, 128 at D
// 80 and 96): the tensor maps end at D, so TMA writes zeros past it, and the
// barriers expect the boxes' full bytes, zeros included (counted from D, a
// padded box would leave the barrier short and its wait would trap).  No
// product reads the padding: Q K^T reduces over D / 16 k-steps and P V
// runs at N = D.  At D 16 and 32 a block takes 25 KB and some 70
// registers a thread (ptxas), so 6-7 blocks share an SM as the launch
// bounds stand; there the exponentials, one a (q, k) pair, and not the
// products set the least time (PERF.md).  D 192 (MLA's q/k width, 128 +
// 64) is three whole boxes: 73 KB a block, two blocks an SM.  D 80
// (zamba2's shared attention) is two boxes, the second holding columns
// 64-79 and 48 columns of zeros: Q K^T reduces over 5 k-steps (4 in box 0,
// the first 16 columns of box 1) and P V runs at N = 80, reading V's box 0
// and the first 16 columns of box 1; 49 KB a block.
template <int D, int BQ_, int BK_> struct TilesWg {
  static constexpr int BQ = BQ_;         // query rows: BQ / 64 warpgroups
  static constexpr int BK = BK_;         // keys per KV tile
  static constexpr int WG = BQ / 64;     // consumer warpgroups
  static constexpr int STAGES = 1;
  static constexpr int THREADS = 128 * WG;
  static constexpr int DP = (D + 63) / 64 * 64;  // D padded to whole boxes
  static constexpr int NB = DP / 64;             // boxes of a row
  static constexpr int Q_BYTES = BQ * DP * 2;    // NB boxes [BQ][64]
  static constexpr int KV_BYTES = BK * DP * 2;   // NB boxes [BK][64]
  static constexpr size_t smem_bytes =
      1024 + size_t(Q_BYTES) + 2 * STAGES * size_t(KV_BYTES) +
      (1 + 3 * STAGES) * sizeof(uint64_t);
  static constexpr bool FITS = smem_bytes <= SMEM_MAX;
  static_assert(BQ % 64 == 0 && BK % 16 == 0, "whole warpgroups, k16 steps");
};

// This thread's warpgroup of WG: 0 at one, and at two read from lane 0 so
// that the compiler sees it uniform across the warp.  The wgmma
// descriptors built from it must be uniform: threadIdx.x / 128 as it
// stands made the default tile's bf16 kernel slower at every head dim
// (PERF.md).
template <int WG>
__device__ __forceinline__ int warpgroup() {
  if constexpr (WG == 1)
    return 0;
  else
    return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One block owns BQ query rows of one flat head b*H + h, 64 rows a
// warpgroup.  Thread 0 also loads: the block's Q once, then K and V tiles of
// BK keys into the ring (separate barriers for K and V, so that S = Q K^T
// starts while V still streams in, and K's next tile streams in during the
// softmax and P V); the last of the block's warps to release a stage, of
// every warpgroup, refills it.  A dedicated producer warp would
// cost registers: the register file is split between the SM's 4 schedulers,
// and a warp beside two warpgroups leaves 168 registers a thread where the
// products need about 190 at D = 256.  Each warpgroup computes S (64 x BK) =
// Q K^T by m64nBKk16 wgmma from shared memory (both K-major); an online
// softmax in exp2 with scale * log2(e) folded in (the scale from the real
// D), masks applied only on tiles that cross the causal diagonal, the
// window's edge or S; then O (64 x D) += P V by m64nDk16 wgmma with P from
// the S registers as bf16 and V MN-major (transpose-B): at D = 96 it reads
// V's box 0 and the first half of box 1.  Q, K and V are seen through 3-d
// tensor maps (D, S, heads), so that a ragged last tile arrives as zeros
// and not as the next head's rows.  The block's KV range is its rows', so every tile has a
// live key for some row.  At two warpgroups the range is the union of their
// rows': a warpgroup skips the products of a tile with no live key for its
// own rows (the diagonal's last tiles for the first warpgroup, the window's
// first for the second, every tile for rows wholly past S), after waiting
// for the tile as the others do, so that no warp's releases run a stage
// ahead of another's.
template <int D, int BQ_, int BK_>
__global__ void __launch_bounds__(TilesWg<D, BQ_, BK_>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       __nv_bfloat16* __restrict__ o, int H, int Hkv, int S,
                       int causal, int window, float scale_log2) {
  using Tl = TilesWg<D, BQ_, BK_>;
  using namespace hopper;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, STAGES = Tl::STAGES, WG = Tl::WG;
  constexpr int Q_BYTES = Tl::Q_BYTES, KV_BYTES = Tl::KV_BYTES, NB = Tl::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);       // [NB][BQ][64]
  unsigned char* Ks = Qs + Q_BYTES;              // [STAGES][NB][BK][64]
  unsigned char* Vs = Ks + STAGES * KV_BYTES;    // [STAGES][NB][BK][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint32_t* k_released = reinterpret_cast<uint32_t*>(v_full + STAGES);
  uint32_t* v_released = k_released + STAGES;

  // block u: query tile nq - 1 - u / heads of flat head u % heads, the
  // longest causal sweeps first
  const int nq = (S + BQ - 1) / BQ, heads = gridDim.x / nq;
  const int bh = blockIdx.x % heads;                   // flat head b*H + h
  const int q0 = (nq - 1 - blockIdx.x / heads) * BQ;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hkv + h / (H / Hkv);
  // KV tiles with a live key for some row of this block
  int kt_begin = 0, kt_end = (S + BK - 1) / BK;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  const int n_tiles = kt_end - kt_begin;
  // warp of its warpgroup wg, whose 64 rows start at q0w
  const int wg = warpgroup<WG>();
  const int warp = WG == 1 ? threadIdx.x / 32 : threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, q0w = q0 + 64 * wg;

  // K (or V) tile i of this block into stage i % STAGES (thread 0)
  auto load = [&](const CUtensorMap* map, unsigned char* tiles,
                  uint64_t* full, int i) {
    const int s = i % STAGES, k0 = (kt_begin + i) * BK;
    mbar_arrive_expect_tx(&full[s], KV_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_load_3d(tiles + s * KV_BYTES + c * BK * 128, map, &full[s], 64 * c,
                  k0, kvh);
  };
  // Each warp releases tile i of K (or V) once its products are done; the
  // last of the block's warps to release it loads tile i + STAGES into the
  // stage; nobody waits for a release.  The count only grows: every 4 WG
  // releases of a stage are one tile.
  auto release = [&](const CUtensorMap* map, unsigned char* tiles,
                     uint64_t* full, uint32_t* released, int i) {
    if (lane == 0) {
      __threadfence_block();   // this warp's reads of the stage are done
      if ((atomicAdd(&released[i % STAGES], 1u) + 1) % (4 * WG) == 0) {
        __threadfence_block();
        if (i + STAGES < n_tiles) load(map, tiles, full, i + STAGES);
      }
    }
    __syncwarp();
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      k_released[s] = v_released[s] = 0;
    }
    mbar_fence_init();
    mbar_arrive_expect_tx(q_full, Q_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tma_load_3d(Qs + c * BQ * 128, &map_q, q_full, 64 * c, q0, bh);
    for (int i = 0; i < STAGES && i < n_tiles; ++i) {
      load(&map_k, Ks, k_full, i);
      load(&map_v, Vs, v_full, i);
    }
  }
  __syncthreads();

  const int row[2] = {q0w + 16 * warp + lane / 4,
                      q0w + 16 * warp + lane / 4 + 8};
  const int kcol = 2 * (lane % 4);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this lane's part
  Acc<D> acc;
  acc_zero(acc);
  const unsigned char* Qw = Qs + wg * 64 * 128;   // this warpgroup's rows
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES, k0 = (kt_begin + i) * BK;
    const uint32_t phase = (i / STAGES) & 1;
    if (WG > 1 && (q0w >= S || (causal && k0 > q0w + 63) ||
                   (window > 0 && k0 + BK - 1 <= q0w - window))) {
      // no live key for this warpgroup's rows
      mbar_wait(&k_full[s], phase);
      release(&map_k, Ks, k_full, k_released, i);
      mbar_wait(&v_full[s], phase);
      release(&map_v, Vs, v_full, v_released, i);
      continue;
    }
    // some key of the tile masked for some row of the warpgroup
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0w) ||
                      (window > 0 && k0 <= q0w + 63 - window);
    mbar_wait(&k_full[s], phase);
    Acc<BK> sc;
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < D / 16; ++st) {
      const int c = st / 4, kk = st % 4;
      wgmma_ss<0>(sc, desc_sw128(Qw + c * BQ * 128 + 32 * kk, 16, 1024),
                  desc_sw128(Ks + s * KV_BYTES + c * BK * 128 + 32 * kk, 16,
                             1024),
                  st > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence(sc);
    release(&map_k, Ks, k_full, k_released, i);

    // sc.r[4 j + e]: row row[e / 2], key k0 + 8 j + kcol + (e & 1)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) {
      float x = sc.r[r] * scale_log2;
      if (edge) {
        const int qpos = row[(r % 4) / 2];
        const int kpos = k0 + 8 * (r / 4) + kcol + (r & 1);
        const bool live = kpos < S && (!causal || qpos >= kpos) &&
                          (window <= 0 || qpos - kpos < window);
        x = live ? x : NEG_INF;
      }
      sc.r[r] = x;
      mx[(r % 4) / 2] = fmaxf(mx[(r % 4) / 2], x);
    }
    float corr[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
      const float m_new = fmaxf(m[h2], mx[h2]);
      corr[h2] = ex2(m[h2] - m_new);
      m[h2] = m_new;
      l[h2] *= corr[h2];
    }
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) {
      sc.r[r] = ex2(sc.r[r] - m[(r % 4) / 2]);
      l[(r % 4) / 2] += sc.r[r];
    }
    // P as the A operand: keys 16 kk .. 16 kk + 15 are n-tiles 2 kk and
    // 2 kk + 1 of the scores
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack(sc.r[8 * kk + 2 * e], sc.r[8 * kk + 2 * e + 1]);
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc.r[r] *= corr[(r % 4) / 2];

    mbar_wait(&v_full[s], phase);
    acc_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<1>(acc, pa[kk],
                  desc_sw128(Vs + s * KV_BYTES + 2048 * kk, BK * 128, 1024),
                  1);
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence(acc);
    release(&map_v, Vs, v_full, v_released, i);
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
  }
  __nv_bfloat16* op = o + (long long)bh * S * D;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (row[h2] >= S) continue;
    const float inv = 1.f / fmaxf(l[h2], 1e-30f);
    __nv_bfloat16* orow = op + (long long)row[h2] * D + kcol;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack(acc.r[4 * j + 2 * h2] * inv, acc.r[4 * j + 2 * h2 + 1] * inv);
  }
}

// q (B, H, S, D) and k, v (B, Hkv, S, D) as 3-d tensor maps (D, S, heads)
// of 64-element boxes (wider than the tensor at D 16 and 32)
template <int D, int BQ, int BK>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int Hkv, int S, int causal, int window,
                         cudaStream_t stream) {
  using Tl = TilesWg<D, BQ, BK>;
  CUtensorMap map_q, map_k, map_v;
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint64_t q_dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                                (cuuint64_t)B * H};
  const cuuint64_t kv_dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                                 (cuuint64_t)B * Hkv};
  const cuuint32_t q_box[3] = {64, (cuuint32_t)Tl::BQ, 1};
  const cuuint32_t kv_box[3] = {64, (cuuint32_t)Tl::BK, 1};
  cudaError_t err =
      hopper::make_map_bf16(&map_q, q, 3, q_dims, strides, q_box);
  if (err == cudaSuccess)
    err = hopper::make_map_bf16(&map_k, k, 3, kv_dims, strides, kv_box);
  if (err == cudaSuccess)
    err = hopper::make_map_bf16(&map_v, v, 3, kv_dims, strides, kv_box);
  auto kernel = flash_fwd_wgmma_kernel<D, BQ, BK>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Tl::smem_bytes);
  if (err != cudaSuccess) return err;
  // one block per work unit (query tile, flat head)
  const int grid = B * H * ((S + Tl::BQ - 1) / Tl::BQ);
  kernel<<<grid, Tl::THREADS, Tl::smem_bytes, stream>>>(
      map_q, map_k, map_v, static_cast<__nv_bfloat16*>(o), H, Hkv, S, causal,
      window, (float)(1.4426950408889634 / sqrt((double)D)));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32 on Hopper: three TF32 passes on wgmma (the tf32x3 variant)

// rows of V^T in the split workspace: S rounded up to 4 (16-byte rows for TMA)
inline long long vt_stride(int S) { return (S + 3) / 4 * 4; }

// The split pass (csrc/flash_attention.cu): q and k into TF32 hi and lo
// parts, v transposed and split, into ws at the offsets tf32x3_workspace
// counts, on `stream`
cudaError_t launch_tf32_split(const float* q, const float* k, const float* v,
                              float* ws, int B, int H, int Hkv, int S, int D,
                              cudaStream_t stream);

// One block of BQ query rows (BQ / 64 warpgroups).  Q and K rows arrive in
// whole 128-byte boxes of 32 columns, NB = DP / 32 of them, DP being D
// rounded up to 32 (32 at D 16, 96 at D 80): TMA writes zeros past D, and the
// barriers expect the boxes' full bytes.  V^T is D rows of keys, whole at
// every D.  No product reads the padding: Q K^T reduces over D / 8
// k-steps and P V runs at N = D.  Its shared memory:
//   Q hi and lo, resident for the whole sweep: 2 x BQ x DP x 4 bytes;
//   a ring of STAGES items, each one of K hi, K lo (BK x DP x 4 bytes),
//   V^T hi, V^T lo (D x BK x 4 bytes) of one tile of BK keys, loaded in
//   that order, tile after tile, each stage as large as the larger;
//   P hi and lo: 2 x BQ x BK x 4 bytes;
// plus 1024 bytes of alignment and the barriers.  The default tiles:
//
//   D       BK   Q hi+lo   item    ring             P hi+lo   total
//   16, 32  64   16 KB     8 KB    4 stages, 32 KB  32 KB     81 KB
//   64      64   32 KB     16 KB   4 stages, 64 KB  32 KB     129 KB
//   80, 96  64   48 KB     24 KB   3 stages, 72 KB  32 KB     153 KB
//   128     64   64 KB     32 KB   3 stages, 96 KB  32 KB     193 KB
//   192     32   96 KB     24 KB   2 stages, 48 KB  16 KB     161 KB
//   256     32   128 KB    32 KB   2 stages, 64 KB  16 KB     209 KB
//
// of the 227 KB a block may have: one block an SM from D = 64 on, two at
// D 16 and 32.  At D 192 and 256 the ring holds only K hi and K lo of one
// tile, or V^T hi and lo; each item is refilled as soon as the products
// that read it are done, so the next item's load runs under the current
// products and the softmax.  Another tile takes as many stages as its
// shared memory leaves room for, never more than the default's at its D
// and never fewer than 2 (K lo is waited for before K hi is released); a
// tile with no room for 2 is not instantiated (at D 256 only the default
// fits; PERF.md).
template <int D> constexpr int tf32_default_bk() { return D > 128 ? 32 : 64; }

// shared bytes of a tf32x3 block at head dim D, tile (BQ, BK) and a ring
// of `stages`: Q and P hi and lo, the ring's items (K: BK x DP fp32, the
// larger), 1024 bytes of alignment, the barriers and release counters
template <int D, int BQ, int BK>
constexpr size_t tf32_smem(int stages) {
  constexpr int DP = (D + 31) / 32 * 32;
  return 1024 + size_t(2 * BQ * DP * 4) + size_t(stages) * (BK * DP * 4) +
         size_t(2 * BQ * BK * 4) + (1 + stages) * sizeof(uint64_t) +
         stages * sizeof(uint32_t);
}

// the default tile's stages at D, fewer where shared memory ends; 0 where
// not even 2 fit
template <int D, int BQ, int BK>
constexpr int tf32_stages() {
  constexpr int most = D <= 64 ? 4 : D <= 128 ? 3 : 2;
  for (int s = most; s >= 2; --s)
    if (tf32_smem<D, BQ, BK>(s) <= SMEM_MAX) return s;
  return 0;
}

template <int D, int BQ_, int BK_> struct TilesTf32 {
  static constexpr int BQ = BQ_;                 // query rows: BQ / 64 warpgroups
  static constexpr int BK = BK_;                 // keys per KV tile
  static constexpr int WG = BQ / 64;             // consumer warpgroups
  static constexpr int THREADS = 128 * WG;
  static constexpr int DP = (D + 31) / 32 * 32;    // D padded to whole boxes
  static constexpr int NB = DP / 32;               // boxes of a Q or K row
  static constexpr int Q_BYTES = 2 * BQ * DP * 4;  // [hi, lo][NB][BQ][32]
  static constexpr int K_BYTES = BK * DP * 4;      // K: [NB][BK][32]
  static constexpr int VT_BYTES = BK * D * 4;      // V^T: [BK/32][D][32]
  static constexpr int ITEM = K_BYTES;             // a stage (>= VT_BYTES)
  static constexpr int P_BYTES = 2 * BQ * BK * 4;  // [hi, lo][BK/32][BQ][32]
  static_assert(VT_BYTES <= ITEM && D % 8 == 0, "V^T boxes of D rows");
  static_assert(BQ % 64 == 0 && BK % 32 == 0, "whole warpgroups, P boxes");
  static constexpr int STAGES = tf32_stages<D, BQ, BK>();
  static constexpr bool FITS = STAGES >= 2;
  static constexpr size_t smem_bytes = tf32_smem<D, BQ, BK>(FITS ? STAGES : 2);
};

// What flash_fwd_f32_kernel computes, with both products on the tensor
// cores as CUTLASS's 3xTF32, 64 query rows a warpgroup: S = Q K^T and O +=
// P V each sum lo·hi, hi·lo
// and hi·hi (only lo·lo, about 2^-22 relative, is dropped), from the split
// pass's operands and P split in registers.  The skeleton is
// flash_fwd_wgmma_kernel's: thread 0 loads Q (hi and lo) once and primes
// the ring; the last warp to release an item refills its stage with the
// item STAGES further on.  Each product is two commit groups: the passes
// that read the hi item (lo·hi, then hi·hi, summing the small terms first),
// then hi·lo; the hi item is released, and its stage refilled, while hi·lo
// still runs.  S (64 x BK) is m64nBKk8 wgmma from shared memory; the online
// softmax runs in exp2 with scale * log2(e) folded in, masks only on tiles
// that cross the causal diagonal, the window's edge or S; P goes to shared
// memory as hi and lo in the 128-byte swizzled layout a TMA load would
// write (the A operand of TF32 wgmma from registers would cost 8 registers
// a k8 step, and the 64 x 256 accumulator already takes 128); O (64 x D)
// is m64nDk8 wgmma with P and V^T from shared memory.  Q, K and V^T are
// read through 3-d tensor maps whose third index picks the head and the
// part (hi or lo), so that rows and keys past S arrive as zeros.  At two
// warpgroups each writes and reads its own rows of P behind a barrier of
// its own, and skips the products of a tile with no live key for its rows
// as flash_fwd_wgmma_kernel does.
template <int D, int BQ_, int BK_>
__global__ void __launch_bounds__(TilesTf32<D, BQ_, BK_>::THREADS, 1)
flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_vt,
                        float* __restrict__ o, int H, int Hkv, int S,
                        int causal, int window, float scale_log2) {
  using Tl = TilesTf32<D, BQ_, BK_>;
  using namespace hopper;
  constexpr int BQ = Tl::BQ, BK = Tl::BK, STAGES = Tl::STAGES, WG = Tl::WG;
  constexpr int ITEM = Tl::ITEM, NB = Tl::NB;
  constexpr int QH = BQ * Tl::DP * 4, PH = BQ * BK * 4;   // bytes of a part
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);       // [hi, lo][NB][BQ][32]
  unsigned char* ring = Qs + Tl::Q_BYTES;        // [STAGES][ITEM]
  unsigned char* Ps = ring + STAGES * ITEM;      // [hi, lo][BK/32][BQ][32]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Ps + Tl::P_BYTES);
  uint64_t* full = q_full + 1;
  uint32_t* released = reinterpret_cast<uint32_t*>(full + STAGES);

  // block u: query tile nq - 1 - u / heads of flat head u % heads, the
  // longest causal sweeps first
  const int nq = (S + BQ - 1) / BQ, heads = gridDim.x / nq;
  const int bh = blockIdx.x % heads;                   // flat head b*H + h
  const int q0 = (nq - 1 - blockIdx.x / heads) * BQ;
  const int b = bh / H, h = bh % H;
  const int kv_heads = heads / H * Hkv;                // B*Hkv
  const int kvh = b * Hkv + h / (H / Hkv);
  int kt_begin = 0, kt_end = (S + BK - 1) / BK;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK + 1);
  const int n_items = 4 * (kt_end - kt_begin);
  // warp of its warpgroup wg, whose 64 rows start at q0w
  const int wg = warpgroup<WG>();
  const int warp = WG == 1 ? threadIdx.x / 32 : threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, q0w = q0 + 64 * wg;

  // item i: kind i % 4 (K hi, K lo, V^T hi, V^T lo) of the block's KV tile
  // i / 4, into stage i % STAGES (one thread)
  auto load = [&](int i) {
    const int s = i % STAGES, kind = i % 4, k0 = (kt_begin + i / 4) * BK;
    const int head = (kind & 1) * kv_heads + kvh;
    unsigned char* dst = ring + s * ITEM;
    if (kind < 2) {
      mbar_arrive_expect_tx(&full[s], Tl::K_BYTES);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load_3d(dst + c * BK * 128, &map_k, &full[s], 32 * c, k0, head);
    } else {
      mbar_arrive_expect_tx(&full[s], Tl::VT_BYTES);
#pragma unroll
      for (int c = 0; c < BK / 32; ++c)
        tma_load_3d(dst + c * D * 128, &map_vt, &full[s], k0 + 32 * c, 0,
                    head);
    }
  };
  // Each warp releases item i once its products are done; the last of the
  // 4 WG to release it loads item i + STAGES into the stage.  The count only
  // grows: every 4 WG releases of a stage are one item.
  auto release = [&](int i) {
    if (lane == 0) {
      __threadfence_block();   // this warp's reads of the stage are done
      if ((atomicAdd(&released[i % STAGES], 1u) + 1) % (4 * WG) == 0) {
        __threadfence_block();
        if (i + STAGES < n_items) load(i + STAGES);
      }
    }
    __syncwarp();
  };
  auto wait_item = [&](int i) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    return ring + (i % STAGES) * ITEM;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    mbar_fence_init();
    mbar_arrive_expect_tx(q_full, Tl::Q_BYTES);
#pragma unroll
    for (int part = 0; part < 2; ++part)
#pragma unroll
      for (int c = 0; c < NB; ++c)
        tma_load_3d(Qs + part * QH + c * BQ * 128, &map_q, q_full, 32 * c,
                    q0, part * heads + bh);
    for (int i = 0; i < STAGES && i < n_items; ++i) load(i);
  }
  __syncthreads();

  const int row[2] = {q0w + 16 * warp + lane / 4,
                      q0w + 16 * warp + lane / 4 + 8};
  const int kcol = 2 * (lane % 4);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this lane's part
  Acc<D> acc;
  acc_zero(acc);
  // this warpgroup's rows of Q and P
  const unsigned char* q_hi = Qs + wg * 64 * 128;
  const unsigned char* q_lo = q_hi + QH;
  unsigned char* Pw = Ps + wg * 64 * 128;
  mbar_wait(q_full, 0);

  for (int i = 0; i < n_items; i += 4) {
    const int k0 = (kt_begin + i / 4) * BK;
    if (WG > 1 && (q0w >= S || (causal && k0 > q0w + 63) ||
                   (window > 0 && k0 + BK - 1 <= q0w - window))) {
      // no live key for this warpgroup's rows
      for (int j = 0; j < 4; ++j) {
        wait_item(i + j);
        release(i + j);
      }
      continue;
    }
    // some key of the tile masked for some row of the warpgroup
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0w) ||
                      (window > 0 && k0 <= q0w + 63 - window);
    Acc<BK> sc;
    const unsigned char* k_hi = wait_item(i);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < D / 8; ++st) {
      const int off = st / 4 * BQ * 128 + 32 * (st % 4);
      const uint64_t kb = desc_sw128(k_hi + st / 4 * BK * 128 + 32 * (st % 4),
                                     16, 1024);
      wgmma_ss_tf32(sc, desc_sw128(q_lo + off, 16, 1024), kb, st > 0);
      wgmma_ss_tf32(sc, desc_sw128(q_hi + off, 16, 1024), kb, 1);
    }
    wgmma_commit();
    const unsigned char* k_lo = wait_item(i + 1);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < D / 8; ++st)
      wgmma_ss_tf32(sc, desc_sw128(q_hi + st / 4 * BQ * 128 + 32 * (st % 4),
                                   16, 1024),
                    desc_sw128(k_lo + st / 4 * BK * 128 + 32 * (st % 4), 16,
                               1024),
                    1);
    wgmma_commit();
    wgmma_wait<1>();
    release(i);
    wgmma_wait<0>();
    acc_fence(sc);
    release(i + 1);

    // sc.r[4 j + e]: row row[e / 2], key k0 + 8 j + kcol + (e & 1)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) {
      float x = sc.r[r] * scale_log2;
      if (edge) {
        const int qpos = row[(r % 4) / 2];
        const int kpos = k0 + 8 * (r / 4) + kcol + (r & 1);
        const bool live = kpos < S && (!causal || qpos >= kpos) &&
                          (window <= 0 || qpos - kpos < window);
        x = live ? x : NEG_INF;
      }
      sc.r[r] = x;
      mx[(r % 4) / 2] = fmaxf(mx[(r % 4) / 2], x);
    }
    float corr[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
      const float m_new = fmaxf(m[h2], mx[h2]);
      corr[h2] = ex2(m[h2] - m_new);
      m[h2] = m_new;
      l[h2] *= corr[h2];
    }
    // P as hi and lo into shared memory, 128-byte swizzled: row rr of the
    // warpgroup, key x of box c is at c * BQ * 128 + rr * 128 from Pw,
    // 16-byte piece x / 4 XOR rr % 8
#pragma unroll
    for (int r = 0; r < BK / 2; r += 2) {
      const int h2 = (r % 4) / 2, rr = 16 * warp + lane / 4 + 8 * h2;
      const int x = (8 * (r / 4) + kcol) % 32, c = (8 * (r / 4)) / 32;
      const float p0 = ex2(sc.r[r] - m[h2]), p1 = ex2(sc.r[r + 1] - m[h2]);
      l[h2] += p0 + p1;
      float2 hi, lo;
      tf32_split(p0, hi.x, lo.x);
      tf32_split(p1, hi.y, lo.y);
      const int off = c * BQ * 128 + rr * 128 +
                      ((((x >> 2) ^ (rr & 7)) << 4) | ((x & 3) << 2));
      *reinterpret_cast<float2*>(Pw + off) = hi;
      *reinterpret_cast<float2*>(Pw + PH + off) = lo;
    }
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc.r[r] *= corr[(r % 4) / 2];
    fence_proxy_async();   // P's plain stores, visible to wgmma
    // every warp's rows of P are written (of the warpgroup's 4 warps)
    if constexpr (WG == 1)
      __syncthreads();
    else
      bar_sync(1 + wg, 128);

    const unsigned char* v_hi = wait_item(i + 2);
    acc_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < BK / 8; ++st) {
      const int off = st / 4 * BQ * 128 + 32 * (st % 4);
      const uint64_t vb = desc_sw128(v_hi + st / 4 * D * 128 + 32 * (st % 4),
                                     16, 1024);
      wgmma_ss_tf32(acc, desc_sw128(Pw + PH + off, 16, 1024), vb, 1);
      wgmma_ss_tf32(acc, desc_sw128(Pw + off, 16, 1024), vb, 1);
    }
    wgmma_commit();
    const unsigned char* v_lo = wait_item(i + 3);
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < BK / 8; ++st)
      wgmma_ss_tf32(acc, desc_sw128(Pw + st / 4 * BQ * 128 + 32 * (st % 4),
                                    16, 1024),
                    desc_sw128(v_lo + st / 4 * D * 128 + 32 * (st % 4), 16,
                               1024),
                    1);
    wgmma_commit();
    wgmma_wait<1>();
    release(i + 2);
    wgmma_wait<0>();
    acc_fence(acc);
    release(i + 3);
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
  }
  float* op = o + (long long)bh * S * D;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (row[h2] >= S) continue;
    const float denom = fmaxf(l[h2], 1e-30f);
    float* orow = op + (long long)row[h2] * D + kcol;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(acc.r[4 * j + 2 * h2] / denom,
                      acc.r[4 * j + 2 * h2 + 1] / denom);
  }
}

// float32 elements of the tf32x3 workspace: q and k hi/lo, v transposed
// hi/lo with rows of vt_stride(S).  Rows hold D columns, not DP: the tensor
// maps end at D and TMA fills a box past it with zeros (D 16, 80, 96)
inline long long tf32x3_workspace(int B, int H, int Hkv, int S, int D) {
  return 2LL * S * D * ((long long)B * H + (long long)B * Hkv) +
         2LL * B * Hkv * D * vt_stride(S);
}

// The split pass into ws (n_ws float32 elements, at least
// tf32x3_workspace(...), 16-byte aligned), then the product over it, on one
// stream.
template <int D, int BQ, int BK>
cudaError_t launch_tf32x3(const float* q, const float* k, const float* v,
                          float* o, float* ws, long long n_ws, int B, int H,
                          int Hkv, int S, int causal, int window,
                          cudaStream_t stream) {
  using Tl = TilesTf32<D, BQ, BK>;
  if (!ws || n_ws < tf32x3_workspace(B, H, Hkv, S, D))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_tf32_split(q, k, v, ws, B, H, Hkv, S, D, stream);
  if (err != cudaSuccess) return err;
  const long long nq = (long long)B * H * S * D;
  const long long nk = (long long)B * Hkv * S * D;
  const int Sp = (int)vt_stride(S);

  // (D, S, 2 B H), (D, S, 2 B Hkv) and (S, D, 2 B Hkv) maps: the third
  // index picks the part (hi, lo) and the head
  CUtensorMap map_q, map_k, map_vt;
  const cuuint64_t row_strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)S * D * 4};
  const cuuint64_t q_dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                                2 * (cuuint64_t)B * H};
  const cuuint64_t k_dims[3] = {(cuuint64_t)D, (cuuint64_t)S,
                                2 * (cuuint64_t)B * Hkv};
  const cuuint64_t vt_dims[3] = {(cuuint64_t)S, (cuuint64_t)D,
                                 2 * (cuuint64_t)B * Hkv};
  const cuuint64_t vt_strides[2] = {(cuuint64_t)Sp * 4,
                                    (cuuint64_t)D * Sp * 4};
  const cuuint32_t q_box[3] = {32, (cuuint32_t)Tl::BQ, 1};
  const cuuint32_t k_box[3] = {32, (cuuint32_t)Tl::BK, 1};
  const cuuint32_t vt_box[3] = {32, (cuuint32_t)D, 1};
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  err = hopper::make_map(&map_q, F32, ws, 3, q_dims, row_strides, q_box);
  if (err == cudaSuccess)
    err = hopper::make_map(&map_k, F32, ws + 2 * nq, 3, k_dims, row_strides,
                           k_box);
  if (err == cudaSuccess)
    err = hopper::make_map(&map_vt, F32, ws + 2 * (nq + nk), 3, vt_dims,
                           vt_strides, vt_box);
  int device = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  static std::atomic<uint64_t> smem_set{0};
  auto kernel = flash_fwd_tf32x3_kernel<D, BQ, BK>;
  if (err == cudaSuccess)
    err = hopper::smem_limit_once(smem_set, kernel, (int)Tl::smem_bytes,
                                  device);
  if (err != cudaSuccess) return err;
  // one block per work unit (query tile, flat head)
  const int grid = B * H * ((S + Tl::BQ - 1) / Tl::BQ);
  kernel<<<grid, Tl::THREADS, Tl::smem_bytes, stream>>>(
      map_q, map_k, map_vt, o, H, Hkv, S, causal, window,
      (float)(1.4426950408889634 / sqrt((double)D)));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch

template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const void* q,
                   const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int S, int D, int causal, int window,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, S, causal, window,
      (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

// Kernel variants, chosen by the caller (flash_attention.py::variant):
// 0 float32 FMAs, 1 bf16 mma.sync, 2 bf16 wgmma with TMA, 3 float32 three
// TF32 passes on wgmma.  The Hopper variants (2, 3) take every head dim of
// flash_attention_fwd; the older kernels (0, 1), which they replaced, are
// not built at D 80 and 192 and refuse them.
enum Variant { kFma = 0, kMmaSync = 1, kWgmma = 2, kTf32x3 = 3 };

// A call of flash_attention_fwd; (bq, bk) = (0, 0) is the default tile
struct Args {
  const void *q, *k, *v;
  void* o;
  float* ws;
  long long n_ws;
  int B, H, Hkv, S, causal, window, dtype, variant, bq, bk;
  cudaStream_t stream;
};

// What flash_attention_tile lays out for an instance: its ring's stages,
// its dynamic shared memory, its threads, and cudaFuncGetAttributes'
// registers a thread and local (spilled) bytes a thread
struct TileInfo {
  int stages, smem_bytes, threads, regs, local_bytes;
};

// The Hopper variants' tiles: (bq, bk) with bq in {64, 128} and bk in {32,
// 64, 128} whose block fits in shared memory, and the default, (64, 64), or
// for tf32x3 above D 128 (64, 32).  with_tile<D, V> calls f with the tile
// (bq, bk) as two integral constants, and refuses any other
template <int D, int V, int BQ, int BK>
constexpr bool tile_fits() {
  if constexpr (V == kWgmma) return TilesWg<D, BQ, BK>::FITS;
  else return TilesTf32<D, BQ, BK>::FITS;
}

template <int D, int V, typename F>
cudaError_t with_tile(int bq, int bk, F&& f) {
  if (bq == 0 && bk == 0) {
    bq = 64;
    bk = V == kTf32x3 ? tf32_default_bk<D>() : 64;
  }
#define FLASH_TILE(BQ_, BK_)                                             \
  if (bq == BQ_ && bk == BK_) {                                          \
    if constexpr (tile_fits<D, V, BQ_, BK_>())                           \
      return f(std::integral_constant<int, BQ_>{},                       \
               std::integral_constant<int, BK_>{});                      \
    else                                                                 \
      return cudaErrorInvalidValue;                                      \
  }
  FLASH_TILE(64, 32)
  FLASH_TILE(64, 64)
  FLASH_TILE(64, 128)
  FLASH_TILE(128, 32)
  FLASH_TILE(128, 64)
  FLASH_TILE(128, 128)
#undef FLASH_TILE
  return cudaErrorInvalidValue;
}

// the older kernels' one tile: 64 rows by 64 keys, 32 above D 128
template <int D>
bool older_tile(int bq, int bk) {
  return (bq == 0 && bk == 0) || (bq == BQ && bk == (D > 128 ? 32 : 64));
}

template <int D>
cudaError_t launch_d(const Args& a) {
  if constexpr (D != 80 && D != 192) {
    if (a.variant == kFma || a.variant == kMmaSync) {
      if (!older_tile<D>(a.bq, a.bk)) return cudaErrorInvalidValue;
      if (a.dtype == 0 && a.variant == kFma)
        return launch<float>(flash_fwd_f32_kernel<D>, NT,
                             TilesF32<D>::smem_bytes, a.q, a.k, a.v, a.o, a.B,
                             a.H, a.Hkv, a.S, D, a.causal, a.window,
                             a.stream);
      if (a.dtype == 1 && a.variant == kMmaSync)
        return launch<__nv_bfloat16>(flash_fwd_bf16_kernel<D>, NTB,
                                     TilesBf16<D>::smem_bytes, a.q, a.k, a.v,
                                     a.o, a.B, a.H, a.Hkv, a.S, D, a.causal,
                                     a.window, a.stream);
    }
  }
  if (a.dtype == 1 && a.variant == kWgmma)
    return with_tile<D, kWgmma>(a.bq, a.bk, [&](auto bq, auto bk) {
      return launch_wgmma<D, decltype(bq)::value, decltype(bk)::value>(
          a.q, a.k, a.v, a.o, a.B, a.H, a.Hkv, a.S, a.causal, a.window,
          a.stream);
    });
  if (a.dtype == 0 && a.variant == kTf32x3)
    return with_tile<D, kTf32x3>(a.bq, a.bk, [&](auto bq, auto bk) {
      return launch_tf32x3<D, decltype(bq)::value, decltype(bk)::value>(
          static_cast<const float*>(a.q), static_cast<const float*>(a.k),
          static_cast<const float*>(a.v), static_cast<float*>(a.o), a.ws,
          a.n_ws, a.B, a.H, a.Hkv, a.S, a.causal, a.window, a.stream);
    });
  return cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t info_of(Kernel kernel, int stages, size_t smem, int threads,
                    TileInfo* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *out = {stages, (int)smem, threads, attr.numRegs, (int)attr.localSizeBytes};
  return cudaSuccess;
}

template <int D>
cudaError_t tile_info_d(int variant, int bq, int bk, TileInfo* out) {
  if constexpr (D != 80 && D != 192) {
    if (!older_tile<D>(bq, bk) && (variant == kFma || variant == kMmaSync))
      return cudaErrorInvalidValue;
    if (variant == kFma)
      return info_of(flash_fwd_f32_kernel<D>, 1, TilesF32<D>::smem_bytes, NT,
                     out);
    if (variant == kMmaSync)
      return info_of(flash_fwd_bf16_kernel<D>, 1, TilesBf16<D>::smem_bytes,
                     NTB, out);
  }
  if (variant == kWgmma)
    return with_tile<D, kWgmma>(bq, bk, [&](auto bq_, auto bk_) {
      using Tl = TilesWg<D, decltype(bq_)::value, decltype(bk_)::value>;
      return info_of(flash_fwd_wgmma_kernel<D, Tl::BQ, Tl::BK>, Tl::STAGES,
                     Tl::smem_bytes, Tl::THREADS, out);
    });
  if (variant == kTf32x3)
    return with_tile<D, kTf32x3>(bq, bk, [&](auto bq_, auto bk_) {
      using Tl = TilesTf32<D, decltype(bq_)::value, decltype(bk_)::value>;
      return info_of(flash_fwd_tf32x3_kernel<D, Tl::BQ, Tl::BK>, Tl::STAGES,
                     Tl::smem_bytes, Tl::THREADS, out);
    });
  return cudaErrorInvalidValue;
}

// Each head dim's launches and tile information, defined by its part
// csrc/flash_attention.d<D>.cu (FLASH_ATTENTION_PART)
#define FLASH_ATTENTION_DECLARE(D)                                   \
  cudaError_t launch_##D(const Args& a);                             \
  cudaError_t tile_info_##D(int variant, int bq, int bk, TileInfo* out);
FLASH_ATTENTION_DECLARE(16)
FLASH_ATTENTION_DECLARE(32)
FLASH_ATTENTION_DECLARE(64)
FLASH_ATTENTION_DECLARE(80)
FLASH_ATTENTION_DECLARE(96)
FLASH_ATTENTION_DECLARE(128)
FLASH_ATTENTION_DECLARE(192)
FLASH_ATTENTION_DECLARE(256)
#undef FLASH_ATTENTION_DECLARE

#define FLASH_ATTENTION_PART(D)                                        \
  cudaError_t flash::launch_##D(const Args& a) { return launch_d<D>(a); } \
  cudaError_t flash::tile_info_##D(int variant, int bq, int bk,        \
                                   TileInfo* out) {                    \
    return tile_info_d<D>(variant, bq, bk, out);                       \
  }

}  // namespace flash
