// Tiled matrix product for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/nvdla_matmul.py
// (_matmul_kernel, launched by matmul through pl.pallas_call) and computes
// the same function: c = a @ b for a (M, K) and b (K, N), both row-major,
// with a float32 accumulator over the whole K loop and c written once, in
// the inputs' type.  The TPU kernel walks the grid (M/bm, N/bn, K/bk) with K
// innermost on one core and keeps the accumulator in VMEM scratch between
// grid steps (NVDLA's channel-block loop, outputs accumulated in place).
// Here one block owns one output tile and walks K in a loop, with the
// accumulator in registers.  The TPU kernel asserts that its blocks divide
// M, N and K; this one takes any M, N and K and masks the ragged edges
// itself: elements past an edge load as zeros and are never stored.  The
// Pallas bm/bn/bk become launch parameters: each variant instantiates a
// few tiles (output rows and columns, k a step, pipeline stages), and the
// caller names one, with the number of blocks K is split over.  The tiling
// optimizer's Hopper chooser (repro_torch/core/tiling.py::
// choose_matmul_tiling, the counterpart of repro/core/tiling.py's) picks
// both; this file decides no tile and no split, and refuses a tile it does
// not instantiate.
//
// What bounds it on the H100: a product of M rows does 2 M N K operations
// on (M K + K N + M N) elements, so at M in the thousands it is bound by
// the arithmetic rate and at M of a few rows (decoding) by reading b.
//
// bf16 kernel: the products run on the tensor cores (mma.sync m16n8k16,
// bf16 in, float32 accumulate).  Tiles of a and b are staged in shared
// memory as bf16 with rows padded by 8 elements, so that the 8 rows an
// ldmatrix touches start in 8 different banks; a's fragments come from
// ldmatrix, b's (b is k-major) from ldmatrix.trans.  A block of WM x WN
// warps owns a (16 MT WM) x (8 NT WN) tile; each warp MT x NT mma tiles.
//
// float32 FMA kernel (variant "fma", named explicitly): the
// products are float32 FMAs on the CUDA cores.  256 threads; thread (ty, tx)
// = (tid / 16, tid % 16) owns rows ty TM .. ty TM + TM - 1 and columns
// 4 tx .. 4 tx + 3 and 64 + 4 tx .. 64 + 4 tx + 3 of a (16 TM) x 128 tile.
// a's tile is stored transposed (k-major) so that a thread's rows are
// contiguous in shared memory.
//
// The FMA and mma.sync kernels keep a small variant for M of at most 16
// rows (the decoding shapes): its block holds 16 rows, so b is read once
// and not many times over 128 rows of zeros.  Where the output tiles are too
// few to fill the card's 132 SMs (a few rows by a narrow N), the caller
// splits K over blocks, whose float32 partials a second kernel sums. Both
// load the next K tile into registers while the current one is multiplied.
// Tiles: FMA 16 x 128 (k 16) and 128 x 128 (k 8); mma.sync 16 x 128 and
// 128 x 128 (k 32).
//
// bf16 on Hopper (the wgmma variant), for M > 16 and K, N multiples of 8:
// the card's full tensor-core rate needs wgmma, which reads its operands
// from shared memory while the tiles stream in.  a's and b's tiles arrive by
// TMA (128-byte swizzle, boxes of 64 bf16 on the inner dimension) in a
// ring of 3 or 4 stages guarded by mbarriers; a producer warpgroup keeps the
// loads in flight and two consumer warpgroups multiply a 128 x BN output
// tile (BN 64, 128 or 256), b being MN-major (wgmma's transpose-B), and
// store it by TMA from shared memory.  It never splits K.  The helpers it shares with the flash kernel
// are in hopper.cuh.
//
// float32 with M > 16 (the tf32x3 variant): the reference tolerance (rtol
// 2e-4, atol 2e-4 sqrt(K)) rules out one TF32 pass, and FMAs cap the product
// at the CUDA cores' 67 TFLOP/s.  So a split pass writes each operand as a
// TF32 "hi" part and a TF32 "lo" remainder, K-major and padded to K % 32 ==
// 0 (b transposed: TF32 wgmma has no transpose-B), and a wgmma kernel on the
// bf16 one's skeleton sums lo·hi + hi·lo + hi·hi into one float32
// accumulator (CUTLASS's 3xTF32: only lo·lo, about 2^-22 relative, is
// dropped), at up to a third of the 495 TFLOP/s TF32 rate.  Its tiles: BM
// 64 or 128 rows (one or two consumer warpgroups) by BN 64, 112, 128 or 256
// columns, with as many stages (2-4) as shared memory holds; where the
// tiles are too few for the SMs, the caller splits K over blocks and the
// float32 partials are summed as below.
//
// float32 with M <= 16 (the stream variant): the product reads b once and
// is bound by that.  Each thread owns 4 adjacent columns, reads b as 16-byte
// read-only loads, 8 k rows in flight, and uses each element M times from a
// register; a's few rows come through the read-only cache as warp-wide
// broadcasts; its tile is 16 rows by 1024 columns, 8 k rows a step.  Where
// the columns fill less than one wave, the caller splits K and the split-K
// sum kernel adds the partials.
//
// Which variant runs is the caller's choice (nvdla_matmul.py::variant):
// float32 takes tf32x3 for M > 16 and stream otherwise; bf16 the wgmma one
// where TMA can describe the operands and M > 16, the mma.sync one
// otherwise; fma is named explicitly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores

constexpr int F_NT = 256;      // threads per block
constexpr int F_BN = 128;      // columns per block

// TM rows per thread (the block has 16 TM rows), F_BK k per shared tile
template <int TM, int F_BK>
__global__ void __launch_bounds__(F_NT)
matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, float* __restrict__ ws, int M, int N,
                  int K, int kchunk) {
  constexpr int BM = 16 * TM;
  constexpr int LDA = BM + 4;  // padded: the transposing store hits 32 banks
  constexpr int A_LOADS = (BM * F_BK + F_NT - 1) / F_NT;
  constexpr int B_LOADS = F_BK * F_BN / F_NT;
  __shared__ __align__(16) float As[F_BK][LDA];   // a's tile, k-major
  __shared__ __align__(16) float Bs[F_BK][F_BN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * F_BN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);

  float ra[A_LOADS], rb[B_LOADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < A_LOADS; ++r) {
      const int i = tid + r * F_NT, row = i / F_BK, gk = k0 + i % F_BK;
      ra[r] = i < BM * F_BK && m0 + row < M && gk < K
                  ? a[(long long)(m0 + row) * K + gk] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < B_LOADS; ++r) {
      const int i = tid + r * F_NT, gk = k0 + i / F_BN, gn = n0 + i % F_BN;
      rb[r] = gk < K && gn < N ? b[(long long)gk * N + gn] : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int r = 0; r < A_LOADS; ++r) {
      const int i = tid + r * F_NT;
      if (i < BM * F_BK) As[i % F_BK][i / F_BK] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < B_LOADS; ++r) {
      const int i = tid + r * F_NT;
      Bs[i / F_BN][i % F_BN] = rb[r];
    }
  };

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(kb);
  store();
  __syncthreads();
  for (int k0 = kb; k0 < ke; k0 += F_BK) {
    const bool more = k0 + F_BK < ke;
    if (more) load(k0 + F_BK);   // in flight while this tile is multiplied
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float av[TM], bv[8];
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4)
          *reinterpret_cast<float4*>(av + i) =
              *reinterpret_cast<const float4*>(&As[kk][ty * TM + i]);
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
      }
      *reinterpret_cast<float4*>(bv) =
          *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      *reinterpret_cast<float4*>(bv + 4) =
          *reinterpret_cast<const float4*>(&Bs[kk][64 + 4 * tx]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();             // every thread is done with this tile
    if (more) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
      if (col >= N) continue;
      if (ws)
        ws[((long long)blockIdx.z * M + row) * N + col] = acc[i][j];
      else
        c[(long long)row * N + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products (mma.sync m16n8k16)

constexpr int H_BK = 32;            // k per shared tile
constexpr int H_LD = H_BK + 8;      // padded row of a's tile

// d += a * b for one 16x16 A (row-major fragment) and 16x8 B (column)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// elements [row][col, col + 8) of a rows x cols row-major bf16 matrix, as 16
// bytes; elements past an edge are zeros.  vec: cols % 8 == 0, so a whole
// piece inside the matrix is 16-byte aligned (the base is).
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* m, int row,
                                       int col, int rows, int cols,
                                       bool vec) {
  if (row >= rows || col >= cols) return make_uint4(0u, 0u, 0u, 0u);
  const __nv_bfloat16* p = m + (long long)row * cols + col;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = col + 2 * i < cols ? __bfloat16_as_ushort(p[2 * i]) : 0u;
    const uint32_t hi =
        col + 2 * i + 1 < cols ? __bfloat16_as_ushort(p[2 * i + 1]) : 0u;
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(32 * WM * WN)
matmul_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                   const __nv_bfloat16* __restrict__ b,
                   __nv_bfloat16* __restrict__ c, float* __restrict__ ws,
                   int M, int N, int K, int kchunk) {
  static_assert(NT % 2 == 0, "b's fragments load two n-tiles at a time");
  constexpr int THREADS = 32 * WM * WN;
  constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  constexpr int LDB = BN + 8;                           // padded row of b's tile
  constexpr int A_PIECES = BM * H_BK / 8, B_PIECES = H_BK * BN / 8;
  constexpr int A_LOADS = (A_PIECES + THREADS - 1) / THREADS;
  constexpr int B_LOADS = (B_PIECES + THREADS - 1) / THREADS;
  __shared__ __align__(16) __nv_bfloat16 As[BM * H_LD];    // [BM][H_LD]
  __shared__ __align__(16) __nv_bfloat16 Bs[H_BK * LDB];   // [H_BK][LDB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  const bool vec_a = K % 8 == 0, vec_b = N % 8 == 0;

  uint4 ra[A_LOADS], rb[B_LOADS];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < A_LOADS; ++r) {
      const int i = tid + r * THREADS;
      const int row = i / (H_BK / 8), col = (i % (H_BK / 8)) * 8;
      ra[r] = i < A_PIECES ? load8(a, m0 + row, k0 + col, M, K, vec_a)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int r = 0; r < B_LOADS; ++r) {
      const int i = tid + r * THREADS;
      const int row = i / (BN / 8), col = (i % (BN / 8)) * 8;
      rb[r] = i < B_PIECES ? load8(b, k0 + row, n0 + col, K, N, vec_b)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int r = 0; r < A_LOADS; ++r) {
      const int i = tid + r * THREADS;
      if (i < A_PIECES)
        *reinterpret_cast<uint4*>(As + (i / (H_BK / 8)) * H_LD +
                                  (i % (H_BK / 8)) * 8) = ra[r];
    }
#pragma unroll
    for (int r = 0; r < B_LOADS; ++r) {
      const int i = tid + r * THREADS;
      if (i < B_PIECES)
        *reinterpret_cast<uint4*>(Bs + (i / (BN / 8)) * LDB +
                                  (i % (BN / 8)) * 8) = rb[r];
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix addresses: lane l gives row l % 8 of matrix l / 8
  const int lr = lane % 8 + 8 * ((lane / 8) & 1), lc = 8 * (lane / 16);

  load(kb);
  store();
  __syncthreads();
  for (int k0 = kb; k0 < ke; k0 += H_BK) {
    const bool more = k0 + H_BK < ke;
    if (more) load(k0 + H_BK);   // in flight while this tile is multiplied
#pragma unroll
    for (int kk = 0; kk < H_BK; kk += 16) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)   // matrices: rows +0/+8 x k +0/+8
        ldsm_x4(af[i], As + (wm * MT * 16 + i * 16 + lr) * H_LD + kk + lc);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {   // matrices: k +0/+8 x n +0/+8
        uint32_t r[4];
        ldsm_x4_trans(r, Bs + (kk + lr) * LDB + wn * NT * 8 + j * 8 + lc);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_16816(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();             // every warp is done with this tile
    if (more) {
      store();
      __syncthreads();
    }
  }

  // acc[i][j][e] is row 16 i + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4)
  // + (e & 1) of this warp's tile
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * MT * 16 + i * 16 + lane / 4 + 8 * (e / 2);
        const int col = n0 + wn * NT * 8 + j * 8 + 2 * (lane % 4) + (e & 1);
        if (row >= M || col >= N) continue;
        if (ws)
          ws[((long long)blockIdx.z * M + row) * N + col] = acc[i][j][e];
        else
          c[(long long)row * N + col] = __float2bfloat16(acc[i][j][e]);
      }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: wgmma fed by TMA through a ring of shared tiles

namespace wg {
constexpr int BM = 128, BK = 64;             // output rows a tile, k a stage
constexpr int CONSUMERS = 2;                 // warpgroups of 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int A_BYTES = BM * BK * 2;         // one box [BM][64]
// BN output columns a tile (64, 128 or 256), STAGES stages in the ring
template <int BN_, int STAGES_>
struct Tile {
  static constexpr int BN = BN_, STAGES = STAGES_;
  static constexpr int B_BYTES = BK * BN * 2;   // BN / 64 boxes [BK][64]
  // BN / 64 boxes [64][64] a warpgroup
  static constexpr int C_BYTES = 64 * BN * 2;
  // tiling.py::_wgmma_tile computes the same
  static constexpr size_t SMEM = 1024 + size_t(STAGES) * (A_BYTES + B_BYTES) +
                                 size_t(CONSUMERS) * C_BYTES +
                                 2 * STAGES * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "227 KB of shared memory a block");
};
}  // namespace wg

// A persistent grid: block i owns output tiles i, i + gridDim.x, ... (BM x
// BN each, N fastest), so that one tile's epilogue overlaps the loads of the
// next.  Warpgroup CONSUMERS is the producer: one thread issues the TMA loads
// of a's (BM x 64, K-major) and b's (64 x BN, MN-major) boxes into the
// STAGES-deep ring, each stage guarded by a `full` barrier (TMA bytes) and an
// `empty` one (one arrival per consumer warp); the ring runs on across tiles.
// Consumer warpgroup w multiplies rows 64 w .. 64 w + 63 with m64nBNk16
// wgmma, keeping one stage's products in flight while it waits for the next.
// Its epilogue writes the float32 accumulator as bf16 into its own shared
// tile (the 128-byte-swizzled boxes a TMA load of c would write), and one
// thread stores those boxes to c by TMA while the warpgroup goes on to its
// next tile: register-to-global stores of 4 bytes cost 28% of the time
// (PERF.md).  TMA writes nothing past M and N; a's and b's boxes arrive as
// zeros there.
template <typename Tl>
__global__ void __launch_bounds__(wg::THREADS, 1)
matmul_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                         const __grid_constant__ CUtensorMap map_b,
                         const __grid_constant__ CUtensorMap map_c, int M,
                         int N, int K) {
  using namespace wg;
  using namespace hopper;
  constexpr int BN = Tl::BN, STAGES = Tl::STAGES;
  constexpr int B_BYTES = Tl::B_BYTES, C_BYTES = Tl::C_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = align1024(smem_raw);          // [STAGES][BM][64]
  unsigned char* Bs = As + STAGES * A_BYTES;        // [STAGES][BN/64][BK][64]
  unsigned char* Cs = Bs + STAGES * B_BYTES;        // [CONSUMERS][BN/64][64][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(Cs + CONSUMERS * C_BYTES);
  uint64_t* empty = full + STAGES;

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_n * ((M + BM - 1) / BM);
  const int nk = (K + BK - 1) / BK;
  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == CONSUMERS) {   // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;   // k tiles loaded so far, over all this block's tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * BM, n0 = t % tiles_n * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], A_BYTES + B_BYTES);
          tma_load_2d(As + s * A_BYTES, &map_a, &full[s], kt * BK, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(Bs + s * B_BYTES + j * BK * 128, &map_b, &full[s],
                        n0 + 64 * j, kt * BK);
        }
      }
    }
  } else {                  // consumers
    setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool storer = threadIdx.x % 128 == 0;
    unsigned char* cs = Cs + wgi * C_BYTES;
    Acc<BN> acc;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t / tiles_n * BM, n0 = t % tiles_n * BN;
      acc_zero(acc);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* a = As + s * A_BYTES + wgi * 64 * 128;
        const unsigned char* b = Bs + s * B_BYTES;
        acc_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss<1>(acc, desc_sw128(a + 32 * kk, 16, 1024),
                      desc_sw128(b + 2048 * kk, BK * 128, 1024), 1);
        wgmma_commit();
        acc_fence(acc);
        wgmma_wait<1>();   // the previous stage's products are done
        if (kt > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      acc_fence(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

      // the previous tile's stores have read this warpgroup's shared tile
      if (storer) tma_store_wait_read();
      bar_sync(1 + wgi, 128);
      // acc.r[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h of the warpgroup's
      // 64, column 8 j + 2 (lane % 4) + e; 16-byte piece j % 8 of box j / 8,
      // swizzled by the row
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + lane / 4 + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(
              cs + (j / 8) * 64 * 128 + r * 128 + ((j % 8) ^ (r % 8)) * 16 +
              4 * (lane % 4)) =
              __floats2bfloat162_rn(acc.r[4 * j + 2 * h],
                                    acc.r[4 * j + 2 * h + 1]);
        }
      fence_proxy_async();
      bar_sync(1 + wgi, 128);
      if (storer) {
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_store_2d(&map_c, cs + b * 64 * 128, n0 + 64 * b, m0 + 64 * wgi);
        tma_store_commit();
      }
    }
    if (storer) tma_store_wait();
  }
}

// a (M, K) and b (K, N) as tensor maps of 64-element boxes; K % 8 == 0 and
// N % 8 == 0 so that their row strides are whole 16-byte units
template <typename Tl>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int M, int N,
                         int K, cudaStream_t stream) {
  using namespace wg;
  if (K % 8 || N % 8) return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b, map_c;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t a_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t a_box[2] = {64, BM};
  const cuuint64_t b_dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t b_strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t b_box[2] = {64, BK};
  cudaError_t err =
      hopper::make_map_bf16(&map_a, a, 2, a_dims, a_strides, a_box);
  const cuuint64_t c_dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint32_t c_box[2] = {64, 64};
  if (err == cudaSuccess)
    err = hopper::make_map_bf16(&map_b, b, 2, b_dims, b_strides, b_box);
  if (err == cudaSuccess)   // c's rows have b's stride
    err = hopper::make_map_bf16(&map_c, c, 2, c_dims, b_strides, c_box);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = hopper::device_sms(&device, &sms);
  static std::atomic<uint64_t> smem_set{0};
  if (err == cudaSuccess)
    err = hopper::smem_limit_once(smem_set, matmul_bf16_wgmma_kernel<Tl>,
                                  (int)Tl::SMEM, device);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)((N + Tl::BN - 1) / Tl::BN) * ((M + BM - 1) / BM);
  const int grid = (int)(tiles < sms ? tiles : sms);
  matmul_bf16_wgmma_kernel<Tl><<<grid, THREADS, Tl::SMEM, stream>>>(
      map_a, map_b, map_c, M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch

// the split-K partials of ws, (splits, M, N) float32, summed into c
template <typename T>
__global__ void splitk_sum_kernel(const float* __restrict__ ws,
                                  T* __restrict__ c, long long mn,
                                  int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    if constexpr (sizeof(T) == 4)
      c[i] = s;
    else
      c[i] = __float2bfloat16(s);
  }
}

constexpr int SMALL_M = 16;    // at most this many rows: the stream kernel
constexpr int SPLIT_ALIGN = 32;   // a split's k range is whole k tiles of the
                                  // FMA and mma.sync kernels

// the split-K partials of ws summed into c by splitk_sum_kernel
template <typename T>
cudaError_t sum_splits(const float* ws, void* c, int M, int N, int splits,
                       cudaStream_t stream) {
  const long long mn = (long long)M * N;
  const int blocks = (int)min((mn + 255) / 256, 4LL * 132);
  splitk_sum_kernel<T><<<blocks, 256, 0, stream>>>(ws, static_cast<T*>(c), mn,
                                                   splits);
  return cudaGetLastError();
}

// k per split when K is split over `splits` blocks: ceil(K / splits)
// rounded up to `align`; 0 (refused) unless that leaves each of the
// `splits` k ranges non-empty (tiling.py::aligned_splits gives such counts)
int split_chunk(int K, int splits, int align) {
  if (splits < 1) return 0;
  const int chunk = ((K + splits - 1) / splits + align - 1) / align * align;
  return (K + chunk - 1) / chunk == splits ? chunk : 0;
}

// a kernel of the FMA or mma.sync family at a bm x bn tile over `splits`
// k ranges, their float32 partials (ws: splits x M x N) summed by a second
// kernel
template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int bm, int bn, const void* a,
                   const void* b, void* c, float* ws, int M, int N, int K,
                   int splits, cudaStream_t stream) {
  const int kchunk = split_chunk(K, splits, SPLIT_ALIGN);
  if (!kchunk || (splits > 1 && !ws)) return cudaErrorInvalidValue;
  const dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm, splits);
  kernel<<<grid, threads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      splits > 1 ? ws : nullptr, M, N, K, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits<T>(ws, c, M, N, splits, stream);
}

// ---------------------------------------------------------------------------
// float32 on the tensor cores: three TF32 passes (the tf32x3 variant)

namespace tf {
constexpr int BK = 32;   // k per stage: one 128-byte row of fp32
// BM output rows a tile (64 or 128: one or two consumer warpgroups), BN
// columns (64, 112, 128 or 256), STAGES stages in the ring
template <int BM_, int BN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int CONSUMERS = BM / 64;      // warpgroups of 64 rows
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int A_BYTES = BM * BK * 4;    // a box [BM][32]: a_hi or a_lo
  static constexpr int B_BYTES = BN * BK * 4;    // a box [BN][32]
  static constexpr int STAGE = 2 * A_BYTES + 2 * B_BYTES;   // hi and lo
  // tiling.py::_tf32x3_tile computes the same
  static constexpr size_t SMEM =
      1024 + size_t(STAGES) * STAGE + 2 * STAGES * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "227 KB of shared memory a block");
};
constexpr int SPLIT_T = 64;                  // tile edge of the split pass
}  // namespace tf

// K rounded up to whole k stages: the split operands' row length
inline int kpad(int K) { return (K + tf::BK - 1) / tf::BK * tf::BK; }

// The split pass.  ws holds [a_hi; a_lo] as (2, M, Kp) and [bT_hi; bT_lo]
// as (2, N, Kp) behind it, all K-major and zero past K.  A block turns one
// 64 x 64 tile of a destination (rows x Kp) through shared memory: element
// (r, k) is a[r][k] for a's tiles (which come first) and b[k][r] for b's,
// read along the source's contiguous dimension and written along k, 16
// loads a thread in flight.
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ ws, int M, int N, int K, int Kp) {
  constexpr int T = tf::SPLIT_T, PER = T * T / 256;
  __shared__ float t[T][T + 1];   // [r][k], padded against bank conflicts
  const int kt = (Kp + T - 1) / T;
  const long long a_tiles = (long long)((M + T - 1) / T) * kt;
  long long tile = blockIdx.x;
  const bool is_a = tile < a_tiles;
  if (!is_a) tile -= a_tiles;
  const int rows = is_a ? M : N;
  const int r0 = (int)(tile / kt) * T, k0 = (int)(tile % kt) * T;
  // element e of a thread: row e / T of the tile's source, e % T along it
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = threadIdx.x + 256 * j, i = e / T, x = e % T;
    if (is_a) {
      const int r = r0 + i, k = k0 + x;
      t[i][x] = r < M && k < K ? a[(long long)r * K + k] : 0.f;
    } else {
      const int k = k0 + i, r = r0 + x;
      t[x][i] = r < N && k < K ? b[(long long)k * N + r] : 0.f;
    }
  }
  __syncthreads();
  float* hi = is_a ? ws : ws + 2LL * M * Kp;
  float* lo = hi + (long long)rows * Kp;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = threadIdx.x + 256 * j, i = e / T, x = e % T;
    const int r = r0 + i, k = k0 + x;
    if (r >= rows || k >= Kp) continue;
    float h, l;
    hopper::tf32_split(t[i][x], h, l);
    hi[(long long)r * Kp + k] = h;
    lo[(long long)r * Kp + k] = l;
  }
}

// The product, on the skeleton of matmul_bf16_wgmma_kernel (a
// persistent grid, a TMA ring guarded by full / empty mbarriers, a producer
// warpgroup, one or two consumer warpgroups of 64 rows), with four boxes a
// stage: a_hi, a_lo (BM x 32) and bT_hi, bT_lo (BN x 32), each through a
// 3-d map whose third index picks hi or lo (so that rows past M or N arrive
// as zeros, not as the other part's rows).  Each k8 step issues m64nBNk8
// three times, lo·hi and hi·lo before hi·hi, into one float32 accumulator.
// A block's work items are (split, tile) pairs, split-major: split z takes
// k stages z kc .. z kc + kc - 1 and, with splits > 1, writes its float32
// partial to partials[z] (M x N) for the split-K sum, else to c.  The
// epilogue stores from registers: a float32 row piece of 8 columns is one
// whole 32-byte sector.  What these stores cost was not measured (the bf16
// kernel's register stores cost 28% before it stored through shared memory
// and TMA).  With one consumer warpgroup the registers are not moved
// between warpgroups (setmaxnreg): a thread of its 256 may hold 255.
template <typename Tl>
__global__ void __launch_bounds__(Tl::THREADS, 1)
matmul_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     float* __restrict__ c, float* __restrict__ partials,
                     int M, int N, int Kp, int kc, int splits) {
  using namespace hopper;
  using tf::BK;
  constexpr int BM = Tl::BM, BN = Tl::BN, STAGES = Tl::STAGES;
  constexpr int CONSUMERS = Tl::CONSUMERS;
  constexpr int A_BYTES = Tl::A_BYTES, B_BYTES = Tl::B_BYTES;
  constexpr int STAGE = Tl::STAGE;
  extern __shared__ unsigned char smem_raw[];
  // [STAGES][a_hi, a_lo, bT_hi, bT_lo]
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
  uint64_t* empty = full + STAGES;

  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_n * ((M + BM - 1) / BM);
  const int items = tiles * splits;
  const int nk = Kp / BK;
  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == CONSUMERS) {   // producer
    if constexpr (CONSUMERS > 1) setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;   // k stages loaded so far, over all this block's items
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const int z = t / tiles, r = t % tiles;
        const int m0 = r / tiles_n * BM, n0 = r % tiles_n * BN;
        const int kb = z * kc, ke = min(nk, kb + kc);
        for (int kt = kb; kt < ke; ++kt, ++it) {
          const int s = it % STAGES;
          unsigned char* st = ring + s * STAGE;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], STAGE);
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // 0: hi, 1: lo
            tma_load_3d(st + h * A_BYTES, &map_a, &full[s], kt * BK, m0, h);
            tma_load_3d(st + 2 * A_BYTES + h * B_BYTES, &map_b, &full[s],
                        kt * BK, n0, h);
          }
        }
      }
    }
  } else {                  // consumers
    if constexpr (CONSUMERS > 1) setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool even = N % 2 == 0;   // pieces (col, col + 1) 8-byte aligned
    Acc<BN> acc;
    int it = 0;
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      const int z = t / tiles, r = t % tiles;
      const int m0 = r / tiles_n * BM, n0 = r % tiles_n * BN;
      const int kb = z * kc, ke = min(nk, kb + kc);
      float* out = splits > 1 ? partials + (long long)z * M * N : c;
      acc_zero(acc);
      for (int kt = kb; kt < ke; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* a_hi = ring + s * STAGE + wgi * 64 * 128;
        const unsigned char* a_lo = a_hi + A_BYTES;
        const unsigned char* b_hi = ring + s * STAGE + 2 * A_BYTES;
        const unsigned char* b_lo = b_hi + B_BYTES;
        acc_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const uint64_t ah = desc_sw128(a_hi + 32 * kk, 16, 1024),
                         al = desc_sw128(a_lo + 32 * kk, 16, 1024),
                         bh = desc_sw128(b_hi + 32 * kk, 16, 1024),
                         bl = desc_sw128(b_lo + 32 * kk, 16, 1024);
          wgmma_ss_tf32(acc, al, bh, 1);
          wgmma_ss_tf32(acc, ah, bl, 1);
          wgmma_ss_tf32(acc, ah, bh, 1);
        }
        wgmma_commit();
        acc_fence(acc);
        wgmma_wait<1>();   // the previous stage's products are done
        if (kt > kb && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      acc_fence(acc);
      if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);

      // acc.r[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h of the
      // warpgroup's 64, column 8 j + 2 (lane % 4) + e
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 64 * wgi + 16 * warp + lane / 4 + 8 * h;
          const int col = n0 + 8 * j + 2 * (lane % 4);
          if (row >= M || col >= N) continue;
          float* o = out + (long long)row * N + col;
          const float x = acc.r[4 * j + 2 * h], y = acc.r[4 * j + 2 * h + 1];
          if (even && col + 1 < N) {
            *reinterpret_cast<float2*>(o) = make_float2(x, y);
          } else {
            o[0] = x;
            if (col + 1 < N) o[1] = y;
          }
        }
    }
  }
}

// float32 elements of the split operands, a's and b^T's hi and lo, (M + N)
// rows of Kp, and of the split-K partials behind them (splits x M x N where
// splits > 1); nvdla_matmul.py::tf32x3_workspace computes the same
long long tf32x3_workspace(int M, int N, int K, int splits) {
  return 2LL * kpad(K) * (M + N) +
         (splits > 1 ? (long long)splits * M * N : 0);
}

// The split pass, then the product at tile Tl over `splits` k ranges on the
// same stream, then (splits > 1) the split-K sum.  ws: n_ws float32
// elements, at least tf32x3_workspace(M, N, K, splits), 16-byte aligned.
template <typename Tl>
cudaError_t launch_tf32x3(const float* a, const float* b, float* c, float* ws,
                          long long n_ws, int M, int N, int K, int splits,
                          cudaStream_t stream) {
  using tf::SPLIT_T;
  const int kchunk = split_chunk(K, splits, tf::BK);
  if (!kchunk || !ws || n_ws < tf32x3_workspace(M, N, K, splits))
    return cudaErrorInvalidValue;
  const int Kp = kpad(K);
  const long long split_tiles =
      (long long)((M + SPLIT_T - 1) / SPLIT_T + (N + SPLIT_T - 1) / SPLIT_T) *
      ((Kp + SPLIT_T - 1) / SPLIT_T);
  tf32_split_kernel<<<(unsigned)split_tiles, 256, 0, stream>>>(a, b, ws, M, N,
                                                               K, Kp);
  cudaError_t err = cudaGetLastError();
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = hopper::device_sms(&device, &sms);
  // (Kp, rows, 2) maps: the third index picks hi or lo
  CUtensorMap map_a, map_b;
  const cuuint64_t row_bytes = (cuuint64_t)Kp * 4;
  const cuuint64_t a_dims[3] = {(cuuint64_t)Kp, (cuuint64_t)M, 2};
  const cuuint64_t a_strides[2] = {row_bytes, row_bytes * M};
  const cuuint32_t a_box[3] = {tf::BK, Tl::BM, 1};
  const cuuint64_t b_dims[3] = {(cuuint64_t)Kp, (cuuint64_t)N, 2};
  const cuuint64_t b_strides[2] = {row_bytes, row_bytes * N};
  const cuuint32_t b_box[3] = {tf::BK, Tl::BN, 1};
  if (err == cudaSuccess)
    err = hopper::make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws, 3,
                           a_dims, a_strides, a_box);
  if (err == cudaSuccess)
    err = hopper::make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                           ws + 2LL * M * Kp, 3, b_dims, b_strides, b_box);
  static std::atomic<uint64_t> smem_set{0};
  if (err == cudaSuccess)
    err = hopper::smem_limit_once(smem_set, matmul_tf32x3_kernel<Tl>,
                                  (int)Tl::SMEM, device);
  if (err != cudaSuccess) return err;
  float* partials = ws + 2LL * Kp * (M + N);
  const long long items = (long long)((N + Tl::BN - 1) / Tl::BN) *
                          ((M + Tl::BM - 1) / Tl::BM) * splits;
  const int grid = (int)(items < sms ? items : sms);
  matmul_tf32x3_kernel<Tl><<<grid, Tl::THREADS, Tl::SMEM, stream>>>(
      map_a, map_b, c, partials, M, N, Kp, kchunk / tf::BK, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits<float>(partials, c, M, N, splits, stream);
}

// ---------------------------------------------------------------------------
// float32 decoding rows: b streamed once (the stream variant)

constexpr int S_NT = 256;          // threads per block
constexpr int S_BN = 4 * S_NT;     // columns per block, 4 a thread
constexpr int S_U = 8;             // k rows in flight per thread

// b[k][n .. n + 3] (zeros past N); vec: N % 4 == 0, so the piece is one
// aligned 16-byte read-only load
__device__ __forceinline__ float4 load_b4(const float* b, int k, int n, int N,
                                          bool vec) {
  const float* p = b + (long long)k * N + n;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), n + 1 < N ? __ldg(p + 1) : 0.f,
                     n + 2 < N ? __ldg(p + 2) : 0.f,
                     n + 3 < N ? __ldg(p + 3) : 0.f);
}

// MT >= M rows a thread; the block's columns are blockIdx.x S_BN + 4 tid ..
// + 3, its k range blockIdx.y kchunk .. + kchunk - 1.  With ws the block
// writes its partial to ws[blockIdx.y], else the result to c.
template <int MT>
__global__ void __launch_bounds__(S_NT)
matmul_f32_stream_kernel(const float* __restrict__ a,
                         const float* __restrict__ b, float* __restrict__ c,
                         float* __restrict__ ws, int M, int N, int K,
                         int kchunk) {
  const int n = blockIdx.x * S_BN + 4 * threadIdx.x;
  if (n >= N) return;
  const int kb = blockIdx.y * kchunk, ke = min(K, kb + kchunk);
  const bool vec = N % 4 == 0;
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += S_U) {
    float4 bv[S_U];
#pragma unroll
    for (int u = 0; u < S_U; ++u)
      bv[u] = k0 + u < ke ? load_b4(b, k0 + u, n, N, vec)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < S_U; ++u)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float av =
            m < M && k0 + u < ke ? __ldg(a + (long long)m * K + k0 + u) : 0.f;
        acc[m][0] = fmaf(av, bv[u].x, acc[m][0]);
        acc[m][1] = fmaf(av, bv[u].y, acc[m][1]);
        acc[m][2] = fmaf(av, bv[u].z, acc[m][2]);
        acc[m][3] = fmaf(av, bv[u].w, acc[m][3]);
      }
  }

  float* out = ws ? ws + (long long)blockIdx.y * M * N : c;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
    float* p = out + (long long)m * N + n;
    if (vec) {
      *reinterpret_cast<float4*>(p) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) p[j] = acc[m][j];
    }
  }
}

// the stream kernel over `splits` k ranges, each a multiple of S_U rows
template <int MT>
cudaError_t launch_stream_mt(const float* a, const float* b, float* c,
                             float* ws, int M, int N, int K, int splits,
                             cudaStream_t stream) {
  const int kchunk = split_chunk(K, splits, S_U);
  if (!kchunk || (splits > 1 && !ws)) return cudaErrorInvalidValue;
  const dim3 grid((N + S_BN - 1) / S_BN, splits);
  matmul_f32_stream_kernel<MT><<<grid, S_NT, 0, stream>>>(
      a, b, c, splits > 1 ? ws : nullptr, M, N, K, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return sum_splits<float>(ws, c, M, N, splits, stream);
}

// M rounded up to 4, 8 or 16 rows: the kernel is bound by b's bytes, so the
// FMAs of the rows past M cost nothing
cudaError_t launch_stream(const float* a, const float* b, float* c, float* ws,
                          int M, int N, int K, int splits,
                          cudaStream_t stream) {
  if (M <= 4) return launch_stream_mt<4>(a, b, c, ws, M, N, K, splits, stream);
  if (M <= 8) return launch_stream_mt<8>(a, b, c, ws, M, N, K, splits, stream);
  if (M <= SMALL_M)
    return launch_stream_mt<16>(a, b, c, ws, M, N, K, splits, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Kernel variants, chosen by the caller (nvdla_matmul.py::variant):
// 0 float32 FMAs, 1 bf16 mma.sync, 2 bf16 wgmma with TMA, 3 float32 stream
// (M <= 16), 4 float32 three TF32 passes on wgmma.
enum Variant { kFma = 0, kMmaSync = 1, kWgmma = 2, kStream = 3, kTf32x3 = 4 };

// float32 elements of the workspace an (M, N, K) product needs under a
// variant with K split over `splits` blocks: tf32x3's split operands, and
// the split-K partials, splits * M * N, where splits > 1.
extern "C" long long nvdla_matmul_workspace(int M, int N, int K, int variant,
                                            int splits) {
  if (M < 1 || N < 1 || K < 1 || splits < 1) return 0;
  if (variant == kTf32x3) return tf32x3_workspace(M, N, K, splits);
  return splits > 1 ? (long long)splits * M * N : 0;
}

// a tile's key: output rows and columns, k a step
constexpr int tile(int bm, int bn, int bk) {
  return (bm << 20) | (bn << 8) | bk;
}

// a: (M, K), b: (K, N), c: (M, N), all row-major, contiguous and of one type,
// 16-byte aligned: dtype 0 is float32 (variants 0, 3 with M <= 16, 4), 1 is
// bfloat16 (variant 1, or 2 when K % 8 == 0 and N % 8 == 0).  Any M, N,
// K >= 1.  (bm, bn, bk) names one of the variant's tiles
// (tiling.py::H100_MATMUL_KERNELS), K split over `splits` blocks (wgmma:
// 1; a count tiling.py::aligned_splits gives); any other tile or count is
// refused.  ws: n_ws float32 elements, at least nvdla_matmul_workspace(M,
// N, K, variant, splits), or null when that is 0; a shorter workspace is
// refused.  Returns the cudaError_t of the launch (0 on success).
extern "C" int nvdla_matmul(const void* a, const void* b, void* c, void* ws,
                            long long n_ws, int M, int N, int K, int dtype,
                            int variant, int bm, int bn, int bk, int splits,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  if (M < 1 || N < 1 || K < 1 || splits < 1 || bm < 1 || bm >= 2048 ||
      bn < 1 || bn >= 4096 || bk < 1 || bk >= 256 ||
      (ws ? n_ws : 0) < nvdla_matmul_workspace(M, N, K, variant, splits))
    return (int)cudaErrorInvalidValue;
  const float *af = static_cast<const float*>(a),
              *bf = static_cast<const float*>(b);
  float* cf = static_cast<float*>(c);
  const int t = tile(bm, bn, bk);
  if (dtype == 0 && variant == kFma) {
    if (t == tile(16, F_BN, 16))
      return (int)launch<float>(matmul_f32_kernel<1, 16>, F_NT, 16, F_BN, a,
                                b, c, w, M, N, K, splits, st);
    if (t == tile(128, F_BN, 8))
      return (int)launch<float>(matmul_f32_kernel<8, 8>, F_NT, 128, F_BN, a,
                                b, c, w, M, N, K, splits, st);
  }
  if (dtype == 0 && variant == kStream && t == tile(16, S_BN, S_U))
    return (int)launch_stream(af, bf, cf, w, M, N, K, splits, st);
  if (dtype == 0 && variant == kTf32x3) {
    using tf::Tile;
    switch (t) {
      case tile(64, 64, 32):
        return (int)launch_tf32x3<Tile<64, 64, 4>>(af, bf, cf, w, n_ws, M, N,
                                                   K, splits, st);
      case tile(64, 112, 32):
        return (int)launch_tf32x3<Tile<64, 112, 4>>(af, bf, cf, w, n_ws, M, N,
                                                    K, splits, st);
      case tile(64, 128, 32):
        return (int)launch_tf32x3<Tile<64, 128, 4>>(af, bf, cf, w, n_ws, M, N,
                                                    K, splits, st);
      case tile(64, 256, 32):
        return (int)launch_tf32x3<Tile<64, 256, 2>>(af, bf, cf, w, n_ws, M, N,
                                                    K, splits, st);
      case tile(128, 64, 32):
        return (int)launch_tf32x3<Tile<128, 64, 4>>(af, bf, cf, w, n_ws, M, N,
                                                    K, splits, st);
      case tile(128, 112, 32):
        return (int)launch_tf32x3<Tile<128, 112, 3>>(af, bf, cf, w, n_ws, M,
                                                     N, K, splits, st);
      case tile(128, 128, 32):
        return (int)launch_tf32x3<Tile<128, 128, 3>>(af, bf, cf, w, n_ws, M,
                                                     N, K, splits, st);
      case tile(128, 256, 32):
        return (int)launch_tf32x3<Tile<128, 256, 2>>(af, bf, cf, w, n_ws, M,
                                                     N, K, splits, st);
    }
  }
  if (dtype == 1 && variant == kMmaSync) {
    if (t == tile(16, 128, H_BK))
      return (int)launch<__nv_bfloat16>(matmul_bf16_kernel<1, 4, 1, 4>, 128,
                                        16, 128, a, b, c, w, M, N, K, splits,
                                        st);
    if (t == tile(128, 128, H_BK))
      return (int)launch<__nv_bfloat16>(matmul_bf16_kernel<2, 4, 4, 4>, 256,
                                        128, 128, a, b, c, w, M, N, K, splits,
                                        st);
  }
  if (dtype == 1 && variant == kWgmma && splits == 1) {
    using wg::Tile;
    switch (t) {
      case tile(wg::BM, 64, wg::BK):
        return (int)launch_wgmma<Tile<64, 4>>(a, b, c, M, N, K, st);
      case tile(wg::BM, 128, wg::BK):
        return (int)launch_wgmma<Tile<128, 4>>(a, b, c, M, N, K, st);
      case tile(wg::BM, 256, wg::BK):
        return (int)launch_wgmma<Tile<256, 3>>(a, b, c, M, N, K, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
