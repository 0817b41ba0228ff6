// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (flash_attention.cuh, nvdla_matmul.cu): inline PTX for mbarriers, TMA
// tensor loads and stores, wgmma shared-memory descriptors and products (bf16
// and TF32), the TF32 hi/lo split, and register reallocation between
// warpgroups, plus the host-side encoding of a TMA tensor map and the
// one-time, per-device set-up of a persistent kernel's launch.
//
// The shared-memory layout every helper here assumes is the one a TMA load
// with 128-byte swizzle writes: boxes whose inner dimension is 128 bytes (64
// bf16 or 32 fp32), each row's eight 16-byte pieces XOR-permuted by the
// row's index mod 8, every box starting on a 1024-byte boundary.  A wgmma
// operand is then described by desc_sw128:
//  - K-major (the reduction dimension contiguous, as a's rows in a @ b, or
//    q's and k's rows in q k^T): SBO = 1024 bytes between groups of 8 rows,
//    LBO unused; the 32-byte k step kk inside a box (k16 of bf16, k8 of
//    TF32) starts 32 kk bytes further on.
//  - MN-major, bf16 only (the output dimension contiguous, as b's rows in
//    a @ b or v's rows in p v; the product's transpose-B bit is set): SBO =
//    1024 bytes between groups of 8 k rows, LBO = the distance between boxes
//    of 64 output columns; the k16 step kk starts 16 rows (2048 bytes)
//    further on.  A product narrower than a box (N = 16 or 32) reads the
//    first N columns of each swizzled row.
// A box may be wider than the tensor (a head dim of 16, 32 or 96 in boxes
// of 64 bf16 or 32 fp32): TMA writes zeros past the tensor's edge, and
// those bytes count toward the barrier's transaction bytes like the rest.
//
// The tensor map is encoded on the host with cuTensorMapEncodeTiled, which
// lives in the driver; it is reached through the runtime's entry-point query,
// so that the libraries need no -lcuda.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums: types only
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned address at or after p (a swizzled TMA box
// must start on one); a kernel asks for 1024 bytes more than it uses
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------------
// mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also tells the barrier to wait for `bytes` of TMA data
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// spins until the phase of parity `parity` has completed.  A barrier starts
// in phase 0, so waiting on parity 1 passes at once: a ring's producer waits
// on its empty barriers with the parity flipped.  A wait that outlasts any
// real one by far (2^26 polls) traps, so that a fault in the ring surfaces
// as a launch error and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA: one thread copies a box of a tensor into shared memory; the barrier
// counts its bytes.  Coordinates are in elements, innermost first; parts of
// the box outside the tensor arrive as zeros (and still count).

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a box of shared memory (laid out as a load of the same map would write it)
// into the tensor; parts of the box outside the tensor are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// waits until this thread's stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// waits until this thread's stores are done
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// makes this thread's plain shared-memory writes visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a barrier for `threads` threads of the block (named barrier `id` > 0)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFFu) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFFu) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// The float32 accumulator of a 64 x N product: N / 2 registers a thread.
// r[4 j + e] is row 16 w + lane / 4 + 8 (e / 2) and column 8 j + 2 (lane % 4)
// + (e & 1), for warp w of the warpgroup: the mma.sync m16n8 layout, once per
// 8 columns.
template <int N>
struct Acc {
  float r[N / 2];
};

template <int N>
__device__ __forceinline__ void acc_zero(Acc<N>& d) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d.r[i] = 0.f;
}

// keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous products
template <int N>
__device__ __forceinline__ void acc_fence(Acc<N>& d) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d.r[i]) :: "memory");
}

// d (+)= a b for a 64 x 16 bf16 A and a 16 x N bf16 B, float32 accumulate;
// scale_d = 0 overwrites d.  wgmma_ss reads A from shared memory (K-major),
// wgmma_rs from registers in the mma.sync m16n8k16 A layout (rows 16 w ..
// 16 w + 15 for warp w).  TB = 1 marks B as MN-major (transpose-B).
// Generated text: one overload per N the kernels use (32, 64, 128 and 256
// from shared memory: flash attention's S = Q K^T at N = bk; 16, 32, 64, 80,
// 96, 128, 192 and 256 from registers: its P V at N = D), as the instruction
// names every accumulator register.
template <int TB>
__device__ __forceinline__ void wgmma_ss(Acc<32>& d, uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "},"
      " %16, %17, p, 1, 1, 0, %19;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(Acc<64>& d, uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "},"
      " %32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(Acc<128>& d, uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "},"
      " %64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]), "+f"(d.r[40]), "+f"(d.r[41]),
        "+f"(d.r[42]), "+f"(d.r[43]), "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47]),
        "+f"(d.r[48]), "+f"(d.r[49]), "+f"(d.r[50]), "+f"(d.r[51]), "+f"(d.r[52]), "+f"(d.r[53]),
        "+f"(d.r[54]), "+f"(d.r[55]), "+f"(d.r[56]), "+f"(d.r[57]), "+f"(d.r[58]), "+f"(d.r[59]),
        "+f"(d.r[60]), "+f"(d.r[61]), "+f"(d.r[62]), "+f"(d.r[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(Acc<256>& d, uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "},"
      " %128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]), "+f"(d.r[40]), "+f"(d.r[41]),
        "+f"(d.r[42]), "+f"(d.r[43]), "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47]),
        "+f"(d.r[48]), "+f"(d.r[49]), "+f"(d.r[50]), "+f"(d.r[51]), "+f"(d.r[52]), "+f"(d.r[53]),
        "+f"(d.r[54]), "+f"(d.r[55]), "+f"(d.r[56]), "+f"(d.r[57]), "+f"(d.r[58]), "+f"(d.r[59]),
        "+f"(d.r[60]), "+f"(d.r[61]), "+f"(d.r[62]), "+f"(d.r[63]), "+f"(d.r[64]), "+f"(d.r[65]),
        "+f"(d.r[66]), "+f"(d.r[67]), "+f"(d.r[68]), "+f"(d.r[69]), "+f"(d.r[70]), "+f"(d.r[71]),
        "+f"(d.r[72]), "+f"(d.r[73]), "+f"(d.r[74]), "+f"(d.r[75]), "+f"(d.r[76]), "+f"(d.r[77]),
        "+f"(d.r[78]), "+f"(d.r[79]), "+f"(d.r[80]), "+f"(d.r[81]), "+f"(d.r[82]), "+f"(d.r[83]),
        "+f"(d.r[84]), "+f"(d.r[85]), "+f"(d.r[86]), "+f"(d.r[87]), "+f"(d.r[88]), "+f"(d.r[89]),
        "+f"(d.r[90]), "+f"(d.r[91]), "+f"(d.r[92]), "+f"(d.r[93]), "+f"(d.r[94]), "+f"(d.r[95]),
        "+f"(d.r[96]), "+f"(d.r[97]), "+f"(d.r[98]), "+f"(d.r[99]), "+f"(d.r[100]), "+f"(d.r[101]),
        "+f"(d.r[102]), "+f"(d.r[103]), "+f"(d.r[104]), "+f"(d.r[105]), "+f"(d.r[106]), "+f"(d.r[107]),
        "+f"(d.r[108]), "+f"(d.r[109]), "+f"(d.r[110]), "+f"(d.r[111]), "+f"(d.r[112]), "+f"(d.r[113]),
        "+f"(d.r[114]), "+f"(d.r[115]), "+f"(d.r[116]), "+f"(d.r[117]), "+f"(d.r[118]), "+f"(d.r[119]),
        "+f"(d.r[120]), "+f"(d.r[121]), "+f"(d.r[122]), "+f"(d.r[123]), "+f"(d.r[124]), "+f"(d.r[125]),
        "+f"(d.r[126]), "+f"(d.r[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(Acc<16>& d, const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(Acc<32>& d, const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(Acc<64>& d, const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(Acc<80>& d, const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "},"
      " {%40, %41, %42, %43}, %44, p, 1, 1, %46;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(Acc<96>& d, const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "},"
      " {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]), "+f"(d.r[40]), "+f"(d.r[41]),
        "+f"(d.r[42]), "+f"(d.r[43]), "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(Acc<128>& d, const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]), "+f"(d.r[40]), "+f"(d.r[41]),
        "+f"(d.r[42]), "+f"(d.r[43]), "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47]),
        "+f"(d.r[48]), "+f"(d.r[49]), "+f"(d.r[50]), "+f"(d.r[51]), "+f"(d.r[52]), "+f"(d.r[53]),
        "+f"(d.r[54]), "+f"(d.r[55]), "+f"(d.r[56]), "+f"(d.r[57]), "+f"(d.r[58]), "+f"(d.r[59]),
        "+f"(d.r[60]), "+f"(d.r[61]), "+f"(d.r[62]), "+f"(d.r[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(Acc<192>& d, const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "},"
      " {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]), "+f"(d.r[40]), "+f"(d.r[41]),
        "+f"(d.r[42]), "+f"(d.r[43]), "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47]),
        "+f"(d.r[48]), "+f"(d.r[49]), "+f"(d.r[50]), "+f"(d.r[51]), "+f"(d.r[52]), "+f"(d.r[53]),
        "+f"(d.r[54]), "+f"(d.r[55]), "+f"(d.r[56]), "+f"(d.r[57]), "+f"(d.r[58]), "+f"(d.r[59]),
        "+f"(d.r[60]), "+f"(d.r[61]), "+f"(d.r[62]), "+f"(d.r[63]), "+f"(d.r[64]), "+f"(d.r[65]),
        "+f"(d.r[66]), "+f"(d.r[67]), "+f"(d.r[68]), "+f"(d.r[69]), "+f"(d.r[70]), "+f"(d.r[71]),
        "+f"(d.r[72]), "+f"(d.r[73]), "+f"(d.r[74]), "+f"(d.r[75]), "+f"(d.r[76]), "+f"(d.r[77]),
        "+f"(d.r[78]), "+f"(d.r[79]), "+f"(d.r[80]), "+f"(d.r[81]), "+f"(d.r[82]), "+f"(d.r[83]),
        "+f"(d.r[84]), "+f"(d.r[85]), "+f"(d.r[86]), "+f"(d.r[87]), "+f"(d.r[88]), "+f"(d.r[89]),
        "+f"(d.r[90]), "+f"(d.r[91]), "+f"(d.r[92]), "+f"(d.r[93]), "+f"(d.r[94]), "+f"(d.r[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(Acc<256>& d, const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]), "+f"(d.r[40]), "+f"(d.r[41]),
        "+f"(d.r[42]), "+f"(d.r[43]), "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47]),
        "+f"(d.r[48]), "+f"(d.r[49]), "+f"(d.r[50]), "+f"(d.r[51]), "+f"(d.r[52]), "+f"(d.r[53]),
        "+f"(d.r[54]), "+f"(d.r[55]), "+f"(d.r[56]), "+f"(d.r[57]), "+f"(d.r[58]), "+f"(d.r[59]),
        "+f"(d.r[60]), "+f"(d.r[61]), "+f"(d.r[62]), "+f"(d.r[63]), "+f"(d.r[64]), "+f"(d.r[65]),
        "+f"(d.r[66]), "+f"(d.r[67]), "+f"(d.r[68]), "+f"(d.r[69]), "+f"(d.r[70]), "+f"(d.r[71]),
        "+f"(d.r[72]), "+f"(d.r[73]), "+f"(d.r[74]), "+f"(d.r[75]), "+f"(d.r[76]), "+f"(d.r[77]),
        "+f"(d.r[78]), "+f"(d.r[79]), "+f"(d.r[80]), "+f"(d.r[81]), "+f"(d.r[82]), "+f"(d.r[83]),
        "+f"(d.r[84]), "+f"(d.r[85]), "+f"(d.r[86]), "+f"(d.r[87]), "+f"(d.r[88]), "+f"(d.r[89]),
        "+f"(d.r[90]), "+f"(d.r[91]), "+f"(d.r[92]), "+f"(d.r[93]), "+f"(d.r[94]), "+f"(d.r[95]),
        "+f"(d.r[96]), "+f"(d.r[97]), "+f"(d.r[98]), "+f"(d.r[99]), "+f"(d.r[100]), "+f"(d.r[101]),
        "+f"(d.r[102]), "+f"(d.r[103]), "+f"(d.r[104]), "+f"(d.r[105]), "+f"(d.r[106]), "+f"(d.r[107]),
        "+f"(d.r[108]), "+f"(d.r[109]), "+f"(d.r[110]), "+f"(d.r[111]), "+f"(d.r[112]), "+f"(d.r[113]),
        "+f"(d.r[114]), "+f"(d.r[115]), "+f"(d.r[116]), "+f"(d.r[117]), "+f"(d.r[118]), "+f"(d.r[119]),
        "+f"(d.r[120]), "+f"(d.r[121]), "+f"(d.r[122]), "+f"(d.r[123]), "+f"(d.r[124]), "+f"(d.r[125]),
        "+f"(d.r[126]), "+f"(d.r[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// d (+)= a b for a 64 x 8 tf32 A and an 8 x N tf32 B, float32 accumulate,
// both read from shared memory and both K-major: TF32 wgmma has no transpose
// bits, so an MN-major operand is transposed before it reaches shared memory.
// A 128-byte swizzled row holds 32 fp32 values, so the k8 step kk inside a
// box starts 32 kk bytes further on, as bf16's k16 step does.  The tensor
// cores read the top 19 bits of each 32-bit operand (see tf32_split).
// Generated text, one overload per N (flash attention's output at N = D:
// 16, 32, 64, 80, 96, 128, 192, 256, and its 64-key score tiles; the matmul's
// 112, 128, 256).
__device__ __forceinline__ void wgmma_ss_tf32(Acc<16>& d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "},"
      " %8, %9, p, 1, 1;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tf32(Acc<32>& d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "},"
      " %16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tf32(Acc<64>& d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "},"
      " %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tf32(Acc<80>& d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "},"
      " %40, %41, p, 1, 1;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tf32(Acc<96>& d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "},"
      " %48, %49, p, 1, 1;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]), "+f"(d.r[40]), "+f"(d.r[41]),
        "+f"(d.r[42]), "+f"(d.r[43]), "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tf32(Acc<112>& d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "},"
      " %56, %57, p, 1, 1;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]), "+f"(d.r[40]), "+f"(d.r[41]),
        "+f"(d.r[42]), "+f"(d.r[43]), "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47]),
        "+f"(d.r[48]), "+f"(d.r[49]), "+f"(d.r[50]), "+f"(d.r[51]), "+f"(d.r[52]), "+f"(d.r[53]),
        "+f"(d.r[54]), "+f"(d.r[55])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tf32(Acc<128>& d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "},"
      " %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]), "+f"(d.r[40]), "+f"(d.r[41]),
        "+f"(d.r[42]), "+f"(d.r[43]), "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47]),
        "+f"(d.r[48]), "+f"(d.r[49]), "+f"(d.r[50]), "+f"(d.r[51]), "+f"(d.r[52]), "+f"(d.r[53]),
        "+f"(d.r[54]), "+f"(d.r[55]), "+f"(d.r[56]), "+f"(d.r[57]), "+f"(d.r[58]), "+f"(d.r[59]),
        "+f"(d.r[60]), "+f"(d.r[61]), "+f"(d.r[62]), "+f"(d.r[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tf32(Acc<192>& d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "},"
      " %96, %97, p, 1, 1;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]), "+f"(d.r[40]), "+f"(d.r[41]),
        "+f"(d.r[42]), "+f"(d.r[43]), "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47]),
        "+f"(d.r[48]), "+f"(d.r[49]), "+f"(d.r[50]), "+f"(d.r[51]), "+f"(d.r[52]), "+f"(d.r[53]),
        "+f"(d.r[54]), "+f"(d.r[55]), "+f"(d.r[56]), "+f"(d.r[57]), "+f"(d.r[58]), "+f"(d.r[59]),
        "+f"(d.r[60]), "+f"(d.r[61]), "+f"(d.r[62]), "+f"(d.r[63]), "+f"(d.r[64]), "+f"(d.r[65]),
        "+f"(d.r[66]), "+f"(d.r[67]), "+f"(d.r[68]), "+f"(d.r[69]), "+f"(d.r[70]), "+f"(d.r[71]),
        "+f"(d.r[72]), "+f"(d.r[73]), "+f"(d.r[74]), "+f"(d.r[75]), "+f"(d.r[76]), "+f"(d.r[77]),
        "+f"(d.r[78]), "+f"(d.r[79]), "+f"(d.r[80]), "+f"(d.r[81]), "+f"(d.r[82]), "+f"(d.r[83]),
        "+f"(d.r[84]), "+f"(d.r[85]), "+f"(d.r[86]), "+f"(d.r[87]), "+f"(d.r[88]), "+f"(d.r[89]),
        "+f"(d.r[90]), "+f"(d.r[91]), "+f"(d.r[92]), "+f"(d.r[93]), "+f"(d.r[94]), "+f"(d.r[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_tf32(Acc<256>& d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "},"
      " %128, %129, p, 1, 1;\n"
      "}\n"
      : "+f"(d.r[0]), "+f"(d.r[1]), "+f"(d.r[2]), "+f"(d.r[3]), "+f"(d.r[4]), "+f"(d.r[5]),
        "+f"(d.r[6]), "+f"(d.r[7]), "+f"(d.r[8]), "+f"(d.r[9]), "+f"(d.r[10]), "+f"(d.r[11]),
        "+f"(d.r[12]), "+f"(d.r[13]), "+f"(d.r[14]), "+f"(d.r[15]), "+f"(d.r[16]), "+f"(d.r[17]),
        "+f"(d.r[18]), "+f"(d.r[19]), "+f"(d.r[20]), "+f"(d.r[21]), "+f"(d.r[22]), "+f"(d.r[23]),
        "+f"(d.r[24]), "+f"(d.r[25]), "+f"(d.r[26]), "+f"(d.r[27]), "+f"(d.r[28]), "+f"(d.r[29]),
        "+f"(d.r[30]), "+f"(d.r[31]), "+f"(d.r[32]), "+f"(d.r[33]), "+f"(d.r[34]), "+f"(d.r[35]),
        "+f"(d.r[36]), "+f"(d.r[37]), "+f"(d.r[38]), "+f"(d.r[39]), "+f"(d.r[40]), "+f"(d.r[41]),
        "+f"(d.r[42]), "+f"(d.r[43]), "+f"(d.r[44]), "+f"(d.r[45]), "+f"(d.r[46]), "+f"(d.r[47]),
        "+f"(d.r[48]), "+f"(d.r[49]), "+f"(d.r[50]), "+f"(d.r[51]), "+f"(d.r[52]), "+f"(d.r[53]),
        "+f"(d.r[54]), "+f"(d.r[55]), "+f"(d.r[56]), "+f"(d.r[57]), "+f"(d.r[58]), "+f"(d.r[59]),
        "+f"(d.r[60]), "+f"(d.r[61]), "+f"(d.r[62]), "+f"(d.r[63]), "+f"(d.r[64]), "+f"(d.r[65]),
        "+f"(d.r[66]), "+f"(d.r[67]), "+f"(d.r[68]), "+f"(d.r[69]), "+f"(d.r[70]), "+f"(d.r[71]),
        "+f"(d.r[72]), "+f"(d.r[73]), "+f"(d.r[74]), "+f"(d.r[75]), "+f"(d.r[76]), "+f"(d.r[77]),
        "+f"(d.r[78]), "+f"(d.r[79]), "+f"(d.r[80]), "+f"(d.r[81]), "+f"(d.r[82]), "+f"(d.r[83]),
        "+f"(d.r[84]), "+f"(d.r[85]), "+f"(d.r[86]), "+f"(d.r[87]), "+f"(d.r[88]), "+f"(d.r[89]),
        "+f"(d.r[90]), "+f"(d.r[91]), "+f"(d.r[92]), "+f"(d.r[93]), "+f"(d.r[94]), "+f"(d.r[95]),
        "+f"(d.r[96]), "+f"(d.r[97]), "+f"(d.r[98]), "+f"(d.r[99]), "+f"(d.r[100]), "+f"(d.r[101]),
        "+f"(d.r[102]), "+f"(d.r[103]), "+f"(d.r[104]), "+f"(d.r[105]), "+f"(d.r[106]), "+f"(d.r[107]),
        "+f"(d.r[108]), "+f"(d.r[109]), "+f"(d.r[110]), "+f"(d.r[111]), "+f"(d.r[112]), "+f"(d.r[113]),
        "+f"(d.r[114]), "+f"(d.r[115]), "+f"(d.r[116]), "+f"(d.r[117]), "+f"(d.r[118]), "+f"(d.r[119]),
        "+f"(d.r[120]), "+f"(d.r[121]), "+f"(d.r[122]), "+f"(d.r[123]), "+f"(d.r[124]), "+f"(d.r[125]),
        "+f"(d.r[126]), "+f"(d.r[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// x as a TF32 "hi" part and the TF32-rounded remainder "lo" (both with the
// low 13 mantissa bits zero, rounded to nearest, ties away): hi + lo holds x
// to about 2^-22 relative, so hi·hi + hi·lo + lo·hi on the tensor cores
// drops only lo·lo (CUTLASS's 3xTF32).
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - hi);
}

// ---------------------------------------------------------------------------
// warpgroup register reallocation: a producer warpgroup gives registers back,
// the consumers take them (counts are multiples of 8 in [24, 256])

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// ---------------------------------------------------------------------------
// host: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once; null if missing
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of a row-major tensor of `type` and `rank` dimensions (2 or
// 3), innermost first: dims[i] elements, strides[i] bytes between
// consecutive indices of dimension i + 1, boxes of box[i] elements (box[0]
// elements make one 128-byte swizzled row: 64 bf16 or 32 fp32, which may
// exceed dims[0]), 128-byte swizzle, zeros outside the tensor.  The base and every stride must be
// multiples of 16 bytes.  Returns a CUDA error code, 0 on success.
inline cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type,
                            const void* base, int rank,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides,
      box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline cudaError_t make_map_bf16(CUtensorMap* map, const void* base, int rank,
                                 const cuuint64_t* dims,
                                 const cuuint64_t* strides,
                                 const cuuint32_t* box) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims,
                  strides, box);
}

// ---------------------------------------------------------------------------
// host: launch set-up done once per device (the first 64; a device past
// them is queried on every call)

constexpr int CACHED_DEVICES = 64;

// The current device and its SM count, the count read once per device
inline cudaError_t device_sms(int* device, int* sms) {
  static std::atomic<int> cached[CACHED_DEVICES];
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  const bool keep = *device >= 0 && *device < CACHED_DEVICES;
  if (keep && (*sms = cached[*device].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *device);
  if (err == cudaSuccess && keep)
    cached[*device].store(*sms, std::memory_order_relaxed);
  return err;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on `device` once:
// `done` is the caller's bit set of the devices where it is raised (a static
// of its own for each kernel), so that later launches skip the call.
template <typename Kernel>
inline cudaError_t smem_limit_once(std::atomic<uint64_t>& done, Kernel kernel,
                                   int bytes, int device) {
  const uint64_t bit =
      device >= 0 && device < CACHED_DEVICES ? uint64_t(1) << device : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace hopper
