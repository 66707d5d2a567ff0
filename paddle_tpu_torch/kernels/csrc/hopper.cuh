// Hopper (sm_90a) building blocks shared by the port's TMA/wgmma kernels.
//
// What is here, and the conventions every kernel that includes it keeps:
//  * Tiles in shared memory are written by TMA with 128-byte swizzle: a
//    box has an inner extent of 64 bf16 values (128 bytes), so a tile that
//    is 128 values deep along its contiguous dimension is two boxes, one
//    after the other. Every box starts on a 1024-byte boundary (one swizzle
//    atom: 8 rows of 128 bytes), so the hardware's swizzle, computed from
//    address bits, matches the one wgmma undoes.
//  * wgmma shared-memory descriptors (desc_k_major / desc_mn_major):
//      K-major (the contiguous dimension is the product's k): rows of 128
//        bytes, 8-row groups 1024 bytes apart (the stride byte offset);
//        the leading byte offset is unused with swizzle. A k16 step is 32
//        bytes further along the row: the start address moves by 32 bytes
//        inside the atom (the swizzle is applied to the final address).
//      MN-major (the contiguous dimension is m or n; the transpose bit):
//        k-rows of 128 bytes holding 64 consecutive m (or n) values; 8-row
//        groups along k 1024 bytes apart (stride byte offset); the next 64
//        values of m or n are the next box (leading byte offset = one box).
//        A k16 step is two 8-row groups: the start moves by 2048 bytes.
//  * wgmma_* wrap wgmma.mma_async for a 64-row warpgroup tile with f32
//    accumulators (A MN-major with wgmma_ss's TransA, B with TransB):
//    d[4 j + 0, 1] hold row 16 w + lane / 4, columns
//    8 j + 2 (lane % 4) + {0, 1} of warp w, d[4 j + 2, 3] the row 8 below
//    (the mma.sync m16n8 C layout, repeated across n). The register-A form
//    takes each warp's 16 rows in the mma.sync m16n8k16 A layout, so two
//    adjacent n8 column blocks of an accumulator become one k16 A fragment.
//  * mbarriers: mbar_wait(bar, parity) returns once the phase of that
//    parity has completed. A ring stage's "full" barrier is armed by the
//    producer (arrive + expected transaction bytes) and completed by TMA;
//    its "empty" barrier is completed by the consumers' arrivals. The
//    producer waits on empty with the inverted parity, so its first pass
//    over the ring does not block.
//  * Host side: encode_map builds a CUtensorMap of any element type and
//    swizzle (encode_bf16_map / encode_16bit_map: bf16 or f16 with 128-byte
//    swizzle), out-of-bounds elements reading as zeros. cuTensorMapEncodeTiled
//    is a driver function: it is looked up at run time through the CUDA
//    runtime's cudaGetDriverEntryPoint (ByVersion where the toolkit has
//    it), so the libraries link against the runtime only, not -lcuda. The
//    map travels to the kernel by value, as a __grid_constant__ const
//    CUtensorMap parameter.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda link
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A wait that never completes (a TMA that faulted, a miscounted arrival)
// traps after 4 s, so the launch fails with an error instead of holding
// the card. The clock is read only once the first poll has failed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

// -------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// `bytes` contiguous bytes from global src into shared memory at dst,
// completing on bar (both addresses and bytes multiples of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one box of a tensor map into shared memory at dst, completing on bar;
// coordinates innermost first, in elements, and may lie out of bounds
// (those elements read as zeros)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a box of shared memory at src (written by this CTA's threads, then
// fence_proxy_async) to the tensor map's coordinates; out-of-bounds
// elements are not written. Completion is tracked per issuing thread by
// bulk groups: bulk_commit, then bulk_wait_read (the source may be
// reused) or bulk_wait (the writes are done)
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}
// orders this thread's shared-memory writes before TMA's reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1-15; 0 is __syncthreads) across `threads` threads
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------ warp specialisation
// give registers back (the producer) or take them (the consumers); every
// warp of a warpgroup runs it
template <int Regs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(Regs));
}
template <int Regs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(Regs));
}

// ------------------------------------------------------------------ wgmma
constexpr uint32_t kSwizzleAtom = 1024;  // 8 rows x 128 bytes

__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return static_cast<uint64_t>((bytes & 0x3FFFF) >> 4);
}

// 128-byte swizzle descriptor (layout type 1) for the operand at smem
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  return desc_field(smem_u32(smem)) | (desc_field(lbo) << 16) |
         (desc_field(sbo) << 32) | (1ull << 62);
}

// K-major operand: rows of one 128-byte box row, 8-row groups 1024 apart
__device__ __forceinline__ uint64_t desc_k_major(const void* smem) {
  return make_desc(smem, 16, kSwizzleAtom);
}

// MN-major operand: 64-value boxes of box_bytes each along m or n
__device__ __forceinline__ uint64_t desc_mn_major(const void* smem,
                                                  uint32_t box_bytes) {
  return make_desc(smem, box_bytes, kSwizzleAtom);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads of wgmma's registers across the
// wait (the asm's outputs are defined only once the group completes)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory,
// bf16 (wgmma_ss_n64) or f16 (wgmma_ss_n64_f16) operands
#define HOPPER_WGMMA_SS_N64(NAME, TY) \
template <int TransB, int TransA = 0> \
__device__ __forceinline__ void NAME(float (&d)[32], uint64_t a, \
                                     uint64_t b, int scale_d) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, %32, %33, p, 1, 1, %36, %35;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransB), "n"(TransA)); \
}
HOPPER_WGMMA_SS_N64(wgmma_ss_n64, "bf16")
HOPPER_WGMMA_SS_N64(wgmma_ss_n64_f16, "f16")

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory,
// bf16 (wgmma_ss_n128) or f16 (wgmma_ss_n128_f16) operands
#define HOPPER_WGMMA_SS_N128(NAME, TY) \
template <int TransB, int TransA = 0> \
__device__ __forceinline__ void NAME(float (&d)[64], uint64_t a, \
                                            uint64_t b, int scale_d) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
      "%60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, %68, %67;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransB), "n"(TransA)); \
}
HOPPER_WGMMA_SS_N128(wgmma_ss_n128, "bf16")
HOPPER_WGMMA_SS_N128(wgmma_ss_n128_f16, "f16")

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], A and B from shared memory,
// bf16 (wgmma_ss_n256) or f16 (wgmma_ss_n256_f16) operands
#define HOPPER_WGMMA_SS_N256(NAME, TY) \
template <int TransB, int TransA = 0> \
__device__ __forceinline__ void NAME(float (&d)[128], uint64_t a, \
                                            uint64_t b, int scale_d) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
      "%120, %121, %122, %123, %124, %125, %126, %127" \
      "}, %128, %129, p, 1, 1, %132, %131;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransB), "n"(TransA)); \
}
HOPPER_WGMMA_SS_N256(wgmma_ss_n256, "bf16")
HOPPER_WGMMA_SS_N256(wgmma_ss_n256_f16, "f16")

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the mma.sync
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory;
// bf16 (wgmma_rs_n64) or f16 (wgmma_rs_n64_f16) operands
#define HOPPER_WGMMA_RS_N64(NAME, TY) \
template <int TransB> \
__device__ __forceinline__ void NAME(float (&d)[32], \
                                            const uint32_t (&a)[4], uint64_t b, \
                                            int scale_d) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31" \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB)); \
}
HOPPER_WGMMA_RS_N64(wgmma_rs_n64, "bf16")
HOPPER_WGMMA_RS_N64(wgmma_rs_n64_f16, "f16")

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (the mma.sync
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory;
// bf16 (wgmma_rs_n128) or f16 (wgmma_rs_n128_f16) operands
#define HOPPER_WGMMA_RS_N128(NAME, TY) \
template <int TransB> \
__device__ __forceinline__ void NAME(float (&d)[64], \
                                            const uint32_t (&a)[4], uint64_t b, \
                                            int scale_d) { \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
      "%60, %61, %62, %63" \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB)); \
}
HOPPER_WGMMA_RS_N128(wgmma_rs_n128, "bf16")
HOPPER_WGMMA_RS_N128(wgmma_rs_n128_f16, "f16")

// wgmma_ss<N, TransB[, E[, TransA]]> / wgmma_rs<N, TransB[, E]>: the
// wrappers above by width and operand type E (bf16 or __half). TransA = 1
// reads A from shared memory MN-major (its 64 rows contiguous, as
// desc_mn_major describes; only the shared-memory form has the bit), 0
// K-major, the default every existing caller compiles to.
template <int N, int TransB, typename E = __nv_bfloat16, int TransA = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  constexpr bool kHalf = std::is_same<E, __half>::value;
  static_assert(kHalf || std::is_same<E, __nv_bfloat16>::value,
                "wgmma_ss: E is bf16 or __half");
  if constexpr (N == 64) {
    if constexpr (kHalf) wgmma_ss_n64_f16<TransB, TransA>(d, a, b, scale_d);
    else wgmma_ss_n64<TransB, TransA>(d, a, b, scale_d);
  } else if constexpr (N == 128) {
    if constexpr (kHalf) wgmma_ss_n128_f16<TransB, TransA>(d, a, b, scale_d);
    else wgmma_ss_n128<TransB, TransA>(d, a, b, scale_d);
  } else {
    static_assert(N == 256, "wgmma_ss: N is 64, 128 or 256");
    if constexpr (kHalf) wgmma_ss_n256_f16<TransB, TransA>(d, a, b, scale_d);
    else wgmma_ss_n256<TransB, TransA>(d, a, b, scale_d);
  }
}

template <int N, int TransB, typename E = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  constexpr bool kHalf = std::is_same<E, __half>::value;
  static_assert(kHalf || std::is_same<E, __nv_bfloat16>::value,
                "wgmma_rs: E is bf16 or __half");
  if constexpr (N == 64) {
    if constexpr (kHalf) wgmma_rs_n64_f16<TransB>(d, a, b, scale_d);
    else wgmma_rs_n64<TransB>(d, a, b, scale_d);
  } else {
    static_assert(N == 128, "wgmma_rs: N is 64 or 128");
    if constexpr (kHalf) wgmma_rs_n128_f16<TransB>(d, a, b, scale_d);
    else wgmma_rs_n128<TransB>(d, a, b, scale_d);
  }
}

// 16-bit float elements, E = bf16 or __half: two f32 values as one
// register (rounded to nearest; the lower half holds lo), one register
// back to two f32 values, a pair stored, and mma.sync m16n8k16 on E
// operands with f32 accumulators (c += a b, the PTX ISA's fragments)
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<E, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

template <typename E>
__device__ __forceinline__ float2 unpack2(uint32_t w) {
  if constexpr (std::is_same<E, __half>::value) {
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  } else {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  }
}

template <typename E>
__device__ __forceinline__ void store2(E* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2<E>(lo, hi);
}

// two elements from two addresses as one register (lo in the lower half)
template <typename E>
__device__ __forceinline__ uint32_t pair2(const E* lo, const E* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

template <typename E>
__device__ __forceinline__ void mma16816(float c[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<E, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
}

// --------------------------------------------------------- host: tensor maps
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of `rank` dimensions over base, elements of `type`: dims
// and box innermost first (in elements), strides in bytes for dimensions
// 1 .. rank - 1; out-of-bounds elements read as zero. Returns 0, or a
// cudaError_t value when the map cannot be made.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type,
                      CUtensorMapSwizzle swizzle, const void* base, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(
      map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides,
      box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A bf16 tensor map with 128-byte swizzle, so box[0] is 64 (encode_map)
inline int encode_bf16_map(CUtensorMap* map, const void* base, int rank,
                           const cuuint64_t* dims, const cuuint64_t* strides,
                           const cuuint32_t* box) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    CU_TENSOR_MAP_SWIZZLE_128B, base, rank, dims, strides,
                    box);
}

// The same for a 16-bit float type E (bf16 or __half)
template <typename E>
inline int encode_16bit_map(CUtensorMap* map, const void* base, int rank,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box) {
  return encode_map(map,
                    std::is_same<E, __half>::value
                        ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    CU_TENSOR_MAP_SWIZZLE_128B, base, rank, dims, strides,
                    box);
}

// streaming multiprocessors of the current device (for persistent grids)
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return n;
}

}  // namespace hopper
