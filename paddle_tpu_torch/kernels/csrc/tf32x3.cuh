// 3xTF32 products on mma.sync and cp.async staging of f32 rows, shared by
// the f32 flash forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) kernels for Hopper (sm_90a).
//
// 3xTF32: x = hi + lo, hi = x rounded to TF32 (nearest, ties away),
// lo = x - hi, and a b ~ (lo_a hi_b + hi_a lo_b) + hi_a hi_b (the split of
// CUTLASS's fast-f32 GEMMs). hi keeps 11 significant bits; lo, exact in
// f32, is read by the tensor core as TF32 (its low 13 bits ignored), so
// the operands keep ~22 bits and the dropped lo_a lo_b is ~2^-22 of the
// product. The tensor core adds each product into its f32 accumulator with
// truncation, so callers keep the small cross terms in accumulators of
// their own and their chains short.
//
// Fragment layouts of mma.sync m16n8k8 .tf32 (g = lane / 4, t = lane % 4):
//   A (16x8): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8x8):  b0 = B[t][g], b1 = B[t+4][g]
//   C (16x8): c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
//
// Staged f32 rows are padded to D + 4 floats (4 mod 32 words, a multiple
// of 16 bytes for cp.async), which keeps the fragment reads of both
// operand orientations free of bank conflicts: A[g][t] or B[g][t] at bank
// 4 g + t, and the rows 2t and 2t + 1 that a C-layout operand pairs with
// at banks 8 t + g and 8 t + 4 + g.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int kThreads = 128;  // the block size of every kernel using them

// 16 bytes global -> shared, asynchronously; zeros when !ok (src-size 0:
// nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + Rows) of a [n_rows, stride] f32 matrix into shared
// memory [Rows][D + 4]; rows at or past n_rows are zeros
template <int D, int Rows>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          size_t stride, int r0,
                                          int n_rows) {
  constexpr int V = D / 4;  // 16-byte vectors per row
  static_assert(Rows * V % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < Rows * V / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / V;
    const int c = (i - r * V) * 4;
    const bool ok = r0 + r < n_rows;
    cp_async16(dst + r * (D + 4) + c,
               ok ? src + (size_t)(r0 + r) * stride + c : src, ok);
  }
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away from zero:
// a carry into bit 13 of the magnitude, then the low 13 bits cleared; as
// cvt.rna.tf32.f32 for finite x, which compiles to a longer
// compare-and-select sequence), lo = x - hi exactly
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b in 3xTF32: big += hi_a hi_b, small += lo_a hi_b + hi_a lo_b.
// OnePass keeps hi_a hi_b only (one-pass TF32): the planted fault each
// kernel file's own plant macro selects, never the library's
template <bool OnePass = false>
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  if (!OnePass) {
    mma_tf32(small, al, bh0, bh1);
    mma_tf32(small, ah, bl0, bl1);
  }
  mma_tf32(big, ah, bh0, bh1);
}

}  // namespace tf32x3
