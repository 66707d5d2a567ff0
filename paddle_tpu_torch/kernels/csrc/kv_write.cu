// Fused KV-cache page write for the serving engine: the K and V of N new
// tokens into their page slots, in place, in one launch (float pages take
// a plain store; int8 pages the per-token, per-head absmax quantization
// and its f32 scale in the same slot).
//
// Replaces: no TPU kernel. In the JAX package `quantize_tokens`
// (paddle_tpu/kernels/pallas/paged_attention.py:59) and `update_pages`
// (:292) are XLA ops that XLA fuses into the decode and prefill programs;
// eager PyTorch ran them as ~20 small launches a layer (index arithmetic,
// a `nonzero` host sync, four `index_put_`). One launch with a fixed
// grid is also what lets a step be captured into a CUDA graph.
//
// Routing, per token i: table row rows[i], position positions[i]; written
// only where valid[i] and 0 <= positions[i] < pages_per_seq * page_size
// (JAX drops the other rows; the plain version routes them to a sink
// page no table names). Physical page tables[rows[i], pos / page_size],
// slot pos % page_size.
//
// Bound: bytes. At the serving decode shape (8 tokens, 16 kv heads, d 128,
// bf16) it moves ~64 KiB, ~0.02 us at 3.35 TB/s: its time is its launch.
// Design: one warp per (token, kv head, K or V); a lane holds at most 8
// values (d <= 256), read and written 16 bytes at a time where the rows
// allow it. The int8 scale is max(absmax, 1e-8) / 127 with IEEE division
// and the values round half to even (rintf), clamped to +-127: the same
// expression, in the same order, as the plain `quantize_tokens`, so the
// pages and scales are bit-identical to it (the build has no
// --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;         // warps per block
constexpr int kMaxPerLane = 8;    // values a lane holds: d <= 256

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// Lane `lane` holds elements ((lane + 32 r) * C + c) of a d-row, r < 8 / C,
// c < C: C = 1 reads element by element, C = 16 / sizeof(T) a 16-byte
// vector at a time. Elements past d read as 0.
template <typename T, int C>
__device__ __forceinline__ void load_row(const T* src, int d, int lane,
                                         float (&vals)[kMaxPerLane]) {
#pragma unroll
  for (int r = 0; r < kMaxPerLane / C; ++r) {
    const int j0 = (lane + 32 * r) * C;
    if (j0 < d) {
      if constexpr (C == 1) {
        vals[r] = to_float(src[j0]);
      } else {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + j0);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int c = 0; c < C; ++c) vals[r * C + c] = to_float(e[c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) vals[r * C + c] = 0.f;
    }
  }
}

// The float pool: the row's bits copied as they are (the pool has the
// new rows' dtype).
template <typename T, int C>
__device__ __forceinline__ void copy_row(const T* src, T* dst, int d,
                                         int lane) {
#pragma unroll
  for (int r = 0; r < kMaxPerLane / C; ++r) {
    const int j0 = (lane + 32 * r) * C;
    if (j0 < d) {
      if constexpr (C == 1) {
        dst[j0] = src[j0];
      } else {
        *reinterpret_cast<uint4*>(dst + j0) =
            *reinterpret_cast<const uint4*>(src + j0);
      }
    }
  }
}

// The int8 pool: absmax over the row (a warp reduction), the scale, the
// rounded values; C int8 values stored together.
template <typename T, int C>
__device__ __forceinline__ void quantize_row(const T* src, int8_t* dst,
                                             float* scale_out, int d,
                                             int lane) {
  float vals[kMaxPerLane];
  load_row<T, C>(src, d, lane, vals);
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) amax = fmaxf(amax, fabsf(vals[j]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  if (lane == 0) *scale_out = scale;
#pragma unroll
  for (int r = 0; r < kMaxPerLane / C; ++r) {
    const int j0 = (lane + 32 * r) * C;
    if (j0 >= d) continue;
    // C int8 values packed into words, low byte first (little endian)
    uint32_t word[(C + 3) / 4] = {};
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float x = rintf(__fdiv_rn(vals[r * C + c], scale));
      const int8_t q = (int8_t)fminf(fmaxf(x, -127.f), 127.f);
      word[c / 4] |= (uint32_t)(uint8_t)q << (8 * (c % 4));
    }
    if constexpr (C == 1) {
      dst[j0] = (int8_t)word[0];
    } else if constexpr (C == 4) {
      *reinterpret_cast<uint32_t*>(dst + j0) = word[0];
    } else {
      *reinterpret_cast<uint2*>(dst + j0) = make_uint2(word[0], word[1]);
    }
  }
}

template <typename T, int C, bool kQuant>
__global__ void __launch_bounds__(kWarps * 32)
    kv_write_kernel(const T* __restrict__ k_new, const T* __restrict__ v_new,
                    void* __restrict__ k_pages, void* __restrict__ v_pages,
                    float* __restrict__ k_scales,
                    float* __restrict__ v_scales,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ rows,
                    const int32_t* __restrict__ positions,
                    const uint8_t* __restrict__ valid, int n_tokens,
                    int n_kv_heads, int n_pages, int page_size,
                    int pages_per_seq, int d) {
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int per_tensor = n_tokens * n_kv_heads;
  if (warp >= 2 * per_tensor) return;
  const bool is_v = warp >= per_tensor;
  const int w = is_v ? warp - per_tensor : warp;
  const int i = w / n_kv_heads;
  const int h = w % n_kv_heads;
  const int pos = positions[i];
  if (!valid[i] || pos < 0 || pos >= pages_per_seq * page_size) return;
  const int phys =
      tables[(long long)rows[i] * pages_per_seq + pos / page_size];
  if (phys < 0 || phys >= n_pages) return;
  const long long slot =
      ((long long)h * n_pages + phys) * page_size + pos % page_size;
  const T* src = (is_v ? v_new : k_new) + ((long long)i * n_kv_heads + h) * d;
  if constexpr (kQuant) {
    int8_t* dst = static_cast<int8_t*>(is_v ? v_pages : k_pages) + slot * d;
    quantize_row<T, C>(src, dst, (is_v ? v_scales : k_scales) + slot, d,
                       lane);
  } else {
    T* dst = static_cast<T*>(is_v ? v_pages : k_pages) + slot * d;
    copy_row<T, C>(src, dst, d, lane);
  }
}

template <typename T, bool kQuant>
int launch(const void* k_new, const void* v_new, void* k_pages, void* v_pages,
           void* k_scales, void* v_scales, const void* tables,
           const void* rows, const void* positions, const void* valid,
           int n_tokens, int n_kv_heads, int n_pages, int page_size,
           int pages_per_seq, int d, int vec, cudaStream_t stream) {
  const long long warps = 2LL * n_tokens * n_kv_heads;
  const dim3 grid((unsigned)((warps + kWarps - 1) / kWarps));
  constexpr int kVec = 16 / sizeof(T);
  auto args = [&](auto kernel) {
    kernel<<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(k_new), static_cast<const T*>(v_new), k_pages,
        v_pages, static_cast<float*>(k_scales), static_cast<float*>(v_scales),
        static_cast<const int32_t*>(tables),
        static_cast<const int32_t*>(rows),
        static_cast<const int32_t*>(positions),
        static_cast<const uint8_t*>(valid), n_tokens, n_kv_heads, n_pages,
        page_size, pages_per_seq, d);
  };
  if (vec)
    args(kv_write_kernel<T, kVec, kQuant>);
  else
    args(kv_write_kernel<T, 1, kQuant>);
  return (int)cudaGetLastError();
}

template <bool kQuant>
int dispatch(int dtype, const void* k_new, const void* v_new, void* k_pages,
             void* v_pages, void* k_scales, void* v_scales,
             const void* tables, const void* rows, const void* positions,
             const void* valid, int n_tokens, int n_kv_heads, int n_pages,
             int page_size, int pages_per_seq, int d, int vec,
             cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch<float, kQuant>(k_new, v_new, k_pages, v_pages, k_scales,
                                   v_scales, tables, rows, positions, valid,
                                   n_tokens, n_kv_heads, n_pages, page_size,
                                   pages_per_seq, d, vec, stream);
    case 1:
      return launch<__nv_bfloat16, kQuant>(
          k_new, v_new, k_pages, v_pages, k_scales, v_scales, tables, rows,
          positions, valid, n_tokens, n_kv_heads, n_pages, page_size,
          pages_per_seq, d, vec, stream);
    case 2:
      return launch<__half, kQuant>(k_new, v_new, k_pages, v_pages, k_scales,
                                    v_scales, tables, rows, positions, valid,
                                    n_tokens, n_kv_heads, n_pages, page_size,
                                    pages_per_seq, d, vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// k_new, v_new [n_tokens, n_kv_heads, d] of `dtype` (0 f32, 1 bf16, 2 f16);
// pages [n_kv_heads, n_pages, page_size, d] of that dtype, or int8 with
// `quant` and f32 scales [n_kv_heads, n_pages, page_size]; tables
// [*, pages_per_seq] int32; rows, positions [n_tokens] int32; valid
// [n_tokens] bool. `vec`: every row starts on a 16-byte boundary. Returns
// the CUDA error of the launch (0 when n_tokens is 0: nothing to launch).
extern "C" int kv_write_launch(const void* k_new, const void* v_new,
                               void* k_pages, void* v_pages, void* k_scales,
                               void* v_scales, const void* tables,
                               const void* rows, const void* positions,
                               const void* valid, int n_tokens,
                               int n_kv_heads, int n_pages, int page_size,
                               int pages_per_seq, int d, int dtype, int quant,
                               int vec, void* stream) {
  if (n_tokens == 0 || n_kv_heads == 0) return 0;
  if (d < 1 || d > 32 * kMaxPerLane) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (quant)
    return dispatch<true>(dtype, k_new, v_new, k_pages, v_pages, k_scales,
                          v_scales, tables, rows, positions, valid, n_tokens,
                          n_kv_heads, n_pages, page_size, pages_per_seq, d,
                          vec, s);
  return dispatch<false>(dtype, k_new, v_new, k_pages, v_pages, k_scales,
                         v_scales, tables, rows, positions, valid, n_tokens,
                         n_kv_heads, n_pages, page_size, pages_per_seq, d,
                         vec, s);
}
