// Fused KV-cache page write for the serving engine, two entry points:
//
// kv_write_launch: the K and V of N new tokens into their page slots, in
// place, in one launch (float pages take a plain store; int8 pages the
// per-token, per-head absmax quantization and its f32 scale in the same
// slot).
//
// rope_kv_write_launch: the same write with RoPE folded in, the one
// launch a layer of every serving program makes: q and k rotated
// (neox style, pairs j and j + d/2, by per-row cos/sin tables the caller
// builds once per program), q into q_out, the rotated k into its slot
// (and k_out when asked), v into its slot.
//
// Replaces: no TPU kernel. In the JAX package `quantize_tokens`
// (paddle_tpu/kernels/pallas/paged_attention.py:59), `update_pages`
// (:292) and `rope_qk` (paddle_tpu/ops/impl/fused_ops.py:87, its
// `_apply_rope` :29) are XLA ops that XLA fuses into the decode, prefill
// and verify programs; eager PyTorch ran the rotation as 27 small
// launches a layer (the angle table, then casts, products, sums and a
// concatenation for q and for k) and the write as one more. One launch
// with a fixed grid is also what lets a step be captured into a CUDA
// graph.
//
// Routing, per token i: table row rows[i], position positions[i]; written
// only where valid[i] and 0 <= positions[i] < pages_per_seq * page_size
// (JAX drops the other rows; the plain version routes them to a sink
// page no table names). Physical page tables[rows[i], pos / page_size],
// slot pos % page_size. Rotation ignores the routing: every q row (and
// every k row with k_out) is rotated, as the plain version rotates them.
//
// Bound: bytes. At the serving decode shape (8 tokens, 16 q and 16 kv
// heads, d 128, bf16) the rotating write moves ~200 KB, ~0.06 us at
// 3.35 TB/s: its time is its launch. Design: one warp per (token, kv
// head, K or V), and for the rotating write one warp per (token, head)
// over the q heads, the k heads and the v heads; a lane holds at most 8
// values (d <= 256), read and written 16 bytes at a time where the rows
// allow it. A rotated row is built in the warp's row of shared memory
// (f32 products and sums, each rounded once: __fmul_rn, __fsub_rn,
// __fadd_rn, as PyTorch's separate elementwise kernels round them, then
// round to nearest into the row's dtype) and stored from there by the
// same row writers as kv_write, so an int8 pool quantizes the rounded,
// rotated row. The int8 scale is max(absmax, 1e-8) / 127 with IEEE
// division and the values round half to even (rintf), clamped to +-127:
// the same expression, in the same order, as the plain `quantize_tokens`,
// so the pages and scales are bit-identical to it (the build has no
// --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;         // warps per block
constexpr int kMaxPerLane = 8;    // values a lane holds: d <= 256
constexpr int kMaxD = 32 * kMaxPerLane;

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

// Where token i's K/V row of kv head h goes: its slot in the pool, in
// rows of d, or -1 where the token is not written.
__device__ __forceinline__ long long page_slot(
    const int32_t* tables, const int32_t* rows, const int32_t* positions,
    const uint8_t* valid, int i, int h, int n_pages, int page_size,
    int pages_per_seq) {
  const int pos = positions[i];
  if (!valid[i] || pos < 0 || pos >= pages_per_seq * page_size) return -1;
  const int phys =
      tables[(long long)rows[i] * pages_per_seq + pos / page_size];
  if (phys < 0 || phys >= n_pages) return -1;
  return ((long long)h * n_pages + phys) * page_size + pos % page_size;
}

// One row into its slot: a float pool takes the bits, an int8 pool the
// quantized row and its scale.
template <typename T, int C, bool kQuant>
__device__ __forceinline__ void store_row(const T* src, void* pages,
                                          float* scales, long long slot,
                                          int d, int lane) {
  if constexpr (kQuant) {
    quantize_row<T, C>(src, static_cast<int8_t*>(pages) + slot * d,
                       scales + slot, d, lane);
  } else {
    copy_row<T, C>(src, static_cast<T*>(pages) + slot * d, d, lane);
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
  const long long slot = page_slot(tables, rows, positions, valid, i, h,
                                   n_pages, page_size, pages_per_seq);
  if (slot < 0) return;
  const T* src = (is_v ? v_new : k_new) + ((long long)i * n_kv_heads + h) * d;
  store_row<T, C, kQuant>(src, is_v ? v_pages : k_pages,
                          is_v ? v_scales : k_scales, slot, d, lane);
}

// ------------------------------------------------------------ rope_kv_write
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// One warp per (token, head) over the q heads, then the kv heads (k), then
// the kv heads again (v). A q or k row is rotated into the warp's row of
// shared memory, rounded to T, then stored from there by the row writers
// above: q into q_out; k into k_out (when given) and its page slot. A v
// row goes to its slot as kv_write_kernel writes it.
template <typename T, int C, bool kQuant>
__global__ void __launch_bounds__(kWarps * 32) rope_kv_write_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, T* __restrict__ q_out,
    T* __restrict__ k_out, void* __restrict__ k_pages,
    void* __restrict__ v_pages, float* __restrict__ k_scales,
    float* __restrict__ v_scales, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ positions,
    const uint8_t* __restrict__ valid, int n_tokens, int n_q_heads,
    int n_kv_heads, int n_pages, int page_size, int pages_per_seq, int d) {
  __shared__ __align__(16) unsigned char smem[kWarps * kMaxD * sizeof(T)];
  const int lane = threadIdx.x % 32;
  const long long warp = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int heads = n_q_heads + 2 * n_kv_heads;
  if (warp >= (long long)n_tokens * heads) return;
  const int i = (int)(warp / heads);
  const int h = (int)(warp % heads);
  const bool is_q = h < n_q_heads;
  const int hk = is_q ? 0 : (h - n_q_heads) % n_kv_heads;
  const long long slot =
      is_q ? -1
           : page_slot(tables, rows, positions, valid, i, hk, n_pages,
                       page_size, pages_per_seq);
  const long long kv_row = ((long long)i * n_kv_heads + hk) * d;
  if (h >= n_q_heads + n_kv_heads) {  // v: written as it is
    if (slot >= 0)
      store_row<T, C, kQuant>(v + kv_row, v_pages, v_scales, slot, d, lane);
    return;
  }
  if (!is_q && slot < 0 && k_out == nullptr) return;
  const long long q_row = ((long long)i * n_q_heads + h) * d;
  const T* src = is_q ? q + q_row : k + kv_row;
  T* rot = reinterpret_cast<T*>(smem) + (threadIdx.x / 32) * kMaxD;
  // neox pairs (j, j + d/2): f32, one rounding per op (no contraction),
  // then round to nearest into T
  const int d2 = d / 2;
  const float* c = cos_t + (long long)i * d2;
  const float* s = sin_t + (long long)i * d2;
  for (int j = lane; j < d2; j += 32) {
    const float x1 = to_float(src[j]), x2 = to_float(src[j + d2]);
    const float cj = c[j], sj = s[j];
    rot[j] = from_float<T>(__fsub_rn(__fmul_rn(x1, cj), __fmul_rn(x2, sj)));
    rot[j + d2] =
        from_float<T>(__fadd_rn(__fmul_rn(x2, cj), __fmul_rn(x1, sj)));
  }
  __syncwarp();
  if (is_q) {
    copy_row<T, C>(rot, q_out + q_row, d, lane);
    return;
  }
  if (k_out != nullptr) copy_row<T, C>(rot, k_out + kv_row, d, lane);
  if (slot >= 0)
    store_row<T, C, kQuant>(rot, k_pages, k_scales, slot, d, lane);
}

template <typename T>
struct Tag {
  using type = T;
};

// f(Tag<T>{}) for the row dtype code (0 f32, 1 bf16, 2 f16)
template <typename F>
int with_dtype(int dtype, F&& f) {
  switch (dtype) {
    case 0:
      return f(Tag<float>{});
    case 1:
      return f(Tag<__nv_bfloat16>{});
    case 2:
      return f(Tag<__half>{});
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
  if (d < 1 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long warps = 2LL * n_tokens * n_kv_heads;
  const dim3 grid((unsigned)((warps + kWarps - 1) / kWarps));
  return with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int kVec = 16 / sizeof(T);
    auto go = [&](auto kernel) {
      kernel<<<grid, kWarps * 32, 0, s>>>(
          static_cast<const T*>(k_new), static_cast<const T*>(v_new),
          k_pages, v_pages, static_cast<float*>(k_scales),
          static_cast<float*>(v_scales), static_cast<const int32_t*>(tables),
          static_cast<const int32_t*>(rows),
          static_cast<const int32_t*>(positions),
          static_cast<const uint8_t*>(valid), n_tokens, n_kv_heads, n_pages,
          page_size, pages_per_seq, d);
      return (int)cudaGetLastError();
    };
    if (quant)
      return vec ? go(kv_write_kernel<T, kVec, true>)
                 : go(kv_write_kernel<T, 1, true>);
    return vec ? go(kv_write_kernel<T, kVec, false>)
               : go(kv_write_kernel<T, 1, false>);
  });
}

// q [n_tokens, n_q_heads, d], k and v [n_tokens, n_kv_heads, d] of `dtype`;
// cos_t, sin_t [n_tokens, d / 2] f32; q_out like q; k_out like k, or null;
// the pool and the routing as kv_write_launch's. Rotates every row of q
// into q_out and of k into k_out; writes the rotated k and the v of every
// routed token into the pool. `vec`: every row of q_out, k_out, v and the
// pages starts on a 16-byte boundary. d even, at most 256.
extern "C" int rope_kv_write_launch(
    const void* q, const void* k, const void* v, const void* cos_t,
    const void* sin_t, void* q_out, void* k_out, void* k_pages,
    void* v_pages, void* k_scales, void* v_scales, const void* tables,
    const void* rows, const void* positions, const void* valid, int n_tokens,
    int n_q_heads, int n_kv_heads, int n_pages, int page_size,
    int pages_per_seq, int d, int dtype, int quant, int vec, void* stream) {
  if (n_tokens == 0 || n_q_heads + n_kv_heads == 0) return 0;
  if (d < 2 || d % 2 || d > kMaxD || n_kv_heads < 1)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long warps = (long long)n_tokens * (n_q_heads + 2 * n_kv_heads);
  const dim3 grid((unsigned)((warps + kWarps - 1) / kWarps));
  return with_dtype(dtype, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int kVec = 16 / sizeof(T);
    auto go = [&](auto kernel) {
      kernel<<<grid, kWarps * 32, 0, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const float*>(cos_t),
          static_cast<const float*>(sin_t), static_cast<T*>(q_out),
          static_cast<T*>(k_out), k_pages, v_pages,
          static_cast<float*>(k_scales), static_cast<float*>(v_scales),
          static_cast<const int32_t*>(tables),
          static_cast<const int32_t*>(rows),
          static_cast<const int32_t*>(positions),
          static_cast<const uint8_t*>(valid), n_tokens, n_q_heads,
          n_kv_heads, n_pages, page_size, pages_per_seq, d);
      return (int)cudaGetLastError();
    };
    if (quant)
      return vec ? go(rope_kv_write_kernel<T, kVec, true>)
                 : go(rope_kv_write_kernel<T, 1, true>);
    return vec ? go(rope_kv_write_kernel<T, kVec, false>)
               : go(rope_kv_write_kernel<T, 1, false>);
  });
}
