// Paged decode attention for Hopper (sm_90a), one query token per sequence.
//
// Replaces: paddle_tpu/kernels/pallas/paged_attention.py:paged_attention
//           (kernel bodies _decode_kernel and, for int8 pages,
//           _decode_kernel_quant; online-softmax step
//           _online_softmax_step).
//
// Computes, for every sequence b and query head hq:
//   out[b, hq] = softmax(q[b, hq] . K[b]^T * scale) V[b]
// over the first lengths[b] tokens of the sequence's logical cache, whose
// token t lives in physical page block_tables[b, t / page_size], slot
// t % page_size, of k_pages/v_pages [kv_heads, pages, page_size, d].
// Query heads are grouped per kv head (GQA, hq / kv_heads per group).
// Int8 pages (paged_attention_quant_launch) come with f32 scale planes
// k_scales/v_scales [kv_heads, pages, page_size], one scale per cached
// token per head: each K/V element is dequantized right after its load
// (int8 * scale, as the TPU kernel's k_ref * ks_ref), and the rest is the
// float kernel. Unwritten slots have scale 0 and read as exact zeros.
// lengths[b] == 0 gives exact zeros. Lengths are clamped to the block
// table's capacity, so the kernel never reads past a sequence's table.
//
// What bounds it on an H100: bytes. Each cached token costs 2 * d loads
// (K and V; half the bytes of bf16 when int8, plus 8 bytes of scales)
// for 4 * d * group flops, far below the ~295 flop/byte the card needs
// before compute is the limit. At serving sizes (8 sequences,
// a few hundred tokens) the real limit is latency: too little work per
// sequence to fill the card if one block walks a sequence alone.
//
// Design (split-K, two kernels):
//  1. paged_decode_split: one block per (sequence, kv head, 128-token
//     chunk). It reads each K/V row of its chunk once for the whole query
//     group: per 32-token tile, one block-table lookup per token, then
//     independent 16-byte loads into shared memory as f32; scores as
//     4-lane partial dot products (every thread busy, two shuffles per
//     score); an f32 online softmax (running max, sum, accumulator) over
//     the chunk's tiles. It writes the chunk's unnormalised state (max,
//     sum, accumulator) to a workspace. Chunks past a sequence's length
//     write an empty state and stop.
//  2. paged_decode_combine: one block per (sequence, kv head) merges its
//     chunks' states (rescaled to the common max) and writes out.
// Pages may be any size: tiles and chunks are cut by token position.
// The page element type P (float, bf16 or int8) is a template parameter
// beside the query type T; rows take 16-byte loads (4 f32, 8 bf16 or 16
// int8 values) when d and the page base allow it, scalar loads else.
//
// Launch contract: the launch function takes a workspace of
// paged_attention_workspace_bytes() bytes, launches both kernels on the
// given stream and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;    // tokens per tile == warp width
constexpr int kChunk = 128;  // tokens per split block
constexpr int kParts = 4;    // lanes sharing one score's dot product

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 loaded bytes -> f32 values (4 floats, 8 bf16 or 16 int8), each
// times ``s`` (the token's scale; 1 for float pages)
template <typename P>
__device__ __forceinline__ void unpack(uint4 w, float s, float* dst);
template <>
__device__ __forceinline__ void unpack<float>(uint4 w, float, float* dst) {
  dst[0] = __uint_as_float(w.x);
  dst[1] = __uint_as_float(w.y);
  dst[2] = __uint_as_float(w.z);
  dst[3] = __uint_as_float(w.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint4 w, float,
                                                      float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void unpack<int8_t>(uint4 w, float s,
                                               float* dst) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int j = 0; j < 16; ++j) dst[j] = static_cast<float>(b[j]) * s;
}

// one page element -> f32 (times the token's scale for int8)
__device__ __forceinline__ float load_elem(float x, float) { return x; }
__device__ __forceinline__ float load_elem(__nv_bfloat16 x, float) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float load_elem(int8_t x, float s) {
  return static_cast<float>(x) * s;
}

__host__ __device__ constexpr int k_stride(int d) {
  // padded K row: with the 4-lane interleaved dot product, 8 tokens x 4
  // lanes of a warp land on 32 distinct banks when d % 8 == 0
  return d + 4;
}

__host__ __device__ inline size_t smem_floats(int group, int d) {
  return 2 * (size_t)group * d          // q_s, acc_s
         + (size_t)kTile * k_stride(d)  // k_s
         + (size_t)kTile * d            // v_s
         + (size_t)group * kTile        // p_s
         + 3 * (size_t)group;           // m_s, l_s, a_s
}

// P is the page element type; k_scales/v_scales are read only when P is
// int8 (null otherwise)
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) paged_decode_split(
    const T* __restrict__ q,              // [batch, hq, d]
    const P* __restrict__ k_pages,        // [hkv, n_pages, page_size, d]
    const P* __restrict__ v_pages,        // [hkv, n_pages, page_size, d]
    const float* __restrict__ k_scales,   // [hkv, n_pages, page_size]
    const float* __restrict__ v_scales,   // [hkv, n_pages, page_size]
    const int32_t* __restrict__ tables,   // [batch, pages_per_seq]
    const int32_t* __restrict__ lengths,  // [batch]
    float* __restrict__ part_m,           // [batch, hkv, splits, group]
    float* __restrict__ part_l,           // [batch, hkv, splits, group]
    float* __restrict__ part_acc,         // [batch, hkv, splits, group, d]
    int n_q_heads, int n_kv_heads, int n_pages, int page_size,
    int pages_per_seq, int d, float scale, int vec) {
  extern __shared__ float smem[];
  constexpr bool kQuant = sizeof(P) == 1;
  __shared__ size_t row_s[kTile];       // element offset of each tile row
  __shared__ float ks_s[kTile];         // each tile row's K scale (int8)
  __shared__ float vs_s[kTile];         // each tile row's V scale (int8)
  const int group = n_q_heads / n_kv_heads;
  const int ks = k_stride(d);
  float* q_s = smem;                    // [group][d]
  float* acc_s = q_s + group * d;       // [group][d]
  float* k_s = acc_s + group * d;       // [kTile][ks]
  float* v_s = k_s + kTile * ks;        // [kTile][d]
  float* p_s = v_s + kTile * d;         // [group][kTile] scores, then probs
  float* m_s = p_s + group * kTile;     // [group] running max
  float* l_s = m_s + group;             // [group] running sum
  float* a_s = l_s + group;             // [group] this tile's rescale

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int capacity = pages_per_seq * page_size;
  int length = lengths[b];
  length = length < 0 ? 0 : (length > capacity ? capacity : length);
  const int start = split * kChunk;
  const int end = min(length, start + kChunk);
  const size_t state = ((size_t)b * n_kv_heads + h) * n_splits + split;

  if (start >= end) {  // nothing of this sequence in this chunk
    for (int g = tid; g < group; g += kThreads) {
      part_m[state * group + g] = -INFINITY;
      part_l[state * group + g] = 0.f;
    }
    return;
  }

  const size_t qo = ((size_t)b * n_q_heads + (size_t)h * group) * d;
  for (int i = tid; i < group * d; i += kThreads) {
    q_s[i] = to_f32(q[qo + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  const int32_t* table = tables + (size_t)b * pages_per_seq;
  const size_t head_base = (size_t)h * n_pages * page_size;  // tokens

  for (int t0 = start; t0 < end; t0 += kTile) {
    const int n = min(kTile, end - t0);
    // the tile's row offsets, one block-table lookup per token, and for
    // int8 pages the token's two scales
    if (tid < n) {
      const int pos = t0 + tid;
      const size_t phys = (size_t)table[pos / page_size];
      const size_t token = head_base + phys * page_size + pos % page_size;
      row_s[tid] = token * d;
      if (kQuant) {
        ks_s[tid] = k_scales[token];
        vs_s[tid] = v_scales[token];
      }
    }
    __syncthreads();
    // stage this tile's K/V rows (f32, dequantized) in shared memory:
    // independent 16-byte loads when rows are 16-byte aligned, else
    // scalar loads
    if (vec) {
      constexpr int V = 16 / sizeof(P);
      const int per_row = d / V;
#pragma unroll 4
      for (int i = tid; i < n * per_row; i += kThreads) {
        const int t = i / per_row;
        const int c = (i - t * per_row) * V;
        const uint4 kw =
            *reinterpret_cast<const uint4*>(k_pages + row_s[t] + c);
        const uint4 vw =
            *reinterpret_cast<const uint4*>(v_pages + row_s[t] + c);
        unpack<P>(kw, kQuant ? ks_s[t] : 1.f, k_s + t * ks + c);
        unpack<P>(vw, kQuant ? vs_s[t] : 1.f, v_s + t * d + c);
      }
    } else {
      for (int i = tid; i < n * d; i += kThreads) {
        const int t = i / d;
        const int c = i - t * d;
        k_s[t * ks + c] =
            load_elem(k_pages[row_s[t] + c], kQuant ? ks_s[t] : 1.f);
        v_s[i] = load_elem(v_pages[row_s[t] + c], kQuant ? vs_s[t] : 1.f);
      }
    }
    __syncthreads();
    // scores: kParts lanes per (query row, token) pair, each summing the
    // columns c = part, part + kParts, ...; every thread runs the same
    // number of iterations, so the shuffles see full warps
    for (int i = tid; i < group * kTile * kParts; i += kThreads) {
      const int part = i & (kParts - 1);
      const int pr = i / kParts;
      const int g = pr / kTile;
      const int t = pr - g * kTile;
      const float* qr = q_s + g * d;
      const float* kr = k_s + t * ks;
      float dot = 0.f;
      for (int c = part; c < d; c += kParts) dot += qr[c] * kr[c];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (part == 0) p_s[pr] = t < n ? dot * scale : -INFINITY;
    }
    __syncthreads();
    // online softmax: one warp per query row, lane == token of the tile.
    // Every tile holds at least one valid token, so m_new is finite.
    for (int g = warp; g < group; g += kWarps) {
      const float s = p_s[g * kTile + lane];
      float mt = s;
      for (int o = 16; o > 0; o >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      }
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mt);
      const float p = lane < n ? expf(s - m_new) : 0.f;
      float ps = p;
      for (int o = 16; o > 0; o >>= 1) {
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      }
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);  // 0 on the first tile
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V
    for (int i = tid; i < group * d; i += kThreads) {
      const int g = i / d;
      const int c = i - g * d;
      const float* pr = p_s + g * kTile;
      float a = acc_s[i] * a_s[g];
      for (int t = 0; t < n; ++t) a += pr[t] * v_s[t * d + c];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int g = tid; g < group; g += kThreads) {
    part_m[state * group + g] = m_s[g];
    part_l[state * group + g] = l_s[g];
  }
  for (int i = tid; i < group * d; i += kThreads) {
    part_acc[state * group * d + i] = acc_s[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_combine(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ out,
    int n_q_heads, int n_kv_heads, int n_splits, int d) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = n_q_heads / n_kv_heads;
  const size_t first = ((size_t)b * n_kv_heads + h) * n_splits;
  const size_t qo = ((size_t)b * n_q_heads + (size_t)h * group) * d;
  for (int i = threadIdx.x; i < group * d; i += kThreads) {
    const int g = i / d;
    const int c = i - g * d;
    float m = -INFINITY;
    for (int s = 0; s < n_splits; ++s) {
      m = fmaxf(m, part_m[(first + s) * group + g]);
    }
    float l = 0.f, a = 0.f;
    if (m != -INFINITY) {
      for (int s = 0; s < n_splits; ++s) {
        const size_t st = (first + s) * group + g;
        const float ms = part_m[st];
        if (ms == -INFINITY) continue;  // an empty chunk
        const float w = expf(ms - m);
        l += part_l[st] * w;
        a += part_acc[st * d + c] * w;
      }
    }
    store(out + qo + i, l == 0.f ? 0.f : a / l);  // length 0: exact zeros
  }
}

size_t workspace_floats(int batch, int n_q_heads, int n_kv_heads, int d,
                        int n_splits) {
  const size_t states = (size_t)batch * n_kv_heads * n_splits *
                        (n_q_heads / n_kv_heads);
  return states * (2 + (size_t)d);
}

template <typename T, typename P>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* tables,
           const void* lengths, void* out, void* workspace, int batch,
           int n_q_heads, int n_kv_heads, int n_pages, int page_size,
           int pages_per_seq, int d, float scale, cudaStream_t stream) {
  const int group = n_q_heads / n_kv_heads;
  const int n_splits = (pages_per_seq * page_size + kChunk - 1) / kChunk;
  const size_t states = (size_t)batch * n_kv_heads * n_splits * group;
  float* part_m = static_cast<float*>(workspace);
  float* part_l = part_m + states;
  float* part_acc = part_l + states;
  // 16-byte loads need 16-byte aligned rows
  const int vec = d % (16 / sizeof(P)) == 0 &&
                  reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  const size_t smem = smem_floats(group, d) * sizeof(float);
  auto split = paged_decode_split<T, P>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split<<<dim3(batch, n_kv_heads, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pages),
      static_cast<const P*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), part_m, part_l, part_acc,
      n_q_heads, n_kv_heads, n_pages, page_size, pages_per_seq, d, scale,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine<T><<<dim3(batch, n_kv_heads), kThreads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), n_q_heads, n_kv_heads,
      n_splits, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one split block needs, in bytes.
size_t paged_attention_smem_bytes(int group, int d) {
  return smem_floats(group, d) * sizeof(float);
}

// Workspace the launch needs, in bytes (per-chunk softmax states).
size_t paged_attention_workspace_bytes(int batch, int n_q_heads,
                                       int n_kv_heads, int d,
                                       int capacity) {
  const int n_splits = (capacity + kChunk - 1) / kChunk;
  return workspace_floats(batch, n_q_heads, n_kv_heads, d, n_splits) *
         sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 (q, pages and out share it).
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* lengths, void* out, void* workspace,
                           int batch, int n_q_heads, int n_kv_heads,
                           int n_pages, int page_size, int pages_per_seq,
                           int d, float scale, int dtype, void* stream) {
  if (batch == 0 || pages_per_seq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, float>(
        q, k_pages, v_pages, nullptr, nullptr, block_tables, lengths, out,
        workspace, batch, n_q_heads, n_kv_heads, n_pages, page_size,
        pages_per_seq, d, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, block_tables, lengths, out,
        workspace, batch, n_q_heads, n_kv_heads, n_pages, page_size,
        pages_per_seq, d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Int8 pages with f32 scales [n_kv_heads, n_pages, page_size]; dtype is
// q's and out's (0 = float32, 1 = bfloat16).
int paged_attention_quant_launch(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales,
                                 const void* block_tables,
                                 const void* lengths, void* out,
                                 void* workspace, int batch, int n_q_heads,
                                 int n_kv_heads, int n_pages, int page_size,
                                 int pages_per_seq, int d, float scale,
                                 int dtype, void* stream) {
  if (batch == 0 || pages_per_seq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, int8_t>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths, out,
        workspace, batch, n_q_heads, n_kv_heads, n_pages, page_size,
        pages_per_seq, d, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths, out,
        workspace, batch, n_q_heads, n_kv_heads, n_pages, page_size,
        pages_per_seq, d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
