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
// token per head (the TPU kernel's k_ref * ks_ref). Unwritten slots have
// scale 0 and read as exact zeros. lengths[b] == 0 gives exact zeros.
// Lengths are clamped to the block table's capacity, so the kernel never
// reads past a sequence's table. q and out are f32, bf16 or f16; pages
// have q's type, or are int8.
//
// What bounds it on an H100: bytes. Each cached token costs 2 * d loads
// (K and V; half the bytes of bf16 when int8, plus 8 bytes of scales)
// for 4 * d * group flops, far below the ~295 flop/byte the card needs
// before compute is the limit. At serving sizes (8 sequences, a few
// hundred tokens, ~3 us of bytes) the real limit is latency: the chain
// of dependent reads (length, block table, K/V rows) and the launches.
//
// Two designs, chosen by the launch's `variant`:
//
// Cluster (variant 0, the default). One launch, no workspace. The grid is
// (sequence, kv head, chunk); the chunks of one (sequence, kv head) are
// one thread-block cluster of `blocks` blocks (cluster_geometry: the
// capacity over at most kMaxCluster blocks, and no more than the card
// holds resident for the grid's pairs, chunks of at least kMinChunk
// tokens rounded to the kCTile-token tile). A block reads its chunk's
// block-table entries once into shared memory, then streams the chunk's
// K/V rows, in the page's own type, through a ring of kCStages
// kCTile-token stages filled by cp.async (16-, 8- or 4-byte copies as
// the row and the pool's base allow; plain loads otherwise), so the
// loads of the next kCStages - 1 tiles fly while tile t is scored. Rows
// are dequantized as they are read from shared memory: an int8 K row's
// scale multiplies its dot product, a V row's scale its softmax weight.
// f32 scores and online softmax, as the split kernel. Each block owns a
// slice of the group x d outputs and pushes its (max, sum, accumulator)
// into the owners' shared memory (distributed shared memory stores, no
// round trip); after one cluster barrier every block merges its slice
// from its own shared memory and writes it in q's type. Blocks whose
// chunk lies past the length push an empty state. Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (chip_sweeps.py paged_cluster): 32-token tiles
// in 2 stages against 16-token tiles in 4, 12 % faster at the serving
// shape (more tiles cost more than deeper loads save), and against 3
// stages level there but 7-9 % faster with f32 pages and long context
// (fewer resident blocks); a cluster capped at 4 blocks is 2 % faster at
// the serving shape and ~40 % slower with GQA and long context, chunks of
// at least 128 tokens 2 % faster and 35 % slower with GQA.
//
// Split-K (variant 1, the first design, kept for side-by-side timing):
// one block per (sequence, kv head, 128-token chunk) stages each 32-token
// tile as f32 in shared memory after a synchronous block-table lookup
// and writes the chunk's state to a workspace; a second kernel merges
// the chunks. Needs paged_attention_workspace_bytes() of workspace.
//
// Launch contract: the launch functions launch on the given stream and
// return cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;    // tokens per tile == warp width
constexpr int kChunk = 128;  // tokens per split block
constexpr int kParts = 4;    // lanes sharing one score's dot product

// cluster design (chip_sweeps.py paged_cluster): tokens a ring stage
// (at most a warp: the softmax gives a lane each), and stages
constexpr int kCTile = 32;  // sweep: paged_tile
constexpr int kCStages = 2;  // sweep: paged_stages
constexpr int kMaxCluster = 8;  // sweep: paged_cluster
constexpr int kMinChunk = 64;  // sweep: paged_min_chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// 16 loaded bytes -> f32 values (4 floats, 8 bf16 or f16, 16 int8), each
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
__device__ __forceinline__ void unpack<__half>(uint4 w, float, float* dst) {
  const __half2* h = reinterpret_cast<const __half2*>(&w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __half22float2(h[j]);
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
template <typename P>
__device__ __forceinline__ float load_elem(P x, float s) {
  return sizeof(P) == 1 ? to_f32(x) * s : to_f32(x);
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

// ---------------------------------------------------------------------------
// Split-K (variant 1).

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
int launch_split(const void* q, const void* k_pages, const void* v_pages,
                 const void* k_scales, const void* v_scales,
                 const void* tables, const void* lengths, void* out,
                 void* workspace, int batch, int n_q_heads, int n_kv_heads,
                 int n_pages, int page_size, int pages_per_seq, int d,
                 float scale, cudaStream_t stream) {
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

// ---------------------------------------------------------------------------
// Cluster (variant 0).

// blocks per (sequence, kv head) and tokens per block for a table of
// `capacity` tokens: at most kMaxCluster blocks, and at most `room`, of
// at least kMinChunk tokens, the chunk a whole number of tiles
__host__ __device__ inline void cluster_geometry(int capacity, int room,
                                                 int* blocks, int* chunk) {
  int c = (capacity + kMinChunk - 1) / kMinChunk;
  c = c > kMaxCluster ? kMaxCluster : c;
  c = c > room ? room : c;
  c = c < 1 ? 1 : c;
  int ch = (capacity + c - 1) / c;
  ch = ch < 1 ? kCTile : (ch + kCTile - 1) / kCTile * kCTile;
  *blocks = (capacity + ch - 1) / ch < 1 ? 1 : (capacity + ch - 1) / ch;
  *chunk = ch;
}

// K/V rows in shared memory. Where the scores read 16-byte chunks (a
// quarter warp: 2 tokens x 4 lanes on chunks 4 j .. 4 j + 3), the K rows
// of odd tokens keep chunk c at chunk c ^ 4 when a row has a multiple of
// 8 chunks, so the two tokens' 64 bytes fall on distinct banks with no
// padding; otherwise rows are padded to start 64 bytes apart modulo 128.
// Where the scores read single elements (8 tokens x 4 lanes of a warp),
// K rows are padded by 16 bytes (4 banks apart, for 1-, 2- and 4-byte
// elements alike). A V row is its bytes rounded to 16 (P V reads
// consecutive columns).
__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}
__host__ __device__ constexpr bool k_swizzled(int d, int elem, bool vec) {
  return vec && d * elem % 128 == 0;
}
__host__ __device__ constexpr int k_row_stride(int d, int elem, bool vec) {
  return k_swizzled(d, elem, vec)
             ? d * elem
             : (vec ? round16(d * elem) + (192 - round16(d * elem) % 128) % 128
                    : round16(d * elem) + 16);
}

struct ClusterSmem {
  int floats;       // q_s, acc_s, p_s, m_s, l_s, a_s
  int per;          // outputs a block merges (its slice of group x d)
  int merge;        // the states pushed to it: m, l [blocks][group],
                    // acc [blocks][per]
  int table;        // block-table entries of one chunk
  int ring_offset;  // bytes, 16-aligned
  int krs, vrs;     // K and V row strides, bytes
  int stage;        // bytes per ring stage: K tile, V tile, [scales]
  int total;
};

// vec: the scores read 16-byte chunks (copies of 16 bytes)
__host__ __device__ inline ClusterSmem cluster_smem(int group, int d,
                                                    int elem, int chunk,
                                                    int page_size, bool vec,
                                                    int blocks) {
  ClusterSmem s;
  s.floats = 2 * group * d + group * kCTile + 3 * group;
  s.per = (group * d + blocks - 1) / blocks;
  s.merge = blocks * (2 * group + s.per);
  s.table = (chunk + page_size - 1) / page_size + 1;  // a chunk may start
                                                      // inside a page
  s.ring_offset = ((s.floats + s.merge + s.table) * 4 + 15) / 16 * 16;
  s.krs = k_row_stride(d, elem, vec);
  s.vrs = round16(d * elem);
  s.stage = kCTile * (s.krs + s.vrs) + (elem == 1 ? 2 * kCTile * 4 : 0);
  s.total = s.ring_offset + kCStages * s.stage;
  return s;
}

// `bytes` (16, 8 or 4) global -> shared asynchronously, or, with bytes 0,
// one element of `elem` bytes by plain loads
__device__ __forceinline__ void copy_row_part(void* dst, const void* src,
                                              int bytes, int elem) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else if (elem == 1) {
    *static_cast<int8_t*>(dst) = *static_cast<const int8_t*>(src);
  } else if (elem == 2) {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  } else {
    *static_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, typename P>
__global__ void __launch_bounds__(kThreads) paged_decode_cluster(
    const T* __restrict__ q,              // [batch, hq, d]
    const P* __restrict__ k_pages,        // [hkv, n_pages, page_size, d]
    const P* __restrict__ v_pages,        // [hkv, n_pages, page_size, d]
    const float* __restrict__ k_scales,   // [hkv, n_pages, page_size]
    const float* __restrict__ v_scales,   // [hkv, n_pages, page_size]
    const int32_t* __restrict__ tables,   // [batch, pages_per_seq]
    const int32_t* __restrict__ lengths,  // [batch]
    T* __restrict__ out,                  // [batch, hq, d]
    int n_q_heads, int n_kv_heads, int n_pages, int page_size,
    int pages_per_seq, int d, float scale, int chunk, int vbytes) {
  constexpr bool kQuant = sizeof(P) == 1;
  constexpr int kElem = sizeof(P);
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char cluster_smem_raw[];
  unsigned char* smem = cluster_smem_raw;
  const int group = n_q_heads / n_kv_heads;
  const int n_ranks = (int)cluster.num_blocks();
  const ClusterSmem lay = cluster_smem(group, d, kElem, chunk, page_size,
                                       vbytes == 16, n_ranks);
  const int krs = lay.krs;
  const int vrs = lay.vrs;
  // chunk c of an odd token's K row sits at chunk c ^ swz (see above)
  const int swz = k_swizzled(d, kElem, vbytes == 16) ? 4 : 0;
  float* q_s = reinterpret_cast<float*>(smem);  // [group][d]
  float* acc_s = q_s + group * d;               // [group][d]
  float* p_s = acc_s + group * d;               // [group][kCTile]
  float* m_s = p_s + group * kCTile;             // [group] running max
  float* l_s = m_s + group;                     // [group] running sum
  float* a_s = l_s + group;                     // [group] tile rescale
  float* mm_s = a_s + group;                    // [blocks][group] pushed m
  float* ml_s = mm_s + n_ranks * group;         // [blocks][group] pushed l
  float* ma_s = ml_s + n_ranks * group;         // [blocks][per] pushed acc
  int* table_s = reinterpret_cast<int*>(ma_s + n_ranks * lay.per);
  unsigned char* ring = smem + lay.ring_offset;

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  // arrive now, wait before the first write to a peer: by then every
  // block of the cluster has started (the rule for distributed shared
  // memory), and the wait costs nothing
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int capacity = pages_per_seq * page_size;
  const int start = rank * chunk;
  const int first_page = start / page_size;
  // q and the chunk's block-table entries (as far as the capacity goes),
  // read once, with the length: three independent loads, not a chain
  if (start < capacity) {
    const size_t qo = ((size_t)b * n_q_heads + (size_t)h * group) * d;
    for (int i = tid; i < group * d; i += kThreads) q_s[i] = to_f32(q[qo + i]);
    const int n_tp =
        (min(capacity, start + chunk) - 1) / page_size - first_page + 1;
    const int32_t* table = tables + (size_t)b * pages_per_seq + first_page;
    for (int i = tid; i < n_tp; i += kThreads) table_s[i] = table[i];
  }
  int length = lengths[b];
  length = length < 0 ? 0 : (length > capacity ? capacity : length);
  const int end = min(length, start + chunk);

  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  for (int i = tid; i < group * d; i += kThreads) acc_s[i] = 0.f;

  if (start < end) {
    __syncthreads();

    const size_t head_base = (size_t)h * n_pages * page_size;  // tokens
    // copies per row: vbytes-wide, or elements with plain loads
    const int per_row = vbytes ? d * kElem / vbytes : d;
    const int part = vbytes ? vbytes : kElem;
    const int n_tiles = (end - start + kCTile - 1) / kCTile;

    // issue tile t's copies into ring stage t % kCStages: 4 threads a
    // token (one block-table lookup each, shared by its K and V rows) copy
    // its rows, and for int8 its two scales
    constexpr int kPer = kThreads / kCTile;  // threads a token
    static_assert(kPer * kCTile == kThreads, "whole threads a token");
    auto issue = [&](int t) {
      const int t0 = start + t * kCTile;
      const int tok = tid / kPer;
      const int sub = tid - tok * kPer;
      if (tok >= min(kCTile, end - t0)) return;
      unsigned char* st = ring + (t % kCStages) * lay.stage;
      const int pos = t0 + tok;
      const size_t token =
          head_base +
          (size_t)table_s[pos / page_size - first_page] * page_size +
          pos % page_size;
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(k_pages + token * d);
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(v_pages + token * d);
      unsigned char* kdst = st + tok * krs;
      unsigned char* vdst = st + kCTile * krs + tok * vrs;
      const int kx = (tok & 1) * swz;
      for (int c = sub; c < per_row; c += kPer) {
        copy_row_part(kdst + (c ^ kx) * part, ksrc + c * part, vbytes,
                      kElem);
        copy_row_part(vdst + c * part, vsrc + c * part, vbytes, kElem);
      }
      if (kQuant && sub < 2) {
        float* sc = reinterpret_cast<float*>(st + kCTile * (krs + vrs));
        copy_row_part(sc + sub * kCTile + tok,
                      (sub ? v_scales : k_scales) + token, vbytes ? 4 : 0, 4);
      }
    };

#pragma unroll
    for (int s = 0; s < kCStages - 1; ++s) {
      if (s < n_tiles) issue(s);
      cp_async_commit();  // an empty group keeps the count
    }
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kCStages - 2>();  // tile t has landed
      __syncthreads();                // ... for every thread; t - 1 done
      if (t + kCStages - 1 < n_tiles) issue(t + kCStages - 1);
      cp_async_commit();
      const unsigned char* st = ring + (t % kCStages) * lay.stage;
      const unsigned char* vst = st + kCTile * krs;
      const float* ksc =
          reinterpret_cast<const float*>(st + kCTile * (krs + vrs));
      const float* vsc = ksc + kCTile;
      const int n = min(kCTile, end - start - t * kCTile);
      // scores: kParts lanes per (query row, token) pair, as the split
      // kernel; an int8 row's scale multiplies its dot product. Rows past
      // n hold stale bytes, whose scores are dropped.
      for (int i = tid; i < group * kCTile * kParts; i += kThreads) {
        const int pt = i & (kParts - 1);
        const int pr = i / kParts;
        const int g = pr / kCTile;
        const int tt = pr - g * kCTile;
        const float* qr = q_s + g * d;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        if (vbytes == 16) {
          // lane pt takes the row's 16-byte chunks pt, pt + 4, ...
          constexpr int V = 16 / kElem;  // values a chunk
          const unsigned char* kr = st + tt * krs;
          const int kx = (tt & 1) * swz;
          for (int ch = pt; ch < d * kElem / 16; ch += kParts) {
            float kv[V];
            unpack<P>(*reinterpret_cast<const uint4*>(kr + (ch ^ kx) * 16),
                      1.f, kv);
            const float4* q4 = reinterpret_cast<const float4*>(qr + ch * V);
#pragma unroll
            for (int e4 = 0; e4 < V / 4; ++e4) {
              const float4 qv = q4[e4];
              s0 += qv.x * kv[4 * e4];
              s1 += qv.y * kv[4 * e4 + 1];
              s2 += qv.z * kv[4 * e4 + 2];
              s3 += qv.w * kv[4 * e4 + 3];
            }
          }
        } else {
          // four independent sums: the chain of dependent FMAs, not the
          // loads, sets a tile's latency
          const P* kr = reinterpret_cast<const P*>(st + tt * krs);
          int c = pt;
          for (; c + 3 * kParts < d; c += 4 * kParts) {
            s0 += qr[c] * to_f32(kr[c]);
            s1 += qr[c + kParts] * to_f32(kr[c + kParts]);
            s2 += qr[c + 2 * kParts] * to_f32(kr[c + 2 * kParts]);
            s3 += qr[c + 3 * kParts] * to_f32(kr[c + 3 * kParts]);
          }
          for (; c < d; c += kParts) s0 += qr[c] * to_f32(kr[c]);
        }
        float dot = (s0 + s1) + (s2 + s3);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (pt == 0) {
          p_s[pr] = tt < n ? dot * scale * (kQuant ? ksc[tt] : 1.f)
                           : -INFINITY;
        }
      }
      __syncthreads();
      // online softmax, one warp per query row; the stored weight carries
      // an int8 V row's scale
      for (int g = warp; g < group; g += kWarps) {
        const float s = lane < kCTile ? p_s[g * kCTile + lane] : -INFINITY;
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
        if (lane < kCTile) {
          p_s[g * kCTile + lane] =
              kQuant ? (lane < n ? p * vsc[lane] : 0.f) : p;
        }
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
        const float* pr = p_s + g * kCTile;
        auto vv = [&](int tt) {
          return to_f32(reinterpret_cast<const P*>(vst + tt * vrs)[c]);
        };
        float a0 = acc_s[i] * a_s[g], a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int tt = 0;
        for (; tt + 3 < n; tt += 4) {
          a0 += pr[tt] * vv(tt);
          a1 += pr[tt + 1] * vv(tt + 1);
          a2 += pr[tt + 2] * vv(tt + 2);
          a3 += pr[tt + 3] * vv(tt + 3);
        }
        for (; tt < n; ++tt) a0 += pr[tt] * vv(tt);
        acc_s[i] = (a0 + a1) + (a2 + a3);
      }
    }
    cp_async_wait<0>();
  }

  // every block's (m, l, acc) is final. Each block pushes it into the
  // shared memory of the blocks that own its outputs (block r owns the
  // slice [r per, (r + 1) per) of the group x d outputs): remote stores,
  // no round trip; then one cluster barrier, after which every block
  // merges its slice from its own shared memory and no block touches a
  // peer's again.
  __syncthreads();  // this block's m, l and acc are written
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int total = group * d;
  const int per = lay.per;
  for (int i = tid; i < n_ranks * group; i += kThreads) {
    const int owner = i / group;
    const int g = i - owner * group;
    *cluster.map_shared_rank(mm_s + rank * group + g, owner) = m_s[g];
    *cluster.map_shared_rank(ml_s + rank * group + g, owner) = l_s[g];
  }
  for (int i = tid; i < total; i += kThreads) {
    const int owner = i / per;
    *cluster.map_shared_rank(ma_s + rank * per + (i - owner * per), owner) =
        acc_s[i];
  }
  cluster.sync();
  const int lo = rank * per;
  const int hi = min(total, lo + per);
  const size_t qo = ((size_t)b * n_q_heads + (size_t)h * group) * d;
  // R lanes (a power of two >= the blocks, dividing the warp) per output:
  // lane j takes block j's (m, l, acc) for it, and shuffles within the R
  // lanes merge them
  const int R = n_ranks <= 2 ? n_ranks : (n_ranks <= 4 ? 4
                                           : (n_ranks <= 8 ? 8 : 16));
  const int j = tid & (R - 1);
  for (int base = lo; base < hi; base += kThreads / R) {  // block-uniform
    const int i = base + tid / R;
    float mr = -INFINITY, lr = 0.f, ar = 0.f;
    if (i < hi && j < n_ranks) {
      const int g = i / d;
      mr = mm_s[j * group + g];
      lr = ml_s[j * group + g];
      ar = ma_s[j * per + (i - lo)];
    }
    float m = mr;
    for (int o = R / 2; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    // a block past the length (or no block: length 0) weighs nothing
    const float w = mr == -INFINITY ? 0.f : expf(mr - m);
    float l = lr * w, a = ar * w;
    for (int o = R / 2; o > 0; o >>= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, o);
      a += __shfl_xor_sync(0xffffffffu, a, o);
    }
    if (j == 0 && i < hi) {
      store(out + qo + i, l == 0.f ? 0.f : a / l);  // length 0: zeros
    }
  }
}

// the widest asynchronous copy (16, 8 or 4 bytes) that divides a row and
// both pools' bases; 0: plain loads
int copy_bytes(int d, int elem, const void* k_pages, const void* v_pages) {
  const int row = d * elem;
  for (int v = 16; v >= 4; v /= 2) {
    if (row % v == 0 && reinterpret_cast<uintptr_t>(k_pages) % v == 0 &&
        reinterpret_cast<uintptr_t>(v_pages) % v == 0) {
      return v;
    }
  }
  return 0;
}

template <typename T, typename P>
int launch_cluster(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales,
                   const void* tables, const void* lengths, void* out,
                   int batch, int n_q_heads, int n_kv_heads, int n_pages,
                   int page_size, int pages_per_seq, int d, float scale,
                   cudaStream_t stream) {
  const int capacity = pages_per_seq * page_size;
  const int group = n_q_heads / n_kv_heads;
  const int vbytes = copy_bytes(d, sizeof(P), k_pages, v_pages);
  auto kernel = paged_decode_cluster<T, P>;
  // Blocks per (sequence, kv head): no more than the card holds resident
  // beside the other pairs' (a cluster's blocks past the length keep their
  // slots until its busy ones are done, so a second wave of blocks waits
  // on the first). The occupancy is read at the largest layout (one
  // block, the longest table) and kept per layout size.
  int blocks, chunk;
  cluster_geometry(capacity, 1, &blocks, &chunk);
  const int most = cluster_smem(group, d, sizeof(P), chunk, page_size,
                                vbytes == 16, kMaxCluster).total;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return (int)err;
  static int known_dev = -1, known_smem = -1, resident = 0;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (known_dev != dev || known_smem != most) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, most)) != cudaSuccess) {
      return (int)err;
    }
    known_dev = dev;
    known_smem = most;
    resident = sms * per_sm;
  }
  const long long pairs = (long long)batch * n_kv_heads;
  cluster_geometry(capacity, (int)(resident / pairs), &blocks, &chunk);
  const ClusterSmem lay = cluster_smem(group, d, sizeof(P), chunk,
                                       page_size, vbytes == 16, blocks);
  if (blocks > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch, n_kv_heads, blocks);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = blocks;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const P*>(k_pages),
      static_cast<const P*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), n_q_heads,
      n_kv_heads, n_pages, page_size, pages_per_seq, d, scale, chunk,
      vbytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int launch(int variant, const void* q, const void* k_pages,
           const void* v_pages, const void* k_scales, const void* v_scales,
           const void* tables, const void* lengths, void* out,
           void* workspace, int batch, int n_q_heads, int n_kv_heads,
           int n_pages, int page_size, int pages_per_seq, int d, float scale,
           cudaStream_t stream) {
  if (variant == 0) {
    return launch_cluster<T, P>(q, k_pages, v_pages, k_scales, v_scales,
                                tables, lengths, out, batch, n_q_heads,
                                n_kv_heads, n_pages, page_size,
                                pages_per_seq, d, scale, stream);
  }
  if (variant == 1) {
    if (workspace == nullptr) return (int)cudaErrorInvalidValue;
    return launch_split<T, P>(q, k_pages, v_pages, k_scales, v_scales,
                              tables, lengths, out, workspace, batch,
                              n_q_heads, n_kv_heads, n_pages, page_size,
                              pages_per_seq, d, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of `variant` needs, in bytes, for a
// query group, head dim, page element size (1, 2 or 4 bytes), page size
// and table capacity in tokens.
size_t paged_attention_smem_bytes(int group, int d, int elem, int page_size,
                                  int capacity, int variant) {
  if (variant == 1) return smem_floats(group, d) * sizeof(float);
  // one block per (sequence, kv head) reads the longest table; the larger
  // of the two layouts (which one runs depends on the pools' alignment)
  int blocks, chunk;
  cluster_geometry(capacity, 1, &blocks, &chunk);
  const int vec =
      cluster_smem(group, d, elem, chunk, page_size, true, kMaxCluster).total;
  const int sca =
      cluster_smem(group, d, elem, chunk, page_size, false, kMaxCluster).total;
  return (size_t)(vec > sca ? vec : sca);
}

// Workspace the split variant needs, in bytes (per-chunk softmax states);
// the cluster variant needs none.
size_t paged_attention_workspace_bytes(int batch, int n_q_heads,
                                       int n_kv_heads, int d,
                                       int capacity) {
  const int n_splits = (capacity + kChunk - 1) / kChunk;
  return workspace_floats(batch, n_q_heads, n_kv_heads, d, n_splits) *
         sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, pages and out share
// it). variant: 0 = cluster (workspace unused), 1 = split-K.
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* lengths, void* out, void* workspace,
                           int batch, int n_q_heads, int n_kv_heads,
                           int n_pages, int page_size, int pages_per_seq,
                           int d, float scale, int dtype, int variant,
                           void* stream) {
  if (batch == 0 || pages_per_seq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, float>(
        variant, q, k_pages, v_pages, nullptr, nullptr, block_tables,
        lengths, out, workspace, batch, n_q_heads, n_kv_heads, n_pages,
        page_size, pages_per_seq, d, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(
        variant, q, k_pages, v_pages, nullptr, nullptr, block_tables,
        lengths, out, workspace, batch, n_q_heads, n_kv_heads, n_pages,
        page_size, pages_per_seq, d, scale, s);
  }
  if (dtype == 2) {
    return launch<__half, __half>(
        variant, q, k_pages, v_pages, nullptr, nullptr, block_tables,
        lengths, out, workspace, batch, n_q_heads, n_kv_heads, n_pages,
        page_size, pages_per_seq, d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Int8 pages with f32 scales [n_kv_heads, n_pages, page_size]; dtype is
// q's and out's (0 = float32, 1 = bfloat16, 2 = float16).
int paged_attention_quant_launch(const void* q, const void* k_pages,
                                 const void* v_pages, const void* k_scales,
                                 const void* v_scales,
                                 const void* block_tables,
                                 const void* lengths, void* out,
                                 void* workspace, int batch, int n_q_heads,
                                 int n_kv_heads, int n_pages, int page_size,
                                 int pages_per_seq, int d, float scale,
                                 int dtype, int variant, void* stream) {
  if (batch == 0 || pages_per_seq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, int8_t>(
        variant, q, k_pages, v_pages, k_scales, v_scales, block_tables,
        lengths, out, workspace, batch, n_q_heads, n_kv_heads, n_pages,
        page_size, pages_per_seq, d, scale, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, int8_t>(
        variant, q, k_pages, v_pages, k_scales, v_scales, block_tables,
        lengths, out, workspace, batch, n_q_heads, n_kv_heads, n_pages,
        page_size, pages_per_seq, d, scale, s);
  }
  if (dtype == 2) {
    return launch<__half, int8_t>(
        variant, q, k_pages, v_pages, k_scales, v_scales, block_tables,
        lengths, out, workspace, batch, n_q_heads, n_kv_heads, n_pages,
        page_size, pages_per_seq, d, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
