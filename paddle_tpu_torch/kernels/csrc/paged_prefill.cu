// Continuation (paged-context) prefill attention for Hopper (sm_90a).
//
// Replaces: no TPU kernel. In the JAX package a prefill continuation
// (paddle_tpu/serving/adapter.py:388, prefill_ext) gathers the sequence's
// whole page timeline (_gather_context, :246) and attends over it in the
// masked scaled_dot_product_attention form (:411-432), which XLA fuses.
// Gathered in PyTorch that is a [heads, S, capacity] score tensor per
// layer and chunk; here the keys are read through the block table in
// place.
//
// Computes, for each slot s (a sequence: one per launch for a prefill
// chunk, one per batch slot for the speculative verify window of
// serving/adapter.py's verify, JAX adapter.py:493), its token t <
// length[s] (global position cache_len[s] + t), query head h and kv head
// kvh = h / (heads / kv_heads) (GQA read in place):
//   out[s, t, h] = softmax_c(q[s, t, h] . K[c, kvh] * scale) V[c, kvh]
// over the keys c <= cache_len[s] + t of slot s's timeline, key c read
// from physical page table[s][c / page_size], slot c % page_size.
// Layout: q and out [slots, S, heads, d]; pages [kv_heads, n_pages,
// page_size, d] of q's dtype, or int8 pages with f32 scales [kv_heads,
// n_pages, page_size] (k = int8 * scale, dequantized as the tile is
// staged); table [slots, pages_per_seq] int32; cache_len and length
// int32 [slots] in DEVICE memory. The grid is fixed by S, the heads, the
// slots and the table's capacity alone: each block reads its slot's
// cache_len and length itself and takes the 64-key tiles (its share of
// them) from absolute position 0 up to cache_len + min(its last query
// row + 1, length), so a CUDA graph captured once replays any chunk or
// window at any offsets. Rows t >=
// length are finite (they see the keys below that end; a tile with no
// row below length writes zeros, so an inactive slot, length 0, writes
// zeros and reads nothing) and are never read. A table entry outside
// [0, n_pages) reads as a zero row.
//
// What bounds it on an H100: neither bytes nor operations at serving
// shapes, but latency. A 128-token bf16 chunk after 192 cached tokens (16
// heads, d 128) moves ~3.6 MB and does ~0.27 GFLOP: ~1.1 us of bytes. A
// verify step of the serving cell (8 slots, a 5-token window each over up
// to 512 cached tokens) moves ~13 MB: ~4 us. What a block costs is the
// chain it walks: its table entries, then each key tile's rows, then the
// products, one tile after the other. So the work of one (query tile,
// head, slot) has to be spread over enough SMs and its loads put in
// flight together.
//
// Two designs for 16-bit q, chosen by the launch's `design`:
//
// Split (design 1; d 64 or 128, page sizes that are multiples of 8 and
// divide 64 or are multiples of it). A block of 4 warps takes a tile of
// M packed query rows of one (slot, kv head): under GQA row p is token p /
// group of query head kvh * group + p % group, so the group's heads share
// every K/V row a block reads. M is sized to the work: 16 rows for a
// window or chunk of S x group <= 16 rows (one mma.sync row tile; the 4
// warps split each 64-key tile into 16-key slices), 32 rows up to 32 (2
// warps a slice of 32 keys), else 64 (each warp 16 rows over all 64 keys).
// The key tiles a row tile needs (to cache_len + its last token + 1, read
// from device memory) are split over a thread-block cluster of `splits`
// blocks (fixed at launch from the capacity and how many blocks the card
// holds beside the grid's other row tiles: a capture holds it), block r
// taking tiles [r n / splits, (r + 1) n / splits). Warp 0 resolves each
// tile's pages from the table (one lane a page) and issues them by TMA,
// one box per (page, 64 columns) with 128-byte swizzle (16-bit pages) or
// raw (int8 pages, with their scales), into a ring of `stages` stages
// on mbarriers: a block's first tiles all fly at once. A table entry
// outside [0, n_pages), or a page past the keys the tile needs, is a box
// out of the tensor's bounds: zeros, no bytes read. int8 tiles are
// converted to q's dtype in shared memory with their scales. Scores and P
// V are mma.sync m16n8k16 fed by ldmatrix from the swizzled tiles, the
// online softmax in registers. Then every warp's (max, sum, accumulator)
// goes to the block of the cluster that owns those rows (distributed
// shared memory stores into the ring, which every block has finished
// with), and after one cluster barrier each block merges its rows over
// the splits x key slices and writes them in q's dtype. With one split
// and one key slice a warp writes its rows itself. Blocks past the key
// end push empty states; a tile of rows all at or past `length` writes
// zeros (rank 0) and reads no page.
//
// Ring (design 0, the first design, kept for side-by-side timing and for
// the head dims and page sizes the split design does not take): the
// flash forward's mma.sync kernel with the key tiles staged through the
// table.
//  * bf16 and float16 q: one block of 4 warps per (64-row query tile,
//    head, slot); mma.sync m16n8k16, the online softmax on the
//    accumulators in registers, P fed back as the A operand of P V in q's
//    dtype. The block table's entries sit in shared memory; for each key
//    tile the block resolves its 64 rows' page offsets there, then copies
//    the rows with cp.async (16-bit rows 16 bytes a copy into the padded
//    tiles; int8 rows raw, 8 bytes a copy, and their scales, converted to
//    q's dtype once landed) into a two-slot ring: tile k + 1 is in flight
//    while tile k is multiplied.
//  * f32 q (both designs): exact f32 FMAs from shared memory, 256
//    threads, each owning a 4 x 4 block of the score tile and a 4 x (d /
//    16) block of the output, as the flash FMA kernel; float rows are
//    copied with cp.async, all of a tile's copies in flight at once; int8
//    rows dequantize in f32 as the plain version does.
// Scores and P V of 64-row tiles at d 128 with bf16 q run on wgmma (one
// warpgroup, A from registers), the rest on mma.sync; 64-row tiles at d
// 64 take 8 warps, two key slices.
// Measured (chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit; kernel alone, median of 20 launches, cold L2), split against
// ring in the same run: the serving verify window (8 slots x 5 rows, 16
// heads, d 128) 0.0217 against 0.0369 ms (bound 0.0040: bytes); its GQA
// form (hq 32, hkv 4, d 64) 0.0157 against 0.0258; int8 pages 0.0289
// against 0.0545; a 16-token chunk at cache_len 496 0.0155 against
// 0.0372; a 128-token chunk after 192 cached 0.0199 against 0.0265 (int8
// 0.0260 against 0.0377); (0, 128) and (37, 61), one row tile of 1-2 key
// tiles, at parity (0.99-1.01). A 64-row tile at d 128 takes ~2 us a
// key tile with one split on wgmma or mma.sync alike (chip_sweeps.py
// prefill_mma), so what a block waits on there is its chain of dependent
// steps (the table, then the tiles, then the products), not its math.
// Launch contract: each block offsets q, out and the table by its slot
// (blockIdx.z) and reads its own table entries, so a block of an inactive
// slot skips nothing another needs. The launch function sets the dynamic
// shared memory, launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // f32 kernel: 16 x 16 threads over 64 x 64
constexpr int kSP = kBK + 1;   // padded score row
constexpr int kTcThreads = 128;

// The tile's rows [k0, k0 + 64): for key c < k_end, its row index in the
// pages (kvh, phys, slot) flattened, or -1 (a zero row), read through
// `table` (in device or shared memory). With scale planes (int8 pages)
// also their K and V scales, 0 for a zero row.
__device__ __forceinline__ void resolve_rows(
    int k0, int k_end, const int* table, int n_pages, int page_size,
    int kvh, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, long long* off_s, float* ksc_s,
    float* vsc_s) {
  for (int r = threadIdx.x; r < kBK; r += blockDim.x) {
    const int col = k0 + r;
    long long off = -1;
    if (col < k_end) {
      const int phys = table[col / page_size];
      if (phys >= 0 && phys < n_pages) {
        off = ((long long)kvh * n_pages + phys) * page_size +
              col % page_size;
      }
    }
    off_s[r] = off;
    if (k_scales != nullptr) {
      ksc_s[r] = off >= 0 ? k_scales[off] : 0.f;
      vsc_s[r] = off >= 0 ? v_scales[off] : 0.f;
    }
  }
}

template <typename P>
__device__ __forceinline__ float page_value(const P* p, long long i,
                                            float sc) {
  if constexpr (std::is_same<P, int8_t>::value) {
    return (float)p[i] * sc;
  } else {
    return p[i];
  }
}

// `bytes` (16, 8 or 4) global -> shared asynchronously; zeros when !valid
// (src is then not read, but must be a valid address)
template <int bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;
  if constexpr (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(d), "l"(src), "n"(bytes), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// f32 q: FMAs from shared memory.

template <int D>
constexpr size_t fma_smem_bytes() {
  return kBK * (sizeof(long long) + 2 * sizeof(float)) +
         (2 * (size_t)kBQ * (D + 1) + (size_t)kBK * D + (size_t)kBQ * kSP +
          3 * (size_t)kBQ) *
             sizeof(float);
}

template <int D, typename P>
__global__ void __launch_bounds__(kThreads) paged_prefill_fma_kernel(
    const float* __restrict__ q, const P* __restrict__ k_pages,
    const P* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table,
    const int* __restrict__ cache_len_p, const int* __restrict__ length_p,
    float* __restrict__ out, int sq, int heads, int kv_heads, int n_pages,
    int page_size, int pages_per_seq, float scale) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* off_s = reinterpret_cast<long long*>(smem_raw);
  float* ksc_s = reinterpret_cast<float*>(off_s + kBK);
  float* vsc_s = ksc_s + kBK;
  float* q_s = vsc_s + kBK;       // [kBQ][DP]
  float* k_s = q_s + kBQ * DP;    // [kBK][DP]
  float* v_s = k_s + kBK * DP;    // [kBK][D]
  float* s_s = v_s + kBK * D;     // [kBQ][kSP]
  float* m_s = s_s + kBQ * kSP;   // [kBQ]
  float* l_s = m_s + kBQ;         // [kBQ]
  float* a_s = l_s + kBQ;         // [kBQ]

  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y;
  const int sl = blockIdx.z;
  const int kvh = hh / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cache_len = max(cache_len_p[sl], 0);
  const int length = min(max(length_p[sl], 0), sq);
  const size_t q_row = (size_t)heads * D;
  const size_t q_slot = (size_t)sl * sq * q_row;
  const float* q_b = q + q_slot + (size_t)hh * D;
  float* o_b = out + q_slot + (size_t)hh * D;
  table += (size_t)sl * pages_per_seq;

  if (q0 >= length) {  // padding only: finite zeros
    for (int i = tid; i < kBQ * D; i += kThreads) {
      const int r = i / D;
      if (q0 + r < sq) o_b[(size_t)(q0 + r) * q_row + i - r * D] = 0.f;
    }
    return;
  }
  const int k_end =
      min(cache_len + min(q0 + kBQ, length), pages_per_seq * page_size);

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = q0 + r;
    q_s[r * DP + c] = row < sq ? q_b[(size_t)row * q_row + c] : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    resolve_rows(k0, k_end, table, n_pages, page_size, kvh, k_scales,
                 v_scales, off_s, ksc_s, vsc_s);
    __syncthreads();
    if constexpr (std::is_same<P, int8_t>::value) {
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int r = i / D;
        const int c = i - r * D;
        const long long off = off_s[r];
        float kv = 0.f, vv = 0.f;
        if (off >= 0) {
          kv = page_value(k_pages, off * D + c, ksc_s[r]);
          vv = page_value(v_pages, off * D + c, vsc_s[r]);
        }
        k_s[r * DP + c] = kv;
        v_s[r * D + c] = vv;
      }
    } else {
      // every load of the tile in flight at once (k_s rows are padded:
      // 4-byte copies)
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int r = i / D;
        const int c = i - r * D;
        const long long off = off_s[r];
        const long long at = off >= 0 ? off * D + c : 0;
        cp_async<4>(k_s + r * DP + c, k_pages + at, off >= 0);
        cp_async<4>(v_s + r * D + c, v_pages + at, off >= 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();

    // scores for rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty + 16 * i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = k_s[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qa[i] * kb[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        const int cc = tx + 16 * j;
        const int col = k0 + cc;
        const bool keep = col < k_end && col <= cache_len + q0 + r;
        s_s[r * kSP + cc] = keep ? sc[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w + 8, ...; lanes own 2 keys
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const float s0 = s_s[r * kSP + lane];
      const float s1 = s_s[r * kSP + lane + 32];
      float mt = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mt);
      float p0 = 0.f, p1 = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {  // a row with no visible key yet stays 0
        p0 = expf(s0 - m_new);
        p1 = expf(s1 - m_new);
        alpha = expf(m_prev - m_new);
      }
      s_s[r * kSP + lane] = p0;
      s_s[r * kSP + lane + 32] = p1;
      float ps = p0 + p1;
      for (int o = 16; o > 0; o >>= 1) {
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      }
      if (lane == 0) {
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + ps;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty + 16 * i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v_s[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += p[i] * vv[j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row < sq) {
      const float l = l_s[r];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        o_b[(size_t)row * q_row + tx + 16 * j] =
            l == 0.f ? 0.f : acc[i][j] / l;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 / float16 q on the tensor cores (mma.sync m16n8k16). Fragment
// layouts are the PTX ISA's, as in flash_attention.cu:
//   A (16x16): reg0 = A[g][2t..2t+1], reg1 = A[g+8][2t..], reg2 =
//              A[g][2t+8..], reg3 = A[g+8][2t+8..]
//   B (16x8):  reg0 = B[2t..2t+1][g], reg1 = B[2t+8..2t+9][g]
//   C (16x8):  c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// with g = lane / 4 and t = lane % 4.

template <typename T>
struct Tc;

template <>
struct Tc<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float c[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16(x);
  }
};

template <>
struct Tc<__half> {
  static __device__ __forceinline__ void mma(float c[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ __half from(float x) {
    return __float2half_rn(x);
  }
};

template <typename T>
__device__ __forceinline__ uint32_t pair(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ uint32_t pair2(const T* lo, const T* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

// Shared memory of the tc kernel: row metadata for the two ring slots,
// the query tile, and the K/V tiles in q's dtype, two ring slots of them
// for 16-bit pages; int8 pages land raw in a two-slot ring of their own
// and are converted into one slot of 16-bit tiles.
template <int D, typename T, typename P>
struct TcSmem {
  static constexpr bool kQuant = std::is_same<P, int8_t>::value;
  static constexpr int kRow = D + 8;                 // padded 16-bit row
  static constexpr int kTileSlots = kQuant ? 1 : 2;  // 16-bit K/V tiles
  static constexpr size_t kMeta = 2 * kBK * (sizeof(long long) + 8);
  static constexpr size_t kTile = (size_t)kBK * kRow * sizeof(T);
  static constexpr size_t kRaw = (size_t)kBK * D;    // one int8 tile
  static constexpr size_t kTable =  // the block table follows
      kMeta + kTile * (1 + 2 * kTileSlots) + (kQuant ? 4 * kRaw : 0);
  static constexpr size_t bytes(int pages_per_seq) {
    return kTable + (size_t)pages_per_seq * sizeof(int);
  }
};

template <int D, typename T, typename P>
constexpr size_t tc_smem_bytes(int pages_per_seq) {
  return TcSmem<D, T, P>::bytes(pages_per_seq);
}

// Issue the asynchronous copies of one K/V tile (rows resolved in
// off_s) into ring slot `slot`: 16-bit rows straight into the padded
// tiles, 16 bytes a copy; int8 rows raw, 8 bytes a copy. Rows with no
// source are zero-filled.
template <int D, typename T, typename P>
__device__ __forceinline__ void issue_tile(
    const P* __restrict__ k_pages, const P* __restrict__ v_pages,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    const long long* off_s, T* k_dst, T* v_dst, int8_t* k_raw,
    int8_t* v_raw, float* ksc_s, float* vsc_s) {
  constexpr int V = D / 8;  // 8-element vectors per row
  if constexpr (std::is_same<P, int8_t>::value) {
    for (int r = threadIdx.x; r < kBK; r += kTcThreads) {
      const long long off = off_s[r];
      cp_async<4>(ksc_s + r, k_scales + (off >= 0 ? off : 0), off >= 0);
      cp_async<4>(vsc_s + r, v_scales + (off >= 0 ? off : 0), off >= 0);
    }
  }
  for (int i = threadIdx.x; i < kBK * V; i += kTcThreads) {
    const int r = i / V;
    const int c = (i - r * V) * 8;
    const long long off = off_s[r];
    const long long at = off >= 0 ? off * D + c : 0;
    if constexpr (std::is_same<P, int8_t>::value) {
      cp_async<8>(k_raw + r * D + c, k_pages + at, off >= 0);
      cp_async<8>(v_raw + r * D + c, v_pages + at, off >= 0);
    } else {
      cp_async<16>(k_dst + r * (D + 8) + c, k_pages + at, off >= 0);
      cp_async<16>(v_dst + r * (D + 8) + c, v_pages + at, off >= 0);
    }
  }
}

// int8 rows (landed raw) to q's dtype with their scales: a zero-filled
// row has scale 0 and stays 0.
template <int D, typename T>
__device__ __forceinline__ void convert_tile(const int8_t* raw,
                                             const float* sc_s, T* dst) {
  constexpr int V = D / 8;
  for (int i = threadIdx.x; i < kBK * V; i += kTcThreads) {
    const int r = i / V;
    const int c = (i - r * V) * 8;
    const uint2 w8 = *reinterpret_cast<const uint2*>(raw + r * D + c);
    const int8_t* e = reinterpret_cast<const int8_t*>(&w8);
    const float sc = sc_s[r];
    uint4 w;
    w.x = Tc<T>::pack((float)e[0] * sc, (float)e[1] * sc);
    w.y = Tc<T>::pack((float)e[2] * sc, (float)e[3] * sc);
    w.z = Tc<T>::pack((float)e[4] * sc, (float)e[5] * sc);
    w.w = Tc<T>::pack((float)e[6] * sc, (float)e[7] * sc);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = w;
  }
}

template <int D, typename T, typename P>
__global__ void __launch_bounds__(kTcThreads) paged_prefill_tc_kernel(
    const T* __restrict__ q, const P* __restrict__ k_pages,
    const P* __restrict__ v_pages, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table,
    const int* __restrict__ cache_len_p, const int* __restrict__ length_p,
    T* __restrict__ out, int sq, int heads, int kv_heads, int n_pages,
    int page_size, int pages_per_seq, float scale) {
  using L = TcSmem<D, T, P>;
  constexpr int S = L::kRow;  // padded smem row, 16-bit elements
  constexpr int DT = D / 8;   // 8-wide output column tiles per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* off_s = reinterpret_cast<long long*>(smem_raw);  // [2][kBK]
  float* ksc_s = reinterpret_cast<float*>(off_s + 2 * kBK);   // [2][kBK]
  float* vsc_s = ksc_s + 2 * kBK;                             // [2][kBK]
  T* q_s = reinterpret_cast<T*>(smem_raw + L::kMeta);
  T* kv_s = q_s + kBQ * S;  // [slots][K, V][kBK][S]
  int8_t* raw_s = reinterpret_cast<int8_t*>(
      smem_raw + L::kMeta + L::kTile * (1 + 2 * L::kTileSlots));
  int* table_s = reinterpret_cast<int*>(smem_raw + L::kTable);

  const int q0 = blockIdx.x * kBQ;
  const int hh = blockIdx.y;
  const int sl = blockIdx.z;
  const int kvh = hh / (heads / kv_heads);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cache_len = max(cache_len_p[sl], 0);
  const int length = min(max(length_p[sl], 0), sq);
  const size_t q_row = (size_t)heads * D;
  const size_t q_slot = (size_t)sl * sq * q_row;
  const T* q_b = q + q_slot + (size_t)hh * D;
  T* o_b = out + q_slot + (size_t)hh * D;
  table += (size_t)sl * pages_per_seq;

  if (q0 >= length) {  // padding only: finite zeros
    for (int i = threadIdx.x; i < kBQ * D; i += kTcThreads) {
      const int r = i / D;
      if (q0 + r < sq) {
        o_b[(size_t)(q0 + r) * q_row + i - r * D] = Tc<T>::from(0.f);
      }
    }
    return;
  }
  const int k_end =
      min(cache_len + min(q0 + kBQ, length), pages_per_seq * page_size);
  const int n_tiles = (k_end + kBK - 1) / kBK;

  auto tile_k = [&](int slot) { return kv_s + (2 * slot) * kBK * S; };
  auto tile_v = [&](int slot) { return kv_s + (2 * slot + 1) * kBK * S; };
  auto prefetch = [&](int kt, int slot) {
    // the slot's row offsets from the block table in shared memory, then
    // its copies, the int8 scales among them (one commit group a tile)
    long long* offs = off_s + slot * kBK;
    resolve_rows(kt * kBK, k_end, table_s, n_pages, page_size, kvh, nullptr,
                 nullptr, offs, nullptr, nullptr);
    __syncthreads();
    issue_tile<D, T, P>(k_pages, v_pages, k_scales, v_scales, offs,
                        tile_k(L::kQuant ? 0 : slot),
                        tile_v(L::kQuant ? 0 : slot),
                        raw_s + (2 * slot) * L::kRaw,
                        raw_s + (2 * slot + 1) * L::kRaw,
                        ksc_s + slot * kBK, vsc_s + slot * kBK);
  };

  // the slot's table entries the tiles will read, once (every block
  // loads its own: none relies on another block of its slot)
  for (int i = threadIdx.x; i < (k_end + page_size - 1) / page_size;
       i += kTcThreads) {
    table_s[i] = table[i];
  }
  __syncthreads();

  // the query tile (rows past sq are zeros) joins tile 0's copy group
  for (int i = threadIdx.x; i < kBQ * DT; i += kTcThreads) {
    const int r = i / DT;
    const int c = (i - r * DT) * 8;
    const bool ok = q0 + r < sq;
    cp_async<16>(q_s + r * S + c, q_b + (ok ? (size_t)(q0 + r) * q_row + c : 0),
                 ok);
  }
  prefetch(0, 0);
  cp_async_commit();

  const int r_lo = q0 + warp * 16 + g;  // this lane's two query rows
  const int r_hi = r_lo + 8;
  const int see_lo = cache_len + r_lo;  // last visible key of each row
  const int see_hi = cache_len + r_hi;
  const T* qa = q_s + (warp * 16 + g) * S + 2 * t;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int slot = kt & 1;
    const int k0 = kt * kBK;
    // tile kt + 1 in flight while tile kt is used. Its slot was last read
    // by tile kt - 1: the barrier inside prefetch, between resolving the
    // rows (metadata no product reads) and issuing the copies, waits for
    // every thread to finish tile kt - 1
    if (kt + 1 < n_tiles) prefetch(kt + 1, slot ^ 1);
    cp_async_commit();  // possibly empty: keeps one group per tile
    cp_async_wait<1>();  // tile kt (and the query tile) have landed
    __syncthreads();
    if constexpr (L::kQuant) {
      convert_tile<D, T>(raw_s + (2 * slot) * L::kRaw, ksc_s + slot * kBK,
                         tile_k(0));
      convert_tile<D, T>(raw_s + (2 * slot + 1) * L::kRaw,
                         vsc_s + slot * kBK, tile_v(0));
      __syncthreads();
    }
    const T* k_s = tile_k(L::kQuant ? 0 : slot);
    const T* v_s = tile_v(L::kQuant ? 0 : slot);

    // scores: 16 rows x 64 keys = 8 tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const uint32_t a0 = pair(qa + kk);
      const uint32_t a1 = pair(qa + 8 * S + kk);
      const uint32_t a2 = pair(qa + kk + 8);
      const uint32_t a3 = pair(qa + 8 * S + kk + 8);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const T* kb = k_s + (n * 8 + g) * S + kk + 2 * t;
        Tc<T>::mma(sc[n], a0, a1, a2, a3, pair(kb), pair(kb + 8));
      }
    }

    // mask, then the online softmax on the accumulators
    float mt_lo = -INFINITY, mt_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + n * 8 + 2 * t + e;
        const bool ok = col < k_end;
        sc[n][e] = ok && col <= see_lo ? sc[n][e] * scale : -INFINITY;
        sc[n][2 + e] =
            ok && col <= see_hi ? sc[n][2 + e] * scale : -INFINITY;
        mt_lo = fmaxf(mt_lo, sc[n][e]);
        mt_hi = fmaxf(mt_hi, sc[n][2 + e]);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mt_lo = fmaxf(mt_lo, __shfl_xor_sync(0xffffffffu, mt_lo, o_));
      mt_hi = fmaxf(mt_hi, __shfl_xor_sync(0xffffffffu, mt_hi, o_));
    }
    const float mn_lo = fmaxf(m_lo, mt_lo);
    const float mn_hi = fmaxf(m_hi, mt_hi);
    // a row with no visible key yet keeps p = 0 (exp(-inf - 0)); the
    // old state is scaled by exp(-inf - x) = 0 until its first key
    const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float al_lo = expf(m_lo - base_lo);
    const float al_hi = expf(m_hi - base_hi);
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[n][e] = expf(sc[n][e] - base_lo);
        sc[n][2 + e] = expf(sc[n][2 + e] - base_hi);
        ps_lo += sc[n][e];
        ps_hi += sc[n][2 + e];
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      ps_lo += __shfl_xor_sync(0xffffffffu, ps_lo, o_);
      ps_hi += __shfl_xor_sync(0xffffffffu, ps_hi, o_);
    }
    l_lo = l_lo * al_lo + ps_lo;
    l_hi = l_hi * al_hi + ps_hi;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= al_lo;
      o[j][1] *= al_lo;
      o[j][2] *= al_hi;
      o[j][3] *= al_hi;
    }
    m_lo = mn_lo;
    m_hi = mn_hi;

    // o += P V: 4 steps of 16 keys; P's A fragment is two score tiles
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t a0 = Tc<T>::pack(sc[2 * ks][0], sc[2 * ks][1]);
      const uint32_t a1 = Tc<T>::pack(sc[2 * ks][2], sc[2 * ks][3]);
      const uint32_t a2 = Tc<T>::pack(sc[2 * ks + 1][0], sc[2 * ks + 1][1]);
      const uint32_t a3 = Tc<T>::pack(sc[2 * ks + 1][2], sc[2 * ks + 1][3]);
      const T* vb = v_s + (ks * 16 + 2 * t) * S + g;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const T* vj = vb + j * 8;
        Tc<T>::mma(o[j], a0, a1, a2, a3, pair2(vj, vj + S),
                   pair2(vj + 8 * S, vj + 9 * S));
      }
    }
  }

  const float inv_lo = l_lo == 0.f ? 0.f : 1.f / l_lo;
  const float inv_hi = l_hi == 0.f ? 0.f : 1.f / l_hi;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = j * 8 + 2 * t;
    if (r_lo < sq) {
      *reinterpret_cast<uint32_t*>(o_b + (size_t)r_lo * q_row + c) =
          Tc<T>::pack(o[j][0] * inv_lo, o[j][1] * inv_lo);
    }
    if (r_hi < sq) {
      *reinterpret_cast<uint32_t*>(o_b + (size_t)r_hi * q_row + c) =
          Tc<T>::pack(o[j][2] * inv_hi, o[j][3] * inv_hi);
    }
  }
}

// ---------------------------------------------------------------------------
// The split design (design 1): 16-bit q, d 64 or 128, pages by TMA.

constexpr int kKeyTile = 64;     // keys a ring stage
constexpr int kMaxStages = 6;    // ring stages at most (the launch picks)
// blocks a cluster at most: 8-block clusters were as slow as 4 or up to
// 1.5x slower at every shape but the GQA window, 4 % faster there
// (chip_sweeps.py prefill_split: their scheduling and merges cost more
// than the shorter key ranges save)
constexpr int kMaxSplits = 4;  // sweep: prefill_max_splits
// key slices of a 64-row tile at d 128 (2 at d 64; chip_sweeps.py
// prefill_slices: two, 8 warps, were slower at d 128)
constexpr int kSlicesD128 = 1;  // sweep: prefill_slices_d128
// 64-row tiles at d 128 with bf16 q: QK^T and PV on wgmma (one warpgroup,
// A from registers: the q fragments and P; B straight from the swizzled
// tiles), else mma.sync (chip_sweeps.py prefill_mma times both)
constexpr bool kSplitWgmma = true;  // sweep: prefill_wgmma

template <int D, typename P, int RW>
struct SplitCfg {
  static constexpr bool kQuant = std::is_same<P, int8_t>::value;
  static constexpr int kRows = 16 * RW;             // packed query rows
  // warps sharing a 16-row group, each a slice of every key tile: 4 for
  // 16 rows, 2 for 32, and for 64 rows 2 at d 64 (8 warps), kSlicesD128
  // at d 128
  static constexpr int kKW =
      RW == 1 ? 4 : (RW == 2 || D == 64 ? 2 : kSlicesD128);
  static constexpr int kThreads = 32 * RW * kKW;
  static constexpr int kSlice = kKeyTile / kKW;     // keys a warp a stage
  static constexpr int kTile16 = kKeyTile * D * 2;  // swizzled K or V tile
  // int8 scales of one stage: K's then V's, each a 128-byte aligned slot
  // per box (a box is at most 64 rows: 256 bytes; at least 8: 8 slots)
  static constexpr int kScaleBytes = 1024;
  static constexpr int kStage =
      kQuant ? 2 * kKeyTile * D + 2 * kScaleBytes : 2 * kTile16;
  // bytes a stage's boxes land (its barrier's transaction count)
  static constexpr int kStageTx =
      kQuant ? 2 * kKeyTile * D + 2 * kKeyTile * 4 : 2 * kTile16;
  // once the ring is done with, it holds the states being merged: the
  // key slices' (accumulator, max, sum) rows of the warps kw > 0, then
  // the splits' rows pushed to the block that owns them
  static constexpr int kStateRow = D + 2;  // floats
  static constexpr int kSlices = (kKW - 1) * kRows * kStateRow * 4;
  static constexpr int kMerge = kRows * kStateRow * 4;
  static constexpr int kCvt = kQuant ? 2 * kTile16 : 0;  // converted K, V
  // Layout from the 1024-aligned base: the converted tiles, the arena
  // (the ring of `stages` stages, later the states), the barriers, the
  // slot's block table; plus 1024 bytes of alignment slack.
  static __host__ __device__ constexpr int arena(int stages) {
    const int ring = stages * kStage;
    const int most = ring > kSlices ? ring : kSlices;
    return ((most > kMerge ? most : kMerge) + 1023) / 1024 * 1024;
  }
  static __host__ __device__ constexpr int table(int stages) {
    return kCvt + arena(stages) + kMaxStages * 8;
  }
  static constexpr int bytes(int stages, int pages_per_seq) {
    return 1024 + table(stages) + (pages_per_seq * 4 + 15) / 16 * 16;
  }
};

// Byte offset of 16-byte chunk c (of d / 8) of row r of a 64-row tile
// that TMA wrote with 128-byte swizzle: one 64-column box after the other
// (box c / 8), chunk c % 8 of a row stored at (c % 8) ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * (kKeyTile * 128) + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

template <int D, typename T, typename P, int RW>
__global__ void __launch_bounds__(SplitCfg<D, P, RW>::kThreads) paged_prefill_split_kernel(
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap ks_map,
    const __grid_constant__ CUtensorMap vs_map, const T* __restrict__ q,
    const int* __restrict__ table, const int* __restrict__ cache_len_p,
    const int* __restrict__ length_p, T* __restrict__ out, int sq,
    int heads, int kv_heads, int page_size, int pages_per_seq, float scale,
    int row_tiles, int stages) {
  using C = SplitCfg<D, P, RW>;
  constexpr int M = C::kRows;
  constexpr int KW = C::kKW;
  constexpr int KS = C::kSlice;
  // one warpgroup over the 64 rows and all 64 keys of a stage
  constexpr bool kWg = kSplitWgmma && RW == 4 && KW == 1 && D == 128 &&
                       std::is_same<T, __nv_bfloat16>::value;
  constexpr int NB = KS / 8;  // 8-key score tiles of a warp's slice
  constexpr int DT = D / 8;   // 8-wide output column tiles (16-byte chunks)
  constexpr int SR = C::kStateRow;
  extern __shared__ __align__(1024) unsigned char split_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(split_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* cvt = smem;
  unsigned char* ring = smem + C::kCvt;  // the arena
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::arena(stages));
  int* table_s = reinterpret_cast<int*>(smem + C::table(stages));

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rt = blockIdx.y % row_tiles;
  const int kvh = blockIdx.y / row_tiles;
  const int sl = blockIdx.z;
  const int group = heads / kv_heads;
  const int n_rows = sq * group;  // packed (token, head-of-group) rows
  const int p0 = rt * M;
  const size_t q_row = (size_t)heads * D;
  const size_t slot_off = (size_t)sl * sq * q_row;
  // packed row p's q or out row
  auto row_of = [&](int p) {
    return slot_off + (size_t)(p / group) * q_row +
           (size_t)(kvh * group + p % group) * D;
  };

  // the slot's offsets and its block table, read together: one round
  // trip, not a chain
  const int cache_len = max(cache_len_p[sl], 0);
  const int length = min(max(length_p[sl], 0), sq);
  table += (size_t)sl * pages_per_seq;
  for (int i = threadIdx.x; i < pages_per_seq; i += C::kThreads) {
    table_s[i] = table[i];
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (p0 / group >= length) {  // padding only: finite zeros, no page read
    if (rank == 0) {
      for (int i = threadIdx.x; i < M * DT; i += C::kThreads) {
        const int r = i / DT;
        if (p0 + r < n_rows) {
          *reinterpret_cast<uint4*>(out + row_of(p0 + r) + (i - r * DT) * 8) =
              make_uint4(0, 0, 0, 0);
        }
      }
    }
    return;  // every block of the cluster: they share (row tile, slot)
  }
  const int last = (min(p0 + M, n_rows) - 1) / group;  // the tile's last token
  const int capacity = pages_per_seq * page_size;
  const int k_end = min(cache_len + min(last + 1, length), capacity);
  const int n_tiles = (k_end + kKeyTile - 1) / kKeyTile;
  const int kt0 = rank * n_tiles / splits;
  const int mine = (rank + 1) * n_tiles / splits - kt0;
  const int box_rows = min(page_size, kKeyTile);  // 8, 16, 32 or 64
  const int box_shift = __ffs(box_rows) - 1;
  const int ppt = kKeyTile >> box_shift;  // boxes a tile: pages or parts
  const int slot_shift = box_shift > 5 ? box_shift : 5;  // scale slots

  // Tiles [first, first + count) of this block into their ring stages:
  // lane 0 arms each stage's barrier with the stage's bytes (an
  // out-of-bounds box still lands its zeros and counts them), then one
  // lane a box resolves its page and issues its copies.
  auto issue = [&](int first, int count) {
    if (warp != 0) return;
    if (lane == 0) {
      for (int i = first; i < first + count; ++i) {
        hopper::mbar_arrive_expect_tx(&full[i % stages], C::kStageTx);
      }
    }
    __syncwarp();
    for (int w = lane; w < count * ppt; w += 32) {
      const int i = first + w / ppt;
      const int part = w - (w / ppt) * ppt;
      const int key = (kt0 + i) * kKeyTile + (part << box_shift);
      const int lp = key / page_size;
      const int phys = key < k_end && lp < pages_per_seq ? table_s[lp] : -1;
      const int off = key - lp * page_size;
      uint64_t* bar = &full[i % stages];
      unsigned char* st = ring + (i % stages) * C::kStage;
      if constexpr (C::kQuant) {
        hopper::tma_load_4d(st + (part << box_shift) * D, &k_map, bar, 0,
                            off, phys, kvh);
        hopper::tma_load_4d(st + (kKeyTile + (part << box_shift)) * D,
                            &v_map, bar, 0, off, phys, kvh);
        float* sc = reinterpret_cast<float*>(st + 2 * kKeyTile * D);
        hopper::tma_load_3d(sc + (part << slot_shift), &ks_map, bar, off,
                            phys, kvh);
        hopper::tma_load_3d(sc + C::kScaleBytes / 4 + (part << slot_shift),
                            &vs_map, bar, off, phys, kvh);
      } else {
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          const int at = h * kKeyTile * 128 + (part << box_shift) * 128;
          hopper::tma_load_4d(st + at, &k_map, bar, h * 64, off, phys, kvh);
          hopper::tma_load_4d(st + C::kTile16 + at, &v_map, bar, h * 64, off,
                              phys, kvh);
        }
      }
    }
  };

  if (threadIdx.x == 0) {
    hopper::tma_prefetch(&k_map);
    hopper::tma_prefetch(&v_map);
  }
  issue(0, min(stages, mine));

  // this warp's 16 rows and key slice; its q rows straight from device
  // memory as mma A fragments while the first tiles land
  const int rw = warp % RW;
  const int kw = warp / RW;
  const int pr0 = p0 + rw * 16;
  const bool act = pr0 < n_rows;
  const int p_lo = pr0 + g;
  const int p_hi = p_lo + 8;
  const int see_lo = cache_len + p_lo / group;  // last visible key
  const int see_hi = cache_len + p_hi / group;
  uint32_t qf[D / 16][4];
  {
    const T* ql = q + row_of(p_lo < n_rows ? p_lo : 0) + 2 * t4;
    const T* qh = q + row_of(p_hi < n_rows ? p_hi : 0) + 2 * t4;
    const bool ok_lo = p_lo < n_rows;
    const bool ok_hi = p_hi < n_rows;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = ok_lo ? pair(ql + kk * 16) : 0u;
      qf[kk][1] = ok_hi ? pair(qh + kk * 16) : 0u;
      qf[kk][2] = ok_lo ? pair(ql + kk * 16 + 8) : 0u;
      qf[kk][3] = ok_hi ? pair(qh + kk * 16 + 8) : 0u;
    }
  }
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // ldmatrix lanes: matrix lane / 8, its row lane % 8
  const int lrow = lane & 7;
  const int lhalf = (lane >> 3) & 1;  // second 8 columns (K) or keys (V)
  const int lpair = lane >> 4;        // second n tile

  for (int i = 0; i < mine; ++i) {
    const int stage = i % stages;
    hopper::mbar_wait(&full[stage], (i / stages) & 1);
    unsigned char* st = ring + stage * C::kStage;
    if constexpr (C::kQuant) {
      // raw int8 rows and their scales to q's dtype, swizzled as TMA
      // would write them; a zero-filled row has scale 0
      const int8_t* raw = reinterpret_cast<const int8_t*>(st);
      const float* sc = reinterpret_cast<const float*>(st + 2 * kKeyTile * D);
      for (int x = threadIdx.x; x < 2 * kKeyTile * DT; x += C::kThreads) {
        const int kv = x / (kKeyTile * DT);
        const int rem = x - kv * (kKeyTile * DT);
        const int r = rem / DT;
        const int c = rem - r * DT;
        const uint2 w8 = *reinterpret_cast<const uint2*>(
            raw + (kv * kKeyTile + r) * D + c * 8);
        const int8_t* e = reinterpret_cast<const int8_t*>(&w8);
        const float s = sc[kv * (C::kScaleBytes / 4) +
                           ((r >> box_shift) << slot_shift) +
                           (r & (box_rows - 1))];
        uint4 w;
        w.x = Tc<T>::pack((float)e[0] * s, (float)e[1] * s);
        w.y = Tc<T>::pack((float)e[2] * s, (float)e[3] * s);
        w.z = Tc<T>::pack((float)e[4] * s, (float)e[5] * s);
        w.w = Tc<T>::pack((float)e[6] * s, (float)e[7] * s);
        *reinterpret_cast<uint4*>(cvt + kv * C::kTile16 + swz(r, c)) = w;
      }
      if constexpr (kWg) hopper::fence_proxy_async();  // wgmma reads them
      __syncthreads();
    }
    const unsigned char* kt = C::kQuant ? cvt : st;  // this stage's K, V
    const uint32_t kb = hopper::smem_u32(kt);
    const uint32_t vb = kb + C::kTile16;
    if (act || kWg) {  // a warpgroup's wgmma takes all four warps
      const int key0 = (kt0 + i) * kKeyTile + kw * KS;  // slice's first key
      float sc[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      if constexpr (kWg) {
        // S[64 x 64] = Q K^T: K is K-major, a k16 step 32 bytes along the
        // 128-byte row, the second 64 columns the next box
        float(&s32)[NB * 4] = reinterpret_cast<float(&)[NB * 4]>(sc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          hopper::wgmma_rs<64, 0>(
              s32, qf[kk],
              hopper::desc_k_major(kt + (kk >> 2) * (kKeyTile * 128) +
                                   (kk & 3) * 32),
              kk);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s32);
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
          for (int n = 0; n < NB; n += 2) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4(kb + swz(kw * KS + (n + lpair) * 8 + lrow, 2 * kk + lhalf),
                    b0, b1, b2, b3);
            Tc<T>::mma(sc[n], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], b0,
                       b1);
            Tc<T>::mma(sc[n + 1], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3],
                       b2, b3);
          }
        }
      }
      // mask, then the online softmax on the accumulators
      float mt_lo = -INFINITY, mt_hi = -INFINITY;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = key0 + n * 8 + 2 * t4 + e;
          const bool ok = col < k_end;
          sc[n][e] = ok && col <= see_lo ? sc[n][e] * scale : -INFINITY;
          sc[n][2 + e] =
              ok && col <= see_hi ? sc[n][2 + e] * scale : -INFINITY;
          mt_lo = fmaxf(mt_lo, sc[n][e]);
          mt_hi = fmaxf(mt_hi, sc[n][2 + e]);
        }
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mt_lo = fmaxf(mt_lo, __shfl_xor_sync(0xffffffffu, mt_lo, o_));
        mt_hi = fmaxf(mt_hi, __shfl_xor_sync(0xffffffffu, mt_hi, o_));
      }
      const float mn_lo = fmaxf(m_lo, mt_lo);
      const float mn_hi = fmaxf(m_hi, mt_hi);
      // a row with no visible key yet keeps p = 0 (exp(-inf - 0)); the
      // old state is scaled by exp(-inf - x) = 0 until its first key
      const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
      const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
      const float al_lo = expf(m_lo - base_lo);
      const float al_hi = expf(m_hi - base_hi);
      float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[n][e] = expf(sc[n][e] - base_lo);
          sc[n][2 + e] = expf(sc[n][2 + e] - base_hi);
          ps_lo += sc[n][e];
          ps_hi += sc[n][2 + e];
        }
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        ps_lo += __shfl_xor_sync(0xffffffffu, ps_lo, o_);
        ps_hi += __shfl_xor_sync(0xffffffffu, ps_hi, o_);
      }
      l_lo = l_lo * al_lo + ps_lo;
      l_hi = l_hi * al_hi + ps_hi;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][0] *= al_lo;
        o[j][1] *= al_lo;
        o[j][2] *= al_hi;
        o[j][3] *= al_hi;
      }
      m_lo = mn_lo;
      m_hi = mn_hi;
      // o += P V over the slice, 16 keys a step; P's A fragment is two
      // score tiles (all packed before wgmma's fence), V's B fragments two
      // column tiles a transposed load (wgmma: V is MN-major, a k16 step
      // two 8-row groups further)
      uint32_t pa[KS / 16][4];
#pragma unroll
      for (int ks = 0; ks < KS / 16; ++ks) {
        pa[ks][0] = Tc<T>::pack(sc[2 * ks][0], sc[2 * ks][1]);
        pa[ks][1] = Tc<T>::pack(sc[2 * ks][2], sc[2 * ks][3]);
        pa[ks][2] = Tc<T>::pack(sc[2 * ks + 1][0], sc[2 * ks + 1][1]);
        pa[ks][3] = Tc<T>::pack(sc[2 * ks + 1][2], sc[2 * ks + 1][3]);
      }
      if constexpr (kWg) {
        float(&o64)[DT * 4] = reinterpret_cast<float(&)[DT * 4]>(o);
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS / 16; ++ks) {
          hopper::wgmma_rs<D, 1>(
              o64, pa[ks],
              hopper::desc_mn_major(kt + C::kTile16 + ks * 2048,
                                    kKeyTile * 128),
              1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o64);
      } else {
#pragma unroll
        for (int ks = 0; ks < KS / 16; ++ks) {
          const int vr = kw * KS + ks * 16 + lhalf * 8 + lrow;
#pragma unroll
          for (int j = 0; j < DT; j += 2) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(vb + swz(vr, j + lpair), b0, b1, b2, b3);
            Tc<T>::mma(o[j], pa[ks][0], pa[ks][1], pa[ks][2], pa[ks][3], b0,
                       b1);
            Tc<T>::mma(o[j + 1], pa[ks][0], pa[ks][1], pa[ks][2], pa[ks][3],
                       b2, b3);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the stage (and cvt)
    if (i + stages < mine) issue(i + stages, 1);
  }

  // The warps of a key slice kw > 0 hand their rows' state to warp kw = 0
  // of the same rows through the ring, which every warp is done with:
  // (accumulator, max, sum) rows of SR floats, [kw - 1][M][SR].
  if constexpr (KW > 1) {
    float* xs = reinterpret_cast<float*>(ring);
    if (kw > 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* b = xs + ((kw - 1) * M + rw * 16 + g + 8 * h) * SR;
        if (t4 == 0) {
          b[D] = h ? m_hi : m_lo;
          b[D + 1] = h ? l_hi : l_lo;
        }
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          *reinterpret_cast<float2*>(b + j * 8 + 2 * t4) =
              make_float2(o[j][2 * h], o[j][2 * h + 1]);
        }
      }
    }
    __syncthreads();
    if (kw == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* b = xs + (rw * 16 + g + 8 * h) * SR;
        float m = h ? m_hi : m_lo;
        float l = h ? l_hi : l_lo;
        float mx = m;
#pragma unroll
        for (int x = 1; x < KW; ++x) mx = fmaxf(mx, b[(x - 1) * M * SR + D]);
        // a slice with no visible key (or none at all) weighs nothing
        const float w0 = m == -INFINITY ? 0.f : expf(m - mx);
        l *= w0;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          o[j][2 * h] *= w0;
          o[j][2 * h + 1] *= w0;
        }
#pragma unroll
        for (int x = 1; x < KW; ++x) {
          const float* bx = b + (x - 1) * M * SR;
          const float mp = bx[D];
          if (mp == -INFINITY) continue;
          const float w = expf(mp - mx);
          l += w * bx[D + 1];
#pragma unroll
          for (int j = 0; j < DT; ++j) {
            const float2 a = *reinterpret_cast<const float2*>(
                bx + j * 8 + 2 * t4);
            o[j][2 * h] += w * a.x;
            o[j][2 * h + 1] += w * a.y;
          }
        }
        if (h) {
          m_hi = mx;
          l_hi = l;
        } else {
          m_lo = mx;
          l_lo = l;
        }
      }
    }
  }

  if (splits == 1) {  // warp kw = 0 holds its rows' whole state
    if (act && kw == 0) {
      const float inv_lo = l_lo == 0.f ? 0.f : 1.f / l_lo;
      const float inv_hi = l_hi == 0.f ? 0.f : 1.f / l_hi;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int c = j * 8 + 2 * t4;
        if (p_lo < n_rows) {
          *reinterpret_cast<uint32_t*>(out + row_of(p_lo) + c) =
              Tc<T>::pack(o[j][0] * inv_lo, o[j][1] * inv_lo);
        }
        if (p_hi < n_rows) {
          *reinterpret_cast<uint32_t*>(out + row_of(p_hi) + c) =
              Tc<T>::pack(o[j][2] * inv_hi, o[j][3] * inv_hi);
        }
      }
    }
    return;
  }

  // Every block is done with its ring (the merged states go there) and
  // has started (the rule for distributed shared memory). Warps kw = 0
  // push their rows' state to the block that owns them: block b owns
  // rows [b rpo, (b + 1) rpo) of the tile and holds, for every split,
  // mm / ml [splits][rpo] and ma [splits][rpo][D]. A row with no visible
  // key pushes its max (-inf) alone. After a second barrier each block
  // merges its rows.
  cluster.sync();
  const int rpo = M / splits;  // rows a block merges (splits <= 4 < M)
  const int per = rpo * D;
  float* mm = reinterpret_cast<float*>(ring);
  float* ml = mm + M;
  float* ma = ml + M;
  if (kw == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw * 16 + g + 8 * h;
      const int owner = r / rpo;
      const int rl = r - owner * rpo;
      const float m = h ? m_hi : m_lo;
      if (t4 == 0) {
        *cluster.map_shared_rank(mm + rank * rpo + rl, owner) = m;
        *cluster.map_shared_rank(ml + rank * rpo + rl, owner) =
            h ? l_hi : l_lo;
      }
      if (m != -INFINITY) {
        float* dst = cluster.map_shared_rank(
            ma + rank * per + rl * D + 2 * t4, owner);
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          *reinterpret_cast<float2*>(dst + j * 8) =
              make_float2(o[j][2 * h], o[j][2 * h + 1]);
        }
      }
    }
  }
  cluster.sync();
  for (int e = 2 * threadIdx.x; e < per; e += 2 * C::kThreads) {
    const int rl = e / D;
    const int c = e - rl * D;
    float mx = -INFINITY;
    for (int x = 0; x < splits; ++x) mx = fmaxf(mx, mm[x * rpo + rl]);
    float l = 0.f, a0 = 0.f, a1 = 0.f;
    for (int x = 0; x < splits; ++x) {
      const float mp = mm[x * rpo + rl];
      if (mp == -INFINITY) continue;  // nothing pushed: weighs nothing
      const float w = expf(mp - mx);
      const float2 a = *reinterpret_cast<const float2*>(ma + x * per + e);
      l += w * ml[x * rpo + rl];
      a0 += w * a.x;
      a1 += w * a.y;
    }
    const int p = p0 + rank * rpo + rl;
    if (p < n_rows) {
      const float inv = l == 0.f ? 0.f : 1.f / l;
      *reinterpret_cast<uint32_t*>(out + row_of(p) + c) =
          Tc<T>::pack(a0 * inv, a1 * inv);
    }
  }
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* table;
  const int* cache_len;
  const int* length;
  void* out;
  int slots, s, heads, kv_heads, n_pages, page_size, pages_per_seq;
  float scale;
};

// the ring design and the f32 kernel: grid (ceil(S / 64), heads, slots)
template <typename T, typename P, typename Kernel>
int launch(Kernel kernel, size_t smem, int threads, const Args& a,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.s + kBQ - 1) / kBQ, a.heads, a.slots);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k_pages),
      static_cast<const P*>(a.v_pages), a.k_scales, a.v_scales, a.table,
      a.cache_len, a.length, static_cast<T*>(a.out), a.s, a.heads,
      a.kv_heads, a.n_pages, a.page_size, a.pages_per_seq, a.scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_tc(const Args& a, int quant, cudaStream_t stream) {
  if (quant) {
    return launch<T, int8_t>(paged_prefill_tc_kernel<D, T, int8_t>,
                             tc_smem_bytes<D, T, int8_t>(a.pages_per_seq),
                             kTcThreads, a, stream);
  }
  return launch<T, T>(paged_prefill_tc_kernel<D, T, T>,
                      tc_smem_bytes<D, T, T>(a.pages_per_seq), kTcThreads, a,
                      stream);
}

template <int D>
int launch_d(const Args& a, int dtype, int quant, cudaStream_t stream) {
  if (dtype == 0) {
    if (quant) {
      return launch<float, int8_t>(paged_prefill_fma_kernel<D, int8_t>,
                                   fma_smem_bytes<D>(), kThreads, a, stream);
    }
    return launch<float, float>(paged_prefill_fma_kernel<D, float>,
                                fma_smem_bytes<D>(), kThreads, a, stream);
  }
  if (dtype == 1) return launch_tc<D, __nv_bfloat16>(a, quant, stream);
  return launch_tc<D, __half>(a, quant, stream);
}

// The split design's tensor maps: pages [kv_heads, n_pages, page_size, d]
// as 4-d maps, a box of (64 columns, min(page_size, 64) rows) of one page
// of one kv head (16-bit: 128-byte swizzle; int8: d columns, raw), scales
// [kv_heads, n_pages, page_size] as a 3-d map of the same rows
template <int D, typename T, typename P>
int split_maps(const Args& a, CUtensorMap* km, CUtensorMap* vm,
               CUtensorMap* ksm, CUtensorMap* vsm) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  const cuuint32_t rows = (cuuint32_t)(a.page_size < kKeyTile ? a.page_size
                                                              : kKeyTile);
  const cuuint64_t e = kQuant ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)a.page_size,
                              (cuuint64_t)a.n_pages,
                              (cuuint64_t)a.kv_heads};
  const cuuint64_t strides[3] = {D * e, (cuuint64_t)a.page_size * D * e,
                                 (cuuint64_t)a.n_pages * a.page_size * D * e};
  if constexpr (kQuant) {
    const cuuint32_t box[4] = {(cuuint32_t)D, rows, 1, 1};
    int err = hopper::encode_map(km, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                                 CU_TENSOR_MAP_SWIZZLE_NONE, a.k_pages, 4,
                                 dims, strides, box);
    if (err) return err;
    err = hopper::encode_map(vm, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                             CU_TENSOR_MAP_SWIZZLE_NONE, a.v_pages, 4, dims,
                             strides, box);
    if (err) return err;
    const cuuint64_t sdims[3] = {(cuuint64_t)a.page_size,
                                 (cuuint64_t)a.n_pages,
                                 (cuuint64_t)a.kv_heads};
    const cuuint64_t sstrides[2] = {(cuuint64_t)a.page_size * 4,
                                    (cuuint64_t)a.n_pages * a.page_size * 4};
    const cuuint32_t sbox[3] = {rows, 1, 1};
    err = hopper::encode_map(ksm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                             CU_TENSOR_MAP_SWIZZLE_NONE, a.k_scales, 3, sdims,
                             sstrides, sbox);
    if (err) return err;
    return hopper::encode_map(vsm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                              CU_TENSOR_MAP_SWIZZLE_NONE, a.v_scales, 3,
                              sdims, sstrides, sbox);
  } else {
    const cuuint32_t box[4] = {64, rows, 1, 1};
    int err = hopper::encode_16bit_map<T>(km, a.k_pages, 4, dims, strides,
                                          box);
    if (err) return err;
    *ksm = CUtensorMap{};
    *vsm = CUtensorMap{};
    return hopper::encode_16bit_map<T>(vm, a.v_pages, 4, dims, strides, box);
  }
}

template <int D, typename T, typename P, int RW>
int launch_split_rw(const Args& a, int splits, int stages,
                    cudaStream_t stream) {
  using C = SplitCfg<D, P, RW>;
  CUtensorMap km, vm, ksm, vsm;
  int err = split_maps<D, T, P>(a, &km, &vm, &ksm, &vsm);
  if (err) return err;
  auto kernel = paged_prefill_split_kernel<D, T, P, RW>;
  const int smem = C::bytes(stages, a.pages_per_seq);
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const int group = a.heads / a.kv_heads;
  const long long row_tiles =
      ((long long)a.s * group + C::kRows - 1) / C::kRows;
  if (row_tiles * a.kv_heads > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (unsigned)(row_tiles * a.kv_heads), a.slots);
  cfg.blockDim = dim3(C::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one split: a plain launch
  cerr = cudaLaunchKernelEx(
      &cfg, kernel, km, vm, ksm, vsm, static_cast<const T*>(a.q), a.table,
      a.cache_len, a.length, static_cast<T*>(a.out), a.s, a.heads,
      a.kv_heads, a.page_size, a.pages_per_seq, a.scale, (int)row_tiles,
      stages);
  if (cerr != cudaSuccess) return (int)cerr;
  return (int)cudaGetLastError();
}

// Blocks of the split kernel the card holds at once, or a negative CUDA
// error: with one split, blocks an SM x SMs; with clusters, the clusters
// of `splits` blocks the card places at once x splits (a cluster's blocks
// must share a GPC, so this can be less than the blocks an SM holds
// suggest).
template <int D, typename T, typename P, int RW>
int split_occupancy_rw(int stages, int pages_per_seq, int splits) {
  using C = SplitCfg<D, P, RW>;
  auto kernel = paged_prefill_split_kernel<D, T, P, RW>;
  const int smem = C::bytes(stages, pages_per_seq);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess && splits == 1) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        C::kThreads, smem);
    n *= hopper::sm_count();
  } else if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, 1, 1);
    cfg.blockDim = dim3(C::kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    n *= splits;
  }
  return err == cudaSuccess ? n : -(int)err;
}

// rows (16, 32 or 64) to the kernel instance's RW (16-row groups); with
// `a` the launch, without it the occupancy query at (stages, pps,
// splits), by D, q's type and the page type
template <int D, typename T, typename P>
int split_by_rows(const Args* a, int rows, int splits, int stages, int pps,
                  cudaStream_t stream) {
  switch (rows) {
    case 16:
      return a ? launch_split_rw<D, T, P, 1>(*a, splits, stages, stream)
               : split_occupancy_rw<D, T, P, 1>(stages, pps, splits);
    case 32:
      return a ? launch_split_rw<D, T, P, 2>(*a, splits, stages, stream)
               : split_occupancy_rw<D, T, P, 2>(stages, pps, splits);
    case 64:
      return a ? launch_split_rw<D, T, P, 4>(*a, splits, stages, stream)
               : split_occupancy_rw<D, T, P, 4>(stages, pps, splits);
    default:
      return a ? (int)cudaErrorInvalidValue : -(int)cudaErrorInvalidValue;
  }
}

template <int D>
int split_d(const Args* a, int dtype, int quant, int rows, int splits,
            int stages, int pps, cudaStream_t stream) {
  if (dtype == 1) {
    return quant ? split_by_rows<D, __nv_bfloat16, int8_t>(
                       a, rows, splits, stages, pps, stream)
                 : split_by_rows<D, __nv_bfloat16, __nv_bfloat16>(
                       a, rows, splits, stages, pps, stream);
  }
  return quant ? split_by_rows<D, __half, int8_t>(a, rows, splits, stages,
                                                  pps, stream)
               : split_by_rows<D, __half, __half>(a, rows, splits, stages,
                                                  pps, stream);
}

// the split design takes this shape (its 16-bit q, head dims, page sizes)
bool split_takes(int dtype, int d, int page_size) {
  return (dtype == 1 || dtype == 2) && (d == 64 || d == 128) &&
         page_size % 8 == 0 &&
         (kKeyTile % page_size == 0 || page_size % kKeyTile == 0);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and out; float pages
// share it). quant: int8 pages with f32 scales (k_scales, v_scales), else
// both null. table is [slots, pages_per_seq]; cache_len and length point
// to int32 [slots] on the device. d: 16, 32, 64, 128 or 256. q, out and
// 16-bit pages start on a 16-byte boundary (the wrapper copies q if
// not). design: 0 = ring (f32 q: the FMA kernel, whichever design), 1 =
// split, with `rows` packed query rows a block (16, 32 or 64), `splits`
// blocks a cluster (1, 2 or 4) and `stages` ring stages (1 to 6; rows,
// splits and stages unread by the ring design); pages and scales
// 16-byte aligned.
int paged_prefill_launch(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scales,
                         const void* v_scales, const void* table,
                         const void* cache_len, const void* length, void* out,
                         int slots, int s, int heads, int kv_heads,
                         int n_pages, int page_size, int pages_per_seq, int d,
                         float scale, int dtype, int quant, int design,
                         int rows, int splits, int stages, void* stream) {
  if (slots == 0 || s == 0 || heads == 0) return 0;
  if (dtype < 0 || dtype > 2 || kv_heads < 1 || heads % kv_heads ||
      page_size < 1 || pages_per_seq < 1 || slots < 0 || slots > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (quant && (k_scales == nullptr || v_scales == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q,
               k_pages,
               v_pages,
               static_cast<const float*>(quant ? k_scales : nullptr),
               static_cast<const float*>(quant ? v_scales : nullptr),
               static_cast<const int*>(table),
               static_cast<const int*>(cache_len),
               static_cast<const int*>(length),
               out,
               slots,
               s,
               heads,
               kv_heads,
               n_pages,
               page_size,
               pages_per_seq,
               scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design == 1 && dtype != 0) {
    if (!split_takes(dtype, d, page_size) || splits < 1 ||
        splits > kMaxSplits || (splits & (splits - 1)) || stages < 1 ||
        stages > kMaxStages ||
        (uintptr_t)k_pages % 16 || (uintptr_t)v_pages % 16 ||
        (quant && ((uintptr_t)k_scales % 16 || (uintptr_t)v_scales % 16))) {
      return (int)cudaErrorInvalidValue;
    }
    return d == 64
               ? split_d<64>(&a, dtype, quant, rows, splits, stages, 0, st)
               : split_d<128>(&a, dtype, quant, rows, splits, stages, 0, st);
  }
  if (design != 0 && design != 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch_d<16>(a, dtype, quant, st);
    case 32:
      return launch_d<32>(a, dtype, quant, st);
    case 64:
      return launch_d<64>(a, dtype, quant, st);
    case 128:
      return launch_d<128>(a, dtype, quant, st);
    case 256:
      return launch_d<256>(a, dtype, quant, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the split design's kernel for (d, dtype, quant, rows,
// stages, pages_per_seq) that the card holds at once in clusters of
// `splits` (the wrapper sizes the splits and the ring by it), or a
// negative CUDA error (-cudaErrorInvalidValue where the split design does
// not take the shape).
int paged_prefill_split_occupancy(int d, int dtype, int quant, int rows,
                                  int stages, int pages_per_seq,
                                  int splits) {
  if (!split_takes(dtype, d, 8) || pages_per_seq < 1 || stages < 1 ||
      stages > kMaxStages || splits < 1 || splits > kMaxSplits) {
    return -(int)cudaErrorInvalidValue;
  }
  return d == 64 ? split_d<64>(nullptr, dtype, quant, rows, splits, stages,
                               pages_per_seq, nullptr)
                 : split_d<128>(nullptr, dtype, quant, rows, splits, stages,
                                pages_per_seq, nullptr);
}

}  // extern "C"
