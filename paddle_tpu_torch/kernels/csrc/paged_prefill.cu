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
// int32 [slots] in DEVICE memory. The grid is fixed by S, the heads and
// the slots alone: each block reads its slot's cache_len and length
// itself and walks the 64-key tiles from absolute position 0 up to
// cache_len + min(its last query row + 1, length), so a CUDA graph
// captured once replays any chunk or window at any offsets. Rows t >=
// length are finite (they see the keys below that end; a tile with no
// row below length writes zeros, so an inactive slot, length 0, writes
// zeros and reads nothing) and are never read. A table entry outside
// [0, n_pages) reads as a zero row.
//
// What bounds it on an H100: at the serving shape (16 heads, d 128, a
// 128-token bf16 chunk after 192 cached tokens) it moves ~3.6 MB (q, out
// and 320 K/V rows) and does ~0.27 GFLOP: ~1 us either way. At serving
// shapes it is bound by its launch and latency; each K/V row is read
// once per (query tile, head), from L2 after the first. A verify step of
// the serving cell (8 slots, a 5-token window each over up to 512 cached
// tokens) has 128 blocks of one partly used query tile each: ~1 block an
// SM, each walking its slot's whole cache, so it is latency bound too.
//
// Design (a first, simple kernel; wgmma and TMA are later work): the
// flash forward's two non-wgmma kernels (flash_attention.cu) with the key
// tiles staged through the table.
//  * bf16 and float16 q (variant tc): one block of 4 warps per (64-row
//    query tile, head); mma.sync m16n8k16 (16-bit in, f32 accumulate),
//    the online softmax on the accumulators in registers, P fed back as
//    the A operand of P V in q's dtype. The block table's entries sit in
//    shared memory; for each key tile the block resolves its 64 rows'
//    page offsets there, then copies the rows with cp.async (16-bit rows
//    16 bytes a copy into the padded tiles; int8 rows raw, 8 bytes a
//    copy, and their scales, converted to q's dtype once landed) into a
//    two-slot ring: tile k + 1 is in flight while tile k is multiplied. (The first
//    version staged each row with plain loads, one tile at a time; its
//    loads waited on each other, ~13 us a tile at the serving shape.)
//  * f32 q (variant fma): exact f32 FMAs from shared memory, 256 threads,
//    each owning a 4 x 4 block of the score tile and a 4 x (d / 16) block
//    of the output, as the flash FMA kernel; float rows are copied with
//    cp.async, all of a tile's copies in flight at once; int8 rows
//    dequantize in f32 as the plain version does.
// Launch contract: grid (ceil(S / 64), heads, slots); each block offsets
// q, out and the table by its slot (blockIdx.z) and loads its own table
// entries, so a block of an inactive slot skips nothing another needs.
// The launch function sets
// the dynamic shared memory, launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q and out; float pages
// share it). quant: int8 pages with f32 scales (k_scales, v_scales), else
// both null. table is [slots, pages_per_seq]; cache_len and length point
// to int32 [slots] on the device. d: 16, 32, 64, 128 or 256. q, out and
// 16-bit pages start on a 16-byte boundary (the wrapper copies q if
// not).
int paged_prefill_launch(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scales,
                         const void* v_scales, const void* table,
                         const void* cache_len, const void* length, void* out,
                         int slots, int s, int heads, int kv_heads,
                         int n_pages, int page_size, int pages_per_seq, int d,
                         float scale, int dtype, int quant, void* stream) {
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

}  // extern "C"
