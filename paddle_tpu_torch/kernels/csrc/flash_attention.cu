// Flash attention forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py:_flash_fwd
//           (kernel body _fwd_kernel).
//
// Computes, per batch b, query head h and query row i,
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, kvh] * scale) v[b, j, kvh]
//   lse[b, h, i] = logsumexp_j(q[b, i, h] . k[b, j, kvh] * scale)
// with kvh = h / (heads / kv_heads) (GQA read in place, no repeated K/V),
// over all keys j < sk, or over j <= i when causal (top-left aligned, the
// TPU kernel's mask; callers send causal work here only when sq == sk).
// Layout: q/out [b, sq, heads, d], k/v [b, sk, kv_heads, d], contiguous;
// lse [b, heads, sq] float32. Unlike the TPU kernel, sq and sk need not
// be multiples of the tile: ragged tails are masked.
//
// What bounds it on an H100: at the serving shapes (prompts of tens to a
// few hundred tokens, d = 128) the work is small and the kernel is bound
// by launch and latency; at long sequences it is bound by operations.
// What the design does about bytes: every element of q, k and v is read
// from device memory once per (query tile, key tile) pair, and the s x s
// score matrix never leaves the SM. Causal tiles above the diagonal are
// skipped. Two kernels, chosen by dtype:
//
//  * bf16 (flash_fwd_tc_kernel): the products run on the tensor cores
//    (mma.sync m16n8k16, bf16 in, f32 accumulate), the online softmax
//    stays in registers, and P goes to the P V product as bf16 straight
//    from the score accumulators. Not yet the Hopper-only wgmma/TMA
//    pipeline, so it stays below the card's bf16 peak. It stages rows
//    with 16-byte loads, so q, k and v must start on a 16-byte boundary
//    (the Python wrapper copies any that do not).
//  * f32 (flash_fwd_kernel): exact f32 FMAs from shared memory, for the
//    f32 path whose outputs must match the plain version to f32 rounding.
//    One block of 256 threads per (b * heads, 64-row query tile) stages Q
//    once, then walks 64-key tiles of K and V with an f32 online softmax
//    (running max, sum, accumulator). Each thread owns a 4 x 4 block of
//    the score tile and a 4 x (d / 16) block of the output accumulator,
//    in registers; Q and K rows are padded by one float in shared memory
//    so the score loop reads them without bank conflicts.
//
// Launch contract: grid (ceil(sq / 64), b * heads); the launch function
// sets each kernel's dynamic shared memory, returns cudaGetLastError()
// (0 on success) and launches on the given stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid over the 64 x 64 tile
constexpr int kSP = kBK + 1;   // padded score row

constexpr size_t smem_floats(int d) {
  return 2 * (size_t)kBQ * (d + 1)   // q_s, k_s (padded rows)
         + (size_t)kBK * d           // v_s
         + (size_t)kBQ * kSP         // s_s
         + 3 * (size_t)kBQ;          // m_s, l_s, a_s
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse,
    int heads, int kv_heads, int sq, int sk, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;              // [kBQ][DP]
  float* k_s = q_s + kBQ * DP;    // [kBK][DP]
  float* v_s = k_s + kBK * DP;    // [kBK][D]
  float* s_s = v_s + kBK * D;     // [kBQ][kSP]
  float* m_s = s_s + kBQ * kSP;   // [kBQ]
  float* l_s = m_s + kBQ;         // [kBQ]
  float* a_s = l_s + kBQ;         // [kBQ]

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int bi = bh / heads;
  const int hh = bh - bi * heads;
  const int kvh = hh / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const size_t q_row = (size_t)heads * D;
  const size_t kv_row = (size_t)kv_heads * D;
  const float* q_b = q + (size_t)bi * sq * q_row + (size_t)hh * D;
  const float* k_b = k + (size_t)bi * sk * kv_row + (size_t)kvh * D;
  const float* v_b = v + (size_t)bi * sk * kv_row + (size_t)kvh * D;

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

  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const int col = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (col < sk) {
        kv = k_b[(size_t)col * kv_row + c];
        vv = v_b[(size_t)col * kv_row + c];
      }
      k_s[r * DP + c] = kv;
      v_s[r * D + c] = vv;
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
        const bool keep = col < sk && (!causal || col <= q0 + r);
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

  float* o_b = out + (size_t)bi * sq * q_row + (size_t)hh * D;
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
  for (int r = tid; r < kBQ; r += kThreads) {
    const int row = q0 + r;
    if (row < sq) {
      const float l = l_s[r];
      lse[(size_t)bh * sq + row] = m_s[r] + logf(l == 0.f ? 1.f : l);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores. One block of 4 warps per (b * heads, 64-row
// query tile); warp w owns query rows 16 w .. 16 w + 15. Q, K and V tiles
// sit in shared memory as bf16 (rows padded by 8 elements, so the
// fragment loads below hit 32 distinct banks). Per 64-key tile each warp
// computes its 16 x 64 scores with mma.sync.m16n8k16 (bf16 in, f32
// accumulate), runs the online softmax on the accumulators in registers
// (a row's values live in the 4 lanes of a quad), and feeds the
// probabilities, rounded to bf16, straight back as the A operand of the
// P V product. Fragment layouts are the PTX ISA's for m16n8k16:
//   A (16x16): reg0 = A[g][2t..2t+1], reg1 = A[g+8][2t..], reg2 =
//              A[g][2t+8..], reg3 = A[g+8][2t+8..]
//   B (16x8):  reg0 = B[2t..2t+1][g], reg1 = B[2t+8..2t+9][g]
//   C (16x8):  c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// with g = lane / 4 and t = lane % 4; the lower half of a register holds
// the lower column (or k) index.

constexpr int kTcThreads = 128;

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0,
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pair2(const __nv_bfloat16* lo,
                                          const __nv_bfloat16* hi) {
  __nv_bfloat162 h;
  h.x = *lo;
  h.y = *hi;
  return *reinterpret_cast<uint32_t*>(&h);
}

constexpr size_t tc_smem_bytes(int d) {
  return 3 * (size_t)kBQ * (d + 8) * sizeof(__nv_bfloat16);
}

// rows [r0, r0 + 64) of a [rows, stride] bf16 matrix into shared memory
// [64][d + 8], 16 bytes per load; rows at or past n_rows are zeros
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t stride, int r0,
                                           int n_rows) {
  constexpr int V = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kBQ * V; i += kTcThreads) {
    const int r = i / V;
    const int c = (i - r * V) * 8;
    uint4 w = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows) {
      w = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride +
                                          c);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = w;
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int heads, int kv_heads, int sq, int sk,
    float scale, int causal) {
  constexpr int S = D + 8;    // padded smem row, bf16 elements
  constexpr int DT = D / 8;   // 8-wide output column tiles per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBQ * S;
  __nv_bfloat16* v_s = k_s + kBK * S;

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int bi = bh / heads;
  const int hh = bh - bi * heads;
  const int kvh = hh / (heads / kv_heads);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t q_row = (size_t)heads * D;
  const size_t kv_row = (size_t)kv_heads * D;
  const __nv_bfloat16* q_b = q + (size_t)bi * sq * q_row + (size_t)hh * D;
  const __nv_bfloat16* k_b = k + (size_t)bi * sk * kv_row + (size_t)kvh * D;
  const __nv_bfloat16* v_b = v + (size_t)bi * sk * kv_row + (size_t)kvh * D;

  stage_rows<D>(q_s, q_b, q_row, q0, sq);

  const int r_lo = q0 + warp * 16 + g;  // this lane's two query rows
  const int r_hi = r_lo + 8;
  const __nv_bfloat16* qa = q_s + (warp * 16 + g) * S + 2 * t;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D>(k_s, k_b, kv_row, k0, sk);
    stage_rows<D>(v_s, v_b, kv_row, k0, sk);
    __syncthreads();

    // scores: 16 rows x 64 keys = 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const uint32_t a0 = pair(qa + kk);
      const uint32_t a1 = pair(qa + 8 * S + kk);
      const uint32_t a2 = pair(qa + kk + 8);
      const uint32_t a3 = pair(qa + 8 * S + kk + 8);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kb = k_s + (n * 8 + g) * S + kk + 2 * t;
        mma_bf16(s[n], a0, a1, a2, a3, pair(kb), pair(kb + 8));
      }
    }

    // mask, then the online softmax on the accumulators
    float mt_lo = -INFINITY, mt_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + n * 8 + 2 * t + e;
        const bool ok = col < sk;
        s[n][e] = ok && (!causal || col <= r_lo) ? s[n][e] * scale
                                                 : -INFINITY;
        s[n][2 + e] = ok && (!causal || col <= r_hi) ? s[n][2 + e] * scale
                                                     : -INFINITY;
        mt_lo = fmaxf(mt_lo, s[n][e]);
        mt_hi = fmaxf(mt_hi, s[n][2 + e]);
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
        s[n][e] = expf(s[n][e] - base_lo);
        s[n][2 + e] = expf(s[n][2 + e] - base_hi);
        ps_lo += s[n][e];
        ps_hi += s[n][2 + e];
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
      const uint32_t a0 = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      const uint32_t a1 = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      const uint32_t a2 = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const __nv_bfloat16* vb = v_s + (ks * 16 + 2 * t) * S + g;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const __nv_bfloat16* vj = vb + j * 8;
        mma_bf16(o[j], a0, a1, a2, a3, pair2(vj, vj + S),
                 pair2(vj + 8 * S, vj + 9 * S));
      }
    }
  }

  __nv_bfloat16* o_b = out + (size_t)bi * sq * q_row + (size_t)hh * D;
  const float inv_lo = l_lo == 0.f ? 0.f : 1.f / l_lo;
  const float inv_hi = l_hi == 0.f ? 0.f : 1.f / l_hi;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = j * 8 + 2 * t;
    if (r_lo < sq) {
      *reinterpret_cast<__nv_bfloat162*>(o_b + (size_t)r_lo * q_row + c) =
          __floats2bfloat162_rn(o[j][0] * inv_lo, o[j][1] * inv_lo);
    }
    if (r_hi < sq) {
      *reinterpret_cast<__nv_bfloat162*>(o_b + (size_t)r_hi * q_row + c) =
          __floats2bfloat162_rn(o[j][2] * inv_hi, o[j][3] * inv_hi);
    }
  }
  if (t == 0) {
    if (r_lo < sq) {
      lse[(size_t)bh * sq + r_lo] = m_lo + logf(l_lo == 0.f ? 1.f : l_lo);
    }
    if (r_hi < sq) {
      lse[(size_t)bh * sq + r_hi] = m_hi + logf(l_hi == 0.f ? 1.f : l_hi);
    }
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out,
             float* lse, int batch, int heads, int kv_heads, int sq, int sk,
             float scale, int causal, int dtype, cudaStream_t stream) {
  dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  if (dtype == 0) {
    auto kernel = flash_fwd_kernel<D>;
    const size_t smem = smem_floats(D) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, heads,
        kv_heads, sq, sk, scale, causal);
  } else {
    auto kernel = flash_fwd_tc_kernel<D>;
    const size_t smem = tc_smem_bytes(D);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kTcThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), lse, heads, kv_heads, sq, sk, scale,
        causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). bf16 q, k
// and v must start on a 16-byte boundary (the caller copies them if not).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, void* lse, int batch, int heads,
                               int kv_heads, int sq, int sk, int d,
                               float scale, int causal, int dtype,
                               void* stream) {
  if (batch == 0 || sq == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (d) {
    case 16:
      return launch_d<16>(q, k, v, out, lse_f, batch, heads, kv_heads, sq,
                          sk, scale, causal, dtype, s);
    case 32:
      return launch_d<32>(q, k, v, out, lse_f, batch, heads, kv_heads, sq,
                          sk, scale, causal, dtype, s);
    case 64:
      return launch_d<64>(q, k, v, out, lse_f, batch, heads, kv_heads, sq,
                          sk, scale, causal, dtype, s);
    case 128:
      return launch_d<128>(q, k, v, out, lse_f, batch, heads, kv_heads, sq,
                          sk, scale, causal, dtype, s);
    case 256:
      return launch_d<256>(q, k, v, out, lse_f, batch, heads, kv_heads, sq,
                          sk, scale, causal, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
