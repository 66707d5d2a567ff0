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
// What bounds it on an H100: at the training shape (b 12, h 16, d 128,
// s 1024, causal) the two are close: ~0.2 GB of q, k, v, out and lse take
// 0.060 ms at 3.35 TB/s, 51.6 GFLOP 0.052 ms at 989 TFLOP/s. At the serving
// shapes (prompts of tens to a few hundred tokens) the work is small and
// the kernel is bound by launch and latency. Every element of q, k and v
// is read once per (query tile, key tile) pair, from L2 where the block
// order keeps it there, and the s x s score matrix never leaves the SM.
// Causal tiles above the diagonal are skipped. Four kernels, chosen by
// the wrapper (flash_attention.py:_fwd_variant) and passed as `variant`:
//
//  * 16-bit, d 64 or 128 (flash_fwd_wgmma_kernel, variant 1): the Hopper
//    design, TMA loads into an mbarrier ring, a producer thread and two
//    consumer warpgroups on wgmma. Described at the kernel.
//  * 16-bit, other head dims (flash_fwd_tc_kernel, variant 0): mma.sync
//    m16n8k16 (16-bit in, f32 accumulate), the online softmax in
//    registers, P fed to the P V product as 16-bit straight from the score
//    accumulators; K and V staged synchronously. It stages rows with
//    16-byte loads, so q, k and v must start on a 16-byte boundary (the
//    Python wrapper copies any that do not; TMA needs the same).
//  * f32, d 64 or 128 (flash_fwd_tf32_kernel, variant 2): 3xTF32 on the
//    tensor cores (mma.sync m16n8k8 .tf32, every f32 operand split into a
//    TF32 high and low part, three products), K and V by cp.async into a
//    two-stage ring. Described at the kernel.
//  * f32, other head dims and sk == 0 (flash_fwd_kernel, variant 0):
//    exact f32 FMAs from shared memory,
//    for the f32 path whose outputs must match the plain version to f32
//    rounding. One block of 256 threads per (b * heads, 64-row query
//    tile) stages Q once, then walks 64-key tiles of K and V with an f32
//    online softmax (running max, sum, accumulator). Each thread owns a
//    4 x 4 block of the score tile and a 4 x (d / 16) block of the output
//    accumulator, in registers; Q and K rows are padded by one float in
//    shared memory so the score loop reads them without bank conflicts.
//
// "16-bit" is bf16 or float16: each 16-bit kernel is a template on its
// element type T (__nv_bfloat16 or __half), which picks the PTX operand
// type of mma.sync and wgmma (.bf16 or .f16), the f32 -> 16-bit packing
// of P and of the output (hopper::pack2 / store2: __floats2bfloat162_rn or
// __floats2half2_rn) and the TMA element type; the design is the same.
// In float16, P (in [0, 1]) keeps 3 more mantissa bits than in bf16; q, k
// and v must lie within float16's range, as any float16 tensor does.
//
// Launch contract: variants 0 and 2 launch a grid (ceil(sq / 64),
// b * heads), variant 1 one block per (128-row query tile, batch x head);
// the launch
// function sets each kernel's dynamic shared memory, returns
// cudaGetLastError() (0 on success) and launches on the given stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tf32x3.cuh"

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
// 16-bit (bf16 or f16, T) on the tensor cores. One block of 4 warps per
// (b * heads, 64-row query tile); warp w owns query rows 16 w .. 16 w +
// 15. Q, K and V tiles sit in shared memory as T (rows padded by 8 elements, so the
// fragment loads below hit 32 distinct banks). Per 64-key tile each warp
// computes its 16 x 64 scores with mma.sync.m16n8k16 (T in, f32
// accumulate), runs the online softmax on the accumulators in registers
// (a row's values live in the 4 lanes of a quad), and feeds the
// probabilities, rounded to T, straight back as the A operand of the
// P V product. Fragment layouts are the PTX ISA's for m16n8k16:
//   A (16x16): reg0 = A[g][2t..2t+1], reg1 = A[g+8][2t..], reg2 =
//              A[g][2t+8..], reg3 = A[g+8][2t+8..]
//   B (16x8):  reg0 = B[2t..2t+1][g], reg1 = B[2t+8..2t+9][g]
//   C (16x8):  c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// with g = lane / 4 and t = lane % 4; the lower half of a register holds
// the lower column (or k) index.

constexpr int kTcThreads = 128;

__device__ __forceinline__ uint32_t pair(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

constexpr size_t tc_smem_bytes(int d) {
  return 3 * (size_t)kBQ * (d + 8) * 2;
}

// rows [r0, r0 + 64) of a [rows, stride] 16-bit matrix into shared memory
// [64][d + 8], 16 bytes per load; rows at or past n_rows are zeros
template <int D, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
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

template <int D, typename T>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out,
    float* __restrict__ lse, int heads, int kv_heads, int sq, int sk,
    float scale, int causal) {
  constexpr int S = D + 8;    // padded smem row, 16-bit elements
  constexpr int DT = D / 8;   // 8-wide output column tiles per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + kBQ * S;
  T* v_s = k_s + kBK * S;

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
  const T* q_b = q + (size_t)bi * sq * q_row + (size_t)hh * D;
  const T* k_b = k + (size_t)bi * sk * kv_row + (size_t)kvh * D;
  const T* v_b = v + (size_t)bi * sk * kv_row + (size_t)kvh * D;

  stage_rows<D, T>(q_s, q_b, q_row, q0, sq);

  const int r_lo = q0 + warp * 16 + g;  // this lane's two query rows
  const int r_hi = r_lo + 8;
  const T* qa = q_s + (warp * 16 + g) * S + 2 * t;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D, T>(k_s, k_b, kv_row, k0, sk);
    stage_rows<D, T>(v_s, v_b, kv_row, k0, sk);
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
        const T* kb = k_s + (n * 8 + g) * S + kk + 2 * t;
        hopper::mma16816<T>(s[n], a0, a1, a2, a3, pair(kb), pair(kb + 8));
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
      const uint32_t a0 = hopper::pack2<T>(s[2 * ks][0], s[2 * ks][1]);
      const uint32_t a1 = hopper::pack2<T>(s[2 * ks][2], s[2 * ks][3]);
      const uint32_t a2 =
          hopper::pack2<T>(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      const uint32_t a3 =
          hopper::pack2<T>(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const T* vb = v_s + (ks * 16 + 2 * t) * S + g;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const T* vj = vb + j * 8;
        hopper::mma16816<T>(o[j], a0, a1, a2, a3,
                            hopper::pair2(vj, vj + S),
                 hopper::pair2(vj + 8 * S, vj + 9 * S));
      }
    }
  }

  T* o_b = out + (size_t)bi * sq * q_row + (size_t)hh * D;
  const float inv_lo = l_lo == 0.f ? 0.f : 1.f / l_lo;
  const float inv_hi = l_hi == 0.f ? 0.f : 1.f / l_hi;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = j * 8 + 2 * t;
    if (r_lo < sq) {
      hopper::store2(o_b + (size_t)r_lo * q_row + c, o[j][0] * inv_lo,
                     o[j][1] * inv_lo);
    }
    if (r_hi < sq) {
      hopper::store2(o_b + (size_t)r_hi * q_row + c, o[j][2] * inv_hi,
                     o[j][3] * inv_hi);
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

// ---------------------------------------------------------------------------
// 16-bit (bf16 or f16, T) on Hopper, d in {64, 128}: wgmma fed by TMA
// through an mbarrier ring (hopper.cuh).
//
// Block: 128 query rows of one (batch, head), 3 warpgroups. Warpgroups 0
// and 1 are consumers, each owning 64 of the rows; one thread of
// warpgroup 2 is the producer. It loads the Q tile once (4-D tensor map
// over (d, heads, seq, batch) of the [b, s, h, d] layout, a box of 128
// rows by 64 of d, two boxes at d = 128: a box never crosses a batch, and
// rows past sq read as zeros), then streams K and V tiles of 128 keys
// through a ring of kStages stages, K and V each with full/empty
// mbarriers, so the products of one tile overlap the loads of the next.
// Per key tile each consumer warpgroup runs
//   S = Q K^T      wgmma.m64n128k16, A = Q and B = K from shared memory,
//                  both K-major (d contiguous);
//   online softmax on the accumulator registers in base 2: the running
//                  max in raw score units, p = 2^(s scale log2e - m scale
//                  log2e) as one FMA and one ex2; the row sum kept per
//                  thread and reduced over the quad once, at the end;
//   O += P V       P rounded to T in registers, fed as wgmma's register
//                  A operand (two adjacent n8 column blocks of S are one
//                  k16 A fragment); B = V from shared memory, MN-major
//                  (d contiguous): the transpose bit.
// Only the diagonal tile (causal) and the ragged key tail are masked.
//
// Block order. The card hands blocks to SMs in index order as SMs free
// up, so the order decides both the balance and the reuse of K/V in L2.
// Blocks are grouped in chunks of `chunk` (batch, head) pairs, chosen by
// the launcher so that a chunk's K and V take ~8 MB (one chunk where all
// of K and V fit in L2 anyway); inside a chunk the
// last (heaviest causal) query tile of every head comes first, then the
// one before it, and so on. The long rows start first and the short ones
// fill the tail, while the K/V tiles being read belong to one or two
// chunks and stay in L2: ordered by query tile across all heads instead,
// every query-tile level streamed all of K and V from device memory again.
//
// lse is stored in natural log units, m scale + ln(l); a row with no
// visible key gives out 0 and lse -inf, as the mma.sync kernel and the
// plain version do.

constexpr int kHQ = 128;        // query rows per block
constexpr int kHK = 128;        // keys per K/V tile
constexpr int kHThreads = 384;  // consumer warpgroups 0, 1; producer 2

template <int D>
struct FwdCfg {
  static constexpr int kBoxes = D / 64;    // 64-wide boxes along d
  static constexpr int kStages = D == 128 ? 2 : 3;  // sweep: flash_stages
  static constexpr int kQBox = kHQ * 128;  // bytes of a [128 rows][64] box
  static constexpr int kKVBox = kHK * 128;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;  // one K (or V) tile
  static constexpr int kTiles = kQBytes + 2 * kStages * kKVBytes;
  // alignment slack, tiles, q_full + full/empty for K and for V
  static constexpr int kSmem = 1024 + kTiles + (1 + 4 * kStages) * 8;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, typename T>
__global__ void __launch_bounds__(kHThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    T* __restrict__ out, float* __restrict__ lse, int heads,
    int kv_heads, int sq, int sk, float scale, int causal, int n_bh,
    int chunk) {
  using C = FwdCfg<D>;
  extern __shared__ __align__(1024) unsigned char fa_smem[];
  unsigned char* q_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fa_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* k_s = q_s + C::kQBytes;
  unsigned char* v_s = k_s + C::kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s +
                                                 C::kStages * C::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + C::kStages;
  uint64_t* v_full = k_empty + C::kStages;
  uint64_t* v_empty = v_full + C::kStages;

  // this block's (batch x head, query tile): chunk c of `chunk` heads,
  // the heaviest query tile of each of its heads first
  const int n_qt = (sq + kHQ - 1) / kHQ;
  const int c = (int)(blockIdx.x / ((unsigned)chunk * n_qt));
  const int r = (int)(blockIdx.x - (unsigned)c * chunk * n_qt);
  const int in_chunk = min(chunk, n_bh - c * chunk);
  const int bh = c * chunk + r % in_chunk;
  const int q0 = (n_qt - 1 - r / in_chunk) * kHQ;
  const int bi = bh / heads;
  const int hh = bh - bi * heads;
  const int kvh = hh / (heads / kv_heads);
  const int k_end = causal ? min(sk, q0 + kHQ) : sk;
  const int n_kt = (k_end + kHK - 1) / kHK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&k_empty[s], 8);  // one arrival per consumer warp
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&v_empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int j = 0; j < C::kBoxes; ++j) {
        hopper::tma_load_4d(q_s + j * C::kQBox, &q_map, q_full, 64 * j, hh,
                            q0, bi);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        hopper::mbar_wait(&k_empty[stage], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&k_full[stage], C::kKVBytes);
        unsigned char* kb = k_s + stage * C::kKVBytes;
#pragma unroll
        for (int j = 0; j < C::kBoxes; ++j) {
          hopper::tma_load_4d(kb + j * C::kKVBox, &k_map, &k_full[stage],
                              64 * j, kvh, kt * kHK, bi);
        }
        hopper::mbar_wait(&v_empty[stage], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&v_full[stage], C::kKVBytes);
        unsigned char* vb = v_s + stage * C::kKVBytes;
#pragma unroll
        for (int j = 0; j < C::kBoxes; ++j) {
          hopper::tma_load_4d(vb + j * C::kKVBox, &v_map, &v_full[stage],
                              64 * j, kvh, kt * kHK, bi);
        }
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  hopper::setmaxnreg_inc<232>();
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float sl2 = scale * 1.4426950408889634f;  // scale log2(e)
  const int r_lo = q0 + wg * 64 + warp * 16 + (lane >> 2);  // this lane's
  const int r_hi = r_lo + 8;                                // two rows
  const unsigned char* q_wg = q_s + wg * 64 * 128;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  // S = Q K^T for the K tile in ring stage st, into s (not waited for)
  float s[kHK / 2];
  auto issue_s = [&](int st, uint32_t ph) {
    hopper::mbar_wait(&k_full[st], ph);
    const unsigned char* kb = k_s + st * C::kKVBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * C::kQBox + (kk & 3) * 32;
      const int koff = (kk >> 2) * C::kKVBox + (kk & 3) * 32;
      hopper::wgmma_ss<kHK, 0, T>(s, hopper::desc_k_major(q_wg + off),
                               hopper::desc_k_major(kb + koff), kk > 0);
    }
    hopper::wgmma_commit();
  };
  // O += P V for the V tile in ring stage st (not waited for)
  auto issue_pv = [&](int st, uint32_t ph, const uint32_t (&p)[kHK / 16][4]) {
    hopper::mbar_wait(&v_full[st], ph);
    const unsigned char* vb = v_s + st * C::kKVBytes;
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kHK / 16; ++ks) {
      hopper::wgmma_rs<D, 1, T>(o, p[ks],
                             hopper::desc_mn_major(vb + ks * 2048,
                                                   C::kKVBox),
                             1);
    }
    hopper::wgmma_commit();
  };
  // the online softmax of key tile kt on s, in base 2: P as 16-bit A
  // fragments into p, the running max and sum updated; returns the
  // factors (lo, hi rows) by which O must be rescaled
  auto softmax = [&](int kt, uint32_t (&p)[kHK / 16][4], float& al_lo,
                     float& al_hi) {
    const int k0 = kt * kHK;
    // mask the ragged key tail and the causal diagonal only
    if (k0 + kHK > sk || (causal && k0 + kHK - 1 > q0 + wg * 64)) {
#pragma unroll
      for (int j = 0; j < kHK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * (lane & 3) + e;
          if (col >= sk || (causal && col > r_lo)) s[4 * j + e] = -INFINITY;
          if (col >= sk || (causal && col > r_hi)) {
            s[4 * j + 2 + e] = -INFINITY;
          }
        }
      }
    }
    float mn_lo = m_lo, mn_hi = m_hi;
#pragma unroll
    for (int j = 0; j < kHK / 8; ++j) {
      mn_lo = fmaxf(mn_lo, fmaxf(s[4 * j], s[4 * j + 1]));
      mn_hi = fmaxf(mn_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mn_lo = fmaxf(mn_lo, __shfl_xor_sync(0xffffffffu, mn_lo, x));
      mn_hi = fmaxf(mn_hi, __shfl_xor_sync(0xffffffffu, mn_hi, x));
    }
    // a row with no visible key yet keeps p = 0; its old state is scaled
    // by 2^-inf = 0 until its first key
    const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo * sl2;
    const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi * sl2;
    al_lo = fast_exp2(m_lo * sl2 - base_lo);
    al_hi = fast_exp2(m_hi * sl2 - base_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int ks = 0; ks < kHK / 16; ++ks) {
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // elements 0, 1, 4, 5 are row lo; 2, 3, 6, 7 row hi
        x[e] = fast_exp2(fmaf(s[8 * ks + e], sl2,
                              (e & 2) ? -base_hi : -base_lo));
      }
      ps_lo += (x[0] + x[1]) + (x[4] + x[5]);
      ps_hi += (x[2] + x[3]) + (x[6] + x[7]);
      p[ks][0] = hopper::pack2<T>(x[0], x[1]);
      p[ks][1] = hopper::pack2<T>(x[2], x[3]);
      p[ks][2] = hopper::pack2<T>(x[4], x[5]);
      p[ks][3] = hopper::pack2<T>(x[6], x[7]);
    }
    l_lo = l_lo * al_lo + ps_lo;
    l_hi = l_hi * al_hi + ps_hi;
  };
  auto rescale_o = [&](float al_lo, float al_hi) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= al_lo;
      o[4 * j + 1] *= al_lo;
      o[4 * j + 2] *= al_hi;
      o[4 * j + 3] *= al_hi;
    }
  };

  hopper::mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  // the products of a tile wait for its softmax and the other way round;
  // the two consumer warpgroups (and the producer's next loads) overlap
  // one another. Overlapping the softmax of tile kt with S of tile kt + 1
  // inside a warpgroup would need a second score accumulator (64 more
  // registers a thread at d = 128) and P's registers held until P V
  // completes; it is not done here.
  for (int kt = 0; kt < n_kt; ++kt) {
    issue_s(stage, phase);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    if (lane == 0) hopper::mbar_arrive(&k_empty[stage]);
    uint32_t p[kHK / 16][4];
    float al_lo, al_hi;
    softmax(kt, p, al_lo, al_hi);
    rescale_o(al_lo, al_hi);
    issue_pv(stage, phase, p);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (lane == 0) hopper::mbar_arrive(&v_empty[stage]);
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
  }
  const size_t row_stride = (size_t)heads * D;
  T* o_b = out + (size_t)bi * sq * row_stride + (size_t)hh * D;
  const float inv_lo = l_lo == 0.f ? 0.f : 1.f / l_lo;
  const float inv_hi = l_hi == 0.f ? 0.f : 1.f / l_hi;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int cc = 8 * j + 2 * (lane & 3);
    if (r_lo < sq) {
      hopper::store2(o_b + (size_t)r_lo * row_stride + cc,
                     o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    }
    if (r_hi < sq) {
      hopper::store2(o_b + (size_t)r_hi * row_stride + cc,
                     o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
    }
  }
  if ((lane & 3) == 0) {
    if (r_lo < sq) {
      lse[(size_t)bh * sq + r_lo] =
          m_lo * scale + logf(l_lo == 0.f ? 1.f : l_lo);
    }
    if (r_hi < sq) {
      lse[(size_t)bh * sq + r_hi] =
          m_hi * scale + logf(l_hi == 0.f ? 1.f : l_hi);
    }
  }
}

template <int D, typename T>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int batch, int heads, int kv_heads, int sq,
                 int sk, float scale, int causal, cudaStream_t stream) {
  using C = FwdCfg<D>;
  CUtensorMap q_map, k_map, v_map;
  const cuuint64_t q_dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                                (cuuint64_t)sq, (cuuint64_t)batch};
  const cuuint64_t q_strides[3] = {(cuuint64_t)D * 2,
                                   (cuuint64_t)heads * D * 2,
                                   (cuuint64_t)sq * heads * D * 2};
  const cuuint32_t q_box[4] = {64, 1, kHQ, 1};
  int err =
      hopper::encode_16bit_map<T>(&q_map, q, 4, q_dims, q_strides, q_box);
  if (err) return err;
  const cuuint64_t kv_dims[4] = {(cuuint64_t)D, (cuuint64_t)kv_heads,
                                 (cuuint64_t)sk, (cuuint64_t)batch};
  const cuuint64_t kv_strides[3] = {(cuuint64_t)D * 2,
                                    (cuuint64_t)kv_heads * D * 2,
                                    (cuuint64_t)sk * kv_heads * D * 2};
  const cuuint32_t kv_box[4] = {64, 1, kHK, 1};
  err = hopper::encode_16bit_map<T>(&k_map, k, 4, kv_dims, kv_strides,
                                    kv_box);
  if (err) return err;
  err = hopper::encode_16bit_map<T>(&v_map, v, 4, kv_dims, kv_strides,
                                    kv_box);
  if (err) return err;
  auto kernel = flash_fwd_wgmma_kernel<D, T>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (cerr != cudaSuccess) return (int)cerr;
  const int n_bh = batch * heads;
  // (batch, head) pairs per chunk. Where all of K and V fit in 24 MB they
  // stay in the 50 MB L2 in any order: one chunk, the heaviest tiles of
  // every head first (8 MB chunks cost 40-65 % there: b 1 s 2048). Past
  // that, chunks whose K and V (per query head: a GQA group shares them)
  // take ~8 MB, so the one or two chunks in flight stay in L2 (b 12 s 1024:
  // 0.177 against 0.220 ms in one chunk). chip_sweeps.py flash_chunk, on
  // an H100 80GB HBM3 at 700 W.
  const long long kv_per_head =
      4LL * sk * D / (heads / kv_heads) + 1;  // K and V, 2 bytes each
  const long long one_chunk_bytes = 24LL << 20;  // sweep: flash_one_chunk_bytes
  const long long chunk_bytes = 8LL << 20;       // sweep: flash_chunk_bytes
  const long long chunk = kv_per_head * n_bh <= one_chunk_bytes
                              ? n_bh : chunk_bytes / kv_per_head;
  const int chunk_bh = (int)(chunk < 1 ? 1 : chunk > n_bh ? n_bh : chunk);
  const long long blocks = (long long)((sq + kHQ - 1) / kHQ) * n_bh;
  kernel<<<(unsigned)blocks, kHThreads, C::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<T*>(out), lse, heads,
      kv_heads, sq, sk, scale, causal, n_bh, chunk_bh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores, d in {64, 128}: 3xTF32 on mma.sync (variant 2).
//
// What bounds the FMA kernel above: K and V come in by synchronous 4-byte
// loads behind three __syncthreads a tile, the scores go through shared
// memory, one warp walks the online softmax over 8 rows in turn, and its
// 4 x 4 register tiles need 8 shared loads for 16 FMAs, so shared memory
// caps it near half the 67 TFLOP/s f32 peak (23 % of it on an H100 at the
// DiT shape). Here the products run on the tensor cores in TF32 (495
// TFLOP/s dense), three of them to keep f32's accuracy (the split and
// the products: tf32x3.cuh). A one-pass TF32 product (hi_a hi_b) is
// ~2^-11 off and fails the f32 gate (chip_smoke.py plants it,
// FLASH_TF32_PLANT below).
//
// The tensor core adds each product into its f32 accumulator with
// truncation, so a long chain of mma.sync into one accumulator drifts
// (toward zero) further than f32 FMAs do. The chains are kept short:
// the small cross terms go to accumulators of their own (their
// truncation is ~2^-11 of the big terms'), and P V is summed per 32-key
// tile from zero, then added to the running output with an f32 FMA that
// also applies the softmax rescale. Every chain is D / 8 (scores) or 4
// (P V) products long.
//
// Block: 4 warps, 64 query rows of one (batch, head); warp w owns rows
// 16 w .. 16 w + 15, as in the mma.sync kernel above. Q is staged once;
// K and V tiles of 32 keys stream through a two-stage ring by 16-byte
// cp.async (zeros past sk), the next tile's copies issued before the
// current tile's products, one __syncthreads a tile. Per tile each warp
// computes its 16 x 32 scores (4 n8 tiles, D / 8 k-steps), masks the
// ragged tail and the causal diagonal, runs the online softmax in base 2
// on the accumulators (a row's values in the 4 lanes of a quad; the
// running sum kept per lane, reduced once at the end), and adds P V.
// Fragment layouts of m16n8k8 .tf32: tf32x3.cuh.
// P leaves S's products in the C layout (lane holds keys 2t, 2t + 1 of
// each 8-key tile), not in A's (keys t, t + 4). The sum over keys does
// not care about their order, so P V takes k = t as key 2t and k = t + 4
// as key 2t + 1: a0..a3 = c0, c2, c1, c3, and V's B fragment reads rows
// 2t and 2t + 1. No shuffle.
// Shared memory rows are padded to D + 4 floats (4 mod 32 words, a
// multiple of 16 bytes for cp.async): K's fragments read K[g][t] (bank
// 4 g + t), V's V[2t][g] and V[2t + 1][g] (banks 8 t + g and 8 t + 4 + g),
// Q's Q[g][t]: 32 distinct banks each. Q stays in shared memory and is
// split per k-step (hi and lo of 16 x D in registers would take D
// registers a thread); 52 KB (d 64) or 101 KB (d 128) a block, 4 or 2
// blocks an SM (127 and 255 registers, no spill).
//
// Blocks run the heaviest (causal) query tile of each head first. lse is
// stored in natural log units; a row with no visible key gives out 0 and
// lse -inf, as the FMA kernel does.

// 0 in the library. chip_smoke.py builds two planted copies to show that
// the f32 gate catches their faults: 1 keeps hi x hi only (one-pass TF32),
// 2 scales the scores of the last key tile by 1.01
#ifndef FLASH_TF32_PLANT
#define FLASH_TF32_PLANT 0
#endif

constexpr int kXBK = 32;     // keys per K/V tile
constexpr int kXStages = 2;  // K/V ring depth

template <int D>
struct Tf32Cfg {
  static constexpr int kRow = D + 4;       // padded row, floats
  static constexpr int kQ = kBQ * kRow;    // floats of the Q tile
  static constexpr int kKV = kXBK * kRow;  // floats of one K (or V) tile
  static constexpr int kSmem =
      (kQ + 2 * kXStages * kKV) * (int)sizeof(float);
};

// the cp.async staging and the split products: tf32x3.cuh (shared with
// the f32 backward)
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait_all;
using tf32x3::split_tf32;
using tf32x3::stage_f32;

// this file's products: one-pass TF32 in the planted copy 1
constexpr bool kOnePass = FLASH_TF32_PLANT == 1;

template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 64 ? 4 : 2)
    flash_fwd_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          float* __restrict__ out, float* __restrict__ lse,
                          int heads, int kv_heads, int sq, int sk,
                          float scale, int causal) {
  using C = Tf32Cfg<D>;
  constexpr int R = C::kRow;
  constexpr int DT = D / 8;  // 8-wide output column tiles
  constexpr int NT = kXBK / 8;  // 8-key score tiles
  extern __shared__ __align__(16) float xs[];
  float* q_s = xs;                       // [kBQ][R]
  float* k_s = q_s + C::kQ;              // [kXStages][kXBK][R]
  float* v_s = k_s + kXStages * C::kKV;  // [kXStages][kXBK][R]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
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
  const float* q_b = q + (size_t)bi * sq * q_row + (size_t)hh * D;
  const float* k_b = k + (size_t)bi * sk * kv_row + (size_t)kvh * D;
  const float* v_b = v + (size_t)bi * sk * kv_row + (size_t)kvh * D;

  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  const int n_kt = (k_end + kXBK - 1) / kXBK;  // >= 1: the launcher
                                                // sends sk > 0 only
  auto stage_kv = [&](int kt) {
    const int st = kt % kXStages;
    stage_f32<D, kXBK>(k_s + st * C::kKV, k_b, kv_row, kt * kXBK, sk);
    stage_f32<D, kXBK>(v_s + st * C::kKV, v_b, kv_row, kt * kXBK, sk);
  };
  stage_f32<D, kBQ>(q_s, q_b, q_row, q0, sq);
  stage_kv(0);
  cp_async_commit();

  const int r_lo = q0 + warp * 16 + g;  // this lane's two query rows
  const int r_hi = r_lo + 8;
  const float* qa = q_s + (warp * 16 + g) * R + t;
  const float sl2 = scale * 1.4426950408889634f;  // scale log2(e)
  // running max (base-2 units), this lane's share of the running sum
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait_all();  // tile kt (and Q): this thread's copies
    __syncthreads();      // everyone's; tile kt - 1's readers are done
    if (kt + 1 < n_kt) stage_kv(kt + 1);  // into the stage kt - 1 used
    cp_async_commit();
    const float* kb = k_s + (kt % kXStages) * C::kKV;
    const float* vb = v_s + (kt % kXStages) * C::kKV;

    // S = Q K^T: 16 rows x 32 keys, NT tiles of 8 keys; s the hi x hi
    // products, s2 the cross terms
    float s[NT][4], s2[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s2[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      uint32_t ah[4], al[4];
      split_tf32(qa[kk], ah[0], al[0]);
      split_tf32(qa[8 * R + kk], ah[1], al[1]);
      split_tf32(qa[kk + 4], ah[2], al[2]);
      split_tf32(qa[8 * R + kk + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kr = kb + (n * 8 + g) * R + kk + t;
        uint32_t bh0, bh1, bl0, bl1;
        split_tf32(kr[0], bh0, bl0);
        split_tf32(kr[4], bh1, bl1);
        tf32x3::mma_3xtf32<kOnePass>(s[n], s2[n], ah, al, bh0, bh1, bl0,
                                        bl1);
      }
    }

    // scores in base-2 units; the ragged key tail and the causal
    // diagonal masked
    const int k0 = kt * kXBK;
    const float plant = (FLASH_TF32_PLANT == 2 && kt == n_kt - 1) ? 1.01f
                                                                  : 1.f;
    const bool edge = k0 + kXBK > sk ||
                      (causal && k0 + kXBK - 1 > q0 + warp * 16);
    float mn_lo = m_lo, mn_hi = m_hi;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = (s[n][e] + s2[n][e]) * (sl2 * plant);
        s[n][2 + e] = (s[n][2 + e] + s2[n][2 + e]) * (sl2 * plant);
        if (edge) {
          const int col = k0 + n * 8 + 2 * t + e;
          if (col >= sk || (causal && col > r_lo)) s[n][e] = -INFINITY;
          if (col >= sk || (causal && col > r_hi)) s[n][2 + e] = -INFINITY;
        }
        mn_lo = fmaxf(mn_lo, s[n][e]);
        mn_hi = fmaxf(mn_hi, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mn_lo = fmaxf(mn_lo, __shfl_xor_sync(0xffffffffu, mn_lo, x));
      mn_hi = fmaxf(mn_hi, __shfl_xor_sync(0xffffffffu, mn_hi, x));
    }
    // a row with no visible key yet keeps p = 0 (2^-inf); its old state
    // is scaled by 2^-inf = 0 until its first key
    const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float al_lo = exp2f(m_lo - base_lo);
    const float al_hi = exp2f(m_hi - base_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = exp2f(s[n][e] - base_lo);
        s[n][2 + e] = exp2f(s[n][2 + e] - base_hi);
        ps_lo += s[n][e];
        ps_hi += s[n][2 + e];
      }
    }
    l_lo = l_lo * al_lo + ps_lo;
    l_hi = l_hi * al_hi + ps_hi;

    // O = O alpha + P V: per 8 output columns, NT k-steps of 8 keys from
    // zero, key 2t as k = t and key 2t + 1 as k = t + 4 (see above)
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      split_tf32(s[ks][0], ph[ks][0], pl[ks][0]);  // P[g][2t]
      split_tf32(s[ks][2], ph[ks][1], pl[ks][1]);  // P[g + 8][2t]
      split_tf32(s[ks][1], ph[ks][2], pl[ks][2]);  // P[g][2t + 1]
      split_tf32(s[ks][3], ph[ks][3], pl[ks][3]);  // P[g + 8][2t + 1]
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f}, pv2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < NT; ++ks) {
        const float* vr = vb + (ks * 8 + 2 * t) * R + j * 8 + g;
        uint32_t bh0, bh1, bl0, bl1;
        split_tf32(vr[0], bh0, bl0);  // V[2t][8j + g]
        split_tf32(vr[R], bh1, bl1);  // V[2t + 1][8j + g]
        tf32x3::mma_3xtf32<kOnePass>(pv, pv2, ph[ks], pl[ks], bh0, bh1,
                                        bl0, bl1);
      }
      o[j][0] = fmaf(o[j][0], al_lo, pv[0] + pv2[0]);
      o[j][1] = fmaf(o[j][1], al_lo, pv[1] + pv2[1]);
      o[j][2] = fmaf(o[j][2], al_hi, pv[2] + pv2[2]);
      o[j][3] = fmaf(o[j][3], al_hi, pv[3] + pv2[3]);
    }
  }
  cp_async_wait_all();  // the last (empty) group

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
  }
  float* o_b = out + (size_t)bi * sq * q_row + (size_t)hh * D;
  const float inv_lo = l_lo == 0.f ? 0.f : 1.f / l_lo;
  const float inv_hi = l_hi == 0.f ? 0.f : 1.f / l_hi;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = j * 8 + 2 * t;
    if (r_lo < sq) {
      *reinterpret_cast<float2*>(o_b + (size_t)r_lo * q_row + c) =
          make_float2(o[j][0] * inv_lo, o[j][1] * inv_lo);
    }
    if (r_hi < sq) {
      *reinterpret_cast<float2*>(o_b + (size_t)r_hi * q_row + c) =
          make_float2(o[j][2] * inv_hi, o[j][3] * inv_hi);
    }
  }
  if (t == 0) {
    constexpr float kLn2 = 0.6931471805599453f;
    if (r_lo < sq) {
      lse[(size_t)bh * sq + r_lo] = m_lo * kLn2 + logf(l_lo == 0.f ? 1.f
                                                                   : l_lo);
    }
    if (r_hi < sq) {
      lse[(size_t)bh * sq + r_hi] = m_hi * kLn2 + logf(l_hi == 0.f ? 1.f
                                                                   : l_hi);
    }
  }
}

template <int D>
int launch_tf32(const float* q, const float* k, const float* v, float* out,
                float* lse, int batch, int heads, int kv_heads, int sq,
                int sk, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_tf32_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tf32Cfg<D>::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  kernel<<<grid, kTcThreads, Tf32Cfg<D>::kSmem, stream>>>(
      q, k, v, out, lse, heads, kv_heads, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, typename T>
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
  } else if constexpr (!std::is_same<T, float>::value) {
    auto kernel = flash_fwd_tc_kernel<D, T>;
    const size_t smem = tc_smem_bytes(D);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kTcThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, heads, kv_heads,
        sq, sk, scale, causal);
  }
  return (int)cudaGetLastError();
}

// the kernels of one element type T (float selects the FMA kernel or,
// with variant 2, the 3xTF32 kernel; bf16 and __half the mma.sync kernel
// or, with variant 1, the wgmma kernel)
template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 float* lse, int batch, int heads, int kv_heads, int sq,
                 int sk, int d, float scale, int causal, int variant,
                 cudaStream_t s) {
  constexpr int dtype = std::is_same<T, float>::value ? 0 : 1;
  if (variant == 2) {
    if constexpr (dtype == 0) {
      const float* qf = static_cast<const float*>(q);
      const float* kf = static_cast<const float*>(k);
      const float* vf = static_cast<const float*>(v);
      float* of = static_cast<float*>(out);
      if (sk > 0 && d == 64) {
        return launch_tf32<64>(qf, kf, vf, of, lse, batch, heads, kv_heads,
                               sq, sk, scale, causal, s);
      }
      if (sk > 0 && d == 128) {
        return launch_tf32<128>(qf, kf, vf, of, lse, batch, heads,
                                kv_heads, sq, sk, scale, causal, s);
      }
    }
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 0) {
    if (variant != 1 || dtype == 0 || sk == 0) {
      return (int)cudaErrorInvalidValue;
    }
    if constexpr (dtype == 1) {
      if (d == 64) {
        return launch_wgmma<64, T>(q, k, v, out, lse, batch, heads,
                                   kv_heads, sq, sk, scale, causal, s);
      }
      if (d == 128) {
        return launch_wgmma<128, T>(q, k, v, out, lse, batch, heads,
                                    kv_heads, sq, sk, scale, causal, s);
      }
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (d) {
    case 16:
      return launch_d<16, T>(q, k, v, out, lse, batch, heads, kv_heads, sq,
                             sk, scale, causal, dtype, s);
    case 32:
      return launch_d<32, T>(q, k, v, out, lse, batch, heads, kv_heads, sq,
                             sk, scale, causal, dtype, s);
    case 64:
      return launch_d<64, T>(q, k, v, out, lse, batch, heads, kv_heads, sq,
                             sk, scale, causal, dtype, s);
    case 128:
      return launch_d<128, T>(q, k, v, out, lse, batch, heads, kv_heads, sq,
                              sk, scale, causal, dtype, s);
    case 256:
      return launch_d<256, T>(q, k, v, out, lse, batch, heads, kv_heads, sq,
                              sk, scale, causal, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and out share
// it). q, k and v must start on a 16-byte boundary (the caller copies
// them if not). variant: 0 = the kernel of the dtype (f32 FMA, or
// mma.sync for bf16 and f16); 1 = the Hopper wgmma/TMA kernel (bf16 or
// f16, d 64 or 128, sk > 0); 2 = the 3xTF32 kernel (f32, d 64 or 128,
// sk > 0).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, void* lse, int batch, int heads,
                               int kv_heads, int sq, int sk, int d,
                               float scale, int causal, int dtype,
                               int variant, void* stream) {
  if (batch == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return launch_typed<float>(q, k, v, out, l, batch, heads, kv_heads, sq,
                                 sk, d, scale, causal, variant, s);
    case 1:
      return launch_typed<__nv_bfloat16>(q, k, v, out, l, batch, heads,
                                         kv_heads, sq, sk, d, scale, causal,
                                         variant, s);
    case 2:
      return launch_typed<__half>(q, k, v, out, l, batch, heads, kv_heads,
                                  sq, sk, d, scale, causal, variant, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
