// Flash attention backward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/kernels/pallas/flash_attention.py:_flash_bwd
//           (kernel bodies _bwd_dq_kernel and _bwd_dkv_kernel).
//
// Given the forward's inputs q [b, sq, heads, d], k/v [b, sk, kv_heads, d],
// the output gradient dout (q's layout), the forward's per-row logsumexp
// lse [b, heads, sq] and delta [b, heads, sq] = rowsum(dout * out) (both
// float32), it recomputes, per (query row i, key j) visible pair,
//   P  = exp(q_i . k_j * scale - lse_i)
//   dS = P * (dout_i . v_j - delta_i) * scale
// and accumulates
//   dq_i = sum_j dS k_j,  dk_j = sum_i dS q_i,  dv_j = sum_i P dout_i.
// GQA is read in place: query head h uses kv head h / (heads / kv_heads),
// and dk/dv of a kv head sum over every query head of its group inside
// one block (no atomics, no repeated K/V written out). The causal mask is
// top-left aligned, as in the forward (callers send causal work here only
// when sq == sk); ragged tails (sq or sk not a multiple of the tile) are
// masked.
//
// Two kernels, as in the TPU version:
//  * dq:  one block per (b * heads, query tile); it walks the key tiles
//         up to the diagonal and accumulates dq in f32 registers.
//  * dkv: one block per (b * kv_heads, key tile); it walks, for every
//         query head of the group, the query tiles at or below the
//         diagonal and accumulates dk and dv in f32 registers.
// Each kernel recomputes S and dP for its own tiles, so together they
// run seven s x s x d products where the least work is five: the price
// of keeping dq out of atomics (a single kernel would sum dq across key
// tiles in f32 by atomics and convert it in a third pass, and lose
// run-to-run determinism).
//
// What bounds it on an H100: at the training shapes (s = 1024, d = 128)
// the products dominate, so it is bound by operations; the designs keep
// every s x s tile (S, P, dP, dS) in registers and read each q, k, v and
// dout element once per tile pair. Four designs, by dtype and head dim
// (the launch functions' `variant`):
//  * 16-bit, d 64 and 128 (*_wgmma kernels, variant 1): Hopper's wgmma
//    fed by TMA through an mbarrier ring, a producer thread and two
//    consumer warpgroups; the dq kernel also computes delta. See the
//    section "16-bit on Hopper" below.
//  * 16-bit, d 16 and 32, and every 16-bit call of variant 0 (*_tc
//    kernels, the design every bf16 call ran before the wgmma kernels;
//    kept at d 64 and 128 as their yardstick): mma.sync.m16n8k16 on the
//    tensor cores (16-bit in, f32 accumulate), with the fragment layouts and
//    16-byte staging of flash_attention.cu. Every operand fragment read
//    from shared memory comes through ldmatrix (.trans for the B operands
//    of the second products, whose tiles hold k along their rows). P and
//    dS go from the first products' accumulators to the second products'
//    A operands in registers, rounded to 16 bits only there. The s x s work
//    is done 32 columns at a time. q, k, v and dout must start on a
//    16-byte boundary (the Python wrapper copies any that do not).
//  * f32, d 64 and 128 (*_tf32 kernels, variant 2): 3xTF32 on mma.sync,
//    streamed tiles by cp.async. See the section "f32 on the tensor
//    cores" below.
//  * f32, d 16 and 32, and every f32 call of variant 0 (kept at d 64 and
//    128 as the 3xTF32 kernels' yardstick): exact FMAs from shared memory
//    (rows padded by one float), 256 threads in a 16 x 16 grid, each
//    owning a 4 x 4 block of the 64 x 64 score tile and a 4 x (d / 16)
//    block of its accumulators.
//
// "16-bit" is bf16 or float16: each 16-bit kernel is a template on its
// element type T (__nv_bfloat16 or __half), which picks the PTX operand
// type of mma.sync and wgmma (.bf16 or .f16), the f32 -> 16-bit packing
// of P, dS and the gradients (hopper::pack2 / store2), the unpacking of
// O and dO for delta (hopper::unpack2) and the TMA element type; the
// designs are the same. In float16, P and dS keep 3 more mantissa bits
// than in bf16 but only 5 exponent bits: dS values below 2^-14 lose
// precision (subnormal) and below 2^-24 become 0, where bf16 keeps them.
// Under a loss scale (amp's GradScaler) dO and dS are scaled up, which
// keeps dS in float16's normal range; an overflow of dO shows as inf in
// the gradients, which the scaler's finite check turns into a skipped
// step.
//
// Launch contract: the two launch functions set each kernel's dynamic
// shared memory, launch on the given stream and return cudaGetLastError()
// (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // f32 kernels: 16 x 16 threads
constexpr int kSP = kBK + 1;   // padded score row (f32)
constexpr int kTcThreads = 128;

// A row whose every key is masked has lse = -inf (no valid call sends
// one); +inf turns its probabilities into exp(s - inf) = 0. Rows past
// the sequence end get +inf too.
__device__ __forceinline__ float row_lse(const float* lse, size_t base,
                                         int row, int n) {
  if (row >= n) return INFINITY;
  const float x = lse[base + row];
  return x == -INFINITY ? INFINITY : x;
}

// ---------------------------------------------------------------------------
// f32: exact FMAs.

constexpr size_t dq_smem_floats(int d) {
  return 4 * (size_t)kBQ * (d + 1)   // q_s, do_s, k_s, v_s
         + (size_t)kBQ * kSP         // ds_s
         + 2 * (size_t)kBQ;          // lse_s, dl_s
}

constexpr size_t dkv_smem_floats(int d) {
  return 4 * (size_t)kBQ * (d + 1)   // k_s, v_s, q_s, do_s
         + 2 * (size_t)kBQ * kSP     // pt_s, dst_s
         + 2 * (size_t)kBQ;          // lse_s, dl_s
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int heads, int kv_heads, int sq, int sk,
    float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;              // [kBQ][DP]
  float* do_s = q_s + kBQ * DP;   // [kBQ][DP]
  float* k_s = do_s + kBQ * DP;   // [kBK][DP]
  float* v_s = k_s + kBK * DP;    // [kBK][DP]
  float* ds_s = v_s + kBK * DP;   // [kBQ][kSP]
  float* lse_s = ds_s + kBQ * kSP;
  float* dl_s = lse_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int bi = bh / heads;
  const int hh = bh - bi * heads;
  const int kvh = hh / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const size_t q_row = (size_t)heads * D;
  const size_t kv_row = (size_t)kv_heads * D;
  const size_t q_off = (size_t)bi * sq * q_row + (size_t)hh * D;
  const float* q_b = q + q_off;
  const float* do_b = dout + q_off;
  const float* k_b = k + (size_t)bi * sk * kv_row + (size_t)kvh * D;
  const float* v_b = v + (size_t)bi * sk * kv_row + (size_t)kvh * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = q0 + r;
    const bool ok = row < sq;
    q_s[r * DP + c] = ok ? q_b[(size_t)row * q_row + c] : 0.f;
    do_s[r * DP + c] = ok ? do_b[(size_t)row * q_row + c] : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    const int row = q0 + r;
    lse_s[r] = row_lse(lse, (size_t)bh * sq, row, sq);
    dl_s[r] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
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
      v_s[r * DP + c] = vv;
    }
    __syncthreads();

    // S and dP for rows ty + 16 i, keys tx + 16 j
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qa[4], da[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = q_s[(ty + 16 * i) * DP + c];
        da[i] = do_s[(ty + 16 * i) * DP + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = k_s[(tx + 16 * j) * DP + c];
        vb[j] = v_s[(tx + 16 * j) * DP + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] += qa[i] * kb[j];
          dp[i][j] += da[i] * vb[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tx + 16 * j;
        const int col = k0 + cc;
        const bool keep = col < sk && (!causal || col <= q0 + r);
        const float p = keep ? expf(sc[i][j] * scale - lse_s[r]) : 0.f;
        ds_s[r * kSP + cc] = p * (dp[i][j] - dl_s[r]) * scale;
      }
    }
    __syncthreads();

    // dq += dS K for rows ty + 16 i, columns tx + 16 j
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float ds[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = ds_s[(ty + 16 * i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = k_s[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += ds[i] * kv[j];
    }
  }

  float* dq_b = dq + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < sq) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dq_b[(size_t)row * q_row + tx + 16 * j] = acc[i][j];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int heads,
    int kv_heads, int sq, int sk, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;               // [kBK][DP]
  float* v_s = k_s + kBK * DP;     // [kBK][DP]
  float* q_s = v_s + kBK * DP;     // [kBQ][DP]
  float* do_s = q_s + kBQ * DP;    // [kBQ][DP]
  float* pt_s = do_s + kBQ * DP;   // [kBK][kSP]  P^T
  float* dst_s = pt_s + kBK * kSP; // [kBK][kSP]  dS^T
  float* lse_s = dst_s + kBK * kSP;
  float* dl_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int bkv = blockIdx.y;
  const int bi = bkv / kv_heads;
  const int kvh = bkv - bi * kv_heads;
  const int group = heads / kv_heads;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const size_t q_row = (size_t)heads * D;
  const size_t kv_row = (size_t)kv_heads * D;
  const size_t kv_off = (size_t)bi * sk * kv_row + (size_t)kvh * D;
  const float* k_b = k + kv_off;
  const float* v_b = v + kv_off;

  for (int i = tid; i < kBK * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = k0 + r;
    const bool ok = row < sk;
    k_s[r * DP + c] = ok ? k_b[(size_t)row * kv_row + c] : 0.f;
    v_s[r * DP + c] = ok ? v_b[(size_t)row * kv_row + c] : 0.f;
  }

  float dka[4][DJ], dva[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  // causal: the queries that see any key of this tile start at k0
  const int q_start = causal ? k0 : 0;
  for (int hh = kvh * group; hh < (kvh + 1) * group; ++hh) {
    const size_t q_off = (size_t)bi * sq * q_row + (size_t)hh * D;
    const float* q_b = q + q_off;
    const float* do_b = dout + q_off;
    const size_t l_off = ((size_t)bi * heads + hh) * sq;
    for (int q0 = q_start; q0 < sq; q0 += kBQ) {
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < kBQ * D; i += kThreads) {
        const int r = i / D;
        const int c = i - r * D;
        const int row = q0 + r;
        const bool ok = row < sq;
        q_s[r * DP + c] = ok ? q_b[(size_t)row * q_row + c] : 0.f;
        do_s[r * DP + c] = ok ? do_b[(size_t)row * q_row + c] : 0.f;
      }
      for (int r = tid; r < kBQ; r += kThreads) {
        const int row = q0 + r;
        lse_s[r] = row_lse(lse, l_off, row, sq);
        dl_s[r] = row < sq ? delta[l_off + row] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for keys ty + 16 i, queries tx + 16 j
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float ka[4], va[4], qb[4], db[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = k_s[(ty + 16 * i) * DP + c];
          va[i] = v_s[(ty + 16 * i) * DP + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qb[j] = q_s[(tx + 16 * j) * DP + c];
          db[j] = do_s[(tx + 16 * j) * DP + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] += ka[i] * qb[j];
            dpt[i][j] += va[i] * db[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int key = k0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = tx + 16 * j;
          const bool keep = key < sk && (!causal || key <= q0 + cc);
          const float p = keep ? expf(st[i][j] * scale - lse_s[cc]) : 0.f;
          pt_s[r * kSP + cc] = p;
          dst_s[r * kSP + cc] = p * (dpt[i][j] - dl_s[cc]) * scale;
        }
      }
      __syncthreads();

      // dv += P^T dout, dk += dS^T q for keys ty + 16 i, columns tx + 16 j
#pragma unroll 4
      for (int c = 0; c < kBQ; ++c) {
        float pv[4], dsv[4], dov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt_s[(ty + 16 * i) * kSP + c];
          dsv[i] = dst_s[(ty + 16 * i) * kSP + c];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dov[j] = do_s[c * DP + tx + 16 * j];
          qv[j] = q_s[c * DP + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dva[i][j] += pv[i] * dov[j];
            dka[i][j] += dsv[i] * qv[j];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row < sk) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const size_t at = kv_off + (size_t)row * kv_row + tx + 16 * j;
        dk[at] = dka[i][j];
        dv[at] = dva[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores, d in {64, 128}: 3xTF32 on mma.sync (variant 2).
//
// What bounds the FMA kernels above: every s x s x d product runs as f32
// FMAs from shared memory, whose 4 x 4 register tiles need 8 shared loads
// for 16 FMAs (about a quarter of the 67 TFLOP/s f32 peak at the DiT
// shape), and K/V or Q/dO tiles come in by synchronous 4-byte loads
// behind three __syncthreads a tile. Here every product runs on the tensor
// cores as three TF32 products of split operands (tf32x3.cuh: the split,
// the products, the cp.async staging and the fragment layouts), as in the
// f32 forward (flash_attention.cu); a one-pass TF32 product fails the f32
// gate (chip_smoke.py plants it, FLASH_BWD_TF32_PLANT below).
//
// The tensor core truncates as it accumulates, so no chain is long: the
// cross terms have accumulators of their own, the hi x hi products of S
// and dP are summed 32 values of D at a time (a chain of 4) and added in
// f32, and each streamed tile's dS K, P^T dO and dS^T Q is summed from
// zero (N / 8 products) and then added to the f32 gradient registers. P
// is exp(S scale - lse) in natural units, as the FMA kernels form it:
// 2^(S scale log2(e) - lse log2(e)) rounds lse log2(e) once per row, an
// error that every key of the row shares and dq does not average away.
// At GQA hq 32 / hkv 4 / s 512 a dk/dv block walks 8 heads x 16 tiles:
// one chain over them would drift as the forward's first form did.
//
// dq: a block is 64 query rows of one (batch, head), 4 warps of 16 rows.
// It computes delta = rowsum(dO O) of its rows and stores it for the
// dk/dv kernel (no separate pass over O and dO, as the wgmma dq kernel).
// Q and dO are staged once; K and V tiles of N keys stream by 16-byte
// cp.async (zeros past sk) through a two-stage ring, the next tile's
// copies issued before the current tile's products, one __syncthreads a
// tile. Per tile each warp forms S = Q K^T and dP = dO V^T (16 x N, in
// the C layout), P = exp(S scale - lse) with the ragged tail and the
// causal diagonal masked (a row past sq, or whose lse is -inf, has lse
// +inf: P = 0), dS = P (dP - delta) scale, and dq += dS K
// with dS as the A operand straight from the C layout: key 2t as k = t,
// key 2t + 1 as k = t + 4 (a0..a3 = c0, c2, c1, c3), K's rows read in
// that order, no shuffle. Causal blocks stop at the diagonal; the
// heaviest query tiles run first.
//
// dk/dv: a block is 64 keys of one (batch, kv head), 4 warps of 16 keys.
// K and V are staged once; Q, dO, lse and delta tiles of N queries stream
// through the ring over every query head of the group (causal: from the
// block's first key). With rows as keys, S^T = K Q^T and dP^T = V dO^T
// come out in the C layout, so P^T and dS^T feed dv += P^T dO and
// dk += dS^T Q as A operands by the same trick, dO and Q read at rows 2t
// and 2t + 1. dv's product runs before dP^T is formed, which keeps the
// registers a thread holds at once near 128 (dk, dv) + 48.
//
// N is 32 at d 64 and 16 at d 128: shared memory 68 KB (dq) and 68.5 KB
// (dk/dv) a block at d 64, 99 KB and 99.25 KB at d 128, so two blocks fit
// an SM at either (their registers allow two, no more, at d 64 too).
// Each warp splits the streamed values it reads. Splitting each tile once,
// as it lands, into hi and lo planes doubles the ring (102 KB at d 64,
// 132 KB at d 128: one block an SM); on an H100 that was no faster at
// d 64 and slower at d 128 (PERF.md), and 32-row tiles at d 128 were
// slower than 16 (chip_sweeps.py flash_bwd_tf32).
// Rows are padded to D + 4 floats: Q[g][t], K[g][t] (bank 4 g + t) and
// the C-layout pairs' rows 2t, 2t + 1 (banks 8 t + g, 8 t + 4 + g) are
// 32 distinct banks each, in both kernels' orientations. No atomics: two
// runs give bit-identical gradients.

// 0 in the library. chip_smoke.py builds two planted copies to show that
// the f32 gate catches their faults: 1 keeps hi x hi only in every
// product (one-pass TF32), 2 scales dS by 1.01 in dq's last key tile and
// in dk/dv's last query tile of each head
#ifndef FLASH_BWD_TF32_PLANT
#define FLASH_BWD_TF32_PLANT 0
#endif

constexpr bool kBwdOnePass = FLASH_BWD_TF32_PLANT == 1;
constexpr int kXStages = 2;  // ring depth of the streamed tiles

using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait_all;
using tf32x3::split_tf32;
using tf32x3::stage_f32;

// the blocks an SM the dq kernel is compiled for (its registers: at most
// 65536 / (128 x this))
template <int D>
constexpr int kDqMinBlocks = 2;  // sweep: flash_bwd_tf32_dq_blocks

template <int D>
struct BwdTf32Cfg {
  static constexpr int kRow = D + 4;  // padded row, floats
  // rows of a streamed tile
  static constexpr int kN = D == 128 ? 16 : 32;  // sweep: flash_bwd_tf32_rows
  static constexpr int kBlock = kBQ * kRow;  // floats of a 64-row operand
  static constexpr int kTile = kN * kRow;    // floats of a streamed tile
  // dq: Q and dO once, K and V tiles in the ring
  static constexpr int kDqSmem =
      (2 * kBlock + 2 * kXStages * kTile) * (int)sizeof(float);
  // dk/dv: K and V once; Q, dO, lse and delta tiles in the ring
  static constexpr int kDkvSmem =
      (2 * kBlock + 2 * kXStages * (kTile + kN)) * (int)sizeof(float);
};

// 4 bytes global -> shared, asynchronously; a zero when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// big + small = A B^T over D for one warp's 16 rows of A and NT x 8 rows
// of B, both [rows][D + 4] in shared memory: a is A + g R + t (rows g and
// g + 8), and b is B + g R + t, both split per k-step. The hi x hi
// products of every 32 values of D are summed from zero (a chain of 4),
// then added to big in f32; the cross terms chain D / 8 into small
template <int D, int NT>
__device__ __forceinline__ void mma_rows(float (&big)[NT][4],
                                         float (&small)[NT][4],
                                         const float* a, const float* b) {
  constexpr int R = D + 4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) big[n][e] = small[n][e] = 0.f;
  }
#pragma unroll 1
  for (int kc = 0; kc < D; kc += 32) {
    float part[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = kc; kk < kc + 32; kk += 8) {
      uint32_t ah[4], al[4];
      split_tf32(a[kk], ah[0], al[0]);
      split_tf32(a[8 * R + kk], ah[1], al[1]);
      split_tf32(a[kk + 4], ah[2], al[2]);
      split_tf32(a[8 * R + kk + 4], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* br = b + n * 8 * R + kk;
        uint32_t bh0, bh1, bl0, bl1;
        split_tf32(br[0], bh0, bl0);
        split_tf32(br[4], bh1, bl1);
        tf32x3::mma_3xtf32<kBwdOnePass>(part[n], small[n], ah, al, bh0,
                                        bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) big[n][e] += part[n][e];
    }
  }
}

// the C-layout values c of a 16 x 8 NT tile (lane: rows g, g + 8, columns
// 2t, 2t + 1 of each 8-column step) as split A fragments whose k runs
// over those columns: column 2t as k = t, 2t + 1 as k = t + 4
template <int NT>
__device__ __forceinline__ void c_to_a(const float (&c)[NT][4],
                                       uint32_t (&h)[NT][4],
                                       uint32_t (&l)[NT][4]) {
#pragma unroll
  for (int ks = 0; ks < NT; ++ks) {
    split_tf32(c[ks][0], h[ks][0], l[ks][0]);  // [g][2t]
    split_tf32(c[ks][2], h[ks][1], l[ks][1]);  // [g + 8][2t]
    split_tf32(c[ks][1], h[ks][2], l[ks][2]);  // [g][2t + 1]
    split_tf32(c[ks][3], h[ks][3], l[ks][3]);  // [g + 8][2t + 1]
  }
}

// acc += X B for one warp's 16 rows: X (16 x 8 NT) in c_to_a's fragments,
// B [8 NT][D + 4] in shared memory at b = B + 2t R + g (rows 2t and
// 2t + 1 of each 8-row step: c_to_a's k order), split per read. Each
// 8-column tile of the product is summed from zero over the tile (a chain
// of NT), then added to acc in f32
template <int D, int NT>
__device__ __forceinline__ void mma_cols(float (&acc)[D / 8][4],
                                         const uint32_t (&xh)[NT][4],
                                         const uint32_t (&xl)[NT][4],
                                         const float* b) {
  constexpr int R = D + 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    float x[4] = {0.f, 0.f, 0.f, 0.f}, x2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < NT; ++ks) {
      const float* br = b + ks * 8 * R + j * 8;
      uint32_t bh0, bh1, bl0, bl1;
      split_tf32(br[0], bh0, bl0);  // B[8 ks + 2t][8 j + g]
      split_tf32(br[R], bh1, bl1);  // B[8 ks + 2t + 1][8 j + g]
      tf32x3::mma_3xtf32<kBwdOnePass>(x, x2, xh[ks], xl[ks], bh0, bh1, bl0,
                                      bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += x[e] + x2[e];
  }
}

// rows r_lo and r_lo + 8 of a 16 x D register tile (the C layout) into
// f32 rows of `stride` floats; rows at or past n are not written
template <int D>
__device__ __forceinline__ void store_f32_rows(float* dst, size_t stride,
                                           const float (&acc)[D / 8][4],
                                           int r_lo, int n, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (r_lo < n) {
      *reinterpret_cast<float2*>(dst + (size_t)r_lo * stride + c) =
          make_float2(acc[j][0], acc[j][1]);
    }
    if (r_lo + 8 < n) {
      *reinterpret_cast<float2*>(dst + (size_t)(r_lo + 8) * stride + c) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, kDqMinBlocks<D>)
    flash_bwd_dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ out, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, int heads,
    int kv_heads, int sq, int sk, float scale, int causal) {
  using C = BwdTf32Cfg<D>;
  constexpr int R = C::kRow;
  constexpr int N = C::kN;
  constexpr int NT = N / 8;
  extern __shared__ __align__(16) float xs[];
  float* q_s = xs;                          // [kBQ][R]
  float* do_s = q_s + C::kBlock;            // [kBQ][R]
  float* k_s = do_s + C::kBlock;            // [kXStages][N][R]
  float* v_s = k_s + kXStages * C::kTile;   // [kXStages][N][R]

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
  const size_t q_off = (size_t)bi * sq * q_row + (size_t)hh * D;
  const float* k_b = k + (size_t)bi * sk * kv_row + (size_t)kvh * D;
  const float* v_b = v + (size_t)bi * sk * kv_row + (size_t)kvh * D;

  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  const int n_kt = (k_end + N - 1) / N;  // >= 1: the launcher sends sk > 0
  auto stage_kv = [&](int kt) {
    const int st = kt % kXStages;
    stage_f32<D, N>(k_s + st * C::kTile, k_b, kv_row, kt * N, sk);
    stage_f32<D, N>(v_s + st * C::kTile, v_b, kv_row, kt * N, sk);
  };
  stage_f32<D, kBQ>(q_s, q + q_off, q_row, q0, sq);
  stage_f32<D, kBQ>(do_s, dout + q_off, q_row, q0, sq);
  stage_kv(0);
  cp_async_commit();

  const int r_lo = q0 + warp * 16 + g;  // this lane's two query rows
  const int r_hi = r_lo + 8;
  const size_t l_off = (size_t)bh * sq;
  const float lse_lo = row_lse(lse, l_off, r_lo, sq);
  const float lse_hi = row_lse(lse, l_off, r_hi, sq);
  // delta = rowsum(dO O) of this lane's two rows, while the first tiles
  // land: each lane of the quad sums a quarter of D, the quad adds the
  // four; lane 0 stores it for the dk/dv kernel
  float dl_lo = 0.f, dl_hi = 0.f;
#pragma unroll
  for (int c = t * (D / 4); c < (t + 1) * (D / 4); c += 4) {
    if (r_lo < sq) {
      const size_t at = q_off + (size_t)r_lo * q_row + c;
      const float4 o = *reinterpret_cast<const float4*>(out + at);
      const float4 d = *reinterpret_cast<const float4*>(dout + at);
      dl_lo += o.x * d.x + o.y * d.y + o.z * d.z + o.w * d.w;
    }
    if (r_hi < sq) {
      const size_t at = q_off + (size_t)r_hi * q_row + c;
      const float4 o = *reinterpret_cast<const float4*>(out + at);
      const float4 d = *reinterpret_cast<const float4*>(dout + at);
      dl_hi += o.x * d.x + o.y * d.y + o.z * d.z + o.w * d.w;
    }
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, x);
    dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, x);
  }
  if (t == 0) {
    if (r_lo < sq) delta[l_off + r_lo] = dl_lo;
    if (r_hi < sq) delta[l_off + r_hi] = dl_hi;
  }
  const float* qa = q_s + (warp * 16 + g) * R + t;
  const float* da = do_s + (warp * 16 + g) * R + t;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const float* kb = k_s + (kt % kXStages) * C::kTile;
    const float* vb = v_s + (kt % kXStages) * C::kTile;
    cp_async_wait_all();  // tile kt (and Q, dO): this thread's copies
    __syncthreads();      // everyone's; tile kt - 1's readers are done
    if (kt + 1 < n_kt) stage_kv(kt + 1);  // into the stage kt - 1 used
    cp_async_commit();

    float s[NT][4], s2[NT][4], dp[NT][4], dp2[NT][4];
    mma_rows<D, NT>(s, s2, qa, kb + g * R + t);    // S = Q K^T
    mma_rows<D, NT>(dp, dp2, da, vb + g * R + t);  // dP = dO V^T

    // P, then dS in its place; the ragged key tail and the causal
    // diagonal masked
    const int k0 = kt * N;
    const float ds_scale =
        (FLASH_BWD_TF32_PLANT == 2 && kt == n_kt - 1) ? 1.01f * scale
                                                       : scale;
    const bool edge = k0 + N > sk ||
                      (causal && k0 + N - 1 > q0 + warp * 16);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + n * 8 + 2 * t + e;
        float p_lo = expf(fmaf(s[n][e] + s2[n][e], scale, -lse_lo));
        float p_hi = expf(fmaf(s[n][2 + e] + s2[n][2 + e], scale, -lse_hi));
        if (edge) {
          if (col >= sk || (causal && col > r_lo)) p_lo = 0.f;
          if (col >= sk || (causal && col > r_hi)) p_hi = 0.f;
        }
        s[n][e] = p_lo * (dp[n][e] + dp2[n][e] - dl_lo) * ds_scale;
        s[n][2 + e] =
            p_hi * (dp[n][2 + e] + dp2[n][2 + e] - dl_hi) * ds_scale;
      }
    }
    uint32_t xh[NT][4], xl[NT][4];
    c_to_a<NT>(s, xh, xl);
    mma_cols<D, NT>(acc, xh, xl, kb + 2 * t * R + g);  // dq += dS K
  }
  cp_async_wait_all();  // the last (empty) group
  store_f32_rows<D>(dq + q_off, q_row, acc, r_lo, sq, t);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2) flash_bwd_dkv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int heads,
    int kv_heads, int sq, int sk, float scale, int causal) {
  using C = BwdTf32Cfg<D>;
  constexpr int R = C::kRow;
  constexpr int N = C::kN;
  constexpr int NT = N / 8;
  extern __shared__ __align__(16) float xs[];
  float* k_s = xs;                          // [kBQ][R], 64 keys
  float* v_s = k_s + C::kBlock;             // [kBQ][R]
  float* q_s = v_s + C::kBlock;             // [kXStages][N][R]
  float* do_s = q_s + kXStages * C::kTile;  // [kXStages][N][R]
  float* l_s = do_s + kXStages * C::kTile;  // [kXStages][N] lse
  float* dl_s = l_s + kXStages * N;         // [kXStages][N] delta

  const int k0 = blockIdx.x * kBQ;
  const int bkv = blockIdx.y;
  const int bi = bkv / kv_heads;
  const int kvh = bkv - bi * kv_heads;
  const int group = heads / kv_heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t q_row = (size_t)heads * D;
  const size_t kv_row = (size_t)kv_heads * D;
  const size_t kv_off = (size_t)bi * sk * kv_row + (size_t)kvh * D;
  stage_f32<D, kBQ>(k_s, k + kv_off, kv_row, k0, sk);
  stage_f32<D, kBQ>(v_s, v + kv_off, kv_row, k0, sk);

  // causal: the queries that see any key of this block start at k0. The
  // tiles run head by head, N queries at a time
  const int q_start = causal ? k0 : 0;
  const int n_qt = sq > q_start ? (sq - q_start + N - 1) / N : 0;
  const int n_tiles = group * n_qt;
  auto stage_q = [&](int i) {
    const int st = i % kXStages;
    const int hh = kvh * group + i / n_qt;
    const int q0 = q_start + (i % n_qt) * N;
    const size_t q_off = (size_t)bi * sq * q_row + (size_t)hh * D;
    stage_f32<D, N>(q_s + st * C::kTile, q + q_off, q_row, q0, sq);
    stage_f32<D, N>(do_s + st * C::kTile, dout + q_off, q_row, q0, sq);
    const int r = threadIdx.x;
    if (r < 2 * N) {  // lse (r < N), then delta
      const int row = q0 + r % N;
      const bool ok = row < sq;
      const float* src = (r < N ? lse : delta) +
                         ((size_t)bi * heads + hh) * sq + (ok ? row : 0);
      cp_async4((r < N ? l_s : dl_s) + st * N + r % N, src, ok);
    }
  };
  if (n_tiles > 0) stage_q(0);
  cp_async_commit();

  const int key_lo = k0 + warp * 16 + g;  // this lane's two keys
  const int key_hi = key_lo + 8;
  const float* ka = k_s + (warp * 16 + g) * R + t;
  const float* va = v_s + (warp * 16 + g) * R + t;
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kXStages;
    const float* qb = q_s + st * C::kTile;
    const float* dob = do_s + st * C::kTile;
    cp_async_wait_all();  // tile i (and K, V): this thread's copies
    __syncthreads();      // everyone's; tile i - 1's readers are done
    if (i + 1 < n_tiles) stage_q(i + 1);  // into the stage i - 1 used
    cp_async_commit();
    const float* ls = l_s + st * N;
    const float* dls = dl_s + st * N;
    const int q0 = q_start + (i % n_qt) * N;

    float s[NT][4], s2[NT][4];
    mma_rows<D, NT>(s, s2, ka, qb + g * R + t);  // S^T = K Q^T

    // P^T in place (columns are queries: a query past sq, or whose lse
    // is -inf, has lse +inf), each column's delta kept for dS^T
    const bool edge = causal && k0 + warp * 16 + 15 > q0;
    float dl[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * t + e;
        const int query = q0 + c;
        const float lq = ls[c];
        const float l = query >= sq || lq == -INFINITY ? INFINITY : lq;
        dl[n][e] = dls[c];
        float p_lo = expf(fmaf(s[n][e] + s2[n][e], scale, -l));
        float p_hi = expf(fmaf(s[n][2 + e] + s2[n][2 + e], scale, -l));
        if (edge) {
          if (key_lo > query) p_lo = 0.f;
          if (key_hi > query) p_hi = 0.f;
        }
        s[n][e] = p_lo;
        s[n][2 + e] = p_hi;
      }
    }
    uint32_t xh[NT][4], xl[NT][4];
    c_to_a<NT>(s, xh, xl);
    mma_cols<D, NT>(dva, xh, xl, dob + 2 * t * R + g);  // dv += P^T dO

    float dp[NT][4], dp2[NT][4];
    mma_rows<D, NT>(dp, dp2, va, dob + g * R + t);  // dP^T = V dO^T
    const float ds_scale =
        (FLASH_BWD_TF32_PLANT == 2 && q0 + N >= sq) ? 1.01f * scale : scale;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = s[n][e] * (dp[n][e] + dp2[n][e] - dl[n][e]) * ds_scale;
        s[n][2 + e] =
            s[n][2 + e] * (dp[n][2 + e] + dp2[n][2 + e] - dl[n][e]) *
            ds_scale;
      }
    }
    c_to_a<NT>(s, xh, xl);
    mma_cols<D, NT>(dka, xh, xl, qb + 2 * t * R + g);  // dk += dS^T Q
  }
  cp_async_wait_all();  // the last (empty) group
  store_f32_rows<D>(dk + kv_off, kv_row, dka, key_lo, sk, t);
  store_f32_rows<D>(dv + kv_off, kv_row, dva, key_lo, sk, t);
}

// ---------------------------------------------------------------------------
// 16-bit (bf16 or f16, T) on the tensor cores. Fragment layouts are the
// PTX ISA's for
// mma.m16n8k16 (g = lane / 4, t = lane % 4; the lower half of a register
// holds the lower column or k index):
//   A (16x16): reg0 = A[g][2t..2t+1], reg1 = A[g+8][2t..], reg2 =
//              A[g][2t+8..], reg3 = A[g+8][2t+8..]
//   B (16x8):  reg0 = B[2t..2t+1][g], reg1 = B[2t+8..2t+9][g]
//   C (16x8):  c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// Two 16x8 C tiles side by side are one A fragment of the next product,
// so P and dS go from accumulators to operands without shared memory.

// Four 8x8 16-bit matrices from shared memory, one per 8 lanes' row
// addresses (lane l gives row l % 8 of matrix l / 8). Plain: register i
// of lane l holds row l / 4, columns 2 (l % 4) .. + 1 of matrix i, an A
// or B fragment of rows stored along k. .trans: register i holds rows
// 2 (l % 4) .. + 1 of column l / 4, the B fragment of a tile stored with
// k along its rows.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4],
                                              const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// four [64][d + 8] 16-bit tiles, then two [64] f32 rows
constexpr size_t tc_smem_bytes(int d) {
  return 4 * (size_t)kBQ * (d + 8) * 2 +
         2 * (size_t)kBQ * sizeof(float);
}

// rows [r0, r0 + 64) of a [rows, stride] 16-bit matrix into shared memory
// [64][d + 8], 16 bytes per load; rows at or past n_rows are zeros
template <int D, typename T>
__device__ __forceinline__ void stage_rows(T* dst,
                                           const T* src,
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

// x += A1 B1^T and y += A2 B2^T, [16 x 32] each: a1/a2 point at the
// warp's 16 A rows, b1/b2 at the 32 B rows, all [.][D + 8] tiles with
// the product's k (head dim) along their rows.
template <int D, typename T>
__device__ __forceinline__ void rows_times_rows(
    float x[4][4], float y[4][4], const T* a1,
    const T* b1, const T* a2,
    const T* b2, int lane) {
  constexpr int S = D + 8;
  // A: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15), in fragment order
  const int ao = (lane & 15) * S + (lane >> 4) * 8;
  // B: (8-row tile n, k 0-7), (n, k 8-15), (n + 1, k 0-7), (n + 1, k 8-15)
  const int bo = ((lane & 7) + (lane >> 4) * 8) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t p[4], r[4], b[4];
    ldsm_x4(p, a1 + ao + kk);
    ldsm_x4(r, a2 + ao + kk);
#pragma unroll
    for (int n = 0; n < 4; n += 2) {
      ldsm_x4(b, b1 + n * 8 * S + bo + kk);
      hopper::mma16816<T>(x[n], p[0], p[1], p[2], p[3], b[0], b[1]);
      hopper::mma16816<T>(x[n + 1], p[0], p[1], p[2], p[3], b[2], b[3]);
      ldsm_x4(b, b2 + n * 8 * S + bo + kk);
      hopper::mma16816<T>(y[n], r[0], r[1], r[2], r[3], b[0], b[1]);
      hopper::mma16816<T>(y[n + 1], r[0], r[1], r[2], r[3], b[2], b[3]);
    }
  }
}

// acc[16 x D] += A[16 x 32] M[32 x D], A given as the 4 accumulator tiles
// x[n] (keys or queries n * 8 ..), M the 32 rows starting at m of a
// [.][D + 8] tile stored with k along its rows (B through ldmatrix.trans)
template <int D, typename T>
__device__ __forceinline__ void acc_times_rows(float acc[D / 8][4],
                                               const float x[4][4],
                                               const T* m,
                                               int lane) {
  constexpr int S = D + 8;
  // matrices (k 0-7, cols j), (k 8-15, cols j), (k 0-7, j + 1), (k 8-15,
  // j + 1): registers 0, 1 are column tile j's fragment, 2, 3 tile j + 1's
  const T* mo =
      m + ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint32_t a0 = hopper::pack2<T>(x[2 * ks][0], x[2 * ks][1]);
    const uint32_t a1 = hopper::pack2<T>(x[2 * ks][2], x[2 * ks][3]);
    const uint32_t a2 = hopper::pack2<T>(x[2 * ks + 1][0], x[2 * ks + 1][1]);
    const uint32_t a3 = hopper::pack2<T>(x[2 * ks + 1][2], x[2 * ks + 1][3]);
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, mo + ks * 16 * S + j * 8);
      hopper::mma16816<T>(acc[j], a0, a1, a2, a3, b[0], b[1]);
      hopper::mma16816<T>(acc[j + 1], a0, a1, a2, a3, b[2], b[3]);
    }
  }
}

// One block of 4 warps per (b * heads, 64-row query tile); warp w owns
// query rows 16 w .. 16 w + 15 and accumulates their dq.
template <int D, typename T>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dq_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq,
    int heads, int kv_heads, int sq, int sk, float scale, int causal) {
  constexpr int S = D + 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + kBQ * S;
  T* k_s = do_s + kBQ * S;
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
  const size_t q_off = (size_t)bi * sq * q_row + (size_t)hh * D;
  const T* k_b = k + (size_t)bi * sk * kv_row + (size_t)kvh * D;
  const T* v_b = v + (size_t)bi * sk * kv_row + (size_t)kvh * D;

  stage_rows<D, T>(q_s, q + q_off, q_row, q0, sq);
  stage_rows<D, T>(do_s, dout + q_off, q_row, q0, sq);

  const int r_lo = q0 + warp * 16 + g;  // this lane's two query rows
  const int r_hi = r_lo + 8;
  const float lse_lo = row_lse(lse, (size_t)bh * sq, r_lo, sq);
  const float lse_hi = row_lse(lse, (size_t)bh * sq, r_hi, sq);
  const float dl_lo = r_lo < sq ? delta[(size_t)bh * sq + r_lo] : 0.f;
  const float dl_hi = r_hi < sq ? delta[(size_t)bh * sq + r_hi] : 0.f;
  const T* qw = q_s + warp * 16 * S;   // the warp's rows
  const T* dw = do_s + warp * 16 * S;

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D, T>(k_s, k_b, kv_row, k0, sk);
    stage_rows<D, T>(v_s, v_b, kv_row, k0, sk);
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < kBK; kc += 32) {  // 32 keys at a time
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] =
            dp[n][2] = dp[n][3] = 0.f;
      rows_times_rows<D, T>(s, dp, qw, k_s + kc * S, dw, v_s + kc * S, lane);
      // s becomes dS = P (dP - delta) scale
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + kc + n * 8 + 2 * t + e;
          const bool ok = col < sk;
          const float p_lo = ok && (!causal || col <= r_lo)
                                 ? expf(s[n][e] * scale - lse_lo) : 0.f;
          const float p_hi = ok && (!causal || col <= r_hi)
                                 ? expf(s[n][2 + e] * scale - lse_hi) : 0.f;
          s[n][e] = p_lo * (dp[n][e] - dl_lo) * scale;
          s[n][2 + e] = p_hi * (dp[n][2 + e] - dl_hi) * scale;
        }
      }
      acc_times_rows<D, T>(acc, s, k_s + kc * S, lane);
    }
  }

  T* dq_b = dq + q_off;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = j * 8 + 2 * t;
    if (r_lo < sq) {
      hopper::store2(dq_b + (size_t)r_lo * q_row + c, acc[j][0], acc[j][1]);
    }
    if (r_hi < sq) {
      hopper::store2(dq_b + (size_t)r_hi * q_row + c, acc[j][2], acc[j][3]);
    }
  }
}

// One block of 4 warps per (b * kv_heads, 64-key tile); warp w owns keys
// 16 w .. 16 w + 15 and accumulates their dk and dv over every query head
// of the group.
template <int D, typename T>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dkv_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int heads, int kv_heads, int sq, int sk,
    float scale, int causal) {
  constexpr int S = D + 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + kBK * S;
  T* q_s = v_s + kBK * S;
  T* do_s = q_s + kBQ * S;
  float* lse_s = reinterpret_cast<float*>(do_s + kBQ * S);
  float* dl_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int bkv = blockIdx.y;
  const int bi = bkv / kv_heads;
  const int kvh = bkv - bi * kv_heads;
  const int group = heads / kv_heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  const size_t q_row = (size_t)heads * D;
  const size_t kv_row = (size_t)kv_heads * D;
  const size_t kv_off = (size_t)bi * sk * kv_row + (size_t)kvh * D;
  stage_rows<D, T>(k_s, k + kv_off, kv_row, k0, sk);
  stage_rows<D, T>(v_s, v + kv_off, kv_row, k0, sk);

  const int kr_lo = k0 + warp * 16 + g;  // this lane's two key rows
  const int kr_hi = kr_lo + 8;
  const T* kw = k_s + warp * 16 * S;   // the warp's keys
  const T* vw = v_s + warp * 16 * S;

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }

  // causal: the queries that see any key of this tile start at k0
  const int q_start = causal ? k0 : 0;
  for (int hh = kvh * group; hh < (kvh + 1) * group; ++hh) {
    const size_t q_off = (size_t)bi * sq * q_row + (size_t)hh * D;
    const size_t l_off = ((size_t)bi * heads + hh) * sq;
    for (int q0 = q_start; q0 < sq; q0 += kBQ) {
      __syncthreads();  // the previous tile's readers are done
      stage_rows<D, T>(q_s, q + q_off, q_row, q0, sq);
      stage_rows<D, T>(do_s, dout + q_off, q_row, q0, sq);
      for (int r = threadIdx.x; r < kBQ; r += kTcThreads) {
        const int row = q0 + r;
        lse_s[r] = row_lse(lse, l_off, row, sq);
        dl_s[r] = row < sq ? delta[l_off + row] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int qc = 0; qc < kBQ; qc += 32) {  // 32 queries at a time
        float st[4][4], dpt[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          st[n][0] = st[n][1] = st[n][2] = st[n][3] = dpt[n][0] =
              dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
        rows_times_rows<D, T>(st, dpt, kw, q_s + qc * S, vw, do_s + qc * S,
                           lane);
        // st becomes P^T, dpt becomes dS^T
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = qc + n * 8 + 2 * t + e;
            const int col = q0 + qi;
            const float l = lse_s[qi];
            const float dl = dl_s[qi];
            const float p_lo = kr_lo < sk && (!causal || kr_lo <= col)
                                   ? expf(st[n][e] * scale - l) : 0.f;
            const float p_hi = kr_hi < sk && (!causal || kr_hi <= col)
                                   ? expf(st[n][2 + e] * scale - l) : 0.f;
            st[n][e] = p_lo;
            st[n][2 + e] = p_hi;
            dpt[n][e] = p_lo * (dpt[n][e] - dl) * scale;
            dpt[n][2 + e] = p_hi * (dpt[n][2 + e] - dl) * scale;
          }
        }
        acc_times_rows<D, T>(dva, st, do_s + qc * S, lane);
        acc_times_rows<D, T>(dka, dpt, q_s + qc * S, lane);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = j * 8 + 2 * t;
    if (kr_lo < sk) {
      const size_t at = kv_off + (size_t)kr_lo * kv_row + c;
      hopper::store2(dk + at, dka[j][0], dka[j][1]);
      hopper::store2(dv + at, dva[j][0], dva[j][1]);
    }
    if (kr_hi < sk) {
      const size_t at = kv_off + (size_t)kr_hi * kv_row + c;
      hopper::store2(dk + at, dka[j][2], dka[j][3]);
      hopper::store2(dv + at, dva[j][2], dva[j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit (T) on Hopper, d in {64, 128}: wgmma fed by TMA through mbarrier
// rings
// (hopper.cuh), as the forward's flash_fwd_wgmma_kernel.
//
// Both kernels: warpgroups 0 and 1 are consumers, each owning 64 rows of
// the block's 128 (query rows for dq, keys for dk/dv). Tiles are read
// with 4-D tensor maps over (d, heads, seq, batch) of the [b, s, h, d]
// layout, 64-wide boxes along d (two at d = 128): a box never crosses a
// batch, rows past the sequence read as zeros, and the TMA stores of dq,
// dk and dv clip them. Every accumulator is f32; P and dS are rounded to
// T only as the register A operand of the second products (two
// adjacent n8 column blocks of an accumulator are one k16 A fragment).
// Scores run in base 2: P = 2^(S scale log2e - lse log2e), one FMA and
// one ex2. The softmax scale of dS is applied once, to dq and dk at the
// end.
//
//  * flash_bwd_dq_wgmma_kernel: one block per (b * heads, 128 query
//    rows). Q and dO are loaded once; K and V tiles of kBK keys stream
//    through a ring of kDqStages stages. Prologue: each consumer lane
//    reads its two rows of O and dO from device memory (a quarter of d
//    each, summed over the quad) and computes delta = rowsum(dO O) in
//    f32; it keeps it in registers and writes it, beside lse in base 2
//    (+inf where a row has no mass or lies past sq), to the rows buffer
//    the dk/dv kernel reads next on the stream. Per key tile:
//      S  = Q K^T, dP = dO V^T   wgmma, A and B from shared memory, both
//                                 K-major (d contiguous);
//      dS = P (dP - delta)       in registers, masked only on the causal
//                                 diagonal and the ragged key tail;
//      dq += dS K                 register A, B = K MN-major (the
//                                 transpose bit).
//    A warpgroup computes up to its own last causal key tile.
//  * flash_bwd_dkv_wgmma_kernel: one block per (b * kv_heads, 128 keys).
//    K and V stay in shared memory; the Q and dO tiles of kBM query rows
//    of every query head of the GQA group stream through a ring of
//    kDkvStages stages, each with its rows' (lse, delta) pairs (one bulk
//    copy). Per query tile:
//      S^T = K Q^T, dP^T = V dO^T   shared-memory A and B, K-major, so
//                                   that P^T and dS^T land in the
//                                   accumulator layout wgmma takes as A;
//      dV += P^T dO, dK += dS^T Q   register A, B = dO and Q MN-major.
//    The group sum stays in the registers: no atomics, deterministic.
//    Keys past sk compute what the store then clips.
// Both have 256 threads, the two consumer warpgroups; thread 0 also
// issues every TMA load, a ring's tiles one stage ahead of the
// consumers.
//
// Block order: the heaviest causal blocks first (the last query tiles for
// dq, the first key tiles for dk/dv), inside chunks of (batch, head)
// pairs whose streamed operands (K and V for dq; Q and dO of a group for
// dk/dv) take ~8 MB, as the forward orders its blocks: the tiles in
// flight stay in L2.
//
// Registers: ptxas gives a thread at most 65536 / (block threads rounded
// up to whole warpgroups) registers, setmaxnreg.inc notwithstanding: 168
// with a producer warp or warpgroup beside the consumers, 255 without.
// The dq consumer holds S and dP (64 each at 128 keys), dq (64) and dS;
// a dk/dv consumer dK and dV (128 at d 128) beside S^T and dP^T (32 each
// at kBM = 64): held to 168 it spilled ~800 bytes. A product left in flight while
// other registers are computed made ptxas serialize every wgmma (its
// warning C7515), so each product is waited for before the registers it
// feeds are touched; the other warpgroup's products fill the tensor
// cores meanwhile.

constexpr int kHRows = 128;  // rows of a block: dq's queries, dk/dv's keys
constexpr float kLog2e = 1.4426950408889634f;
// both kernels: consumer warpgroups 0 and 1 only, thread 0 also issuing
// the loads, so that ptxas gives each thread up to 255 registers (see
// "Registers" above)
constexpr int kBwdThreads = 256;
// depth of the dq kernel's K/V ring: two 64 KB stages at d 128 beside Q
// and dO (a third would not fit)
constexpr int kDqStages = 2;
// depth of the dk/dv kernel's Q/dO ring
constexpr int kDkvStages = 2;  // sweep: flash_bwd_stages
static_assert(kDqStages >= 2 && kDkvStages >= 2,
              "thread 0 loads a ring's tiles one stage ahead");

template <int D>
struct DqCfg {
  static constexpr int kBoxes = D / 64;  // 64-wide boxes along d
  // keys per K/V tile: S, dP and dq take 64 + 64 + 64 registers a thread
  // at d 128
  static constexpr int kBK = 128;  // sweep: flash_bwd_dq_keys
  static constexpr int kQBox = kHRows * 128;  // bytes of a [128][64] box
  static constexpr int kKBox = kBK * 128;
  static constexpr int kQBytes = kBoxes * kQBox;  // Q (and dO)
  static constexpr int kKBytes = kBoxes * kKBox;  // one K (or V) tile
  static constexpr int kStageBytes = 2 * kKBytes;  // K, then V
  static constexpr int kTiles = 2 * kQBytes + kDqStages * kStageBytes;
  // alignment slack, tiles, q_full + full/empty per stage
  static constexpr int kSmem = 1024 + kTiles + (1 + 2 * kDqStages) * 8;
};

template <int D>
struct DkvCfg {
  static constexpr int kBoxes = D / 64;
  // query rows per Q/dO tile: the n of S^T and dP^T, the k of dV and dK
  // (chip_sweeps.py flash_bwd_tile: 128 rows cost 17 % at d 128, where
  // S^T and dP^T would take 128 registers, and gain 8 % with GQA at d 64)
  static constexpr int kBM = D == 128 ? 64 : 128;  // sweep: flash_bwd_dkv_rows
  static constexpr int kKBox = kHRows * 128;
  static constexpr int kKBytes = kBoxes * kKBox;  // K (or V)
  static constexpr int kQBox = kBM * 128;
  static constexpr int kQBytes = kBoxes * kQBox;  // one Q (or dO) tile
  static constexpr int kStageBytes = 2 * kQBytes;  // Q, then dO
  static constexpr int kRowBytes = kBM * 8;  // (lse base 2, delta) a row
  static constexpr int kTiles = 2 * kKBytes + kDkvStages * kStageBytes;
  // alignment slack, tiles, rows per stage, kv_full + full/empty
  static constexpr int kSmem =
      1024 + kTiles + kDkvStages * kRowBytes + (1 + 2 * kDkvStages) * 8;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// lse in base 2 for the scores' exponent; +inf (no probability mass) for
// a row whose every key is masked (lse = -inf) or past the sequence
__device__ __forceinline__ float row_lse2(const float* lse, size_t base,
                                          int row, int n) {
  if (row >= n) return INFINITY;
  const float x = lse[base + row];
  return x == -INFINITY ? INFINITY : x * kLog2e;
}

// sum over part `part` (of 4) of d of a[row] * b[row], in f32; 0 past n
template <int D, typename T>
__device__ __forceinline__ float row_dot(const T* a,
                                         const T* b, size_t base,
                                         size_t stride, int row, int n,
                                         int part) {
  if (row >= n) return 0.f;
  constexpr int kPart = D / 4;
  const size_t at = base + (size_t)row * stride + part * kPart;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kPart; i += 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + at + i);
    const uint4 y = *reinterpret_cast<const uint4*>(b + at + i);
    const uint32_t* xp = reinterpret_cast<const uint32_t*>(&x);
    const uint32_t* yp = reinterpret_cast<const uint32_t*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 xf = hopper::unpack2<T>(xp[e]);
      const float2 yf = hopper::unpack2<T>(yp[e]);
      acc = fmaf(xf.x, yf.x, acc);
      acc = fmaf(xf.y, yf.y, acc);
    }
  }
  return acc;
}

// the block's (batch x head, row tile) in the order described above:
// chunk c of `chunk` heads, and inside it tile level `level` of every
// head before level + 1 (level 0 is the heaviest)
struct BlockSlot {
  int head, level;
};
__device__ __forceinline__ BlockSlot block_slot(int n_tiles, int n_heads,
                                                int chunk) {
  const int c = (int)(blockIdx.x / ((unsigned)chunk * n_tiles));
  const int r = (int)(blockIdx.x - (unsigned)c * chunk * n_tiles);
  const int in_chunk = min(chunk, n_heads - c * chunk);
  return {c * chunk + r % in_chunk, r / in_chunk};
}

// a warpgroup's 64 rows of an f32 accumulator [64 x D], times `mul`, as
// T into the rows of `half` (its 64 rows inside boxes of `box_bytes`
// each, 128-byte swizzled as TMA reads them), then stored by TMA
// to coordinates (., c1, c2, c3) of `map`; the warpgroup's thread 0
// waits until the store has read shared memory
template <int D, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float mul, unsigned char* half,
                                           int box_bytes,
                                           const CUtensorMap* map, int c1,
                                           int c2, int c3, int wg) {
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int r = (tid >> 5) * 16 + (lane >> 2);  // rows r and r + 8
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    // 16-byte chunk j % 8 of its 128-byte row, swizzled by row % 8
    unsigned char* box = half + (j >> 3) * box_bytes;
    const int chunk = ((j & 7) ^ (r & 7)) * 16 + 4 * (lane & 3);
    *reinterpret_cast<uint32_t*>(box + r * 128 + chunk) =
        hopper::pack2<T>(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    *reinterpret_cast<uint32_t*>(box + (r + 8) * 128 + chunk) =
        hopper::pack2<T>(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
  hopper::fence_proxy_async();
  hopper::named_bar_sync(1 + wg, 128);
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < D / 64; ++b) {
      hopper::tma_store_4d(map, half + b * box_bytes, 64 * b, c1, c2, c3);
    }
    hopper::bulk_commit();
    hopper::bulk_wait<0>();
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap dq_map,
    const T* __restrict__ out,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float2* __restrict__ rows, int heads, int kv_heads, int sq, int sk,
    float scale, int causal, int n_bh, int chunk) {
  using C = DqCfg<D>;
  constexpr int BK = C::kBK;
  extern __shared__ __align__(1024) unsigned char dq_smem[];
  unsigned char* q_s = align1024(dq_smem);
  unsigned char* do_s = q_s + C::kQBytes;
  unsigned char* ring = do_s + C::kQBytes;  // per stage: K tile, V tile
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(ring + kDqStages * C::kStageBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kDqStages;

  const int n_qt = (sq + kHRows - 1) / kHRows;
  const BlockSlot slot = block_slot(n_qt, n_bh, chunk);
  const int bh = slot.head;
  const int q0 = (n_qt - 1 - slot.level) * kHRows;  // last tiles first
  const int bi = bh / heads;
  const int hh = bh - bi * heads;
  const int kvh = hh / (heads / kv_heads);
  const int k_end = causal ? min(sk, q0 + kHRows) : sk;
  const int n_kt = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;

  // thread 0 also produces: K and V tile t into ring stage t % kDqStages,
  // once both warpgroups have released the tile that stage held before
  auto load_tile = [&](int t) {
    const int st = t % kDqStages;
    hopper::mbar_wait(&empty[st], ((t / kDqStages) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&full[st], C::kStageBytes);
    unsigned char* kb = ring + st * C::kStageBytes;
#pragma unroll
    for (int j = 0; j < C::kBoxes; ++j) {
      hopper::tma_load_4d(kb + j * C::kKBox, &k_map, &full[st], 64 * j, kvh,
                          t * BK, bi);
      hopper::tma_load_4d(kb + C::kKBytes + j * C::kKBox, &v_map, &full[st],
                          64 * j, kvh, t * BK, bi);
    }
  };
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(q_full, 2 * C::kQBytes);
#pragma unroll
    for (int j = 0; j < C::kBoxes; ++j) {
      hopper::tma_load_4d(q_s + j * C::kQBox, &q_map, q_full, 64 * j, hh, q0,
                          bi);
      hopper::tma_load_4d(do_s + j * C::kQBox, &do_map, q_full, 64 * j, hh,
                          q0, bi);
    }
    for (int t = 0; t < kDqStages - 1 && t < n_kt; ++t) load_tile(t);
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float sl2 = scale * kLog2e;
  const int r_lo = q0 + wg * 64 + warp * 16 + (lane >> 2);  // this lane's
  const int r_hi = r_lo + 8;                                // two rows

  // delta = rowsum(dO O), while the producer's first loads are in flight;
  // it leaves beside lse in base 2 for the dk/dv kernel, one (lse, delta)
  // pair a row, every row of the block (past sq: +inf and 0)
  const size_t row_stride = (size_t)heads * D;
  const size_t base = (size_t)bi * sq * row_stride + (size_t)hh * D;
  float dl_lo = row_dot<D, T>(out, dout, base, row_stride, r_lo, sq, lane & 3);
  float dl_hi = row_dot<D, T>(out, dout, base, row_stride, r_hi, sq, lane & 3);
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, x);
    dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, x);
  }
  const float l_lo = row_lse2(lse, (size_t)bh * sq, r_lo, sq);
  const float l_hi = row_lse2(lse, (size_t)bh * sq, r_hi, sq);
  if ((lane & 3) == 0) {
    float2* rw = rows + (size_t)bh * n_qt * kHRows;
    rw[r_lo] = make_float2(l_lo, dl_lo);
    rw[r_hi] = make_float2(l_hi, dl_hi);
  }

  const unsigned char* q_wg = q_s + wg * 64 * 128;
  const unsigned char* do_wg = do_s + wg * 64 * 128;
  // causal: this warpgroup's rows see keys up to q0 + 64 wg + 63
  const int wg_end = causal ? min(sk, q0 + wg * 64 + 64) : sk;
  const int wg_kt = (wg_end + BK - 1) / BK;
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  // per key tile: S and dP, dS in registers, dq += dS K, each product
  // waited for before the next step (see "Registers" above)
  // every warpgroup waits for, and releases, each of the block's tiles,
  // computing on those its rows see
  hopper::mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    if (threadIdx.x == 0 && kt + kDqStages - 1 < n_kt) {
      load_tile(kt + kDqStages - 1);
    }
    hopper::mbar_wait(&full[stage], phase);
    if (kt >= wg_kt) {
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (++stage == kDqStages) {
        stage = 0;
        phase ^= 1;
      }
      continue;
    }
    const unsigned char* kb = ring + stage * C::kStageBytes;
    const unsigned char* vb = kb + C::kKBytes;
    float s[BK / 2], dp[BK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * C::kQBox + (kk & 3) * 32;
      const int koff = (kk >> 2) * C::kKBox + (kk & 3) * 32;
      hopper::wgmma_ss<BK, 0, T>(s, hopper::desc_k_major(q_wg + off),
                              hopper::desc_k_major(kb + koff), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * C::kQBox + (kk & 3) * 32;
      const int koff = (kk >> 2) * C::kKBox + (kk & 3) * 32;
      hopper::wgmma_ss<BK, 0, T>(dp, hopper::desc_k_major(do_wg + off),
                              hopper::desc_k_major(vb + koff), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // dS = P (dP - delta) as 16-bit A fragments; only the ragged key tail
    // and the causal diagonal are masked
    const int k0 = kt * BK;
    const bool edge =
        k0 + BK > sk || (causal && k0 + BK - 1 > q0 + wg * 64);
    uint32_t ds[BK / 16][4];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // elements 0, 1, 4, 5 are row lo; 2, 3, 6, 7 row hi
        const bool hi = (e & 2) != 0;
        float p = fast_exp2(fmaf(s[8 * ks + e], sl2, hi ? -l_hi : -l_lo));
        if (edge) {
          const int col = k0 + 16 * ks + 8 * (e >> 2) + 2 * (lane & 3) +
                          (e & 1);
          if (col >= sk || (causal && col > (hi ? r_hi : r_lo))) p = 0.f;
        }
        x[e] = p * (dp[8 * ks + e] - (hi ? dl_hi : dl_lo));
      }
      ds[ks][0] = hopper::pack2<T>(x[0], x[1]);
      ds[ks][1] = hopper::pack2<T>(x[2], x[3]);
      ds[ks][2] = hopper::pack2<T>(x[4], x[5]);
      ds[ks][3] = hopper::pack2<T>(x[6], x[7]);
    }

    hopper::fence_regs(dq);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      hopper::wgmma_rs<D, 1, T>(dq, ds[ks],
                             hopper::desc_mn_major(kb + ks * 2048, C::kKBox),
                             1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    if (++stage == kDqStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // dq scale, through this warpgroup's rows of the Q tile (its last
  // reader was this warpgroup's last S product)
  store_rows<D, T>(dq, scale, q_s + wg * 64 * 128, C::kQBox, &dq_map, hh,
                q0 + wg * 64, bi, wg);
}

template <int D, typename T>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const __grid_constant__ CUtensorMap dk_map,
    const __grid_constant__ CUtensorMap dv_map,
    const float2* __restrict__ rows, int heads, int kv_heads, int sq,
    int sk, float scale, int causal, int n_bkv, int chunk) {
  using C = DkvCfg<D>;
  constexpr int BM = C::kBM;
  extern __shared__ __align__(1024) unsigned char dkv_smem[];
  unsigned char* k_s = align1024(dkv_smem);
  unsigned char* v_s = k_s + C::kKBytes;
  unsigned char* ring = v_s + C::kKBytes;  // per stage: Q tile, dO tile
  float2* rows_s =
      reinterpret_cast<float2*>(ring + kDkvStages * C::kStageBytes);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows_s + kDkvStages * BM);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kDkvStages;

  const int n_kt = (sk + kHRows - 1) / kHRows;
  const BlockSlot slot = block_slot(n_kt, n_bkv, chunk);
  const int bkv = slot.head;
  const int k0 = slot.level * kHRows;  // first key tiles first
  const int bi = bkv / kv_heads;
  const int kvh = bkv - bi * kv_heads;
  const int group = heads / kv_heads;
  const int sq_pad = (sq + kHRows - 1) / kHRows * kHRows;  // rows' length
  // causal: the queries that see a key of this block start at k0
  const int q_first = causal ? k0 / BM * BM : 0;
  const int n_qt = q_first < sq ? (sq - q_first + BM - 1) / BM : 0;
  const int n_tiles = group * n_qt;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // thread 0 also produces: tile t (of the group's query heads, then of
  // their query tiles) into ring stage t % kDkvStages, once both
  // warpgroups have released the tile that stage held before
  auto load_tile = [&](int t) {
    const int st = t % kDkvStages;
    hopper::mbar_wait(&empty[st], ((t / kDkvStages) & 1) ^ 1);
    const int hh = kvh * group + t / n_qt;
    const int qs = q_first + (t % n_qt) * BM;
    hopper::mbar_arrive_expect_tx(&full[st],
                                  C::kStageBytes + C::kRowBytes);
    unsigned char* qb = ring + st * C::kStageBytes;
#pragma unroll
    for (int j = 0; j < C::kBoxes; ++j) {
      hopper::tma_load_4d(qb + j * C::kQBox, &q_map, &full[st], 64 * j, hh,
                          qs, bi);
      hopper::tma_load_4d(qb + C::kQBytes + j * C::kQBox, &do_map,
                          &full[st], 64 * j, hh, qs, bi);
    }
    hopper::bulk_load(rows_s + st * BM,
                      rows + ((size_t)bi * heads + hh) * sq_pad + qs,
                      C::kRowBytes, &full[st]);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_arrive_expect_tx(kv_full, 2 * C::kKBytes);
#pragma unroll
    for (int j = 0; j < C::kBoxes; ++j) {
      hopper::tma_load_4d(k_s + j * C::kKBox, &k_map, kv_full, 64 * j, kvh,
                          k0, bi);
      hopper::tma_load_4d(v_s + j * C::kKBox, &v_map, kv_full, 64 * j, kvh,
                          k0, bi);
    }
    for (int t = 0; t < kDkvStages - 1 && t < n_tiles; ++t) load_tile(t);
  }

  // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float sl2 = scale * kLog2e;
  const int k_wg = k0 + wg * 64;
  const int kr_lo = k_wg + warp * 16 + (lane >> 2);  // this lane's keys
  const int kr_hi = kr_lo + 8;
  const unsigned char* k_wg_s = k_s + wg * 64 * 128;
  const unsigned char* v_wg_s = v_s + wg * 64 * 128;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_tiles; ++it) {
    if (threadIdx.x == 0 && it + kDkvStages - 1 < n_tiles) {
      load_tile(it + kDkvStages - 1);
    }
    const int qs = q_first + (it % n_qt) * BM;
    hopper::mbar_wait(&full[stage], phase);
    // causal: a tile whose every query precedes these keys adds nothing
    if (!causal || qs + BM - 1 >= k_wg) {
      const unsigned char* qb = ring + stage * C::kStageBytes;
      const unsigned char* dob = qb + C::kQBytes;
      const float2* rw = rows_s + stage * BM;
      float st[BM / 2], dpt[BM / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int aoff = (kk >> 2) * C::kKBox + (kk & 3) * 32;
        const int boff = (kk >> 2) * C::kQBox + (kk & 3) * 32;
        hopper::wgmma_ss<BM, 0, T>(st, hopper::desc_k_major(k_wg_s + aoff),
                                hopper::desc_k_major(qb + boff), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int aoff = (kk >> 2) * C::kKBox + (kk & 3) * 32;
        const int boff = (kk >> 2) * C::kQBox + (kk & 3) * 32;
        hopper::wgmma_ss<BM, 0, T>(dpt, hopper::desc_k_major(v_wg_s + aoff),
                                hopper::desc_k_major(dob + boff), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);

      // P^T and dS^T as 16-bit A fragments; the causal mask only where
      // some query of the tile precedes some key of the warpgroup
      const bool edge = causal && qs < k_wg + 63;
      uint32_t pt[BM / 16][4], dst[BM / 16][4];
#pragma unroll
      for (int ks = 0; ks < BM / 16; ++ks) {
        float x[8], y[8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // columns (queries) 16 ks + 8 h + 2 (lane % 4) + {0, 1}: their
          // (lse, delta) pairs
          const int col = 16 * ks + 8 * h + 2 * (lane & 3);
          const float4 ld = *reinterpret_cast<const float4*>(rw + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // element e: 0, 1 key lo; 2, 3 key hi
            const int i = 8 * ks + 4 * h + e;
            float p = fast_exp2(fmaf(st[i], sl2, (e & 1) ? -ld.z : -ld.x));
            if (edge && qs + col + (e & 1) < ((e & 2) ? kr_hi : kr_lo)) {
              p = 0.f;
            }
            x[4 * h + e] = p;
            y[4 * h + e] = p * (dpt[i] - ((e & 1) ? ld.w : ld.y));
          }
        }
        pt[ks][0] = hopper::pack2<T>(x[0], x[1]);
        pt[ks][1] = hopper::pack2<T>(x[2], x[3]);
        pt[ks][2] = hopper::pack2<T>(x[4], x[5]);
        pt[ks][3] = hopper::pack2<T>(x[6], x[7]);
        dst[ks][0] = hopper::pack2<T>(y[0], y[1]);
        dst[ks][1] = hopper::pack2<T>(y[2], y[3]);
        dst[ks][2] = hopper::pack2<T>(y[4], y[5]);
        dst[ks][3] = hopper::pack2<T>(y[6], y[7]);
      }

      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BM / 16; ++ks) {
        hopper::wgmma_rs<D, 1, T>(
            dv, pt[ks], hopper::desc_mn_major(dob + ks * 2048, C::kQBox), 1);
      }
#pragma unroll
      for (int ks = 0; ks < BM / 16; ++ks) {
        hopper::wgmma_rs<D, 1, T>(
            dk, dst[ks], hopper::desc_mn_major(qb + ks * 2048, C::kQBox), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
    }
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    if (++stage == kDkvStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // dk scale and dv, through this warpgroup's rows of K and V
  store_rows<D, T>(dk, scale, k_s + wg * 64 * 128, C::kKBox, &dk_map, kvh,
                k_wg, bi, wg);
  store_rows<D, T>(dv, 1.f, v_s + wg * 64 * 128, C::kKBox, &dv_map, kvh, k_wg,
                bi, wg);
}

// a 16-bit [batch, seq, heads, D] tensor map with boxes of `rows` x 64
template <int D, typename T>
int seq_map(CUtensorMap* map, const void* base, int batch, int seq,
            int heads, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)seq * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return hopper::encode_16bit_map<T>(map, base, 4, dims, strides, box);
}

// (batch, head) pairs per chunk of the block order, as the forward's:
// one chunk where every head's streamed operands (`per_head` bytes each)
// fit in 24 MB, else chunks of ~8 MB
inline int chunk_heads(long long per_head, int n_heads) {
  const long long chunk = per_head * n_heads <= (24LL << 20)
                              ? n_heads : (8LL << 20) / per_head;
  return (int)(chunk < 1 ? 1 : chunk > n_heads ? n_heads : chunk);
}

template <int D, typename T>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* out, const float* lse,
                    float2* rows, void* dq, int batch, int heads,
                    int kv_heads, int sq, int sk, float scale, int causal,
                    cudaStream_t stream) {
  using C = DqCfg<D>;
  CUtensorMap q_map, do_map, k_map, v_map, dq_map;
  int err = seq_map<D, T>(&q_map, q, batch, sq, heads, kHRows);
  if (!err) err = seq_map<D, T>(&do_map, dout, batch, sq, heads, kHRows);
  if (!err) err = seq_map<D, T>(&k_map, k, batch, sk, kv_heads, C::kBK);
  if (!err) err = seq_map<D, T>(&v_map, v, batch, sk, kv_heads, C::kBK);
  if (!err) err = seq_map<D, T>(&dq_map, dq, batch, sq, heads, 64);
  if (err) return err;
  auto kernel = flash_bwd_dq_wgmma_kernel<D, T>;
  const cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (cerr != cudaSuccess) return (int)cerr;
  const int n_bh = batch * heads;
  // K and V of a query head (a GQA group shares them), 2 bytes each
  const int chunk = chunk_heads(4LL * sk * D / (heads / kv_heads) + 1, n_bh);
  const long long blocks = (long long)((sq + kHRows - 1) / kHRows) * n_bh;
  kernel<<<(unsigned)blocks, kBwdThreads, C::kSmem, stream>>>(
      q_map, do_map, k_map, v_map, dq_map,
      static_cast<const T*>(out),
      static_cast<const T*>(dout), lse, rows, heads, kv_heads,
      sq, sk, scale, causal, n_bh, chunk);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float2* rows, void* dk,
                     void* dv, int batch, int heads, int kv_heads, int sq,
                     int sk, float scale, int causal, cudaStream_t stream) {
  using C = DkvCfg<D>;
  CUtensorMap q_map, do_map, k_map, v_map, dk_map, dv_map;
  int err = seq_map<D, T>(&q_map, q, batch, sq, heads, C::kBM);
  if (!err) err = seq_map<D, T>(&do_map, dout, batch, sq, heads, C::kBM);
  if (!err) err = seq_map<D, T>(&k_map, k, batch, sk, kv_heads, kHRows);
  if (!err) err = seq_map<D, T>(&v_map, v, batch, sk, kv_heads, kHRows);
  if (!err) err = seq_map<D, T>(&dk_map, dk, batch, sk, kv_heads, 64);
  if (!err) err = seq_map<D, T>(&dv_map, dv, batch, sk, kv_heads, 64);
  if (err) return err;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D, T>;
  const cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (cerr != cudaSuccess) return (int)cerr;
  const int n_bkv = batch * kv_heads;
  // Q and dO of every query head of a kv head's group, 2 bytes each
  const int chunk =
      chunk_heads(4LL * sq * D * (heads / kv_heads) + 1, n_bkv);
  const long long blocks = (long long)((sk + kHRows - 1) / kHRows) * n_bkv;
  kernel<<<(unsigned)blocks, kBwdThreads, C::kSmem, stream>>>(
      q_map, do_map, k_map, v_map, dk_map, dv_map, rows, heads, kv_heads,
      sq, sk, scale, causal, n_bkv, chunk);
  return (int)cudaGetLastError();
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_dq_tf32(const void* q, const void* k, const void* v,
                   const void* dout, const void* out, const float* lse,
                   float* delta, void* dq, int batch, int heads,
                   int kv_heads, int sq, int sk, float scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_bwd_dq_tf32_kernel<D>;
  constexpr int smem = BwdTf32Cfg<D>::kDqSmem;
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(out), lse, delta, static_cast<float*>(dq),
      heads, kv_heads, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tf32(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int batch, int heads, int kv_heads,
                    int sq, int sk, float scale, int causal,
                    cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_tf32_kernel<D>;
  constexpr int smem = BwdTf32Cfg<D>::kDkvSmem;
  const cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sk + kBQ - 1) / kBQ, batch * kv_heads);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), heads,
      kv_heads, sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int batch,
              int heads, int kv_heads, int sq, int sk, float scale,
              int causal, int dtype, cudaStream_t stream) {
  dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  if (dtype == 0) {
    auto kernel = flash_bwd_dq_kernel<D>;
    const size_t smem = dq_smem_floats(D) * sizeof(float);
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dq), heads, kv_heads, sq, sk, scale,
        causal);
  } else if constexpr (!std::is_same<T, float>::value) {
    auto kernel = flash_bwd_dq_tc_kernel<D, T>;
    const size_t smem = tc_smem_bytes(D);
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kTcThreads, smem, stream>>>(
        static_cast<const T*>(q),
        static_cast<const T*>(k),
        static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), heads, kv_heads, sq, sk, scale,
        causal);
  }
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int batch, int heads, int kv_heads, int sq, int sk,
               float scale, int causal, int dtype, cudaStream_t stream) {
  dim3 grid((sk + kBK - 1) / kBK, batch * kv_heads);
  if (dtype == 0) {
    auto kernel = flash_bwd_dkv_kernel<D>;
    const size_t smem = dkv_smem_floats(D) * sizeof(float);
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, static_cast<float*>(dk), static_cast<float*>(dv), heads,
        kv_heads, sq, sk, scale, causal);
  } else if constexpr (!std::is_same<T, float>::value) {
    auto kernel = flash_bwd_dkv_tc_kernel<D, T>;
    const size_t smem = tc_smem_bytes(D);
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kTcThreads, smem, stream>>>(
        static_cast<const T*>(q),
        static_cast<const T*>(k),
        static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dk), static_cast<T*>(dv),
        heads, kv_heads, sq, sk, scale, causal);
  }
  return (int)cudaGetLastError();
}

// the kernels of one element type T (float selects the FMA kernels or,
// with variant 2, the 3xTF32 kernels; bf16 and __half the mma.sync
// kernels or, with variant 1, the wgmma kernels)
template <typename T>
int dq_typed(const void* q, const void* k, const void* v, const void* dout,
             const void* out, const float* l, void* delta, void* dq,
             int batch, int heads, int kv_heads, int sq, int sk, int d,
             float scale, int causal, int variant, cudaStream_t s) {
  constexpr int dtype = std::is_same<T, float>::value ? 0 : 1;
  if (variant == 2) {
    if (dtype == 0 && sk > 0 && (d == 64 || d == 128)) {
      float* dl = static_cast<float*>(delta);
      return d == 64
                 ? launch_dq_tf32<64>(q, k, v, dout, out, l, dl, dq, batch,
                                      heads, kv_heads, sq, sk, scale, causal,
                                      s)
                 : launch_dq_tf32<128>(q, k, v, dout, out, l, dl, dq, batch,
                                       heads, kv_heads, sq, sk, scale,
                                       causal, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 0) {
    if (variant != 1 || dtype == 0 || sk == 0) {
      return (int)cudaErrorInvalidValue;
    }
    if constexpr (dtype == 1) {
      float2* rows = static_cast<float2*>(delta);
      if (d == 64) {
        return launch_dq_wgmma<64, T>(q, k, v, dout, out, l, rows, dq, batch,
                                      heads, kv_heads, sq, sk, scale, causal,
                                      s);
      }
      if (d == 128) {
        return launch_dq_wgmma<128, T>(q, k, v, dout, out, l, rows, dq,
                                       batch, heads, kv_heads, sq, sk, scale,
                                       causal, s);
      }
    }
    return (int)cudaErrorInvalidValue;
  }
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 16:
      return launch_dq<16, T>(q, k, v, dout, l, dl, dq, batch, heads,
                              kv_heads, sq, sk, scale, causal, dtype, s);
    case 32:
      return launch_dq<32, T>(q, k, v, dout, l, dl, dq, batch, heads,
                              kv_heads, sq, sk, scale, causal, dtype, s);
    case 64:
      return launch_dq<64, T>(q, k, v, dout, l, dl, dq, batch, heads,
                              kv_heads, sq, sk, scale, causal, dtype, s);
    case 128:
      return launch_dq<128, T>(q, k, v, dout, l, dl, dq, batch, heads,
                               kv_heads, sq, sk, scale, causal, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dkv_typed(const void* q, const void* k, const void* v, const void* dout,
              const float* l, const void* delta, void* dk, void* dv,
              int batch, int heads, int kv_heads, int sq, int sk, int d,
              float scale, int causal, int variant, cudaStream_t s) {
  constexpr int dtype = std::is_same<T, float>::value ? 0 : 1;
  if (variant == 2) {
    if (dtype == 0 && sq > 0 && (d == 64 || d == 128)) {
      const float* dl = static_cast<const float*>(delta);
      return d == 64
                 ? launch_dkv_tf32<64>(q, k, v, dout, l, dl, dk, dv, batch,
                                       heads, kv_heads, sq, sk, scale,
                                       causal, s)
                 : launch_dkv_tf32<128>(q, k, v, dout, l, dl, dk, dv, batch,
                                        heads, kv_heads, sq, sk, scale,
                                        causal, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (variant != 0) {
    if (variant != 1 || dtype == 0 || sq == 0) {
      return (int)cudaErrorInvalidValue;
    }
    if constexpr (dtype == 1) {
      const float2* rows = static_cast<const float2*>(delta);
      if (d == 64) {
        return launch_dkv_wgmma<64, T>(q, k, v, dout, rows, dk, dv, batch,
                                       heads, kv_heads, sq, sk, scale, causal,
                                       s);
      }
      if (d == 128) {
        return launch_dkv_wgmma<128, T>(q, k, v, dout, rows, dk, dv, batch,
                                        heads, kv_heads, sq, sk, scale,
                                        causal, s);
      }
    }
    return (int)cudaErrorInvalidValue;
  }
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 16:
      return launch_dkv<16, T>(q, k, v, dout, l, dl, dk, dv, batch, heads,
                               kv_heads, sq, sk, scale, causal, dtype, s);
    case 32:
      return launch_dkv<32, T>(q, k, v, dout, l, dl, dk, dv, batch, heads,
                               kv_heads, sq, sk, scale, causal, dtype, s);
    case 64:
      return launch_dkv<64, T>(q, k, v, dout, l, dl, dk, dv, batch, heads,
                               kv_heads, sq, sk, scale, causal, dtype, s);
    case 128:
      return launch_dkv<128, T>(q, k, v, dout, l, dl, dk, dv, batch, heads,
                                kv_heads, sq, sk, scale, causal, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, dout, out and
// the gradients share it); lse is float32 [batch, heads, sq]. 16-bit q,
// k, v, dout and out must start on a 16-byte boundary (the caller copies
// them if not). variant: 0 = the kernels of the dtype (f32 FMA, or
// mma.sync for bf16 and f16), which read delta = rowsum(dout * out) from
// `delta`, float32 [batch, heads, sq]; 2 = the 3xTF32 kernels (f32, d 64
// or 128, sq and sk > 0; q, k, v, dout and out 16-byte aligned): the dq
// kernel fills `delta`, float32 [batch, heads, sq], computing it from
// out and dout, for the dk/dv kernel launched after it on the same
// stream; 1 = the Hopper wgmma/TMA kernels
// (bf16 or f16, d 64 or 128, sq and sk > 0): `delta` is then float32
// [batch * heads, sq_pad, 2], sq_pad = sq rounded up to 128, which the dq
// kernel fills with (lse log2(e), delta) pairs (computing delta from out
// and dout) for the dk/dv kernel, launched after it on the same stream.
int flash_attention_bwd_dq_launch(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* out, const void* lse,
                                  void* delta, void* dq, int batch,
                                  int heads, int kv_heads, int sq, int sk,
                                  int d, float scale, int causal, int dtype,
                                  int variant, void* stream) {
  if (batch == 0 || sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  switch (dtype) {
    case 0:
      return dq_typed<float>(q, k, v, dout, out, l, delta, dq, batch, heads,
                             kv_heads, sq, sk, d, scale, causal, variant, s);
    case 1:
      return dq_typed<__nv_bfloat16>(q, k, v, dout, out, l, delta, dq, batch,
                                     heads, kv_heads, sq, sk, d, scale,
                                     causal, variant, s);
    case 2:
      return dq_typed<__half>(q, k, v, dout, out, l, delta, dq, batch, heads,
                              kv_heads, sq, sk, d, scale, causal, variant, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int flash_attention_bwd_dkv_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int batch, int heads,
                                   int kv_heads, int sq, int sk, int d,
                                   float scale, int causal, int dtype,
                                   int variant, void* stream) {
  if (batch == 0 || sk == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  switch (dtype) {
    case 0:
      return dkv_typed<float>(q, k, v, dout, l, delta, dk, dv, batch, heads,
                              kv_heads, sq, sk, d, scale, causal, variant, s);
    case 1:
      return dkv_typed<__nv_bfloat16>(q, k, v, dout, l, delta, dk, dv, batch,
                                      heads, kv_heads, sq, sk, d, scale,
                                      causal, variant, s);
    case 2:
      return dkv_typed<__half>(q, k, v, dout, l, delta, dk, dv, batch, heads,
                               kv_heads, sq, sk, d, scale, causal, variant,
                               s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
