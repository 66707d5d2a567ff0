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
//  * dq:  one block per (b * heads, 64-row query tile); it walks the key
//         tiles up to the diagonal and accumulates dq in f32 registers.
//  * dkv: one block per (b * kv_heads, 64-key tile); it walks, for every
//         query head of the group, the query tiles at or below the
//         diagonal and accumulates dk and dv in f32 registers.
// Each kernel recomputes S and dP for its own tiles, so together they
// run seven s x s x d products where the least work is five.
//
// What bounds it on an H100: at the training shapes (s = 1024, d = 128)
// the products dominate, so it is bound by operations; the design keeps
// every s x s tile (S, P, dP, dS) in registers or shared memory and reads
// each q, k, v and dout element once per tile pair. Per dtype:
//  * bf16 (*_tc kernels): mma.sync.m16n8k16 on the tensor cores (bf16 in,
//    f32 accumulate), with the fragment layouts and 16-byte staging of
//    flash_attention.cu. Every operand fragment read from shared memory
//    comes through ldmatrix (.trans for the B operands of the second
//    products, whose tiles hold k along their rows). P and dS go from
//    the first products' accumulators to the second products' A
//    operands in registers, rounded to bf16 only there; every
//    accumulator is f32. The s x s work is done 32 columns at a time to
//    keep the f32 accumulators of dk and dv (or dq) in registers at
//    d = 128. Not yet wgmma/TMA: it stays below the card's bf16 peak.
//    q, k, v and dout must start on a 16-byte boundary (the Python
//    wrapper copies any that do not).
//  * f32: exact FMAs from shared memory (rows padded by one float), 256
//    threads in a 16 x 16 grid, each owning a 4 x 4 block of the 64 x 64
//    score tile and a 4 x (d / 16) block of its accumulators.
//
// Launch contract: the two launch functions set each kernel's dynamic
// shared memory, launch on the given stream and return cudaGetLastError()
// (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
// bf16 on the tensor cores. Fragment layouts are the PTX ISA's for
// mma.m16n8k16 (g = lane / 4, t = lane % 4; the lower half of a register
// holds the lower column or k index):
//   A (16x16): reg0 = A[g][2t..2t+1], reg1 = A[g+8][2t..], reg2 =
//              A[g][2t+8..], reg3 = A[g+8][2t+8..]
//   B (16x8):  reg0 = B[2t..2t+1][g], reg1 = B[2t+8..2t+9][g]
//   C (16x8):  c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// Two 16x8 C tiles side by side are one A fragment of the next product,
// so P and dS go from accumulators to operands without shared memory.

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

// Four 8x8 bf16 matrices from shared memory, one per 8 lanes' row
// addresses (lane l gives row l % 8 of matrix l / 8). Plain: register i
// of lane l holds row l / 4, columns 2 (l % 4) .. + 1 of matrix i, an A
// or B fragment of rows stored along k. .trans: register i holds rows
// 2 (l % 4) .. + 1 of column l / 4, the B fragment of a tile stored with
// k along its rows.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4],
                                        const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4],
                                              const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// four [64][d + 8] bf16 tiles, then two [64] f32 rows
constexpr size_t tc_smem_bytes(int d) {
  return 4 * (size_t)kBQ * (d + 8) * sizeof(__nv_bfloat16) +
         2 * (size_t)kBQ * sizeof(float);
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

// x += A1 B1^T and y += A2 B2^T, [16 x 32] each: a1/a2 point at the
// warp's 16 A rows, b1/b2 at the 32 B rows, all [.][D + 8] tiles with
// the product's k (head dim) along their rows.
template <int D>
__device__ __forceinline__ void rows_times_rows(
    float x[4][4], float y[4][4], const __nv_bfloat16* a1,
    const __nv_bfloat16* b1, const __nv_bfloat16* a2,
    const __nv_bfloat16* b2, int lane) {
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
      mma_bf16(x[n], p[0], p[1], p[2], p[3], b[0], b[1]);
      mma_bf16(x[n + 1], p[0], p[1], p[2], p[3], b[2], b[3]);
      ldsm_x4(b, b2 + n * 8 * S + bo + kk);
      mma_bf16(y[n], r[0], r[1], r[2], r[3], b[0], b[1]);
      mma_bf16(y[n + 1], r[0], r[1], r[2], r[3], b[2], b[3]);
    }
  }
}

// acc[16 x D] += A[16 x 32] M[32 x D], A given as the 4 accumulator tiles
// x[n] (keys or queries n * 8 ..), M the 32 rows starting at m of a
// [.][D + 8] tile stored with k along its rows (B through ldmatrix.trans)
template <int D>
__device__ __forceinline__ void acc_times_rows(float acc[D / 8][4],
                                               const float x[4][4],
                                               const __nv_bfloat16* m,
                                               int lane) {
  constexpr int S = D + 8;
  // matrices (k 0-7, cols j), (k 8-15, cols j), (k 0-7, j + 1), (k 8-15,
  // j + 1): registers 0, 1 are column tile j's fragment, 2, 3 tile j + 1's
  const __nv_bfloat16* mo =
      m + ((lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint32_t a0 = pack_bf16(x[2 * ks][0], x[2 * ks][1]);
    const uint32_t a1 = pack_bf16(x[2 * ks][2], x[2 * ks][3]);
    const uint32_t a2 = pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]);
    const uint32_t a3 = pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3]);
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, mo + ks * 16 * S + j * 8);
      mma_bf16(acc[j], a0, a1, a2, a3, b[0], b[1]);
      mma_bf16(acc[j + 1], a0, a1, a2, a3, b[2], b[3]);
    }
  }
}

// One block of 4 warps per (b * heads, 64-row query tile); warp w owns
// query rows 16 w .. 16 w + 15 and accumulates their dq.
template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int heads, int kv_heads, int sq, int sk, float scale, int causal) {
  constexpr int S = D + 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + kBQ * S;
  __nv_bfloat16* k_s = do_s + kBQ * S;
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
  const size_t q_off = (size_t)bi * sq * q_row + (size_t)hh * D;
  const __nv_bfloat16* k_b = k + (size_t)bi * sk * kv_row + (size_t)kvh * D;
  const __nv_bfloat16* v_b = v + (size_t)bi * sk * kv_row + (size_t)kvh * D;

  stage_rows<D>(q_s, q + q_off, q_row, q0, sq);
  stage_rows<D>(do_s, dout + q_off, q_row, q0, sq);

  const int r_lo = q0 + warp * 16 + g;  // this lane's two query rows
  const int r_hi = r_lo + 8;
  const float lse_lo = row_lse(lse, (size_t)bh * sq, r_lo, sq);
  const float lse_hi = row_lse(lse, (size_t)bh * sq, r_hi, sq);
  const float dl_lo = r_lo < sq ? delta[(size_t)bh * sq + r_lo] : 0.f;
  const float dl_hi = r_hi < sq ? delta[(size_t)bh * sq + r_hi] : 0.f;
  const __nv_bfloat16* qw = q_s + warp * 16 * S;   // the warp's rows
  const __nv_bfloat16* dw = do_s + warp * 16 * S;

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int k_end = causal ? min(sk, q0 + kBQ) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows<D>(k_s, k_b, kv_row, k0, sk);
    stage_rows<D>(v_s, v_b, kv_row, k0, sk);
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < kBK; kc += 32) {  // 32 keys at a time
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] =
            dp[n][2] = dp[n][3] = 0.f;
      rows_times_rows<D>(s, dp, qw, k_s + kc * S, dw, v_s + kc * S, lane);
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
      acc_times_rows<D>(acc, s, k_s + kc * S, lane);
    }
  }

  __nv_bfloat16* dq_b = dq + q_off;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = j * 8 + 2 * t;
    if (r_lo < sq) {
      *reinterpret_cast<__nv_bfloat162*>(dq_b + (size_t)r_lo * q_row + c) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    }
    if (r_hi < sq) {
      *reinterpret_cast<__nv_bfloat162*>(dq_b + (size_t)r_hi * q_row + c) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
    }
  }
}

// One block of 4 warps per (b * kv_heads, 64-key tile); warp w owns keys
// 16 w .. 16 w + 15 and accumulates their dk and dv over every query head
// of the group.
template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int heads, int kv_heads, int sq, int sk,
    float scale, int causal) {
  constexpr int S = D + 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kBK * S;
  __nv_bfloat16* q_s = v_s + kBK * S;
  __nv_bfloat16* do_s = q_s + kBQ * S;
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
  stage_rows<D>(k_s, k + kv_off, kv_row, k0, sk);
  stage_rows<D>(v_s, v + kv_off, kv_row, k0, sk);

  const int kr_lo = k0 + warp * 16 + g;  // this lane's two key rows
  const int kr_hi = kr_lo + 8;
  const __nv_bfloat16* kw = k_s + warp * 16 * S;   // the warp's keys
  const __nv_bfloat16* vw = v_s + warp * 16 * S;

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
      stage_rows<D>(q_s, q + q_off, q_row, q0, sq);
      stage_rows<D>(do_s, dout + q_off, q_row, q0, sq);
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
        rows_times_rows<D>(st, dpt, kw, q_s + qc * S, vw, do_s + qc * S,
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
        acc_times_rows<D>(dva, st, do_s + qc * S, lane);
        acc_times_rows<D>(dka, dpt, q_s + qc * S, lane);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < DT; ++j) {
    const int c = j * 8 + 2 * t;
    if (kr_lo < sk) {
      const size_t at = kv_off + (size_t)kr_lo * kv_row + c;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[j][0], dka[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[j][0], dva[j][1]);
    }
    if (kr_hi < sk) {
      const size_t at = kv_off + (size_t)kr_hi * kv_row + c;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[j][2], dka[j][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[j][2], dva[j][3]);
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
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
  } else {
    auto kernel = flash_bwd_dq_tc_kernel<D>;
    const size_t smem = tc_smem_bytes(D);
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kTcThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dq), heads, kv_heads, sq, sk, scale,
        causal);
  }
  return (int)cudaGetLastError();
}

template <int D>
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
  } else {
    auto kernel = flash_bwd_dkv_tc_kernel<D>;
    const size_t smem = tc_smem_bytes(D);
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kTcThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        heads, kv_heads, sq, sk, scale, causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients share
// it); lse and delta are float32 [batch, heads, sq]. bf16 q, k, v and dout
// must start on a 16-byte boundary (the caller copies them if not).
int flash_attention_bwd_dq_launch(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int batch, int heads,
                                  int kv_heads, int sq, int sk, int d,
                                  float scale, int causal, int dtype,
                                  void* stream) {
  if (batch == 0 || sq == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 16:
      return launch_dq<16>(q, k, v, dout, l, dl, dq, batch, heads, kv_heads,
                           sq, sk, scale, causal, dtype, s);
    case 32:
      return launch_dq<32>(q, k, v, dout, l, dl, dq, batch, heads, kv_heads,
                           sq, sk, scale, causal, dtype, s);
    case 64:
      return launch_dq<64>(q, k, v, dout, l, dl, dq, batch, heads, kv_heads,
                           sq, sk, scale, causal, dtype, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, l, dl, dq, batch, heads,
                            kv_heads, sq, sk, scale, causal, dtype, s);
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
                                   void* stream) {
  if (batch == 0 || sk == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  switch (d) {
    case 16:
      return launch_dkv<16>(q, k, v, dout, l, dl, dk, dv, batch, heads,
                            kv_heads, sq, sk, scale, causal, dtype, s);
    case 32:
      return launch_dkv<32>(q, k, v, dout, l, dl, dk, dv, batch, heads,
                            kv_heads, sq, sk, scale, causal, dtype, s);
    case 64:
      return launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, batch, heads,
                            kv_heads, sq, sk, scale, causal, dtype, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, batch, heads,
                             kv_heads, sq, sk, scale, causal, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
