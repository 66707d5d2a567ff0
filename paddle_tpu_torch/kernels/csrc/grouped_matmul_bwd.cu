// Ragged grouped GEMM weight gradient for Hopper (sm_90a): the MoE expert
// projections' drhs.
//
// Replaces: paddle_tpu/kernels/pallas/grouped_matmul.py:_gmm_pallas_bwd
//           (:220), which takes drhs from the VJP of the XLA fallback's
//           contraction (the JAX package has no kernel for it).
//
// Computes, for rows sorted so that each group's rows are one contiguous
// segment of group_sizes[g] rows (group 0 first):
//   drhs[g] = lhs[seg_g]^T @ dout[seg_g]        [k, m] per group
// with lhs [n, k], dout [n, m] and drhs [e, k, m] of one dtype (f32, bf16
// or f16), f32 accumulation. Segments are clamped to [0, n), as the
// forward's. An empty group's matrix is written as zeros.
//
// What bounds it on an H100: operations (2 n k m; at the MoE shapes, n =
// 16384 routed rows, k 1024, m 2816, 0.0955 ms at 989 TFLOP/s bf16); the
// bytes (lhs and dout once, drhs once) take ~0.04 ms.
//
// Design. One block per (m tile, k tile, group): grid (m / 128, k / 128,
// e). Thread 0 sums the group sizes before its group on the device (no
// host sync) and the block walks its segment's rows in chunks of kRows,
// starting at the segment's first row: a chunk is any kRows consecutive
// rows (no alignment is needed, each row is its own 16-byte vectors), and
// rows at or past the segment's end load as zeros, so no chunk adds a row
// of the next group. The block owns its [128, 128] output tile alone: no
// atomics, no second pass, and it always stores (zeros for an empty or a
// 1-row segment are the products of zero rows).
//  * 16-bit: 8 warps, warp w owns k rows 64 (w / 4) .. + 63 and m columns
//    32 (w % 4) .. + 31 of the tile. Each chunk goes through a ring of
//    kStages shared-memory stages filled by 16-byte cp.async, kStages - 1
//    chunks ahead of the products: the lhs chunk [kRows][128 k] and the
//    dout chunk [kRows][128 m], both stored as they lie in memory (rows
//    along n). mma.sync.m16n8k16 with f32 accumulators: the A operand
//    (k x rows) is the lhs chunk transposed, read by ldmatrix.trans; the
//    B operand (rows x m) is the dout chunk, read by ldmatrix.trans as the
//    forward reads its rhs. Gate: k % 8 == 0, m % 8 == 0, 16-byte
//    aligned lhs and dout.
//  * f32: exact FMAs, 256 threads in a 16 x 16 grid over a 64 x 64 tile,
//    rows in chunks of 16, scalar loads masked per element (any shape).
//
// Launch contract: grouped_matmul_wgrad_launch launches on the given
// stream and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

// The group's rows [lo, hi), clamped to [0, n): thread 0 sums the sizes
// before it; every thread gets the bounds through shared memory.
__device__ void segment(const int32_t* __restrict__ group_sizes, int g, int n,
                        int* lo, int* hi) {
  __shared__ int bounds[2];
  if (threadIdx.x == 0) {
    long long start = 0;
    for (int j = 0; j < g; ++j) start += group_sizes[j] > 0 ? group_sizes[j] : 0;
    const long long size = group_sizes[g] > 0 ? group_sizes[g] : 0;
    bounds[0] = (int)(start < n ? start : n);
    bounds[1] = (int)(start + size < n ? start + size : n);
  }
  __syncthreads();
  *lo = bounds[0];
  *hi = bounds[1];
}

// ---------------------------------------------------------------------------
// f32: exact FMAs.

constexpr int kFT = 64, kFRows = 16, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads) gmm_wgrad_f32_kernel(
    const float* __restrict__ lhs, const float* __restrict__ dout,
    const int32_t* __restrict__ group_sizes, float* __restrict__ drhs, int n,
    int k, int m) {
  __shared__ float a_s[kFRows][kFT + 4];  // lhs chunk, rows x k
  __shared__ float b_s[kFRows][kFT + 4];  // dout chunk, rows x m
  const int g = blockIdx.z;
  int lo, hi;
  segment(group_sizes, g, n, &lo, &hi);
  const int k0 = blockIdx.y * kFT;
  const int m0 = blockIdx.x * kFT;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = lo; r0 < hi; r0 += kFRows) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < kFRows * kFT; i += kFThreads) {
      const int r = i / kFT;
      const int c = i - r * kFT;
      const int row = r0 + r;
      a_s[r][c] = row < hi && k0 + c < k ? lhs[(size_t)row * k + k0 + c]
                                         : 0.f;
      b_s[r][c] = row < hi && m0 + c < m ? dout[(size_t)row * m + m0 + c]
                                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kFRows; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
  }

  float* out = drhs + (size_t)g * k * m;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= k) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = m0 + tx + 16 * j;
      if (col < m) out[(size_t)row * m + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit on the tensor cores (mma.sync). Fragment layouts are the PTX
// ISA's for mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16): reg0 = A[g][2t..2t+1], reg1 = A[g+8][2t..], reg2 =
//              A[g][2t+8..], reg3 = A[g+8][2t+8..]
//   B (16x8):  reg0 = B[2t..2t+1][g], reg1 = B[2t+8..2t+9][g]
//   C (16x8):  c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// Here A[i][r] = lhs[row r][k index i] and B[r][j] = dout[row r][m index
// j]: both chunks lie in shared memory with the rows along the first
// dimension, so both are read transposed (ldmatrix .trans).

constexpr int kBT = 128;        // output tile, k and m
constexpr int kRows = 32;       // rows a chunk
constexpr int kThreads = 256;
constexpr int kStages = 3;      // cp.async ring depth
constexpr int kS = kBT + 8;     // padded row: conflict-free ldmatrix
constexpr int kChunkElems = kRows * kS;
constexpr int kSmemBytes = kStages * 2 * kChunkElems * 2;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <typename L>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<L, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <typename L>
__device__ __forceinline__ void store2(L* p, float lo, float hi) {
  if constexpr (std::is_same<L, __half>::value) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(lo, hi);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
  }
}

template <typename L>
__global__ void __launch_bounds__(kThreads) gmm_wgrad_mma_kernel(
    const L* __restrict__ lhs, const L* __restrict__ dout,
    const int32_t* __restrict__ group_sizes, L* __restrict__ drhs, int n,
    int k, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  L* smem = reinterpret_cast<L*>(smem_raw);
  const int g = blockIdx.z;
  int lo, hi;
  segment(group_sizes, g, n, &lo, &hi);
  const int k0 = blockIdx.y * kBT;
  const int m0 = blockIdx.x * kBT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wk = (warp >> 2) * 64;  // the warp's k rows of the tile
  const int wn = (warp & 3) * 32;   // its m columns

  // stage st: the lhs chunk, then the dout chunk
  auto a_tile = [&](int st) { return smem + st * 2 * kChunkElems; };
  auto b_tile = [&](int st) { return smem + st * 2 * kChunkElems + kChunkElems; };

  // issue the loads of chunk c (rows lo + c kRows ..) into stage c % kStages;
  // rows at or past hi, and columns past k or m, are zeros
  auto load = [&](int c) {
    const int r0 = lo + c * kRows;
    L* a_s = a_tile(c % kStages);
    L* b_s = b_tile(c % kStages);
    for (int i = tid; i < kRows * (kBT / 8); i += kThreads) {
      const int r = i >> 4;
      const int v = (i & 15) * 8;
      const int row = r0 + r;
      const bool a_ok = row < hi && k0 + v < k;
      cp_async16(a_s + r * kS + v,
                 lhs + (a_ok ? (size_t)row * k + k0 + v : 0), a_ok);
      const bool b_ok = row < hi && m0 + v < m;
      cp_async16(b_s + r * kS + v,
                 dout + (b_ok ? (size_t)row * m + m0 + v : 0), b_ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // ldmatrix lane offsets. A through .trans from the lhs chunk [rows][k]:
  // matrices (k 0-7, rows 0-7), (k 8-15, rows 0-7), (k 0-7, rows 8-15),
  // (k 8-15, rows 8-15) give reg0..reg3. B through .trans from the dout
  // chunk [rows][m], as the forward reads its rhs: registers 0, 1 for
  // column tile j, 2, 3 for j + 1.
  const int ao = ((lane & 7) + (lane >> 4) * 8) * kS + ((lane >> 3) & 1) * 8;
  const int bo = ((lane & 7) + ((lane >> 3) & 1) * 8) * kS + (lane >> 4) * 8;

  const int chunks = (hi - lo + kRows - 1) / kRows;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < chunks) load(st);
    cp_async_commit();  // an empty group keeps the count when chunks is small
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed
    __syncthreads();               // ... for every thread; chunk c - 1 done
    if (c + kStages - 1 < chunks) load(c + kStages - 1);
    cp_async_commit();
    const L* a_s = a_tile(c % kStages);
    const L* b_s = b_tile(c % kStages);
#pragma unroll
    for (int rr = 0; rr < kRows; rr += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldsm_x4_trans(a[i], a_s + rr * kS + ao + wk + 16 * i);
      }
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_s + rr * kS + bo + wn + j * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma16816<L>(acc[i][j], a[i], b[0], b[1]);
          mma16816<L>(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  L* out = drhs + (size_t)g * k * m;
  const int gr = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = m0 + wn + j * 8 + 2 * t;  // even; m % 8 == 0
    if (col >= m) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = k0 + wk + i * 16 + gr + 8 * h;
        if (row >= k) continue;
        store2<L>(out + (size_t)row * m + col, acc[i][j][2 * h],
                  acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <typename L>
int launch_mma(const void* lhs, const void* dout, const int32_t* gs,
               void* drhs, int n, int k, int m, int e, cudaStream_t stream) {
  auto kernel = gmm_wgrad_mma_kernel<L>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + kBT - 1) / kBT, (k + kBT - 1) / kBT, e);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const L*>(lhs), static_cast<const L*>(dout), gs,
      static_cast<L*>(drhs), n, k, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (lhs, dout and drhs share
// it). 16-bit needs k % 8 == 0 and m % 8 == 0.
int grouped_matmul_wgrad_launch(const void* lhs, const void* dout,
                                const void* group_sizes, void* drhs, int n,
                                int k, int m, int e, int dtype,
                                void* stream) {
  if (k == 0 || m == 0 || e == 0) return 0;
  if (e > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* gs = static_cast<const int32_t*>(group_sizes);
  if (dtype == 0) {
    const dim3 grid((m + kFT - 1) / kFT, (k + kFT - 1) / kFT, e);
    gmm_wgrad_f32_kernel<<<grid, kFThreads, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(dout), gs,
        static_cast<float*>(drhs), n, k, m);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 && dtype != 2) return (int)cudaErrorInvalidValue;
  if (k % 8 || m % 8) return (int)cudaErrorInvalidValue;
  return dtype == 2
             ? launch_mma<__half>(lhs, dout, gs, drhs, n, k, m, e, s)
             : launch_mma<__nv_bfloat16>(lhs, dout, gs, drhs, n, k, m, e, s);
}

}  // extern "C"
