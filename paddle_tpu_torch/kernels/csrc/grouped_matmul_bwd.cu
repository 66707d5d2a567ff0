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
// bytes (lhs and dout once, drhs once) take ~0.05 ms. The reduction runs
// over a group's rows, so a tile's work is its group's size, and every
// tile of an empty group is still a store of zeros.
//
// Design. Three kernels; the wrapper picks one before the launch
// (grouped_matmul._wgrad_variant: wgmma for 16-bit from a measured
// multiply-add crossover, mma.sync below it, FMA for f32).
//  * 16-bit on Hopper (gmm_wgrad_wgmma_kernel): a persistent grid of one
//    block per SM walks a work list of output tiles (group, 128 k-rows,
//    256 m-columns), 704 at the MoE shapes. Thread 0 builds the list on
//    the device from the group sizes (clamped segments [lo, hi), no host
//    sync); the groups are ranked by size, largest first, and a group's
//    tiles are consecutive, so a wave's blocks share its lhs and dout
//    rows in L2. A tile's reduction walks its segment in 64-row chunks
//    starting at lo: one producer thread loads each chunk by TMA (the lhs
//    box [64 rows][128 k] as two 64-value boxes, the dout box [64
//    rows][256 m] as four) into a 4-stage mbarrier ring of 48 KB stages,
//    and two consumer warpgroups each own 64 k-rows of the tile:
//    wgmma.m64n256k16 with f32 accumulators. What holds it back is the
//    loads' latency: a chunk's products take ~0.56 us at the tensor
//    cores' rate, so the ring must keep ~2 us of loads in flight. Two
//    stages take 0.316 ms at the MoE up projection, three (the forward's
//    ring) 0.185, four 0.171 (chip_sweeps.py wgrad_tile, an H100 80GB
//    HBM3 at 700 W); the fourth stage fits because the epilogue stages
//    its output in two rounds of two 64-column boxes (32 KB, not 64).
//    L2 is not the limit: blocks paired in clusters along k, each
//    multicasting half of the dout boxes into both (a third less L2
//    traffic), took 0.192 ms against 0.186 at three stages and 0.173
//    against 0.171 at four, and are not kept. Both operands are
//    the transposed (MN-major) form: A = lhs^T has k contiguous, B = dout
//    has m contiguous, each as TMA wrote it with 128-byte swizzle. For A
//    this needs the transpose bit hopper.cuh's wgmma_ss now takes
//    (TransA, default 0, so every other caller compiles as before),
//    chosen over wgmma's register-A form: that form would load A through
//    ldmatrix.trans out of the swizzled box, registers and instructions
//    per k16 step that the shared-memory form leaves to the tensor cores.
//    A segment's last chunk runs past hi into the next group's rows (TMA
//    zero-fills only past n): the consumers zero those rows of both
//    operands in shared memory (a stray inf times 0 would be NaN), then
//    fence.proxy.async and a barrier of both warpgroups before the
//    products. Segments of any length, 0 and 1 rows included, start and
//    end anywhere. The epilogue stages each warpgroup's 64 x 256 share
//    in shared memory, two boxes a round, and stores it by TMA through a
//    (m, k, e) map, which clips rows past k and columns past m per group
//    and drains under the next tile's loads; an empty group's tile is
//    stored as zeros. Shared memory (4 x 48 KB ring, 32 KB of staging)
//    leaves room for the work list of at most 165 groups. TMA
//    needs 16-byte row strides: k % 8 == 0 and m % 8 == 0, the wrapper's
//    gate; tails in k and m are zero-filled on load, clipped on store.
//  * 16-bit on mma.sync (gmm_wgrad_mma_kernel, below the crossover, and
//    variant="mma" to time it beside the wgmma kernel): one block per (m
//    tile, k tile, group), grid (m / 128, k / 128, e). Thread 0 sums the
//    group sizes before its group on the device and the block walks its
//    segment's rows in chunks of kRows from the segment's first row (a
//    chunk is any kRows consecutive rows; rows at or past the segment's
//    end load as zeros). The block owns its [128, 128] output tile
//    alone and always stores it. 8 warps, warp w owns k rows 64 (w / 4)
//    .. + 63 and m columns 32 (w % 4) .. + 31; a ring of kStages stages
//    filled by 16-byte cp.async holds the lhs chunk [kRows][128 k] and
//    the dout chunk [kRows][128 m] as they lie; mma.sync.m16n8k16, both
//    operands read by ldmatrix.trans.
//  * f32: exact FMAs, 256 threads in a 16 x 16 grid over a 64 x 64 tile,
//    rows in chunks of 16, scalar loads masked per element (any shape).
//
// Launch contract: grouped_matmul_wgrad_launch launches on the given
// stream and returns cudaGetLastError() (0 on success), or an error
// without launching for inputs off its gate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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


// ---------------------------------------------------------------------------
// 16-bit on Hopper: wgmma fed by TMA through an mbarrier ring (hopper.cuh),
// a persistent grid. Described in the file's header.

constexpr int kGM = 128;        // output k-rows per tile, 64 a warpgroup
// output m-columns per tile (against 128: chip_sweeps.py wgrad_tile)
constexpr int kGN = 256;  // sweep: wgrad_tile_n
constexpr int kGR = 64;         // segment rows (the reduction) per stage
constexpr int kGThreads = 384;  // consumer warpgroups 0, 1; producer 2
// ring stages, 48 KB each at BN 256 (against 2 and 3: chip_sweeps.py
// wgrad_tile); room for the fourth comes from staging the output in
// rounds of kGOutBoxes 64-column boxes (16 KB each) in place of all four
constexpr int kGStages = 4;  // sweep: wgrad_stages
constexpr int kGOutBoxes = 2;  // sweep: wgrad_out_boxes

template <int BN>
struct WgradCfg {
  static constexpr int kStages = kGStages;
  static constexpr int kBox = kGR * 128;      // 64 rows x 64 values, 8 KB
  static constexpr int kABoxes = kGM / 64;    // lhs: one per warpgroup
  static constexpr int kBBoxes = BN / 64;     // dout
  static constexpr int kStageBytes = (kABoxes + kBBoxes) * kBox;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // the output tile staged for TMA stores, kOutBoxes boxes of 128 k-rows x
  // 64 columns at a time, 128-byte swizzled; warpgroup wg's rows are the
  // box's half
  static constexpr int kOutBoxes = kGOutBoxes < kBBoxes ? kGOutBoxes
                                                        : kBBoxes;
  static_assert(kBBoxes % kOutBoxes == 0, "whole rounds of output boxes");
  static constexpr int kOutBox = kGM * 128;
  static constexpr int kOutBytes = kOutBoxes * kOutBox;
  static constexpr int kTileBytes = kRingBytes + kOutBytes;
};

struct GTile {
  int g, lo, hi, k0, m0;  // group, its rows [lo, hi), the tile's origin
};

// tile t of the list: groups by size, largest first (order[]), then k
// tiles, then m tiles fastest, so the blocks of one wave share a group's
// lhs and dout rows in L2
__device__ __forceinline__ GTile wgrad_tile(int t, int k_tiles, int m_tiles,
                                            const int* order,
                                            const int* seg_lo,
                                            const int* seg_hi, int bn) {
  const int per_group = k_tiles * m_tiles;
  const int r = t / per_group;
  const int rem = t - r * per_group;
  const int kt = rem / m_tiles;
  GTile w;
  w.g = order[r];
  w.lo = seg_lo[w.g];
  w.hi = seg_hi[w.g];
  w.k0 = kt * kGM;
  w.m0 = (rem - kt * m_tiles) * bn;
  return w;
}

// rows `from` .. 63 of a 64-row box to zeros (each row is its 128 bytes,
// whatever the swizzle does inside it), by the warpgroup's 128 threads
__device__ __forceinline__ void zero_rows(unsigned char* box, int from,
                                          int tid) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < (kGR - from) * 8; i += 128) {
    *reinterpret_cast<uint4*>(box + from * 128 + i * 16) = z;
  }
}

template <int BN, typename E>
__global__ void __launch_bounds__(kGThreads, 1) gmm_wgrad_wgmma_kernel(
    const __grid_constant__ CUtensorMap lhs_map,   // (k, n), 64 x 64 boxes
    const __grid_constant__ CUtensorMap dout_map,  // (m, n), 64 x 64 boxes
    const __grid_constant__ CUtensorMap out_map,   // (m, k, e), 64 x 64 x 1
    const int32_t* __restrict__ group_sizes, int n, int k, int m, int e) {
  using C = WgradCfg<BN>;
  static_assert(C::kBBoxes % 2 == 0, "the dout boxes split over warpgroups");
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* staged = smem + C::kRingBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kTileBytes);
  uint64_t* empty = full + C::kStages;
  int* seg_lo = reinterpret_cast<int*>(empty + C::kStages);
  int* seg_hi = seg_lo + e;
  int* order = seg_hi + e;  // groups by rows, largest first

  if (threadIdx.x == 0) {
    long long start = 0;
    for (int g = 0; g < e; ++g) {
      const long long size = group_sizes[g] > 0 ? group_sizes[g] : 0;
      seg_lo[g] = (int)(start < n ? start : n);
      seg_hi[g] = (int)(start + size < n ? start + size : n);
      start += size;
    }
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // each group's rank: the groups with more rows, or as many and before it
  for (int g = threadIdx.x; g < e; g += kGThreads) {
    const int rows = seg_hi[g] - seg_lo[g];
    int rnk = 0;
    for (int j = 0; j < e; ++j) {
      const int rj = seg_hi[j] - seg_lo[j];
      rnk += rj > rows || (rj == rows && j < g);
    }
    order[rnk] = g;
  }
  __syncthreads();

  const int k_tiles = (k + kGM - 1) / kGM;
  const int m_tiles = (m + BN - 1) / BN;
  const int n_tiles = e * k_tiles * m_tiles;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full, a stage per 64 rows
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hopper::tma_prefetch(&lhs_map);
      hopper::tma_prefetch(&dout_map);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const GTile w = wgrad_tile(t, k_tiles, m_tiles, order, seg_lo, seg_hi,
                                   BN);
        for (int r0 = w.lo; r0 < w.hi; r0 += kGR) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * C::kStageBytes;
          hopper::mbar_arrive_expect_tx(&full[stage], C::kStageBytes);
#pragma unroll
          for (int j = 0; j < C::kABoxes; ++j) {
            hopper::tma_load_2d(st + j * C::kBox, &lhs_map, &full[stage],
                                w.k0 + 64 * j, r0);
          }
#pragma unroll
          for (int j = 0; j < C::kBBoxes; ++j) {
            hopper::tma_load_2d(st + (C::kABoxes + j) * C::kBox, &dout_map,
                                &full[stage], w.m0 + 64 * j, r0);
          }
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns k-rows 64 wg .. 64 wg + 63
    hopper::setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const GTile w = wgrad_tile(t, k_tiles, m_tiles, order, seg_lo, seg_hi,
                                 BN);
      const int chunks = (w.hi - w.lo + kGR - 1) / kGR;
      if (chunks == 0) {  // an empty group: its tile is zeros
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      }
      int prev = 0;
      for (int c = 0; c < chunks; ++c) {
        hopper::mbar_wait(&full[stage], phase);
        unsigned char* st = smem + stage * C::kStageBytes;
        const int valid = w.hi - (w.lo + c * kGR);  // the group's rows here
        if (valid < kGR) {
          // the box's rows past the segment hold the next group's rows (or
          // TMA's zeros past n): zeros in both operands (inf x 0 is NaN),
          // this warpgroup's lhs box and its half of the dout boxes, then
          // both warpgroups' zeros before either's products
          zero_rows(st + wg * C::kBox, valid, tid);
#pragma unroll
          for (int j = 0; j < C::kBBoxes / 2; ++j) {
            zero_rows(st + (C::kABoxes + wg * (C::kBBoxes / 2) + j) * C::kBox,
                      valid, tid);
          }
          hopper::fence_proxy_async();
          hopper::named_bar_sync(3, 256);
        }
        const unsigned char* a = st + wg * C::kBox;
        const unsigned char* b = st + C::kABoxes * C::kBox;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kGR / 16; ++kk) {
          // A = lhs^T (k contiguous: MN-major), B = dout (m contiguous:
          // MN-major); a k16 step is 16 rows, two 8-row groups
          hopper::wgmma_ss<BN, 1, E, 1>(
              acc, hopper::desc_mn_major(a + kk * 2048, C::kBox),
              hopper::desc_mn_major(b + kk * 2048, C::kBox), c > 0 || kk > 0);
        }
        hopper::wgmma_commit();
        // the previous chunk's products are done: release its stage
        hopper::wgmma_wait<1>();
        if (c > 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (chunks > 0) {
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        if (lane == 0) hopper::mbar_arrive(&empty[prev]);
      }

      // this warpgroup's 64 k-rows: staged in shared memory (128-byte
      // swizzled boxes of 64 columns), kOutBoxes boxes a round, and stored
      // by TMA, which drains while the warpgroup goes on; rows past k and
      // columns past m are clipped by the tensor map, per group
      unsigned char* half = staged + wg * 64 * 128;
      const int r_lo = warp * 16 + (lane >> 2);  // this lane's two rows
#pragma unroll
      for (int rd = 0; rd < C::kBBoxes / C::kOutBoxes; ++rd) {
        if (tid == 0) hopper::bulk_wait_read<0>();  // the last store read
        hopper::named_bar_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < 8 * C::kOutBoxes; ++jj) {
          const int j = 8 * C::kOutBoxes * rd + jj;  // the 8-column group
          // 16-byte chunk j % 8 of its 128-byte row, swizzled by row % 8
          unsigned char* box = half + (jj >> 3) * C::kOutBox;
          const int chunk = ((j & 7) ^ (r_lo & 7)) * 16 + 4 * (lane & 3);
          *reinterpret_cast<uint32_t*>(box + r_lo * 128 + chunk) =
              hopper::pack2<E>(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(box + (r_lo + 8) * 128 + chunk) =
              hopper::pack2<E>(acc[4 * j + 2], acc[4 * j + 3]);
        }
        hopper::fence_proxy_async();
        hopper::named_bar_sync(1 + wg, 128);
        if (tid == 0) {
#pragma unroll
          for (int bx = 0; bx < C::kOutBoxes; ++bx) {
            hopper::tma_store_3d(&out_map, half + bx * C::kOutBox,
                                 w.m0 + 64 * (C::kOutBoxes * rd + bx),
                                 w.k0 + 64 * wg, w.g);
          }
          hopper::bulk_commit();
        }
      }
    }
    // the stores must have read shared memory before the block ends
    if (tid == 0) hopper::bulk_wait<0>();
  }
}

// shared memory of the wgmma kernel: alignment slack, the ring and the
// staged output, full/empty barriers, the segments and the order
template <int BN>
constexpr int wgrad_smem_bytes(int e) {
  return 1024 + WgradCfg<BN>::kTileBytes + 2 * WgradCfg<BN>::kStages * 8 +
         3 * e * 4;
}

template <int BN, typename E>
int launch_wgmma(const void* lhs, const void* dout, const int32_t* gs,
                 void* drhs, int n, int k, int m, int e,
                 cudaStream_t stream) {
  const int smem = wgrad_smem_bytes<BN>(e);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // too many groups
  // n == 0: every segment is empty and nothing is loaded, but a map needs
  // a row and a base; drhs serves
  const void* lhs_base = n ? lhs : drhs;
  const void* dout_base = n ? dout : drhs;
  const cuuint64_t rows = n ? (cuuint64_t)n : 1;
  CUtensorMap lhs_map, dout_map, out_map;
  const cuuint32_t box[2] = {64, kGR};
  const cuuint64_t l_dims[2] = {(cuuint64_t)k, rows};
  const cuuint64_t l_strides[1] = {(cuuint64_t)k * 2};
  int err = hopper::encode_16bit_map<E>(&lhs_map, lhs_base, 2, l_dims,
                                        l_strides, box);
  if (err) return err;
  const cuuint64_t d_dims[2] = {(cuuint64_t)m, rows};
  const cuuint64_t d_strides[1] = {(cuuint64_t)m * 2};
  err = hopper::encode_16bit_map<E>(&dout_map, dout_base, 2, d_dims,
                                    d_strides, box);
  if (err) return err;
  const cuuint64_t o_dims[3] = {(cuuint64_t)m, (cuuint64_t)k, (cuuint64_t)e};
  const cuuint64_t o_strides[2] = {(cuuint64_t)m * 2, (cuuint64_t)k * m * 2};
  const cuuint32_t o_box[3] = {64, 64, 1};
  err = hopper::encode_16bit_map<E>(&out_map, drhs, 3, o_dims, o_strides,
                                    o_box);
  if (err) return err;
  auto kernel = gmm_wgrad_wgmma_kernel<BN, E>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const long long tiles = (long long)e * ((k + kGM - 1) / kGM) *
                          ((m + BN - 1) / BN);
  const int sms = hopper::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kGThreads, smem, stream>>>(lhs_map, dout_map, out_map, gs,
                                            n, k, m, e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (lhs, dout and drhs share
// it). variant: 0 = the kernel of the dtype (f32 FMA, or mma.sync for
// 16-bit); 1 = wgmma (16-bit). 16-bit needs k % 8 == 0 and m % 8 == 0.
int grouped_matmul_wgrad_launch(const void* lhs, const void* dout,
                                const void* group_sizes, void* drhs, int n,
                                int k, int m, int e, int dtype, int variant,
                                void* stream) {
  if (k == 0 || m == 0 || e == 0) return 0;
  if (e > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* gs = static_cast<const int32_t*>(group_sizes);
  if (variant == 1) {
    if ((dtype != 1 && dtype != 2) || k % 8 || m % 8) {
      return (int)cudaErrorInvalidValue;
    }
    return dtype == 2
               ? launch_wgmma<kGN, __half>(lhs, dout, gs, drhs, n, k, m, e, s)
               : launch_wgmma<kGN, __nv_bfloat16>(lhs, dout, gs, drhs, n, k,
                                                  m, e, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
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
