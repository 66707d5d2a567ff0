// Ragged grouped GEMM for Hopper (sm_90a): the MoE expert projection.
//
// Replaces: paddle_tpu/kernels/pallas/grouped_matmul.py:_gmm_pallas_raw
//           (kernel bodies _gmm_kernel and, for int8 expert weights,
//           _gmm_kernel_quant; work list _group_metadata).
//
// Computes, for rows sorted so that each group's rows are one contiguous
// segment of group_sizes[g] rows (group 0 first):
//   out[i] = lhs[i] @ rhs[g(i)]               float rhs
//   out[i] = (lhs[i] @ q[g(i)]) * scales[g(i)]  int8 rhs, per column
// with lhs [n, k], rhs [e, k, m], scales [e, m] f32, out [n, m] in lhs's
// dtype, f32 accumulation. Empty groups are allowed. Segments are clamped
// to [0, n): group sizes summing past n never write past the output, and
// rows past the sum are left unwritten (the JAX contract: unspecified).
//
// What bounds it on an H100: at the MoE shapes (n = 16384 rows, k 1024,
// m 2816, 8 groups) operations (2 n k m at 989 TFLOP/s bf16 is ~0.1 ms;
// the bytes, lhs + every expert's rhs + out, take ~0.05 ms).
//
// Design. The TPU kernel walks the (group, row tile) staircase in order
// and carries an f32 accumulator in VMEM across a tile's items. Blocks on
// the card run in no order, but every row belongs to exactly one group:
// so a block owns one staircase item (one row tile of one group) and one
// column tile, computes lhs[tile] @ rhs[g][:, cols] in f32 over the whole
// k, and stores only its group's rows [lo, hi) of the tile. Two blocks
// that share a row tile (a group boundary inside it) store disjoint rows:
// no atomics, no accumulation across items. The work list is built on
// the device: each block reads the [e] group sizes and walks their
// running sums (no host sync). 16-bit means bf16 or f16 (lhs, float rhs
// and out share it). Four kernels:
//  * 16-bit lhs and rhs (gmm_wgmma_kernel, the Hopper design): a
//    persistent grid of one block per SM walks the work list;
//    wgmma.m64n256k16 products from shared memory that TMA fills through a
//    3-stage mbarrier ring, a producer thread and two consumer warpgroups
//    per block. Described at the kernel.
//  * 16-bit lhs with int8 rhs on wgmma (gmm_wgmma_int8_kernel): the same
//    grid, work list and ring with an int8 rhs box per stage, converted
//    by the consumers into the swizzled 16-bit layout wgmma reads.
//    Described at the kernel.
//  * 16-bit lhs with 16-bit or int8 rhs on mma.sync (gmm_mma_kernel; the
//    wrapper takes it below a measured size, and chip_smoke.py times it
//    beside the wgmma kernels). Its grid is static at row tiles + e items
//    (blockIdx.x) by column tiles (blockIdx.y), as on the TPU; inactive
//    items exit. Each block walks the running sums to find its item. 8
//    warps, a 128 x 128 output tile, k in steps of 32 through a 3-stage
//    ring in shared memory filled by 16-byte cp.async (int8 rhs: 8-byte,
//    converted to a 16-bit tile in shared memory before its step, exact
//    for |q| <= 128), mma.sync.m16n8k16 products into f32 accumulators
//    through ldmatrix (.trans for rhs, which is stored with k along its
//    rows). Gate: k % 8 == 0 and m % 8 == 0 (whole 16-byte vectors),
//    16-byte aligned lhs and rhs (8-byte for int8); ragged n, k and m
//    tails are masked per vector.
//  * f32 lhs (f32 or int8 rhs): exact FMAs, 256 threads in a 16 x 16
//    grid over a 64 x 64 output tile, k in steps of 16, scalar loads
//    masked per element (any shape).
// int8 scales multiply each item's f32 result per column before the
// store, as the TPU kernel's contrib * s_ref.
//
// Launch contract: grouped_matmul_launch launches on the given stream
// and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// The work list: item t of the staircase over row tiles of tm rows.

struct Item {
  int tile, lo, hi, g;  // row tile, the group's [lo, hi) rows, the group
};

// Thread 0 walks the group sizes; every thread gets the item through
// shared memory. Returns false for an inactive (padding) item.
__device__ bool find_item(const int32_t* __restrict__ group_sizes, int e,
                          int n, int tm, int t, Item* out) {
  __shared__ Item item;
  __shared__ int found;
  if (threadIdx.x == 0) {
    found = 0;
    long long start = 0;
    int istart = 0;
    for (int g = 0; g < e; ++g) {
      const long long size = group_sizes[g] > 0 ? group_sizes[g] : 0;
      const int lo = (int)(start < n ? start : n);
      const int hi = (int)(start + size < n ? start + size : n);
      start += size;
      if (hi <= lo) continue;
      const int first = lo / tm;
      const int count = (hi - 1) / tm - first + 1;
      if (t < istart + count) {
        item.tile = first + (t - istart);
        item.lo = lo;
        item.hi = hi;
        item.g = g;
        found = 1;
        break;
      }
      istart += count;
    }
  }
  __syncthreads();
  *out = item;
  return found;
}

// ---------------------------------------------------------------------------
// f32 lhs: exact FMAs.

constexpr int kFM = 64, kFN = 64, kFK = 16, kFThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename R>
__global__ void __launch_bounds__(kFThreads) gmm_f32_kernel(
    const float* __restrict__ lhs, const R* __restrict__ rhs,
    const float* __restrict__ scales, const int32_t* __restrict__ group_sizes,
    float* __restrict__ out, int n, int k, int m, int e) {
  __shared__ float a_s[kFK][kFM + 4];  // lhs tile, k-major
  __shared__ float b_s[kFK][kFN + 4];
  Item it;
  if (!find_item(group_sizes, e, n, kFM, blockIdx.x, &it)) return;
  const int r0 = max(it.lo, it.tile * kFM);
  const int r1 = min(it.hi, it.tile * kFM + kFM);
  const int row0 = it.tile * kFM;
  const int col0 = blockIdx.y * kFN;
  const R* w = rhs + (size_t)it.g * k * m;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kFK) {
    __syncthreads();  // the previous step's readers are done
    for (int i = threadIdx.x; i < kFM * kFK; i += kFThreads) {
      const int r = i / kFK;
      const int c = i - r * kFK;
      const int row = row0 + r;
      a_s[c][r] = row >= r0 && row < r1 && k0 + c < k
                      ? lhs[(size_t)row * k + k0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < kFK * kFN; i += kFThreads) {
      const int r = i / kFN;
      const int c = i - r * kFN;
      b_s[r][c] = k0 + r < k && col0 + c < m
                      ? to_f32(w[(size_t)(k0 + r) * m + col0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < r0 || row >= r1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= m) continue;
      float x = acc[i][j];
      if (scales != nullptr) x *= scales[(size_t)it.g * m + col];
      out[(size_t)row * m + col] = x;
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit lhs on the tensor cores (mma.sync). Fragment layouts are the
// PTX ISA's for mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16): reg0 = A[g][2t..2t+1], reg1 = A[g+8][2t..], reg2 =
//              A[g][2t+8..], reg3 = A[g+8][2t+8..]
//   B (16x8):  reg0 = B[2t..2t+1][g], reg1 = B[2t+8..2t+9][g]
//   C (16x8):  c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]

constexpr int kBM = 128, kBN = 128, kBK = 32, kTcThreads = 256;
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kSA = kBK + 8;   // padded lhs row: conflict-free ldmatrix
constexpr int kSB = kBN + 8;   // padded rhs row

// one ring stage: the lhs tile, then the rhs tile (bf16 [kBK][kSB], or
// int8 [kBK][kBN] staged as loaded)
template <typename R>
__host__ __device__ constexpr int stage_bytes() {
  return kBM * kSA * 2 + (sizeof(R) == 1 ? kBK * kBN : kBK * kSB * 2);
}
template <typename R>
__host__ __device__ constexpr int tc_smem_bytes() {
  // int8 rhs: one 16-bit tile more, the stage's rhs converted
  return kStages * stage_bytes<R>() + (sizeof(R) == 1 ? kBK * kSB * 2 : 0);
}

// 16 (or, for int8 rhs, 8) bytes global -> shared, asynchronously; zeros
// when !ok (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// c += a b on bf16 (L = __nv_bfloat16) or f16 (L = __half) fragments
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

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// two f32 values as one register of two L (bf16 or f16), rounded
template <typename L>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<L, __half>::value) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

template <typename L>
__device__ __forceinline__ void store2(L* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2<L>(lo, hi);
}

// One block of 8 warps per (staircase item, column tile); warp w owns
// rows 64 (w / 4) .. + 63 and columns 32 (w % 4) .. + 31 of the 128 x 128
// tile. The k steps go through a ring of kStages shared-memory stages
// filled by cp.async, kStages - 1 steps ahead of the products. int8 rhs
// is staged as loaded and converted to an L tile (exact for |q| <= 128)
// right before its step's products. L is the lhs and output type (bf16 or
// f16), R the rhs type (L or int8).
template <typename L, typename R>
__global__ void __launch_bounds__(kTcThreads) gmm_mma_kernel(
    const L* __restrict__ lhs, const R* __restrict__ rhs,
    const float* __restrict__ scales, const int32_t* __restrict__ group_sizes,
    L* __restrict__ out, int n, int k, int m, int e) {
  constexpr bool kInt8 = sizeof(R) == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Item it;
  if (!find_item(group_sizes, e, n, kBM, blockIdx.x, &it)) return;
  const int r0 = max(it.lo, it.tile * kBM);
  const int r1 = min(it.hi, it.tile * kBM + kBM);
  const int row0 = it.tile * kBM;
  const int col0 = blockIdx.y * kBN;
  const R* w = rhs + (size_t)it.g * k * m;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;

  auto a_tile = [&](int st) {
    return reinterpret_cast<L*>(smem_raw + st * stage_bytes<R>());
  };
  auto b_stage = [&](int st) {
    return smem_raw + st * stage_bytes<R>() + kBM * kSA * 2;
  };
  L* b_conv = reinterpret_cast<L*>(smem_raw + kStages * stage_bytes<R>());

  // issue the loads of k step kt into ring stage kt % kStages
  auto load = [&](int kt) {
    const int k0 = kt * kBK;
    L* a_s = a_tile(kt % kStages);
    // lhs: 128 rows x 4 vectors of 8; rows outside [r0, r1) and k past
    // the end are zeros
    for (int i = tid; i < kBM * (kBK / 8); i += kTcThreads) {
      const int r = i >> 2;
      const int c = (i & 3) * 8;
      const int row = row0 + r;
      const bool ok = row >= r0 && row < r1 && k0 + c < k;
      cp_async16(a_s + r * kSA + c,
                 lhs + (ok ? (size_t)row * k + k0 + c : 0), ok);
    }
    // rhs: 32 rows x 16 vectors of 8
    unsigned char* b = b_stage(kt % kStages);
    for (int i = tid; i < kBK * (kBN / 8); i += kTcThreads) {
      const int r = i >> 4;
      const int c = (i & 15) * 8;
      const bool ok = k0 + r < k && col0 + c < m;
      const R* src = w + (ok ? (size_t)(k0 + r) * m + col0 + c : 0);
      if (kInt8) {
        cp_async8(b + r * kBN + c, src, ok);
      } else {
        cp_async16(reinterpret_cast<L*>(b) + r * kSB + c, src, ok);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // ldmatrix lane offsets: A as in a row-major [m][k] tile; B (k along
  // rows) through .trans, registers 0, 1 for column tile j, 2, 3 for j + 1
  const int ao = (lane & 15) * kSA + (lane >> 4) * 8;
  const int bo = ((lane & 7) + ((lane >> 3) & 1) * 8) * kSB + (lane >> 4) * 8;

  const int steps = (k + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit();  // an empty group keeps the count when steps is small
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kStages - 2>();  // step kt has landed
    __syncthreads();               // ... for every thread; step kt - 1 done
    if (kt + kStages - 1 < steps) load(kt + kStages - 1);
    cp_async_commit();
    const L* a_s = a_tile(kt % kStages);
    const L* b_s;
    if (kInt8) {
      const int8_t* q = reinterpret_cast<const int8_t*>(b_stage(kt % kStages));
      for (int i = tid; i < kBK * (kBN / 8); i += kTcThreads) {
        const int r = i >> 4;
        const int c = (i & 15) * 8;
        const uint2 raw = *reinterpret_cast<const uint2*>(q + r * kBN + c);
        const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
        uint4 x;
        x.x = pack2<L>(v[0], v[1]);
        x.y = pack2<L>(v[2], v[3]);
        x.z = pack2<L>(v[4], v[5]);
        x.w = pack2<L>(v[6], v[7]);
        *reinterpret_cast<uint4*>(b_conv + r * kSB + c) = x;
      }
      __syncthreads();
      b_s = b_conv;
    } else {
      b_s = reinterpret_cast<const L*>(b_stage(kt % kStages));
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldsm_x4(a[i], a_s + (wm + 16 * i) * kSA + ao + kk);
      }
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_s + kk * kSB + bo + wn + j * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma16816<L>(acc[i][j], a[i], b[0], b[1]);
          mma16816<L>(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + wn + j * 8 + 2 * t;  // even; m % 8 == 0
    if (col >= m) continue;
    float s0 = 1.f, s1 = 1.f;
    if (scales != nullptr) {
      s0 = scales[(size_t)it.g * m + col];
      s1 = scales[(size_t)it.g * m + col + 1];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + i * 16 + g + 8 * h;
        if (row < r0 || row >= r1) continue;
        store2<L>(out + (size_t)row * m + col, acc[i][j][2 * h] * s0,
                  acc[i][j][2 * h + 1] * s1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit lhs and rhs (bf16 or f16, E) on Hopper: wgmma fed by TMA
// through an mbarrier ring (hopper.cuh), a persistent grid.
//
// Block: 3 warpgroups. Warpgroups 0 and 1 are consumers, each owning 64
// rows of a 128 x BN output tile (wgmma.m64nBNk16, f32 accumulators in
// registers); one thread of warpgroup 2 is the producer, issuing the TMA
// loads of each k step (a 128 x 64 lhs box and BN / 64 rhs boxes of
// 64 x 64) into a ring of kStages stages with full/empty mbarriers. lhs is
// K-major (2-D map over [n, k]), rhs MN-major (3-D map over (m, k, e): the
// transpose bit). TMA zero-fills past n, k and m; rows of a neighbouring
// group loaded into the tile are never stored. The epilogue goes out by
// TMA stores from a staged copy in shared memory, so it drains while the
// next tile's products run (stores straight from the registers took the
// up projection from 0.165 to 0.217 ms: chip_sweeps.py gmm_epilogue, on
// an H100 80GB HBM3 at 700 W); a warpgroup whose rows cross a
// group boundary stores the group's rows from its registers instead.
//
// Work list: every block walks the group sizes once (thread 0, into
// shared memory: clamped segment bounds and running item counts), then
// takes work tiles t = blockIdx.x, + gridDim.x, ... of the list
// (item, column tile), column tile fastest: the blocks of one wave share
// an item's lhs rows and one expert's rhs, which stay in L2. An item is
// one row tile of one group; its tile stores only the group's rows, so
// tiles that share a row tile write disjoint rows, with no atomics.

constexpr int kWM = 128;        // output rows per tile
// output columns per tile (against 128: chip_sweeps.py gmm_tile)
constexpr int kWN = 256;  // sweep: gmm_tile_n
constexpr int kWK = 64;         // k per ring stage: one 128-byte box row
constexpr int kWThreads = 384;  // consumer warpgroups 0, 1; producer 2
// epilogue by TMA stores where a warpgroup's rows lie in one group
// (against stores from the registers: chip_sweeps.py gmm_epilogue)
constexpr bool kTmaStore = true;  // sweep: gmm_tma_store

template <int BN>
struct WgmmaCfg {
  // 3 x 48 KB at BN 256, beside the 64 KB output tile: 4 would not fit
  static constexpr int kStages = 3;
  static constexpr int kABytes = kWM * kWK * 2;  // 16 KB lhs box
  static constexpr int kBBox = kWK * 64 * 2;     // 8 KB: one 64-column box
  static constexpr int kStageBytes = kABytes + (BN / 64) * kBBox;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // the output tile staged for TMA stores: BN / 64 boxes of 128 rows x 64
  // columns, 128-byte swizzled; warpgroup wg's rows are the box's half wg
  static constexpr int kOutBox = kWM * 128;
  static constexpr int kOutBytes = (BN / 64) * kOutBox;
  static constexpr int kTileBytes = kRingBytes + kOutBytes;
};

struct WTile {
  int tile, lo, hi, g, col0;  // row tile, the group's rows [lo, hi)
};

// work tile t of the list (item-major, column tile fastest); items[] are
// the running item counts of the e groups (items[e] = all items)
// Thread 0 of a persistent block: each group's clamped rows [lo, hi) and
// the running item counts of 128-row tiles (items[e] = all items)
__device__ void build_work_list(const int32_t* __restrict__ group_sizes,
                                int n, int e, int* seg_lo, int* seg_hi,
                                int* items) {
  long long start = 0;
  int total = 0;
  for (int g = 0; g < e; ++g) {
    const long long size = group_sizes[g] > 0 ? group_sizes[g] : 0;
    const int lo = (int)(start < n ? start : n);
    const int hi = (int)(start + size < n ? start + size : n);
    start += size;
    seg_lo[g] = lo;
    seg_hi[g] = hi;
    items[g] = total;
    if (hi > lo) total += (hi - 1) / kWM - lo / kWM + 1;
  }
  items[e] = total;
}

template <int BN>
__device__ __forceinline__ WTile locate(int t, int n_cols, int e,
                                        const int* seg_lo, const int* seg_hi,
                                        const int* items) {
  const int item = t / n_cols;
  int lo = 0, hi = e;  // first g with items[g] > item; its group is g - 1
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (items[mid] <= item) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int g = lo - 1;
  WTile w;
  w.g = g;
  w.lo = seg_lo[g];
  w.hi = seg_hi[g];
  w.tile = w.lo / kWM + (item - items[g]);
  w.col0 = (t - item * n_cols) * BN;
  return w;
}

template <int BN, typename E>
__global__ void __launch_bounds__(kWThreads, 1) gmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap lhs_map,
    const __grid_constant__ CUtensorMap rhs_map,
    const __grid_constant__ CUtensorMap out_map,
    const int32_t* __restrict__ group_sizes, E* __restrict__ out,
    int n, int k, int m, int e) {
  using C = WgmmaCfg<BN>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* staged = smem + C::kRingBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kTileBytes);
  uint64_t* empty = full + C::kStages;
  int* seg_lo = reinterpret_cast<int*>(empty + C::kStages);
  int* seg_hi = seg_lo + e;
  int* items = seg_hi + e;  // e + 1 running counts

  if (threadIdx.x == 0) {
    build_work_list(group_sizes, n, e, seg_lo, seg_hi, items);
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int n_cols = (m + BN - 1) / BN;
  const int n_tiles = items[e] * n_cols;
  const int ksteps = (k + kWK - 1) / kWK;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hopper::tma_prefetch(&lhs_map);
      hopper::tma_prefetch(&rhs_map);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const WTile w = locate<BN>(t, n_cols, e, seg_lo, seg_hi, items);
        for (int ks = 0; ks < ksteps; ++ks) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * C::kStageBytes;
          hopper::mbar_arrive_expect_tx(&full[stage], C::kStageBytes);
          hopper::tma_load_2d(st, &lhs_map, &full[stage], ks * kWK,
                              w.tile * kWM);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) {
            hopper::tma_load_3d(st + C::kABytes + j * C::kBBox, &rhs_map,
                                &full[stage], w.col0 + 64 * j, ks * kWK, w.g);
          }
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63
    hopper::setmaxnreg_inc<232>();
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const WTile w = locate<BN>(t, n_cols, e, seg_lo, seg_hi, items);
      int prev = 0;
      for (int ks = 0; ks < ksteps; ++ks) {
        hopper::mbar_wait(&full[stage], phase);
        const unsigned char* a = smem + stage * C::kStageBytes + wg * 64 * 128;
        const unsigned char* b = smem + stage * C::kStageBytes + C::kABytes;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWK / 16; ++kk) {
          hopper::wgmma_ss<BN, 1, E>(acc, hopper::desc_k_major(a + kk * 32),
                                  hopper::desc_mn_major(b + kk * 2048,
                                                        C::kBBox),
                                  ks > 0 || kk > 0);
        }
        hopper::wgmma_commit();
        // the previous step's products are done: release its stage
        hopper::wgmma_wait<1>();
        if (ks > 0 && lane == 0) hopper::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[prev]);

      // this warpgroup's 64 rows of the tile. All of them in the group
      // (rows past n included: TMA does not write them): staged in shared
      // memory and stored by TMA, which drains while the warpgroup runs
      // the next tile. A group boundary inside them: the group's rows
      // only, as bf16 pairs from the registers.
      const int base = w.tile * kWM + wg * 64;
      const int r_lo = warp * 16 + (lane >> 2);  // this lane's two rows
      if (kTmaStore && w.lo <= base && (w.hi >= base + 64 || w.hi == n)) {
        // the staging rows are free once the last store has read them
        if (tid == 0) hopper::bulk_wait_read<0>();
        hopper::named_bar_sync(1 + wg, 128);
        unsigned char* half = staged + wg * 64 * 128;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          // 16-byte chunk j % 8 of its 128-byte row, swizzled by row % 8
          unsigned char* box = half + (j >> 3) * C::kOutBox;
          const int chunk = ((j & 7) ^ (r_lo & 7)) * 16 + 4 * (lane & 3);
          *reinterpret_cast<uint32_t*>(box + r_lo * 128 + chunk) =
              pack2<E>(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(box + (r_lo + 8) * 128 + chunk) =
              pack2<E>(acc[4 * j + 2], acc[4 * j + 3]);
        }
        hopper::fence_proxy_async();
        hopper::named_bar_sync(1 + wg, 128);
        if (tid == 0) {
#pragma unroll
          for (int b = 0; b < BN / 64; ++b) {
            hopper::tma_store_2d(&out_map, half + b * C::kOutBox,
                                 w.col0 + 64 * b, base);
          }
          hopper::bulk_commit();
        }
      } else {
        const int r0 = max(w.lo, w.tile * kWM);
        const int r1 = min(w.hi, w.tile * kWM + kWM);
        const int row = base + r_lo;
        const bool lo_ok = row >= r0 && row < r1;
        const bool hi_ok = row + 8 >= r0 && row + 8 < r1;
        const int cb = w.col0 + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = cb + 8 * j;  // even; m % 8 == 0
          if (col < m) {
            if (lo_ok) {
              store2<E>(out + (size_t)row * m + col, acc[4 * j],
                        acc[4 * j + 1]);
            }
            if (hi_ok) {
              store2<E>(out + (size_t)(row + 8) * m + col, acc[4 * j + 2],
                        acc[4 * j + 3]);
            }
          }
        }
      }
    }
    // the stores must have read shared memory before the block ends
    if (tid == 0) hopper::bulk_wait<0>();
  }
}

template <int BN, typename E>
int launch_wgmma(const void* lhs, const void* rhs, const int32_t* gs,
                 void* out, int n, int k, int m, int e, cudaStream_t stream) {
  using C = WgmmaCfg<BN>;
  CUtensorMap lhs_map, rhs_map;
  const cuuint64_t l_dims[2] = {(cuuint64_t)k, (cuuint64_t)n};
  const cuuint64_t l_strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t l_box[2] = {64, kWM};
  int err = hopper::encode_16bit_map<E>(&lhs_map, lhs, 2, l_dims, l_strides,
                                        l_box);
  if (err) return err;
  const cuuint64_t r_dims[3] = {(cuuint64_t)m, (cuuint64_t)k, (cuuint64_t)e};
  const cuuint64_t r_strides[2] = {(cuuint64_t)m * 2,
                                   (cuuint64_t)k * m * 2};
  const cuuint32_t r_box[3] = {64, kWK, 1};
  err = hopper::encode_16bit_map<E>(&rhs_map, rhs, 3, r_dims, r_strides,
                                    r_box);
  if (err) return err;
  CUtensorMap out_map;
  const cuuint64_t o_dims[2] = {(cuuint64_t)m, (cuuint64_t)n};
  const cuuint64_t o_strides[1] = {(cuuint64_t)m * 2};
  const cuuint32_t o_box[2] = {64, 64};
  err = hopper::encode_16bit_map<E>(&out_map, out, 2, o_dims, o_strides,
                                    o_box);
  if (err) return err;
  // alignment slack, the ring and the staged output, full/empty
  // barriers, the work list
  const int smem = 1024 + C::kTileBytes + 2 * C::kStages * 8 +
                   (3 * e + 1) * 4;
  auto kernel = gmm_wgmma_kernel<BN, E>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  // at most row tiles + e items, times the column tiles
  const long long tiles =
      (long long)((n + kWM - 1) / kWM + e) * ((m + BN - 1) / BN);
  const int sms = hopper::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kWThreads, smem, stream>>>(
      lhs_map, rhs_map, out_map, gs, static_cast<E*>(out), n, k, m, e);
  return (int)cudaGetLastError();
}

template <typename L, typename R>
int launch_mma(const void* lhs, const void* rhs, const float* scales,
               const int32_t* gs, void* out, int n, int k, int m, int e,
               cudaStream_t stream) {
  auto kernel = gmm_mma_kernel<L, R>;
  constexpr int smem = tc_smem_bytes<R>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBM - 1) / kBM + e, (m + kBN - 1) / kBN);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const L*>(lhs), static_cast<const R*>(rhs), scales, gs,
      static_cast<L*>(out), n, k, m, e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 16-bit lhs (bf16 or f16, E) with int8 rhs on Hopper: the wgmma kernel's
// persistent grid, work list and mbarrier ring, with the rhs converted on
// its way to the tensor cores.
//
// What bounds it: operations, as the float kernel (2 n k m at the 16-bit
// rate), with a quarter of the rhs bytes; on the SM, shared memory: each
// k16 step moves the TMA writes, the conversion's int8 reads and 16-bit
// writes and the products' reads through it.
//
// 256 threads: two consumer warpgroups, thread 0 of which also issues
// each stage's TMA loads once both warpgroups have released it (no
// producer warp: its 168-register cap made the kernel spill). A ring
// stage holds the 128 x 64 lhs box (K-major, 128-byte swizzle, as the
// float kernel) and one int8 rhs box of 64 k-rows x 256 columns
// (MN-major, no swizzle: 16 KB, half the float kernel's rhs). Each
// consumer warpgroup owns 128 rows x 128 columns of the 128 x 256 tile
// (two m64n128k16 products per k16 step, 128 f32 accumulators a thread)
// and so needs only its own half of the rhs: it converts that half of
// each stage, int8 -> E (exact for |q| <= 128, by byte permutes and one
// subtraction, no conversion instruction), into one of kQDepth + 1
// buffers of its own, in the 128-byte-swizzled MN-major layout the float
// kernel's TMA writes (two 64-column boxes of 64 k-rows). Then
// fence.proxy.async (generic-proxy stores read by wgmma) and a named
// barrier of the warpgroup. The conversion of step ks overlaps the
// products of the kQDepth steps before it, still in flight; a buffer is
// written again only after the warpgroup's wait for the products that
// read it. A stage is released once both warpgroups' products of it are
// done. The per-column f32 scales of the
// tile's group multiply the f32 accumulators in the epilogue, before the
// cast (the TPU kernel's contrib * s_ref). The epilogue is the float
// kernel's (TMA stores of a staged copy where the whole tile lies in one
// group, else the group's rows from the registers); the staged copy
// lives in the warpgroup's converted buffers, free once its last products
// are done, and the next tile's first conversion waits for the stores to
// have read them.
//
// Shared memory: 4 stages x 32 KB + 2 x (kQDepth + 1) converted buffers
// x 16 KB: 192 KB. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_sweeps.py gmm_int8_stages): 3 stages 4-6 % slower than 4; two
// product groups in flight while converting no faster than one. Two
// other designs, each timed once on the up projection, were slower: a
// warpgroup owning 64 rows x 256 columns (one m64n256k16 product a step)
// on a tile both warpgroups convert behind a barrier of the two, 0.26 ms
// against 0.248; and the float kernel's consumers fed by a third
// warpgroup of three converting warps and a loading thread, 0.37 ms
// against 0.25 (the converters fell behind).

constexpr int kQStages = 4;  // sweep: gmm_int8_stages
// product groups a warpgroup leaves in flight while it converts the next
// stage (each reads its own converted buffer)
constexpr int kQDepth = 1;  // sweep: gmm_int8_depth
constexpr int kQN = 256;     // output columns per tile, 128 a warpgroup
// two consumer warpgroups and no producer warp: thread 0 issues the
// loads, so each thread may hold up to 255 registers (at 384 threads
// ptxas caps them at 168, and the 128 accumulators and the conversion
// spilled there)
constexpr int kQThreads = 256;

struct QCfg {
  static constexpr int kABytes = kWM * kWK * 2;  // 16 KB lhs box
  static constexpr int kBBytes = kWK * kQN;      // 16 KB int8 rhs box
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRingBytes = kQStages * kStageBytes;
  // one converted 64-column box: 64 k-rows x 128 bytes
  static constexpr int kConvBox = kWK * 128;
  static constexpr int kConvBuf = 2 * kConvBox;  // a warpgroup's columns
  static constexpr int kConvBufs = kQDepth + 1;   // a warpgroup's buffers
  static constexpr int kConvBytes = 2 * kConvBufs * kConvBuf;
  // the output staged for TMA stores, in the warpgroup's two converted
  // buffers: a box of 128 rows x 64 columns each
  static constexpr int kOutBox = kWM * 128;
  static_assert(2 * kOutBox <= kConvBufs * kConvBuf,
                "staging fits in a warpgroup's buffers");
  static constexpr int kTileBytes = kRingBytes + kConvBytes;
};

// 4 int8 values (one register) -> 4 E values (two registers), exact
template <typename E>
__device__ __forceinline__ void int8x4_to(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // each byte: q + 128, unsigned
  if constexpr (std::is_same<E, __half>::value) {
    // f16 bits 0x64xx = 1024 + xx, exactly; minus 1152 = q
    const uint32_t a = __byte_perm(u, 0x64646464u, 0x4140);
    const uint32_t b = __byte_perm(u, 0x64646464u, 0x4342);
    const __half2 bias = __halves2half2(__ushort_as_half(0x6480),
                                        __ushort_as_half(0x6480));
    __half2 ha = __hsub2(*reinterpret_cast<const __half2*>(&a), bias);
    __half2 hb = __hsub2(*reinterpret_cast<const __half2*>(&b), bias);
    lo = *reinterpret_cast<uint32_t*>(&ha);
    hi = *reinterpret_cast<uint32_t*>(&hb);
  } else {
    // f32 bits 0x4B0000xx = 2^23 + xx, exactly; minus 2^23 + 128 = q, a
    // float whose low 16 bits are 0, so its high half is the bf16 value
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
             8388736.f;
    }
    lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
}

// 64 rows of a warpgroup's 128 x 128 share, times the columns' scales,
// into the staged output (128-byte swizzled boxes of 64 columns)
template <typename E>
__device__ __forceinline__ void stage_rows(unsigned char* boxes,
                                           const float (&acc)[64], int row,
                                           const float2 (&sv)[16],
                                           int lane) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    unsigned char* box = boxes + (j >> 3) * QCfg::kOutBox;
    const int chunk = ((j & 7) ^ (row & 7)) * 16 + 4 * (lane & 3);
    *reinterpret_cast<uint32_t*>(box + row * 128 + chunk) =
        pack2<E>(acc[4 * j] * sv[j].x, acc[4 * j + 1] * sv[j].y);
    *reinterpret_cast<uint32_t*>(box + (row + 8) * 128 + chunk) =
        pack2<E>(acc[4 * j + 2] * sv[j].x, acc[4 * j + 3] * sv[j].y);
  }
}

// the same rows straight to out, only those in [r0, r1) and columns < m
template <typename E>
__device__ __forceinline__ void store_rows(E* __restrict__ out,
                                           const float (&acc)[64], int row,
                                           int r0, int r1, int cb, int m,
                                           const float2 (&sv)[16]) {
  const bool lo_ok = row >= r0 && row < r1;
  const bool hi_ok = row + 8 >= r0 && row + 8 < r1;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = cb + 8 * j;  // even; m % 16 == 0
    if (col >= m) continue;
    if (lo_ok) {
      store2<E>(out + (size_t)row * m + col, acc[4 * j] * sv[j].x,
                acc[4 * j + 1] * sv[j].y);
    }
    if (hi_ok) {
      store2<E>(out + (size_t)(row + 8) * m + col, acc[4 * j + 2] * sv[j].x,
                acc[4 * j + 3] * sv[j].y);
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(kQThreads, 1) gmm_wgmma_int8_kernel(
    const __grid_constant__ CUtensorMap lhs_map,
    const __grid_constant__ CUtensorMap rhs_map,
    const __grid_constant__ CUtensorMap out_map,
    const float* __restrict__ scales,  // [e, m]
    const int32_t* __restrict__ group_sizes, E* __restrict__ out, int n,
    int k, int m, int e) {
  using C = QCfg;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  unsigned char* conv = smem + C::kRingBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kTileBytes);
  uint64_t* empty = full + kQStages;
  int* seg_lo = reinterpret_cast<int*>(empty + kQStages);
  int* seg_hi = seg_lo + e;
  int* items = seg_hi + e;  // e + 1 running counts

  if (threadIdx.x == 0) {
    build_work_list(group_sizes, n, e, seg_lo, seg_hi, items);
    for (int s = 0; s < kQStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int n_cols = (m + kQN - 1) / kQN;
  const int n_tiles = items[e] * n_cols;
  const int ksteps = (k + kWK - 1) / kWK;
  const int wg = threadIdx.x / 128;  // owns columns 128 wg .. 128 wg + 127
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // ---- the loads: thread 0 issues the next (tile, k step) of this
  // block's sequence into the ring each time a stage is released
  int lt = blockIdx.x, lks = 0, lstage = 0;
  uint32_t lphase = 0;
  WTile lw;
  if (lt < n_tiles) lw = locate<kQN>(lt, n_cols, e, seg_lo, seg_hi, items);
  auto produce = [&]() {
    if (lt >= n_tiles) return;
    hopper::mbar_wait(&empty[lstage], lphase ^ 1);
    unsigned char* st = smem + lstage * C::kStageBytes;
    hopper::mbar_arrive_expect_tx(&full[lstage], C::kStageBytes);
    hopper::tma_load_2d(st, &lhs_map, &full[lstage], lks * kWK,
                        lw.tile * kWM);
    hopper::tma_load_3d(st + C::kABytes, &rhs_map, &full[lstage], lw.col0,
                        lks * kWK, lw.g);
    if (++lstage == kQStages) {
      lstage = 0;
      lphase ^= 1;
    }
    if (++lks == ksteps) {
      lks = 0;
      lt += gridDim.x;
      if (lt < n_tiles) {
        lw = locate<kQN>(lt, n_cols, e, seg_lo, seg_hi, items);
      }
    }
  };
  if (threadIdx.x == 0) {
    hopper::tma_prefetch(&lhs_map);
    hopper::tma_prefetch(&rhs_map);
    for (int s = 0; s < kQStages; ++s) produce();
  }

  unsigned char* my_conv = conv + wg * C::kConvBufs * C::kConvBuf;
  int stage = 0;
  uint32_t phase = 0;
  int step = 0;  // k steps so far: the converted buffer is step % kConvBufs
  float acc0[64], acc1[64];  // rows 0 .. 63, 64 .. 127 of the tile
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const WTile w = locate<kQN>(t, n_cols, e, seg_lo, seg_hi, items);
    // the ring stage of step ks - j is (stage - j) mod kQStages
    auto release = [&](int j) {
      if (lane == 0) {
        hopper::mbar_arrive(&empty[(stage - j + 2 * kQStages) % kQStages]);
      }
      if (threadIdx.x == 0) produce();
    };
    for (int ks = 0; ks < ksteps; ++ks, ++step) {
      if (ks == 0) {
        // the previous tile's TMA stores read the buffers first
        if (tid == 0) hopper::bulk_wait_read<0>();
        hopper::named_bar_sync(1 + wg, 128);
      }
      hopper::mbar_wait(&full[stage], phase);
      const unsigned char* a = smem + stage * C::kStageBytes;
      // this warpgroup's 128 columns of each 256-byte int8 k-row
      const unsigned char* q8 = a + C::kABytes + wg * 128;
      unsigned char* cb = my_conv + (step % C::kConvBufs) * C::kConvBuf;
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        // 8 consecutive threads (one shared-memory wavefront of 16-byte
        // stores) take k-rows 2 p and 2 p + 1, chunks 0-3 of one and 4-7
        // of the other: the two rows' swizzles differ in their lowest bit,
        // so the 8 stores land on distinct banks
        const int idx = tid + 128 * it;
        const int q = idx >> 3;
        const int half = (idx >> 2) & 1;
        const int row = (q & ~1) | (half ^ (q & 1));  // k-row 0 .. 63
        const int c16 = 4 * half + (idx & 3);  // 16 int8 values
        const uint4 raw =
            *reinterpret_cast<const uint4*>(q8 + row * kQN + c16 * 16);
        uint4 lo, hi;
        int8x4_to<E>(raw.x, lo.x, lo.y);
        int8x4_to<E>(raw.y, lo.z, lo.w);
        int8x4_to<E>(raw.z, hi.x, hi.y);
        int8x4_to<E>(raw.w, hi.z, hi.w);
        // 16-byte chunk ch of the box row lands at chunk ch ^ (row % 8)
        unsigned char* box = cb + (c16 >> 2) * C::kConvBox + row * 128;
        const int ch = (c16 & 3) * 2;
        *reinterpret_cast<uint4*>(box + ((ch ^ (row & 7)) * 16)) = lo;
        *reinterpret_cast<uint4*>(box + (((ch + 1) ^ (row & 7)) * 16)) = hi;
      }
      hopper::fence_proxy_async();
      hopper::named_bar_sync(1 + wg, 128);
      hopper::fence_regs(acc0);
      hopper::fence_regs(acc1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        const uint64_t b = hopper::desc_mn_major(cb + kk * 2048,
                                                 C::kConvBox);
        hopper::wgmma_ss<128, 1, E>(acc0, hopper::desc_k_major(a + kk * 32),
                                    b, ks > 0 || kk > 0);
        hopper::wgmma_ss<128, 1, E>(
            acc1, hopper::desc_k_major(a + 64 * 128 + kk * 32), b,
            ks > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      // the products of step ks - kQDepth are done: release their stage
      // (and their converted buffer is free for the next step), refill it
      hopper::wgmma_wait<kQDepth>();
      if (ks >= kQDepth) release(kQDepth);
      if (++stage == kQStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc0);
    hopper::fence_regs(acc1);
    // the tile's last stages, oldest first
    for (int j = min(kQDepth, ksteps); j >= 1; --j) release(j);

    // the group's per-column scales of this lane's 32 columns
    const int cb0 = w.col0 + 128 * wg + 2 * (lane & 3);
    float2 sv[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = cb0 + 8 * j;
      sv[j] = col < m ? *reinterpret_cast<const float2*>(
                            scales + (size_t)w.g * m + col)
                      : make_float2(0.f, 0.f);
    }
    const int base = w.tile * kWM;
    const int r_lo = warp * 16 + (lane >> 2);  // this lane's rows
    if (kTmaStore && w.lo <= base && (w.hi >= base + kWM || w.hi == n)) {
      // the whole tile in one group: staged in the warpgroup's converted
      // buffers (its products are done), then TMA stores that drain while
      // the next tile's first loads land
      unsigned char* boxes = my_conv;
      stage_rows<E>(boxes, acc0, r_lo, sv, lane);
      stage_rows<E>(boxes, acc1, 64 + r_lo, sv, lane);
      hopper::fence_proxy_async();
      hopper::named_bar_sync(1 + wg, 128);
      if (tid == 0) {
#pragma unroll
        for (int bx = 0; bx < 2; ++bx) {
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            hopper::tma_store_2d(&out_map,
                                 boxes + bx * C::kOutBox + rh * 64 * 128,
                                 w.col0 + 128 * wg + 64 * bx,
                                 base + 64 * rh);
          }
        }
        hopper::bulk_commit();
      }
    } else {
      const int r0 = max(w.lo, base);
      const int r1 = min(w.hi, base + kWM);
      store_rows<E>(out, acc0, base + r_lo, r0, r1, cb0, m, sv);
      store_rows<E>(out, acc1, base + 64 + r_lo, r0, r1, cb0, m, sv);
    }
  }
  // the stores must have read shared memory before the block ends
  if (tid == 0) hopper::bulk_wait<0>();
}

template <typename E>
int launch_wgmma_int8(const void* lhs, const void* rhs, const float* scales,
                      const int32_t* gs, void* out, int n, int k, int m,
                      int e, cudaStream_t stream) {
  using C = QCfg;
  CUtensorMap lhs_map, rhs_map, out_map;
  const cuuint64_t l_dims[2] = {(cuuint64_t)k, (cuuint64_t)n};
  const cuuint64_t l_strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t l_box[2] = {64, kWM};
  int err = hopper::encode_16bit_map<E>(&lhs_map, lhs, 2, l_dims, l_strides,
                                        l_box);
  if (err) return err;
  // int8 rhs (m, k, e): one 256-column x 64 k-row box, unswizzled
  const cuuint64_t r_dims[3] = {(cuuint64_t)m, (cuuint64_t)k, (cuuint64_t)e};
  const cuuint64_t r_strides[2] = {(cuuint64_t)m, (cuuint64_t)k * m};
  const cuuint32_t r_box[3] = {kQN, kWK, 1};
  err = hopper::encode_map(&rhs_map, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                           CU_TENSOR_MAP_SWIZZLE_NONE, rhs, 3, r_dims,
                           r_strides, r_box);
  if (err) return err;
  const cuuint64_t o_dims[2] = {(cuuint64_t)m, (cuuint64_t)n};
  const cuuint64_t o_strides[1] = {(cuuint64_t)m * 2};
  const cuuint32_t o_box[2] = {64, 64};
  err = hopper::encode_16bit_map<E>(&out_map, out, 2, o_dims, o_strides,
                                    o_box);
  if (err) return err;
  const int smem = 1024 + C::kTileBytes + 2 * kQStages * 8 + (3 * e + 1) * 4;
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // too many groups
  auto kernel = gmm_wgmma_int8_kernel<E>;
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const long long tiles =
      (long long)((n + kWM - 1) / kWM + e) * ((m + kQN - 1) / kQN);
  const int sms = hopper::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, kQThreads, smem, stream>>>(lhs_map, rhs_map, out_map,
                                            scales, gs, static_cast<E*>(out),
                                            n, k, m, e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lhs_dtype: 0 = float32, 1 = bfloat16, 2 = float16 (out shares it);
// rhs_int8: rhs is int8 with f32 scales [e, m] (else rhs has lhs's dtype
// and scales is null). variant: 0 = the kernel of the dtypes (f32 FMA, or
// mma.sync for 16-bit lhs); 1 = wgmma (16-bit lhs, k > 0; int8 rhs also
// needs m % 16 == 0).
int grouped_matmul_launch(const void* lhs, const void* rhs,
                          const void* scales, const void* group_sizes,
                          void* out, int n, int k, int m, int e,
                          int lhs_dtype, int rhs_int8, int variant,
                          void* stream) {
  if (n == 0 || m == 0 || e == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* gs = static_cast<const int32_t*>(group_sizes);
  const float* sc = static_cast<const float*>(scales);
  const bool half = lhs_dtype == 2;
  if (variant == 1) {
    if ((lhs_dtype != 1 && !half) || k == 0 || k % 8 || m % 8) {
      return (int)cudaErrorInvalidValue;
    }
    if (rhs_int8) {
      if (m % 16) return (int)cudaErrorInvalidValue;
      return half ? launch_wgmma_int8<__half>(lhs, rhs, sc, gs, out, n, k, m,
                                              e, s)
                  : launch_wgmma_int8<__nv_bfloat16>(lhs, rhs, sc, gs, out,
                                                     n, k, m, e, s);
    }
    return half ? launch_wgmma<kWN, __half>(lhs, rhs, gs, out, n, k, m, e, s)
                : launch_wgmma<kWN, __nv_bfloat16>(lhs, rhs, gs, out, n, k,
                                                   m, e, s);
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (lhs_dtype == 0) {
    const dim3 grid((n + kFM - 1) / kFM + e, (m + kFN - 1) / kFN);
    if (rhs_int8) {
      gmm_f32_kernel<int8_t><<<grid, kFThreads, 0, s>>>(
          static_cast<const float*>(lhs), static_cast<const int8_t*>(rhs), sc,
          gs, static_cast<float*>(out), n, k, m, e);
    } else {
      gmm_f32_kernel<float><<<grid, kFThreads, 0, s>>>(
          static_cast<const float*>(lhs), static_cast<const float*>(rhs),
          nullptr, gs, static_cast<float*>(out), n, k, m, e);
    }
    return (int)cudaGetLastError();
  }
  if (lhs_dtype == 1 || half) {
    if (k % 8 || m % 8) return (int)cudaErrorInvalidValue;
    if (half) {
      return rhs_int8 ? launch_mma<__half, int8_t>(lhs, rhs, sc, gs, out, n,
                                                   k, m, e, s)
                      : launch_mma<__half, __half>(lhs, rhs, nullptr, gs, out,
                                                   n, k, m, e, s);
    }
    return rhs_int8 ? launch_mma<__nv_bfloat16, int8_t>(lhs, rhs, sc, gs,
                                                        out, n, k, m, e, s)
                    : launch_mma<__nv_bfloat16, __nv_bfloat16>(
                          lhs, rhs, nullptr, gs, out, n, k, m, e, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
