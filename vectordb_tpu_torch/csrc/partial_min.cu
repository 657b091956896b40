// Fused distance + grouped partial-min scan for NVIDIA Hopper (sm_90a).
//
// Replaces vectordb_tpu/ops/pallas_topk.py:_partial_min_kernel, the Pallas
// TPU kernel behind flat-serve and the exact-KNN build. It computes the same
// thing with the same survivor layout, so the survivor-width gates and the
// position-by-position tests carry over unchanged:
//   * the table is cut into tiles of TC rows (TC = pick_tile_c(D)); a tile is
//     fold = TC/128 stripes of 128 rows, and row j of a tile joins group
//     j mod 128 of that tile;
//   * each (query, group) keeps its best and second-best (score, global row),
//     compared with strict <, so the earlier stripe wins a tie; before any
//     update the second-best is +inf with the id of the stripe-0 row;
//   * output [B, 2*G] with G = N/fold: column t*128 + lane holds the best of
//     group `lane` of tile t, column G + t*128 + lane the second-best.
// Scores (L2 = |q|^2 - 2 q.x + |x|^2, cosine = 1 - q.x, dot = -q.x) are
// accumulated in f32 from exact products and never reach device memory.
// Rows >= n_valid, rows whose mask is 0 and, with exclude_self, the row
// q_base + (query index in the batch) score +inf.
//
// What bounds it: 2*B*N*D FLOPs. At flat-serve (B = 8192, N = 262,144,
// D = 128) that is 5.50e11 FLOP, 0.556 ms on the bf16 tensor cores, against
// 608 MB of inputs and survivor planes read or written once (0.18 ms at
// 3.35 TB/s); at a KNN block (B = 1,024, N = 1,048,576) 2.75e11 FLOP,
// 0.278 ms, against 545 MB (0.16 ms). So the product on the tensor cores
// bounds it, and after the product the fold: about ten CUDA-core
// instructions for each of the B*N scores.
//
// Design of the bf16 path (the main path: the device store is bf16):
//   * wgmma.mma_async m64n64k16, bf16 x bf16 -> f32 accumulators in
//     registers. Queries [B, D] and table rows [N, D] are both K-major, read
//     from shared memory through 128-byte-swizzled descriptors.
//   * One block per (128-query tile, table tile, half of the 128 lanes):
//     two consumer warpgroups of 64 queries each fold the same 64 lanes, so
//     a consumer thread owns 32 (query, lane) cells: 32 accumulators and
//     3 x 32 words of state (best, second, packed stripe ids), no spills.
//     blockIdx.x walks the query tiles of one table tile first, so a table
//     tile is read from HBM once and from L2 after that.
//   * One producer thread streams the stripe halves (64 rows, all of D as
//     64-dim chunks, in one 3D TMA request) and their column terms through
//     a 128 KB ring with mbarriers. At D <= 256 the 128-query tile is
//     loaded once and stays in shared memory; above that its 64-dim chunks
//     travel with the table's, one chunk a stage.
//   * The fold runs in the accumulator's own layout: each accumulator
//     element folds into the same thread's state for that cell, with no
//     shuffles. n_valid and the mask arrive folded into one per-column term
//     (|x|^2 or 0, +inf for an excluded row), so a score is one FMA and one
//     add; exclude_self is tested only in stripes that hold a query's own
//     row. Values take three min/max, ids two compares and two predicated
//     byte permutes: 9 instructions a score, no branch. While one
//     warpgroup folds, the other's product runs.
//   * The survivor planes are staged in shared memory and written by TMA
//     stores as whole 256-byte rows, not as 32-byte pieces of 16 rows.
// The fold, not the product, sets the pace: at flat-serve the scan takes
// 2.29 ms, 1.60 with the product compiled out of a copy of this source,
// 0.50 with the fold compiled out (an NVIDIA H100 80GB HBM3, 700 W;
// PERF.md). The f32 path (is_bf16 = 0)
// stays on the CUDA cores: tensor cores would need TF32, which changes
// results; the main path never takes it.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kEuclidean = 1;  // schema.MetricType values
constexpr int kCosine = 2;

// ---------------------------------------------------------------------------
// f32 path: CUDA-core FMAs, one block per (64-query tile, table tile).
// ---------------------------------------------------------------------------

constexpr int kQT = 64;        // queries per block
constexpr int kLanes = 128;    // rows per stripe = groups per table tile
constexpr int kKC = 32;        // feature dims per shared-memory chunk
constexpr int kThreads = 256;  // 16 query groups x 16 lane groups

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Lane (column within a stripe) of register column j for lane group tx:
// two runs of four, 64 apart, so a warp's float4 reads of a staged row
// cover contiguous shared memory.
__device__ __forceinline__ int lane_of(int tx, int j) {
  return (j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
partial_min_kernel(const T* __restrict__ q, const float* __restrict__ qn,
                   const T* __restrict__ tab, const float* __restrict__ nrm,
                   const float* __restrict__ mask, float* __restrict__ out_val,
                   int32_t* __restrict__ out_idx, int d, int tile_c,
                   int n_valid, int metric, int exclude_self, int q_base,
                   int gcols) {
  __shared__ __align__(16) float qs[kKC][kQT];
  __shared__ __align__(16) float xs[kKC][kLanes];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // lane group: 8 lanes
  const int ty = tid >> 4;   // query group: 4 queries
  const int q0 = blockIdx.x * kQT;
  const int col0 = blockIdx.y * tile_c;
  const int fold = tile_c / kLanes;

  int qrow[4];
  float qn_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qrow[i] = q0 + ty * 4 + i;
    qn_r[i] = qn[qrow[i]];
  }

  // Running best / second-best per (query, lane) cell; ix packs the stripe
  // of the best (low 16 bits) and of the second-best (high 16 bits).
  float m[4][8], m2[4][8];
  uint32_t ix[4][8];

  for (int s = 0; s < fold; ++s) {
    const int row0 = col0 + s * kLanes;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kKC) {
      __syncthreads();  // the previous chunk's reads are done
      {
        // 64 query rows x 4 groups of 8 dims: one group per thread.
        const int r = tid >> 2, g = tid & 3;
        float v[8];
        load8(q + (size_t)(q0 + r) * d + k0 + g * 8, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) qs[g * 8 + e][r] = v[e];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // 128 table rows x 4 groups of 8 dims: two groups per thread.
        const int gi = tid + h * kThreads;
        const int r = gi >> 2, g = gi & 3;
        float v[8];
        load8(tab + (size_t)(row0 + r) * d + k0 + g * 8, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) xs[g * 8 + e][r] = v[e];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[kk][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&xs[kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&xs[kk][64 + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    // Fold this stripe into the running best / second-best.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = row0 + lane_of(tx, j);
      const bool bad = col >= n_valid || mask[col] == 0.f;
      const float xn = nrm[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float sc;
        if (metric == kEuclidean) {
          sc = qn_r[i] - 2.f * acc[i][j] + xn;
        } else if (metric == kCosine) {
          sc = 1.f - acc[i][j];
        } else {
          sc = -acc[i][j];
        }
        if (bad || (exclude_self && col == q_base + qrow[i])) sc = CUDART_INF_F;
        if (s == 0) {
          m[i][j] = sc;
          m2[i][j] = CUDART_INF_F;
          ix[i][j] = 0u;
        } else if (sc < m[i][j]) {  // new best demotes the old best
          m2[i][j] = m[i][j];
          m[i][j] = sc;
          ix[i][j] = ((ix[i][j] & 0xffffu) << 16) | (uint32_t)s;
        } else if (sc < m2[i][j]) {  // competes for the second slot only
          m2[i][j] = sc;
          ix[i][j] = (ix[i][j] & 0xffffu) | ((uint32_t)s << 16);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lane = lane_of(tx, j);
      const size_t o =
          (size_t)qrow[i] * (2 * (size_t)gcols) + blockIdx.y * kLanes + lane;
      out_val[o] = m[i][j];
      out_idx[o] = col0 + (int)(ix[i][j] & 0xffffu) * kLanes + lane;
      out_val[o + gcols] = m2[i][j];
      out_idx[o + gcols] = col0 + (int)(ix[i][j] >> 16) * kLanes + lane;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 path: wgmma on the tensor cores, TMA ring, fold in registers.
// ---------------------------------------------------------------------------

constexpr int kBM = 128;                 // queries per block
constexpr int kBN = 64;                  // lanes per block: half a stripe
constexpr int kBK = 64;                  // dims per chunk: 128 bytes of bf16
constexpr int kTcThreads = 384;          // producer + two consumer groups
constexpr int kBChunk = kBN * kBK * 2;   // table chunk bytes (8 KB)
constexpr int kAChunk = kBM * kBK * 2;   // query chunk bytes (16 KB)
constexpr int kResidentMaxD = 256;       // query tile stays in smem up to here
constexpr int kRingBytes = 128 * 1024;   // table ring when the tile stays
constexpr int kStagesStreamed = 6;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// 2D TMA load of one box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x),
         "r"(y)
      : "memory");
}

// 3D TMA load: all the 64-dim chunks of a box of rows in one request.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int x, int y,
                                            int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x),
         "r"(y), "r"(z)
      : "memory");
}

// Shared-memory descriptor of a K-major operand stored as 128-byte rows in
// 128-byte-swizzled atoms of 8 rows (1,024 bytes, the TMA's SWIZZLE_128B
// layout): start address / 16, leading offset unused, stride 1,024 bytes
// between atoms, layout type 1 (128B swizzle). One k16 step is +32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous product.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Bulk copy of `bytes` contiguous bytes into shared memory on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// 2D TMA store of one box from shared memory; completes with the bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(x), "r"(y)
      : "memory");
}

// A consumer thread's 32 (query, lane) cells and the constants of their
// scores.
struct FoldState {
  float m[32], m2[32];  // best and second-best score
  uint32_t ix[32];      // stripe of the best (low 16 bits), of the second
  float cq[2];          // |q|^2 (L2), 1 (cosine) or 0 (dot) of its two rows
  float alpha;          // -2 (L2) or -1
  int r0, cpair, self0;
};

template <bool kSelf>
__device__ __forceinline__ void fold_cells(FoldState& f, const float (&acc)[32],
                                           const float2 (&tv)[8], uint32_t s,
                                           int cb) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int j = i >> 2, hi = (i >> 1) & 1, odd = i & 1;
    // The epilogue's order: (|q|^2 - 2 acc) + term, (1 - acc) + term,
    // (-acc) + term; one FMA (the product by 2 or -1 is exact) and one add.
    float sc = fmaf(f.alpha, acc[i], f.cq[hi]) + (odd ? tv[j].y : tv[j].x);
    if (kSelf && cb + 8 * j + f.cpair + odd == f.self0 + f.r0 + 8 * hi)
      sc = CUDART_INF_F;
    // Ids first, from the old best and second. A new second puts s in the
    // high half (selector 0x5410); a new best (always also a new second)
    // then moves the kept low half, the old best, up and puts s in the low
    // half (0x1054). Predicated, so that no cell branches.
    asm("{\n\t.reg .pred pb, ps;\n\t"
        "setp.lt.f32 pb, %1, %2;\n\t"
        "setp.lt.f32 ps, %1, %3;\n\t"
        "@ps prmt.b32 %0, %0, %4, 0x5410;\n\t"
        "@pb prmt.b32 %0, %0, %4, 0x1054;\n\t}"
        : "+r"(f.ix[i])
        : "f"(sc), "f"(f.m[i]), "f"(f.m2[i]), "r"(s));
    // Strict <: a new best demotes the old one, else sc competes for the
    // second slot; min/max give the same values as that sequence.
    f.m2[i] = fminf(f.m2[i], fmaxf(f.m[i], sc));
    f.m[i] = fminf(f.m[i], sc);
  }
}

// Folds stripe s (global row of its lane 0: cb). Only a stripe that holds
// one of the block's queries' own rows tests exclude_self.
__device__ __forceinline__ void fold_stripe(FoldState& f,
                                            const float (&acc)[32],
                                            const float2 (&tv)[8], int s,
                                            int cb, bool exclude_self) {
  if (exclude_self && cb < f.self0 + kBM && f.self0 < cb + kBN)
    fold_cells<true>(f, acc, tv, (uint32_t)s, cb);
  else
    fold_cells<false>(f, acc, tv, (uint32_t)s, cb);
}

// kNK > 0: D = 64 * kNK <= 256, the query tile stays in shared memory and
// the chunk loop is unrolled; kNK = 0: query chunks are streamed.
template <int kNK>
__global__ void __launch_bounds__(kTcThreads, 1)
partial_min_wgmma(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap tmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __grid_constant__ CUtensorMap imap,
                  const float* __restrict__ qn, const float* __restrict__ term,
                  int d, int tile_c, int metric, int exclude_self, int q_base,
                  int gcols) {
  extern __shared__ uint8_t smem_raw[];
  // Shared memory, 1,024-byte aligned for the 128-byte swizzle: [resident
  // query tile: nk chunks of 16 KB] [ring of stages: a stripe half's kNK
  // table chunks of 8 KB each, or (streamed) one table chunk + one query
  // chunk of 16 KB] [resident: the stripe half's column term, 256 bytes a
  // stage] [full, empty barriers] [query bar]. After the scan the first
  // 128 KB stage the survivor planes for the TMA stores.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  constexpr bool resident = kNK > 0;
  const int nk = resident ? kNK : d / kBK;
  const uint32_t stage_bytes =
      resident ? kNK * kBChunk : kBChunk + kAChunk;
  const int stages = resident ? kRingBytes / (kNK * kBChunk)
                              : kStagesStreamed;
  const uint32_t a_res = base;
  const uint32_t ring = base + (resident ? nk * kAChunk : 0);
  const uint32_t tslots = ring + stages * stage_bytes;
  const uint32_t bars = tslots + (resident ? stages * kBN * 4 : 0);
  const uint32_t qbar = bars + 16 * stages;
#define FULL_BAR(i) (bars + 8u * (i))
#define EMPTY_BAR(i) (bars + 8u * (stages + (i)))

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBM;
  const int tile = blockIdx.y >> 1;
  const int lane0 = (blockIdx.y & 1) * kBN;
  const int col0 = tile * tile_c;
  const int fold = tile_c / kLanes;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(FULL_BAR(i), 1);
      mbar_init(EMPTY_BAR(i), 8);  // lane 0 of each consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // Producer warpgroup: one thread issues every copy.
    if (tid == 0) {
      if (resident) {
        mbar_expect_tx(qbar, nk * kAChunk);
        for (int c = 0; c < nk; ++c)
          tma_load(a_res + c * kAChunk, &qmap, qbar, c * kBK, q0);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < fold && resident; ++s) {
        // One 3D request: the stripe half's 64 rows, all kNK chunks.
        // With it, the stripe half's column term (64 floats).
        const int row = col0 + s * kLanes + lane0;
        mbar_wait(EMPTY_BAR(stage), phase ^ 1u);
        mbar_expect_tx(FULL_BAR(stage), stage_bytes + kBN * 4);
        tma_load_3d(ring + stage * stage_bytes, &tmap, FULL_BAR(stage), 0,
                    row, 0);
        bulk_load(tslots + stage * kBN * 4, term + row, kBN * 4,
                  FULL_BAR(stage));
        if (++stage == stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
      for (int s = 0; s < fold && !resident; ++s) {
        for (int c = 0; c < nk; ++c) {
          mbar_wait(EMPTY_BAR(stage), phase ^ 1u);
          const uint32_t dst = ring + stage * stage_bytes;
          mbar_expect_tx(FULL_BAR(stage), stage_bytes);
          tma_load(dst, &tmap, FULL_BAR(stage), c * kBK,
                   col0 + s * kLanes + lane0);
          tma_load(dst + kBChunk, &qmap, FULL_BAR(stage), c * kBK, q0);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg folds queries 64*wg .. 64*wg + 63 of the block.
  const int wg = (tid >> 7) - 1;
  const int lane = tid & 31;
  FoldState f;
  // Accumulator layout of m64nNk16: element i of a thread sits at row
  // r0 + 8*((i >> 1) & 1), column 8*(i >> 2) + cpair + (i & 1).
  f.r0 = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
  f.cpair = 2 * (lane & 3);
  f.self0 = q_base + q0;  // global row of the block's query 0
  if (metric == kEuclidean) {
    f.cq[0] = qn[q0 + f.r0];
    f.cq[1] = qn[q0 + f.r0 + 8];
    f.alpha = -2.f;
  } else {
    f.cq[0] = f.cq[1] = (metric == kCosine) ? 1.f : 0.f;
    f.alpha = -1.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    f.m[i] = CUDART_INF_F;
    f.m2[i] = CUDART_INF_F;
    f.ix[i] = 0u;
  }

  const uint32_t a_off = wg * (64 * 128);  // this group's 64 query rows
  const int cb0 = col0 + lane0;            // global row of stripe 0, lane 0
  const bool excl = exclude_self != 0;
  int is = 0;  // next stage to consume
  uint32_t iph = 0;
  auto next_is = [&]() {
    if (++is == stages) {
      is = 0;
      iph ^= 1u;
    }
  };

  if constexpr (resident) {
    // One stripe at a time per group: the stripe half's products in one
    // commit, its term read, its stage handed back once the products are
    // done, then the fold. The two consumer groups share the tensor cores,
    // so one group's product runs while the other folds. (A second
    // accumulator would let a group overlap itself, but 2 x 32 accumulators
    // + 96 words of state do not fit the 168 registers a thread of a
    // 384-thread block gets, and ptxas then spills and serializes every
    // wgmma.)
    mbar_wait(qbar, 0);
    float acc[32];
    float2 tv[8];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int s = 0; s < fold; ++s) {
      mbar_wait(FULL_BAR(is), iph);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kNK; ++c) {
        const uint64_t da = sw128_desc(a_res + c * kAChunk + a_off);
        const uint64_t db = sw128_desc(ring + is * stage_bytes + c * kBChunk);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_64x64x16(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
      }
      wgmma_commit();
      const float2* ts = reinterpret_cast<const float2*>(
          smem_raw + (tslots + is * kBN * 4 - smem_u32(smem_raw)));
#pragma unroll
      for (int j = 0; j < 8; ++j) tv[j] = ts[4 * j + (lane & 3)];
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(EMPTY_BAR(is));
      next_is();
      fold_stripe(f, acc, tv, s, cb0 + s * kLanes, excl);
    }
  } else {
    // Streamed query chunks: one stripe at a time, each stage handed back
    // as soon as the product that read it is done; the term comes from
    // global memory.
    int rs = 0;  // next stage to release
    auto next_rs = [&]() {
      if (++rs == stages) rs = 0;
    };
    float acc[32];
    float2 tv[8];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int s = 0; s < fold; ++s) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tv[j] = *reinterpret_cast<const float2*>(term + cb0 + s * kLanes +
                                                 8 * j + f.cpair);
      fence_acc(acc);
      wgmma_fence();
      for (int c = 0; c < nk; ++c) {
        mbar_wait(FULL_BAR(is), iph);
        const uint32_t bst = ring + is * stage_bytes;
        const uint64_t da = sw128_desc(bst + kBChunk + a_off);
        const uint64_t db = sw128_desc(bst);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_64x64x16(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (c > 0) {
          if (lane == 0) mbar_arrive(EMPTY_BAR(rs));
          next_rs();
        }
        next_is();
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(EMPTY_BAR(rs));
      next_rs();
      fold_stripe(f, acc, tv, s, cb0 + s * kLanes, excl);
    }
  }
#undef FULL_BAR
#undef EMPTY_BAR

  // Survivor planes: staged in shared memory as four [64 rows][64 lanes]
  // boxes per group (best and second values, best and second ids), then
  // written by TMA as whole 256-byte rows. The ring and the query tile are
  // free once both groups' last products are done.
  asm volatile("bar.sync 1, 256;" ::: "memory");
  const uint32_t stg = base + wg * 4 * (64 * kBN * 4);
  const int rl = ((tid & 127) >> 5) * 16 + (lane >> 2);  // row in the group
  const int id0 = col0 + lane0;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int j = i >> 2, hi = (i >> 1) & 1;
    const int c = 8 * j + f.cpair;
    const uint32_t off = ((rl + 8 * hi) * kBN + c) * 4;
    uint2* plane = reinterpret_cast<uint2*>(
        smem_raw + (stg + off - smem_u32(smem_raw)));
    const int col = id0 + c;
    plane[0] =
        make_uint2(__float_as_uint(f.m[i]), __float_as_uint(f.m[i + 1]));
    plane[kBN * 64 / 2] =
        make_uint2(__float_as_uint(f.m2[i]), __float_as_uint(f.m2[i + 1]));
    plane[kBN * 64] =
        make_uint2(col + (f.ix[i] & 0xffffu) * kLanes,
                   col + 1 + (f.ix[i + 1] & 0xffffu) * kLanes);
    plane[kBN * 64 * 3 / 2] =
        make_uint2(col + (f.ix[i] >> 16) * kLanes,
                   col + 1 + (f.ix[i + 1] >> 16) * kLanes);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" :: "r"(2 + wg) : "memory");
  if ((tid & 127) == 0) {
    const int x = tile * kLanes + lane0, y = q0 + wg * 64;
    constexpr uint32_t kPlane = 64 * kBN * 4;
    tma_store(&vmap, stg, x, y);
    tma_store(&vmap, stg + kPlane, gcols + x, y);
    tma_store(&imap, stg + 2 * kPlane, x, y);
    tma_store(&imap, stg + 3 * kPlane, gcols + x, y);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

// cuTensorMapEncodeTiled of libcuda, fetched through the runtime so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a row-major bf16 [rows, d] matrix with the 128-byte
// swizzle. chunks = 0: 2D, boxes of box_rows x 64 dims. chunks > 0: 3D view
// (64 dims, rows, d / 64 chunks), boxes of box_rows x all `chunks` chunks,
// which land chunk after chunk as the descriptors expect.
// Tensor map of a row-major 32-bit [rows, cols] matrix written in boxes of
// 64 x 64 (the survivor planes).
bool out_map(CUtensorMap* map, void* ptr, int rows, int cols,
             CUtensorMapDataType type) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kBN, 64};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, type, 2, ptr, dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool bf16_map(CUtensorMap* map, const void* ptr, int rows, int d,
              int box_rows, int chunks) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)(chunks ? kBK : d),
                              (cuuint64_t)rows, (cuuint64_t)(d / kBK)};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)kBK * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kBK, (cuuint32_t)box_rows,
                             (cuuint32_t)chunks};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, chunks ? 3 : 2,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* q, const float* qn, const void* tab,
                const float* term, float* out_val, int32_t* out_idx, int b,
                int n, int d, int tile_c, int metric, int exclude_self,
                int q_base, cudaStream_t st) {
  if (b % kBM != 0 || d % kBK != 0 || (n / tile_c) * 2 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int nk = d / kBK;
  const bool resident = d <= kResidentMaxD;
  const int gcols = n / (tile_c / kLanes);
  CUtensorMap qmap, tmap, vmap, imap;
  if (!bf16_map(&qmap, q, b, d, kBM, 0) ||
      !bf16_map(&tmap, tab, n, d, kBN, resident ? nk : 0) ||
      !out_map(&vmap, out_val, b, 2 * gcols, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !out_map(&imap, out_idx, b, 2 * gcols, CU_TENSOR_MAP_DATA_TYPE_INT32)) {
    return (int)cudaErrorInvalidValue;
  }
  const int stages = resident ? kRingBytes / (nk * kBChunk) : kStagesStreamed;
  const int smem =
      1024 +
      (resident ? nk * kAChunk + kRingBytes + stages * kBN * 4
                : stages * (kBChunk + kAChunk)) +
      (2 * stages + 1) * 8;
  auto kernel = partial_min_wgmma<4>;
  if (!resident) {
    kernel = partial_min_wgmma<0>;
  } else if (nk == 1) {
    kernel = partial_min_wgmma<1>;
  } else if (nk == 2) {
    kernel = partial_min_wgmma<2>;
  } else if (nk == 3) {
    kernel = partial_min_wgmma<3>;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // blockIdx.x walks the query tiles of one table tile first.
  const dim3 grid(b / kBM, (n / tile_c) * 2);
  kernel<<<grid, kTcThreads, smem, st>>>(qmap, tmap, vmap, imap, qn, term, d,
                                         tile_c, metric, exclude_self, q_base,
                                         gcols);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for shapes the kernel does not take. All tensors are
// contiguous; q/tab are bf16 (is_bf16 = 1) or f32, 16-byte aligned. `term`
// is the bf16 path's per-column term (ops/partial_min.column_term: |x|^2 for
// L2 or 0, +inf for rows >= n_valid or masked); the f32 path reads nrm,
// mask and n_valid instead.
extern "C" int vdb_partial_min(const void* q, const float* qn, const void* tab,
                               const float* nrm, const float* mask,
                               const float* term, float* out_val,
                               int32_t* out_idx, int b, int n, int d,
                               int tile_c, int n_valid, int metric,
                               int exclude_self, int q_base, int is_bf16,
                               void* stream) {
  if (b <= 0 || n <= 0 || b % kQT != 0 || tile_c <= 0 ||
      tile_c % kLanes != 0 || n % tile_c != 0 || d <= 0 || d % kKC != 0 ||
      tile_c / kLanes > 0xffff || n / tile_c > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_bf16(q, qn, tab, term, out_val, out_idx, b, n, d, tile_c,
                       metric, exclude_self, q_base, st);
  }
  const dim3 grid(b / kQT, n / tile_c);
  const int gcols = n / (tile_c / kLanes);
  partial_min_kernel<float><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), qn, static_cast<const float*>(tab), nrm,
      mask, out_val, out_idx, d, tile_c, n_valid, metric, exclude_self,
      q_base, gcols);
  return (int)cudaGetLastError();
}
