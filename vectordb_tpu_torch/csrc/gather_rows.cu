// Random row gather for NVIDIA Hopper (sm_90a): out[i] = tab[clamp(ids[i])].
//
// Replaces benchmarks/gather_micro.py:pallas_gather, the Pallas TPU kernel
// that gathers table[ids] with one async DMA per row. In the port it serves
// every row gather of graph traversal, pruning and the device re-rank (the
// JAX package does these with jnp.take, ops/beam.py and index/graph.py):
// bf16 store rows, int32 adjacency rows, int8 fused-neighbour rows, f32
// re-rank rows, and 4-byte scalars (norms, representative ids, masks).
//
// Semantics: ids are int32, clamped to [0, n_rows - 1] exactly as the JAX
// callers' jnp.clip + jnp.take, and the bytes of the row are copied
// unchanged, so the output is bit-identical to
// table[ids.clamp(0, N - 1).long()].
//
// What bounds it: the bytes (ids read, rows read, rows written) at the HBM
// rate. Each row is a random read that waits a full memory latency, so the
// rate the card reaches is the bytes in flight over that latency (Little's
// law): at 3.35 TB/s and 1-2 us under load, megabytes across the card.
// One warp per row with one 16-byte load a lane keeps at most 256 bytes a
// warp in flight and leaves lanes idle on narrow rows.
//
// Design:
// - The work is the flat list of output vectors e = row * row_vecs + vec.
//   A warp copies 32 x U consecutive vectors a step, lane t the vectors
//   t, t + 32, ...: every lane works whatever the row width (32 vectors are
//   two bf16 rows, 2.7 adjacency rows or 32 scalars) and a warp's stores
//   are one contiguous span.
// - Vectors are 16, 8 or 4 bytes, the widest the row width and both
//   pointers allow.
// - A thread loads and clamps its U ids, issues its U row loads, and only
//   then stores: U = 2 loads of 16 bytes in flight a thread (1 KB a warp),
//   4 of 8 or 4 bytes. U = 2 timed best, or within the noise of U = 1, at
//   every row width the main path gathers; 4 and 8 mean fewer warps, which
//   slows the small gathers (PERF.md, section 6).
// - Row loads take the non-coherent path without L1 allocation; rows of
//   256 bytes and more add the L2 256-byte prefetch hint, so a bf16 row is
//   one request to the memory system instead of two 128-byte misses.
// - The grid has a warp per tile, in order, and the block scheduler
//   balances the load: the warps at work at any moment read and write one
//   moving front of the output. A persistent grid (SMs x the resident
//   blocks, striding over the tiles) left some warps a tile more than
//   others, and giving each of its warps an equal contiguous share spread
//   the stores over thousands of places at once; both timed slower.
// - The row of a vector comes from a multiply and a shift (FastDiv); a
//   launch covers fewer than 2^31 vectors, and larger gathers are split
//   into several launches on the host.
// - Each launch is a programmatic dependent launch: its blocks are set up
//   while the kernel before it drains, and wait (griddepcontrol.wait) for
//   that grid before touching memory. A plain launch left about 1.5 us
//   between back-to-back kernels, 4-5% of a 40 us gather.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxVecs = (1LL << 31) - 1;
constexpr int kUnroll = 2;  // loads in flight a thread for 16-byte vectors

// Unsigned division by a divisor fixed for the launch, as a multiply-high
// and a shift; exact for dividends below 2^31 (CUTLASS's FastDivmod).
struct FastDiv {
  uint32_t d, mul, shift;
  explicit FastDiv(uint32_t divisor) : d(divisor), mul(0), shift(0) {
    if (d != 1) {
      uint32_t log2 = 0;  // ceil(log2(d))
      while ((1ULL << log2) < d) ++log2;
      const uint32_t p = 31 + log2;
      mul = (uint32_t)(((1ULL << p) + d - 1) / d);
      shift = p - 32;
    }
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shift;
  }
};

template <int VB> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };

#define VDB_LD(hint) "ld.global.nc.L1::no_allocate" hint

template <bool kHint>
__device__ __forceinline__ void load(const uint4* p, uint4& v) {
  if (kHint) {
    asm volatile(VDB_LD(".L2::256B") ".v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else {
    asm volatile(VDB_LD("") ".v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  }
}

template <bool kHint>
__device__ __forceinline__ void load(const uint2* p, uint2& v) {
  if (kHint) {
    asm volatile(VDB_LD(".L2::256B") ".v2.u32 {%0, %1}, [%2];"
                 : "=r"(v.x), "=r"(v.y) : "l"(p));
  } else {
    asm volatile(VDB_LD("") ".v2.u32 {%0, %1}, [%2];"
                 : "=r"(v.x), "=r"(v.y) : "l"(p));
  }
}

template <bool kHint>
__device__ __forceinline__ void load(const uint32_t* p, uint32_t& v) {
  if (kHint) {
    asm volatile(VDB_LD(".L2::256B") ".u32 %0, [%1];" : "=r"(v) : "l"(p));
  } else {
    asm volatile(VDB_LD("") ".u32 %0, [%1];" : "=r"(v) : "l"(p));
  }
}

#undef VDB_LD

__device__ __forceinline__ void store(uint4* p, const uint4& v) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ void store(uint2* p, const uint2& v) {
  asm volatile("st.global.v2.u32 [%0], {%1, %2};"
               :: "l"(p), "r"(v.x), "r"(v.y) : "memory");
}

__device__ __forceinline__ void store(uint32_t* p, const uint32_t& v) {
  asm volatile("st.global.u32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// out[e] = tab[clamp(ids[e / row_vecs]) * row_vecs + e % row_vecs] for every
// vector e < n_vecs, in units of V.
template <typename V, int U, bool kHint>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ tab, const int32_t* __restrict__ ids,
                   V* __restrict__ out, uint32_t n_vecs, FastDiv row_vecs,
                   int32_t max_row) {
  constexpr uint32_t kTile = 32 * U;
  // Launched as a programmatic dependent of the kernel before it: wait here
  // until that grid has finished and its writes are visible, before any
  // read or write of global memory.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const uint32_t lane = threadIdx.x & 31;
  // Warp w copies tile w; the last block's spare warps have none.
  const uint64_t warp = (uint64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp * kTile >= n_vecs) return;
  const uint32_t base = (uint32_t)(warp * kTile);
  uint32_t row[U];
  int32_t r[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const uint32_t e = base + k * 32 + lane;
    row[k] = row_vecs.div(e < n_vecs ? e : 0);
    r[k] = e < n_vecs ? __ldg(ids + row[k]) : 0;
  }
  V v[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const uint32_t e = base + k * 32 + lane;
    const int32_t rr = r[k] < 0 ? 0 : (r[k] > max_row ? max_row : r[k]);
    const uint32_t vec = e - row[k] * row_vecs.d;
    if (e < n_vecs) load<kHint>(tab + (uint64_t)rr * row_vecs.d + vec, v[k]);
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const uint32_t e = base + k * 32 + lane;
    if (e < n_vecs) store(out + e, v[k]);
  }
}

template <int VB, int U, bool kHint>
int launch(const void* tab, const int32_t* ids, void* out, long long n_ids,
           long long n_rows, long long row_bytes, cudaStream_t st) {
  using V = typename Vec<VB>::T;
  const long long row_vecs = row_bytes / VB;
  if (row_vecs > kMaxVecs) return (int)cudaErrorInvalidValue;
  const int32_t max_row =
      (int32_t)(n_rows - 1 < 2147483647LL ? n_rows - 1 : 2147483647LL);
  const FastDiv div((uint32_t)row_vecs);
  const long long ids_per_launch = kMaxVecs / row_vecs;
  for (long long s = 0; s < n_ids; s += ids_per_launch) {
    const long long m = n_ids - s < ids_per_launch ? n_ids - s
                                                   : ids_per_launch;
    const long long n_vecs = m * row_vecs;
    const long long tiles = (n_vecs + 32 * U - 1) / (32 * U);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((tiles + kWarps - 1) / kWarps));
    cfg.blockDim = dim3(kThreads);
    cfg.stream = st;
    cudaLaunchAttribute pdl[1];
    pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = pdl;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, gather_rows_kernel<V, U, kHint>, static_cast<const V*>(tab),
        ids + s, static_cast<V*>(out) + s * row_vecs, (uint32_t)n_vecs, div,
        max_row);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <int VB, int U>
int launch_hinted(const void* tab, const int32_t* ids, void* out,
                  long long n_ids, long long n_rows, long long row_bytes,
                  cudaStream_t st) {
  if (row_bytes >= 256) {
    return launch<VB, U, true>(tab, ids, out, n_ids, n_rows, row_bytes, st);
  }
  return launch<VB, U, false>(tab, ids, out, n_ids, n_rows, row_bytes, st);
}

}  // namespace

// Launches on `stream` (on the current device) and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for arguments
// the kernel does not take. tab is [n_rows, row_bytes] and out
// [n_ids, row_bytes], both contiguous; row_bytes is a positive multiple of 4
// and both pointers are 4-byte aligned.
extern "C" int vdb_gather_rows(const void* tab, const int32_t* ids, void* out,
                               long long n_ids, long long n_rows,
                               long long row_bytes, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(tab) |
                          reinterpret_cast<uintptr_t>(out);
  if (n_ids < 0 || n_rows <= 0 || row_bytes <= 0 || row_bytes % 4 != 0 ||
      align % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_ids == 0) return (int)cudaGetLastError();
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0 && align % 16 == 0) {
    return launch_hinted<16, kUnroll>(tab, ids, out, n_ids, n_rows,
                                      row_bytes, st);
  }
  if (row_bytes % 8 == 0 && align % 8 == 0) {
    return launch_hinted<8, 2 * kUnroll>(tab, ids, out, n_ids, n_rows,
                                         row_bytes, st);
  }
  return launch_hinted<4, 2 * kUnroll>(tab, ids, out, n_ids, n_rows,
                                       row_bytes, st);
}
