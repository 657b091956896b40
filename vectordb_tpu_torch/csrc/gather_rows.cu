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
// What bounds it: each output row is one random read of `row_bytes` from
// device memory. For the traversal's 128-256-byte rows the cost is the
// count of random 32-byte sectors the memory system serves, not the bytes:
// the row count bounds it, as the TPU file found for its own gather. The
// int8 fused rows (6 KB) move enough bytes to be bandwidth-bound instead.
//
// Design (simple first): one warp per output row, eight rows per block, a
// grid-stride loop over rows. A warp copies its row with 16-byte vector
// loads and stores when the row and both pointers allow it (every row of
// the traversal does), with 4-byte words otherwise. Read-only loads go
// through the non-coherent cache. Async copies, TMA and L2 residency hints
// are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr long long kMaxBlocks = 1 << 20;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const V* __restrict__ tab, const int32_t* __restrict__ ids,
                   V* __restrict__ out, long long n_ids, long long n_rows,
                   long long row_vecs) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long i = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       i < n_ids; i += stride) {
    long long r = __ldg(ids + i);
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    const V* src = tab + r * row_vecs;
    V* dst = out + i * row_vecs;
    for (long long c = lane; c < row_vecs; c += 32) dst[c] = __ldg(src + c);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take. tab is
// [n_rows, row_bytes] and out [n_ids, row_bytes], both contiguous; row_bytes
// is a positive multiple of 4 and both pointers are 4-byte aligned.
extern "C" int vdb_gather_rows(const void* tab, const int32_t* ids, void* out,
                               long long n_ids, long long n_rows,
                               long long row_bytes, void* stream) {
  if (n_ids < 0 || n_rows <= 0 || row_bytes <= 0 || row_bytes % 4 != 0 ||
      reinterpret_cast<uintptr_t>(tab) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_ids == 0) return (int)cudaGetLastError();
  long long blocks = (n_ids + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool vec16 = row_bytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(tab) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec16) {
    gather_rows_kernel<uint4><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const uint4*>(tab), ids, static_cast<uint4*>(out), n_ids,
        n_rows, row_bytes / 16);
  } else {
    gather_rows_kernel<uint32_t><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const uint32_t*>(tab), ids, static_cast<uint32_t*>(out),
        n_ids, n_rows, row_bytes / 4);
  }
  return (int)cudaGetLastError();
}
