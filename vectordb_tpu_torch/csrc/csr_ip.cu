// Inner products of one dense query scatter with every row of a CSR column,
// for NVIDIA Hopper (sm_90a):
//   out[r] = sum over j in [offs[r], offs[r + 1]) of
//            q[clamp(idx[j], 0, len_q - 1)] * val[j].
//
// Replaces vectordb_tpu/ops/sparse.py:_sparse_ip_kernel, a jitted XLA
// program (not a Pallas kernel): gather of the scatter at every stored
// index, multiply, one f32 prefix sum over the column differenced at the row
// boundaries. Here each row is summed on its own in f32, so a row's error
// is that of its own additions, not of the column's prefix (the port's
// repair of the prefix drift). The scatter carries a trailing zero, so a
// stored index past the query's largest reads 0 (JAX's jnp.minimum(idx,
// len) on the zero-padded scatter).
//
// What bounds it: the bytes. Every nnz is read once (4 bytes of index, 4 of
// value), the int64 offsets once, one f32 written a row, the scatter once:
// about 970 MB for the 1M-row, 120M-nnz SPLADE-like column, 0.29 ms at
// 3.35 TB/s. The multiply-adds (2 a nnz, f32 on the CUDA cores) are about
// 1% of that time. The scatter is read at random, once a nnz.
//
// Design:
// - The scatter in shared memory (kShared): each block copies it once, then
//   every random read of it is a shared-memory access, not an L2 round
//   trip. Up to Hopper's 232,448 bytes of dynamic shared memory a block
//   (58,112 floats: BERT's 30,522 terms take 122 KB). A larger scatter (the
//   caller chooses by size) is read from global memory through the
//   read-only path instead, where L1 and L2 keep its hot terms.
// - A persistent grid: as many 1,024-thread blocks as fit on the card at
//   once (one an SM with a 122 KB scatter), so the copy of the scatter is
//   paid once a block, not once a tile of rows.
// - A warp per row, kRows rows at a time: the warps of the grid stride over
//   items of kRows consecutive rows, so together they read one moving front
//   of the column. Lane t takes the 16-byte vectors t, t + 32, ... of a
//   row's span, index and value each, and the loads of all kRows rows are
//   issued before any is used (2 x kRows 16-byte loads in flight a lane).
//   A row of ~120 nnz is one 32-lane step of ~1 KB; with one row in flight
//   a warp, an SM's 32 warps keep ~32 KB in flight, about what 3.35 TB/s
//   over 132 SMs needs at a microsecond of latency, with no margin; two
//   rows double it.
// - Row offsets are arbitrary: a row's span is the 16-byte vectors that
//   cover it, and elements outside [offs[r], offs[r + 1]) are masked, so no
//   load is misaligned. The last vector of the arrays, when nnz is not a
//   multiple of 4, is read element by element, never past the end.
// - The next item's offsets are loaded before the current item's rows are
//   read, so their latency hides behind the row loads.
// - Each row's lanes are summed with shuffles; lane 0 writes the kRows
//   sums. An empty row (or a row past the column's end) writes 0.
// - Index and value loads are streaming (ld.global.cs: evict first), so
//   they do not push the scatter's lines out of L1 and L2.
// - Offsets are int64 (a column of 2^31 nnz and more is 17 GB, which fits
//   on the card) and clamped to [0, nnz], so malformed offsets cannot read
//   outside the arrays.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;  // rows a warp reads at once

template <bool kShared>
__device__ __forceinline__ float scatter_at(const float* sq,
                                            const float* __restrict__ q,
                                            int32_t i) {
  if constexpr (kShared) {
    return sq[i];
  } else {
    return __ldg(q + i);
  }
}

// offs[row], or 0 past the column's last boundary.
__device__ __forceinline__ long long offset_at(
    const long long* __restrict__ offs, long long row, long long n_rows) {
  return row <= n_rows ? __ldg(offs + row) : 0LL;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
csr_ip_kernel(const int32_t* __restrict__ idx, const float* __restrict__ val,
              const long long* __restrict__ offs,
              const float* __restrict__ q, float* __restrict__ out,
              long long nnz, long long n_rows, int32_t len_q) {
  extern __shared__ float sq[];
  if constexpr (kShared) {
#pragma unroll 8
    for (int32_t i = threadIdx.x; i < len_q; i += kThreads) {
      sq[i] = __ldg(q + i);
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int32_t lim = len_q - 1;
  const long long n_items = (n_rows + kRows - 1) / kRows;
  const long long n_warps = (long long)gridDim.x * kWarps;
  long long item = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  // Lanes 0..kRows hold the kRows + 1 boundaries of the current item.
  long long o = lane <= kRows ? offset_at(offs, item * kRows + lane, n_rows)
                              : 0LL;
  for (; item < n_items; item += n_warps) {
    const long long r0 = item * kRows;
    long long s[kRows], e[kRows], v0[kRows], v1[kRows];
    long long steps = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      long long a = __shfl_sync(0xffffffffu, o, r);
      long long b = __shfl_sync(0xffffffffu, o, r + 1);
      a = a < 0 ? 0 : (a > nnz ? nnz : a);
      b = b < a ? a : (b > nnz ? nnz : b);
      if (r0 + r >= n_rows) b = a;
      s[r] = a;
      e[r] = b;
      v0[r] = a >> 2;                        // first 16-byte vector
      v1[r] = b > a ? (b + 3) >> 2 : v0[r];  // one past the last
      const long long n = (v1[r] - v0[r] + 31) >> 5;
      steps = n > steps ? n : steps;
    }
    // The next item's boundaries, in flight while this item's rows load.
    const long long next = item + n_warps;
    o = lane <= kRows && next < n_items
            ? offset_at(offs, next * kRows + lane, n_rows)
            : 0LL;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (long long step = 0; step < steps; ++step) {
      int4 iv[kRows];
      float4 fv[kRows];
      long long p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        p[r] = v0[r] + step * 32 + lane;
        iv[r] = make_int4(0, 0, 0, 0);
        fv[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p[r] < v1[r]) {
          const long long first = p[r] * 4;
          if (first + 4 <= nnz) {
            iv[r] = __ldcs(reinterpret_cast<const int4*>(idx) + p[r]);
            fv[r] = __ldcs(reinterpret_cast<const float4*>(val) + p[r]);
          } else {  // the arrays' last vector, 1-3 elements long
            iv[r].x = __ldcs(idx + first);
            fv[r].x = __ldcs(val + first);
            if (first + 1 < nnz) {
              iv[r].y = __ldcs(idx + first + 1);
              fv[r].y = __ldcs(val + first + 1);
            }
            if (first + 2 < nnz) {
              iv[r].z = __ldcs(idx + first + 2);
              fv[r].z = __ldcs(val + first + 2);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int ii[4] = {iv[r].x, iv[r].y, iv[r].z, iv[r].w};
        const float ff[4] = {fv[r].x, fv[r].y, fv[r].z, fv[r].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long pos = p[r] * 4 + j;
          const int32_t t = ii[j] < 0 ? 0 : (ii[j] > lim ? lim : ii[j]);
          if (pos >= s[r] && pos < e[r]) {
            acc[r] = fmaf(scatter_at<kShared>(sq, q, t), ff[j], acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], m);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r0 + r < n_rows) out[r0 + r] = acc[r];
      }
    }
  }
}

constexpr int kMaxDevices = 64;
// Devices whose shared-memory limit for csr_ip_kernel<true> is raised. A
// race of two first launches sets the same limit twice, harmlessly.
bool g_raised[kMaxDevices] = {};

template <bool kShared>
int launch(const int32_t* idx, const float* val, const long long* offs,
           const float* q, float* out, long long nnz, long long n_rows,
           int32_t len_q, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = kShared ? (size_t)len_q * sizeof(float) : 0;
  if constexpr (kShared) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    // Above 48 KB a launch is refused unless the kernel's limit is raised;
    // raised to the card's opt-in limit once a device.
    if (dev < kMaxDevices && !g_raised[dev]) {
      err = cudaFuncSetAttribute(csr_ip_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
      if (err != cudaSuccess) return (int)err;
      g_raised[dev] = true;
    } else if (dev >= kMaxDevices) {
      return (int)cudaErrorInvalidDevice;
    }
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, csr_ip_kernel<kShared>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (n_rows + kRows - 1) / kRows;
  const long long want = (items + kWarps - 1) / kWarps;
  const long long fit = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(want < fit ? want : fit);
  csr_ip_kernel<kShared><<<blocks, kThreads, smem, st>>>(
      idx, val, offs, q, out, nnz, n_rows, len_q);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (on the current device) and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for arguments
// the kernel does not take. idx [nnz] int32 and val [nnz] f32 are
// contiguous and 16-byte aligned; offs [n_rows + 1] int64; q [len_q] f32,
// len_q >= 1; out [n_rows] f32. shared != 0 puts the scatter in shared
// memory (len_q * 4 bytes must fit in a block's opt-in limit).
extern "C" int vdb_csr_ip(const int32_t* idx, const float* val,
                          const int64_t* offs, const float* q, float* out,
                          long long nnz, long long n_rows, long long len_q,
                          int shared, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(idx) |
                          reinterpret_cast<uintptr_t>(val);
  if (nnz < 0 || n_rows < 0 || len_q < 1 || len_q > 2147483647LL ||
      align % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0) return (int)cudaGetLastError();
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const long long* o = reinterpret_cast<const long long*>(offs);
  if (shared) {
    return launch<true>(idx, val, o, q, out, nnz, n_rows, (int32_t)len_q, st);
  }
  return launch<false>(idx, val, o, q, out, nnz, n_rows, (int32_t)len_q, st);
}
