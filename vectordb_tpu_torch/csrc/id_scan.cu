// Distances of b queries to the rows of a table named by an id list, for
// NVIDIA Hopper (sm_90a): the filtered scan by ids (ops/id_scan.py).
//
// A device filter's kept rows arrive as one int32 id list, built once per
// filter and mutation version (expr/device.DeviceFilter.kept_ids). This
// kernel scores those rows alone, where the full-table flat scan
// (ops/flat.flat_topk) widens every row of the table to f32 and multiplies
// all of them. It replaces no TPU kernel: the JAX package scores the whole
// masked table in one XLA program (vectordb_tpu/ops/flat.py flat_topk).
//
// Output: out[j * m + r], the distance of query j to row ids[r], f32, under
// ops/flat.py's conventions: squared L2 (|q|^2 - 2 q.x) + |x|^2 with |x|^2
// from the store's f32 norms, cosine 1 - q.x, dot -q.x. The numerics are the
// full scan's: with a bf16 table each query is rounded to bf16 on its way
// into shared memory (to nearest even, as torch's .to(bfloat16)), products
// and sums are f32 FMAs (a bf16 x bf16 product is exact in f32; no TF32),
// and |q|^2 is taken of the rounded query. Only the order of the summation
// differs.
//
// What bounds it: bytes. Each kept row is read once, 2*m*D bytes in bf16
// (4*m*D in f32), and the queries once, 4*b*D; beside those the ids (4*m),
// the scores written (4*b*m) and, for L2, the norms (4*m). At
// cohere-768-1m-filter99's shape (m = 10,023, D = 768, b = 1) 2*m*D + 4*b*D
// is 15.4 MB: 4.6 us at the H100's 3.35 TB/s. The 2*b*m*D FLOPs (15.4 M)
// are nothing beside that.
//
// Design:
//   * A group of L lanes scores a row: L = 32, a warp, when the row has at
//     least 32 16-byte chunks (D >= 256 in bf16), else the largest power of
//     two not above its chunk count (D = 64 in bf16: 8 chunks, 8 lanes, four
//     rows a warp). A lane loads its chunks with 16-byte loads, 8 bf16 or
//     4 f32 each. The chunks a lane holds at once (CPL, a template
//     parameter) are the fewest of 1, 2, 3, 4, 6, 8 that cover the row (D =
//     768 bf16: 96 chunks, 3 a lane), so no register holds a chunk the row
//     lacks; wider rows go in segments of 8 a lane.
//   * A group scores kRows = 2 rows, and every load of both is issued before
//     the first use, so each lane has 2 * CPL loads in flight. The loads are
//     issued before the block stages its queries, so the staging hides
//     under their latency.
//   * The block's queries sit in shared memory as f32, so rows held in
//     registers serve every query of the block: per query the lane's
//     partial dot products, shuffle reductions over the L lanes, and one
//     store a row by the group's first lane. Rows wider than a segment add
//     their segments' sums in order in a per-row slot of shared memory.
//   * 256-thread blocks, __launch_bounds__ for 4 resident a multiprocessor
//     (64 registers): at D = 768 a block scores 16 rows, and 10,023 rows
//     make 627 blocks, 1.2 waves of 4 x 132. The ragged end (rows past m)
//     is masked: its lanes load and store nothing but take part in the
//     shuffles.
// On the H100 at that shape it takes 7.4 us with its rows in L2 (as between
// two queries of the cell), 16.3 us after a 256 MB write has pushed them
// out of L2 (PERF.md section 6).
//   * Queries past what 48 KB of shared memory holds go to further blocks
//     along grid.y, which read the rows again (from L2 at the sizes served).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kEuclidean = 1;
constexpr int kCosine = 2;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 227 * 1024;

// A 16-byte chunk of a row widened to f32: 8 bf16 or 4 f32 values.
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kVals = 8;
  __device__ static void widen(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is word i's low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <>
struct Chunk<float> {
  static constexpr int kVals = 4;
  __device__ static void widen(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static float round(float v) { return v; }
};

// A group's rows: kRows rows a group, so that each lane has the chunks of
// kRows rows in flight at once.
constexpr int kRows = 2;

// The lane's CPL chunks of each of the group's rows in a segment that
// starts at chunk c0 (zeros past the row's end and for a row past m).
template <int CPL>
__device__ __forceinline__ void load_segment(uint4 (&raw)[kRows][CPL],
                                             const uint4* const (&row)[kRows],
                                             const bool (&valid)[kRows],
                                             int c0, int gl, int lanes,
                                             int chunks) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = c0 + gl + i * lanes;
      raw[k][i] = (valid[k] && c < chunks) ? __ldg(row[k] + c)
                                           : make_uint4(0, 0, 0, 0);
    }
  }
}

// One block: kRows * (kThreads / lanes) rows against qt queries. Shared
// memory: qs [qt, d] the rounded queries, qn [qt] their squared norms (L2),
// part [groups * kRows, qt] the sums of earlier segments (rows wider than
// one segment of CPL chunks a lane).
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads, 4)
    id_scan_kernel(const T* __restrict__ tab, const int32_t* __restrict__ ids,
                   const float* __restrict__ q,
                   const float* __restrict__ norms, float* __restrict__ out,
                   int b, int m, int d, int lanes, int qt, int nseg,
                   int metric) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* qn = qs + static_cast<size_t>(qt) * d;
  float* part = qn + qt;
  constexpr int V = Chunk<T>::kVals;
  const int q0 = blockIdx.y * qt;
  const int nq = min(qt, b - q0);
  const int chunks = d / V;
  const int groups = kThreads / lanes;
  const int g = threadIdx.x / lanes;
  const int gl = threadIdx.x % lanes;
  int r[kRows], id[kRows];
  bool valid[kRows];
  const uint4* row[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    r[k] = (blockIdx.x * kRows + k) * groups + g;
    valid[k] = r[k] < m;
    id[k] = valid[k] ? ids[r[k]] : 0;
    row[k] = reinterpret_cast<const uint4*>(tab + static_cast<size_t>(id[k]) * d);
  }
  const int seg_chunks = lanes * CPL;

  uint4 raw[kRows][CPL];
  load_segment<CPL>(raw, row, valid, 0, gl, lanes, chunks);

  const float* qb = q + static_cast<size_t>(q0) * d;
  for (int i = threadIdx.x; i < nq * d; i += kThreads) {
    qs[i] = Chunk<T>::round(qb[i]);
  }
  __syncthreads();
  if (metric == kEuclidean) {
    const int lane = threadIdx.x & 31;
    for (int j = threadIdx.x >> 5; j < nq; j += kThreads / 32) {
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s = fmaf(qs[j * d + c], qs[j * d + c], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(~0u, s, off);
      if (lane == 0) qn[j] = s;
    }
    __syncthreads();
  }

  for (int s = 0; s < nseg; ++s) {
    if (s > 0) {
      load_segment<CPL>(raw, row, valid, s * seg_chunks, gl, lanes, chunks);
    }
    for (int j = 0; j < nq; ++j) {
      float acc[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) acc[k] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = s * seg_chunks + gl + i * lanes;
        if (c < chunks) {
          const float4* qc =
              reinterpret_cast<const float4*>(qs + static_cast<size_t>(j) * d +
                                              c * V);
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            float x[V];
            Chunk<T>::widen(raw[k][i], x);
#pragma unroll
            for (int e = 0; e < V / 4; ++e) {
              const float4 qv = qc[e];
              acc[k] = fmaf(x[4 * e], qv.x, acc[k]);
              acc[k] = fmaf(x[4 * e + 1], qv.y, acc[k]);
              acc[k] = fmaf(x[4 * e + 2], qv.z, acc[k]);
              acc[k] = fmaf(x[4 * e + 3], qv.w, acc[k]);
            }
          }
        }
      }
      for (int off = lanes / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          acc[k] += __shfl_xor_sync(~0u, acc[k], off);
        }
      }
      if (gl != 0) continue;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (!valid[k]) continue;
        float* slot = part + (g * kRows + k) * qt + j;
        const float ip = s > 0 ? *slot + acc[k] : acc[k];
        if (s + 1 < nseg) {
          *slot = ip;
          continue;
        }
        float dist;
        if (metric == kEuclidean) {
          dist = (qn[j] - 2.f * ip) + norms[id[k]];
        } else if (metric == kCosine) {
          dist = 1.f - ip;
        } else {
          dist = -ip;
        }
        out[static_cast<size_t>(q0 + j) * m + r[k]] = dist;
      }
    }
  }
}

template <typename T, int CPL>
int launch_cpl(const void* tab, const int32_t* ids, const float* q,
               const float* norms, float* out, int b, int m, int d,
               int lanes, int metric, cudaStream_t st) {
  constexpr int V = Chunk<T>::kVals;
  const int chunks = d / V;
  const int groups = kThreads / lanes;
  const int nseg = (chunks + lanes * CPL - 1) / (lanes * CPL);
  const size_t per_q =
      (static_cast<size_t>(d) + 1 + (nseg > 1 ? groups * kRows : 0)) *
      sizeof(float);
  size_t qt = kSmemDefault / per_q;
  if (qt < 1) qt = 1;
  if (qt > static_cast<size_t>(b)) qt = b;
  const size_t smem = per_q * qt;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        id_scan_kernel<T, CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows_a_block = groups * kRows;
  const dim3 grid((m + rows_a_block - 1) / rows_a_block,
                  static_cast<unsigned>((b + qt - 1) / qt));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  id_scan_kernel<T, CPL><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(tab), ids, q, norms, out, b, m, d, lanes,
      static_cast<int>(qt), nseg, metric);
  return static_cast<int>(cudaGetLastError());
}

// Lanes a row: 32, or the largest power of two not above its chunk count.
// Chunks a lane held at once (CPL): the fewest of 1, 2, 3, 4, 6, 8 that
// cover the row (D = 768 bf16: 96 chunks, 3 a lane), else 8 a segment.
template <typename T>
int launch(const void* tab, const int32_t* ids, const float* q,
           const float* norms, float* out, int b, int m, int d, int metric,
           cudaStream_t st) {
  const int chunks = d / Chunk<T>::kVals;
  int lanes = 1;
  while (lanes < 32 && lanes * 2 <= chunks) lanes *= 2;
  const int need = (chunks + lanes - 1) / lanes;
  switch (need) {
    case 1:
      return launch_cpl<T, 1>(tab, ids, q, norms, out, b, m, d, lanes, metric, st);
    case 2:
      return launch_cpl<T, 2>(tab, ids, q, norms, out, b, m, d, lanes, metric, st);
    case 3:
      return launch_cpl<T, 3>(tab, ids, q, norms, out, b, m, d, lanes, metric, st);
    case 4:
      return launch_cpl<T, 4>(tab, ids, q, norms, out, b, m, d, lanes, metric, st);
    case 5:
    case 6:
      return launch_cpl<T, 6>(tab, ids, q, norms, out, b, m, d, lanes, metric, st);
    default:
      return launch_cpl<T, 8>(tab, ids, q, norms, out, b, m, d, lanes, metric, st);
  }
}

}  // namespace

// tab [N, d] bf16 (is_bf16) or f32; ids [m] int32 rows of tab; q [b, d] f32;
// norms [N] f32 (read for L2 only); out [b, m] f32. Returns a cudaError_t:
// the launch's, or cudaErrorInvalidValue for shapes it does not take.
extern "C" int vdb_id_scan(const void* tab, const int32_t* ids, const float* q,
                           const float* norms, float* out, int b, int m, int d,
                           int metric, int is_bf16, void* stream) {
  if (b <= 0 || m <= 0 || d <= 0 || d % (is_bf16 ? 8 : 4) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(tab, ids, q, norms, out, b, m, d, metric, st);
  }
  return launch<float>(tab, ids, q, norms, out, b, m, d, metric, st);
}
