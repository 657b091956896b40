// Beam traversal iterations over a fixed-degree graph, for NVIDIA Hopper
// (sm_90a), in two variants: a warp a query for narrow beams, a block a
// query for wide ones; a walk in one launch where the batch is resident,
// else one launch an iteration.
//
// Replaces the loop body of vectordb_tpu/ops/beam.py:98 beam_search_kernel,
// a jitted XLA program (not a Pallas kernel), which the port ran as about 50
// host-launched torch ops an iteration (ops/beam.beam_iteration_ref, its
// plain version). One iteration of one query, as there:
//   1. pick the M first available beam entries (not expanded, finite
//      distance) in position order, then the first unavailable ones, and
//      mark all M expanded (lax.top_k's rule on a sorted beam);
//   2. write the picks to visited[it*M : (it+1)*M], -1 where not valid;
//   3. read the M adjacency rows: C = M*R candidates, -1 past an invalid
//      pick;
//   4. drop padding (< 0), beam members, repeats (the first occurrence
//      wins) and rows already in visited;
//   5. split path: keep the survivors in column order, at most `cp` of them
//      when 0 < cp < C (the stable pick-major compaction), and score their
//      rows of `table`; fused path: score each survivor's int8 vector from
//      its pick's row of `fused` ([N, R*D]), times `scale`;
//   6. merge: a stable sort of [beam ; survivors] by distance (ties to the
//      beam, then to the lower column), keep L.
// Scores use the plain version's arithmetic: f32 sums of f32 products (in
// another order, so they agree bit for bit where every sum is exact, as on
// integer-valued inputs), then EUCLIDEAN |q|^2 - 2 ip + |x|^2, COSINE
// 1 - ip, IP -ip (the fused path's ip and |x|^2 times scale and scale^2),
// each of these steps rounded on its own, as torch does (no fused
// multiply-add).
//
// Stop rule (JAX's): a batch stops when no query has an available entry in
// its first `tw` beam positions. After an iteration every query ORs its
// "work left" into flags[it + 1]. In a walk of a batch in one launch
// (it_end > it_begin + 1, launched cooperatively, so every block is
// resident) the block variant then waits on the whole grid
// (cooperative_groups' grid sync) and reads the flag; in the warp variant
// a query with work goes on at once (the batch does), and one without
// waits until the flag is set or every query has counted itself done with
// the iteration, so the queries drift apart instead of running each phase
// in lockstep. One query reads its own state. A launch of one iteration
// reads flags[it] first and leaves the state as it is when it is 0, so a
// batch that is not resident runs a launch an iteration with no host sync
// between them.
//
// What bounds it on an H100: for a batch, the bytes its data needs (the
// valid picks' adjacency rows, the scored candidates' rows, the beam once
// and each visited id once a walk) at 3.35 TB/s, about 47 MB an iteration
// at 2,048 queries and 96-192 bf16 rows of 256 B each (14 us); the 2 FMAs
// a candidate element stay under 4 flops a byte. For one query, the chain
// of dependent loads (beam -> adjacency -> rows), a few microseconds an
// iteration, whatever the bytes. The one-block-a-query kernel before this
// one reached 12-19% of the batch bound: register-bound at 4 queries a
// multiprocessor, its block waited at ten barriers an iteration on one
// load chain, 16 rows in flight while scoring (42-50% of its time), an
// O(S^2) rank by counting (16-25%), a 168-184 byte stack frame.
//
// Design:
// - The warp variant (beam_warp_kernel), for batches of more queries than
//   the card has multiprocessors: a warp a query, kWarpQueries queries a
//   block, __launch_bounds__ for 32 resident queries a multiprocessor at
//   64 registers a thread. Its state (beam, f32 query, duplicate table,
//   survivors, visited ids) is ~6 KB of shared memory at L 18 and C 192,
//   laid out at offsets the kernel's parameters hold, so no register holds
//   a pointer per array. Phases sync with __syncwarp and ballots, and a
//   walk's queries drift apart (the stop rule above), so the table, rank
//   and merge phases of some overlap the row loads of others. It takes
//   L <= 64, M <= 32, C <= 256, rows of at most 32 16-byte chunks and
//   visited <= 1,024.
// - The block variant (beam_block_kernel), for up to one query a
//   multiprocessor and for wider beams, up to L 16,000: a block of 256
//   threads a query, so eight warps share one query's chain; the beam in
//   shared memory while it fits the card's opt-in limit (L of about 12,000
//   at C = 192), else double-buffered in global memory, the state and a
//   scratch copy that the caller passes, swapped as pointers.
// - Candidates: the warp variant copies the adjacency entries into shared
//   memory with cp.async, all in flight at once and holding no register.
// - Duplicates: an open-addressing table of ids and first columns, 2 C or
//   more slots (a read before the atomicCAS of a slot, then atomicMin of
//   the column); beam and visited ids mark their slot. A candidate survives
//   iff its slot still holds its own column.
// - Scores: the warp variant asks L2 for every survivor's row first (all
//   in flight at once), then reads one row a lane, kLaneBatch 16-byte
//   chunks at a time; the block variant scores with g lanes a row (as many
//   as its 16-byte chunks), kRowBatch rows a lane in flight. The fused path
//   of a single query also asks L2 for its picks' fused rows right after
//   the pick, so they arrive while the dedup runs.
// - Rank: only the survivors that can enter the beam (a distance below its
//   last entry's) are ranked, by a bitonic sort of (distance, column) keys
//   in shared memory (a warp, or the block past 256 keys), then a
//   merge-path into the beam.
// - No local memory: ptxas reports a 0-byte stack frame for every kernel.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kBlockVariant = 0;  // variant numbers of the operator
constexpr int kWarpVariant = 1;
constexpr int kThreads = 256;  // block variant: threads a query
constexpr int kWarps = kThreads / 32;
constexpr int kBlockMinBlocks = 2;  // at most 128 registers a thread
constexpr int kWarpQueries = 4;     // warp variant: queries (warps) a block
constexpr int kWarpMinBlocks = 8;   // 32 queries a multiprocessor
constexpr int kWarpMaxL = 64;       // two beam entries a lane
constexpr int kWarpMaxM = 32;       // one pick a lane
constexpr int kWarpMaxC = 256;      // eight candidates a lane
constexpr int kWarpMaxChunks = 32;  // one 16-byte chunk of a row a lane
constexpr int kWarpMaxVisited = 1024;
constexpr int kRowBatch = 4;   // block variant: rows a lane loads at once
constexpr int kLaneBatch = 4;  // warp variant: chunks a lane loads at once
constexpr int kEuclidean = 1;  // MetricType values of the package
constexpr int kCosine = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;

struct Args {
  const void* q;         // [B, D] table dtype
  const float* q_norms;  // [B] f32
  const void* table;     // [N, D] bf16 or f32
  const int32_t* adj;    // [N, R]
  const int8_t* fused;   // [N, R * D] or null
  int32_t* beam_ids;     // [B, L]
  uint8_t* beam_exp;     // [B, L]
  float* beam_d;         // [B, L]
  int32_t* visited;      // [B, V]
  int32_t* flags;        // [n_flags]
  int32_t* done;         // [it_end - it_begin] zeros: a walk's queries
                         // done with each iteration (warp variant)
  int32_t* sc_ids;       // [B, L] scratch of a beam kept in global memory,
  float* sc_d;           // or null when the beam lives in shared memory
  uint8_t* sc_exp;
  long long n_table, n_adj, n_fused;  // rows of table, adj and fused
  float scale;
  int b, d, l, m, r, v, cp, tw, metric, it_begin, it_end, peel, n_flags, h;
  int prefetch;  // fused rows to L2 right after the pick
  // Warp variant: shared memory of one query, and the byte offsets of its
  // arrays there (warp_layout).
  int warp_bytes, w_dist, w_exp, w_q, w_keys, w_cols, w_sid, w_scol, w_sd,
      w_vis, w_pk, w_uk, w_pid, w_pv;
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Slots of the duplicate table: at least 2 C, a multiple of 32.
__host__ __device__ inline int table_slots(int c) {
  const int h = ((2 * c + 31) / 32) * 32;
  return h < 64 ? 64 : h;
}

// Shared memory of a block of the block variant; the beam's part only when
// it lives there (`beam`).
__host__ __device__ inline size_t block_smem_bytes(int l, int d, int c, int m,
                                                   int h, bool beam) {
  if (!beam) l = 0;
  return 4 * align16((size_t)l * 4) + 2 * align16((size_t)l) +
         align16((size_t)d * 4) + 4 * align16((size_t)c * 4) +
         2 * align16((size_t)h * 4) + 4 * align16((size_t)m * 4) +
         align16(kWarps * 4);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of row elements widened to f32 by word operations (no local
// copy): 8 bf16, 4 f32 or 16 int8.
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void widen(const uint4& u, float* out) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void widen(const uint4& u, float* out) {
    out[0] = __uint_as_float(u.x);
    out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z);
    out[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int kN = 16;
  __device__ static void widen(const uint4& u, float* out) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[4 * i + j] = (float)((int32_t)(w[i] << (24 - 8 * j)) >> 24);
      }
    }
  }
};

__device__ __forceinline__ bool available(uint8_t exp, float d) {
  return !exp && isfinite(d);
}

// --- The duplicate table: ids and their first columns, 2 C or more
// slots. ---

__device__ __forceinline__ int slot_home(int32_t id, int h) {
  return (int)__umulhi((uint32_t)id * 2654435761u, (unsigned)h);
}

// Inserts candidate `id` (>= 0) of column `col`; its slot keeps the lowest
// column. A slot is read before it is claimed, so a probe past a taken slot
// costs a load, not an atomic.
__device__ __forceinline__ void table_insert(int32_t* keys, int32_t* cols,
                                             int h, int32_t id, int col) {
  int s = slot_home(id, h);
  for (;;) {
    int32_t k = *reinterpret_cast<volatile int32_t*>(&keys[s]);
    if (k == -1) k = atomicCAS(&keys[s], -1, id);
    if (k == -1 || k == id) {
      atomicMin(&cols[s], col);
      return;
    }
    s = s + 1 == h ? 0 : s + 1;
  }
}

// Slot holding `id`, or -1.
__device__ __forceinline__ int table_find(const int32_t* keys, int h,
                                          int32_t id) {
  int s = slot_home(id, h);
  for (int probe = 0; probe < h; ++probe) {
    const int32_t k = keys[s];
    if (k == id) return s;
    if (k == -1) return -1;
    s = s + 1 == h ? 0 : s + 1;
  }
  return -1;
}

// A beam member or visited row: its candidate slot (if any) loses its
// column.
__device__ __forceinline__ void table_mark(const int32_t* keys, int32_t* cols,
                                           int h, int32_t id) {
  if (id < 0) return;
  const int s = table_find(keys, h, id);
  if (s >= 0) cols[s] = -1;
}

// Candidate `id` of column `col` survives: its slot holds this column.
__device__ __forceinline__ bool table_first(const int32_t* keys,
                                            const int32_t* cols, int h,
                                            int32_t id, int col) {
  const int s = table_find(keys, h, id);
  return s >= 0 && cols[s] == col;
}

// --- Survivor keys: (distance, survivor index) in one ordered u64. ---

// -0.0 ranks as +0.0 (torch's sort compares values).
__device__ __forceinline__ unsigned long long rank_key(float d, int idx) {
  uint32_t u = __float_as_uint(__fadd_rn(d, 0.0f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (uint32_t)idx;
}

__device__ __forceinline__ float key_dist(unsigned long long key) {
  uint32_t u = (uint32_t)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

// keys[0, Q) = the keys of survivors idx[0, Q) (their distances in s_d)
// in ascending order: a bitonic sort of pow2 >= Q keys in shared memory
// (room for them in `keys`) by `threads` threads numbered `t`, which
// `sync` holds together between stages (a warp's __syncwarp or a block's
// __syncthreads); no register arrays and no shuffles, so the code stays
// small and spills nothing.
template <typename Sync>
__device__ __forceinline__ void rank_survivors(const float* s_d,
                                               const int32_t* idx, int Q,
                                               unsigned long long* keys,
                                               int t, int threads,
                                               Sync sync) {
  const int n = pow2_at_least(Q);
  for (int i = t; i < n; i += threads) {
    keys[i] = i < Q ? rank_key(s_d[idx[i]], idx[i]) : kEmpty;
  }
  sync();
  for (int size = 2; size <= n; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int pr = t; pr < n / 2; pr += threads) {
        const int i = ((pr & ~(j - 1)) << 1) | (pr & (j - 1));  // bit j clear
        const int p = i | j;
        const unsigned long long x = keys[i], y = keys[p];
        if (((i & size) == 0) ? x > y : x < y) {
          keys[i] = y;
          keys[p] = x;
        }
      }
      sync();
    }
  }
}

// Survivors whose distance is < d (keys sorted ascending).
__device__ __forceinline__ int count_less(const unsigned long long* keys,
                                          int S, float d) {
  int lo = 0, hi = S;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_dist(keys[mid]) < d) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Beam entries whose distance is <= d (the beam sorted ascending).
__device__ __forceinline__ int count_le(const float* dist, int L, float d) {
  int lo = 0, hi = L;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (dist[mid] <= d) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool kFused>
__device__ __forceinline__ float metric_score(float ip, float vn, float qn,
                                              float scale, int metric) {
  if constexpr (kFused) {
    const float sip = __fmul_rn(scale, ip);
    if (metric == kEuclidean) {
      return __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f * scale, ip)),
                       __fmul_rn(__fmul_rn(scale, scale), vn));
    }
    return metric == kCosine ? __fsub_rn(1.f, sip) : -sip;
  } else {
    if (metric == kEuclidean) {
      return __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, ip)), vn);
    }
    return metric == kCosine ? __fsub_rn(1.f, ip) : -ip;
  }
}

// Row (16-byte aligned) that survivor si is scored from.
template <typename T, bool kFused>
__device__ __forceinline__ const unsigned char* row_of(
    const Args& a, const int32_t* s_id, const int32_t* s_col,
    const int32_t* pid, int si) {
  if constexpr (kFused) {
    const int col = s_col[si];
    const int k = col / a.r;
    long long p = pid[k];
    p = p < 0 ? 0 : (p >= a.n_fused ? a.n_fused - 1 : p);
    return reinterpret_cast<const unsigned char*>(a.fused) +
           (p * a.r + (col - k * a.r)) * (long long)a.d;
  } else {
    long long p = s_id[si];
    p = p >= a.n_table ? a.n_table - 1 : p;
    return reinterpret_cast<const unsigned char*>(a.table) +
           p * (long long)a.d * (long long)sizeof(T);
  }
}

// ip += x . q and vn += x . x over a chunk's elements x; q 16-byte
// aligned in shared memory.
template <typename E>
__device__ __forceinline__ void accumulate(const uint4& u, const float* q,
                                           float& ip, float& vn) {
  float x[Vec<E>::kN];
  Vec<E>::widen(u, x);
#pragma unroll
  for (int e = 0; e < Vec<E>::kN; e += 4) {
    const float4 q4 = *reinterpret_cast<const float4*>(q + e);
    ip = fmaf(x[e], q4.x, ip);
    ip = fmaf(x[e + 1], q4.y, ip);
    ip = fmaf(x[e + 2], q4.z, ip);
    ip = fmaf(x[e + 3], q4.w, ip);
    vn = fmaf(x[e], x[e], vn);
    vn = fmaf(x[e + 1], x[e + 1], vn);
    vn = fmaf(x[e + 2], x[e + 2], vn);
    vn = fmaf(x[e + 3], x[e + 3], vn);
  }
}

// s_d[si] for survivors si in [0, S): g lanes a row (as many as its 16-byte
// chunks, up to 32), kRowBatch rounds of loads issued before any is used.
// Warp `unit` of `n_units` takes every n_units-th batch of rows (the block
// variant).
template <typename T, bool kFused>
__device__ __forceinline__ void score_rows(
    const Args& a, const float* qs, float qn, const int32_t* s_id,
    const int32_t* s_col, float* s_d, const int32_t* pid, int S, int unit,
    int n_units, int lane) {
  using E = typename std::conditional<kFused, int8_t, T>::type;
  constexpr int kE = Vec<E>::kN;
  const int chunks = a.d / kE;
  int g = 1;
  while (g < chunks && g < 32) g <<= 1;
  const int rpp = 32 / g, sub = lane / g, gl = lane % g;
  const int step = rpp * kRowBatch;
  for (int base = unit * step; base < S; base += n_units * step) {
    uint4 v[kRowBatch];
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r) {
      const int si = base + r * rpp + sub;
      v[r] = make_uint4(0u, 0u, 0u, 0u);
      if (si < S && gl < chunks) {
        v[r] = __ldg(reinterpret_cast<const uint4*>(
            row_of<T, kFused>(a, s_id, s_col, pid, si) + gl * 16));
      }
    }
#pragma unroll
    for (int r = 0; r < kRowBatch; ++r) {
      const int si = base + r * rpp + sub;
      float ip = 0.f, vn = 0.f;
      if (si < S && gl < chunks) {
        accumulate<E>(v[r], qs + gl * kE, ip, vn);
        if (chunks > 32) {  // rows wider than 32 chunks: the rest in turn
          const unsigned char* row = row_of<T, kFused>(a, s_id, s_col, pid,
                                                       si);
          for (int ch = gl + 32; ch < chunks; ch += 32) {
            accumulate<E>(__ldg(reinterpret_cast<const uint4*>(row + ch * 16)),
                          qs + ch * kE, ip, vn);
          }
        }
      }
      for (int o = g >> 1; o > 0; o >>= 1) {
        ip = __fadd_rn(ip, __shfl_xor_sync(kFull, ip, o));
        vn = __fadd_rn(vn, __shfl_xor_sync(kFull, vn, o));
      }
      if (si < S && gl == 0) {
        s_d[si] = metric_score<kFused>(ip, vn, qn, a.scale, a.metric);
      }
    }
  }
}

// s_d[si] for survivors si in [0, S), one lane a row (the warp variant):
// every row first asked of L2, all in flight at once, then each lane reads
// its row kLaneBatch 16-byte chunks at a time.
template <typename T, bool kFused>
__device__ __forceinline__ void score_rows_by_lane(
    const Args& a, const float* qs, float qn, const int32_t* s_id,
    const int32_t* s_col, float* s_d, const int32_t* pid, int S, int lane) {
  using E = typename std::conditional<kFused, int8_t, T>::type;
  constexpr int kE = Vec<E>::kN;
  const int chunks = a.d / kE;
  const int lines = (chunks * 16 + 127) / 128;
  for (int si = lane; si < S; si += 32) {
    const unsigned char* row = row_of<T, kFused>(a, s_id, s_col, pid, si);
    for (int ln = 0; ln < lines; ++ln) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(row + ln * 128));
    }
  }
  for (int si = lane; si < S; si += 32) {
    const unsigned char* row = row_of<T, kFused>(a, s_id, s_col, pid, si);
    float ip = 0.f, vn = 0.f;
    for (int c0 = 0; c0 < chunks; c0 += kLaneBatch) {
      uint4 v[kLaneBatch];
#pragma unroll
      for (int r = 0; r < kLaneBatch; ++r) {
        v[r] = c0 + r < chunks
                   ? __ldg(reinterpret_cast<const uint4*>(row + (c0 + r) * 16))
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int r = 0; r < kLaneBatch; ++r) {
        if (c0 + r < chunks) accumulate<E>(v[r], qs + (c0 + r) * kE, ip, vn);
      }
    }
    s_d[si] = metric_score<kFused>(ip, vn, qn, a.scale, a.metric);
  }
}

// Asks L2 for `bytes` (a multiple of 16) at a 16-byte aligned address.
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p),
               "r"(bytes)
               : "memory");
}

// --- The warp variant: a warp a query. ---

// One query's arrays in shared memory: a base pointer and the offsets of
// Args (kernel parameters, so no register holds a pointer per array).
struct WarpSmem {
  unsigned char* p;
  const Args& a;
  __device__ int32_t* ids() const {  // [L] the beam
    return reinterpret_cast<int32_t*>(p);
  }
  __device__ float* dist() const {  // [L]
    return reinterpret_cast<float*>(p + a.w_dist);
  }
  __device__ uint8_t* exp() const { return p + a.w_exp; }  // [L]
  __device__ float* q() const {  // [D]
    return reinterpret_cast<float*>(p + a.w_q);
  }
  __device__ int32_t* keys() const {  // [H] duplicate table: ids,
    return reinterpret_cast<int32_t*>(p + a.w_keys);
  }
  __device__ int32_t* cols() const {  // [H] their first columns
    return reinterpret_cast<int32_t*>(p + a.w_cols);
  }
  // Both, after the survivors are known: the ranked survivors' keys.
  __device__ unsigned long long* ranked() const {
    return reinterpret_cast<unsigned long long*>(p + a.w_keys);
  }
  __device__ int32_t* s_id() const {  // [C] survivors in column order
    return reinterpret_cast<int32_t*>(p + a.w_sid);
  }
  // [C] their columns, then the ranked ones' indices, then positions
  __device__ int32_t* s_col() const {
    return reinterpret_cast<int32_t*>(p + a.w_scol);
  }
  __device__ float* s_d() const {  // [C]
    return reinterpret_cast<float*>(p + a.w_sd);
  }
  __device__ int32_t* vis() const {  // [V] visited ids
    return reinterpret_cast<int32_t*>(p + a.w_vis);
  }
  __device__ int32_t* pk() const {  // [M] picked beam positions
    return reinterpret_cast<int32_t*>(p + a.w_pk);
  }
  __device__ int32_t* uk() const {  // [M] unavailable positions
    return reinterpret_cast<int32_t*>(p + a.w_uk);
  }
  __device__ int32_t* pid() const {  // [M] picked ids
    return reinterpret_cast<int32_t*>(p + a.w_pid);
  }
  __device__ int32_t* pv() const {  // [M] pick valid
    return reinterpret_cast<int32_t*>(p + a.w_pv);
  }
};

// Fills the warp variant's offsets of `a` and returns one query's bytes.
__host__ inline int warp_layout(Args* a) {
  int o = 0;
  auto take = [&](size_t bytes) {
    const int at = o;
    o += (int)align16(bytes);
    return at;
  };
  const int c = a->m * a->r;
  take((size_t)a->l * 4);  // ids at 0
  a->w_dist = take((size_t)a->l * 4);
  a->w_q = take((size_t)a->d * 4);
  a->w_keys = take((size_t)a->h * 4);
  a->w_cols = take((size_t)a->h * 4);
  a->w_sid = take((size_t)c * 4);
  a->w_scol = take((size_t)c * 4);
  a->w_sd = take((size_t)c * 4);
  a->w_vis = take((size_t)a->v * 4);
  a->w_pk = take((size_t)a->m * 4);
  a->w_uk = take((size_t)a->m * 4);
  a->w_pid = take((size_t)a->m * 4);
  a->w_pv = take((size_t)a->m * 4);
  a->w_exp = take((size_t)a->l);
  return o;
}

__device__ __forceinline__ bool warp_has_work(const WarpSmem& s, int tw,
                                              int lane) {
  bool any = false;
  for (int i = lane; i < tw; i += 32) any |= available(s.exp()[i], s.dist()[i]);
  return __any_sync(kFull, any) != 0;
}

template <typename T, bool kFused>
__device__ __forceinline__ void warp_iteration(const Args& a,
                                               const WarpSmem& s, int qi,
                                               int it, int cp, float qn,
                                               int lane) {
  const int L = a.l, M = a.m, R = a.r, C = a.m * a.r, H = a.h;
  const unsigned lt = (1u << lane) - 1u;

  // 1-2. Pick: the beam 32 positions at a time.
  int na = 0, nu = 0;
  for (int base = 0; base < L && na < M; base += 32) {
    const int pos = base + lane;
    const bool in = pos < L;
    const bool av = in && available(s.exp()[pos], s.dist()[pos]);
    const bool un = in && !av;
    const unsigned ba = __ballot_sync(kFull, av);
    const unsigned bu = __ballot_sync(kFull, un);
    if (av) {
      const int k = na + __popc(ba & lt);
      if (k < M) s.pk()[k] = pos;
    }
    if (un) {
      const int k = nu + __popc(bu & lt);
      if (k < M) s.uk()[k] = pos;
    }
    na += __popc(ba);
    nu += __popc(bu);
  }
  __syncwarp();
  if (lane < M) {
    const bool valid = lane < na;
    const int pos = valid ? s.pk()[lane] : s.uk()[lane - na];
    const int32_t id = s.ids()[pos];
    s.pid()[lane] = id;
    s.pv()[lane] = valid;
    const int32_t vid = valid ? id : -1;
    a.visited[(long long)qi * a.v + (long long)it * M + lane] = vid;
    s.vis()[it * M + lane] = vid;
    s.exp()[pos] = 1;
    if (kFused && a.prefetch && valid) {
      long long p = id < 0 ? 0 : (id >= a.n_fused ? a.n_fused - 1 : id);
      prefetch_l2(a.fused + p * R * (long long)a.d, (unsigned)(R * a.d));
    }
  }
  for (int i = lane; i < H; i += 32) {
    s.keys()[i] = -1;
    s.cols()[i] = INT_MAX;
  }
  __syncwarp();

  // 3. Candidates into s_id by asynchronous copies, all in flight at once
  // and holding no register (the survivors' compaction then runs over them
  // in place), then their first columns into the table.
  for (int j = lane; j < C; j += 32) {
    const int k = j / R;
    int32_t* dst = s.s_id() + j;
    if (s.pv()[k]) {
      long long p = s.pid()[k];
      p = p < 0 ? 0 : (p >= a.n_adj ? a.n_adj - 1 : p);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       (unsigned)__cvta_generic_to_shared(dst)),
                   "l"(a.adj + p * R + (j - k * R))
                   : "memory");
    } else {
      *dst = -1;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();
  for (int j = lane; j < C; j += 32) {
    const int32_t c = s.s_id()[j];
    if (c >= 0) table_insert(s.keys(), s.cols(), H, c, j);
  }
  __syncwarp();
  // 4. Beam members and visited rows lose their slots.
  for (int i = lane; i < L; i += 32) table_mark(s.keys(), s.cols(), H, s.ids()[i]);
  for (int i = lane; i < it * M; i += 32) {
    table_mark(s.keys(), s.cols(), H, s.vis()[i]);
  }
  __syncwarp();

  // 5. Survivors in column order (at most cp on the split path),
  // compacted in place: a survivor's slot is at most its column, and a
  // round of 32 columns reads all of them before any is written.
  const int limit = (!kFused && cp > 0 && cp < C) ? cp : C;
  int n = 0;
  for (int j0 = 0; j0 < C; j0 += 32) {
    const int j = j0 + lane;
    const int32_t c = j < C ? s.s_id()[j] : -1;
    const bool good = c >= 0 && table_first(s.keys(), s.cols(), H, c, j);
    const unsigned bal = __ballot_sync(kFull, good);
    const int pos = n + __popc(bal & lt);
    if (good && pos < limit) {
      s.s_id()[pos] = c;
      s.s_col()[pos] = j;
    }
    n += __popc(bal);
  }
  const int S = n < limit ? n : limit;
  __syncwarp();
  score_rows_by_lane<T, kFused>(a, s.q(), qn, s.s_id(), s.s_col(), s.s_d(),
                                s.pid(), S, lane);
  __syncwarp();

  // 6. Rank the survivors that can enter the beam (a distance below its
  // last entry's; every survivor ranked before one of them is one too),
  // keys into the table's space, then merge.
  const float worst = s.dist()[L - 1];
  int Q = 0;
  for (int i0 = 0; i0 < S; i0 += 32) {
    const int i = i0 + lane;
    const bool in = i < S && s.s_d()[i] < worst;
    const unsigned bal = __ballot_sync(kFull, in);
    if (in) s.s_col()[Q + __popc(bal & lt)] = i;
    Q += __popc(bal);
  }
  __syncwarp();
  unsigned long long* keys = s.ranked();
  rank_survivors(s.s_d(), s.s_col(), Q, keys, lane, 32,
                 [] { __syncwarp(); });
  int32_t bid[kWarpMaxL / 32];
  float bd[kWarpMaxL / 32];
  uint8_t be[kWarpMaxL / 32];
  int bp[kWarpMaxL / 32];
#pragma unroll
  for (int u = 0; u < kWarpMaxL / 32; ++u) {
    const int i = lane + 32 * u;
    bp[u] = L;
    if (i < L) {
      bid[u] = s.ids()[i];
      bd[u] = s.dist()[i];
      be[u] = s.exp()[i];
      bp[u] = i + count_less(keys, Q, bd[u]);
    }
  }
  for (int j = lane; j < Q; j += 32) {
    const int idx = (int)(uint32_t)keys[j];
    s.s_col()[j] = j + count_le(s.dist(), L, s.s_d()[idx]);
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kWarpMaxL / 32; ++u) {
    if (bp[u] < L) {
      s.ids()[bp[u]] = bid[u];
      s.dist()[bp[u]] = bd[u];
      s.exp()[bp[u]] = be[u];
    }
  }
  for (int j = lane; j < Q; j += 32) {
    const int pos = s.s_col()[j];
    if (pos < L) {
      const int idx = (int)(uint32_t)keys[j];
      s.ids()[pos] = s.s_id()[idx];
      s.dist()[pos] = s.s_d()[idx];
      s.exp()[pos] = 0;
    }
  }
  __syncwarp();
}

template <typename T, bool kFused>
__global__ void __launch_bounds__(kWarpQueries * 32, kWarpMinBlocks)
beam_warp_kernel(const __grid_constant__ Args a) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int qi = blockIdx.x * kWarpQueries + w;
  const bool active = qi < a.b;
  const bool single = a.b == 1;
  // A batch's first iteration runs after a flag that says some query had
  // work (the peeled iteration 0 runs unconditionally).
  if (!single && !(a.peel && a.it_begin == 0) && a.flags[a.it_begin] == 0) {
    return;
  }
  const int L = a.l, D = a.d, M = a.m;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WarpSmem s{smem_raw + (size_t)w * a.warp_bytes, a};
  const long long q0 = active ? qi : 0;
  float qn = 0.f;
  if (active) {
    for (int i = lane; i < L; i += 32) {
      s.ids()[i] = a.beam_ids[q0 * L + i];
      s.dist()[i] = a.beam_d[q0 * L + i];
      s.exp()[i] = a.beam_exp[q0 * L + i];
    }
    const T* qrow = reinterpret_cast<const T*>(a.q) + q0 * D;
    for (int i = lane; i < D; i += 32) s.q()[i] = to_f(qrow[i]);
    const int32_t* g_vis = a.visited + q0 * a.v;
    for (int i = lane; i < a.it_begin * M; i += 32) s.vis()[i] = g_vis[i];
    qn = a.q_norms[q0];
  }
  __syncwarp();

  bool go = single ? active && warp_has_work(s, a.tw, lane) : true;
  for (int it = a.it_begin; it < a.it_end && active; ++it) {
    const bool peeled = a.peel && it == 0;
    if (!peeled && !go) break;
    warp_iteration<T, kFused>(a, s, qi, it, peeled ? 0 : a.cp, qn, lane);
    const bool work = warp_has_work(s, a.tw, lane);
    if (single || it + 1 == a.it_end) {
      if (work && lane == 0 && it + 1 < a.n_flags) a.flags[it + 1] = 1;
      go = work;
      continue;
    }
    // A walk: the batch goes on iff some query has work. A query with work
    // knows that and goes on at once; one without waits until a query
    // sets the flag or every query has counted itself done, so queries
    // drift apart and one's table or sort overlaps another's row loads.
    int g = work;
    if (lane == 0) {
      if (work) atomicExch(&a.flags[it + 1], 1);
      __threadfence();
      atomicAdd(&a.done[it - a.it_begin], 1);
      const volatile int32_t* f = &a.flags[it + 1];
      const volatile int32_t* n = &a.done[it - a.it_begin];
      while (!work && !(g = *f) && *n < a.b) __nanosleep(64);
      __threadfence();
      if (!work) g = *f;
    }
    go = __shfl_sync(kFull, g, 0) != 0;
  }
  if (active) {
    for (int i = lane; i < L; i += 32) {
      a.beam_ids[q0 * L + i] = s.ids()[i];
      a.beam_d[q0 * L + i] = s.dist()[i];
      a.beam_exp[q0 * L + i] = s.exp()[i];
    }
  }
}

// --- The block variant: a block a query. ---

struct BlockSmem {
  int32_t* ids[2];  // beam buffers in shared memory (null: global)
  float* dist[2];
  uint8_t* exp[2];
  float* q;
  int32_t* cand;            // [C]
  int32_t* s_id;            // [C] survivors in column order
  int32_t* s_col;           // [C]
  float* s_d;               // [C]
  int32_t* keys;            // [H] duplicate table: ids,
  int32_t* cols;            // [H] their first columns; both, then the
  unsigned long long* ranked;  // ranked survivors' keys
  int32_t* pk;              // [M]
  int32_t* uk;              // [M]
  int32_t* pid;             // [M]
  int32_t* pv;              // [M]
  int32_t* warp_n;          // [kWarps]
};

__device__ __forceinline__ BlockSmem carve_block(unsigned char* base, int l,
                                                 int d, int c, int m, int h) {
  BlockSmem s;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + o;
    o += align16(bytes);
    return p;
  };
  s.ids[0] = reinterpret_cast<int32_t*>(take((size_t)l * 4));
  s.ids[1] = reinterpret_cast<int32_t*>(take((size_t)l * 4));
  s.dist[0] = reinterpret_cast<float*>(take((size_t)l * 4));
  s.dist[1] = reinterpret_cast<float*>(take((size_t)l * 4));
  s.q = reinterpret_cast<float*>(take((size_t)d * 4));
  s.cand = reinterpret_cast<int32_t*>(take((size_t)c * 4));
  s.s_id = reinterpret_cast<int32_t*>(take((size_t)c * 4));
  s.s_col = reinterpret_cast<int32_t*>(take((size_t)c * 4));
  s.s_d = reinterpret_cast<float*>(take((size_t)c * 4));
  s.keys = reinterpret_cast<int32_t*>(take((size_t)h * 4));
  s.cols = reinterpret_cast<int32_t*>(take((size_t)h * 4));
  s.ranked = reinterpret_cast<unsigned long long*>(s.keys);
  s.pk = reinterpret_cast<int32_t*>(take((size_t)m * 4));
  s.uk = reinterpret_cast<int32_t*>(take((size_t)m * 4));
  s.pid = reinterpret_cast<int32_t*>(take((size_t)m * 4));
  s.pv = reinterpret_cast<int32_t*>(take((size_t)m * 4));
  s.warp_n = reinterpret_cast<int32_t*>(take(kWarps * 4));
  s.exp[0] = take((size_t)l);
  s.exp[1] = take((size_t)l);
  return s;
}

// True for every thread when some entry of the first tw positions is
// available.
__device__ __forceinline__ bool block_has_work(const uint8_t* exp,
                                               const float* dist, int tw) {
  bool any = false;
  for (int i = threadIdx.x; i < tw; i += kThreads) {
    any |= available(exp[i], dist[i]);
  }
  return __syncthreads_or(any) != 0;
}

// Exclusive prefix of `flag` over the block (threads in order) into *pos,
// the block's total returned; every thread must call it.
__device__ __forceinline__ int block_scan(bool flag, int* pos,
                                          int32_t* warp_n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(kFull, flag);
  if (lane == 0) warp_n[warp] = __popc(bal);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int n = warp_n[w];
    before += w < warp ? n : 0;
    total += n;
  }
  *pos = before + __popc(bal & ((1u << lane) - 1u));
  __syncthreads();  // warp_n is reused by the next call
  return total;
}

template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads, kBlockMinBlocks)
beam_block_kernel(const __grid_constant__ Args a) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.l, M = a.m, R = a.r, D = a.d, C = a.m * a.r, H = a.h;
  const bool single = a.b == 1;
  if (!single && !(a.peel && a.it_begin == 0) && a.flags[a.it_begin] == 0) {
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool in_smem = a.sc_ids == nullptr;
  const BlockSmem s = carve_block(smem_raw, in_smem ? L : 0, D, C, M, H);

  int32_t* g_ids = a.beam_ids + (long long)b * L;
  uint8_t* g_exp = a.beam_exp + (long long)b * L;
  float* g_d = a.beam_d + (long long)b * L;
  int32_t* g_vis = a.visited + (long long)b * a.v;
  // The beam in use and the one the merge writes, swapped as pointers.
  int32_t* ids = in_smem ? s.ids[0] : g_ids;
  float* dist = in_smem ? s.dist[0] : g_d;
  uint8_t* exp = in_smem ? s.exp[0] : g_exp;
  int32_t* n_ids = in_smem ? s.ids[1] : a.sc_ids + (long long)b * L;
  float* n_dist = in_smem ? s.dist[1] : a.sc_d + (long long)b * L;
  uint8_t* n_exp = in_smem ? s.exp[1] : a.sc_exp + (long long)b * L;
  if (in_smem) {
    for (int i = tid; i < L; i += kThreads) {
      ids[i] = g_ids[i];
      dist[i] = g_d[i];
      exp[i] = g_exp[i];
    }
  }
  const T* qrow = reinterpret_cast<const T*>(a.q) + (long long)b * D;
  for (int i = tid; i < D; i += kThreads) s.q[i] = to_f(qrow[i]);
  const float qn = a.q_norms[b];
  __syncthreads();

  bool go = single ? block_has_work(exp, dist, a.tw) : true;
  for (int it = a.it_begin; it < a.it_end; ++it) {
    const bool peeled = a.peel && it == 0;
    if (!peeled && !go) break;
    const int cp = peeled ? 0 : a.cp;

    // 1-2. Pick: warp 0 scans the beam 32 positions at a time.
    if (warp == 0) {
      const unsigned lt = (1u << lane) - 1u;
      int na = 0, nu = 0;
      for (int base = 0; base < L && na < M; base += 32) {
        const int pos = base + lane;
        const bool in = pos < L;
        const bool av = in && available(exp[pos], dist[pos]);
        const bool un = in && !av;
        const unsigned ba = __ballot_sync(kFull, av);
        const unsigned bu = __ballot_sync(kFull, un);
        if (av) {
          const int k = na + __popc(ba & lt);
          if (k < M) s.pk[k] = pos;
        }
        if (un) {
          const int k = nu + __popc(bu & lt);
          if (k < M) s.uk[k] = pos;
        }
        na += __popc(ba);
        nu += __popc(bu);
      }
      __syncwarp();
      for (int k = lane; k < M; k += 32) {
        const bool valid = k < na;
        const int pos = valid ? s.pk[k] : s.uk[k - na];
        const int32_t id = ids[pos];
        s.pk[k] = pos;
        s.pid[k] = id;
        s.pv[k] = valid;
        g_vis[(long long)it * M + k] = valid ? id : -1;
        if (kFused && a.prefetch && valid) {
          long long p = id < 0 ? 0 : (id >= a.n_fused ? a.n_fused - 1 : id);
          prefetch_l2(a.fused + p * R * (long long)D, (unsigned)(R * D));
        }
      }
      __syncwarp();
      for (int k = lane; k < M; k += 32) exp[s.pk[k]] = 1;
    }
    for (int i = tid; i < H; i += kThreads) {
      s.keys[i] = -1;
      s.cols[i] = INT_MAX;
    }
    __syncthreads();

    // 3. Candidates, and their first columns in the table.
    for (int j = tid; j < C; j += kThreads) {
      const int k = j / R;
      int32_t c = -1;
      if (s.pv[k]) {
        long long p = s.pid[k];
        p = p < 0 ? 0 : (p >= a.n_adj ? a.n_adj - 1 : p);
        c = __ldg(a.adj + p * R + (j - k * R));
      }
      s.cand[j] = c;
      if (c >= 0) table_insert(s.keys, s.cols, H, c, j);
    }
    __syncthreads();
    // 4. Beam members and visited rows lose their slots (this iteration's
    // picks are beam members).
    for (int i = tid; i < L; i += kThreads) {
      table_mark(s.keys, s.cols, H, ids[i]);
    }
    for (int i = tid; i < it * M; i += kThreads) {
      table_mark(s.keys, s.cols, H, g_vis[i]);
    }
    __syncthreads();

    // 5. Survivors in column order (at most cp on the split path).
    const int limit = (!kFused && cp > 0 && cp < C) ? cp : C;
    int n_good = 0;
    for (int j0 = 0; j0 < C; j0 += kThreads) {
      const int j = j0 + tid;
      const int32_t c = j < C ? s.cand[j] : -1;
      const bool good = c >= 0 && table_first(s.keys, s.cols, H, c, j);
      int pos;
      const int total = block_scan(good, &pos, s.warp_n);
      pos += n_good;
      if (good && pos < limit) {
        s.s_id[pos] = c;
        s.s_col[pos] = j;
      }
      n_good += total;
    }
    const int S = n_good < limit ? n_good : limit;
    __syncthreads();  // the survivors' ids and columns, before scoring
    score_rows<T, kFused>(a, s.q, qn, s.s_id, s.s_col, s.s_d, s.pid, S,
                          warp, kWarps, lane);
    __syncthreads();

    // 6. The survivors that can enter the beam (a distance below its last
    // entry's) ranked by (distance, column), then the merge.
    const float worst = dist[L - 1];
    int Q = 0;
    for (int i0 = 0; i0 < S; i0 += kThreads) {
      const int i = i0 + tid;
      const bool in = i < S && s.s_d[i] < worst;
      int pos;
      const int total = block_scan(in, &pos, s.warp_n);
      if (in) s.s_col[Q + pos] = i;
      Q += total;
    }
    __syncthreads();
    rank_survivors(s.s_d, s.s_col, Q, s.ranked, tid, kThreads,
                   [] { __syncthreads(); });
    const unsigned long long* keys = s.ranked;
    for (int i = tid; i < L; i += kThreads) {
      const float di = dist[i];
      const int pos = i + count_less(keys, Q, di);
      if (pos < L) {
        n_ids[pos] = ids[i];
        n_dist[pos] = di;
        n_exp[pos] = exp[i];
      }
    }
    for (int j = tid; j < Q; j += kThreads) {
      const int idx = (int)(uint32_t)keys[j];
      const float dj = s.s_d[idx];
      const int pos = j + count_le(dist, L, dj);
      if (pos < L) {
        n_ids[pos] = s.s_id[idx];
        n_dist[pos] = dj;
        n_exp[pos] = 0;
      }
    }
    __syncthreads();
    {
      int32_t* ti = ids; ids = n_ids; n_ids = ti;
      float* td = dist; dist = n_dist; n_dist = td;
      uint8_t* te = exp; exp = n_exp; n_exp = te;
    }
    const bool work = block_has_work(exp, dist, a.tw);
    if (work && tid == 0 && it + 1 < a.n_flags) a.flags[it + 1] = 1;
    if (single) {
      go = work;
    } else if (it + 1 < a.it_end) {  // a walk: the batch's rule
      cg::this_grid().sync();
      go = *reinterpret_cast<volatile int32_t*>(&a.flags[it + 1]) != 0;
    }
  }

  if (ids != g_ids) {  // the last merge's buffer to the state
    for (int i = tid; i < L; i += kThreads) {
      g_ids[i] = ids[i];
      g_d[i] = dist[i];
      g_exp[i] = exp[i];
    }
  }
}

// --- Host side. ---

// The kernel of (variant, table dtype, path), and its index in g_raised.
const void* kernel_of(int variant, int bf16, int fused, int* index) {
  *index = variant * 4 + bf16 * 2 + fused;
  if (variant == kWarpVariant) {
    if (bf16) {
      return fused ? (const void*)beam_warp_kernel<__nv_bfloat16, true>
                   : (const void*)beam_warp_kernel<__nv_bfloat16, false>;
    }
    return fused ? (const void*)beam_warp_kernel<float, true>
                 : (const void*)beam_warp_kernel<float, false>;
  }
  if (bf16) {
    return fused ? (const void*)beam_block_kernel<__nv_bfloat16, true>
                 : (const void*)beam_block_kernel<__nv_bfloat16, false>;
  }
  return fused ? (const void*)beam_block_kernel<float, true>
               : (const void*)beam_block_kernel<float, false>;
}

constexpr int kMaxDevices = 64;
bool g_raised[kMaxDevices][8] = {};

// Whether the warp variant takes the shape.
bool warp_takes(int bf16, int fused, int l, int d, int m, int r, int v) {
  const int elems = fused ? 16 : (bf16 ? 8 : 4);
  return l <= kWarpMaxL && m <= kWarpMaxM && m * r <= kWarpMaxC &&
         d / elems <= kWarpMaxChunks && v <= kWarpMaxVisited;
}

struct Launch {
  const void* kernel;
  int threads, queries;  // threads and queries a block
  size_t smem;           // dynamic shared memory of a block
};

// The launch shape of a variant, its kernel's shared memory limit raised
// to the card's opt-in limit when the block needs more than 48 KB. A beam
// kept in global memory (beam_in_smem false) leaves the block variant's
// shared memory without it. Returns a CUDA error.
int prepare(int variant, int bf16, int fused, int l, int d, int m, int r,
            int v, bool beam_in_smem, Launch* out) {
  int dev = 0, optin = 0, index = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int c = m * r, h = table_slots(c);
  out->kernel = kernel_of(variant, bf16, fused, &index);
  if (variant == kWarpVariant) {
    out->threads = kWarpQueries * 32;
    out->queries = kWarpQueries;
    Args shape{};
    shape.l = l;
    shape.d = d;
    shape.m = m;
    shape.r = r;
    shape.v = v;
    shape.h = h;
    out->smem = (size_t)kWarpQueries * warp_layout(&shape);
  } else {
    out->threads = kThreads;
    out->queries = 1;
    out->smem = block_smem_bytes(l, d, c, m, h, beam_in_smem);
  }
  if (out->smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (out->smem > 48 * 1024 && !g_raised[dev][index]) {
    err = cudaFuncSetAttribute(out->kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return (int)err;
    g_raised[dev][index] = true;
  }
  return 0;
}

// The block variant keeps a beam in shared memory while it fits.
bool beam_fits(int l, int d, int m, int r) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return true;  // the launch reports the error
  }
  const int c = m * r;
  return block_smem_bytes(l, d, c, m, table_slots(c), true) <= (size_t)optin;
}

}  // namespace

// Bytes of global scratch a launch of the block variant needs for each
// query: 0 when the beam of L entries fits the current device's shared
// memory with the rest of a block's state, else 9 * L (a second copy of its
// ids, distances and flags); negative: a CUDA error.
extern "C" long long vdb_beam_iter_scratch(int l, int d, int m, int r) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return -(long long)err;
  const int c = m * r;
  const size_t smem = block_smem_bytes(l, d, c, m, table_slots(c), true);
  return smem <= (size_t)optin ? 0 : 9LL * l;
}

// 1 when kernel `variant` takes the shape, else 0.
extern "C" int vdb_beam_iter_takes(int variant, int bf16, int fused, int l,
                                   int d, int m, int r, int v) {
  return variant == kBlockVariant ||
         (variant == kWarpVariant && warp_takes(bf16, fused, l, d, m, r, v));
}

// Each kernel's resources on the current device for a walk's shape: out =
// [registers a thread, local (stack) bytes a thread, static shared memory,
// resident blocks a multiprocessor, threads a block, queries a block,
// dynamic shared memory a block]. Returns a CUDA error (0: none);
// cudaErrorInvalidValue for a variant that does not take the shape.
extern "C" int vdb_beam_iter_attrs(int variant, int bf16, int fused, int l,
                                   int d, int m, int r, int v, int* out) {
  if ((variant != kWarpVariant && variant != kBlockVariant) ||
      (variant == kWarpVariant && !warp_takes(bf16, fused, l, d, m, r, v))) {
    return (int)cudaErrorInvalidValue;
  }
  Launch ln;
  int err = prepare(variant, bf16, fused, l, d, m, r, v,
                    variant == kWarpVariant || beam_fits(l, d, m, r), &ln);
  if (err != 0) return err;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, ln.kernel);
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ln.kernel,
                                                      ln.threads, ln.smem);
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)fa.sharedSizeBytes;
  out[3] = blocks;
  out[4] = ln.threads;
  out[5] = ln.queries;
  out[6] = (int)ln.smem;
  return 0;
}

// Queries of a walk's shape resident at once on one multiprocessor of the
// current device (blocks a multiprocessor x queries a block): a batch of
// at most this many times the multiprocessor count walks in one
// cooperative launch. Negative: a CUDA error.
extern "C" long long vdb_beam_iter_resident(int variant, int bf16, int fused,
                                            int l, int d, int m, int r,
                                            int v) {
  int out[7];
  const int err = vdb_beam_iter_attrs(variant, bf16, fused, l, d, m, r, v,
                                      out);
  return err != 0 ? -(long long)err : (long long)out[3] * out[5];
}

// Launches iterations [it_begin, it_end) of the traversal on `stream` (on
// the current device) with kernel `variant` (0: a block a query, 1: a warp
// a query) and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take. Tensors are
// contiguous; table and fused rows 16-byte aligned (d a multiple of 16);
// bf16 != 0 for a bf16 table and query; fused may be null; scratch null
// (the beam in shared memory) or b * vdb_beam_iter_scratch() bytes, 4-byte
// aligned, block variant only; done: the warp variant's walk of a batch
// (b > 1, more than one iteration) needs it_end - it_begin int32 zeros,
// else null. A batch that walks more than one iteration is launched
// cooperatively (every block resident at once; refused with
// cudaErrorCooperativeLaunchTooLarge when the card cannot hold them).
extern "C" int vdb_beam_iter(const void* q, const float* q_norms,
                             const void* table, const int32_t* adj,
                             const int8_t* fused, float scale,
                             int32_t* beam_ids, uint8_t* beam_exp,
                             float* beam_d, int32_t* visited, int32_t* flags,
                             long long n_table, long long n_adj,
                             long long n_fused, int b, int d, int l, int m,
                             int r, int v, int cp, int tw, int metric,
                             int it_begin, int it_end, int peel, int n_flags,
                             int bf16, void* scratch, void* stream,
                             int variant, int32_t* done) {
  const int c = m * r;
  const int h = table_slots(c);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(fused) |
                          reinterpret_cast<uintptr_t>(q);
  const bool fz = fused != nullptr;
  if (b < 1 || d < 16 || d % 16 != 0 || l < m || m < 1 || r < 1 ||
      c > 4096 || n_table < 1 || n_adj < 1 || (fz && n_fused < 1) ||
      it_begin < 0 || it_end < it_begin || (long long)it_end * m > v ||
      n_flags < it_end || tw < 0 || tw > l || align % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 4 != 0 ||
      (variant != kWarpVariant && variant != kBlockVariant) ||
      (variant == kWarpVariant &&
       (scratch || !warp_takes(bf16, fz, l, d, m, r, v) ||
        (b > 1 && it_end > it_begin + 1 && !done)))) {
    return (int)cudaErrorInvalidValue;
  }
  if (it_end == it_begin) return (int)cudaGetLastError();
  Launch ln;
  const int err = prepare(variant, bf16, fz, l, d, m, r, v,
                          scratch == nullptr, &ln);
  if (err != 0) return err;
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const long long bl = (long long)b * l;
  Args a{q,       q_norms,  table,    adj,     fused,
         beam_ids, beam_exp, beam_d,  visited, flags,   done,
         sc ? reinterpret_cast<int32_t*>(sc) : nullptr,
         sc ? reinterpret_cast<float*>(sc + 4 * bl) : nullptr,
         sc ? sc + 8 * bl : nullptr,
         n_table, n_adj,   n_fused,  scale,
         b,       d,       l,        m,       r,       v,      cp,
         tw,      metric,  it_begin, it_end,  peel,    n_flags, h,
         fz && b == 1 ? 1 : 0};
  a.warp_bytes = warp_layout(&a);
  const int grid = (b + ln.queries - 1) / ln.queries;
  void* params[] = {&a};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (b > 1 && it_end > it_begin + 1) {
    e = cudaLaunchCooperativeKernel(ln.kernel, dim3(grid), dim3(ln.threads),
                                    params, ln.smem, st);
  } else {
    e = cudaLaunchKernel(ln.kernel, dim3(grid), dim3(ln.threads), params,
                         ln.smem, st);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next
    return (int)e;
  }
  return (int)cudaGetLastError();
}
