// Beam traversal iterations over a fixed-degree graph, for NVIDIA Hopper
// (sm_90a): one thread block a query, one launch an iteration for a batch,
// the whole walk in one launch for a single query.
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
// its first `tw` beam positions. Each block ORs its query's "work left"
// after an iteration into flags[it + 1]; an iteration's launch reads
// flags[it] first and leaves the state as it is when it is 0. So a batch
// needs no host sync between launches. With one query the batch's rule is
// the query's own, and one launch runs iterations [it_begin, it_end) in a
// loop, checking its own state before each.
//
// What bounds it: the bytes of the state and of the rows it reads (each
// beam entry read and written, visited, M adjacency rows, the survivors'
// rows or M fused rows), at about 27 KB a query-iteration at L = 64 and 96
// bf16 rows of 256 B: 17 us a launch of 2,048 queries at 3.35 TB/s. The
// arithmetic (2 C D flops a query) is negligible. At one query the walk is
// a chain of dependent loads (beam -> adjacency -> rows), so latency, not
// bandwidth, sets its time.
//
// Design (a simple kernel first):
// - The beam (ids, distances, expanded flags) lives in shared memory for
//   the launch, double-buffered for the merge, while it fits the card's
//   opt-in limit (to L of about 12,000 at C = 192); a wider beam is
//   double-buffered in global memory instead: the state itself and a
//   scratch copy of it that the caller passes. visited stays in global
//   memory (only its written prefix is read).
// - Candidate filtering is a hash table in shared memory of 2C or more
//   slots: each candidate is inserted (atomicCAS on the key, atomicMin of
//   its column), each beam id and each visited id marks its slot bad. A
//   candidate survives iff its slot is not bad and holds its own column:
//   O(C + L + visited) work, not the C x C, C x L and C x V compares.
// - The survivors are compacted in column order with warp ballots.
// - Scoring: a group of lanes a survivor (up to 32, as many as the row has
//   16-byte vectors), 16-byte loads, a shuffle reduction.
// - Merge: survivors ranked by (distance, column) by counting (S <= C),
//   then every beam entry and every survivor finds its output position by a
//   binary search in the other sorted list (a merge-path).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEuclidean = 1;  // MetricType values of the package
constexpr int kCosine = 2;

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
  int32_t* sc_ids;       // [B, L] scratch of a beam kept in global memory,
  float* sc_d;           // or null when the beam lives in shared memory
  uint8_t* sc_exp;
  long long n_table, n_adj, n_fused;  // rows of table, adj and fused
  float scale;
  int b, d, l, m, r, v, cp, tw, metric, it_begin, it_end, peel, n_flags, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of row elements, widened to f32: 8 bf16, 4 f32 or 16 int8.
template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const void* p, float* out) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const void* p, float* out) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  }
};
template <>
struct Vec<int8_t> {
  static constexpr int kN = 16;
  __device__ static void load(const void* p, float* out) {
    const int4 u = __ldg(reinterpret_cast<const int4*>(p));
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = (float)c[i];
  }
};

__device__ __forceinline__ unsigned slot_of(int32_t key, int h) {
  return ((unsigned)key * 2654435761u) & (unsigned)(h - 1);
}

// Slot holding `key` in the open-addressing table, or -1.
__device__ __forceinline__ int find(const int32_t* keys, int h, int32_t key) {
  unsigned s = slot_of(key, h);
  for (int probe = 0; probe < h; ++probe) {
    const int32_t k = keys[s];
    if (k == key) return (int)s;
    if (k == -1) return -1;
    s = (s + 1) & (unsigned)(h - 1);
  }
  return -1;
}

__device__ __forceinline__ bool available(uint8_t exp, float d) {
  return !exp && isfinite(d);
}

// Shared memory of one block, carved from the dynamic allocation.
struct Smem {
  int32_t* ids[2];
  float* dist[2];
  uint8_t* exp[2];
  float* q;
  int32_t* cand;   // [C]
  int32_t* s_id;   // [C] survivors in column order
  int32_t* s_col;  // [C]
  float* s_d;      // [C]
  int32_t* o_id;   // [C] survivors by (distance, column)
  float* o_d;      // [C]
  int32_t* keys;   // [h]
  int32_t* minc;   // [h]
  int32_t* bad;    // [h]
  int32_t* pick;   // [M] beam positions
  int32_t* upick;  // [M] unavailable positions
  int32_t* pid;    // [M]
  int32_t* pvalid; // [M]
  int32_t* warp_n; // [kWarps]
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Dynamic shared memory of a block; the beam's part only when it lives
// there (`beam`).
__host__ __device__ inline size_t smem_bytes(int l, int d, int c, int m,
                                             int h, bool beam) {
  if (!beam) l = 0;
  size_t n = 0;
  n += 2 * align16((size_t)l * 4) * 2;  // ids, dist x 2
  n += align16((size_t)d * 4);          // q
  n += 6 * align16((size_t)c * 4);      // cand .. o_d
  n += 3 * align16((size_t)h * 4);      // hash
  n += 4 * align16((size_t)m * 4);      // picks
  n += align16(kWarps * 4);
  n += 2 * align16((size_t)l);          // exp x 2
  return n;
}

__device__ Smem carve(unsigned char* base, int l, int d, int c, int m, int h) {
  // l = 0: the beam is in global memory (its pointers are set by the
  // kernel).
  Smem s;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base + o;
    o += align16(bytes);
    return p;
  };
  for (int i = 0; i < 2; ++i) {
    s.ids[i] = reinterpret_cast<int32_t*>(take((size_t)l * 4));
    s.dist[i] = reinterpret_cast<float*>(take((size_t)l * 4));
  }
  s.q = reinterpret_cast<float*>(take((size_t)d * 4));
  s.cand = reinterpret_cast<int32_t*>(take((size_t)c * 4));
  s.s_id = reinterpret_cast<int32_t*>(take((size_t)c * 4));
  s.s_col = reinterpret_cast<int32_t*>(take((size_t)c * 4));
  s.s_d = reinterpret_cast<float*>(take((size_t)c * 4));
  s.o_id = reinterpret_cast<int32_t*>(take((size_t)c * 4));
  s.o_d = reinterpret_cast<float*>(take((size_t)c * 4));
  s.keys = reinterpret_cast<int32_t*>(take((size_t)h * 4));
  s.minc = reinterpret_cast<int32_t*>(take((size_t)h * 4));
  s.bad = reinterpret_cast<int32_t*>(take((size_t)h * 4));
  s.pick = reinterpret_cast<int32_t*>(take((size_t)m * 4));
  s.upick = reinterpret_cast<int32_t*>(take((size_t)m * 4));
  s.pid = reinterpret_cast<int32_t*>(take((size_t)m * 4));
  s.pvalid = reinterpret_cast<int32_t*>(take((size_t)m * 4));
  s.warp_n = reinterpret_cast<int32_t*>(take(kWarps * 4));
  for (int i = 0; i < 2; ++i) s.exp[i] = take((size_t)l);
  return s;
}

// True for every thread when some entry of the first tw positions is
// available.
__device__ __forceinline__ bool has_work(const uint8_t* exp, const float* dist,
                                         int tw) {
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
  const unsigned bal = __ballot_sync(0xffffffffu, flag);
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
__global__ void __launch_bounds__(kThreads)
beam_iter_kernel(Args a) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.l, M = a.m, R = a.r, D = a.d, C = a.m * a.r, H = a.h;
  const bool single = gridDim.x == 1;
  // A batch's launch runs one iteration, after a flag that says some query
  // had work (the peeled iteration 0 runs unconditionally).
  if (!single && !(a.peel && a.it_begin == 0) && a.flags[a.it_begin] == 0) {
    return;
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool in_smem = a.sc_ids == nullptr;
  Smem s = carve(smem_raw, in_smem ? L : 0, D, C, M, H);
  int cur = 0;

  int32_t* g_ids = a.beam_ids + (long long)b * L;
  uint8_t* g_exp = a.beam_exp + (long long)b * L;
  float* g_d = a.beam_d + (long long)b * L;
  int32_t* g_vis = a.visited + (long long)b * a.v;
  if (in_smem) {
    for (int i = tid; i < L; i += kThreads) {
      s.ids[0][i] = g_ids[i];
      s.dist[0][i] = g_d[i];
      s.exp[0][i] = g_exp[i];
    }
  } else {  // buffer 0 is the state itself, buffer 1 the scratch
    s.ids[0] = g_ids;
    s.dist[0] = g_d;
    s.exp[0] = g_exp;
    s.ids[1] = a.sc_ids + (long long)b * L;
    s.dist[1] = a.sc_d + (long long)b * L;
    s.exp[1] = a.sc_exp + (long long)b * L;
  }
  const T* qrow = reinterpret_cast<const T*>(a.q) + (long long)b * D;
  for (int i = tid; i < D; i += kThreads) s.q[i] = to_f(qrow[i]);
  const float qn = a.q_norms[b];
  __syncthreads();

  bool work = single ? has_work(s.exp[0], s.dist[0], a.tw) : true;
  for (int it = a.it_begin; it < a.it_end; ++it) {
    const bool peeled = a.peel && it == 0;
    if (!peeled && !work) break;
    const int cp = peeled ? 0 : a.cp;
    int32_t* ids = s.ids[cur];
    float* dist = s.dist[cur];
    uint8_t* exp = s.exp[cur];

    // 1-2. Pick: warp 0 scans the beam 32 positions at a time.
    if (warp == 0) {
      int na = 0, nu = 0;
      for (int base = 0; base < L && na < M; base += 32) {
        const int pos = base + lane;
        const bool in = pos < L;
        const bool av = in && available(exp[pos], dist[pos]);
        const bool un = in && !av;
        const unsigned ba = __ballot_sync(0xffffffffu, av);
        const unsigned bu = __ballot_sync(0xffffffffu, un);
        const unsigned lt = (1u << lane) - 1u;
        if (av) {
          const int k = na + __popc(ba & lt);
          if (k < M) s.pick[k] = pos;
        }
        if (un) {
          const int k = nu + __popc(bu & lt);
          if (k < M) s.upick[k] = pos;
        }
        na += __popc(ba);
        nu += __popc(bu);
      }
      __syncwarp();
      for (int k = lane; k < M; k += 32) {
        const bool valid = k < na;
        const int pos = valid ? s.pick[k] : s.upick[k - na];
        const int32_t id = ids[pos];
        s.pick[k] = pos;
        s.pid[k] = id;
        s.pvalid[k] = valid;
        g_vis[(long long)it * M + k] = valid ? id : -1;
      }
      __syncwarp();
      for (int k = lane; k < M; k += 32) exp[s.pick[k]] = 1;
    }
    // Hash table cleared while warp 0 picks.
    for (int i = tid; i < H; i += kThreads) {
      s.keys[i] = -1;
      s.minc[i] = INT_MAX;
      s.bad[i] = 0;
    }
    __syncthreads();

    // 3. Candidates, and their first columns in the hash table.
    for (int j = tid; j < C; j += kThreads) {
      const int k = j / R;
      int32_t c = -1;
      if (s.pvalid[k]) {
        long long p = s.pid[k];
        p = p < 0 ? 0 : (p >= a.n_adj ? a.n_adj - 1 : p);
        c = __ldg(a.adj + p * R + (j - k * R));
      }
      s.cand[j] = c;
      if (c >= 0) {
        unsigned h = slot_of(c, H);
        for (;;) {
          const int32_t prev = atomicCAS(&s.keys[h], -1, c);
          if (prev == -1 || prev == c) {
            atomicMin(&s.minc[h], j);
            break;
          }
          h = (h + 1) & (unsigned)(H - 1);
        }
      }
    }
    __syncthreads();
    // 4. Beam members and visited rows mark their slots bad.
    for (int i = tid; i < L; i += kThreads) {
      const int32_t id = ids[i];
      if (id >= 0) {
        const int h = find(s.keys, H, id);
        if (h >= 0) s.bad[h] = 1;
      }
    }
    const int n_vis = it * M;  // this iteration's picks are beam members
    for (int i = tid; i < n_vis; i += kThreads) {
      const int32_t id = g_vis[i];
      if (id >= 0) {
        const int h = find(s.keys, H, id);
        if (h >= 0) s.bad[h] = 1;
      }
    }
    __syncthreads();

    // 5. Survivors in column order (at most cp on the split path).
    const int limit = (!kFused && cp > 0 && cp < C) ? cp : C;
    int n_good = 0;
    for (int j0 = 0; j0 < C; j0 += kThreads) {
      const int j = j0 + tid;
      bool good = false;
      int32_t c = -1;
      if (j < C) {
        c = s.cand[j];
        if (c >= 0) {
          const int h = find(s.keys, H, c);
          good = s.minc[h] == j && !s.bad[h];
        }
      }
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

    // Scores: a group of G lanes a survivor.
    {
      constexpr int kE = kFused ? Vec<int8_t>::kN : Vec<T>::kN;
      const int chunks = D / kE;
      int g = 1;
      while (g < chunks && g < 32) g <<= 1;
      const int per_warp = 32 / g;
      const int sub = lane / g, gl = lane % g;
      for (int s0 = warp * per_warp; s0 < S; s0 += kWarps * per_warp) {
        const int si = s0 + sub;
        float ip = 0.f, vn = 0.f;
        if (si < S) {
          const unsigned char* row;
          if constexpr (kFused) {
            const int col = s.s_col[si];
            const int k = col / R;
            long long p = s.pid[k];
            p = p < 0 ? 0 : (p >= a.n_fused ? a.n_fused - 1 : p);
            row = reinterpret_cast<const unsigned char*>(a.fused) +
                  (p * R + (col - k * R)) * (long long)D;
          } else {
            long long p = s.s_id[si];
            p = p >= a.n_table ? a.n_table - 1 : p;
            row = reinterpret_cast<const unsigned char*>(a.table) +
                  p * (long long)D * (long long)sizeof(T);
          }
          for (int ch = gl; ch < chunks; ch += g) {
            float x[kE];
            if constexpr (kFused) {
              Vec<int8_t>::load(row + (long long)ch * 16, x);
            } else {
              Vec<T>::load(row + (long long)ch * 16, x);
            }
            const float* qq = s.q + ch * kE;
#pragma unroll
            for (int e = 0; e < kE; ++e) {
              ip = fmaf(x[e], qq[e], ip);
              vn = fmaf(x[e], x[e], vn);
            }
          }
        }
        for (int o = g >> 1; o > 0; o >>= 1) {
          ip = __fadd_rn(ip, __shfl_xor_sync(0xffffffffu, ip, o));
          vn = __fadd_rn(vn, __shfl_xor_sync(0xffffffffu, vn, o));
        }
        if (si < S && gl == 0) {
          float dd;
          if constexpr (kFused) {
            const float sc = a.scale;
            const float sip = __fmul_rn(sc, ip);
            if (a.metric == kEuclidean) {
              dd = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f * sc, ip)),
                             __fmul_rn(__fmul_rn(sc, sc), vn));
            } else if (a.metric == kCosine) {
              dd = __fsub_rn(1.f, sip);
            } else {
              dd = -sip;
            }
          } else {
            if (a.metric == kEuclidean) {
              dd = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, ip)), vn);
            } else if (a.metric == kCosine) {
              dd = __fsub_rn(1.f, ip);
            } else {
              dd = -ip;
            }
          }
          s.s_d[si] = dd;
        }
      }
    }
    __syncthreads();

    // 6. Survivors ranked by (distance, column), then the merge.
    for (int i = tid; i < S; i += kThreads) {
      const float di = s.s_d[i];
      int rank = 0;
      for (int t = 0; t < S; ++t) {
        const float dt = s.s_d[t];
        rank += (dt < di) || (dt == di && t < i);
      }
      s.o_d[rank] = di;
      s.o_id[rank] = s.s_id[i];
    }
    __syncthreads();
    int32_t* n_ids = s.ids[cur ^ 1];
    float* n_dist = s.dist[cur ^ 1];
    uint8_t* n_exp = s.exp[cur ^ 1];
    for (int i = tid; i < L; i += kThreads) {
      const float di = dist[i];
      int lo = 0, hi = S;  // survivors with a distance < di
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s.o_d[mid] < di) lo = mid + 1; else hi = mid;
      }
      const int pos = i + lo;
      if (pos < L) {
        n_ids[pos] = ids[i];
        n_dist[pos] = di;
        n_exp[pos] = exp[i];
      }
    }
    for (int j = tid; j < S; j += kThreads) {
      const float dj = s.o_d[j];
      int lo = 0, hi = L;  // beam entries with a distance <= dj
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (dist[mid] <= dj) lo = mid + 1; else hi = mid;
      }
      const int pos = j + lo;
      if (pos < L) {
        n_ids[pos] = s.o_id[j];
        n_dist[pos] = dj;
        n_exp[pos] = 0;
      }
    }
    __syncthreads();
    cur ^= 1;
    work = has_work(s.exp[cur], s.dist[cur], a.tw);
    if (work && tid == 0 && it + 1 < a.n_flags) a.flags[it + 1] = 1;
  }

  if (in_smem || cur == 1) {  // the last merge's buffer to the state
    for (int i = tid; i < L; i += kThreads) {
      g_ids[i] = s.ids[cur][i];
      g_d[i] = s.dist[cur][i];
      g_exp[i] = s.exp[cur][i];
    }
  }
}

constexpr int kMaxDevices = 64;
constexpr int kVariants = 4;  // (bf16, f32) x (split, fused)
bool g_raised[kMaxDevices][kVariants] = {};

template <typename T, bool kFused>
int launch(const Args& a, size_t smem, cudaStream_t st, int variant) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // The caller keeps a beam that would pass the limit in global memory;
  // the rest of a block's state (about 200 KB at C = 4096) fits.
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  // Above 48 KB a launch is refused unless the kernel's limit is raised:
  // raised to the card's opt-in limit once a device and variant.
  if (smem > 48 * 1024 && !g_raised[dev][variant]) {
    err = cudaFuncSetAttribute(beam_iter_kernel<T, kFused>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return (int)err;
    g_raised[dev][variant] = true;
  }
  beam_iter_kernel<T, kFused><<<a.b, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

int table_slots(int c) {
  int h = 64;
  while (h < 2 * c) h <<= 1;
  return h;
}

}  // namespace

// Bytes of global scratch a launch needs for each query: 0 when the beam
// of L entries fits the current device's shared memory with the rest of a
// block's state, else 9 * L (a second copy of its ids, distances and
// flags); negative: a CUDA error.
extern "C" long long vdb_beam_iter_scratch(int l, int d, int m, int r) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return -(long long)err;
  const int c = m * r;
  const size_t smem = smem_bytes(l, d, c, m, table_slots(c), true);
  return smem <= (size_t)optin ? 0 : 9LL * l;
}

// Launches iterations [it_begin, it_end) of the traversal on `stream` (on
// the current device) and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take. Tensors are
// contiguous; table and fused rows 16-byte aligned (d a multiple of 16);
// bf16 != 0 for a bf16 table and query; fused may be null; it_end ==
// it_begin + 1 unless b == 1; scratch null (the beam in shared memory)
// or b * vdb_beam_iter_scratch() bytes, 4-byte aligned.
extern "C" int vdb_beam_iter(const void* q, const float* q_norms,
                             const void* table, const int32_t* adj,
                             const int8_t* fused, float scale,
                             int32_t* beam_ids, uint8_t* beam_exp,
                             float* beam_d, int32_t* visited, int32_t* flags,
                             long long n_table, long long n_adj,
                             long long n_fused, int b, int d, int l, int m,
                             int r, int v, int cp, int tw, int metric,
                             int it_begin, int it_end, int peel, int n_flags,
                             int bf16, void* scratch, void* stream) {
  const int c = m * r;
  const int h = table_slots(c);
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(fused) |
                          reinterpret_cast<uintptr_t>(q);
  if (b < 1 || d < 16 || d % 16 != 0 || l < m || m < 1 || r < 1 ||
      c > 4096 || n_table < 1 || n_adj < 1 || (fused && n_fused < 1) ||
      it_begin < 0 || it_end < it_begin ||
      (long long)it_end * m > v || (b > 1 && it_end > it_begin + 1) ||
      n_flags < it_end || tw < 0 || tw > l || align % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (it_end == it_begin) return (int)cudaGetLastError();
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  const long long bl = (long long)b * l;
  Args a{q,       q_norms,  table,    adj,     fused,
         beam_ids, beam_exp, beam_d,  visited, flags,
         sc ? reinterpret_cast<int32_t*>(sc) : nullptr,
         sc ? reinterpret_cast<float*>(sc + 4 * bl) : nullptr,
         sc ? sc + 8 * bl : nullptr,
         n_table, n_adj,   n_fused,  scale,
         b,       d,       l,        m,       r,       v,      cp,
         tw,      metric,  it_begin, it_end,  peel,    n_flags, h};
  const size_t smem = smem_bytes(l, d, c, m, h, sc == nullptr);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    return fused ? launch<__nv_bfloat16, true>(a, smem, st, 0)
                 : launch<__nv_bfloat16, false>(a, smem, st, 1);
  }
  return fused ? launch<float, true>(a, smem, st, 2)
               : launch<float, false>(a, smem, st, 3);
}
