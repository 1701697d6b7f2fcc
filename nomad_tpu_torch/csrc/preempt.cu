// K7 "preempt_bulk": device preemption for one task group's failed
// placements, one persistent launch for all of them.
//
// Replaces (TPU side, jax.jit): nomad_tpu/ops/preempt.py:108
// preempt_bulk (its lax.scan step), called from
// nomad_tpu/ops/engine.py:1161 _preempt_device.
//
// What bounds it on the H100: sequential depth.  Placement i must see
// the victims placements < i consumed and the capacity they committed,
// so the batch is n_place dependent steps over the M candidate rows of
// the compact victim table (config 4: 125 real of 128 padded steps over
// 512 rows of one victim each).  The bytes and operations of the whole
// batch are microseconds.
//
// Design: the per-row key cached, one warp's step.  Two identities of
// the reference (tests/test_torch_preempt.py) make it exact:
//   - row locality: a row's key (cost, then row) depends on that row's
//     inputs and state (usage, job count, victims consumed) only, and a
//     step changes the state of the chosen row and of no other, so every
//     other row's key carries over to the next step;
//   - the consumed victims are always a prefix of the row's table, so a
//     row's state is a count c, not a mask: a first fit k < c takes
//     nothing, else the victims [c, k].
// Set-up (all 1024 threads): every row's state, its first fit k and its
// 64-bit key (orderable cost bits, then the row: the lowest row wins a
// tie, as argmin orders them), then a 32-ary tournament tree of the keys,
// level by level.  A step (warp 0 alone, no block barrier): read the
// root, commit its row (lane v holds victim v: the freed resources are
// warp sums), write the step's (row, victims) pair, recompute that row's
// key (the first-fit prefix as a lane scan; the cost prefix summed in
// XLA's order for a cumsum, in order up to 16 victims, for 32 two blocks
// of 16 with the first block's sum added to the second, broadcast lane
// by lane), and replace the leaf-to-root path (each level one warp
// minimum over the 32 siblings).  Steps past n_real, or after a root
// with no feasible row, compute nothing: their (-1, 0) is written at
// set-up.  The row state (keys, usage, job counts, c and k: 26 bytes a
// row) lives in shared memory when the M rows fit (up to 8,852 rows on
// an H100: `preempt_smem_rows`), else the keys and (c, k) in the
// wrapper's global scratch and the usage and job counts in the outputs
// themselves (the L2 holds them); the tree's upper levels (M / 31 keys)
// always live in shared memory.  Set-up computes keys one thread a row
// (its loads spread over 1024 threads), a step one warp a row (lane v
// victim v): two forms of one key that the card tests hold equal.
// The victim cost (prio + 1) * 1000 + resource sum is one fma, as XLA
// fuses it.

#include "py_launchers.cuh"  // first: it includes Python.h
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 1024;
constexpr int MAX_A = 32;
constexpr int SCAN_BLOCK = 16;     // XLA's blocked cumsum length
constexpr float BIG_COST = 1e30f;
constexpr unsigned long long NO_KEY = ~0ull;   // an empty tree slot
constexpr int MAX_LEVELS = 5;      // 32^5 rows

#include "score_common.cuh"        // orderable, FULL, PhaseClock

struct PreParams {
  const int* cap;            // [M, 3]
  const int* used0;          // [M, 3]
  const uint8_t* stat;       // [M]
  const int* jc0;            // [M]
  const int* prio;           // [M, A]
  const int* res;            // [M, A, 3]
  const int* req;            // [3]
  const int* k0;             // [M]
  int m, a, dh, n_place, n_real;
  int* best;                 // [n_place]
  int* ks;                   // [n_place]
  int* used;                 // [M, 3] output
  int* jc;                   // [M] output
  unsigned char* scratch;    // keys and (c, k) past shared memory
  long long* prof;           // PROF: [10] phase cycles (PhaseClock)
};

// Phase split of the PROF instantiation (PhaseClock, score_common.cuh):
// a computed step's commit (the root's row read and committed), the new
// key of that row, the tree path; padding steps are only counted
enum { PH_COMMIT, PH_KEY, PH_TREE, NPHASE };

// Where a launch keeps its state: the tree levels above the leaves
// (always shared), and the rows' keys, usage, job counts and (c, k)
// (shared when they fit, else the keys and (c, k) in global scratch and
// usage and job counts in the outputs).
struct Plan {
  int levels;                         // tree levels above the leaves
  long long lvl_off[MAX_LEVELS + 1];  // key offset of level l + 1 in the
                                      // tree; [levels]: its key count
  long long smem, scratch;            // bytes
  bool rows_in_smem;
};

__host__ __device__ inline long long align8(long long x) {
  return (x + 7) & ~7ll;
}

__host__ __device__ inline bool make_plan(int m, long long smem_max,
                                          Plan* pl) {
  pl->levels = 0;
  long long n = m, keys = 0;
  while (n > 1) {
    if (pl->levels == MAX_LEVELS) return false;
    n = (n + 31) / 32;
    pl->lvl_off[pl->levels++] = keys;
    keys += n;
  }
  pl->lvl_off[pl->levels] = keys;
  const long long tree = keys * 8;
  // keys, usage, job counts, (c, k)
  const long long rows = (long long)m * 8 + (long long)m * 12 +
                         (long long)m * 4 + align8((long long)m * 2);
  pl->rows_in_smem = tree + rows <= smem_max;
  if (pl->rows_in_smem) {
    pl->smem = tree + rows;
    pl->scratch = 0;
  } else {
    pl->smem = tree;
    pl->scratch = (long long)m * 8 + align8((long long)m * 2);
  }
  return pl->smem <= smem_max;
}

// (c, k) of a row: victims consumed, first fit + 1 (0: none fits)
__device__ __forceinline__ uint16_t pack_ck(int c, int k) {
  return (uint16_t)(c | ((k + 1) << 8));
}

// first index k whose alive prefix (victims c..) frees enough, or -1:
// one thread, in victim order
__device__ __forceinline__ int first_fit_row(const PreParams& p, int i,
                                             const int* u, int c) {
  const int f0 = p.cap[3 * i] - u[0];
  const int f1 = p.cap[3 * i + 1] - u[1];
  const int f2 = p.cap[3 * i + 2] - u[2];
  int g0 = 0, g1 = 0, g2 = 0;
  const int* r = p.res + (int64_t)i * p.a * 3;
  for (int v = 0; v < p.a; ++v) {
    if (v >= c) {
      g0 += r[3 * v];
      g1 += r[3 * v + 1];
      g2 += r[3 * v + 2];
    }
    if (f0 + g0 >= p.req[0] && f1 + g1 >= p.req[1] && f2 + g2 >= p.req[2])
      return v;
  }
  return -1;
}

__device__ __forceinline__ float victim_cost(const PreParams& p, int i,
                                             int v) {
  const int* r = p.res + ((int64_t)i * p.a + v) * 3;
  const float rs = (float)(r[0] + r[1] + r[2]);
  return __fmaf_rn((float)p.prio[(int64_t)i * p.a + v] + 1.0f, 1000.0f, rs);
}

// cost prefix at k of the alive victims (c..), summed as XLA's CPU cumsum
// sums it: one thread
__device__ __forceinline__ float cost_row(const PreParams& p, int i, int c,
                                          int k) {
  const int a = p.a;
  const int b = a > SCAN_BLOCK ? k / SCAN_BLOCK : 0;
  float carry = 0.0f;
  for (int bb = 0; bb < b; ++bb) {
    float s = 0.0f;
    for (int v = bb * SCAN_BLOCK; v < (bb + 1) * SCAN_BLOCK; ++v)
      s = s + (v >= c ? victim_cost(p, i, v) : 0.0f);
    carry = carry + s;
  }
  float local = 0.0f;
  for (int v = b * SCAN_BLOCK; v <= k; ++v)
    local = local + (v >= c ? victim_cost(p, i, v) : 0.0f);
  return a > SCAN_BLOCK ? local + carry : local;
}

// the same prefix with lane v holding victim v's term x (0 when not
// alive): every lane sums the broadcast terms in the same order
__device__ __forceinline__ float cost_warp(float x, int a, int k) {
  const int b = a > SCAN_BLOCK ? k / SCAN_BLOCK : 0;
  float carry = 0.0f;
  for (int bb = 0; bb < b; ++bb) {
    float s = 0.0f;
    for (int v = bb * SCAN_BLOCK; v < (bb + 1) * SCAN_BLOCK; ++v)
      s = s + __shfl_sync(FULL, x, v);
    carry = carry + s;
  }
  float local = 0.0f;
  for (int v = b * SCAN_BLOCK; v <= k; ++v)
    local = local + __shfl_sync(FULL, x, v);
  return a > SCAN_BLOCK ? local + carry : local;
}

__device__ __forceinline__ unsigned long long row_key(bool feasible,
                                                      float cost, int i) {
  return ((unsigned long long)orderable(feasible ? cost : BIG_COST) << 32) |
         (unsigned)i;
}

// The warp's least key: the least cost bits, then the least row among
// the lanes that hold them (two 32-bit warp reductions)
__device__ __forceinline__ unsigned long long warp_min_key(
    unsigned long long x) {
  const unsigned hi = (unsigned)(x >> 32);
  const unsigned mh = __reduce_min_sync(FULL, hi);
  const unsigned ml = __reduce_min_sync(FULL, hi == mh ? (unsigned)x : ~0u);
  return ((unsigned long long)mh << 32) | ml;
}

template <bool SMEM, bool PROF>
__global__ void __launch_bounds__(BS, 1) preempt_kernel(PreParams p,
                                                        Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = p.m, a = p.a;
  PhaseClock<PROF, NPHASE> pc;
  pc.start(tid == 0);

  // the state's arrays
  unsigned long long* tree = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* key;
  int* su;
  int* sj;
  uint16_t* ck;
  if (SMEM) {
    key = tree + pl.lvl_off[pl.levels];
    su = reinterpret_cast<int*>(key + m);
    sj = su + 3 * m;
    ck = reinterpret_cast<uint16_t*>(sj + m);
  } else {
    key = reinterpret_cast<unsigned long long*>(p.scratch);
    su = p.used;
    sj = p.jc;
    ck = reinterpret_cast<uint16_t*>(key + m);
  }

  // set-up: every row's state and key, every step's (-1, 0)
  for (int t = tid; t < p.n_place; t += BS) {
    p.best[t] = -1;
    p.ks[t] = 0;
  }
  for (int i = tid; i < m; i += BS) {
    int u[3];
    for (int q = 0; q < 3; ++q) u[q] = su[3 * i + q] = p.used0[3 * i + q];
    const int j = sj[i] = p.jc0[i];
    const int c = min(max(p.k0[i], 0), a);
    const int k = first_fit_row(p, i, u, c);
    const bool ok = p.stat[i] && k >= 0 && (p.dh > 0 ? j < p.dh : true);
    key[i] = row_key(ok, ok ? cost_row(p, i, c, k) : 0.0f, i);
    ck[i] = pack_ck(c, k);
  }
  __syncthreads();
  // the tree, level by level: level l + 1's node j is the least of level
  // l's nodes [32 j, 32 j + 32)
  long long n_below = m;
  const unsigned long long* below = key;
  for (int l = 0; l < pl.levels; ++l) {
    const long long n = (n_below + 31) / 32;
    unsigned long long* lv = tree + pl.lvl_off[l];
    for (long long j = warp; j < n; j += BS / 32) {
      const long long src = 32 * j + lane;
      const unsigned long long x = warp_min_key(src < n_below ? below[src]
                                                              : NO_KEY);
      if (lane == 0) lv[j] = x;
    }
    __syncthreads();
    n_below = n;
    below = lv;
  }
  pc.setup_done();

  if (warp == 0) {
    const int rq0 = p.req[0], rq1 = p.req[1], rq2 = p.req[2];
    unsigned long long root = pl.levels ? tree[pl.lvl_off[pl.levels - 1]]
                                        : key[0];
    int t = 0;
    for (; t < p.n_real; ++t) {
      if (!(from_orderable((unsigned)(root >> 32)) < BIG_COST / 2)) break;
      pc.step(true);
      const int b = (int)(root & 0xffffffffull);
      // the chosen row, lane v its victim v, and the leaf's siblings
      int r0 = 0, r1 = 0, r2 = 0;
      float vc = 0.0f;
      if (lane < a) {
        const int* r = p.res + ((int64_t)b * a + lane) * 3;
        r0 = r[0];
        r1 = r[1];
        r2 = r[2];
        vc = __fmaf_rn((float)p.prio[(int64_t)b * a + lane] + 1.0f, 1000.0f,
                       (float)(r0 + r1 + r2));
      }
      const int sib = (b & ~31) + lane;
      unsigned long long x = sib < m ? key[sib] : NO_KEY;
      const int u0 = su[3 * b], u1 = su[3 * b + 1], u2 = su[3 * b + 2];
      const int jb = sj[b] + 1;
      const int ckb = ck[b];
      const int c = ckb & 0xff, k = (ckb >> 8) - 1;
      // commit: take the victims [c, k]
      const bool take = lane >= c && lane <= k;
      const int v0 = u0 + rq0 - __reduce_add_sync(FULL, take ? r0 : 0);
      const int v1 = u1 + rq1 - __reduce_add_sync(FULL, take ? r1 : 0);
      const int v2 = u2 + rq2 - __reduce_add_sync(FULL, take ? r2 : 0);
      const int c2 = max(c, k + 1);
      if (lane == 0) {
        p.best[t] = b;
        p.ks[t] = max(k - c + 1, 0);
        su[3 * b] = v0;
        su[3 * b + 1] = v1;
        su[3 * b + 2] = v2;
        sj[b] = jb;
      }
      const int g0 = p.cap[3 * b] - v0, g1 = p.cap[3 * b + 1] - v1,
                g2 = p.cap[3 * b + 2] - v2;
      pc.mark_nb(PH_COMMIT, true);
      // the row's new key: first fit over the alive victims [c2, a)
      const bool alive = lane >= c2 && lane < a;
      int s0 = alive ? r0 : 0, s1 = alive ? r1 : 0, s2 = alive ? r2 : 0;
      for (int o = 1; o < a; o <<= 1) {
        const int y0 = __shfl_up_sync(FULL, s0, o);
        const int y1 = __shfl_up_sync(FULL, s1, o);
        const int y2 = __shfl_up_sync(FULL, s2, o);
        if (lane >= o) {
          s0 += y0;
          s1 += y1;
          s2 += y2;
        }
      }
      const bool fits = lane < a && g0 + s0 >= rq0 && g1 + s1 >= rq1 &&
                        g2 + s2 >= rq2;
      const int k2 = __ffs(__ballot_sync(FULL, fits)) - 1;
      // (the row is static-feasible: the root's cost is below BIG_COST)
      const bool ok = k2 >= 0 && (p.dh > 0 ? jb < p.dh : true);
      const float cost = ok ? cost_warp(alive ? vc : 0.0f, a, k2) : 0.0f;
      unsigned long long cur = row_key(ok, cost, b);
      if (lane == 0) {
        key[b] = cur;
        ck[b] = pack_ck(c2, k2);
      }
      pc.mark_nb(PH_KEY, true);
      // the path from the leaf to the root (unrolled: the level offsets
      // stay in the parameter space, not in local memory)
      int idx = b;
#pragma unroll
      for (int l = 0; l < MAX_LEVELS; ++l) {
        if (l < pl.levels) {
          if (lane == (idx & 31)) x = cur;
          cur = warp_min_key(x);
          idx >>= 5;
          unsigned long long* lv = tree + pl.lvl_off[l];
          if (lane == 0) lv[idx] = cur;
          if (l + 1 < pl.levels) {   // idx's siblings on this level
            const long long n = pl.lvl_off[l + 1] - pl.lvl_off[l];
            const int s = (idx & ~31) + lane;
            x = s < n ? lv[s] : NO_KEY;
          }
        }
      }
      root = cur;
      __syncwarp();
      pc.mark_nb(PH_TREE, true);
    }
    if (PROF)
      for (; t < p.n_place; ++t) pc.step(false);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = tid; i < 3 * m; i += BS) p.used[i] = su[i];
    for (int i = tid; i < m; i += BS) p.jc[i] = sj[i];
  }
  pc.finish(p.prof);
}

// One tree level's round, `rounds` times in a dependent chain: a read of
// 32 sibling keys from shared memory at an address the last round chose,
// the warp minimum, the parent's write (the step's unit of depth)
__global__ void level_probe_kernel(int rounds, unsigned long long* sink) {
  __shared__ unsigned long long lv[64];
  const int lane = threadIdx.x;
  lv[lane] = ((unsigned long long)(lane * 7 % 32) << 32) | lane;
  lv[lane + 32] = ((unsigned long long)(lane * 5 % 32) << 32) | lane;
  __syncwarp();
  unsigned long long cur = 0;
  int idx = 0;
  for (int r = 0; r < rounds; ++r) {
    unsigned long long x = lv[(idx & 32) + lane];
    if (lane == (idx & 31)) x = cur;
    cur = warp_min_key(x);
    idx = (int)(cur & 63) ^ (r & 33);
    if (lane == 0) lv[idx] = cur + 1;
    __syncwarp();
  }
  if (lane == 0) sink[0] = cur;
}

int smem_max() {
  static int optin = -1;
  if (optin < 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      optin = 0;
  }
  return optin;
}

template <bool SMEM, bool PROF>
int launch_kernel(const PreParams& p, const Plan& pl, cudaStream_t stream) {
  auto kern = preempt_kernel<SMEM, PROF>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, BS, (size_t)pl.smem, stream>>>(p, pl);
  return (int)cudaGetLastError();
}

template <bool PROF>
int launch_preempt(const int* cap, const int* used0, const uint8_t* stat,
                   const int* job_count0, const int* prio, const int* res,
                   const int* req, const int* k0, int m, int a, int dh,
                   int n_place, int n_real, int* best, int* ks, int* used,
                   int* job_count, unsigned char* scratch, long long* prof,
                   cudaStream_t stream) {
  Plan pl;
  if (a < 1 || a > MAX_A || m < 1 || n_place < 0 ||
      !make_plan(m, smem_max(), &pl) || (pl.scratch > 0 && !scratch))
    return (int)cudaErrorInvalidValue;
  PreParams p{};
  p.cap = cap; p.used0 = used0; p.stat = stat; p.jc0 = job_count0;
  p.prio = prio; p.res = res; p.req = req; p.k0 = k0;
  p.m = m; p.a = a; p.dh = dh; p.n_place = n_place;
  p.n_real = min(max(n_real, 0), n_place);
  p.best = best; p.ks = ks; p.used = used; p.jc = job_count;
  p.scratch = scratch; p.prof = prof;
  return pl.rows_in_smem ? launch_kernel<true, PROF>(p, pl, stream)
                         : launch_kernel<false, PROF>(p, pl, stream);
}

}  // namespace

// bytes of global scratch a launch over m rows needs (0: its rows fit in
// shared memory), or -1 when even its tree does not fit there
extern "C" int preempt_scratch_bytes(int m) {
  Plan pl;
  if (m < 1 || !make_plan(m, smem_max(), &pl)) return -1;
  return (int)pl.scratch;
}

// the most rows whose state fits in shared memory
extern "C" int preempt_smem_rows() {
  int lo = 1, hi = 1 << 20;
  Plan pl;
  while (lo < hi) {
    const int mid = lo + (hi - lo + 1) / 2;
    if (make_plan(mid, smem_max(), &pl) && pl.rows_in_smem)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// outputs: best, ks [n_place]; used [m, 3] and job_count [m], every row
// written (the inputs used0 and job_count0 are read only)
extern "C" int preempt_bulk(const int* cap, const int* used0,
                            const uint8_t* stat, const int* job_count0,
                            const int* prio, const int* res, const int* req,
                            const int* k0, int m, int a, int dh, int n_place,
                            int n_real, int* best, int* ks, int* used,
                            int* job_count, unsigned char* scratch,
                            cudaStream_t stream) {
  return launch_preempt<false>(cap, used0, stat, job_count0, prio, res, req,
                               k0, m, a, dh, n_place, n_real, best, ks, used,
                               job_count, scratch, nullptr, stream);
}

// The PROF instantiation: the same launch, with block 0's phase split
// written to prof [2 NPHASE + 4] (commit, key, tree)
extern "C" int preempt_bulk_prof(const int* cap, const int* used0,
                                 const uint8_t* stat, const int* job_count0,
                                 const int* prio, const int* res,
                                 const int* req, const int* k0, int m, int a,
                                 int dh, int n_place, int n_real, int* best,
                                 int* ks, int* used, int* job_count,
                                 unsigned char* scratch, long long* prof,
                                 cudaStream_t stream) {
  return launch_preempt<true>(cap, used0, stat, job_count0, prio, res, req,
                              k0, m, a, dh, n_place, n_real, best, ks, used,
                              job_count, scratch, prof, stream);
}

// Probe of the cost of one tree level's round (level_probe_kernel), to
// price K7's sequential depth; the placement path never calls it.
extern "C" int preempt_level_probe(int rounds, unsigned long long* sink,
                                   cudaStream_t stream) {
  level_probe_kernel<<<1, 32, 0, stream>>>(rounds, sink);
  return (int)cudaGetLastError();
}

PY_LAUNCHERS(preempt,
             PY_LAUNCHER(preempt_bulk),
             PY_LAUNCHER(preempt_bulk_prof),
             PY_LAUNCHER(preempt_scratch_bytes),
             PY_LAUNCHER(preempt_smem_rows),
             PY_LAUNCHER(preempt_level_probe))
