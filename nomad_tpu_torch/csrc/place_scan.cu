// K5 "place_scan": the exact placement scan of one eval, one placement
// per step, one persistent launch for the whole batch.
//
// Replaces (TPU side, jax.jit): nomad_tpu/ops/select.py:297 place_packed
// (place :197 with its lax.scan step, step_scores :151, pack_outputs
// :271; the static mask comes from K8 and the affinity from K1,
// csrc/landscape.cu).
//
// What bounds it on the H100: sequential depth.  Step p must see the
// usage, job counts, spread counts and distinct_property counts that
// steps < p committed, so a batch of P placements is P dependent block-
// wide passes over the N nodes (config 3: 4,096 padded steps over 5,000
// nodes).  The bytes and arithmetic are microseconds for the whole
// batch; each step's chain of pass, merge and commit is what costs.
//
// Design (what only the pick changes is cached, the rest is a table):
//
//  * Before the first step, a grid-wide pre-pass (scan_prep, all SMs)
//    builds per (group g, node j) the sum of the binpack and job anti-
//    affinity terms, `acc` (the reference's first two additions of the
//    mean, in its order), `base` = (acc + 0) + affinity (its next two
//    additions for a row that is not the step's reschedule row), and a
//    flag byte: the static mask bit, the capacity fit, distinct_hosts,
//    the three per-dimension overflow bits and jc > 0; per node the
//    tie-break noise; per group the request, limits and the list of
//    distinct_property rows that apply.  The scan block copies its rows
//    of these (and of the affinity and the spread and distinct_property
//    values) into shared memory as far as they fit (plan_smem); what
//    does not fit is read from global memory.  Each block then counts,
//    per group, its rows' filtered, exhausted and per-dimension counts,
//    which it keeps up to date at each commit instead of recounting.
//  * The spread boost per (spread row, value) is a table refreshed only
//    at the pick's value, and with one spread row so is the whole
//    spread term (fma, then the mean's division); the distinct_property
//    check reads the count table.  The per-node pass is then a few
//    shared-memory loads (typed as such when every piece fits), a table
//    lookup per spread row, an addition and the mean's division.
//  * Merge: each thread keeps its top 3 keys (orderable f32 bits of the
//    masked score + noise, then the inverted row, so that ties go to the
//    lower row as jax.lax.top_k orders them) with their scores; warps
//    merge with __reduce_max_sync on the high then the low word (three
//    rounds), warp 0 merges the warps' lists the same way, and the
//    feasible count is one __reduce_add_sync a warp.
//  * Commit, in parallel: as soon as warp 0 has the pick (the first
//    round of its last merge) it lets warps 1 and 2 start; warp 2 bumps
//    the spread and distinct_property counts (a lane per row), warp 1
//    moves the pick's usage and job count (kept in shared memory beside
//    the capacity when they fit, written through to the outputs) and
//    refreshes the pick's cache entries and group counts (a lane per
//    group), while warp 0 merges the other two winners and writes the
//    step's row.  No thread walks a serial chain of global loads.
//  * Memo: a step whose group and committed state (a version bumped at
//    each commit) equal the last computed step's has that step's metric
//    columns; if it is inactive, or that step had no feasible row, its
//    whole row is known and it costs one row write (see `memo_row`).
//  * Blocks: one block does the pass at up to 512 rows (K5_ROWS); past
//    that, one block's pass is bound by its SM's issue rate (about 100
//    instructions a row: 3.5 us a step at 5,000 rows on an H100), so
//    K5 runs on a cluster of up to 8 blocks of K5_ROWS or more rows
//    each, merged as K9 merges its shards (below).  The top 3 by (key,
//    block, rank in the block) is the top 3 by (key, row), blocks being
//    consecutive row ranges, so the picks are those of one block.
//
// K9 "place_scan_sharded": the same scan over a node axis split into S
// shards on one card.  Replaces (TPU side, jax.jit under shard_map):
// nomad_tpu/parallel/mesh.py:221 place_sharded_packed_fn (_place_local
// :89).  One cluster of S blocks; block s runs the step body above on the
// rows [s n_loc, (s+1) n_loc), with global rows for the noise, and keeps
// its own replicated spread and distinct_property counts.  Per step warp
// 0 of each block pushes its post (XW words: its top min(3, n_loc) key
// bits, their global rows, -1 where the key is infeasible, and scores
// as reported, key - noise(row) in f32 as the reference reports them;
// its six counts; its top row's spread value) into a slot of every
// peer's shared memory (distributed shared memory), then arrives on that
// peer's mbarrier; each block waits on its own mbarrier, slots and
// barriers double-buffered by exchange parity.  Warp 0 merges the S
// lists by the same redux rounds keyed by the shard-major concatenation
// index (the lower shard, then the lower local rank, among equal keys,
// as lax.top_k over the all_gather orders them); the owning block
// commits the pick's usage and job count, every block adds the pick's
// spread and distinct_property values to its counts, and block 0 writes
// the step's row.  K5 on a cluster posts its rows whatever their keys
// and its own scores (report_fin).

#include "py_launchers.cuh"  // first: it includes Python.h
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int BS = 1024;   // launch_clusters' block (score_common.cuh)
constexpr int TOP_K = 3;
constexpr int NSUM = 6;            // n_feas n_filt n_exh dim_ex(3)
constexpr int ROW = 14;            // pack_outputs columns
constexpr int STAGE = 512;         // steps staged in shared memory at once
constexpr int GS = 8;              // per-group statics (gstat) words
constexpr int GC = 5;              // per-group counts: filt exh dim(3)
// a block's post in a cluster: 3 key bits, 3 rows, 3 scores, 6 counts
// and its top row's spread value (one spread row)
constexpr int XW = 16;
constexpr int MAX_SHARDS = 8;
constexpr int PREP_THREADS = 256;
// flag bits of the per-(group, node) cache
constexpr unsigned F_STAT = 1, F_FIT = 2, F_DH = 4, F_O0 = 8, F_JC = 64;
constexpr unsigned F_FEAS = F_STAT | F_FIT | F_DH;

#include "score_common.cuh"

// Pieces that live in dynamic shared memory when they fit, in this
// order of preference (plan_smem); off < 0 means global memory.
enum Piece { PC_COUNTS, PC_GROUP, PC_FLAG, PC_BASE, PC_NOISE, PC_SPV,
             PC_PDV, PC_ACC, PC_AFF, PC_NODE, NPIECE };

struct ScanParams {
  const int* cap;            // [N, 3]
  int* used;                 // [N, 3] state and output (starts at used0)
  const uint8_t* stat;       // [G, N] K8 mask & extra_mask
  const float* aff_sc;       // [G, N] K1 affinity
  const uint8_t* aff_any;    // [G]
  const int* req;            // [G, 3]
  const int* desired;        // [G]
  const int* dh_limit;       // [G]
  const int* sp_nodeval;     // [S, N]
  const float* sp_weight;    // [S]
  const float* sp_expected;  // [S, K]
  const float* sp_counts0;   // [S, K]
  const int* pd_nodeval;     // [D, N]
  const int* pd_limit;       // [D]
  const uint8_t* pd_apply;   // [G, D]
  const int* pd_counts0;     // [D, Kd]
  const int* tg_idx;         // [P]
  const int* prev_row;       // [P]
  const uint8_t* active;     // [P]
  int* job_count;            // [N] state and output (starts at job_count0)
  int* buf;                  // [P, 14]
  int n, g, s, k, d, kd, n_steps, spread;
  unsigned seed;
  int n_shards, n_loc;       // blocks and rows per block (the last may
                             // hold fewer)
  int report_fin;            // K5: report each pick's own score
  long long* prof;           // PROF: [18] phase cycles of block 0
  // the wrapper's scratch (scan_layout), carved by the launcher
  float* c_acc;              // [G, N] binpack + anti-affinity terms
  float* c_base;             // [G, N] acc + 0 (no reschedule) + affinity
  float* c_noise;            // [N] tie-break noise
  int* gstat;                // [G, GS] r0 r1 r2 dh des_bits aff_any n_pd
  int* pdl;                  // [G, D] distinct rows that apply, in order
  int* gcnt;                 // [copies, G, GC] per block
  float* sp_glob;            // [copies, 3 S K + S + K] counts, boosts,
                             // expected, weights, one-spread terms
  int* pd_glob;              // [copies, D Kd + D] counts, limits
  uint8_t* c_flag;           // [G, N] flag bits
  int off[NPIECE];           // dynamic shared memory offsets (or -1)
  int all_sm;                // every piece the pass reads in shared memory
};

// Phase split of the PROF instantiation (PhaseClock, score_common.cuh):
// prof[18] holds cycles per phase of active steps [0, 7), of inactive
// steps [7, 14), the step counts [14, 16), the set-up before the first
// step [16] and the whole kernel [17].  Phases: the loop top, the pass
// over the rows, the warp and block merges, the exchange (post and wait,
// K9 and K5 on a cluster), the decode (the merge of the posts, the row,
// the memo; the commit of warps 1 and 2 starts during it, once the pick
// is known), the rest of the commit, and memoised steps.
constexpr int NPHASE = 7;

// The cache entry of one node for one group: the flag bits (without the
// static bit) and acc = (0 + binpack) + anti-affinity, each computed as
// the reference's step computes it (capacity_fit, binpack_score / 18,
// job_anti_affinity, the first two additions of normalize_scores).
__device__ __forceinline__ unsigned node_cache(
    int c0, int c1, int c2, int u0, int u1, int u2, int jc, int r0, int r1,
    int r2, int dh, float des, int spread, float* acc_out) {
  const bool o0 = u0 + r0 > c0, o1 = u1 + r1 > c1, o2 = u2 + r2 > c2;
  const bool fit = !(o0 || o1 || o2);
  const bool dh_ok = dh > 0 ? jc < dh : true;
  const float cf0 = (float)c0, cf1 = (float)c1;
  const float fr0 =
      1.0f - fminf(((float)u0 + (float)r0) / fmaxf(cf0, 1.0f), 1.0f);
  const float fr1 =
      1.0f - fminf(((float)u1 + (float)r1) / fmaxf(cf1, 1.0f), 1.0f);
  const float total = libm_pow10f(fr0) + libm_pow10f(fr1);
  float bs = spread ? total - 2.0f : 20.0f - total;
  bs = fminf(fmaxf(bs, 0.0f), 18.0f);
  const float bp = ((cf0 > 0.0f && cf1 > 0.0f) ? bs : 0.0f) * INV18;
  const float aa = -((float)jc / des);
  float acc = 0.0f;
  acc = acc + bp;
  acc = acc + (jc > 0 ? aa : 0.0f);
  *acc_out = acc;
  return (fit ? F_FIT : 0u) | (dh_ok ? F_DH : 0u) | (o0 ? F_O0 : 0u) |
         (o1 ? F_O0 << 1 : 0u) | (o2 ? F_O0 << 2 : 0u) |
         (jc > 0 ? F_JC : 0u);
}

// the group counts (filt exh dim0 dim1 dim2) one node's flags add
__device__ __forceinline__ void flag_counts(unsigned f, int* c) {
  const bool st = f & F_STAT, fit = f & F_FIT;
  c[0] = !st;
  c[1] = st && !(fit && (f & F_DH));
  for (int i = 0; i < 3; ++i) c[2 + i] = st && !fit && (f & (F_O0 << i));
}

// The pre-pass over all SMs: the [G, N] cache from the initial usage and
// job counts, the noise, and the per-group statics.
__global__ void __launch_bounds__(PREP_THREADS) scan_prep(ScanParams p) {
  const int n = p.n, D = p.d;
  const long long stride = (long long)gridDim.x * PREP_THREADS;
  const long long first = (long long)blockIdx.x * PREP_THREADS + threadIdx.x;
  for (long long i = first; i < (long long)p.g * n; i += stride) {
    const int g = (int)(i / n), j = (int)(i - (long long)g * n);
    float acc;
    const unsigned f = node_cache(
        p.cap[3 * j], p.cap[3 * j + 1], p.cap[3 * j + 2], p.used[3 * j],
        p.used[3 * j + 1], p.used[3 * j + 2], p.job_count[j],
        p.req[3 * g], p.req[3 * g + 1], p.req[3 * g + 2], p.dh_limit[g],
        fmaxf((float)p.desired[g], 1.0f), p.spread, &acc);
    p.c_acc[i] = acc;
    p.c_base[i] = (acc + 0.0f) + (p.aff_any[g] ? p.aff_sc[i] : 0.0f);
    p.c_flag[i] = (uint8_t)(f | (p.stat[i] ? F_STAT : 0u));
    if (g == 0) p.c_noise[j] = tiebreak_noise(p.seed, (unsigned)j);
  }
  for (long long g = first; g < p.g; g += stride) {
    int* gs = p.gstat + g * GS;
    gs[0] = p.req[3 * g];
    gs[1] = p.req[3 * g + 1];
    gs[2] = p.req[3 * g + 2];
    gs[3] = p.dh_limit[g];
    gs[4] = __float_as_int(fmaxf((float)p.desired[g], 1.0f));
    gs[5] = p.aff_any[g] != 0;
    int npd = 0;
    for (int q = 0; q < D; ++q)
      if (p.pd_apply[g * D + q] && p.pd_limit[q] > 0)
        p.pdl[g * D + npd++] = q;
    gs[6] = npd;
    gs[7] = 0;
  }
}

__device__ __forceinline__ void top3_insert(unsigned long long c, float f,
                                            unsigned long long* t,
                                            float* tf) {
  if (c > t[2]) {
    if (c > t[1]) {
      t[2] = t[1];
      tf[2] = tf[1];
      if (c > t[0]) {
        t[1] = t[0];
        tf[1] = tf[0];
        t[0] = c;
        tf[0] = f;
      } else {
        t[1] = c;
        tf[1] = f;
      }
    } else {
      t[2] = c;
      tf[2] = f;
    }
  }
}

// One round of the warp's merge of its lanes' sorted lists (t, tf; keys
// unique but for the empty 0), its result in every lane: the largest
// high word by one redux; only where several lanes hold it, the largest
// low word among them by another; the one winning lane pops its head.
__device__ __forceinline__ void warp_round(unsigned long long* t, float* tf,
                                           unsigned long long* out,
                                           float* outf) {
  const int lane = threadIdx.x & 31;
  const unsigned hi = (unsigned)(t[0] >> 32), lo = (unsigned)t[0];
  const unsigned mh = __reduce_max_sync(FULL, hi);
  unsigned tied = __ballot_sync(FULL, hi == mh);
  if (__popc(tied) > 1) {
    const unsigned ml = __reduce_max_sync(FULL, hi == mh ? lo : 0u);
    tied = __ballot_sync(FULL, hi == mh && lo == ml);
  }
  const int src = __ffs(tied) - 1;
  *out = ((unsigned long long)mh << 32) | __shfl_sync(FULL, lo, src);
  *outf = __shfl_sync(FULL, tf[0], src);
  if (lane == src) {
    t[0] = t[1];
    tf[0] = tf[1];
    t[1] = t[2];
    tf[1] = tf[2];
    t[2] = 0ull;
    tf[2] = 0.0f;
  }
}

// the warp's top 3 of its lanes' sorted lists, in every lane
__device__ __forceinline__ void warp_top3(unsigned long long* t, float* tf,
                                          unsigned long long* out,
                                          float* outf) {
#pragma unroll
  for (int q = 0; q < TOP_K; ++q) warp_round(t, tf, out + q, outf + q);
}

// the exchange slots of one block (score_common.cuh XchT)
using Xch = XchT<XW>;

// the row of a step whose outputs are known without a pass: nothing
// placed, metric columns from the memo (the reference's step computes
// its metrics on the pre-commit state, which an inactive step or one
// with no feasible row leaves as it was)
__device__ __forceinline__ int memo_row(int col, const int* sums) {
  return (col == 0 || (col >= 2 && col < 5)) ? -1
         : col < 8                           ? 0
                                             : sums[col - 8];
}

// One block's pieces (plan_smem): the counts and tables, and its rows'
// node vectors with the stride of a group's or a row's vector.
struct Pieces {
  float* spc;      // [S, K] spread counts
  float* boost;    // [S, K] clamped boost per value
  float* spe;      // [S, K] expected counts
  float* w01;      // [S] weight * 0.01
  float* t1;       // [K] one spread row's whole term per value
  int* pdc;        // [D, Kd] distinct_property counts
  int* lim;        // [D] their limits
  uint8_t* flag;   // [G, rows] flag bits
  float* base;     // [G, rows] acc + 0 + affinity
  const float* noise;
  const int* spv;  // [S, rows]
  const int* pdv;  // [D, rows]
  float* acc;      // [G, rows]
  const float* aff;
  int* nused;      // [rows, 3] usage and [rows] job counts of the rows
  int* njc;
  const int* ncap; // [rows, 3]
  int flag_ld, base_ld, spv_ld, pdv_ld, acc_ld, aff_ld;
};

__device__ __forceinline__ void count_pieces(Pieces& v, unsigned char* c,
                                             int S, int Kv, int D, int Kd) {
  v.spc = (float*)c;
  v.boost = v.spc + S * Kv;
  v.spe = v.boost + S * Kv;
  v.w01 = v.spe + S * Kv;
  v.t1 = v.w01 + S;
  v.pdc = (int*)(v.t1 + Kv);
  v.lim = v.pdc + D * Kd;
}

// every piece in shared memory: the pass's loads are then shared-memory
// loads with 32-bit addresses
__device__ __forceinline__ Pieces smem_pieces(const ScanParams& p,
                                              unsigned char* s_dyn) {
  Pieces v;
  count_pieces(v, s_dyn + p.off[PC_COUNTS], p.s, p.k, p.d, p.kd);
  v.flag = s_dyn + p.off[PC_FLAG];
  v.base = (float*)(s_dyn + p.off[PC_BASE]);
  v.noise = (const float*)(s_dyn + p.off[PC_NOISE]);
  v.spv = (const int*)(s_dyn + p.off[PC_SPV]);
  v.pdv = (const int*)(s_dyn + p.off[PC_PDV]);
  v.acc = (float*)(s_dyn + p.off[PC_ACC]);
  v.aff = (const float*)(s_dyn + p.off[PC_AFF]);
  v.nused = v.njc = nullptr;   // the commit's, not the pass's
  v.ncap = nullptr;
  v.flag_ld = v.base_ld = v.spv_ld = v.pdv_ld = v.acc_ld = v.aff_ld =
      p.n_loc;
  return v;
}

// each piece where plan_smem put it: shared memory or the global caches
// and inputs (generic loads)
__device__ __forceinline__ Pieces mixed_pieces(const ScanParams& p,
                                               unsigned char* s_dyn, int sh,
                                               int row0) {
  Pieces v;
  const int S = p.s, Kv = p.k, D = p.d, Kd = p.kd, n = p.n;
  count_pieces(v,
               p.off[PC_COUNTS] >= 0
                   ? s_dyn + p.off[PC_COUNTS]
                   : (unsigned char*)(p.sp_glob +
                                      (long long)sh * (3 * S * Kv + S + Kv)),
               S, Kv, D, Kd);
  if (p.off[PC_COUNTS] < 0) {
    v.pdc = p.pd_glob + (long long)sh * (D * Kd + D);
    v.lim = v.pdc + D * Kd;
  }
  auto sm = [&](int i) { return p.off[i] >= 0; };
  v.flag = sm(PC_FLAG) ? s_dyn + p.off[PC_FLAG] : p.c_flag + row0;
  v.flag_ld = sm(PC_FLAG) ? p.n_loc : n;
  v.base = sm(PC_BASE) ? (float*)(s_dyn + p.off[PC_BASE]) : p.c_base + row0;
  v.base_ld = sm(PC_BASE) ? p.n_loc : n;
  v.noise = sm(PC_NOISE) ? (const float*)(s_dyn + p.off[PC_NOISE])
                         : p.c_noise + row0;
  v.spv = sm(PC_SPV) ? (const int*)(s_dyn + p.off[PC_SPV])
                     : p.sp_nodeval + row0;
  v.spv_ld = sm(PC_SPV) ? p.n_loc : n;
  v.pdv = sm(PC_PDV) ? (const int*)(s_dyn + p.off[PC_PDV])
                     : p.pd_nodeval + row0;
  v.pdv_ld = sm(PC_PDV) ? p.n_loc : n;
  v.acc = sm(PC_ACC) ? (float*)(s_dyn + p.off[PC_ACC]) : p.c_acc + row0;
  v.acc_ld = sm(PC_ACC) ? p.n_loc : n;
  v.aff = sm(PC_AFF) ? (const float*)(s_dyn + p.off[PC_AFF])
                     : p.aff_sc + row0;
  v.aff_ld = sm(PC_AFF) ? p.n_loc : n;
  if (sm(PC_NODE)) {
    v.nused = (int*)(s_dyn + p.off[PC_NODE]);
    v.njc = v.nused + 3 * p.n_loc;
    v.ncap = v.njc + p.n_loc;
  } else {
    v.nused = p.used + 3 * row0;
    v.njc = p.job_count + row0;
    v.ncap = p.cap + 3 * row0;
  }
  return v;
}

// What a step's pass reads besides the pieces: its group's statics.
struct StepArgs {
  int g, prev_l;         // group, reschedule row local to the block or -1
  bool act, aff_any, sp_any;
  int npd;               // distinct rows that apply, at pdl_g
  const int* pdl_g;
  int S, Kv, Kd, n_loc;
  float n_active;
};

// One row of a step's pass: its feasibility and, on an active step, its
// score and key, in the reference's order of operations.  A row's mean
// is (base + spread) / count; the reschedule row recomputes base with
// its -1 term.  With one spread row the spread term is t1[value], the
// value's whole term.
__device__ __forceinline__ bool score_row(const Pieces& v, const StepArgs& a,
                                          const uint8_t* fl, const float* bs,
                                          int cnt0, int jl, float* fin,
                                          float* key) {
  const unsigned f = fl[jl];
  bool feas = (f & F_FEAS) == F_FEAS;
  for (int i = 0; feas && i < a.npd; ++i) {
    const int q = a.pdl_g[i];
    const int val = v.pdv[q * v.pdv_ld + jl];
    feas = val >= 0 &&
           v.pdc[q * a.Kd + min(max(val, 0), a.Kd - 1)] < v.lim[q];
  }
  if (!a.act) return feas;
  float sp = 0.0f;
  if (a.sp_any) {
    if (a.S == 1) {
      const int val = v.spv[jl];
      sp = val < 0 ? 0.0f : v.t1[min(val, a.Kv - 1)];
    } else {
      for (int s = 0; s < a.S; ++s) {
        const int val = v.spv[s * v.spv_ld + jl];
        const float b =
            val < 0 ? 0.0f : v.boost[s * a.Kv + min(val, a.Kv - 1)];
        sp = __fmaf_rn(b, v.w01[s], sp);
      }
      sp = sp / a.n_active;
    }
  }
  int cnt = cnt0 + ((f & F_JC) != 0);
  float x;
  if (jl != a.prev_l) {
    x = bs[jl];
  } else {
    x = v.acc[a.g * v.acc_ld + jl];
    x = x + -1.0f;
    x = x + (a.aff_any ? v.aff[a.g * v.aff_ld + jl] : 0.0f);
    cnt += 1;
  }
  x = x + sp;
  *fin = x / (float)cnt;
  *key = (feas ? *fin : NEG_INF) + v.noise[jl];
  return feas;
}

// The pass of one step over this block's rows: the feasible count and,
// on an active step, each thread's top 3 keys with their scores.  Two
// rows an iteration, scored before either is inserted, so that their
// chains of loads and arithmetic overlap.
template <int NT>
__device__ __forceinline__ int scan_pass(const Pieces& v, const StepArgs& a,
                                         unsigned long long* top,
                                         float* topf) {
  const uint8_t* fl = v.flag + a.g * v.flag_ld;
  const float* bs = v.base + a.g * v.base_ld;
  const int cnt0 = 1 + a.aff_any + a.sp_any;
  int nfeas = 0;
  for (int jl = threadIdx.x; jl < a.n_loc; jl += 2 * NT) {
    const int jl2 = jl + NT;
    const bool two = jl2 < a.n_loc;
    float f1, k1, f2 = 0.0f, k2 = 0.0f;
    nfeas += score_row(v, a, fl, bs, cnt0, jl, &f1, &k1);
    if (two) nfeas += score_row(v, a, fl, bs, cnt0, jl2, &f2, &k2);
    if (!a.act) continue;
    top3_insert(((unsigned long long)orderable(k1) << 32) | (unsigned)(~jl),
                f1, top, topf);
    if (two)
      top3_insert(
          ((unsigned long long)orderable(k2) << 32) | (unsigned)(~jl2), f2,
          top, topf);
  }
  return nfeas;
}

template <bool SHARDED, bool PROF, int NT>
__global__ void __launch_bounds__(NT, 1) scan_kernel(ScanParams p) {
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ int s_g[STAGE], s_prev[STAGE], s_act[STAGE];
  __shared__ unsigned long long s_wkey[NW * TOP_K];
  __shared__ float s_wfin[NW * TOP_K];
  __shared__ int s_wcnt[NW];
  // the pick, and the memo: group, state version and sums of the last
  // computed step
  __shared__ int s_pick, s_pick_v, s_memo_g, s_memo_ver, s_ver;
  __shared__ int s_memo_sums[NSUM];
  __shared__ __align__(16) int s_post[XW];
  __shared__ __align__(16) Xch s_xch;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PhaseClock<PROF, NPHASE> pc;
  pc.start(blockIdx.x == 0 && tid == 0);
  const int n = p.n, G = p.g, S = p.s, Kv = p.k, D = p.d, Kd = p.kd;
  const int NS = SHARDED ? p.n_shards : 1;
  const int sh = SHARDED ? (int)cg::this_cluster().block_rank() : 0;
  const int n_loc = p.n_loc;
  const int row0 = sh * n_loc;
  const int n_b = min(n_loc, n - row0);   // this block's rows
  if (SHARDED) xch_init(&s_xch, NS);

  const Pieces v = mixed_pieces(p, s_dyn, sh, row0);
  const bool grp_sm = p.off[PC_GROUP] >= 0;
  int* gstat = grp_sm ? (int*)(s_dyn + p.off[PC_GROUP]) : p.gstat;
  int* pdl = grp_sm ? gstat + G * GS : p.pdl;
  int* gcnt = grp_sm ? pdl + G * D : p.gcnt + (long long)sh * G * GC;

  // spread weights (`sp_weight / 100.0` is a multiply by f32(0.01) under
  // XLA); the mean divides by the count of non-padding spreads
  int n_sp = 0;
  for (int s = 0; s < S; ++s) n_sp += p.sp_weight[s] > 0.0f ? 1 : 0;
  const bool sp_any = n_sp > 0;
  const float n_active = (float)max(n_sp, 1);
  // counts, boosts and terms, distinct counts and limits: each block its
  // own; the cached rows and group statics
  for (int i = tid; i < S * Kv; i += NT) {
    const float c = p.sp_counts0[i], e = p.sp_expected[i];
    const float b = fminf(fmaxf((e - c) / fmaxf(e, 1.0f), -1.0f), 1.0f);
    v.spc[i] = c;
    v.boost[i] = b;
    v.spe[i] = e;
    if (S == 1) v.t1[i] = __fmaf_rn(b, p.sp_weight[0] * 0.01f, 0.0f) /
                          n_active;
  }
  for (int s = tid; s < S; s += NT) v.w01[s] = p.sp_weight[s] * 0.01f;
  for (int i = tid; i < D * Kd; i += NT) v.pdc[i] = p.pd_counts0[i];
  for (int q = tid; q < D; q += NT) v.lim[q] = p.pd_limit[q];
  if (grp_sm) {
    for (int i = tid; i < G * GS; i += NT) gstat[i] = p.gstat[i];
    for (int i = tid; i < G * D; i += NT) pdl[i] = p.pdl[i];
  }
  for (int i = tid; i < G * GC; i += NT) gcnt[i] = 0;
  auto sm = [&](int i) { return p.off[i] >= 0; };
  for (int i = tid; i < G * n_loc; i += NT) {
    const int g = i / n_loc, jl = i - g * n_loc;
    if (jl >= n_b) continue;
    const long long src = (long long)g * n + row0 + jl;
    if (sm(PC_FLAG)) v.flag[i] = p.c_flag[src];
    if (sm(PC_BASE)) v.base[i] = p.c_base[src];
    if (sm(PC_ACC)) v.acc[i] = p.c_acc[src];
    if (sm(PC_AFF)) ((float*)v.aff)[i] = p.aff_sc[src];
  }
  if (sm(PC_NOISE))
    for (int jl = tid; jl < n_b; jl += NT)
      ((float*)v.noise)[jl] = p.c_noise[row0 + jl];
  if (sm(PC_NODE)) {
    for (int i = tid; i < 3 * n_b; i += NT) {
      v.nused[i] = p.used[3 * row0 + i];
      ((int*)v.ncap)[i] = p.cap[3 * row0 + i];
    }
    for (int jl = tid; jl < n_b; jl += NT) v.njc[jl] = p.job_count[row0 + jl];
  }
  if (sm(PC_SPV))
    for (int i = tid; i < S * n_loc; i += NT) {
      const int s = i / n_loc, jl = i - s * n_loc;
      if (jl < n_b)
        ((int*)v.spv)[i] = p.sp_nodeval[(long long)s * n + row0 + jl];
    }
  if (sm(PC_PDV))
    for (int i = tid; i < D * n_loc; i += NT) {
      const int q = i / n_loc, jl = i - q * n_loc;
      if (jl < n_b)
        ((int*)v.pdv)[i] = p.pd_nodeval[(long long)q * n + row0 + jl];
    }
  const int top_k = min(TOP_K, n_b);   // local winners
  if (tid == 0) {
    s_memo_g = -1;
    s_memo_ver = -1;
    s_ver = 0;
  }
  __syncthreads();
  // this block's group counts, kept up to date at each commit
  for (int g = 0; g < G; ++g) {
    int c[GC] = {0, 0, 0, 0, 0};
    for (int jl = tid; jl < n_b; jl += NT) {
      int e[GC];
      flag_counts(v.flag[g * v.flag_ld + jl], e);
      for (int i = 0; i < GC; ++i) c[i] += e[i];
    }
    for (int i = 0; i < GC; ++i) {
      const int r = __reduce_add_sync(FULL, c[i]);
      if (lane == 0 && r) atomicAdd(&gcnt[g * GC + i], r);
    }
  }
  if (SHARDED) cg::this_cluster().sync();   // peers' barriers initialised
  pc.setup_done();

  int xk = 0;   // on a cluster: exchanges so far
  for (int t = 0; t < p.n_steps; ++t) {
    const int ts = t % STAGE;
    if (ts == 0) {
      __syncthreads();
      for (int i = tid; i < STAGE && t + i < p.n_steps; i += NT) {
        s_g[i] = p.tg_idx[t + i];
        s_prev[i] = p.prev_row[t + i];
        s_act[i] = p.active[t + i];
      }
      __syncthreads();
    }
    const int g = s_g[ts];
    const bool act = s_act[ts] != 0;
    const int ver = s_ver;
    if (g == s_memo_g && ver == s_memo_ver &&
        (!act || s_memo_sums[0] == 0)) {
      if (sh == 0 && warp == 0 && lane < ROW)
        p.buf[(long long)t * ROW + lane] = memo_row(lane, s_memo_sums);
      pc.mark(6, act);
      pc.step(act);
      continue;
    }
    const int* gs = gstat + g * GS;
    StepArgs sa;
    sa.g = g;
    sa.prev_l = s_prev[ts] >= row0 && s_prev[ts] < row0 + n_b
                    ? s_prev[ts] - row0
                    : -1;
    sa.act = act;
    sa.aff_any = gs[5] != 0;
    sa.sp_any = sp_any;
    sa.npd = gs[6];
    sa.pdl_g = pdl + g * D;
    sa.S = S;
    sa.Kv = Kv;
    sa.Kd = Kd;
    sa.n_loc = n_b;
    sa.n_active = n_active;
    pc.mark(0, act);

    // the pass, then each warp's top 3 and count
    unsigned long long top[TOP_K] = {0ull, 0ull, 0ull};
    float topf[TOP_K] = {0.0f, 0.0f, 0.0f};
    const int nfeas = p.all_sm
                          ? scan_pass<NT>(smem_pieces(p, s_dyn), sa, top, topf)
                          : scan_pass<NT>(v, sa, top, topf);
    pc.mark(1, act);
    {
      const int c = __reduce_add_sync(FULL, nfeas);
      unsigned long long wk[TOP_K] = {0ull, 0ull, 0ull};
      float wf[TOP_K] = {0.0f, 0.0f, 0.0f};
      if (act) warp_top3(top, topf, wk, wf);
      if (lane == 0) {
        s_wcnt[warp] = c;
#pragma unroll
        for (int q = 0; q < TOP_K; ++q) {
          s_wkey[warp * TOP_K + q] = wk[q];
          s_wfin[warp * TOP_K + q] = wf[q];
        }
      }
    }
    __syncthreads();

    // warp 0: the block's top 3 and counts
    unsigned long long best[TOP_K] = {0ull, 0ull, 0ull};
    float bestf[TOP_K] = {0.0f, 0.0f, 0.0f};
    int sums[NSUM] = {0, 0, 0, 0, 0, 0};
    if (warp == 0) {
      unsigned long long t3[TOP_K] = {0ull, 0ull, 0ull};
      float f3[TOP_K] = {0.0f, 0.0f, 0.0f};
      if (act && lane < NW) {
#pragma unroll
        for (int q = 0; q < TOP_K; ++q) {
          t3[q] = s_wkey[lane * TOP_K + q];
          f3[q] = s_wfin[lane * TOP_K + q];
        }
      }
      if (act) warp_top3(t3, f3, best, bestf);
      sums[0] = __reduce_add_sync(FULL, lane < NW ? s_wcnt[lane] : 0);
#pragma unroll
      for (int i = 0; i < GC; ++i) sums[1 + i] = gcnt[g * GC + i];
    }
    pc.mark(2, act);

    // warp 0 publishes the pick (and its spread value, with one spread
    // row) and lets warps 1 and 2 start the commit, on an active step
    auto publish_pick = [&](bool act_, float sc0, int row, int val) {
      if (lane == 0) {
        s_pick = act_ && sc0 > HALF_NEG_INF ? row : -1;
        s_pick_v = val;
      }
      if (act_) asm volatile("bar.arrive 1, 96;" ::: "memory");
    };
    if (warp == 0) {
      int k, rows[TOP_K];
      float sc[TOP_K];
      int my_sum = 0;
#pragma unroll
      for (int i = 0; i < NSUM; ++i)
        if (lane == i) my_sum = sums[i];
      if (SHARDED) {
        // post the block's winners (orderable key bits; global rows, for
        // K9 -1 where the key is infeasible; scores as reported), its
        // counts and its top row's spread value; meet; merge the lists
        int post = 0;
#pragma unroll
        for (int q = 0; q < TOP_K; ++q) {
          const unsigned bits = (unsigned)(best[q] >> 32);
          const int jl = (int)(~(unsigned)best[q]);
          const float key = from_orderable(bits);
          const bool real = q < top_k, feas = real && key > HALF_NEG_INF;
          if (lane == q) post = real ? (int)bits : 0;
          if (lane == TOP_K + q)
            post = real && (feas || p.report_fin) ? row0 + jl : -1;
          if (lane == 2 * TOP_K + q)
            post = __float_as_int(
                !feas ? NEG_INF
                : p.report_fin ? bestf[q]
                               : __fsub_rn(key, v.noise[jl]));
          if (lane == XW - 1 && q == 0 && real && S == 1)
            post = v.spv[jl];
        }
#pragma unroll
        for (int i = 0; i < NSUM; ++i)
          if (lane == 3 * TOP_K + i) post = sums[i];
        if (lane < XW) s_post[lane] = post;
        __syncwarp();
        xch_meet(&s_xch, xk, sh, NS, s_post);
        pc.mark_nb(3, act);
        const int (*slot)[XW] = s_xch.slot[xk & 1];
        unsigned long long t3[TOP_K] = {0ull, 0ull, 0ull};
        float f3[TOP_K] = {0.0f, 0.0f, 0.0f};
        if (lane < NS) {
#pragma unroll
          for (int q = 0; q < TOP_K; ++q)
            t3[q] = ((unsigned long long)(unsigned)slot[lane][q] << 32) |
                    (unsigned)(~(lane * TOP_K + q));
        }
        // the pick first: the commit (warps 1 and 2) starts while this
        // warp merges the other two and writes the row
        unsigned long long gb[TOP_K];
        float gf[TOP_K];
        k = min(TOP_K, n);
#pragma unroll
        for (int q = 0; q < TOP_K; ++q) {
          warp_round(t3, f3, gb + q, gf + q);
          const int ci = (int)(~(unsigned)gb[q]);
          const int* from = slot[q < k ? ci / TOP_K : 0];
          rows[q] = q < k ? from[TOP_K + ci % TOP_K] : -1;
          sc[q] = q < k ? __int_as_float(from[2 * TOP_K + ci % TOP_K])
                        : NEG_INF;
          if (q == 0) publish_pick(act, sc[0], rows[0], from[XW - 1]);
        }
        my_sum = 0;   // lane i < NSUM: the blocks' count i
        if (lane < NSUM)
          for (int r = 0; r < NS; ++r) my_sum += slot[r][3 * TOP_K + lane];
        __syncwarp();   // the slots are read before the next post
        ++xk;
      } else {
        k = top_k;
#pragma unroll
        for (int q = 0; q < TOP_K; ++q) {
          rows[q] = (int)(~(unsigned)best[q]);
          const float key = from_orderable((unsigned)(best[q] >> 32));
          sc[q] = q < k && key > HALF_NEG_INF ? bestf[q] : NEG_INF;
        }
        publish_pick(act, sc[0], rows[0],
                     S == 1 && rows[0] >= 0 ? v.spv[rows[0]] : 0);
      }
      const bool ok = act && sc[0] > HALF_NEG_INF;
      const int pick = ok ? rows[0] : -1;
      int w = __shfl_sync(FULL, my_sum, (lane - 2 - 2 * TOP_K) & 31);
#pragma unroll
      for (int q = 0; q < TOP_K; ++q) {
        const bool on = q < k && ok;
        if (lane == 2 + q) w = on ? rows[q] : -1;
        if (lane == 2 + TOP_K + q) w = __float_as_int(on ? sc[q] : 0.0f);
      }
      if (lane == 0) w = pick;
      if (lane == 1) w = __float_as_int(ok ? sc[0] : 0.0f);
      if (sh == 0 && lane < ROW) p.buf[(long long)t * ROW + lane] = w;
      if (lane < NSUM) s_memo_sums[lane] = my_sum;
      if (lane == 0) {
        s_memo_g = g;
        s_memo_ver = ver;
        if (ok) s_ver = ver + 1;
      }
    }
    pc.mark(4, act);

    // the commit: warp 2 the counts, warp 1 the pick's node
    if (act && (warp == 1 || warp == 2)) {
      asm volatile("bar.sync 1, 96;" ::: "memory");
      const int pick = s_pick;
      if (pick >= 0 && warp == 2) {
        for (int s = lane; s < S; s += 32) {
          const int val =
              S == 1 ? s_pick_v : p.sp_nodeval[(long long)s * n + pick];
          if (val >= 0) {
            const int i = s * Kv + min(val, Kv - 1);
            const float c = v.spc[i] + 1.0f, e = v.spe[i];
            const float b =
                fminf(fmaxf((e - c) / fmaxf(e, 1.0f), -1.0f), 1.0f);
            v.spc[i] = c;
            v.boost[i] = b;
            if (S == 1) v.t1[i] = __fmaf_rn(b, v.w01[0], 0.0f) / n_active;
          }
        }
        const int npd = gs[6];
        const int* pdl_g = pdl + g * D;
        for (int i = lane; i < npd; i += 32) {
          const int q = pdl_g[i];
          const int val = p.pd_nodeval[(long long)q * n + pick];
          if (val >= 0) v.pdc[q * Kd + min(val, Kd - 1)] += 1;
        }
      }
      if (pick >= row0 && pick < row0 + n_b && warp == 1) {
        const int jl = pick - row0;
        const int c0 = v.ncap[3 * jl], c1 = v.ncap[3 * jl + 1],
                  c2 = v.ncap[3 * jl + 2];
        const int u0 = v.nused[3 * jl] + gs[0],
                  u1 = v.nused[3 * jl + 1] + gs[1],
                  u2 = v.nused[3 * jl + 2] + gs[2];
        const int jc = v.njc[jl] + 1;
        __syncwarp();
        if (lane == 0) {   // the shared copy, if any, and the output
          v.nused[3 * jl] = u0;
          v.nused[3 * jl + 1] = u1;
          v.nused[3 * jl + 2] = u2;
          v.njc[jl] = jc;
          p.used[3 * pick] = u0;
          p.used[3 * pick + 1] = u1;
          p.used[3 * pick + 2] = u2;
          p.job_count[pick] = jc;
        }
        for (int h = lane; h < G; h += 32) {
          const int* hs = gstat + h * GS;
          uint8_t* fp = v.flag + h * v.flag_ld + jl;
          const unsigned old = *fp;
          float a;
          const unsigned f =
              node_cache(c0, c1, c2, u0, u1, u2, jc, hs[0], hs[1], hs[2],
                         hs[3], __int_as_float(hs[4]), p.spread, &a) |
              (old & F_STAT);
          *fp = (uint8_t)f;
          v.acc[h * v.acc_ld + jl] = a;
          v.base[h * v.base_ld + jl] =
              (a + 0.0f) + (hs[5] ? v.aff[h * v.aff_ld + jl] : 0.0f);
          int was[GC], now[GC];
          flag_counts(old, was);
          flag_counts(f, now);
#pragma unroll
          for (int i = 1; i < GC; ++i) gcnt[h * GC + i] += now[i] - was[i];
        }
      }
    }
    __syncthreads();
    pc.mark(5, act);
    pc.step(act);
  }
  pc.finish(p.prof);
  // no block leaves while a peer may still write to its shared memory
  if (SHARDED) cg::this_cluster().sync();
}

// The word offsets of the wrapper's int32 scratch.
struct Layout {
  long long acc, base, noise, gstat, pdl, gcnt, sp, pd, flag, total;
};

Layout scan_layout(long long n, long long g, long long s, long long k,
                   long long d, long long kd, long long copies) {
  Layout L;
  long long o = 0;
  L.acc = o;   o += g * n;
  L.base = o;  o += g * n;
  L.noise = o; o += n;
  L.gstat = o; o += g * GS;
  L.pdl = o;   o += g * d;
  L.gcnt = o;  o += copies * g * GC;
  L.sp = o;    o += copies * (3 * s * k + s + k);
  L.pd = o;    o += copies * (d * kd + d);
  L.flag = o;  o += (g * n + 3) / 4;
  L.total = o;
  return L;
}

// Lay the pieces out in dynamic shared memory, in order, each where it
// still fits in `budget` bytes; returns the bytes used.
int plan_smem(ScanParams& p, long long budget) {
  const long long G = p.g, S = p.s, D = p.d, nl = p.n_loc;
  const long long bytes[NPIECE] = {
      4 * (3 * S * p.k + S + p.k + D * p.kd + D),   // PC_COUNTS
      4 * G * (GS + D + GC),                        // PC_GROUP
      G * nl,                                       // PC_FLAG
      4 * G * nl,                                   // PC_BASE
      4 * nl,                                       // PC_NOISE
      4 * S * nl,                                   // PC_SPV
      4 * D * nl,                                   // PC_PDV
      4 * G * nl,                                   // PC_ACC
      4 * G * nl,                                   // PC_AFF
      28 * nl};                                     // PC_NODE
  long long used = 0;
  p.all_sm = 1;
  for (int i = 0; i < NPIECE; ++i) {
    const long long b = (bytes[i] + 15) / 16 * 16;
    if (used + b <= budget) {
      p.off[i] = (int)used;
      used += b;
    } else {
      p.off[i] = -1;
      if (i != PC_NODE) p.all_sm = 0;
    }
  }
  return (int)used;
}

template <bool SHARDED, bool PROF, int NT>
int launch_scan(ScanParams p, int n_shards, cudaStream_t stream) {
  auto kern = scan_kernel<SHARDED, PROF, NT>;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, optin = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int dyn =
      plan_smem(p, (long long)optin - (long long)fa.sharedSizeBytes);
  if (SHARDED)
    return launch_clusters_nt(kern, n_shards, n_shards, NT, (size_t)dyn,
                              stream, p);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dyn);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, NT, dyn, stream>>>(p);
  return (int)cudaGetLastError();
}

// K5's blocks for n rows: one block up to K5_ROWS rows, else a cluster
// of up to 8 blocks of at least K5_ROWS rows each (one block's pass is
// bound by one SM's issue rate), the last block holding the remainder
constexpr int K5_ROWS = 512;
int k5_blocks(int n) {
  int c = (n + K5_ROWS - 1) / K5_ROWS;
  c = c < MAX_SHARDS ? c : MAX_SHARDS;
  const int per = (n + c - 1) / c;
  return (n + per - 1) / per;
}

// the block size: 1024 threads for a large block, 256 (fewer warps to
// merge and to meet at each barrier) at most 1024 rows; `nt` forces one
template <bool PROF>
int run_scan(ScanParams p, int* scratch, int n_shards, int nt,
             cudaStream_t stream) {
  const int s = p.s, k = p.k, d = p.d, kd = p.kd;
  if (p.n < 1 || p.g < 1 || s < 1 || k < 1 || d < 1 || kd < 1 ||
      n_shards < 0 || n_shards > MAX_SHARDS ||
      (n_shards && p.n % n_shards != 0) || (nt && nt != 256 && nt != 1024))
    return (int)cudaErrorInvalidValue;
  // K9 splits the padded rows evenly; K5 reports each pick's own score
  p.n_shards = n_shards ? n_shards : k5_blocks(p.n);
  p.n_loc = (p.n + p.n_shards - 1) / p.n_shards;
  p.report_fin = n_shards == 0;
  const Layout L = scan_layout(p.n, p.g, s, k, d, kd, p.n_shards);
  p.c_acc = (float*)(scratch + L.acc);
  p.c_base = (float*)(scratch + L.base);
  p.c_noise = (float*)(scratch + L.noise);
  p.gstat = scratch + L.gstat;
  p.pdl = scratch + L.pdl;
  p.gcnt = scratch + L.gcnt;
  p.sp_glob = (float*)(scratch + L.sp);
  p.pd_glob = scratch + L.pd;
  p.c_flag = (uint8_t*)(scratch + L.flag);
  const long long blocks = ((long long)p.g * p.n + PREP_THREADS - 1) /
                           PREP_THREADS;
  scan_prep<<<(int)(blocks < 4 * 132 ? blocks : 4 * 132), PREP_THREADS, 0,
              stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!nt) nt = p.n_loc > 1024 ? 1024 : 256;
  if (p.n_shards > 1 || n_shards)
    return nt == 1024
               ? launch_scan<true, PROF, 1024>(p, p.n_shards, stream)
               : launch_scan<true, PROF, 256>(p, p.n_shards, stream);
  return nt == 1024 ? launch_scan<false, PROF, 1024>(p, 0, stream)
                    : launch_scan<false, PROF, 256>(p, 0, stream);
}

ScanParams scan_params(
    const int* cap, int* used, const uint8_t* stat, const float* aff_sc,
    const uint8_t* aff_any, const int* req, const int* desired,
    const int* dh_limit, const int* sp_nodeval, const float* sp_weight,
    const float* sp_expected, const float* sp_counts0, const int* pd_nodeval,
    const int* pd_limit, const uint8_t* pd_apply, const int* pd_counts0,
    const int* tg_idx, const int* prev_row, const uint8_t* active,
    int* job_count, int* buf, int n, int g, int s, int k, int d, int kd,
    int n_steps, int spread, unsigned seed) {
  ScanParams p{};
  p.cap = cap; p.used = used; p.stat = stat; p.aff_sc = aff_sc;
  p.aff_any = aff_any; p.req = req; p.desired = desired;
  p.dh_limit = dh_limit; p.sp_nodeval = sp_nodeval; p.sp_weight = sp_weight;
  p.sp_expected = sp_expected; p.sp_counts0 = sp_counts0;
  p.pd_nodeval = pd_nodeval; p.pd_limit = pd_limit; p.pd_apply = pd_apply;
  p.pd_counts0 = pd_counts0; p.tg_idx = tg_idx; p.prev_row = prev_row;
  p.active = active; p.job_count = job_count; p.buf = buf;
  p.n = n; p.g = g; p.s = s; p.k = k; p.d = d; p.kd = kd;
  p.n_steps = n_steps; p.spread = spread; p.seed = seed;
  return p;
}

// The probe of K9's exchange: `rounds` meetings of `cluster` blocks
// (xch_meet, one warp a block), each post depending on the last.
__global__ void __launch_bounds__(32, 1) dsmem_exchange_kernel(int rounds,
                                                               int* sink) {
  __shared__ __align__(16) Xch s_xch;
  __shared__ __align__(16) int s_post[XW];
  const int NS = (int)cg::this_cluster().num_blocks();
  const int sh = (int)cg::this_cluster().block_rank();
  const int lane = threadIdx.x;
  xch_init(&s_xch, NS);
  cg::this_cluster().sync();
  int v = lane;
  for (int r = 0; r < rounds; ++r) {
    if (lane < XW) s_post[lane] = v + r;
    __syncwarp();
    xch_meet(&s_xch, r, sh, NS, s_post);
    v += s_xch.slot[r & 1][lane % NS][lane % XW] & 1;
    __syncwarp();
  }
  cg::this_cluster().sync();
  if (v == 0x7fffffff) *sink = v;
}

}  // namespace

#define SCAN_ARGS                                                           \
  const int *cap, int *used, const uint8_t *stat, const float *aff_sc,     \
      const uint8_t *aff_any, const int *req, const int *desired,          \
      const int *dh_limit, const int *sp_nodeval, const float *sp_weight,  \
      const float *sp_expected, const float *sp_counts0,                   \
      const int *pd_nodeval, const int *pd_limit, const uint8_t *pd_apply, \
      const int *pd_counts0, const int *tg_idx, const int *prev_row,       \
      const uint8_t *active, int *job_count, int *buf, int *scratch,       \
      int n, int g, int s, int k, int d, int kd, int n_steps, int spread,  \
      unsigned seed
#define SCAN_PARAMS                                                         \
  scan_params(cap, used, stat, aff_sc, aff_any, req, desired, dh_limit,    \
              sp_nodeval, sp_weight, sp_expected, sp_counts0, pd_nodeval,  \
              pd_limit, pd_apply, pd_counts0, tg_idx, prev_row, active,    \
              job_count, buf, n, g, s, k, d, kd, n_steps, spread, seed)

// The int32 words of the scratch the launchers below take (scan_layout)
// for K9's `n_shards` blocks, or K5's (n_shards 0); a host function.
extern "C" int place_scan_scratch_words(int n, int g, int s, int k, int d,
                                        int kd, int n_shards) {
  if (n < 1) return -1;
  const long long w =
      scan_layout(n, g, s, k, d, kd, n_shards ? n_shards : k5_blocks(n))
          .total;
  return w > 0x7fffffff ? -1 : (int)w;
}

// The blocks of K5's launch at n rows (k5_blocks); a host function.
extern "C" int place_scan_blocks(int n) { return n < 1 ? 0 : k5_blocks(n); }

extern "C" int place_scan(SCAN_ARGS, cudaStream_t stream) {
  return run_scan<false>(SCAN_PARAMS, scratch, 0, 0, stream);
}

// K9: n = npad rows in n_shards shards (one cluster of n_shards blocks)
extern "C" int place_scan_sharded(SCAN_ARGS, int n_shards,
                                  cudaStream_t stream) {
  if (n_shards < 1) return (int)cudaErrorInvalidValue;
  return run_scan<false>(SCAN_PARAMS, scratch, n_shards, 0, stream);
}

// The PROF instantiations: the same scans, with block 0's phase split
// written to prof [18] (PhaseClock) and the block size forced by `nt`
// (256 or 1024; 0 chooses as the main path does).  Never on the main
// path.
extern "C" int place_scan_prof(SCAN_ARGS, int nt, long long* prof,
                               cudaStream_t stream) {
  ScanParams p = SCAN_PARAMS;
  p.prof = prof;
  return run_scan<true>(p, scratch, 0, nt, stream);
}

extern "C" int place_scan_sharded_prof(SCAN_ARGS, int n_shards, int nt,
                                       long long* prof,
                                       cudaStream_t stream) {
  if (n_shards < 1) return (int)cudaErrorInvalidValue;
  ScanParams p = SCAN_PARAMS;
  p.prof = prof;
  return run_scan<true>(p, scratch, n_shards, nt, stream);
}

extern "C" int dsmem_exchange_probe(int rounds, int cluster, int* sink,
                                    cudaStream_t stream) {
  if (cluster < 1 || cluster > MAX_SHARDS) return (int)cudaErrorInvalidValue;
  return launch_clusters_nt(dsmem_exchange_kernel, cluster, cluster, 32, 0,
                            stream, rounds, sink);
}

PY_LAUNCHERS(place_scan,
             PY_LAUNCHER(place_scan_scratch_words),
             PY_LAUNCHER(place_scan_blocks),
             PY_LAUNCHER(place_scan),
             PY_LAUNCHER(place_scan_sharded),
             PY_LAUNCHER(place_scan_prof),
             PY_LAUNCHER(place_scan_sharded_prof),
             PY_LAUNCHER(dsmem_exchange_probe))
