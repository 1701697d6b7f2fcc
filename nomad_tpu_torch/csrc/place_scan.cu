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
// nodes).  The bytes a step reads (a few words per node) and its
// arithmetic (two f64 powf emulations and a handful of divisions per
// node) are microseconds for the whole batch; the chain of steps, each
// ending in block reductions and a one-thread commit, is what costs.
//
// Design: one block of 1024 threads.  Per step each thread scores its
// strided nodes exactly as the reference orders the arithmetic (capacity
// fit, distinct_hosts, distinct_property, then the mean of binpack, job
// anti-affinity, reschedule penalty, affinity and spread), counts the
// step's metrics on the pre-commit usage, and keeps its own top 3 of the
// 64-bit keys (orderable f32 bits of score + tie-break noise, then the
// inverted row, so ties go to the lower row as jax.lax.top_k orders
// them).  Warps merge their top 3 by three shuffle maxima, warp 0 merges
// the 32 warps', and thread 0 decodes the picks, commits the placement
// (usage, job count, spread and distinct_property counts, the last two
// in shared memory) and writes the step's 14-word row of pack_outputs.
// The spread sum is one fma per spread, as XLA fuses it.
//
// K9 "place_scan_sharded": the same scan over a node axis split into S
// shards on one card.  Replaces (TPU side, jax.jit under shard_map):
// nomad_tpu/parallel/mesh.py:221 place_sharded_packed_fn (_place_local
// :89).  One cluster of S blocks; block s runs the step body above on the
// rows [s n_loc, (s+1) n_loc), with global rows for the noise, and keeps
// its own replicated spread and distinct_property counts.  Per step each
// block posts its top min(3, n_loc) keys (the row as -1 where the key is
// infeasible) and its six counts to an exchange row in global scratch,
// double-buffered by step parity; after the cluster barrier every block
// takes the top 3 of the shard-major concatenation (the lower shard, then
// the lower local rank, among equal keys, as lax.top_k over the
// all_gather orders them), reports each score as key - noise(row) in f32
// as the reference does, the owning block commits the pick's usage and
// job count, every block adds the pick's spread and distinct_property
// values to its counts, and block 0 writes the step's row.  What bounds
// it: the chain of steps, now with one cluster barrier each.

#include "py_launchers.cuh"  // first: it includes Python.h
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int BS = 1024;
constexpr int NWARP = BS / 32;
constexpr int TOP_K = 3;
constexpr int NSUM = 6;            // n_feas n_filt n_exh dim_ex(3)
constexpr int ROW = 14;            // pack_outputs columns
// counts kept in shared memory up to this many bytes, else in the
// wrapper's global copies
constexpr int SMEM_COUNTS_MAX = 160 * 1024;

#include "score_common.cuh"

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
  float* sp_glob;            // [S, K] global counts (copy of sp_counts0)
  int* pd_glob;              // [D, Kd] global counts (copy of pd_counts0)
  float* score;              // [N] scratch: this step's final scores
  int n, g, s, k, d, kd, n_steps, spread;
  unsigned seed;
  int n_shards, n_loc;       // K9: shards and rows per shard
  int* xch;                  // K9: [2, n_shards, 16] exchange rows
};

__device__ __forceinline__ void top3_insert(unsigned long long c,
                                            unsigned long long* t) {
  if (c > t[2]) {
    if (c > t[1]) {
      t[2] = t[1];
      if (c > t[0]) {
        t[1] = t[0];
        t[0] = c;
      } else {
        t[1] = c;
      }
    } else {
      t[2] = c;
    }
  }
}

// the warp's top 3 of its lanes' sorted triples (keys are unique; 0 is
// the empty slot), returned in every lane
__device__ __forceinline__ void warp_top3(unsigned long long* t,
                                          unsigned long long* out) {
  for (int q = 0; q < TOP_K; ++q) {
    unsigned long long m = t[0];
    for (int o = 16; o > 0; o >>= 1) {
      unsigned long long y = __shfl_xor_sync(FULL, m, o);
      m = y > m ? y : m;
    }
    out[q] = m;
    if (t[0] == m) {
      t[0] = t[1];
      t[1] = t[2];
      t[2] = 0ull;
    }
  }
}

// One step's pick from its merged top rows `rows`/`sc` (k of them):
// writes the step's row of pack_outputs when `t` >= 0, commits the pick's
// usage and job count when its row lies in [row0, row0 + n_own), and adds
// its spread and distinct_property values to the counts.  One thread.
__device__ void commit_step(const ScanParams& p, int t, bool act, int g,
                            const int* rows, const float* sc, int k,
                            const int* sums, float* spc, int* pdc, int row0,
                            int n_own) {
  const int n = p.n, S = p.s, Kv = p.k, D = p.d, Kd = p.kd;
  const bool ok = act && sc[0] > HALF_NEG_INF;
  const int pick = ok ? rows[0] : -1;
  if (t >= 0) {
    int* out = p.buf + (int64_t)t * ROW;
    out[0] = pick;
    out[1] = __float_as_int(ok ? sc[0] : 0.0f);
    for (int q = 0; q < TOP_K; ++q) {
      out[2 + q] = (q < k && ok) ? rows[q] : -1;
      out[5 + q] = __float_as_int((q < k && ok) ? sc[q] : 0.0f);
    }
    for (int i = 0; i < NSUM; ++i) out[8 + i] = sums[i];
  }
  if (!ok) return;
  if (pick >= row0 && pick < row0 + n_own) {
    p.used[3 * pick] += p.req[3 * g];
    p.used[3 * pick + 1] += p.req[3 * g + 1];
    p.used[3 * pick + 2] += p.req[3 * g + 2];
    p.job_count[pick] += 1;
  }
  for (int s = 0; s < S; ++s) {
    const int v = p.sp_nodeval[(int64_t)s * n + pick];
    if (v >= 0) spc[s * Kv + min(v, Kv - 1)] += 1.0f;
  }
  const uint8_t* pd_app = p.pd_apply + (int64_t)g * D;
  for (int q = 0; q < D; ++q) {
    const int v = p.pd_nodeval[(int64_t)q * n + pick];
    if (v >= 0 && pd_app[q]) pdc[q * Kd + min(v, Kd - 1)] += 1;
  }
}

template <bool SHARDED>
__global__ void __launch_bounds__(BS, 1) scan_kernel(ScanParams p,
                                                      int counts_in_smem) {
  extern __shared__ int s_dyn[];
  __shared__ unsigned long long s_top[NWARP * TOP_K];
  __shared__ int s_red[NWARP * NSUM];
  __shared__ unsigned long long s_best[TOP_K];
  __shared__ int s_sum[NSUM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n, S = p.s, Kv = p.k, D = p.d, Kd = p.kd;
  const int NS = SHARDED ? p.n_shards : 1;
  const int sh = SHARDED ? (int)cg::this_cluster().block_rank() : 0;
  const int n_loc = SHARDED ? p.n_loc : n;
  const int row0 = sh * n_loc;
  // each block's own copy of the replicated counts
  float* spc = counts_in_smem ? (float*)s_dyn : p.sp_glob + sh * S * Kv;
  int* pdc = counts_in_smem ? s_dyn + S * Kv : p.pd_glob + sh * D * Kd;
  if (counts_in_smem) {
    for (int i = tid; i < S * Kv; i += BS) spc[i] = p.sp_counts0[i];
    for (int i = tid; i < D * Kd; i += BS) pdc[i] = p.pd_counts0[i];
  }
  // spread weights: `sp_weight / 100.0` is a multiply by f32(0.01) under
  // XLA; the mean divides by the count of non-padding spreads
  int n_sp = 0;
  for (int s = 0; s < S; ++s) n_sp += p.sp_weight[s] > 0.0f ? 1 : 0;
  const bool sp_any = n_sp > 0;
  const float n_active = (float)max(n_sp, 1);
  const int top_k = min(TOP_K, n_loc);   // local winners
  __syncthreads();

  for (int t = 0; t < p.n_steps; ++t) {
    const int g = p.tg_idx[t];
    const int prev = p.prev_row[t];
    const bool act = p.active[t] != 0;
    const int r0 = p.req[3 * g], r1 = p.req[3 * g + 1], r2 = p.req[3 * g + 2];
    const int dh = p.dh_limit[g];
    const float des = fmaxf((float)p.desired[g], 1.0f);
    const bool aff_any = p.aff_any[g] != 0;
    const uint8_t* stat = p.stat + (int64_t)g * n;
    const float* aff = p.aff_sc + (int64_t)g * n;
    const uint8_t* pd_app = p.pd_apply + (int64_t)g * D;

    unsigned long long top[TOP_K] = {0ull, 0ull, 0ull};
    int sums[NSUM] = {0, 0, 0, 0, 0, 0};
    for (int jl = tid; jl < n_loc; jl += BS) {
      const int j = row0 + jl;
      const bool st = stat[j] != 0;
      const int c0 = p.cap[3 * j], c1 = p.cap[3 * j + 1], c2 = p.cap[3 * j + 2];
      const int u0 = p.used[3 * j], u1 = p.used[3 * j + 1],
                u2 = p.used[3 * j + 2];
      const int jc = p.job_count[j];
      const bool o0 = u0 + r0 > c0, o1 = u1 + r1 > c1, o2 = u2 + r2 > c2;
      const bool fit = !(o0 || o1 || o2);
      const bool dh_ok = dh > 0 ? jc < dh : true;
      bool pd_ok = true;
      for (int q = 0; q < D; ++q) {
        if (pd_app[q] && p.pd_limit[q] > 0) {
          const int v = p.pd_nodeval[(int64_t)q * n + j];
          const int cnt = pdc[q * Kd + min(max(v, 0), Kd - 1)];
          pd_ok = pd_ok && cnt < p.pd_limit[q] && v >= 0;
        }
      }
      const bool feas = st && fit && dh_ok && pd_ok;

      // rank chain, in the reference's order of operations
      const float cf0 = (float)c0, cf1 = (float)c1;
      const float fr0 =
          1.0f - fminf(((float)u0 + (float)r0) / fmaxf(cf0, 1.0f), 1.0f);
      const float fr1 =
          1.0f - fminf(((float)u1 + (float)r1) / fmaxf(cf1, 1.0f), 1.0f);
      const float total = libm_pow10f(fr0) + libm_pow10f(fr1);
      float bs = p.spread ? total - 2.0f : 20.0f - total;
      bs = fminf(fmaxf(bs, 0.0f), 18.0f);
      const float bp = ((cf0 > 0.0f && cf1 > 0.0f) ? bs : 0.0f) * INV18;
      const float aa = -((float)jc / des);
      const bool is_prev = j == prev;
      float spv = 0.0f;
      for (int s = 0; s < S; ++s) {
        const int v = p.sp_nodeval[(int64_t)s * n + j];
        const int vc = min(max(v, 0), Kv - 1);
        const float e = p.sp_expected[s * Kv + vc];
        float b = (e - spc[s * Kv + vc]) / fmaxf(e, 1.0f);
        b = fminf(fmaxf(b, -1.0f), 1.0f);
        if (v < 0) b = 0.0f;
        spv = __fmaf_rn(b, p.sp_weight[s] * 0.01f, spv);
      }
      spv = spv / n_active;
      float acc = 0.0f;
      acc = acc + bp;
      acc = acc + (jc > 0 ? aa : 0.0f);
      acc = acc + (is_prev ? -1.0f : 0.0f);
      acc = acc + (aff_any ? aff[j] : 0.0f);
      acc = acc + (sp_any ? spv : 0.0f);
      const int cnt = 1 + (jc > 0) + is_prev + aff_any + sp_any;
      const float fin = acc / (float)cnt;
      p.score[j] = fin;

      const float key =
          (feas ? fin : NEG_INF) + tiebreak_noise(p.seed, (unsigned)j);
      top3_insert(((unsigned long long)orderable(key) << 32) |
                      (unsigned)(~jl),
                  top);
      sums[0] += feas;
      sums[1] += !st;
      sums[2] += st && !(fit && dh_ok);
      const bool nf = st && !fit;
      sums[3] += nf && o0;
      sums[4] += nf && o1;
      sums[5] += nf && o2;
    }

    // block reductions: the six counts and the top 3
    for (int i = 0; i < NSUM; ++i)
      for (int o = 16; o > 0; o >>= 1)
        sums[i] += __shfl_down_sync(FULL, sums[i], o);
    unsigned long long wtop[TOP_K];
    warp_top3(top, wtop);
    if (lane == 0) {
      for (int i = 0; i < NSUM; ++i) s_red[warp * NSUM + i] = sums[i];
      for (int q = 0; q < TOP_K; ++q) s_top[warp * TOP_K + q] = wtop[q];
    }
    __syncthreads();
    if (warp == 0) {
      for (int i = 0; i < NSUM; ++i) {
        int v = s_red[lane * NSUM + i];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
        if (lane == 0) s_sum[i] = v;
      }
      unsigned long long tt[TOP_K] = {s_top[lane * TOP_K],
                                      s_top[lane * TOP_K + 1],
                                      s_top[lane * TOP_K + 2]};
      warp_top3(tt, wtop);
      if (lane == 0)
        for (int q = 0; q < TOP_K; ++q) s_best[q] = wtop[q];
    }
    __syncthreads();

    // decode, commit, write the step's row
    if (!SHARDED && tid == 0) {
      int rows[TOP_K];
      float sc[TOP_K];
      for (int q = 0; q < top_k; ++q) {
        const unsigned long long c = s_best[q];
        rows[q] = (int)(~(unsigned)(c & 0xffffffffull));
        const float key = from_orderable((unsigned)(c >> 32));
        sc[q] = key > HALF_NEG_INF ? p.score[rows[q]] : NEG_INF;
      }
      commit_step(p, t, act, g, rows, sc, top_k, s_sum, spc, pdc, 0, n);
    }
    if (SHARDED) {
      // post the shard's winners (orderable key bits, global row or -1)
      // and counts, meet, then merge the S lists in every block
      int* xrow = p.xch + (int64_t)(t & 1) * NS * 16;
      if (tid == 0) {
        for (int q = 0; q < top_k; ++q) {
          const unsigned long long c = s_best[q];
          const unsigned bits = (unsigned)(c >> 32);
          const int jl = (int)(~(unsigned)(c & 0xffffffffull));
          __stcg(xrow + sh * 16 + q, (int)bits);
          __stcg(xrow + sh * 16 + 3 + q,
                 from_orderable(bits) > HALF_NEG_INF ? row0 + jl : -1);
        }
        for (int i = 0; i < NSUM; ++i)
          __stcg(xrow + sh * 16 + 6 + i, s_sum[i]);
      }
      __threadfence();
      cg::this_cluster().sync();
      if (tid == 0) {
        unsigned long long best[TOP_K] = {0ull, 0ull, 0ull};
        int sums[NSUM] = {0, 0, 0, 0, 0, 0};
        for (int r = 0; r < NS; ++r) {
          for (int q = 0; q < top_k; ++q) {
            const unsigned ci = (unsigned)(r * top_k + q);
            top3_insert(((unsigned long long)(unsigned)__ldcg(
                             xrow + r * 16 + q) << 32) | (unsigned)(~ci),
                        best);
          }
          for (int i = 0; i < NSUM; ++i)
            sums[i] += __ldcg(xrow + r * 16 + 6 + i);
        }
        const int k_glob = min(TOP_K, NS * top_k);
        int rows[TOP_K];
        float sc[TOP_K];
        for (int q = 0; q < k_glob; ++q) {
          const int ci = (int)(~(unsigned)(best[q] & 0xffffffffull));
          const float nsc = from_orderable((unsigned)(best[q] >> 32));
          rows[q] = __ldcg(xrow + (ci / top_k) * 16 + 3 + ci % top_k);
          sc[q] = nsc > HALF_NEG_INF
                      ? __fsub_rn(nsc, tiebreak_noise(
                                           p.seed, (unsigned)max(rows[q], 0)))
                      : NEG_INF;
        }
        for (int i = 0; i < NSUM; ++i) s_sum[i] = sums[i];
        commit_step(p, sh == 0 ? t : -1, act, g, rows, sc, k_glob, s_sum,
                    spc, pdc, row0, n_loc);
      }
    }
    __syncthreads();
  }
}

int run_scan(ScanParams p, int n_shards, cudaStream_t stream) {
  const int s = p.s, k = p.k, d = p.d, kd = p.kd;
  if (p.n < 1 || s < 1 || k < 1 || d < 1 || kd < 1 || n_shards < 0 ||
      n_shards > 8 || (n_shards && p.n % n_shards != 0))
    return (int)cudaErrorInvalidValue;
  const long long bytes = 4ll * ((long long)s * k + (long long)d * kd);
  const int in_smem = bytes <= SMEM_COUNTS_MAX ? 1 : 0;
  const int dyn = in_smem ? (int)bytes : 0;
  if (n_shards) {
    p.n_shards = n_shards;
    p.n_loc = p.n / n_shards;
    return launch_clusters(scan_kernel<true>, n_shards, n_shards,
                           (size_t)dyn, stream, p, in_smem);
  }
  if (dyn > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dyn);
    if (e != cudaSuccess) return (int)e;
  }
  scan_kernel<false><<<1, BS, dyn, stream>>>(p, in_smem);
  return (int)cudaGetLastError();
}

ScanParams scan_params(
    const int* cap, int* used, const uint8_t* stat, const float* aff_sc,
    const uint8_t* aff_any, const int* req, const int* desired,
    const int* dh_limit, const int* sp_nodeval, const float* sp_weight,
    const float* sp_expected, const float* sp_counts0, const int* pd_nodeval,
    const int* pd_limit, const uint8_t* pd_apply, const int* pd_counts0,
    const int* tg_idx, const int* prev_row, const uint8_t* active,
    int* job_count, int* buf, float* sp_glob, int* pd_glob, float* score,
    int n, int g, int s, int k, int d, int kd, int n_steps, int spread,
    unsigned seed) {
  ScanParams p{};
  p.cap = cap; p.used = used; p.stat = stat; p.aff_sc = aff_sc;
  p.aff_any = aff_any; p.req = req; p.desired = desired;
  p.dh_limit = dh_limit; p.sp_nodeval = sp_nodeval; p.sp_weight = sp_weight;
  p.sp_expected = sp_expected; p.sp_counts0 = sp_counts0;
  p.pd_nodeval = pd_nodeval; p.pd_limit = pd_limit; p.pd_apply = pd_apply;
  p.pd_counts0 = pd_counts0; p.tg_idx = tg_idx; p.prev_row = prev_row;
  p.active = active; p.job_count = job_count; p.buf = buf;
  p.sp_glob = sp_glob; p.pd_glob = pd_glob; p.score = score;
  p.n = n; p.g = g; p.s = s; p.k = k; p.d = d; p.kd = kd;
  p.n_steps = n_steps; p.spread = spread; p.seed = seed;
  return p;
}

}  // namespace

#define SCAN_ARGS                                                           \
  const int *cap, int *used, const uint8_t *stat, const float *aff_sc,     \
      const uint8_t *aff_any, const int *req, const int *desired,          \
      const int *dh_limit, const int *sp_nodeval, const float *sp_weight,  \
      const float *sp_expected, const float *sp_counts0,                   \
      const int *pd_nodeval, const int *pd_limit, const uint8_t *pd_apply, \
      const int *pd_counts0, const int *tg_idx, const int *prev_row,       \
      const uint8_t *active, int *job_count, int *buf, float *sp_glob,     \
      int *pd_glob, float *score, int n, int g, int s, int k, int d,       \
      int kd, int n_steps, int spread, unsigned seed
#define SCAN_PARAMS                                                         \
  scan_params(cap, used, stat, aff_sc, aff_any, req, desired, dh_limit,    \
              sp_nodeval, sp_weight, sp_expected, sp_counts0, pd_nodeval,  \
              pd_limit, pd_apply, pd_counts0, tg_idx, prev_row, active,    \
              job_count, buf, sp_glob, pd_glob, score, n, g, s, k, d, kd,  \
              n_steps, spread, seed)

extern "C" int place_scan(SCAN_ARGS, cudaStream_t stream) {
  return run_scan(SCAN_PARAMS, 0, stream);
}

// K9: n = npad rows in n_shards shards; sp_glob [n_shards, S, K] and
// pd_glob [n_shards, D, Kd] hold each block's counts (copies of the
// initial ones) when they exceed shared memory; xch [2, n_shards, 16]
extern "C" int place_scan_sharded(SCAN_ARGS, int n_shards, int* xch,
                                  cudaStream_t stream) {
  if (n_shards < 1) return (int)cudaErrorInvalidValue;
  ScanParams p = SCAN_PARAMS;
  p.xch = xch;
  return run_scan(p, n_shards, stream);
}

PY_LAUNCHERS(place_scan,
             PY_LAUNCHER(place_scan),
             PY_LAUNCHER(place_scan_sharded))
