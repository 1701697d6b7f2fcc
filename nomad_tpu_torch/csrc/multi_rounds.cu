// K6 "multi_bulk": one eval's homogeneous batch in water-fill rounds,
// one persistent launch.  K10 "multi_bulk_sharded": the bulk rounds over
// a node axis split into S shards on one card (see "Sharded rounds"
// below).  K2, K3, K11 and K12, the multi-eval rounds over lanes, every
// row (on one card or in shards) or shard frames, have their own design
// (compact_rounds.cu).
//
// Replaces (TPU side, jax.jit): nomad_tpu/ops/select.py:554
// place_bulk_packed (_bulk_scan :517, _bulk_step :460, _bulk_static
// :505; place_bulk :615) for K6, with the round core round_scores_g
// (:342), waterfill_round (:413), round_metrics_g (:393), tiebreak_noise
// (:43) and pack_round_buffer (:531).
//
// What bounds it on the H100: sequential depth, not bytes or operations.
// A launch is R dependent rounds (each round must see the previous
// round's commits); the bytes it must move are a few MB and its
// arithmetic under a billion operations (microseconds either way); what
// costs is that each round is a chain of block-wide passes (score pass,
// 8 radix-select passes, a sort of the selected rows, a scan, the
// commit, the metrics pass), each waiting on the one before, and that
// each pass walks the whole node axis with one block.
//
// Design: one thread block of 1024 threads for the whole launch, over
// every node row, the static row from the caller's [1, N] mask (one
// group, every round of it), with the bulk kernel's three output layouts
// (full, with a score block, compact prefix plus full fills).  The round
// state (usage, job counts, intake, scores, selection keys) lives in
// global memory that stays L2-resident; selection state lives in shared
// memory.  Per round the block
//   1. scores every row (intake k_i, binpack/anti-affinity/affinity rank
//      chain, normalised exactly as the reference orders it),
//   2. caps intake for the spread algorithm and builds 64-bit selection
//      keys (score + tie-break noise, then the row index, so the order is
//      score descending and index ascending among ties, as
//      jax.lax.top_k orders them),
//   3. finds the top min(round_size, N) keys by an 8-pass MSB radix
//      select with warp-aggregated shared-memory histograms, gathers them
//      and bitonic-sorts them in shared memory,
//   4. water-fills them with a block scan (cumsum) to `want` placements,
//   5. commits usage and job counts, then counts post-commit exhaustion,
//   6. writes its row of the packed output (fills row*2048+count and the
//      16-word meta block, layout byte-identical to pack_round_buffer).
// Floor division of negative free capacity is done explicitly (C `/`
// truncates).  10^x is not the device powf, which differs from the C
// library's powf in the last bit for some exponents: `libm_pow10f`
// follows the C library's algorithm step for step in double precision,
// so scores (and hence picks) agree to the bit with the reference, whose
// XLA CPU pow is the C library's powf.
//
// Sharded rounds (K10).  Replaces (TPU side, jax.jit under shard_map):
// nomad_tpu/parallel/mesh.py:645 place_bulk_sharded_packed_fn
// (_bulk_local :346), with its round _sharded_waterfill (:255).
// Shard s owns the rows [s n_loc, (s+1) n_loc).  One cluster of S
// blocks, each running the round body above on its shard, with global
// rows for the noise.  Per round the blocks meet three times at the
// cluster barrier, through exchange rows in global scratch that the
// wrapper allocates (written and read past L1, `__stcg`/`__ldcg`):
//   1. the viable-row count, summed (the spread algorithm's intake cap);
//   2. each shard's sorted local top min(round, n_loc) keys with their
//      score, intake, row and slot, and the feasible and static counts;
//      every block then gathers the S lists and selects the global top
//      min(round, S kk_loc) of their shard-major concatenation with the
//      same radix select (keys carry the concatenation index, so ties go
//      to the lower shard, then the lower local rank, as lax.top_k over
//      the all_gather orders them), water-fills it with the same
//      arithmetic, and commits the winners whose origin shard it is;
//   3. the post-commit exhaustion metrics, summed.
// Block 0 writes the round's packed row.  A phase's exchange row is
// rewritten a round later only after the next barrier, when every block
// has read it.  What bounds it: the chain of dependent block passes, now
// with three cluster barriers a round.

#include "py_launchers.cuh"  // first: it includes Python.h
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int BS = 1024;            // threads per block (one lane)
constexpr int MAX_RS = 1024;        // select.py asserts round_size <= 1024
constexpr int TOP_K = 3;
constexpr int META = 16;

#include "score_common.cuh"

// one group: its static row, affinity row and rows, request and limits,
// seed and job counts, in every round
struct Params {
  const int* cap;            // [N, 3]
  int* used;                 // [N, 3] state and output
  int n;
  const uint8_t* static_u;   // [N]
  const float* aff_land;     // [N]
  const int* aff;            // [Af, 4]
  int n_aff;
  const int* req;            // [3]
  const int* desired;        // [1]
  const int* dh_limit;       // [1]
  const long long* seed;     // [1], a uint32 value
  const int* job_count0;     // [N]
  const int* round_want;     // [R]
  int n_steps, nc, spread, rs, fill_k;
  int out_mode;              // K6 layout: 0 full, 1 + scores, 2 compact
  int* jc;                   // [N] current job counts (output)
  int* ki;                   // [N] intake
  float* score;              // [N]
  unsigned* keyb;            // [N] orderable key bits
  int* buf;                  // [R, rs + 16 | 2 rs + 16 | fill_k + 16]
  int* fills;                // K6 compact: [R, rs]
  int n_shards;              // sharded: cluster size S; nc = n_loc
  int* xcnt;                 // sharded: [4, S, 8] count rows
  unsigned long long* xkey;  // sharded: [S * kk_loc] keys
  int* xval;                 // sharded: [S * kk_loc, 4]
};

// round_scores_g for one row: intake k_i and the normalised rank score
__device__ __forceinline__ void intake_score(
    const int* c, const int* u, const int* r, int rs, int dh, int jcount,
    bool st, int desired, float af, bool aff_any, bool spread, int* k_out,
    float* sc_out) {
  int k = rounds_kcap(c, u, r, rs);
  if (dh > 0) k = min(k, min(max(dh - jcount, 0), rs));
  if (!st) k = 0;
  *k_out = k;

  float bp = rounds_binpack(c, u, r, spread);
  float aa = -((float)jcount / fmaxf((float)desired, 1.0f));
  float acc = 0.0f;
  acc = acc + bp;
  acc = acc + (jcount > 0 ? aa : 0.0f);
  acc = acc + (aff_any ? af : 0.0f);
  int cnt = 1 + (jcount > 0 ? 1 : 0) + (aff_any ? 1 : 0);
  *sc_out = acc / (float)cnt;
}

// block-wide sum; `red` holds >= 33 ints
__device__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(FULL, t, o);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// block-wide inclusive prefix sum in thread order
__device__ int block_scan(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? red[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    red[lane] = w;
  }
  __syncthreads();
  return x + (warp > 0 ? red[warp - 1] : 0);
}

// The top `kk` (1 <= kk <= m, kk <= MAX_RS) of the m unique 64-bit keys
// comp(j), sorted descending into s_sel[0, kk): an 8-pass MSB radix
// select for the kk-th largest key with warp-aggregated shared-memory
// histograms, a gather of the keys at or above it, and a bitonic sort
// (s_sel[kk, sortp) zeroed).  Called by every thread of the block.
template <class Comp>
__device__ void select_top(Comp comp, int m, int kk,
                           unsigned long long* s_sel, int* s_hist,
                           int* s_misc) {
  const int tid = threadIdx.x;
  const int lane_id = tid & 31, warp = tid >> 5;
  const int n_iter = (m + BS - 1) / BS;   // uniform trip count
  int sortp = 1;
  while (sortp < kk) sortp <<= 1;

  unsigned long long prefix = 0;
  int k_rem = kk;
  for (int pass = 0; pass < 8; ++pass) {
    const int shift = 56 - 8 * pass;
    const unsigned long long hi_mask =
        pass == 0 ? 0ull : (~0ull << (shift + 8));
    for (int i = tid; i < 256; i += BS) s_hist[i] = 0;
    __syncthreads();
    for (int it = 0; it < n_iter; ++it) {
      int j = it * BS + tid;
      int d = -1;
      if (j < m) {
        unsigned long long c = comp(j);
        if ((c & hi_mask) == prefix) d = (int)((c >> shift) & 255);
      }
      unsigned peers = __match_any_sync(FULL, d);
      if (d >= 0 && lane_id == __ffs(peers) - 1)
        atomicAdd(&s_hist[d], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      int cnt[8];
      int sum = 0;
      for (int q = 0; q < 8; ++q) {
        cnt[q] = s_hist[255 - (lane_id * 8 + q)];
        sum += cnt[q];
      }
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(FULL, incl, o);
        if (lane_id >= o) incl += y;
      }
      int acc = incl - sum;
      if (acc < k_rem && k_rem <= incl) {
        for (int q = 0; q < 8; ++q) {
          if (acc + cnt[q] >= k_rem) {
            s_misc[0] = 255 - (lane_id * 8 + q);
            s_misc[1] = acc;
            break;
          }
          acc += cnt[q];
        }
      }
    }
    __syncthreads();
    prefix |= (unsigned long long)s_misc[0] << shift;
    k_rem -= s_misc[1];
    __syncthreads();
  }

  // gather the kk keys >= the threshold (keys are unique), sort
  if (tid == 0) s_misc[2] = 0;
  __syncthreads();
  for (int it = 0; it < n_iter; ++it) {
    int j = it * BS + tid;
    unsigned long long c = 0;
    bool take = false;
    if (j < m) {
      c = comp(j);
      take = c >= prefix;
    }
    unsigned b = __ballot_sync(FULL, take);
    int pos = 0;
    if (lane_id == 0 && b) pos = atomicAdd(&s_misc[2], __popc(b));
    pos = __shfl_sync(FULL, pos, 0);
    if (take) s_sel[pos + __popc(b & ((1u << lane_id) - 1u))] = c;
  }
  for (int i = kk + tid; i < sortp; i += BS) s_sel[i] = 0;
  __syncthreads();
  for (int k2 = 2; k2 <= sortp; k2 <<= 1) {
    for (int jj = k2 >> 1; jj > 0; jj >>= 1) {
      if (tid < sortp) {
        int ixj = tid ^ jj;
        if (ixj > tid) {
          unsigned long long x = s_sel[tid], y = s_sel[ixj];
          bool desc = (tid & k2) == 0;
          if (desc ? (x < y) : (x > y)) {
            s_sel[tid] = y;
            s_sel[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// Sums `nv` (<= 8) per-block values (already block-reduced, the same in
// every thread) over the cluster's S blocks in shard order: each block
// posts its values into its slot of `row` ([S, 8] ints), the cluster
// barrier orders every post before every read.  Called by every thread
// of every block of the cluster.
__device__ void cluster_sum(int* row, int s, int S, int* v, int nv) {
  if (threadIdx.x == 0)
    for (int q = 0; q < nv; ++q) __stcg(row + s * 8 + q, v[q]);
  __threadfence();
  cg::this_cluster().sync();
  for (int q = 0; q < nv; ++q) {
    int t = 0;
    for (int r = 0; r < S; ++r) t += __ldcg(row + r * 8 + q);
    v[q] = t;
  }
}

template <bool SHARDED>
__global__ void __launch_bounds__(BS, 1) rounds_kernel(Params p) {
  extern __shared__ unsigned long long s_all[];   // sharded: S * kk_loc
  __shared__ unsigned long long s_sel[MAX_RS];
  __shared__ int s_row[MAX_RS];
  __shared__ int s_c[MAX_RS];
  __shared__ float s_sc[MAX_RS];
  __shared__ int s_hist[256];
  __shared__ int s_red[33];
  __shared__ int s_misc[4];

  const int tid = threadIdx.x;
  const int S = SHARDED ? p.n_shards : 1;
  const int s = SHARDED ? (int)cg::this_cluster().block_rank() : 0;
  const int nc = p.nc;
  // this block's first row (K10: shard s's)
  const int64_t fb = (int64_t)s * nc;
  int* used_state = p.used + fb * 3;
  int* jc = p.jc + fb;
  int* ki = p.ki + fb;
  float* score = p.score + fb;
  unsigned* keyb = p.keyb + fb;
  const int n_iter = (nc + BS - 1) / BS;   // uniform trip count
  const int kk_loc = min(p.rs, nc);
  // length of the merged (sorted) candidate list a round fills from
  const int kk = SHARDED ? min(p.rs, S * kk_loc) : kk_loc;
  int* xcnt = p.xcnt;
  unsigned long long* xkey = p.xkey;
  int* xval = p.xval;

  const int req[3] = {p.req[0], p.req[1], p.req[2]};
  const int desired = p.desired[0];
  const int dh = p.dh_limit[0];
  const unsigned sd = (unsigned)(p.seed[0] & 0xffffffffll);
  bool aff_any = false;
  for (int q = 0; q < p.n_aff; ++q) aff_any |= p.aff[q * 4 + 3] != 0;
  const float* aff_row = p.aff_land + fb;
  const uint8_t* stat_row = p.static_u + fb;
  const int* jc0 = p.job_count0 + fb;

  for (int t = 0; t < p.n_steps; ++t) {
    const int want = p.round_want[t];

    // 1. job counts (from the seed row, then carried), intake, rank score
    int viable = 0, n_static = 0;
    for (int it = 0; it < n_iter; ++it) {
      int j = it * BS + tid;
      if (j < nc) {
        int jcount = t > 0 ? jc[j] : jc0[j];
        jc[j] = jcount;
        bool st = stat_row[j] != 0;
        const int64_t row = fb + j;
        int c[3] = {p.cap[row * 3], p.cap[row * 3 + 1], p.cap[row * 3 + 2]};
        const int* u = used_state + (int64_t)j * 3;
        int uu[3] = {u[0], u[1], u[2]};
        int k;
        float sc;
        intake_score(c, uu, req, p.rs, dh, jcount, st, desired, aff_row[j],
                     aff_any, p.spread != 0, &k, &sc);
        ki[j] = k;
        score[j] = sc;
        viable += k > 0 ? 1 : 0;
        n_static += st ? 1 : 0;
      }
    }
    viable = block_sum(viable, s_red);
    n_static = block_sum(n_static, s_red);
    if (SHARDED) cluster_sum(xcnt + 1 * S * 8, s, S, &viable, 1);
    const int cap_round =
        p.spread ? max(want / max(viable, 1) + 1, 1) : p.rs;

    // 2. per-round intake cap and selection keys
    int n_feas = 0;
    for (int it = 0; it < n_iter; ++it) {
      int j = it * BS + tid;
      if (j < nc) {
        int kr = min(ki[j], cap_round);
        ki[j] = kr;
        const unsigned grow = (unsigned)(fb + j);
        float key = (kr > 0 ? score[j] : NEG_INF) + tiebreak_noise(sd, grow);
        keyb[j] = orderable(key);
        n_feas += kr > 0 ? 1 : 0;
      }
    }
    n_feas = block_sum(n_feas, s_red);

    // 3. the sorted top kk_loc of the frame (key bits high, inverted
    // index low: key descending, then index ascending, as
    // jax.lax.top_k orders them)
    select_top([&](int j) {
      return ((unsigned long long)keyb[j] << 32) | (unsigned)(~j);
    }, nc, kk_loc, s_sel, s_hist, s_misc);
    int ks = 0, grow = 0, own = -1;
    float scs = NEG_INF;
    if (!SHARDED) {
      if (tid < kk) {
        unsigned long long comp = s_sel[tid];
        own = (int)(~(unsigned)(comp & 0xffffffffull));
        float key = from_orderable((unsigned)(comp >> 32));
        scs = key > HALF_NEG_INF ? score[own] : NEG_INF;
        ks = scs > HALF_NEG_INF ? ki[own] : 0;
        grow = own;
      }
    } else {
      // post the shard's list: keys re-indexed by their place in the
      // shard-major concatenation, with score, intake, row and slot
      if (tid < kk_loc) {
        unsigned long long comp = s_sel[tid];
        int jl = (int)(~(unsigned)(comp & 0xffffffffull));
        float key = from_orderable((unsigned)(comp >> 32));
        int ci = s * kk_loc + tid;
        __stcg(xkey + ci, (comp & 0xffffffff00000000ull) | (unsigned)(~ci));
        __stcg(xval + ci * 4, __float_as_int(key > HALF_NEG_INF ? score[jl]
                                                                : NEG_INF));
        __stcg(xval + ci * 4 + 1, ki[jl]);
        __stcg(xval + ci * 4 + 2, (int)(fb + jl));
        __stcg(xval + ci * 4 + 3, jl);
      }
      int sums[2] = {n_feas, n_static};
      cluster_sum(xcnt + 2 * S * 8, s, S, sums, 2);
      n_feas = sums[0];
      n_static = sums[1];
      const int m = S * kk_loc;
      for (int i = tid; i < m; i += BS) s_all[i] = __ldcg(xkey + i);
      __syncthreads();
      select_top([&](int j) { return s_all[j]; }, m, kk, s_sel, s_hist,
                 s_misc);
      if (tid < kk) {
        unsigned long long comp = s_sel[tid];
        int ci = (int)(~(unsigned)(comp & 0xffffffffull));
        float key = from_orderable((unsigned)(comp >> 32));
        const int* v = xval + ci * 4;
        scs = key > HALF_NEG_INF ? __int_as_float(__ldcg(v)) : NEG_INF;
        ks = scs > HALF_NEG_INF ? __ldcg(v + 1) : 0;
        grow = __ldcg(v + 2);
        own = ci / kk_loc == s ? __ldcg(v + 3) : -1;
      }
    }

    // 4. water-fill the sorted prefix up to `want`
    const int csum = block_scan(ks, s_red);
    const int c = min(max(want - (csum - ks), 0), ks);
    s_row[tid] = grow;
    s_c[tid] = c;
    s_sc[tid] = scs;
    const int placed = block_sum(c, s_red);

    // 5. commit the winners of this frame, then post-commit exhaustion
    if (tid < kk && c > 0 && own >= 0) {
      int* us = used_state + (int64_t)own * 3;
      us[0] += c * req[0];
      us[1] += c * req[1];
      us[2] += c * req[2];
      jc[own] += c;
    }
    __syncthreads();
    int n_exh = 0, dx0 = 0, dx1 = 0, dx2 = 0;
    for (int it = 0; it < n_iter; ++it) {
      int j = it * BS + tid;
      if (j < nc && stat_row[j] != 0) {
        const int64_t row = fb + j;
        const int* u = used_state + (int64_t)j * 3;
        int f0 = p.cap[row * 3] - u[0];
        int f1 = p.cap[row * 3 + 1] - u[1];
        int f2 = p.cap[row * 3 + 2] - u[2];
        bool fit = f0 >= req[0] && f1 >= req[1] && f2 >= req[2] &&
                   f0 >= 0 && f1 >= 0 && f2 >= 0;
        bool dh_ok = dh > 0 ? jc[j] < dh : true;
        if (!(fit && dh_ok)) {
          n_exh += 1;
          dx0 += f0 < req[0] ? 1 : 0;
          dx1 += f1 < req[1] ? 1 : 0;
          dx2 += f2 < req[2] ? 1 : 0;
        }
      }
    }
    int mx[4] = {block_sum(n_exh, s_red), block_sum(dx0, s_red),
                 block_sum(dx1, s_red), block_sum(dx2, s_red)};
    if (SHARDED) cluster_sum(xcnt + 3 * S * 8, s, S, mx, 4);

    // 6. this round's packed output row (block 0 of a cluster)
    if (s == 0) {
      const int width = p.out_mode == 2 ? p.fill_k + META
                        : (p.out_mode == 1 ? 2 * p.rs : p.rs) + META;
      int* brow = p.buf + (int64_t)t * width;
      for (int i = tid; i < p.rs; i += BS) {
        int f = (i < kk && s_c[i] > 0) ? s_row[i] * 2048 + s_c[i] : 0;
        if (p.out_mode == 2) {
          p.fills[(int64_t)t * p.rs + i] = f;
          if (i < p.fill_k) brow[i] = f;
        } else {
          brow[i] = f;
        }
        // slots past kk hold NEG_INF (s_sc's default), as the padded
        // reference prefix does
        if (p.out_mode == 1) brow[p.rs + i] = __float_as_int(s_sc[i]);
      }
      int* meta = brow + width - META;
      if (tid == 0) {
        const int topn = min(min(kk, TOP_K), p.n);
        for (int q = 0; q < TOP_K; ++q) {
          bool v = q < topn && s_sc[q] > HALF_NEG_INF;
          meta[q] = v ? s_row[q] : -1;
          meta[TOP_K + q] = v ? __float_as_int(s_sc[q]) : 0;
        }
        meta[6] = n_feas;
        meta[7] = p.n - n_static;
        meta[8] = mx[0];
        meta[9] = mx[1];
        meta[10] = mx[2];
        meta[11] = mx[3];
        meta[12] = placed;
        meta[13] = 0;
        meta[14] = 0;
        meta[15] = 0;
      }
    }
    __syncthreads();
  }
}

__global__ void pow10_kernel(const float* __restrict__ x,
                             float* __restrict__ y, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = libm_pow10f(x[i]);
}

// `rounds` dependent block-wide barriers in one 1024-thread block, each
// round a shared-memory write and a read across warps (the cheapest
// step of the rounds kernels' barrier chain)
__global__ void __launch_bounds__(BS, 1) barrier_kernel(int rounds,
                                                        int* sink) {
  __shared__ int s[BS];
  int v = threadIdx.x;
  for (int i = 0; i < rounds; ++i) {
    s[threadIdx.x] = v;
    __syncthreads();
    v += s[(threadIdx.x + 32 * (i + 1)) & (BS - 1)];
    __syncthreads();
  }
  if (v == 0x7fffffff) *sink = v;
}

// `rounds` dependent count exchanges of the sharded rounds (post,
// fence, cluster barrier, read of the S slots) in one cluster of 1024-
// thread blocks: the price of one of their three cluster meetings a
// round
__global__ void __launch_bounds__(BS, 1) cluster_barrier_kernel(
    int rounds, int* rows, int* sink) {
  const int S = (int)cg::this_cluster().num_blocks();
  const int s = (int)cg::this_cluster().block_rank();
  int v = threadIdx.x;
  for (int i = 0; i < rounds; ++i) {
    int x = v + i;
    cluster_sum(rows + (i & 3) * S * 8, s, S, &x, 1);
    v += x & 1;
  }
  if (v == 0x7fffffff) *sink = v;
}

// the sharded launch of the rounds kernel: one cluster of S blocks,
// S * kk_loc gathered keys in dynamic shared memory
int launch_sharded(Params p, cudaStream_t stream) {
  if (p.n_shards < 1 || p.n_shards > 8 || p.nc < 1)
    return (int)cudaErrorInvalidValue;
  const size_t dyn = (size_t)p.n_shards * min(p.rs, p.nc) *
                     sizeof(unsigned long long);
  return launch_clusters(rounds_kernel<true>, p.n_shards, p.n_shards, dyn,
                         stream, p);
}

int run_rounds(const int* cap, int* used, const uint8_t* static_row,
               const float* aff_row, const int* aff, const int* req,
               const int* desired, const int* dh_limit,
               const long long* seed, const int* job_count0,
               const int* round_want, int* buf, int n, int n_aff,
               int n_rounds, int spread, int rs, int out_mode, int fill_k,
               int* fills, int* jc, int* ki, float* score, unsigned* keyb,
               int n_shards, int* xcnt, unsigned long long* xkey, int* xval,
               cudaStream_t stream) {
  if (rs > MAX_RS || rs < 1 || out_mode < 0 || out_mode > 2 ||
      (out_mode == 2 && (fill_k < 1 || fill_k > rs || fills == nullptr)) ||
      (n_shards && (out_mode != 0 || n % n_shards != 0)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.cap = cap; p.used = used; p.n = n;
  p.static_u = static_row; p.aff_land = aff_row; p.aff = aff;
  p.n_aff = n_aff; p.req = req; p.desired = desired; p.dh_limit = dh_limit;
  p.seed = seed; p.job_count0 = job_count0; p.round_want = round_want;
  p.n_steps = n_rounds; p.spread = spread;
  p.rs = rs; p.fill_k = fill_k; p.out_mode = out_mode;
  p.jc = jc; p.ki = ki; p.score = score; p.keyb = keyb; p.buf = buf;
  p.fills = fills;
  p.n_shards = n_shards; p.xcnt = xcnt; p.xkey = xkey; p.xval = xval;
  if (n_shards) {
    p.nc = n / n_shards;
    return launch_sharded(p, stream);
  }
  p.nc = n;
  rounds_kernel<false><<<1, BS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The rounds kernels' 10^x over an array, to hold it against the C
// library's powf; the placement path never calls it.
extern "C" int pow10_f32(const float* x, float* y, long long n,
                         cudaStream_t stream) {
  if (n > 0)
    pow10_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

// Probe of the cost of one barrier round (2 * rounds __syncthreads), to
// price the rounds kernels' sequential depth; the placement path never
// calls it.
extern "C" int barrier_probe(int rounds, int* sink, cudaStream_t stream) {
  barrier_kernel<<<1, BS, 0, stream>>>(rounds, sink);
  return (int)cudaGetLastError();
}

// Probe of the cost of one cluster exchange of the sharded kernels at
// cluster size `cluster` (`rows` holds 4 * cluster * 8 ints); the
// placement path never calls it.
extern "C" int cluster_barrier_probe(int rounds, int cluster, int* rows,
                                     int* sink, cudaStream_t stream) {
  if (cluster < 1 || cluster > 8) return (int)cudaErrorInvalidValue;
  return launch_clusters(cluster_barrier_kernel, cluster, cluster, 0,
                         stream, rounds, rows, sink);
}

// K6: one group's rows (static_row, aff_row and job_count0 [N]; req [3];
// desired, dh_limit, seed [1]; aff [Af, 4]) in rounds of round_want [R]
extern "C" int multi_bulk(
    const int* cap, int* used, const uint8_t* static_row,
    const float* aff_row, const int* aff, const int* req, const int* desired,
    const int* dh_limit, const long long* seed, const int* job_count0,
    const int* round_want, int* buf, int n, int n_aff, int n_rounds,
    int spread, int rs, int out_mode, int fill_k, int* fills, int* jc,
    int* ki, float* score, unsigned* keyb, cudaStream_t stream) {
  return run_rounds(cap, used, static_row, aff_row, aff, req, desired,
                    dh_limit, seed, job_count0, round_want, buf, n, n_aff,
                    n_rounds, spread, rs, out_mode, fill_k, fills, jc, ki,
                    score, keyb, 0, nullptr, nullptr, nullptr, stream);
}

// K10: the bulk rounds (full layout) over npad = n rows in n_shards shards
extern "C" int multi_bulk_sharded(
    const int* cap, int* used, const uint8_t* static_row,
    const float* aff_row, const int* aff, const int* req, const int* desired,
    const int* dh_limit, const long long* seed, const int* job_count0,
    const int* round_want, int* buf, int n, int n_aff, int n_rounds,
    int spread, int rs, int* jc, int* ki, float* score, unsigned* keyb,
    int n_shards, int* xcnt, unsigned long long* xkey, int* xval,
    cudaStream_t stream) {
  if (n_shards < 1) return (int)cudaErrorInvalidValue;
  return run_rounds(cap, used, static_row, aff_row, aff, req, desired,
                    dh_limit, seed, job_count0, round_want, buf, n, n_aff,
                    n_rounds, spread, rs, 0, 0, nullptr, jc, ki, score, keyb,
                    n_shards, xcnt, xkey, xval, stream);
}

PY_LAUNCHERS(multi_rounds,
             PY_LAUNCHER(multi_bulk),
             PY_LAUNCHER(pow10_f32),
             PY_LAUNCHER(barrier_probe),
             PY_LAUNCHER(cluster_barrier_probe),
             PY_LAUNCHER(multi_bulk_sharded))
