// K2 "multi_compact", K12 "multi_compact_sharded", K3 "multi_flat", K11
// "multi_flat_sharded", K6 "multi_bulk" and K10 "multi_bulk_sharded": the
// water-fill rounds, batched over evals or over one eval's homogeneous
// batch, one launch per wave or eval, one thread-block cluster per lane.
//
// Replaces (TPU side, jax.jit): nomad_tpu/ops/select.py:836
// place_multi_compact_packed (+ :1006 place_multi_compact_chained) for
// K2; nomad_tpu/parallel/mesh.py:590 place_multi_compact_sharded_fn
// (_multi_compact_local :503, chained form :639, its fill
// _sharded_waterfill :255) for K12; nomad_tpu/ops/select.py:733
// place_multi_packed (+ :997 place_multi_chained) for K3;
// nomad_tpu/parallel/mesh.py:454 place_multi_sharded_packed_fn
// (_multi_local :390, chained form :497) for K11;
// nomad_tpu/ops/select.py:554 place_bulk_packed (_bulk_scan :517,
// _bulk_step :460, _bulk_static :505; place_bulk :615) for K6;
// nomad_tpu/parallel/mesh.py:645 place_bulk_sharded_packed_fn (_bulk_local
// :346) for K10; with their round core round_scores_g (:342),
// waterfill_round (:413), round_metrics_g (:393), tiebreak_noise (:43)
// and pack_round_buffer (:531).
//
// One kernel body, six launches:
//   K2   lanes over zoned frames [L, Nc] (padding slots hold row n);
//   K12  the same over per-shard frames [S, L, Nc_loc]: lane l's frame is
//        its S shard slices laid end to end, shard-major (slot
//        s Nc_loc + j).  The reference's two-stage top-k (each shard's
//        top min(rs, Nc_loc), then the top of their shard-major union,
//        ties to the lower index) is the exact top rs in that slot order,
//        which is K2's order, so K12 is K2 on those frames; block s of
//        the cluster reads shard s's slices in place;
//   K3   (FLAT) one lane whose frame is every row (slot = row, no row
//        array), the step's static row from K1's [U, N] mask
//        (static_u[g_static[g]]) cached in each slot's valid bit and
//        refreshed only when the signature changes, job counts chained by
//        job (K2 chains by group) and reseeded from job_count0 [J, N] in
//        the pass, buf [R, rs + 16] with every fill slot, every row's
//        usage read from used_in and written to used (the same buffer
//        in the chained form), and the last step's job count row as an
//        output;
//   K11  K3 over the npad rows of S node shards.  Shard s owns rows
//        [s n_loc, (s + 1) n_loc), so the reference's stable top rs of
//        the shards' top min(rs, n_loc) lists, laid out shard-major, is
//        the exact top rs over all rows in row order; the noise runs
//        over global rows and the counts are sums over the mesh, so K11
//        is K3 over those rows (the entry checks that the shards divide
//        them);
//   K6   K3 at one group: one signature (K8's [1, N] mask, with the
//        group's device mask row ANDed in by the wrapper), one
//        job whose counts carry from round to round, one seed, and round
//        r wanting clip(p_real - r rs, 0, rs), derived here from p_real
//        (tests/test_torch_bulk.py shows the identity on the reference).
//        K6's three layouts: the full one (K3's), the compact one (a
//        prefix of fill_k slots, the full fills beside it: K2's) and the
//        one with scores ([R, 2 rs + 16]: the score of each of the round's
//        top min(rs, N) keys in rank order, NEG_INF for an infeasible row
//        and past them), which takes the wide path at every computed step
//        with T = min(rs, N) so that every rank is known;
//   K10  K6 over the npad rows of S node shards, as K11 is K3's
//        (tests/test_torch_mesh.py shows K10 = K6 on those rows).
//
// What bounds it on the H100: sequential depth.  Lane l's step t must see
// the usage and job counts its steps < t committed, so a wave is T
// dependent rounds of a frame (the north-star zoned wave: 128 steps, 77
// of them real, over ~10,240 rows, 5 lanes; the flat wave 64 rounds over
// 50,000 rows; the bulk eval 10 rounds over 1,000 rows).  The bytes and operations are microseconds for the whole
// wave; the chain of each step is what costs.
//
// Design.  A lane's frame is split over a cluster of up to 8 blocks of
// 256 threads (slots [sh R, (sh + 1) R) of the frame in block sh; 8
// blocks of 1,280 slots at the zoned wave; K12 one block per shard; K3
// may take a non-portable cluster of 16 blocks so that its frame fits in
// shared memory), and the frame's state lives in shared memory (in
// global scratch when it does not fit): usage, capacity, global row, job
// counts and the seed row they restart from (loaded once per job; K3
// keeps neither row array), and a cache of the terms that only a commit
// or another request changes: the capacity intake, the binpack term (two
// 10^x in double precision) and the fit bits of the exhaustion metrics.
// The cache is refilled only when the step's request differs from the
// cached one, else only at the rows a step commits.  Per step:
//   1. the pass, two rows a thread at a time: each row's score in the
//      reference's order of operations (intake, binpack -> job
//      anti-affinity -> affinity mean, its divisions skipped only where
//      they cannot change a bit) and its 64-bit key (orderable bits of
//      score + noise over the global row, then ~slot: key descending,
//      then frame slot ascending, as jax.lax.top_k orders them); the
//      counts of viable rows and of pre-commit exhaustion; each thread's
//      top TOPB keys;
//   2. the merge: warps by redux rounds, warp 0 over the warps; warp 0
//      posts the block's top TOPB keys with what the decision needs
//      (score, intake, global row, free capacity, job count), the
//      block's counts and its count of valid slots into every peer's
//      shared memory (xch_meet, distributed shared memory,
//      score_common.cuh);
//   3. the decision, in warp 0 of every block alike: the lane's top TOPB
//      of the posts, the spread intake cap (which needs the viable count
//      only for the intake, never for the order: kr > 0 iff k > 0), the
//      water-fill scan, the commit of this block's winners with their
//      cache refresh, the post-commit metrics as the pass's counts
//      corrected at the committed rows, and block 0's output row.
//      A round fills at most TOPB rows when the top TOPB's intake reaches
//      `want` (binpack: a node takes up to round_size placements), or
//      when they hold every feasible row; otherwise (the spread
//      algorithm's fan-out) the step takes the wide path: an exact top
//      T = min(round_size, frame, want) by a cluster-wide MSB radix
//      select over the keys' score bits (histograms read across the
//      cluster; none when T is the whole frame), ties at the threshold
//      taken in frame-slot order, the T entries pushed to every block,
//      ranked by the cluster's threads together (each rank written into
//      every block) and water-filled.
//   4. the memo: a step whose group and `want` repeat the last computed
//      step's, after that step placed nothing, has the same state and
//      inputs (job counts carry over for a repeated group, and so for its
//      job; the static row is the group's), so block 0 copies that step's
//      row and nothing else runs.  That is every padding step of a lane
//      but the first.
// Block barriers per step: 2 (after the pass, after the decision); one
// exchange; a memoised step none; K3 adds 3 at a signature change.  The
// last block of a lane may hold fewer rows; frames of any size are
// accepted.

#include "py_launchers.cuh"  // first: it includes Python.h
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int BS = 256;            // threads per block
constexpr int MAX_RS = 1024;       // select.py asserts round_size <= 1024
constexpr int TOP_K = 3;
constexpr int META = 16;
constexpr int TOPB = 4;            // keys a block posts each step
constexpr int PW = 9;              // post words per key (hi lo sc k row f0
                                   // f1 f2 jc)
constexpr int NCNT = 5;            // pass counts: viable exh dim(3)
constexpr int NPC = NCNT + 1;      // post counts: those, valid slots
constexpr int XW = 44;             // post words (TOPB PW + NPC, padded)
constexpr int GV = 8;              // wide-path entry words besides the key
                                   // (7 and a pad: two 16-byte stores)
constexpr int KPT = MAX_RS / BS;   // wide-path entries a thread holds
constexpr int STAGE = 128;         // steps staged in shared memory at once
constexpr int SW = 12;             // staged words per step
constexpr int MIN_ROWS = 256;      // frame slots a block takes at least
constexpr int MAX_CB = 16;         // blocks a cluster (K3's frames; K2 and
                                   // K12 take at most XCH_BLOCKS)
// frame state bits
constexpr unsigned F_VALID = 1, F_FIT = 2, F_LT0 = 4;

#include "score_common.cuh"

// Frames are [S, L, nc] (K2 and K3: S = 1; K3: L = 1, nc = N, no row
// arrays), every per-slot input laid out alike with the shard outermost.
struct Params {
  const int* cap;            // [N, 3]
  const int* used_in;        // [N, 3] start usage
  int* used_out;             // [N, 3] output (may be used_in)
  const int* cand_rows;      // [S, L, nc] frame rows (padding = n)
  const uint8_t* cand_valid; // [S, L, nc]
  const uint8_t* static_u;   // K3: [U, N] from K1
  const float* aff_land;     // [S, L, Ua, nc]
  const int* aff;            // [Ua, Af, 4]
  const int* req;            // [G, 3]
  const int* desired;        // [G]
  const int* dh_limit;       // [G]
  const int* g_static;       // K3: [G]
  const int* g_aff;          // [G]
  const int* g_job;          // [G]
  const long long* seed;     // [G], uint32 values
  const int* job_count0;     // [S, J', nc]
  const int* round_g;        // [T * L] step-major (K6: none)
  const int* round_want;
  int* buf;                  // [T * L, fill_k + sc_w + 16]
  int* fills;                // [T * L, rs] (K3: none)
  int* jc_out;               // K3: [N] the last step's job counts
  int n, n_lanes, nc, ua, n_aff, n_steps, spread, rs, fill_k;
  int sc_w;                  // K6 with scores: rs score words a row, else 0
  int p_real;                // K6: the placements, a prefix of the rounds
  unsigned seed0;            // K6: the seed (no seed array)
  int shards, n_jrows;       // S, J'
  int cb, rows;              // blocks per lane, frame slots per block
  unsigned char* frame_glob; // scratch for the frame state per block,
                             // used when it does not fit in smem
  long long frame_bytes;     // bytes of one block's frame state
  long long* prof;           // PROF: [2 NPH + 4] block 0's split
};

// The PROF instantiation's phases (PhaseClock): the loop top, the pass,
// the warp and block merge with the post, the exchange, the decision
// (with the commit and the output row), the wide path, memoised steps.
constexpr int NPH = 7;
enum { PH_TOP, PH_PASS, PH_MERGE, PH_XCH, PH_DECIDE, PH_WIDE, PH_MEMO };

__host__ __device__ constexpr long long align16(long long b) {
  return (b + 15) / 16 * 16;
}

// Dynamic shared memory: the wide path's entries (keys, values, sorted
// order, fill counts) and its 4 radix histograms, then the frame state
// when it fits.
struct Dyn {
  long long gkey, gval, gord, gc, hist, frame;
};

__host__ __device__ Dyn dyn_layout(int kk) {
  Dyn d;
  d.gkey = 0;
  d.gval = d.gkey + align16(8ll * kk);
  d.gord = d.gval + align16(4ll * GV * kk);
  d.gc = d.gord + align16(4ll * kk);
  d.hist = d.gc + align16(4ll * kk);
  d.frame = d.hist + 4 * 256 * 4;
  return d;
}

// int words a frame slot holds: 12, and K2's global row and job count
// seed row
__host__ __device__ constexpr int frame_words(bool flat) {
  return flat ? 12 : 14;
}

__host__ __device__ long long frame_size(int rows, bool flat) {
  return align16(4ll * frame_words(flat) * rows + rows);
}

// One block's frame state, structure of arrays over its rows: usage,
// capacity, job counts (jc), the cache (kcap, bp, the fit bits of fl),
// the step's intake, score and key bits, and (K2, K12) the global row and
// the job count seed row the counts restart from (jcs).
struct Frame {
  int *u0, *u1, *u2, *c0, *c1, *c2, *jc, *kcap, *k, *crow, *jcs;
  float *bp, *sc;
  unsigned* hi;
  uint8_t* fl;
};

template <bool FLAT>
__device__ __forceinline__ Frame frame_at(unsigned char* base, int r) {
  Frame f;
  int* w = (int*)base;
  f.u0 = w;
  f.u1 = w + r;
  f.u2 = w + 2 * r;
  f.c0 = w + 3 * r;
  f.c1 = w + 4 * r;
  f.c2 = w + 5 * r;
  f.jc = w + 6 * r;
  f.kcap = w + 7 * r;
  f.k = w + 8 * r;
  f.bp = (float*)(w + 9 * r);
  f.sc = (float*)(w + 10 * r);
  f.hi = (unsigned*)(w + 11 * r);
  f.crow = FLAT ? nullptr : w + 12 * r;
  f.jcs = FLAT ? nullptr : w + 13 * r;
  f.fl = (uint8_t*)(w + frame_words(FLAT) * r);
  return f;
}

// the global row of this block's slot j (K3: slot = row)
template <bool FLAT>
__device__ __forceinline__ int row_of(const Frame& f, int j, int row0) {
  return FLAT ? row0 + j : f.crow[j];
}

// round_metrics_g's fit of free capacity f for request r
__device__ __forceinline__ bool fits(const int* f, const int* r) {
  return f[0] >= r[0] && f[1] >= r[1] && f[2] >= r[2] && f[0] >= 0 &&
         f[1] >= 0 && f[2] >= 0;
}

// The cache of row j for request r: the capacity intake, the binpack
// term and the fit bits of the exhaustion metrics (round_metrics_g).
__device__ __forceinline__ void refresh_row(const Frame& f, int j,
                                            const int* r, int rs,
                                            bool spread) {
  const int c[3] = {f.c0[j], f.c1[j], f.c2[j]};
  const int u[3] = {f.u0[j], f.u1[j], f.u2[j]};
  f.kcap[j] = rounds_kcap(c, u, r, rs);
  f.bp[j] = rounds_binpack(c, u, r, spread);
  const int fr[3] = {c[0] - u[0], c[1] - u[1], c[2] - u[2]};
  f.fl[j] = (uint8_t)((f.fl[j] & F_VALID) | (fits(fr, r) ? F_FIT : 0u) |
                      (fr[0] < r[0] ? F_LT0 : 0u) |
                      (fr[1] < r[1] ? F_LT0 << 1 : 0u) |
                      (fr[2] < r[2] ? F_LT0 << 2 : 0u));
}

// commit c placements of request r to this block's row j, and refresh
// its cache
__device__ __forceinline__ void commit_row(const Frame& f, int j, int c,
                                           const int* r, int rs,
                                           bool spread) {
  f.u0[j] += c * r[0];
  f.u1[j] += c * r[1];
  f.u2[j] += c * r[2];
  f.jc[j] += c;
  refresh_row(f, j, r, rs, spread);
}

// a thread's sorted top TOPB keys (0 = empty)
__device__ __forceinline__ void topb_insert(unsigned long long c,
                                            unsigned long long* t) {
  if (c <= t[TOPB - 1]) return;
#pragma unroll
  for (int i = 0; i < TOPB; ++i) {
    const unsigned long long hi = c > t[i] ? c : t[i];
    c = c > t[i] ? t[i] : c;
    t[i] = hi;
  }
}

// The warp's largest head of its lanes' sorted lists `t`, in every lane
// (keys unique but for the empty 0); the winning lane, *src, pops its
// head.
__device__ __forceinline__ unsigned long long warp_pop(unsigned long long* t,
                                                       int* src_out) {
  const int lane = threadIdx.x & 31;
  const unsigned hi = (unsigned)(t[0] >> 32), lo = (unsigned)t[0];
  const unsigned mh = __reduce_max_sync(FULL, hi);
  unsigned tied = __ballot_sync(FULL, hi == mh);
  if (__popc(tied) > 1) {
    const unsigned ml = __reduce_max_sync(FULL, hi == mh ? lo : 0u);
    tied = __ballot_sync(FULL, hi == mh && lo == ml);
  }
  const int src = __ffs(tied) - 1;
  const unsigned ml = __shfl_sync(FULL, lo, src);
  if (lane == src) {
#pragma unroll
    for (int i = 0; i + 1 < TOPB; ++i) t[i] = t[i + 1];
    t[TOPB - 1] = 0ull;
  }
  *src_out = src;
  return ((unsigned long long)mh << 32) | ml;
}

// the 64-bit key of a post entry (its first two words)
__device__ __forceinline__ unsigned long long post_key(const int* w) {
  return ((unsigned long long)(unsigned)w[0] << 32) | (unsigned)w[1];
}

// A post entry of this block's row j: key bits, inverted slot, score,
// intake, global row, free capacity and job count (0s when key is 0).
template <bool FLAT>
__device__ __forceinline__ void post_entry(int* w, unsigned long long key,
                                           const Frame& f, int row0) {
  if (key == 0ull) {
    for (int q = 0; q < PW; ++q) w[q] = 0;
    return;
  }
  const int j = (int)~(unsigned)key - row0;
  w[0] = (int)(key >> 32);
  w[1] = (int)(unsigned)key;
  w[2] = __float_as_int(f.sc[j]);
  w[3] = f.k[j];
  w[4] = row_of<FLAT>(f, j, row0);
  w[5] = f.c0[j] - f.u0[j];
  w[6] = f.c1[j] - f.u1[j];
  w[7] = f.c2[j] - f.u2[j];
  w[8] = f.jc[j];
}

// block-wide sum of NV ints per thread (in place), in every thread; `red`
// holds 32 * NV ints
template <int NV>
__device__ __forceinline__ void block_sums(int* v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < NV; ++q) v[q] = __reduce_add_sync(FULL, v[q]);
  __syncthreads();
  if (lane == 0)
    for (int q = 0; q < NV; ++q) red[warp * NV + q] = v[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    int s = 0;
    for (int w = 0; w < BS / 32; ++w) s += red[w * NV + q];
    v[q] = s;
  }
}

// block-wide exclusive prefix sum in thread order; `red` holds 32 ints
__device__ __forceinline__ int block_excl(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) red[warp] = x;
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += red[w];
  return base + x - v;
}

// The meta columns after the top rows and scores (pack_round_buffer):
// n_feasible, n_filtered, the exhaustion metrics (4), placed, padding.
__device__ __forceinline__ void meta_tail(int* meta, int feas, int filt,
                                          const int* pre, const int* delta,
                                          int placed) {
  meta[6] = feas;
  meta[7] = filt;
  for (int q = 0; q < 4; ++q) meta[8 + q] = pre[q] + delta[q];
  meta[12] = placed;
  meta[13] = 0;
  meta[14] = 0;
  meta[15] = 0;
}

// The post-commit change of one committed row's exhaustion metrics
// (round_metrics_g: exhausted, then the three per-dimension counts), from
// its pre-commit free capacity f and job count jc and its fill c.
__device__ __forceinline__ void metric_delta(const int* f, int jc, int c,
                                             const int* r, int dh,
                                             int* d) {
  const bool ex = !(fits(f, r) && (dh > 0 ? jc < dh : true));
  int g[3];
  for (int q = 0; q < 3; ++q) g[q] = f[q] - c * r[q];
  const bool ex2 = !(fits(g, r) && (dh > 0 ? jc + c < dh : true));
  d[0] = (int)ex2 - (int)ex;
  for (int q = 0; q < 3; ++q)
    d[1 + q] = (int)(ex2 && g[q] < r[q]) - (int)(ex && f[q] < r[q]);
}

// SM: the frame state in dynamic shared memory (typed shared loads in
// the pass), else in the wrapper's global scratch; FLAT: K3's frame
template <bool PROF, bool SM, bool FLAT>
__global__ void __launch_bounds__(BS, 1) compact_kernel(Params p) {
  constexpr int NT = BS, NW = BS / 32;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ int s_stage[STAGE * SW];
  __shared__ unsigned long long s_wkey[NW * TOPB];
  __shared__ int s_red[32 * NCNT];
  __shared__ int s_tie[2][NW];
  __shared__ int s_tot[256];
  __shared__ __align__(16) int s_post[XW];
  __shared__ __align__(16) XchT<XW, MAX_CB> s_xch;
  // the decision's results for the block: wide path, viable rows, intake
  // cap, placed, pre-commit exhaustion sums (4); the wide path's radix
  // digit and count above it, tie quota and ties, entry counter; the
  // filtered rows
  __shared__ int s_ctl[14];
  __shared__ int s_sel;   // read by the peers
  __shared__ int s_seg[MAX_CB + 1];

  enum { C_WIDE, C_VIABLE, C_CAP, C_PLACED, C_EXH, C_DIG = 8, C_ACC, C_QUOTA,
         C_EQ, C_CNT, C_FILT };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  PhaseClock<PROF, NPH> pc;
  pc.start(blockIdx.x == 0 && tid == 0);
  cg::cluster_group cl = cg::this_cluster();
  const int CB = p.cb, R = p.rows, L = p.n_lanes;
  const int sh = (int)cl.block_rank();
  const int l = (int)blockIdx.x / CB;
  const int nc = p.nc, n = p.n, rs = p.rs;
  const int nct = nc * p.shards;              // slots of the lane's frame
  const int row0 = sh * R;
  const int nb = max(0, min(R, nct - row0));  // this block's rows
  // where this block's slots lie in the [S, L, nc] inputs: K12 one block
  // per shard (R = nc), else shard 0 from slot row0
  const int sb = p.shards > 1 ? sh : 0, jb = p.shards > 1 ? 0 : row0;
  const int64_t in0 = ((int64_t)sb * L + l) * nc + jb;
  const int kk = min(rs, nct);
  const int nbk = min(TOPB, kk);
  const int width = p.fill_k + p.sc_w + META;
  const Dyn dl = dyn_layout(kk);
  unsigned long long* gkey = (unsigned long long*)(s_dyn + dl.gkey);
  int* gval = (int*)(s_dyn + dl.gval);
  int* gord = (int*)(s_dyn + dl.gord);
  int* gc = (int*)(s_dyn + dl.gc);
  int* hist = (int*)(s_dyn + dl.hist);
  const Frame F = frame_at<FLAT>(
      SM ? s_dyn + dl.frame
         : p.frame_glob + (int64_t)blockIdx.x * p.frame_bytes,
      R);
  xch_init(&s_xch, CB);

  // the lane's frame rows; K2's padding rows start empty (never valid);
  // K3's valid bits come with the first step's static row
  int nvalid = 0;   // this block's valid slots
  {
    for (int j = tid; j < nb; j += NT) {
      const bool v = FLAT || p.cand_valid[in0 + j] != 0;
      const int64_t r = FLAT ? row0 + j : p.cand_rows[in0 + j];
      const int64_t rc = min(r, (int64_t)n - 1);
      if (!FLAT) F.crow[j] = (int)r;
      F.c0[j] = p.cap[3 * rc];
      F.c1[j] = p.cap[3 * rc + 1];
      F.c2[j] = p.cap[3 * rc + 2];
      F.u0[j] = v ? p.used_in[3 * r] : 0;
      F.u1[j] = v ? p.used_in[3 * r + 1] : 0;
      F.u2[j] = v ? p.used_in[3 * r + 2] : 0;
      F.fl[j] = v && !FLAT ? F_VALID : 0;
      F.jc[j] = 0;
      nvalid += v && !FLAT ? 1 : 0;
    }
    if (!FLAT) block_sums<1>(&nvalid, s_red);
  }
  cl.sync();   // every exchange barrier set up
  pc.setup_done();

  int g_prev = -1, want_prev = -1, placed_prev = 0, t_last = 0;
  int job_prev = -1;
  int jsrc = -1;    // the job count seed row held in F.jcs
  int u_have = -1;  // K3: the signature whose static row F_VALID holds
  int cq0 = 0, cq1 = 0, cq2 = 0;
  bool cached = false;
  int xk = 0;   // exchanges so far
  for (int t = 0; t < p.n_steps; ++t) {
    if (t % STAGE == 0) {
      // the next STAGE steps' group statics
      __syncthreads();
      for (int i = tid; i < STAGE && t + i < p.n_steps; i += NT) {
        int* w = s_stage + i * SW;
        const int rr = (t + i) * L + l;
        // K6: every round of group 0, round r wanting
        // clip(p_real - r rs, 0, rs)
        const int g = p.round_g ? p.round_g[rr] : 0;
        w[0] = g;
        w[1] = p.round_g ? p.round_want[rr]
                         : min(max(p.p_real - (t + i) * rs, 0), rs);
        w[2] = p.req[3 * g];
        w[3] = p.req[3 * g + 1];
        w[4] = p.req[3 * g + 2];
        w[5] = p.desired[g];
        w[6] = p.dh_limit[g];
        const int a = p.g_aff ? p.g_aff[g] : 0;
        bool any = false;
        for (int q = 0; q < p.n_aff; ++q)
          any |= p.aff[((int64_t)a * p.n_aff + q) * 4 + 3] != 0;
        w[7] = a;
        w[8] = any;
        w[9] = p.seed ? (int)(unsigned)(p.seed[g] & 0xffffffffll)
                      : (int)p.seed0;
        w[10] = p.g_job ? p.g_job[g] : 0;
        w[11] = FLAT && p.g_static ? p.g_static[g] : 0;
      }
      __syncthreads();
    }
    const int* st = s_stage + (t % STAGE) * SW;
    const int g = st[0], want = st[1];
    const bool act = want > 0;
    const bool same = g == g_prev;
    if (same && want == want_prev && placed_prev == 0) {
      // 4. the memo: the last computed step's row
      if (sh == 0) {
        const int64_t r = (int64_t)t * L + l, rl = (int64_t)t_last * L + l;
        if (p.fills)
          for (int i = tid; i < rs; i += NT)
            p.fills[r * rs + i] = p.fills[rl * rs + i];
        for (int i = tid; i < width; i += NT)
          p.buf[r * width + i] = p.buf[rl * width + i];
      }
      pc.mark(PH_MEMO, act);
      pc.step(act);
      continue;
    }
    g_prev = g;
    want_prev = want;
    t_last = t;
    const int req[3] = {st[2], st[3], st[4]};
    const int desired = st[5], dh = st[6], a = st[7];
    const bool aff_any = st[8] != 0;
    const unsigned sd = (unsigned)st[9];
    const int gjob = st[10];
    // the counts carry over from the last step: K2's and K12's for the
    // same group, K3's for the same job (select.py same_r)
    const bool jsame = FLAT ? gjob == job_prev : same;
    job_prev = gjob;
    const bool refresh =
        !cached || req[0] != cq0 || req[1] != cq1 || req[2] != cq2;
    cached = true;
    cq0 = req[0];
    cq1 = req[1];
    cq2 = req[2];
    const int* jc0 =
        p.job_count0 + ((int64_t)sb * p.n_jrows + gjob) * nc + jb;
    if (!FLAT && !jsame && gjob != jsrc) {
      // the group's job count seed row, its loads issued together (each
      // thread reads back only the rows it loads)
      for (int j0 = tid; j0 < nb; j0 += 4 * NT) {
        int v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + q * NT;
          v[q] = j < nb ? __ldg(jc0 + j) : 0;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j0 + q * NT < nb) F.jcs[j0 + q * NT] = v[q];
      }
      jsrc = gjob;
    }
    if (FLAT && st[11] != u_have) {
      // K3: the signature's static row into the valid bits (the cache
      // does not depend on them: every slot holds its row's usage)
      const uint8_t* srow = p.static_u + (int64_t)st[11] * n + row0;
      nvalid = 0;
      for (int j = tid; j < nb; j += NT) {
        const bool v = __ldg(srow + j) != 0;
        F.fl[j] = (uint8_t)((F.fl[j] & ~F_VALID) | (v ? F_VALID : 0u));
        nvalid += v ? 1 : 0;
      }
      block_sums<1>(&nvalid, s_red);
      __syncthreads();   // s_red read before the merge rewrites it
      u_have = st[11];
    }
    pc.mark(PH_TOP, act);

    // 1. the pass, two rows an iteration: both rows' loads, then both
    // chains of arithmetic, then the stores, so that the chains overlap
    unsigned long long top[TOPB];
#pragma unroll
    for (int q = 0; q < TOPB; ++q) top[q] = 0ull;
    int cnt[NCNT] = {0, 0, 0, 0, 0};   // viable exh dim(3)
    {
      const float* afr =
          p.aff_land + (((int64_t)sb * L + l) * p.ua + a) * nc + jb;
      const float des = fmaxf((float)desired, 1.0f);
      const int cnt0 = 1 + (aff_any ? 1 : 0);
      // one row: its intake, score and key bits, and its counts
      auto row = [&](int jcount, unsigned f, int kc, float bp, int grow,
                     float af, int* k_out, float* sc_out) {
        const bool stt = (f & F_VALID) != 0;
        int k = kc;
        if (dh > 0) k = min(k, min(max(dh - jcount, 0), rs));
        if (!stt) k = 0;
        // the reference's mean, its divisions taken only where they
        // change a bit: the anti-affinity term only for a job count > 0,
        // and x / 1 = x, x / 2 = x * 0.5 exactly
        const float aa = jcount > 0 ? -((float)jcount / des) : 0.0f;
        float acc = 0.0f;
        acc = acc + bp;
        acc = acc + aa;
        acc = acc + (aff_any ? af : 0.0f);
        const int c = cnt0 + (jcount > 0 ? 1 : 0);
        const float sc = c == 1 ? acc : c == 2 ? acc * 0.5f : acc / 3.0f;
        const float key =
            (k > 0 ? sc : NEG_INF) + tiebreak_noise(sd, (unsigned)grow);
        const unsigned hi = orderable(key);
        cnt[0] += k > 0 ? 1 : 0;
        const bool dh_ok = dh > 0 ? jcount < dh : true;
        if (stt && !((f & F_FIT) && dh_ok)) {
          cnt[1] += 1;
          cnt[2] += (f & F_LT0) ? 1 : 0;
          cnt[3] += (f & (F_LT0 << 1)) ? 1 : 0;
          cnt[4] += (f & (F_LT0 << 2)) ? 1 : 0;
        }
        *k_out = k;
        *sc_out = sc;
        return hi;
      };
      // a row's job count: carried, else the seed row (K3 reads it here)
      auto jcount_at = [&](int j) {
        return jsame ? F.jc[j] : FLAT ? __ldg(jc0 + j) : F.jcs[j];
      };
      for (int j = tid; j < nb; j += 2 * NT) {
        const int j2 = j + NT;
        const bool two = j2 < nb;
        if (refresh) {
          refresh_row(F, j, req, rs, p.spread != 0);
          if (two) refresh_row(F, j2, req, rs, p.spread != 0);
        }
        const int jj2 = two ? j2 : j;   // a second row's loads, in range
        const int jc1 = jcount_at(j);
        const int jc2 = jcount_at(jj2);
        const unsigned f1 = F.fl[j], f2 = F.fl[jj2];
        const int kc1 = F.kcap[j], kc2 = F.kcap[jj2];
        const float bp1 = F.bp[j], bp2 = F.bp[jj2];
        const int g1 = row_of<FLAT>(F, j, row0);
        const int g2 = row_of<FLAT>(F, jj2, row0);
        const float af1 = aff_any ? afr[j] : 0.0f;
        const float af2 = aff_any ? afr[jj2] : 0.0f;
        int k1, k2;
        float sc1, sc2;
        const unsigned hi1 = row(jc1, f1, kc1, bp1, g1, af1, &k1, &sc1);
        F.hi[j] = hi1;
        F.k[j] = k1;
        F.sc[j] = sc1;
        if (!jsame) F.jc[j] = jc1;
        topb_insert(((unsigned long long)hi1 << 32) | (unsigned)~(row0 + j),
                    top);
        if (two) {
          const unsigned hi2 = row(jc2, f2, kc2, bp2, g2, af2, &k2, &sc2);
          F.hi[j2] = hi2;
          F.k[j2] = k2;
          F.sc[j2] = sc2;
          if (!jsame) F.jc[j2] = jc2;
          topb_insert(
              ((unsigned long long)hi2 << 32) | (unsigned)~(row0 + j2), top);
        }
      }
    }
    pc.mark(PH_PASS, act);

    // 2. the merge: each warp's top TOPB and counts, then warp 0's
    unsigned long long wk[TOPB];
    int src;
#pragma unroll
    for (int q = 0; q < TOPB; ++q) wk[q] = warp_pop(top, &src);
#pragma unroll
    for (int q = 0; q < NCNT; ++q) cnt[q] = __reduce_add_sync(FULL, cnt[q]);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < TOPB; ++q) s_wkey[warp * TOPB + q] = wk[q];
#pragma unroll
      for (int q = 0; q < NCNT; ++q) s_red[warp * NCNT + q] = cnt[q];
    }
    __syncthreads();
    if (warp == 0) {
      unsigned long long t2[TOPB];
#pragma unroll
      for (int q = 0; q < TOPB; ++q) t2[q] = 0ull;
      for (int i = lane; i < NW * TOPB; i += 32) topb_insert(s_wkey[i], t2);
      unsigned long long mine = 0ull;
#pragma unroll
      for (int q = 0; q < TOPB; ++q) {
        const unsigned long long b = warp_pop(t2, &src);
        if (lane == q) mine = b;
      }
      if (lane < TOPB) post_entry<FLAT>(s_post + lane * PW, mine, F, row0);
#pragma unroll
      for (int q = 0; q < NCNT; ++q) {
        int v = 0;
        for (int w = lane; w < NW; w += 32) v += s_red[w * NCNT + q];
        v = __reduce_add_sync(FULL, v);
        if (lane == q) s_post[TOPB * PW + q] = v;
      }
      if (lane == 0) s_post[TOPB * PW + NCNT] = nvalid;
      __syncwarp();
      pc.mark_nb(PH_MERGE, act);
      xch_meet(&s_xch, xk, sh, CB, s_post);
      pc.mark_nb(PH_XCH, act);

      // 3. the decision over the CB posts (one key a lane; two past 8
      // blocks, the second from entry lane + 32)
      const int (*slots)[XW] = s_xch.slot[xk & 1];
      const int ne = CB * TOPB;
      auto entry = [&](int i) { return slots[i / TOPB] + (i % TOPB) * PW; };
      unsigned long long ck[TOPB] = {};
      if (lane < ne) ck[0] = post_key(entry(lane));
      if (lane + 32 < ne) topb_insert(post_key(entry(lane + 32)), ck);
      int win = 0;   // lane q < TOPB: the post entry of the q-th key
      unsigned long long wkey = 0ull;
#pragma unroll
      for (int q = 0; q < TOPB; ++q) {
        const unsigned long long b = warp_pop(ck, &src);
        if (lane == q) {
          win = src;
          wkey = b;
        }
      }
      if (win + 32 < ne && post_key(entry(win)) != wkey) win += 32;
      int vt[NPC];
#pragma unroll
      for (int q = 0; q < NPC; ++q)
        vt[q] = __reduce_add_sync(
            FULL, lane < CB ? slots[lane][TOPB * PW + q] : 0);
      const int filt = n - vt[NCNT];
      // lane q < nbk: the lane's q-th key and its values
      int e[PW];
#pragma unroll
      for (int q = 0; q < PW; ++q) e[q] = 0;
      if (lane < nbk) {
        const int* w = entry(win);
#pragma unroll
        for (int q = 0; q < PW; ++q) e[q] = w[q];
      }
      const bool real = (e[0] | e[1]) != 0;
      const bool feas =
          real && from_orderable((unsigned)e[0]) > HALF_NEG_INF;
      const int cap_round =
          p.spread ? max(want / max(vt[0], 1) + 1, 1) : rs;
      const int ks = feas ? min(e[3], cap_round) : 0;
      int csum = ks;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, csum, o);
        if (lane >= o) csum += y;
      }
      const int c = min(max(want - (csum - ks), 0), ks);
      const int placed = __reduce_add_sync(FULL, c);
      const int csum_b = __shfl_sync(FULL, csum, nbk - 1);
      const bool last_feas = __shfl_sync(FULL, feas, nbk - 1);
      // K6's score layout needs every rank's score: always wide
      const bool wide =
          p.sc_w > 0 || !(nbk == kk || !last_feas || csum_b >= want);
      if (lane == 0) {
        s_ctl[C_WIDE] = wide;
        s_ctl[C_VIABLE] = vt[0];
        s_ctl[C_CAP] = cap_round;
        s_ctl[C_PLACED] = placed;
        for (int q = 0; q < 4; ++q) s_ctl[C_EXH + q] = vt[1 + q];
        s_ctl[C_FILT] = filt;
      }
      if (!wide) {
        int d[4] = {0, 0, 0, 0};
        if (c > 0) {
          const int slot = (int)~(unsigned)e[1];
          if (slot / R == sh)   // this block's winner
            commit_row(F, slot - row0, c, req, rs, p.spread != 0);
          metric_delta(e + 5, e[8], c, req, dh, d);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) d[q] = __reduce_add_sync(FULL, d[q]);
        if (sh == 0) {
          const int64_t r = (int64_t)t * L + l;
          int* frow = p.fills ? p.fills + r * rs : nullptr;
          int* brow = p.buf + r * width;
          const int fq = c > 0 ? e[4] * 2048 + c : 0;
          for (int i = lane; i < rs; i += 32) {
            const int f = i < nbk ? fq : 0;   // i == lane there
            if (frow) frow[i] = f;
            if (i < p.fill_k) brow[i] = f;
          }
          int* meta = brow + p.fill_k + p.sc_w;
          const int topn = min(min(kk, TOP_K), n);
          if (lane < TOP_K) {
            const bool v = lane < topn && feas;
            meta[lane] = v ? e[4] : -1;
            meta[TOP_K + lane] = v ? e[2] : 0;
          }
          if (lane == 0) meta_tail(meta, vt[0], filt, vt + 1, d, placed);
        }
      }
      pc.mark_nb(PH_DECIDE, act);
    }
    ++xk;
    __syncthreads();
    int placed = s_ctl[C_PLACED];
    if (s_ctl[C_WIDE]) {
      // the wide path: the exact top T of the lane's keys (K6's score
      // layout: of all kk)
      const int T = p.sc_w ? kk : min(kk, want);
      // every slot of the frame among the top T: no select
      const bool all = T == nct;
      const int cap_round = s_ctl[C_CAP];
      unsigned prefix = 0;
      int krem = T;
      for (int pass = 0; pass < 4 && !all; ++pass) {
        const int shift = 24 - 8 * pass;
        const unsigned mask = pass == 0 ? 0u : (~0u << (shift + 8));
        int* h = hist + pass * 256;
        for (int i = tid; i < 256; i += NT) h[i] = 0;
        __syncthreads();
        for (int j0 = 0; j0 < nb; j0 += NT) {
          const int j = j0 + tid;
          int dg = -1;
          if (j < nb) {
            const unsigned x = F.hi[j];
            if ((x & mask) == prefix) dg = (int)((x >> shift) & 255u);
          }
          const unsigned peers = __match_any_sync(FULL, dg);
          if (dg >= 0 && lane == __ffs(peers) - 1)
            atomicAdd(&h[dg], __popc(peers));
        }
        cl.sync();   // every block's histogram of this pass
        for (int b = tid; b < 256; b += NT) {
          int s = 0;
          for (int r = 0; r < CB; ++r) s += cl.map_shared_rank(h, r)[b];
          s_tot[b] = s;
        }
        __syncthreads();
        if (warp == 0) {
          int cv[8];
          int sum = 0;
          for (int q = 0; q < 8; ++q) {
            cv[q] = s_tot[255 - (lane * 8 + q)];
            sum += cv[q];
          }
          int incl = sum;
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += y;
          }
          int acc = incl - sum;
          if (acc < krem && krem <= incl) {
            for (int q = 0; q < 8; ++q) {
              if (acc + cv[q] >= krem) {
                s_ctl[C_DIG] = 255 - (lane * 8 + q);
                s_ctl[C_ACC] = acc;
                break;
              }
              acc += cv[q];
            }
          }
        }
        __syncthreads();
        prefix |= (unsigned)s_ctl[C_DIG] << shift;
        krem -= s_ctl[C_ACC];
      }
      // keys above the threshold, and the first `quota` of this block's
      // keys at it in slot order (blocks hold consecutive slots)
      if (warp == 0 && all) {
        if (lane == 0) s_ctl[C_QUOTA] = s_ctl[C_EQ] = s_ctl[C_CNT] = 0;
      } else if (warp == 0) {
        const int bin = (int)(prefix & 255u);
        const int e = lane < CB ? cl.map_shared_rank(hist + 768, lane)[bin]
                                : 0;
        const int before = __reduce_add_sync(FULL, lane < sh ? e : 0);
        const int mine = __shfl_sync(FULL, e, sh);
        if (lane == 0) {
          s_ctl[C_QUOTA] = min(max(krem - before, 0), mine);
          s_ctl[C_EQ] = mine;
          s_ctl[C_CNT] = 0;
        }
      }
      __syncthreads();
      const int quota = s_ctl[C_QUOTA];
      const bool ordered = quota > 0 && quota < s_ctl[C_EQ];
      int tie_base = 0;
      for (int j0 = 0, it = 0; j0 < nb; j0 += NT, ++it) {
        const int j = j0 + tid;
        const unsigned x = j < nb ? F.hi[j] : 0u;
        const bool tie = j < nb && x == prefix;
        bool take = j < nb && (all || x > prefix);
        if (ordered) {
          const unsigned bal = __ballot_sync(FULL, tie);
          if (lane == 0) s_tie[it & 1][warp] = __popc(bal);
          __syncthreads();
          int pos = tie_base + __popc(bal & ((1u << lane) - 1u)), tot = 0;
          for (int w = 0; w < NW; ++w) {
            const int cw = s_tie[it & 1][w];
            pos += w < warp ? cw : 0;
            tot += cw;
          }
          take = take || (tie && pos < quota);
          tie_base += tot;
        } else {
          take = take || (tie && quota > 0);
        }
        if (take) gord[atomicAdd(&s_ctl[C_CNT], 1)] = j;
      }
      __syncthreads();
      const int sel = s_ctl[C_CNT];
      if (tid == 0) s_sel = sel;
      // this block's entries in key order (keys are unique): their keys
      // staged in its own gkey, which no peer writes before the next
      // cluster barrier, and each entry's order kept in a register
      auto key_at = [&](int j) {
        return ((unsigned long long)F.hi[j] << 32) | (unsigned)~(row0 + j);
      };
      for (int i = tid; i < sel; i += NT) gkey[i] = key_at(gord[i]);
      __syncthreads();
      int lr[KPT];
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        const int i = tid + q * NT;
        lr[q] = 0;
        if (i < sel) {
          const unsigned long long ki = gkey[i];
          for (int i2 = 0; i2 < sel; ++i2) lr[q] += gkey[i2] > ki ? 1 : 0;
        }
      }
      cl.sync();   // every block's entry count
      // block r's entries lie at [s_seg[r], s_seg[r + 1]) of every block
      if (tid == 0) {
        int o = 0;
        for (int r = 0; r < CB; ++r) {
          s_seg[r] = o;
          o += *cl.map_shared_rank(&s_sel, r);
        }
        s_seg[CB] = o;
      }
      __syncthreads();
      const int off = s_seg[sh];
      // push this block's entries, in key order, into every block
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        const int i = tid + q * NT;
        if (i >= sel) break;
        const int j = gord[i];
        const unsigned long long key = key_at(j);
        const int4 v0 = make_int4(__float_as_int(F.sc[j]), F.k[j],
                                  row_of<FLAT>(F, j, row0), F.c0[j] - F.u0[j]);
        const int4 v1 =
            make_int4(F.c1[j] - F.u1[j], F.c2[j] - F.u2[j], F.jc[j], 0);
        const int at = off + lr[q];
        for (int r = 0; r < CB; ++r) {
          cl.map_shared_rank(gkey, r)[at] = key;
          int4* dv = (int4*)(cl.map_shared_rank(gval, r) + at * GV);
          dv[0] = v0;
          dv[1] = v1;
        }
      }
      cl.sync();   // the T entries in every block
      // rank: an entry's order in its block, plus the keys above it in
      // each peer's run (a binary search), written into every block
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        if (tid + q * NT >= sel) break;
        const int at = off + lr[q];
        const unsigned long long ki = gkey[at];
        int rank = lr[q];
        for (int r = 0; r < CB; ++r) {
          if (r == sh) continue;
          int a = s_seg[r], b = s_seg[r + 1];
          const int a0 = a;
          while (a < b) {
            const int m = (a + b) >> 1;
            if (gkey[m] > ki) a = m + 1;
            else b = m;
          }
          rank += a - a0;
        }
        for (int r = 0; r < CB; ++r) cl.map_shared_rank(gord, r)[rank] = at;
      }
      cl.sync();   // every rank in every block; then water-fill, commit
      const int ch = (T + NT - 1) / NT;
      const int lo = min(T, tid * ch), hi = min(T, lo + ch);
      auto ks_at = [&](int i) {
        const int e = gord[i];
        const bool feas =
            from_orderable((unsigned)(gkey[e] >> 32)) > HALF_NEG_INF;
        return feas ? min(gval[e * GV + 1], cap_round) : 0;
      };
      int lsum = 0;
      for (int i = lo; i < hi; ++i) lsum += ks_at(i);
      int run = block_excl(lsum, s_red);
      int d[NCNT] = {0, 0, 0, 0, 0};   // placed, metric deltas
      for (int i = lo; i < hi; ++i) {
        const int ks = ks_at(i);
        const int cs = run + ks;
        const int c = min(max(want - (cs - ks), 0), ks);
        run = cs;
        gc[i] = c;
        if (c > 0) {
          const int e = gord[i];
          const int* v = gval + e * GV;
          const int slot = (int)~(unsigned)gkey[e];
          if (slot / R == sh)
            commit_row(F, slot - row0, c, req, rs, p.spread != 0);
          int dm[4];
          metric_delta(v + 3, v[6], c, req, dh, dm);
          d[0] += c;
          for (int q = 0; q < 4; ++q) d[1 + q] += dm[q];
        }
      }
      block_sums<NCNT>(d, s_red);
      if (sh == 0) {
        const int64_t r = (int64_t)t * L + l;
        int* frow = p.fills ? p.fills + r * rs : nullptr;
        int* brow = p.buf + r * width;
        // K6's scores: each rank's (NEG_INF where infeasible, and past kk)
        int* sblk = brow + p.fill_k;
        for (int i = tid; i < rs; i += NT) {
          const int f = i < T && gc[i] > 0
                            ? gval[gord[i] * GV + 2] * 2048 + gc[i]
                            : 0;
          if (frow) frow[i] = f;
          if (i < p.fill_k) brow[i] = f;
          if (i < p.sc_w) {
            const int e = i < T ? gord[i] : 0;
            sblk[i] = i < T && from_orderable((unsigned)(gkey[e] >> 32)) >
                                   HALF_NEG_INF
                          ? gval[e * GV]
                          : __float_as_int(NEG_INF);
          }
        }
        int* meta = brow + p.fill_k + p.sc_w;
        const int topn = min(min(kk, TOP_K), n);
        if (tid < TOP_K) {
          const int e = gord[tid];
          const bool v =
              tid < topn &&
              from_orderable((unsigned)(gkey[e] >> 32)) > HALF_NEG_INF;
          meta[tid] = v ? gval[e * GV + 2] : -1;
          meta[TOP_K + tid] = v ? gval[e * GV] : 0;
        }
        if (tid == 0)
          meta_tail(meta, s_ctl[C_VIABLE], s_ctl[C_FILT], s_ctl + C_EXH,
                    d + 1, d[0]);
      }
      placed = d[0];
      __syncthreads();   // the row complete before a memo copies it
      pc.mark(PH_WIDE, act);
    }
    placed_prev = placed;
    pc.step(act);
  }

  // the frame's usage back to its rows (frames are disjoint; K3 writes
  // every row, and its last step's job counts)
  for (int j = tid; j < nb; j += NT)
    if (FLAT || (F.fl[j] & F_VALID)) {
      const int64_t r = row_of<FLAT>(F, j, row0);
      p.used_out[3 * r] = F.u0[j];
      p.used_out[3 * r + 1] = F.u1[j];
      p.used_out[3 * r + 2] = F.u2[j];
      if (FLAT) p.jc_out[r] = F.jc[j];
    }
  cl.sync();   // no block leaves while a peer may read its memory
  pc.finish(p.prof);
}

// The dynamic shared memory every instantiation can take on the current
// card: its opt-in per block less the largest static shared memory
// (found once per device).
int smem_room(long long* room) {
  static long long rooms[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && rooms[dev] > 0) {
    *room = rooms[dev];
    return 0;
  }
  void (*kerns[])(Params) = {
      compact_kernel<false, true, false>, compact_kernel<true, true, false>,
      compact_kernel<false, false, false>, compact_kernel<true, false, false>,
      compact_kernel<false, true, true>, compact_kernel<true, true, true>,
      compact_kernel<false, false, true>, compact_kernel<true, false, true>};
  size_t st = 0;
  for (auto k : kerns) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, k);
    if (e != cudaSuccess) return (int)e;
    st = fa.sharedSizeBytes > st ? fa.sharedSizeBytes : st;
  }
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  *room = (long long)optin - (long long)st;
  if (dev < 64) rooms[dev] = *room;
  return 0;
}

// The blocks of a lane and the frame slots of each.  K12 (S > 1): one
// block per shard.  Else at least MIN_ROWS slots a block, at most
// XCH_BLOCKS blocks, the last holding the remainder.  A K3 frame that
// does not fit in the shared memory of XCH_BLOCKS blocks takes up to
// MAX_CB blocks where that makes it fit; any other frame that does not
// fit stays on XCH_BLOCKS blocks with its state in global scratch.
struct Plan {
  int cb, rows;
  long long fixed, frame;
  bool fits;
};

Plan split(int nct, int c, bool flat, long long fixed, long long room) {
  Plan q;
  q.rows = (nct + c - 1) / c;
  q.cb = (nct + q.rows - 1) / q.rows;
  q.fixed = fixed;
  q.frame = frame_size(q.rows, flat);
  q.fits = fixed + q.frame <= room;
  return q;
}

int plan(int nc, int shards, int rs, bool flat, Plan* q) {
  long long room = 0;
  const int e = smem_room(&room);
  if (e) return e;
  const int nct = nc * shards;
  const long long fixed = dyn_layout(rs < nct ? rs : nct).frame;
  if (shards > 1) {
    *q = split(nct, shards, flat, fixed, room);
    return 0;
  }
  const int want = (nct + MIN_ROWS - 1) / MIN_ROWS;
  *q = split(nct, want < 1 ? 1 : want > XCH_BLOCKS ? XCH_BLOCKS : want, flat,
             fixed, room);
  if (!q->fits && flat) {
    const Plan w = split(nct, want > MAX_CB ? MAX_CB : want, flat, fixed,
                         room);
    if (w.fits) *q = w;
  }
  return 0;
}

// `p.frame_glob` is the wrapper's scratch (multi_compact_scratch_bytes),
// used only when the frame state does not fit in shared memory
template <bool PROF, bool FLAT>
int launch(Params p, cudaStream_t stream) {
  if (p.rs > MAX_RS || p.rs < 1 || p.nc < 1 || p.n_lanes < 1 ||
      p.fill_k < 1 || p.fill_k > p.rs || p.shards < 1 ||
      p.shards > XCH_BLOCKS ||
      (FLAT && (p.n_lanes != 1 || p.shards != 1 || p.nc != p.n ||
                !p.jc_out)) ||
      (p.sc_w && (p.sc_w != p.rs || p.fill_k != p.rs || p.fills)) ||
      (!p.round_g && (!FLAT || p.p_real < 0)))
    return (int)cudaErrorInvalidValue;
  Plan q;
  int e = plan(p.nc, p.shards, p.rs, FLAT, &q);
  if (e) return e;
  long long room = 0;
  e = smem_room(&room);
  if (e) return e;
  if (q.fixed > room || (!q.fits && !p.frame_glob))
    return (int)cudaErrorInvalidValue;
  p.cb = q.cb;
  p.rows = q.rows;
  p.frame_bytes = q.frame;
  if (q.fits)
    return launch_clusters(compact_kernel<PROF, true, FLAT>,
                           p.n_lanes * q.cb, q.cb,
                           (size_t)(q.fixed + q.frame), stream, p);
  return launch_clusters(compact_kernel<PROF, false, FLAT>, p.n_lanes * q.cb,
                         q.cb, (size_t)q.fixed, stream, p);
}

// The probe of the rounds' exchange: `rounds` meetings of `cluster`
// blocks (xch_meet of an XW-word post, one warp a block), each post
// depending on the last.
__global__ void __launch_bounds__(32, 1) exchange_kernel(int rounds,
                                                         int* sink) {
  __shared__ __align__(16) XchT<XW, MAX_CB> s_xch;
  __shared__ __align__(16) int s_post[XW];
  const int cb = (int)cg::this_cluster().num_blocks();
  const int sh = (int)cg::this_cluster().block_rank();
  const int lane = threadIdx.x;
  xch_init(&s_xch, cb);
  cg::this_cluster().sync();
  int v = lane;
  for (int r = 0; r < rounds; ++r) {
    for (int w = lane; w < XW; w += 32) s_post[w] = v + r;
    __syncwarp();
    xch_meet(&s_xch, r, sh, cb, s_post);
    v += s_xch.slot[r & 1][lane % cb][lane % XW] & 1;
    __syncwarp();
  }
  cg::this_cluster().sync();
  if (v == 0x7fffffff) *sink = v;
}

// the kernels' 10^x (libm_pow10f) over an array
__global__ void pow10_kernel(const float* __restrict__ x,
                             float* __restrict__ y, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = libm_pow10f(x[i]);
}

// `rounds` dependent block-wide barriers in one block of PROBE_BS
// threads, each round a shared-memory write and a read across warps
constexpr int PROBE_BS = 1024;
__global__ void __launch_bounds__(PROBE_BS, 1) barrier_kernel(int rounds,
                                                              int* sink) {
  __shared__ int s[PROBE_BS];
  int v = threadIdx.x;
  for (int i = 0; i < rounds; ++i) {
    s[threadIdx.x] = v;
    __syncthreads();
    v += s[(threadIdx.x + 32 * (i + 1)) & (PROBE_BS - 1)];
    __syncthreads();
  }
  if (v == 0x7fffffff) *sink = v;
}

}  // namespace

#define COMPACT_ARGS                                                       \
  const int *cap, const int *used_in, int *used_out, const int *cand_rows, \
      const uint8_t *cand_valid, const float *aff_land, const int *aff,    \
      const int *req, const int *desired, const int *dh_limit,             \
      const int *g_aff, const int *g_job, const long long *seed,           \
      const int *job_count0, const int *round_g, const int *round_want,    \
      int *buf_small, int *fills_full, int n, int n_lanes, int nc, int ua, \
      int n_aff, int n_steps, int spread, int rs, int fill_k,              \
      unsigned char *scratch

static Params params(COMPACT_ARGS) {
  Params p{};
  p.cap = cap; p.used_in = used_in; p.used_out = used_out;
  p.cand_rows = cand_rows; p.cand_valid = cand_valid;
  p.aff_land = aff_land; p.aff = aff; p.req = req; p.desired = desired;
  p.dh_limit = dh_limit; p.g_aff = g_aff; p.g_job = g_job; p.seed = seed;
  p.job_count0 = job_count0; p.round_g = round_g; p.round_want = round_want;
  p.buf = buf_small; p.fills = fills_full;
  p.n = n; p.n_lanes = n_lanes; p.nc = nc; p.ua = ua; p.n_aff = n_aff;
  p.n_steps = n_steps; p.spread = spread; p.rs = rs; p.fill_k = fill_k;
  p.shards = 1; p.n_jrows = 0;
  p.frame_glob = scratch;
  return p;
}

#define COMPACT_PARAMS                                                      \
  params(cap, used_in, used_out, cand_rows, cand_valid, aff_land, aff,     \
         req, desired, dh_limit, g_aff, g_job, seed, job_count0, round_g,  \
         round_want, buf_small, fills_full, n, n_lanes, nc, ua, n_aff,     \
         n_steps, spread, rs, fill_k, scratch)

// K3: usage read from `used_in` [N, 3] and written to `used` [N, 3]
// (every row; the same buffer for the chained form, updated in place),
// buf [R, rs + 16], the last step's job counts jc [N]
#define FLAT_ARGS                                                          \
  const int *cap, const int *used_in, int *used, const uint8_t *static_u, \
      const float *aff_land, const int *aff, const int *req,               \
      const int *desired, const int *dh_limit, const int *g_static,        \
      const int *g_aff, const int *g_job, const long long *seed,           \
      const int *job_count0, const int *round_g, const int *round_want,    \
      int *buf, int *jc, int n, int ua, int n_aff, int n_rounds,           \
      int spread, int rs, unsigned char *scratch

static Params flat_params(FLAT_ARGS) {
  Params p{};
  p.cap = cap; p.used_in = used_in; p.used_out = used;
  p.static_u = static_u;
  p.aff_land = aff_land; p.aff = aff; p.req = req; p.desired = desired;
  p.dh_limit = dh_limit; p.g_static = g_static; p.g_aff = g_aff;
  p.g_job = g_job; p.seed = seed; p.job_count0 = job_count0;
  p.round_g = round_g; p.round_want = round_want; p.buf = buf;
  p.jc_out = jc;
  p.n = n; p.n_lanes = 1; p.nc = n; p.ua = ua; p.n_aff = n_aff;
  p.n_steps = n_rounds; p.spread = spread; p.rs = rs; p.fill_k = rs;
  p.shards = 1; p.n_jrows = 0;
  p.frame_glob = scratch;
  return p;
}

#define FLAT_PARAMS                                                         \
  flat_params(cap, used_in, used, static_u, aff_land, aff, req, desired,   \
              dh_limit, g_static, g_aff, g_job, seed, job_count0, round_g, \
              round_want, buf, jc, n, ua, n_aff, n_rounds, spread, rs,     \
              scratch)

// K6: the flat mode at one group.  static_row [N] (K8's, with the
// group's device mask ANDed in), aff_row [N] (K1's), aff [Af, 4],
// req [3], desired and dh_limit [1] of the group; job_count0 [N]; the
// rounds' demands from p_real; buf [R, rs + 16] (full layout), [R, 2 rs
// + 16] (with_scores) or [R, fill_k + 16] with fills [R, rs] (compact).
#define BULK_ARGS                                                          \
  const int *cap, const int *used_in, int *used, const uint8_t *static_row, \
      const float *aff_row, const int *aff, const int *req,                \
      const int *desired, const int *dh_limit, const int *job_count0,      \
      int *buf, int *fills, int *jc, int n,                                \
      int n_aff, int n_rounds, int spread, int rs, int fill_k,             \
      int with_scores, int p_real, unsigned seed, unsigned char *scratch

static Params bulk_params(BULK_ARGS) {
  Params p = flat_params(cap, used_in, used, static_row, aff_row, aff, req,
                         desired, dh_limit, nullptr, nullptr, nullptr,
                         nullptr, job_count0, nullptr, nullptr, buf, jc, n,
                         1, n_aff, n_rounds, spread, rs, scratch);
  p.fills = fills;
  p.fill_k = fill_k;
  p.sc_w = with_scores ? rs : 0;
  p.p_real = p_real;
  p.seed0 = seed;
  return p;
}

#define BULK_PARAMS                                                         \
  bulk_params(cap, used_in, used, static_row, aff_row, aff, req, desired,   \
              dh_limit, job_count0, buf, fills, jc, n, n_aff,              \
              n_rounds, spread, rs, fill_k, with_scores, p_real, seed,     \
              scratch)

// The plan of a launch as host functions: the bytes of global scratch it
// needs (the frame state, when it does not fit in shared memory; 0 when
// it needs none, -1 when too large), and its blocks a lane.  `nc` frame
// slots a shard, `n_shards` shards (1: K2, K3), `flat`: K3's frame.
extern "C" int multi_compact_scratch_bytes(int n_lanes, int nc, int rs,
                                           int n_shards, int flat) {
  if (n_lanes < 1 || nc < 1 || rs < 1 || n_shards < 1) return -1;
  Plan q;
  if (plan(nc, n_shards, rs, flat != 0, &q) != 0) return -1;
  if (q.fits) return 0;
  const long long b = (long long)n_lanes * q.cb * q.frame;
  return b > 0x7fffffffll ? -1 : (int)b;
}

extern "C" int multi_compact_blocks(int nc, int rs, int n_shards,
                                    int flat) {
  Plan q;
  if (nc < 1 || rs < 1 || n_shards < 1 ||
      plan(nc, n_shards, rs, flat != 0, &q) != 0)
    return 0;
  return q.cb;
}

// K2: frames [L, nc], seeds [J', nc]
extern "C" int multi_compact(COMPACT_ARGS, cudaStream_t stream) {
  return launch<false, false>(COMPACT_PARAMS, stream);
}

// The PROF instantiations: the same rounds, with block 0's phase split
// (NPH phases) written to prof [2 NPH + 4].  Never on the main path.
extern "C" int multi_compact_prof(COMPACT_ARGS, long long* prof,
                                  cudaStream_t stream) {
  if (!prof) return (int)cudaErrorInvalidValue;
  Params p = COMPACT_PARAMS;
  p.prof = prof;
  return launch<true, false>(p, stream);
}

// K12: frames [S, L, nc] (nc = Nc_loc), seeds [S, n_jrows, nc], affinity
// [S, L, Ua, nc]; one cluster of S blocks a lane
extern "C" int multi_compact_sharded(COMPACT_ARGS, int n_shards,
                                     int n_jrows, cudaStream_t stream) {
  Params p = COMPACT_PARAMS;
  p.shards = n_shards;
  p.n_jrows = n_jrows;
  return launch<false, false>(p, stream);
}

extern "C" int multi_compact_sharded_prof(COMPACT_ARGS, int n_shards,
                                          int n_jrows, long long* prof,
                                          cudaStream_t stream) {
  if (!prof) return (int)cudaErrorInvalidValue;
  Params p = COMPACT_PARAMS;
  p.shards = n_shards;
  p.n_jrows = n_jrows;
  p.prof = prof;
  return launch<true, false>(p, stream);
}

extern "C" int multi_flat(FLAT_ARGS, cudaStream_t stream) {
  return launch<false, true>(FLAT_PARAMS, stream);
}

extern "C" int multi_flat_prof(FLAT_ARGS, long long* prof,
                               cudaStream_t stream) {
  if (!prof) return (int)cudaErrorInvalidValue;
  Params p = FLAT_PARAMS;
  p.prof = prof;
  return launch<true, true>(p, stream);
}

// K11: the flat rounds over npad = n rows that n_shards shards hold in
// order (shard s rows [s n / n_shards, (s + 1) n / n_shards)).  The
// shard-major union of the shards' top lists is the top over all rows in
// row order, so K11 is K3 over the npad rows.
extern "C" int multi_flat_sharded(FLAT_ARGS, int n_shards,
                                  cudaStream_t stream) {
  if (n_shards < 1 || n_shards > XCH_BLOCKS || n % n_shards != 0)
    return (int)cudaErrorInvalidValue;
  return launch<false, true>(FLAT_PARAMS, stream);
}

// K6 (csrc comment at the top: K3's flat mode at one group)
extern "C" int multi_bulk(BULK_ARGS, cudaStream_t stream) {
  return launch<false, true>(BULK_PARAMS, stream);
}

extern "C" int multi_bulk_prof(BULK_ARGS, long long* prof,
                               cudaStream_t stream) {
  if (!prof) return (int)cudaErrorInvalidValue;
  Params p = BULK_PARAMS;
  p.prof = prof;
  return launch<true, true>(p, stream);
}

// K10: K6 over npad = n rows that n_shards shards hold in order, as K11
// is K3 over them
extern "C" int multi_bulk_sharded(BULK_ARGS, int n_shards,
                                  cudaStream_t stream) {
  if (n_shards < 1 || n_shards > XCH_BLOCKS || n % n_shards != 0)
    return (int)cudaErrorInvalidValue;
  return launch<false, true>(BULK_PARAMS, stream);
}

// The kernels' 10^x over an array, to hold it against the C library's
// powf; the placement path never calls it.
extern "C" int pow10_f32(const float* x, float* y, long long n,
                         cudaStream_t stream) {
  if (n > 0)
    pow10_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(x, y, n);
  return (int)cudaGetLastError();
}

// Probe of the cost of one barrier round (2 * rounds __syncthreads in a
// block of 1,024 threads), to price the kernels' sequential depth; the
// placement path never calls it.
extern "C" int barrier_probe(int rounds, int* sink, cudaStream_t stream) {
  barrier_kernel<<<1, PROBE_BS, 0, stream>>>(rounds, sink);
  return (int)cudaGetLastError();
}

// Probe of the cost of one exchange of the rounds at `cluster` blocks
// (up to 16); the placement path never calls it.
extern "C" int compact_exchange_probe(int rounds, int cluster, int* sink,
                                      cudaStream_t stream) {
  if (cluster < 1 || cluster > MAX_CB) return (int)cudaErrorInvalidValue;
  return launch_clusters_nt(exchange_kernel, cluster, cluster, 32, 0,
                            stream, rounds, sink);
}

PY_LAUNCHERS(compact_rounds,
             PY_LAUNCHER(multi_compact_scratch_bytes),
             PY_LAUNCHER(multi_compact_blocks),
             PY_LAUNCHER(multi_compact),
             PY_LAUNCHER(multi_compact_prof),
             PY_LAUNCHER(multi_compact_sharded),
             PY_LAUNCHER(multi_compact_sharded_prof),
             PY_LAUNCHER(multi_flat),
             PY_LAUNCHER(multi_flat_prof),
             PY_LAUNCHER(multi_flat_sharded),
             PY_LAUNCHER(multi_bulk),
             PY_LAUNCHER(multi_bulk_prof),
             PY_LAUNCHER(multi_bulk_sharded),
             PY_LAUNCHER(pow10_f32),
             PY_LAUNCHER(barrier_probe),
             PY_LAUNCHER(compact_exchange_probe))
