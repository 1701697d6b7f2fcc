// K2 "multi_compact" and K3 "multi_flat": the batched multi-eval
// water-fill rounds, one persistent launch per wave.  K6 "multi_bulk":
// one eval's homogeneous batch in rounds, the K3 machinery at one group.
//
// Replaces (TPU side, jax.jit): nomad_tpu/ops/select.py:836
// place_multi_compact_packed (+ :1006 place_multi_compact_chained) for K2,
// :733 place_multi_packed (+ :997 place_multi_chained) for K3 and :554
// place_bulk_packed (_bulk_scan :517, _bulk_step :460, _bulk_static
// :505; place_bulk :615) for K6, with their shared round core
// round_scores_g (:342), waterfill_round (:413), round_metrics_g (:393),
// tiebreak_noise (:43) and pack_round_buffer (:531).
//
// What bounds it on the H100: sequential depth, not bytes or operations.
// A wave is T dependent steps (rounds of one lane must see the previous
// round's commits): 128 steps of a ~10,240-row frame per lane for the
// north-star zoned wave, 64 rounds over 50,000 rows for the flat wave.
// The bytes a wave must move are a few MB and its arithmetic under a
// billion operations (microseconds either way); what costs is that each
// step is a chain of block-wide passes (score pass, 8 radix-select
// passes, a sort of the selected rows, a scan, the commit, the metrics
// pass), each waiting on the one before, and that each pass walks the
// whole frame with one block.
//
// Design: one thread block of 1024 threads per lane, for the whole wave
// (K2: L blocks, one per disjoint signature frame; K3: one block whose
// frame is every node, whose static row comes from K1's [U, N] output).
// K6 is K3 with one group, every round of it, and the bulk kernel's three
// output layouts (full, with a score block, compact prefix plus full
// fills).  The lane's frame state (usage, job counts, intake, scores, selection
// keys) lives in global scratch that stays L2-resident; selection state
// lives in shared memory.  Per step the block
//   1. scores every frame row (intake k_i, binpack/anti-affinity/affinity
//      rank chain, normalised exactly as the reference orders it),
//   2. caps intake for the spread algorithm and builds 64-bit selection
//      keys (score + tie-break noise, then the row index, so the order is
//      score descending and index ascending among ties, as
//      jax.lax.top_k orders them),
//   3. finds the top min(round_size, frame) keys by an 8-pass MSB radix
//      select with warp-aggregated shared-memory histograms, gathers them
//      and bitonic-sorts them in shared memory,
//   4. water-fills them with a block scan (cumsum) to `want` placements,
//   5. commits usage and job counts, then counts post-commit exhaustion,
//   6. writes its row of the packed output (fills row*2048+count and the
//      16-word meta block, layout byte-identical to pack_round_buffer).
// At the end K2 scatters each lane's usage slice back to its cluster rows
// (frames are disjoint, so lanes never write the same row).  Floor
// division of negative free capacity is done explicitly (C `/`
// truncates).  10^x is not the device powf, which differs from the C
// library's powf in the last bit for some exponents: `libm_pow10f`
// follows the C library's algorithm step for step in double precision,
// so scores (and hence picks) agree to the bit with the reference, whose
// XLA CPU pow is the C library's powf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 1024;            // threads per block (one lane)
constexpr int MAX_RS = 1024;        // select.py asserts round_size <= 1024
constexpr int TOP_K = 3;
constexpr int META = 16;

#include "score_common.cuh"

struct Params {
  const int* cap;            // [N, 3]
  const int* used_in;        // K2: [N, 3] start usage
  int* used;                 // K2: [N, 3] output; K3: state and output
  int n;
  const int* cand_rows;      // K2: [L, nc] frame rows (padding = n)
  const uint8_t* cand_valid; // K2: [L, nc]
  const uint8_t* static_u;   // K3: [U, N] from K1
  const float* aff_land;     // K2: [L, Ua, nc]; K3: [Ua, N]
  const int* aff;            // [Ua, Af, 4]
  int ua, n_aff;
  const int* req;            // [G, 3]
  const int* desired;        // [G]
  const int* dh_limit;       // [G]
  const int* g_static;       // [G] (K3)
  const int* g_aff;          // [G]
  const int* g_job;          // [G]
  const long long* seed;     // [G], uint32 values
  const int* job_count0;     // K2: [J', nc]; K3: [G, N]
  const int* round_g;        // K2: [T * L] step-major; K3: [R]
  const int* round_want;
  int n_steps, n_lanes, nc, spread, rs, fill_k;
  int out_mode;              // K3/K6 layout: 0 full, 1 + scores, 2 compact
  int* used_c;               // K2 scratch [L, nc, 3]
  int* jc;                   // [L, nc] current job counts (K3: output)
  int* ki;                   // [L, nc] intake
  float* score;              // [L, nc]
  unsigned* keyb;            // [L, nc] orderable key bits
  int* buf;                  // K2: [T*L, fill_k + 16]; K3: [R, rs + 16];
                             // K6: [R, rs + 16 | 2 rs + 16 | fill_k + 16]
  int* fills;                // K2: [T*L, rs]; K6 compact: [R, rs]
};

// round_scores_g for one row: intake k_i and the normalised rank score
__device__ __forceinline__ void intake_score(
    const int* c, const int* u, const int* r, int rs, int dh, int jcount,
    bool st, int desired, float af, bool aff_any, bool spread, int* k_out,
    float* sc_out) {
  int f0 = c[0] - u[0], f1 = c[1] - u[1], f2 = c[2] - u[2];
  int p0 = r[0] > 0 ? floordiv(f0, r[0]) : rs;
  int p1 = r[1] > 0 ? floordiv(f1, r[1]) : rs;
  int p2 = r[2] > 0 ? floordiv(f2, r[2]) : rs;
  int k = min(min(p0, p1), p2);
  k = min(max(k, 0), rs);
  if (f0 < 0 || f1 < 0 || f2 < 0) k = 0;
  if (dh > 0) k = min(k, min(max(dh - jcount, 0), rs));
  if (!st) k = 0;
  *k_out = k;

  float cf0 = (float)c[0], cf1 = (float)c[1];
  float tu0 = (float)u[0] + (float)r[0];
  float tu1 = (float)u[1] + (float)r[1];
  float fr0 = 1.0f - fminf(tu0 / fmaxf(cf0, 1.0f), 1.0f);
  float fr1 = 1.0f - fminf(tu1 / fmaxf(cf1, 1.0f), 1.0f);
  float total = libm_pow10f(fr0) + libm_pow10f(fr1);
  float s = spread ? total - 2.0f : 20.0f - total;
  s = fminf(fmaxf(s, 0.0f), 18.0f);
  // `/ 18.0` in the reference, which XLA compiles as a multiply by the
  // f32 reciprocal: the scores must agree to the bit
  float bp = ((cf0 > 0.0f && cf1 > 0.0f) ? s : 0.0f) * INV18;
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

__device__ __forceinline__ unsigned long long composite(const unsigned* keyb,
                                                        int j) {
  // key bits high, inverted index low: descending composite order is
  // key descending, then index ascending
  return ((unsigned long long)keyb[j] << 32) | (unsigned)(~j);
}

template <bool COMPACT>
__global__ void __launch_bounds__(BS, 1) rounds_kernel(Params p) {
  __shared__ unsigned long long s_sel[MAX_RS];
  __shared__ int s_j[MAX_RS];
  __shared__ int s_c[MAX_RS];
  __shared__ float s_sc[MAX_RS];
  __shared__ int s_hist[256];
  __shared__ int s_red[33];
  __shared__ int s_misc[4];

  const int tid = threadIdx.x;
  const int lane_id = tid & 31, warp = tid >> 5;
  const int l = COMPACT ? blockIdx.x : 0;
  const int nc = p.nc;
  const int64_t base = (int64_t)l * nc;
  int* used_state = COMPACT ? p.used_c + base * 3 : p.used;
  int* jc = p.jc + base;
  int* ki = p.ki + base;
  float* score = p.score + base;
  unsigned* keyb = p.keyb + base;
  const int* crow = COMPACT ? p.cand_rows + base : nullptr;
  const uint8_t* cval = COMPACT ? p.cand_valid + base : nullptr;
  const int n_iter = (nc + BS - 1) / BS;   // uniform trip count
  const int kk = min(p.rs, nc);
  int sortp = 1;
  while (sortp < kk) sortp <<= 1;

  int cand_n = 0;
  if (COMPACT) {
    // gather the lane's frame; padding rows start empty (they are never
    // static, so nothing reads their usage into an output)
    int cnt = 0;
    for (int it = 0; it < n_iter; ++it) {
      int j = it * BS + tid;
      if (j < nc) {
        bool valid = cval[j] != 0;
        int row = crow[j];
        for (int d = 0; d < 3; ++d)
          used_state[(int64_t)j * 3 + d] =
              valid ? p.used_in[(int64_t)row * 3 + d] : 0;
        cnt += valid ? 1 : 0;
      }
    }
    cand_n = block_sum(cnt, s_red);
  }

  for (int t = 0; t < p.n_steps; ++t) {
    const int rr = COMPACT ? t * p.n_lanes + l : t;
    const int g = p.round_g[rr];
    const int want = p.round_want[rr];
    bool same;
    if (COMPACT)
      same = t > 0 && p.round_g[rr - p.n_lanes] == g;
    else
      same = t > 0 && p.g_job[p.round_g[t - 1]] == p.g_job[g];
    int req[3] = {p.req[3 * g], p.req[3 * g + 1], p.req[3 * g + 2]};
    const int desired = p.desired[g];
    const int dh = p.dh_limit[g];
    const int a = p.g_aff[g];
    const unsigned sd = (unsigned)(p.seed[g] & 0xffffffffll);
    bool aff_any = false;
    for (int q = 0; q < p.n_aff; ++q)
      aff_any |= p.aff[((int64_t)a * p.n_aff + q) * 4 + 3] != 0;
    const float* aff_row =
        COMPACT ? p.aff_land + ((int64_t)l * p.ua + a) * nc
                : p.aff_land + (int64_t)a * nc;
    const uint8_t* stat_row =
        COMPACT ? cval : p.static_u + (int64_t)p.g_static[g] * nc;
    const int* jc0 = p.job_count0 + (int64_t)p.g_job[g] * nc;

    // 1. job counts, intake, rank score
    int viable = 0, n_static = 0;
    for (int it = 0; it < n_iter; ++it) {
      int j = it * BS + tid;
      if (j < nc) {
        int jcount = same ? jc[j] : jc0[j];
        jc[j] = jcount;
        bool st = stat_row[j] != 0;
        int row = COMPACT ? min(crow[j], p.n - 1) : j;
        int c[3] = {p.cap[(int64_t)row * 3], p.cap[(int64_t)row * 3 + 1],
                    p.cap[(int64_t)row * 3 + 2]};
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
    if (!COMPACT) n_static = block_sum(n_static, s_red);
    const int cap_round =
        p.spread ? max(want / max(viable, 1) + 1, 1) : p.rs;

    // 2. per-round intake cap and selection keys
    int n_feas = 0;
    for (int it = 0; it < n_iter; ++it) {
      int j = it * BS + tid;
      if (j < nc) {
        int kr = min(ki[j], cap_round);
        ki[j] = kr;
        unsigned grow = COMPACT ? (unsigned)crow[j] : (unsigned)j;
        float key = (kr > 0 ? score[j] : NEG_INF) + tiebreak_noise(sd, grow);
        keyb[j] = orderable(key);
        n_feas += kr > 0 ? 1 : 0;
      }
    }
    n_feas = block_sum(n_feas, s_red);

    // 3a. radix select: the kk-th largest composite key
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
        if (j < nc) {
          unsigned long long comp = composite(keyb, j);
          if ((comp & hi_mask) == prefix) d = (int)((comp >> shift) & 255);
        }
        unsigned peers = __match_any_sync(FULL, d);
        if (d >= 0 && lane_id == __ffs(peers) - 1)
          atomicAdd(&s_hist[d], __popc(peers));
      }
      __syncthreads();
      if (warp == 0) {
        int cnt[8];
        int s = 0;
        for (int q = 0; q < 8; ++q) {
          cnt[q] = s_hist[255 - (lane_id * 8 + q)];
          s += cnt[q];
        }
        int incl = s;
        for (int o = 1; o < 32; o <<= 1) {
          int y = __shfl_up_sync(FULL, incl, o);
          if (lane_id >= o) incl += y;
        }
        int acc = incl - s;
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

    // 3b. gather the kk keys >= the threshold (keys are unique), sort
    if (tid == 0) s_misc[2] = 0;
    __syncthreads();
    for (int it = 0; it < n_iter; ++it) {
      int j = it * BS + tid;
      unsigned long long comp = 0;
      bool take = false;
      if (j < nc) {
        comp = composite(keyb, j);
        take = comp >= prefix;
      }
      unsigned b = __ballot_sync(FULL, take);
      int pos = 0;
      if (lane_id == 0 && b) pos = atomicAdd(&s_misc[2], __popc(b));
      pos = __shfl_sync(FULL, pos, 0);
      if (take) s_sel[pos + __popc(b & ((1u << lane_id) - 1u))] = comp;
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

    // 4. water-fill the sorted prefix up to `want`
    int ks = 0, jsel = 0;
    float scs = NEG_INF;
    if (tid < kk) {
      unsigned long long comp = s_sel[tid];
      jsel = (int)(~(unsigned)(comp & 0xffffffffull));
      float key = from_orderable((unsigned)(comp >> 32));
      scs = key > HALF_NEG_INF ? score[jsel] : NEG_INF;
      ks = scs > HALF_NEG_INF ? ki[jsel] : 0;
    }
    const int csum = block_scan(ks, s_red);
    const int c = min(max(want - (csum - ks), 0), ks);
    s_j[tid] = jsel;
    s_c[tid] = c;
    s_sc[tid] = scs;
    const int placed = block_sum(c, s_red);

    // 5. commit, then post-commit exhaustion metrics
    if (tid < kk && c > 0) {
      int* us = used_state + (int64_t)jsel * 3;
      us[0] += c * req[0];
      us[1] += c * req[1];
      us[2] += c * req[2];
      jc[jsel] += c;
    }
    __syncthreads();
    int n_exh = 0, dx0 = 0, dx1 = 0, dx2 = 0;
    for (int it = 0; it < n_iter; ++it) {
      int j = it * BS + tid;
      if (j < nc && stat_row[j] != 0) {
        int row = COMPACT ? crow[j] : j;
        const int* u = used_state + (int64_t)j * 3;
        int f0 = p.cap[(int64_t)row * 3] - u[0];
        int f1 = p.cap[(int64_t)row * 3 + 1] - u[1];
        int f2 = p.cap[(int64_t)row * 3 + 2] - u[2];
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
    n_exh = block_sum(n_exh, s_red);
    dx0 = block_sum(dx0, s_red);
    dx1 = block_sum(dx1, s_red);
    dx2 = block_sum(dx2, s_red);

    // 6. this round's packed output row
    int* meta;
    if (COMPACT) {
      const int64_t r = (int64_t)t * p.n_lanes + l;
      int* frow = p.fills + r * p.rs;
      int* brow = p.buf + r * (p.fill_k + META);
      for (int i = tid; i < p.rs; i += BS) {
        int f = (i < kk && s_c[i] > 0) ? crow[s_j[i]] * 2048 + s_c[i] : 0;
        frow[i] = f;
        if (i < p.fill_k) brow[i] = f;
      }
      meta = brow + p.fill_k;
    } else {
      const int width = p.out_mode == 2 ? p.fill_k + META
                        : (p.out_mode == 1 ? 2 * p.rs : p.rs) + META;
      int* brow = p.buf + (int64_t)t * width;
      for (int i = tid; i < p.rs; i += BS) {
        int f = (i < kk && s_c[i] > 0) ? s_j[i] * 2048 + s_c[i] : 0;
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
      meta = brow + width - META;
    }
    if (tid == 0) {
      const int topn = min(min(kk, TOP_K), p.n);
      for (int q = 0; q < TOP_K; ++q) {
        bool v = q < topn && s_sc[q] > HALF_NEG_INF;
        meta[q] = v ? (COMPACT ? crow[s_j[q]] : s_j[q]) : -1;
        meta[TOP_K + q] = v ? __float_as_int(s_sc[q]) : 0;
      }
      meta[6] = n_feas;
      meta[7] = COMPACT ? p.n - cand_n : nc - n_static;
      meta[8] = n_exh;
      meta[9] = dx0;
      meta[10] = dx1;
      meta[11] = dx2;
      meta[12] = placed;
      meta[13] = 0;
      meta[14] = 0;
      meta[15] = 0;
    }
    __syncthreads();
  }

  if (COMPACT) {
    // scatter the lane's usage slice back to its cluster rows
    for (int it = 0; it < n_iter; ++it) {
      int j = it * BS + tid;
      if (j < nc && cval[j] != 0) {
        int row = crow[j];
        for (int d = 0; d < 3; ++d)
          p.used[(int64_t)row * 3 + d] = used_state[(int64_t)j * 3 + d];
      }
    }
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

extern "C" int multi_compact(
    const int* cap, const int* used_in, int* used_out, const int* cand_rows,
    const uint8_t* cand_valid, const float* aff_land, const int* aff,
    const int* req, const int* desired, const int* dh_limit,
    const int* g_aff, const int* g_job, const long long* seed,
    const int* job_count0, const int* round_g, const int* round_want,
    int* buf_small, int* fills_full, int n, int n_lanes, int nc, int ua,
    int n_aff, int n_steps, int spread, int rs, int fill_k, int* used_c,
    int* jc, int* ki, float* score, unsigned* keyb, cudaStream_t stream) {
  if (rs > MAX_RS || rs < 1) return (int)cudaErrorInvalidValue;
  Params p{};
  p.cap = cap; p.used_in = used_in; p.used = used_out; p.n = n;
  p.cand_rows = cand_rows; p.cand_valid = cand_valid;
  p.aff_land = aff_land; p.aff = aff; p.ua = ua; p.n_aff = n_aff;
  p.req = req; p.desired = desired; p.dh_limit = dh_limit;
  p.g_aff = g_aff; p.g_job = g_job; p.seed = seed;
  p.job_count0 = job_count0; p.round_g = round_g; p.round_want = round_want;
  p.n_steps = n_steps; p.n_lanes = n_lanes; p.nc = nc; p.spread = spread;
  p.rs = rs; p.fill_k = fill_k;
  p.used_c = used_c; p.jc = jc; p.ki = ki; p.score = score; p.keyb = keyb;
  p.buf = buf_small; p.fills = fills_full;
  rounds_kernel<true><<<n_lanes, BS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int multi_flat(
    const int* cap, int* used, const uint8_t* static_u, const float* aff_land,
    const int* aff, const int* req, const int* desired, const int* dh_limit,
    const int* g_static, const int* g_aff, const int* g_job,
    const long long* seed, const int* job_count0, const int* round_g,
    const int* round_want, int* buf, int n, int ua, int n_aff, int n_rounds,
    int spread, int rs, int* jc, int* ki, float* score, unsigned* keyb,
    cudaStream_t stream) {
  if (rs > MAX_RS || rs < 1) return (int)cudaErrorInvalidValue;
  Params p{};
  p.cap = cap; p.used = used; p.n = n;
  p.static_u = static_u; p.aff_land = aff_land; p.aff = aff; p.ua = ua;
  p.n_aff = n_aff; p.req = req; p.desired = desired; p.dh_limit = dh_limit;
  p.g_static = g_static; p.g_aff = g_aff; p.g_job = g_job; p.seed = seed;
  p.job_count0 = job_count0; p.round_g = round_g; p.round_want = round_want;
  p.n_steps = n_rounds; p.n_lanes = 1; p.nc = n; p.spread = spread;
  p.rs = rs; p.fill_k = 0;
  p.jc = jc; p.ki = ki; p.score = score; p.keyb = keyb; p.buf = buf;
  rounds_kernel<false><<<1, BS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int multi_bulk(
    const int* cap, int* used, const uint8_t* static_u, const float* aff_land,
    const int* aff, const int* req, const int* desired, const int* dh_limit,
    const int* g_ix, const long long* seed, const int* job_count0,
    const int* round_g, const int* round_want, int* buf, int n, int ua,
    int n_aff, int n_rounds, int spread, int rs, int out_mode, int fill_k,
    int* fills, int* jc, int* ki, float* score, unsigned* keyb,
    cudaStream_t stream) {
  if (rs > MAX_RS || rs < 1 || out_mode < 0 || out_mode > 2 ||
      (out_mode == 2 && (fill_k < 1 || fill_k > rs || fills == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.cap = cap; p.used = used; p.n = n;
  p.static_u = static_u; p.aff_land = aff_land; p.aff = aff; p.ua = ua;
  p.n_aff = n_aff; p.req = req; p.desired = desired; p.dh_limit = dh_limit;
  p.g_static = g_ix; p.g_aff = g_ix; p.g_job = g_ix; p.seed = seed;
  p.job_count0 = job_count0; p.round_g = round_g; p.round_want = round_want;
  p.n_steps = n_rounds; p.n_lanes = 1; p.nc = n; p.spread = spread;
  p.rs = rs; p.fill_k = fill_k; p.out_mode = out_mode;
  p.jc = jc; p.ki = ki; p.score = score; p.keyb = keyb; p.buf = buf;
  p.fills = fills;
  rounds_kernel<false><<<1, BS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}
