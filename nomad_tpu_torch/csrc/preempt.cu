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
// the compact victim table (config 4: 128 padded steps over 512 rows of
// one victim each).  A step reads each row's table once (A <= 32
// victims) and does a few integer and f32 adds per victim: microseconds
// of bytes and operations for the whole batch.
//
// Design: one block of 1024 threads.  Per step each thread takes its
// strided candidate rows: the first-fit prefix over the row's alive
// victims (int prefix sums, in victim order), the prefix's cost summed in
// f32 in XLA's order for a cumsum (in order up to 16 victims; for 32, two
// blocks of 16 with the first block's sum added to the second), and a
// 64-bit key (orderable cost bits, then the row) whose block minimum is
// the cheapest row, lowest row on ties as argmin orders them.  Thread 0
// consumes the chosen prefix (a 32-bit mask per row), commits usage and
// the job count, and writes the step's (row, victims) pair.  The victim
// cost (prio + 1) * 1000 + resource sum is one fma, as XLA fuses it.

#include "py_launchers.cuh"  // first: it includes Python.h
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 1024;
constexpr int NWARP = BS / 32;
constexpr int MAX_A = 32;
constexpr int SCAN_BLOCK = 16;     // XLA's blocked cumsum length
constexpr float BIG_COST = 1e30f;

#include "score_common.cuh"        // orderable / from_orderable, FULL

struct PreParams {
  const int* cap;            // [M, 3]
  int* used;                 // [M, 3] state and output (starts at used0)
  const uint8_t* stat;       // [M]
  int* jc;                   // [M] state and output (starts at job_count0)
  const int* prio;           // [M, A]
  const int* res;            // [M, A, 3]
  const int* req;            // [3]
  const int* k0;             // [M]
  int m, a, dh, n_place, n_real;
  int* best;                 // [n_place]
  int* ks;                   // [n_place]
  unsigned* consumed;        // [M] scratch: consumed-victim mask
  float* vcost;              // [M, A] scratch: per-victim cost
};

// first index k whose alive prefix frees enough, or -1
__device__ __forceinline__ int first_fit(const PreParams& p, int i,
                                         unsigned alive) {
  const int f0 = p.cap[3 * i] - p.used[3 * i];
  const int f1 = p.cap[3 * i + 1] - p.used[3 * i + 1];
  const int f2 = p.cap[3 * i + 2] - p.used[3 * i + 2];
  int g0 = 0, g1 = 0, g2 = 0;
  const int* r = p.res + (int64_t)i * p.a * 3;
  for (int v = 0; v < p.a; ++v) {
    if ((alive >> v) & 1u) {
      g0 += r[3 * v];
      g1 += r[3 * v + 1];
      g2 += r[3 * v + 2];
    }
    if (f0 + g0 >= p.req[0] && f1 + g1 >= p.req[1] && f2 + g2 >= p.req[2])
      return v;
  }
  return -1;
}

// cost prefix at k of the alive victims, summed as XLA's CPU cumsum sums
__device__ __forceinline__ float cost_at(const float* c, unsigned alive,
                                         int a, int k) {
  const int b = a > SCAN_BLOCK ? k / SCAN_BLOCK : 0;
  float carry = 0.0f;
  for (int bb = 0; bb < b; ++bb) {
    float s = 0.0f;
    for (int v = bb * SCAN_BLOCK; v < (bb + 1) * SCAN_BLOCK; ++v)
      s = s + (((alive >> v) & 1u) ? c[v] : 0.0f);
    carry = carry + s;
  }
  float local = 0.0f;
  for (int v = b * SCAN_BLOCK; v <= k; ++v)
    local = local + (((alive >> v) & 1u) ? c[v] : 0.0f);
  return a > SCAN_BLOCK ? local + carry : local;
}

__global__ void __launch_bounds__(BS, 1) preempt_kernel(PreParams p) {
  __shared__ unsigned long long s_min[NWARP];
  __shared__ unsigned long long s_best;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned all = p.a == 32 ? FULL : ((1u << p.a) - 1u);
  for (int i = tid; i < p.m; i += BS) {
    const int k0 = min(max(p.k0[i], 0), p.a);
    p.consumed[i] = k0 >= 32 ? FULL : ((1u << k0) - 1u);
    for (int v = 0; v < p.a; ++v) {
      const int* r = p.res + ((int64_t)i * p.a + v) * 3;
      const float rs = (float)(r[0] + r[1] + r[2]);
      p.vcost[(int64_t)i * p.a + v] =
          __fmaf_rn((float)p.prio[(int64_t)i * p.a + v] + 1.0f, 1000.0f, rs);
    }
  }
  __syncthreads();

  for (int t = 0; t < p.n_place; ++t) {
    unsigned long long mn = ~0ull;
    for (int i = tid; i < p.m; i += BS) {
      const unsigned alive = ~p.consumed[i] & all;
      const int k = first_fit(p, i, alive);
      const bool dh_ok = p.dh > 0 ? p.jc[i] < p.dh : true;
      float cost = BIG_COST;
      if (p.stat[i] && k >= 0 && dh_ok)
        cost = cost_at(p.vcost + (int64_t)i * p.a, alive, p.a, k);
      const unsigned long long key =
          ((unsigned long long)orderable(cost) << 32) | (unsigned)i;
      mn = key < mn ? key : mn;
    }
    for (int o = 16; o > 0; o >>= 1) {
      unsigned long long y = __shfl_xor_sync(FULL, mn, o);
      mn = y < mn ? y : mn;
    }
    if (lane == 0) s_min[warp] = mn;
    __syncthreads();
    if (warp == 0) {
      unsigned long long v = s_min[lane];
      for (int o = 16; o > 0; o >>= 1) {
        unsigned long long y = __shfl_xor_sync(FULL, v, o);
        v = y < v ? y : v;
      }
      if (lane == 0) s_best = v;
    }
    __syncthreads();
    if (tid == 0) {
      const unsigned long long key = s_best;
      const int b = (int)(key & 0xffffffffull);
      const float cost = from_orderable((unsigned)(key >> 32));
      const bool ok = cost < BIG_COST / 2 && t < p.n_real;
      int n_take = 0;
      if (ok) {
        const unsigned alive = ~p.consumed[b] & all;
        const int kb = max(first_fit(p, b, alive), 0);
        const unsigned upto = kb >= 31 ? FULL : ((2u << kb) - 1u);
        const unsigned take = alive & upto;
        n_take = __popc(take);
        p.consumed[b] |= take;
        int fr[3] = {0, 0, 0};
        const int* r = p.res + (int64_t)b * p.a * 3;
        for (int v = 0; v < p.a; ++v)
          if ((take >> v) & 1u)
            for (int q = 0; q < 3; ++q) fr[q] += r[3 * v + q];
        for (int q = 0; q < 3; ++q) p.used[3 * b + q] += p.req[q] - fr[q];
        p.jc[b] += 1;
      }
      p.best[t] = ok ? b : -1;
      p.ks[t] = ok ? n_take : 0;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int preempt_bulk(const int* cap, int* used, const uint8_t* stat,
                            int* job_count, const int* prio, const int* res,
                            const int* req, const int* k0, int m, int a,
                            int dh, int n_place, int n_real, int* best,
                            int* ks, unsigned* consumed, float* vcost,
                            cudaStream_t stream) {
  if (a < 1 || a > MAX_A || m < 1) return (int)cudaErrorInvalidValue;
  PreParams p{};
  p.cap = cap; p.used = used; p.stat = stat; p.jc = job_count;
  p.prio = prio; p.res = res; p.req = req; p.k0 = k0;
  p.m = m; p.a = a; p.dh = dh; p.n_place = n_place; p.n_real = n_real;
  p.best = best; p.ks = ks; p.consumed = consumed; p.vcost = vcost;
  preempt_kernel<<<1, BS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

PY_LAUNCHERS(preempt,
             PY_LAUNCHER(preempt_bulk))
