// K1 "landscape": the static constraint and affinity landscapes of a
// multi-eval wave and of the solo kernels' statics.
// K8 "feasible_mask": the [G, N] static feasibility of one eval.
//
// Replaces (TPU side, jax.jit): K1 nomad_tpu/ops/feasibility.py:29
// constraint_mask (with the host-side _cpu_mask_jit,
// nomad_tpu/ops/engine.py:220) and nomad_tpu/ops/scoring.py:66
// affinity_score / :79 constraint_mask_rows; K8
// nomad_tpu/ops/feasibility.py:75 feasible_mask_jit at its call sites
// nomad_tpu/ops/engine.py:1114 (preemption fallback) and
// nomad_tpu/scheduler/system.py:132 (system scheduler).
//
// What bounds it on the H100: bytes, and far below them the latency of
// a few dependent loads and the launch.  Each output element reads C
// (or Af) attribute words of one node row plus as many LUT bytes; at the
// north-star shape (U = 5 signatures, C = 4 rows, N = 50,000 nodes) the
// pass reads the [N, A] attribute table and writes U N bytes, well under
// a microsecond of memory time, and a call's host path (checks,
// allocation, launch) takes several times its device time.
//
// Design (K1), chosen from a measured split of the call: of a mask or
// affinity call's ~20-25 us on the host clock, two thirds are the
// wrapper's Python and 3 us the launch; the device takes 2-6 us.  So the
// flat path's two landscapes of the same rows go out in one launch (grid
// rows [0, U) the mask, [U, U + Ua) the affinity), the wrappers check
// their inputs in one pass, and the engine folds the eager ops around
// the call (the refuted-node row is ANDed in here as `node_ok`).  On the
// device, one thread per (signature row, node) with an early exit:
// 50,000 nodes and 5 signatures fill the card with 250,000 threads.
// Three alternatives measured slower at that shape on an H100 and were
// dropped (PERF.md, section 6): one thread per node over every signature
// (7.2 against 5.4 us), the same with the block's attribute rows tiled
// in shared memory (11.8 us), and each thread loading the attribute
// words of eight predicate rows, then their LUT bytes, together,
// without an early exit (6.0 us).  Each output row is written
// coalesced; frames of row ids clamp out of range ids as a JAX gather
// clamps them.
//
// K8 is K1's mask pass through its own entry (`feasible_mask`, counted
// on its own kernel by the wrapper): the datacenter row is the one base
// row, the pool row is `node_ok`, and a null group map sends every group
// to base row 0, so its wrapper builds nothing on the device and takes
// K1's one-pass checks.

#include "py_launchers.cuh"  // first: it includes Python.h
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNSET = -1;
constexpr int DOP_EQ = 1;
constexpr int DOP_NEQ = 2;
constexpr int DOP_IS_SET = 3;
constexpr int DOP_IS_NOT_SET = 4;
constexpr int DOP_LUT = 5;

constexpr int NT = 256;   // threads a block

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// One packed predicate row (col, op, arg) against one node's attribute
// row; `other` is the value of any other opcode (padding rows).
__device__ __forceinline__ bool predicate(const int* __restrict__ arow,
                                          int n_attr, const int* row,
                                          const uint8_t* __restrict__ luts,
                                          int n_lut, int n_vocab,
                                          bool other) {
  int col = clampi(row[0], 0, n_attr - 1);
  int op = row[1];
  int arg = row[2];
  int av = arow[col];
  bool is_set = av != UNSET;
  switch (op) {
    case DOP_EQ: return is_set && av == arg;
    case DOP_NEQ: return !is_set || av != arg;
    case DOP_IS_SET: return is_set;
    case DOP_IS_NOT_SET: return !is_set;
    case DOP_LUT: {
      int r = clampi(arg, 0, n_lut - 1);
      int c = clampi(av, 0, n_vocab - 1);
      return is_set && luts[(int64_t)r * n_vocab + c] != 0;
    }
    default: return other;
  }
}

// `ok` and every constraint row of one signature (crow [C, 3]) at one node
__device__ __forceinline__ bool mask_at(const int* __restrict__ arow,
                                        int n_attr, const int* crow,
                                        int n_con,
                                        const uint8_t* __restrict__ luts,
                                        int n_lut, int n_vocab, bool ok) {
  for (int c = 0; c < n_con && ok; ++c)
    ok = predicate(arow, n_attr, crow + 3 * c, luts, n_lut, n_vocab, true);
  return ok;
}

// ------------------------------------------------------------- K1 pass

struct Params {
  const int* attrs;          // [N, A]
  int n, n_attr;
  const uint8_t* luts;       // [L, V]
  int n_lut, n_vocab;
  // the mask (n_sig = 0: none)
  const int* con;            // [U, C, 3]
  int n_sig, n_con;
  const uint8_t* elig;       // [N]
  const uint8_t* base;       // [M, N]
  const int* u_mask;         // [U] -> base row, or null (every row 0)
  const uint8_t* node_ok;    // [N] or null
  uint8_t* mask_out;         // [U, N]
  // the affinity (ua = 0: none)
  const int* aff;            // [Ua, Af, 4]
  int ua, n_aff;
  const int* rows;           // [Lr, Nc] frame rows, or null (Nc = N)
  int nc;
  float* aff_out;            // [Lr, Ua, Nc]
};

// Grid row y of frame set y / (U + Ua): y % (U + Ua) < U is signature
// u's mask row, the rest affinity signature a's row.
__global__ void __launch_bounds__(NT) landscape_kernel(Params p) {
  const int j = blockIdx.x * NT + threadIdx.x;
  const int per_set = p.n_sig + p.ua;
  const int set = blockIdx.y / per_set;
  const int y = blockIdx.y - set * per_set;
  if (j >= p.nc) return;
  const int node =
      p.rows ? clampi(p.rows[(int64_t)set * p.nc + j], 0, p.n - 1) : j;
  const int* __restrict__ arow = p.attrs + (int64_t)node * p.n_attr;

  if (y < p.n_sig) {
    const int u = y;
    const bool ok = p.elig[node] != 0 &&
                    (p.node_ok == nullptr || p.node_ok[node] != 0) &&
                    p.base[(int64_t)(p.u_mask ? p.u_mask[u] : 0) * p.n +
                           node] != 0;
    p.mask_out[(int64_t)u * p.n + node] =
        mask_at(arow, p.n_attr, p.con + (int64_t)u * p.n_con * 3, p.n_con,
                p.luts, p.n_lut, p.n_vocab, ok);
    return;
  }
  const int a = y - p.n_sig;
  const int* arows = p.aff + (int64_t)a * p.n_aff * 4;
  float got = 0.0f, total = 0.0f;
  for (int q = 0; q < p.n_aff; ++q) {
    float w = (float)arows[4 * q + 3];
    total += fabsf(w);
    bool m = predicate(arow, p.n_attr, arows + 4 * q, p.luts, p.n_lut,
                       p.n_vocab, false);
    got += (m ? 1.0f : 0.0f) * w;   // integer-valued: exact in any order
  }
  p.aff_out[((int64_t)set * p.ua + a) * p.nc + j] =
      total > 0.0f ? got / fmaxf(total, 1.0f) : 0.0f;
}

int launch(const Params& p, int n_sets, cudaStream_t stream) {
  if (p.n_attr < 1 || p.n_lut < 1 || p.n_vocab < 1 || p.n < 0 || p.nc < 0 ||
      n_sets < 0 || p.n_sig < 0 || p.n_con < 0 || p.ua < 0 || p.n_aff < 0)
    return (int)cudaErrorInvalidValue;
  const long long ys = (long long)n_sets * (p.n_sig + p.ua);
  if (ys > 65535) return (int)cudaErrorInvalidValue;
  // nothing to compute: no launch
  if (p.n == 0 || p.nc == 0 || ys == 0) return (int)cudaSuccess;
  dim3 grid((p.nc + NT - 1) / NT, (unsigned)ys);
  landscape_kernel<<<grid, NT, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

Params base_params(const int* attrs, int n, int n_attr, const uint8_t* luts,
                   int n_lut, int n_vocab) {
  Params p{};
  p.attrs = attrs; p.n = n; p.n_attr = n_attr;
  p.luts = luts; p.n_lut = n_lut; p.n_vocab = n_vocab;
  p.nc = n;
  return p;
}

void mask_params(Params* p, const int* con, int n_sig, int n_con,
                 const uint8_t* elig, const uint8_t* base,
                 const int* u_mask, const uint8_t* node_ok, uint8_t* out) {
  p->con = con; p->n_sig = n_sig; p->n_con = n_con;
  p->elig = elig; p->base = base; p->u_mask = u_mask;
  p->node_ok = node_ok; p->mask_out = out;
}

}  // namespace

// K1's mask: out [n_sig, n] = constraint_mask & elig & node_ok (null:
// every row) & base[u_mask]
extern "C" int landscape_mask(const int* attrs, int n, int n_attr,
                              const int* con, int n_sig, int n_con,
                              const uint8_t* luts, int n_lut, int n_vocab,
                              const uint8_t* elig, const uint8_t* base,
                              const int* u_mask, const uint8_t* node_ok,
                              uint8_t* out, cudaStream_t stream) {
  Params p = base_params(attrs, n, n_attr, luts, n_lut, n_vocab);
  mask_params(&p, con, n_sig, n_con, elig, base, u_mask, node_ok, out);
  return launch(p, 1, stream);
}

// K1's affinity: out[(set * ua + a) * nc + j], signature a's affinity at
// node rows[set][j] (or node j when rows is null, nc = n)
extern "C" int landscape_affinity(const int* attrs, int n, int n_attr,
                                  const int* rows, int n_sets, int nc,
                                  const int* aff, int ua, int n_aff,
                                  const uint8_t* luts, int n_lut,
                                  int n_vocab, float* out,
                                  cudaStream_t stream) {
  Params p = base_params(attrs, n, n_attr, luts, n_lut, n_vocab);
  if (rows == nullptr && (n_sets != 1 || nc != n))
    return (int)cudaErrorInvalidValue;
  p.rows = rows; p.nc = nc;
  p.aff = aff; p.ua = ua; p.n_aff = n_aff; p.aff_out = out;
  return launch(p, n_sets, stream);
}

// K1's two landscapes of the same n rows in one launch: the mask as
// landscape_mask's, the affinity [ua, n] as landscape_affinity's
extern "C" int landscape_pair(const int* attrs, int n, int n_attr,
                              const int* con, int n_sig, int n_con,
                              const uint8_t* luts, int n_lut, int n_vocab,
                              const uint8_t* elig, const uint8_t* base,
                              const int* u_mask, const uint8_t* node_ok,
                              uint8_t* mask_out, const int* aff, int ua,
                              int n_aff, float* aff_out,
                              cudaStream_t stream) {
  Params p = base_params(attrs, n, n_attr, luts, n_lut, n_vocab);
  mask_params(&p, con, n_sig, n_con, elig, base, u_mask, node_ok, mask_out);
  p.aff = aff; p.ua = ua; p.n_aff = n_aff; p.aff_out = aff_out;
  return launch(p, 1, stream);
}

// K8: out [n_groups, n] = constraint_mask & elig & pool & dc, K1's mask
// pass with `dc` [n] the one base row and `pool` [n] the node_ok row
extern "C" int feasible_mask(const int* attrs, int n, int n_attr,
                             const int* con, int n_groups, int n_con,
                             const uint8_t* luts, int n_lut, int n_vocab,
                             const uint8_t* elig, const uint8_t* dc,
                             const uint8_t* pool, uint8_t* out,
                             cudaStream_t stream) {
  Params p = base_params(attrs, n, n_attr, luts, n_lut, n_vocab);
  mask_params(&p, con, n_groups, n_con, elig, dc, nullptr, pool, out);
  return launch(p, 1, stream);
}

PY_LAUNCHERS(landscape,
             PY_LAUNCHER(landscape_mask),
             PY_LAUNCHER(landscape_affinity),
             PY_LAUNCHER(landscape_pair),
             PY_LAUNCHER(feasible_mask))
