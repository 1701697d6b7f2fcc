// K1 "landscape": the static constraint and affinity landscapes of a
// multi-eval wave and of the solo kernels' statics.
// K8 "feasible_mask": the [G, N] static feasibility of one eval, through
// the same mask pass.
//
// Replaces (TPU side, jax.jit): K1 nomad_tpu/ops/feasibility.py:29
// constraint_mask (with the host-side _cpu_mask_jit,
// nomad_tpu/ops/engine.py:220) and nomad_tpu/ops/scoring.py:66
// affinity_score / :79 constraint_mask_rows; K8
// nomad_tpu/ops/feasibility.py:75 feasible_mask_jit at its call sites
// nomad_tpu/ops/engine.py:1114 (preemption fallback) and
// nomad_tpu/scheduler/system.py:132 (system scheduler).
//
// What bounds it on the H100: bytes.  Each output element reads C (or Af)
// attribute words of one node row plus as many LUT bytes, and does a
// handful of integer compares per row; at the north-star shape (U = 5
// signatures, C <= 8 rows, N = 50,000 nodes) the pass reads the [N, A]
// attribute table once per signature from L2 and writes U*N bytes, a few
// microseconds of memory time against no arithmetic to speak of.
//
// Design: one thread per (signature, node).  Consecutive threads take
// consecutive nodes, so the output row is written coalesced; the
// attribute table (a few MB) and the LUT matrix stay L2-resident across
// the signatures.  The mask entry fuses the reference's
// `constraint_mask & elig & base_mask[u_mask]`; the affinity entry
// optionally reads nodes through a frame of row ids (the compact kernel's
// per-lane candidate frames), clamping out-of-range ids as a JAX gather
// does.

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

__global__ void mask_kernel(const int* __restrict__ attrs, int n, int n_attr,
                            const int* __restrict__ con, int n_con,
                            const uint8_t* __restrict__ luts, int n_lut,
                            int n_vocab, const uint8_t* __restrict__ elig,
                            const uint8_t* __restrict__ base,
                            const int* __restrict__ u_mask,
                            uint8_t* __restrict__ out) {
  int node = blockIdx.x * blockDim.x + threadIdx.x;
  int u = blockIdx.y;
  if (node >= n) return;
  const int* arow = attrs + (int64_t)node * n_attr;
  bool ok = elig[node] != 0 && base[(int64_t)u_mask[u] * n + node] != 0;
  const int* crow = con + (int64_t)u * n_con * 3;
  for (int c = 0; c < n_con && ok; ++c)
    ok = predicate(arow, n_attr, crow + 3 * c, luts, n_lut, n_vocab, true);
  out[(int64_t)u * n + node] = ok;
}

// out[(set * ua + a) * nc + j]: signature a's affinity at node
// rows[set][j] (or node j when rows is null).
__global__ void affinity_kernel(const int* __restrict__ attrs, int n,
                                int n_attr, const int* __restrict__ rows,
                                int nc, const int* __restrict__ aff, int ua,
                                int n_aff, const uint8_t* __restrict__ luts,
                                int n_lut, int n_vocab,
                                float* __restrict__ out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  int set = blockIdx.y / ua;
  int a = blockIdx.y % ua;
  if (j >= nc) return;
  int node = rows ? clampi(rows[(int64_t)set * nc + j], 0, n - 1) : j;
  const int* arow = attrs + (int64_t)node * n_attr;
  const int* arows = aff + (int64_t)a * n_aff * 4;
  float got = 0.0f, total = 0.0f;
  for (int q = 0; q < n_aff; ++q) {
    float w = (float)arows[4 * q + 3];
    total += fabsf(w);
    bool m = predicate(arow, n_attr, arows + 4 * q, luts, n_lut, n_vocab,
                       false);
    got += (m ? 1.0f : 0.0f) * w;   // integer-valued: exact in any order
  }
  out[((int64_t)set * ua + a) * nc + j] =
      total > 0.0f ? got / fmaxf(total, 1.0f) : 0.0f;
}

}  // namespace

extern "C" int landscape_mask(const int* attrs, int n, int n_attr,
                              const int* con, int n_sig, int n_con,
                              const uint8_t* luts, int n_lut, int n_vocab,
                              const uint8_t* elig, const uint8_t* base,
                              const int* u_mask, uint8_t* out,
                              cudaStream_t stream) {
  dim3 grid((n + 255) / 256, n_sig);
  mask_kernel<<<grid, 256, 0, stream>>>(attrs, n, n_attr, con, n_con, luts,
                                        n_lut, n_vocab, elig, base, u_mask,
                                        out);
  return (int)cudaGetLastError();
}

extern "C" int landscape_affinity(const int* attrs, int n, int n_attr,
                                  const int* rows, int n_sets, int nc,
                                  const int* aff, int ua, int n_aff,
                                  const uint8_t* luts, int n_lut,
                                  int n_vocab, float* out,
                                  cudaStream_t stream) {
  dim3 grid((nc + 255) / 256, n_sets * ua);
  affinity_kernel<<<grid, 256, 0, stream>>>(attrs, n, n_attr, rows, nc, aff,
                                            ua, n_aff, luts, n_lut, n_vocab,
                                            out);
  return (int)cudaGetLastError();
}

// K8: the same mask pass; the wrapper passes one base row
// `dc & pool` and maps every group to it
extern "C" int feasible_mask(const int* attrs, int n, int n_attr,
                             const int* con, int n_groups, int n_con,
                             const uint8_t* luts, int n_lut, int n_vocab,
                             const uint8_t* elig, const uint8_t* base,
                             const int* u_mask, uint8_t* out,
                             cudaStream_t stream) {
  dim3 grid((n + 255) / 256, n_groups);
  mask_kernel<<<grid, 256, 0, stream>>>(attrs, n, n_attr, con, n_con, luts,
                                        n_lut, n_vocab, elig, base, u_mask,
                                        out);
  return (int)cudaGetLastError();
}

PY_LAUNCHERS(landscape,
             PY_LAUNCHER(landscape_mask),
             PY_LAUNCHER(landscape_affinity),
             PY_LAUNCHER(feasible_mask))
