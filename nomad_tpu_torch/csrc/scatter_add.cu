// K4 "scatter_add": replay of the packer's usage delta log onto the
// device-resident usage tensor, `used[rows] += vals` in place.
//
// Replaces (TPU side, jax.jit): nomad_tpu/ops/engine.py:50
// _scatter_add_jit, `u.at[r].add(v)`, as PlacementEngine._used_device
// calls it in chunks of SCATTER_CHUNK = 16,384 rows.
//
// Rows index as in the reference (JAX indexes like numpy): for a table
// of N rows, a row r in [-N, 0) adds to row r + N, a row below -N or at
// N and above is dropped, and repeated rows sum.
//
// K13 "scatter_add_sharded": the same replay onto the node-sharded usage
// [npad, 3] of a mesh on one card, N = npad (the padded global table, as
// the reference's jit with a node-sharded output indexes it).  Replaces
// (TPU side, jax.jit with a node-sharded output):
// nomad_tpu/ops/engine.py:96-101 _sharded_fn(mesh, "scatter").  On one
// card the S shards are one contiguous tensor: a row's address is the
// same whichever shard owns it, so K13 runs K4's one pass over the
// chunk and keeps no owner test.  On a mesh across parts
// (parallel/xmesh.py), where each part holds only its own rows
// [row_off, row_off + n) of the npad rows, K13 runs one launch a part
// over the whole chunk (`scatter_add_xmesh`): each thread wraps its row
// as above against npad and keeps it only where this part owns it,
// rebased onto the part's rows.
//
// What bounds it on the H100: neither bytes nor operations, but a
// launch's own latency.  A 16,384-row chunk moves 64 KB of row ids,
// 192 KB of deltas and read-modify-writes 192 KB of `used`: about
// 0.196 us at 3.35 TB/s (K4); the mesh flat wave's replay of a few
// hundred rows bounds K13 at 0.0027 us.  Both lie far under the few
// microseconds a launch takes from host to device and back, so no
// kernel of this size comes near half of its bound; the design keeps
// the device body to one short pass and the host's launch path lean
// (ops/kernels.py).
//
// Design: one thread per delta row, one grid over the m rows, for both
// entries.  A thread reads its row id once, wraps it, tests the range,
// reads its three deltas (consecutive: a warp reads 384 contiguous
// bytes) and issues three atomicAdds whose result it never reads, which
// nvcc emits as fire-and-forget reductions (RED.E.ADD).  Integer adds
// commute, so the result is exact and independent of the order the
// threads run in, however many rows repeat.

#include "py_launchers.cuh"  // first: it includes Python.h
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// n the table's rows; across parts, npad the rows of all parts and
// row_off this part's first (else npad = n, row_off = 0)
__global__ void scatter_add_kernel(int* __restrict__ used, int n,
                                   const int* __restrict__ rows,
                                   const int* __restrict__ vals, int m,
                                   int npad, int row_off) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  int r = __ldg(rows + i);
  if (r < 0) r += npad;                    // [-npad, 0) wraps
  r -= row_off;                            // onto this part's rows
  if ((unsigned)r >= (unsigned)n) return;  // another part's, or dropped
  const int* v = vals + (int64_t)i * 3;
  int* u = used + (int64_t)r * 3;
  const int v0 = __ldg(v), v1 = __ldg(v + 1), v2 = __ldg(v + 2);
  atomicAdd(u, v0);
  atomicAdd(u + 1, v1);
  atomicAdd(u + 2, v2);
}

int run(int* used, int n, const int* rows, const int* vals, int m,
        cudaStream_t stream, int npad = -1, int row_off = 0) {
  if (npad < 0) npad = n;
  if (n < 0 || m < 0 || row_off < 0 || row_off + n > npad)
    return (int)cudaErrorInvalidValue;
  if (m > 0)
    scatter_add_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(used, n, rows, vals, m, npad, row_off);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int scatter_add(int* used, int n, const int* rows,
                           const int* vals, int m, cudaStream_t stream) {
  return run(used, n, rows, vals, m, stream);
}

// K13: used [npad, 3] in n_shards shards of npad / n_shards rows
extern "C" int scatter_add_sharded(int* used, int npad, const int* rows,
                                   const int* vals, int m, int n_shards,
                                   cudaStream_t stream) {
  if (n_shards < 1 || npad % n_shards != 0)
    return (int)cudaErrorInvalidValue;
  return run(used, npad, rows, vals, m, stream);
}

// K13 across parts: this part's used [n, 3] (rows [part n, (part + 1) n)
// of the npad = n n_parts rows), the chunk's rows indexing all npad
extern "C" int scatter_add_xmesh(int* used, int n, const int* rows,
                                 const int* vals, int m, int part,
                                 int n_parts, cudaStream_t stream) {
  if (n_parts < 2 || part < 0 || part >= n_parts)
    return (int)cudaErrorInvalidValue;
  return run(used, n, rows, vals, m, stream, n * n_parts, part * n);
}

PY_LAUNCHERS(scatter_add,
             PY_LAUNCHER(scatter_add),
             PY_LAUNCHER(scatter_add_sharded),
             PY_LAUNCHER(scatter_add_xmesh))
