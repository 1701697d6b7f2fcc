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
// (parallel/xmesh.py), where part q holds only its own rows
// [q n, (q + 1) n) of the npad rows in a tensor of its own, K13 runs
// one launch a distinct card over the whole chunk (`scatter_add_xmesh`):
// the launch takes the used tensors of every part that card holds
// (null for the others), and each thread wraps its row as above against
// npad, finds the owning part q = r / n and adds only where that part
// lies on this card.  Its rows and deltas may lie in mapped pinned host
// memory (the engine's replay chunk, straight from the host): the loads
// are plain ones, valid on host and device memory alike.
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
// Design: one thread per delta row, one grid over the m rows, for every
// entry.  A thread reads its row id once, wraps it, tests the range,
// reads its three deltas (consecutive: a warp reads 384 contiguous
// bytes) and issues three atomicAdds whose result it never reads, which
// nvcc emits as fire-and-forget reductions (RED.E.ADD).  Integer adds
// commute, so the result is exact and independent of the order the
// threads run in, however many rows repeat.

#include "py_launchers.cuh"  // first: it includes Python.h
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

// K4, K13 on one card: n the table's rows
__global__ void scatter_add_kernel(int* __restrict__ used, int n,
                                   const int* __restrict__ rows,
                                   const int* __restrict__ vals, int m) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  int r = __ldg(rows + i);
  if (r < 0) r += n;                       // [-n, 0) wraps
  if ((unsigned)r >= (unsigned)n) return;  // dropped
  const int* v = vals + (int64_t)i * 3;
  int* u = used + (int64_t)r * 3;
  const int v0 = __ldg(v), v1 = __ldg(v + 1), v2 = __ldg(v + 2);
  atomicAdd(u, v0);
  atomicAdd(u + 1, v1);
  atomicAdd(u + 2, v2);
}

// K13 across parts: the used tensors of the parts on this card, by part
constexpr int MAX_PARTS = 8;
struct PartRows {
  int* used[MAX_PARTS];
};

__global__ void scatter_add_parts_kernel(PartRows pr, int n, int n_parts,
                                         const int* rows, const int* vals,
                                         int m, unsigned* count, int* done,
                                         int seq) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int npad = n * n_parts;
  // the row and its deltas read at once (over PCIe from a host chunk:
  // one round trip, not two)
  int r = -npad - 1, v0 = 0, v1 = 0, v2 = 0;
  if (i < m) {
    const int* v = vals + (int64_t)i * 3;
    r = rows[i];
    v0 = v[0];
    v1 = v[1];
    v2 = v[2];
  }
  if (r < 0) r += npad;                     // [-npad, 0) wraps
  if ((unsigned)r < (unsigned)npad) {       // else dropped
    const int q = r / n;
    int* u = pr.used[q];
    if (u) {                                // else a part on another card
      u += (int64_t)(r - q * n) * 3;
      atomicAdd(u, v0);
      atomicAdd(u + 1, v1);
      atomicAdd(u + 2, v2);
    }
  }
  if (!done) return;
  // a chunk staged in host memory: the last block to end tells the host
  // that every block has read it (the slot may then be reused).  The
  // count wraps to 0 in the same atomic, and every read has returned
  // before its block counts: a plain store will do.
  __syncthreads();
  if (threadIdx.x == 0 &&
      atomicInc(count, gridDim.x - 1) == gridDim.x - 1)
    asm volatile("st.relaxed.sys.b32 [%0], %1;" :: "l"(done), "r"(seq)
                 : "memory");
}

int run(int* used, int n, const int* rows, const int* vals, int m,
        cudaStream_t stream) {
  if (n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (m > 0)
    scatter_add_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(used, n, rows, vals, m);
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

// K13 across parts, one launch a card: u_q part q's used [n, 3] (rows
// [q n, (q + 1) n) of the npad = n n_parts rows) where part q lies on
// this card, else null; the chunk's rows index all npad.  With `done`
// (a word of mapped pinned host memory) the last block to end stores
// `seq` there, `count` (a zeroed word of this card's memory, zero again
// after the launch) counting the blocks: the staging slot of a chunk
// read from host memory is reused once its launches' words say so.
extern "C" int scatter_add_xmesh(int* u0, int* u1, int* u2, int* u3,
                                 int* u4, int* u5, int* u6, int* u7, int n,
                                 int n_parts, const int* rows,
                                 const int* vals, int m, unsigned* count,
                                 int* done, int seq, cudaStream_t stream) {
  const PartRows pr{{u0, u1, u2, u3, u4, u5, u6, u7}};
  if (n_parts < 2 || n_parts > MAX_PARTS || n < 1 || m < 1 ||
      (long long)n * n_parts > 0x7fffffffll || (done && !count))
    return (int)cudaErrorInvalidValue;
  for (int q = n_parts; q < MAX_PARTS; ++q)
    if (pr.used[q]) return (int)cudaErrorInvalidValue;
  scatter_add_parts_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(pr, n, n_parts, rows, vals, m, count,
                                       done, seq);
  return (int)cudaGetLastError();
}

// A replay chunk from the CPU into a slot of the staging ring in pinned
// host memory: rows [m] at stage, vals [m, 3] after them.  A host
// function.
extern "C" int xmesh_stage_chunk(int* stage, const int* rows,
                                 const int* vals, int m) {
  if (!stage || m < 0 || (m && (!rows || !vals)))
    return (int)cudaErrorInvalidValue;
  memcpy(stage, rows, sizeof(int) * (size_t)m);
  memcpy(stage + m, vals, sizeof(int) * 3 * (size_t)m);
  return 0;
}

PY_LAUNCHERS(scatter_add,
             PY_LAUNCHER(scatter_add),
             PY_LAUNCHER(scatter_add_sharded),
             PY_LAUNCHER(scatter_add_xmesh),
             PY_LAUNCHER(xmesh_stage_chunk))
