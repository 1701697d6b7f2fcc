// K4 "scatter_add": replay of the packer's usage delta log onto the
// device-resident usage tensor, `used[rows] += vals`, rows may repeat.
//
// Replaces (TPU side, jax.jit): nomad_tpu/ops/engine.py:50
// _scatter_add_jit, as PlacementEngine._used_device (:612) calls it in
// chunks of SCATTER_CHUNK = 16,384 rows.
//
// What bounds it on the H100: bytes.  A chunk reads M row ids and M x 3
// values and read-modify-writes M x 3 words of `used` [N, 3] int32: about
// 40 bytes a row, under 1 MB a chunk, so one launch is a few
// microseconds of memory time, and launch latency dominates.
//
// Design: one thread per (row, dimension) with an int32 atomicAdd.
// Integer atomics commute, so repeated rows sum exactly and the result is
// independent of the order the threads run in.  Rows outside [0, N) are
// dropped; the engine replays only rows of its node table.
//
// K13 "scatter_add_sharded": the same replay onto the node-sharded usage
// [npad, 3] of a mesh on one card.  Replaces (TPU side, jax.jit with a
// node-sharded output): nomad_tpu/ops/engine.py:96-101
// _sharded_fn(mesh, "scatter").  The same body, launched as S groups of
// blocks, one per shard: group s walks the whole chunk and applies only
// the rows [s n_loc, (s+1) n_loc) it owns, as each device of the mesh
// applies its own rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// block group blockIdx.x / per_group applies the rows it owns,
// [group * n_own, (group + 1) * n_own)
__global__ void scatter_add_kernel(int* __restrict__ used, int n_own,
                                   const int* __restrict__ rows,
                                   const int* __restrict__ vals, int m,
                                   int per_group) {
  const int group = blockIdx.x / per_group;
  const int i = (blockIdx.x % per_group) * blockDim.x + threadIdx.x;
  if (i >= 3 * m) return;
  const int r = rows[i / 3];
  if (r < group * n_own || r >= (group + 1) * n_own) return;
  atomicAdd(used + (int64_t)r * 3 + i % 3, vals[i]);
}

int run(int* used, int n, const int* rows, const int* vals, int m,
        int groups, cudaStream_t stream) {
  if (groups < 1 || n % groups != 0) return (int)cudaErrorInvalidValue;
  const int per_group = (3 * m + 255) / 256;
  if (per_group > 0)
    scatter_add_kernel<<<per_group * groups, 256, 0, stream>>>(
        used, n / groups, rows, vals, m, per_group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int scatter_add(int* used, int n, const int* rows,
                           const int* vals, int m, cudaStream_t stream) {
  return run(used, n, rows, vals, m, 1, stream);
}

// K13: used [npad, 3] in n_shards shards of npad / n_shards rows
extern "C" int scatter_add_sharded(int* used, int npad, const int* rows,
                                   const int* vals, int m, int n_shards,
                                   cudaStream_t stream) {
  return run(used, npad, rows, vals, m, n_shards, stream);
}
