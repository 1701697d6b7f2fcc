// The native CUDA bridge: a flat C ABI over the port's hand-written
// placement kernels, for a worker that runs them with no Python runtime
// (reference: native/pjrt_bridge/bridge.cc, which drives a PJRT plugin).
//
// The library owns one CUDA stream on one device and every device buffer
// it hands out.  A "program" names one of the reference's jitted
// multi-eval entries plus its static arguments, and runs the same
// `extern "C"` launchers the Python bindings call (landscape.cu,
// compact_rounds.cu), on the library's stream:
//
//   place_multi_packed(round_size, spread_algo, has_node_ok)
//       K1 landscape_pair, then K3 multi_flat
//   place_multi_compact_packed(round_size, n_lanes, spread_algo)
//       K1 landscape_affinity over the frames, then K2 multi_compact
//   place_bulk_packed(round_size, n_rounds, with_scores, spread_algo, g,
//                     p_real, seed)
//       K8 feasible_mask and K1 landscape_affinity of group g, then K6
//       multi_bulk
//
// Inputs, in this order (numpy dtypes; `seed` int64 or uint32, [G] or
// 0-dim; `node_ok` only with has_node_ok):
//   multi:   attrs cap used0 elig luts base_mask con u_mask aff req desired
//            dh_limit g_static g_aff g_job job_count0 round_g round_want
//            seed [node_ok]
//   compact: the multi inputs but node_ok, then cand_rows cand_valid
//   bulk:    attrs cap used0 elig dc_mask pool_mask luts con aff req
//            desired dh_limit job_count0
// Outputs: flat (buf, used, jc), compact (buf_small, fills_full, used),
// bulk (buf, used, jc), as the Python entries return them.  Inputs are
// never written: the device work the Python wrappers do in eager torch
// has its counterpart here (the compact usage's copy, the empty-rounds
// copies, the seeds' broadcast and widening in `seed_widen`, K1's
// intermediates and the frame scratch on the stream's allocator).
//
// Error convention (the reference's): a caller-supplied `char* err,
// size_t errlen`; NULL or a negative value on failure.  Every entry makes
// the library's device current on the calling thread (and restores the
// caller's): CUDA's current device is per thread.  `ntb_fetch` is the
// synchronisation point; the rest only enqueue on the stream.
//
// Replaces no TPU kernel: its device work is the kernels', and what the
// library adds is bound by host calls (a few allocations, copies and
// launches a program).  Built by ops/kernels.py (`build_bridge`): one
// `nvcc -shared` over this file, landscape.cu and compact_rounds.cu with
// -DNTB_NO_PYTHON, so it links no libpython and no libtorch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <cstdio>
#include <mutex>
#include <string>
#include <unordered_set>
#include <vector>

// the kernels' launchers (csrc/landscape.cu, csrc/compact_rounds.cu)
extern "C" {
int landscape_affinity(const int* attrs, int n, int n_attr, const int* rows,
                       int n_sets, int nc, const int* aff, int ua, int n_aff,
                       const uint8_t* luts, int n_lut, int n_vocab,
                       float* out, cudaStream_t stream);
int landscape_pair(const int* attrs, int n, int n_attr, const int* con,
                   int n_sig, int n_con, const uint8_t* luts, int n_lut,
                   int n_vocab, const uint8_t* elig, const uint8_t* base,
                   const int* u_mask, const uint8_t* node_ok,
                   uint8_t* mask_out, const int* aff, int ua, int n_aff,
                   float* aff_out, cudaStream_t stream);
int feasible_mask(const int* attrs, int n, int n_attr, const int* con,
                  int n_groups, int n_con, const uint8_t* luts, int n_lut,
                  int n_vocab, const uint8_t* elig, const uint8_t* dc,
                  const uint8_t* pool, uint8_t* out, cudaStream_t stream);
int multi_compact_scratch_bytes(int n_lanes, int nc, int rs, int n_shards,
                                int flat);
int multi_compact(const int* cap, const int* used_in, int* used_out,
                  const int* cand_rows, const uint8_t* cand_valid,
                  const float* aff_land, const int* aff, const int* req,
                  const int* desired, const int* dh_limit, const int* g_aff,
                  const int* g_job, const long long* seed,
                  const int* job_count0, const int* round_g,
                  const int* round_want, int* buf_small, int* fills_full,
                  int n, int n_lanes, int nc, int ua, int n_aff, int n_steps,
                  int spread, int rs, int fill_k, unsigned char* scratch,
                  cudaStream_t stream);
int multi_flat(const int* cap, const int* used_in, int* used,
               const uint8_t* static_u, const float* aff_land, const int* aff,
               const int* req, const int* desired, const int* dh_limit,
               const int* g_static, const int* g_aff, const int* g_job,
               const long long* seed, const int* job_count0,
               const int* round_g, const int* round_want, int* buf, int* jc,
               int n, int ua, int n_aff, int n_rounds, int spread, int rs,
               unsigned char* scratch, cudaStream_t stream);
int multi_bulk(const int* cap, const int* used_in, int* used,
               const uint8_t* static_row, const float* aff_row,
               const int* aff, const int* req, const int* desired,
               const int* dh_limit, const int* job_count0, int* buf,
               int* fills, int* jc, int n, int n_aff, int n_rounds,
               int spread, int rs, int fill_k, int with_scores, int p_real,
               unsigned seed, unsigned char* scratch, cudaStream_t stream);
}

namespace {

// PJRT_Buffer_Type values (the reference's ABI): PRED, S8, S16, S32, S64,
// U8, U16, U32, U64, F16, F32, F64
constexpr int T_PRED = 1, T_S32 = 4, T_S64 = 5, T_U32 = 8, T_F32 = 11;

size_t elem_size(int t) {
  switch (t) {
    case 1: case 2: case 6: return 1;
    case 3: case 7: case 10: return 2;
    case 4: case 8: case 11: return 4;
    case 5: case 9: case 12: return 8;
    default: return 0;
  }
}

const char* type_name(int t) {
  switch (t) {
    case T_PRED: return "bool";
    case T_S32: return "int32";
    case T_S64: return "int64";
    case T_U32: return "uint32";
    case T_F32: return "float32";
    default: return "other";
  }
}

// the launchers a program calls, counted where it calls them
enum Launcher {
  L_PAIR, L_AFFINITY, L_FEASIBLE, L_FLAT, L_COMPACT, L_BULK, L_SEED,
  N_LAUNCHERS
};
const char* const kLauncherNames[N_LAUNCHERS] = {
    "landscape_pair", "landscape_affinity", "feasible_mask",
    "multi_flat", "multi_compact", "multi_bulk", "seed_widen"};

enum Program { P_FLAT, P_COMPACT, P_BULK, N_PROGRAMS };
const char* const kProgramNames[N_PROGRAMS] = {
    "place_multi_packed", "place_multi_compact_packed", "place_bulk_packed"};
const int kProgramStatics[N_PROGRAMS] = {3, 3, 7};
const char* const kProgramStaticNames[N_PROGRAMS] = {
    "round_size, spread_algo, has_node_ok",
    "round_size, n_lanes, spread_algo",
    "round_size, n_rounds, with_scores, spread_algo, g, p_real, seed"};

struct Buf {
  void* ptr = nullptr;
  int dtype = 0;
  std::vector<int64_t> dims;
  size_t bytes = 0;
};

struct Exec {
  int program = 0;
  int64_t st[8] = {0};
};

void set_err(char* err, size_t errlen, const std::string& msg) {
  if (err && errlen) snprintf(err, errlen, "%s", msg.c_str());
}

// true on error (message in err)
bool cuda_bad(cudaError_t e, const char* what, char* err, size_t errlen) {
  if (e == cudaSuccess) return false;
  set_err(err, errlen, std::string(what) + ": " + cudaGetErrorName(e) +
                           " (" + cudaGetErrorString(e) + ")");
  return true;
}

__global__ void seed_widen_kernel(const void* src, int is64, int bcast,
                                  long long* dst, int g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g) return;
  const int j = bcast ? 0 : i;
  dst[i] = is64 ? ((const long long*)src)[j]
                : (long long)((const unsigned*)src)[j];
}

}  // namespace

struct NtbClient {
  int device = 0;
  cudaStream_t stream = nullptr;
  // the library's own stream-ordered pool (released only at destroy)
  cudaMemPool_t pool = nullptr;
  std::mutex mu;
  std::unordered_set<Buf*> bufs;
  std::unordered_set<Exec*> execs;
  int64_t live_bytes = 0;
  std::atomic<long long> launches[N_LAUNCHERS];
};

namespace {

// the library's device current on this thread for one entry's lifetime
struct OnDevice {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit OnDevice(int dev) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
  }
  ~OnDevice() {
    int cur = -1;
    if (prev >= 0 && cudaGetDevice(&cur) == cudaSuccess && cur != prev)
      cudaSetDevice(prev);
  }
};

bool live(NtbClient* c, Buf* b) {
  std::lock_guard<std::mutex> g(c->mu);
  return c->bufs.count(b) != 0;
}

bool live_exec(NtbClient* c, Exec* x) {
  std::lock_guard<std::mutex> g(c->mu);
  return c->execs.count(x) != 0;
}

// a buffer of `dims` on the stream's allocator, owned by the client
Buf* alloc_buf(NtbClient* c, int dtype, const int64_t* dims, int ndims,
               char* err, size_t errlen) {
  const size_t es = elem_size(dtype);
  if (!es) {
    set_err(err, errlen, "unsupported buffer type " + std::to_string(dtype));
    return nullptr;
  }
  if (ndims < 0 || ndims > 8) {
    set_err(err, errlen, "buffers take 0 to 8 dims, got " +
                             std::to_string(ndims));
    return nullptr;
  }
  auto* b = new Buf();
  b->dtype = dtype;
  int64_t k = 1;
  for (int i = 0; i < ndims; i++) {
    if (dims[i] < 0) {
      delete b;
      set_err(err, errlen, "negative dim");
      return nullptr;
    }
    b->dims.push_back(dims[i]);
    k *= dims[i];
  }
  b->bytes = (size_t)k * es;
  if (cuda_bad(cudaMallocFromPoolAsync(&b->ptr, b->bytes ? b->bytes : 16,
                                       c->pool, c->stream),
               "cudaMallocFromPoolAsync", err, errlen)) {
    delete b;
    return nullptr;
  }
  std::lock_guard<std::mutex> g(c->mu);
  c->bufs.insert(b);
  c->live_bytes += (int64_t)b->bytes;
  return b;
}

Buf* alloc_like(NtbClient* c, int dtype, std::vector<int64_t> dims,
                char* err, size_t errlen) {
  return alloc_buf(c, dtype, dims.data(), (int)dims.size(), err, errlen);
}

void free_buf(NtbClient* c, Buf* b) {
  {
    std::lock_guard<std::mutex> g(c->mu);
    if (!c->bufs.erase(b)) return;
    c->live_bytes -= (int64_t)b->bytes;
  }
  cudaFreeAsync(b->ptr, c->stream);
  delete b;
}

// device memory that lives for one execute (K1's landscapes, the seeds,
// the frame scratch), released on the stream after the kernels that read
// it
struct Temps {
  NtbClient* c;
  std::vector<void*> ptrs;
  explicit Temps(NtbClient* cl) : c(cl) {}
  void* get(size_t bytes, char* err, size_t errlen) {
    void* p = nullptr;
    if (cuda_bad(cudaMallocFromPoolAsync(&p, bytes ? bytes : 16, c->pool,
                                         c->stream),
                 "cudaMallocFromPoolAsync", err, errlen))
      return nullptr;
    ptrs.push_back(p);
    return p;
  }
  ~Temps() {
    for (void* p : ptrs) cudaFreeAsync(p, c->stream);
  }
};

// ------------------------------------------------------- input checks

struct Check {
  char* err;
  size_t errlen;
  const char* program;
  bool bad = false;
  void fail(const std::string& msg) {
    if (!bad) set_err(err, errlen, std::string(program) + ": " + msg);
    bad = true;
  }
  // input `i` named `name`: type `dtype` and `ndims` dims
  const Buf* in(Buf* const* ins, int i, const char* name, int dtype,
                int ndims) {
    const Buf* b = ins[i];
    if (bad) return b;
    if (b->dtype != dtype)
      fail(std::string(name) + " (input " + std::to_string(i) + ") is " +
           type_name(b->dtype) + ", expected " + type_name(dtype));
    else if ((int)b->dims.size() != ndims)
      fail(std::string(name) + " (input " + std::to_string(i) + ") has " +
           std::to_string(b->dims.size()) + " dims, expected " +
           std::to_string(ndims));
    return b;
  }
  void dim(const Buf* b, int d, int64_t want, const char* what) {
    if (!bad && b->dims[d] != want)
      fail(std::string(what) + ": dim " + std::to_string(d) + " is " +
           std::to_string(b->dims[d]) + ", expected " + std::to_string(want));
  }
};

template <class T>
T* P(const Buf* b) {
  return static_cast<T*>(b->ptr);
}

bool launched(NtbClient* c, int rc, Launcher l, char* err, size_t errlen) {
  if (rc != 0) {
    set_err(err, errlen, std::string(kLauncherNames[l]) +
                             ": CUDA launch failed with cudaError " +
                             std::to_string(rc) + " (" +
                             cudaGetErrorString((cudaError_t)rc) + ")");
    return false;
  }
  c->launches[l].fetch_add(1);
  return true;
}

// _multi_seed: the per-group seeds [G] as int64 (a 0-dim seed broadcast,
// uint32 widened); an int64 [G] seed is used as it is
const long long* seeds(NtbClient* c, const Buf* s, int g, Temps* t,
                       char* err, size_t errlen) {
  if (s->dtype == T_S64 && s->dims.size() == 1) return P<long long>(s);
  auto* dst = (long long*)t->get((size_t)g * 8, err, errlen);
  if (!dst) return nullptr;
  if (g > 0) {
    seed_widen_kernel<<<(g + 255) / 256, 256, 0, c->stream>>>(
        s->ptr, s->dtype == T_S64, s->dims.empty(), dst, g);
    if (!launched(c, (int)cudaGetLastError(), L_SEED, err, errlen))
      return nullptr;
  }
  return dst;
}

// the frame state's global scratch when it does not fit in shared memory
// (select.py _frame_scratch; null when it fits)
bool frame_scratch(Temps* t, int lanes, int nc, int rs, int flat,
                   unsigned char** out, char* err, size_t errlen) {
  const int nb = multi_compact_scratch_bytes(lanes, nc, rs, 1, flat);
  if (nb < 0) {
    set_err(err, errlen, "frames of " + std::to_string(nc) +
                             " slots at round size " + std::to_string(rs) +
                             " do not fit");
    return false;
  }
  *out = nullptr;
  if (nb == 0) return true;
  *out = static_cast<unsigned char*>(t->get((size_t)nb, err, errlen));
  return *out != nullptr;
}

bool d2d(NtbClient* c, void* dst, const void* src, size_t bytes, char* err,
         size_t errlen) {
  return !cuda_bad(cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToDevice,
                                   c->stream),
                   "cudaMemcpyAsync", err, errlen);
}

bool check_rounds(Check* ck, int64_t n, int64_t rs) {
  if (n >= (1 << 20)) ck->fail("packed fill rows support < 2^20 nodes");
  if (rs < 1 || rs > 1024) ck->fail("packed fill counts support rounds <= 1024");
  return !ck->bad;
}

// ------------------------------------------------------------ programs

// K1's two landscapes of the rows, then K3 (select.py _flat_launch)
int run_flat(NtbClient* c, Exec* x, Buf* const* in, Buf** out, char* err,
             size_t errlen) {
  Check ck{err, errlen, kProgramNames[P_FLAT]};
  const int rs = (int)x->st[0], spread = (int)x->st[1];
  const bool has_ok = x->st[2] != 0;
  const Buf* attrs = ck.in(in, 0, "attrs", T_S32, 2);
  const Buf* cap = ck.in(in, 1, "cap", T_S32, 2);
  const Buf* used0 = ck.in(in, 2, "used0", T_S32, 2);
  const Buf* elig = ck.in(in, 3, "elig", T_PRED, 1);
  const Buf* luts = ck.in(in, 4, "luts", T_PRED, 2);
  const Buf* base = ck.in(in, 5, "base_mask", T_PRED, 2);
  const Buf* con = ck.in(in, 6, "con", T_S32, 3);
  const Buf* u_mask = ck.in(in, 7, "u_mask", T_S32, 1);
  const Buf* aff = ck.in(in, 8, "aff", T_S32, 3);
  const Buf* req = ck.in(in, 9, "req", T_S32, 2);
  const Buf* desired = ck.in(in, 10, "desired", T_S32, 1);
  const Buf* dh = ck.in(in, 11, "dh_limit", T_S32, 1);
  const Buf* g_static = ck.in(in, 12, "g_static", T_S32, 1);
  const Buf* g_aff = ck.in(in, 13, "g_aff", T_S32, 1);
  const Buf* g_job = ck.in(in, 14, "g_job", T_S32, 1);
  const Buf* jc0 = ck.in(in, 15, "job_count0", T_S32, 2);
  const Buf* round_g = ck.in(in, 16, "round_g", T_S32, 1);
  const Buf* round_want = ck.in(in, 17, "round_want", T_S32, 1);
  const Buf* seed = in[18];
  const Buf* node_ok = has_ok ? ck.in(in, 19, "node_ok", T_PRED, 1) : nullptr;
  if (ck.bad) return -1;
  const int64_t n = attrs->dims[0], a = attrs->dims[1];
  const int64_t g = req->dims[0], r = round_g->dims[0];
  const int64_t u = con->dims[0], nco = con->dims[1];
  const int64_t ua = aff->dims[0], af = aff->dims[1];
  ck.dim(cap, 0, n, "cap"); ck.dim(cap, 1, 3, "cap");
  ck.dim(used0, 0, n, "used0"); ck.dim(used0, 1, 3, "used0");
  ck.dim(elig, 0, n, "elig"); ck.dim(base, 1, n, "base_mask");
  ck.dim(con, 2, 3, "con"); ck.dim(u_mask, 0, u, "u_mask");
  ck.dim(aff, 2, 4, "aff"); ck.dim(req, 1, 3, "req");
  for (const Buf* b : {desired, dh, g_static, g_aff, g_job})
    ck.dim(b, 0, g, "per-group inputs");
  ck.dim(jc0, 1, n, "job_count0"); ck.dim(round_want, 0, r, "round_want");
  if (node_ok) ck.dim(node_ok, 0, n, "node_ok");
  if (seed->dtype != T_S64 && seed->dtype != T_U32)
    ck.fail("seed must be int64 or uint32");
  else if (seed->dims.size() > 1 ||
           (seed->dims.size() == 1 && seed->dims[0] != g))
    ck.fail("seed must be 0-dim or [G]");
  if (!ck.bad && (a == 0 || luts->dims[0] == 0 || luts->dims[1] == 0))
    ck.fail("inconsistent shapes");
  if (!ck.bad && (n == 0 || jc0->dims[0] == 0))
    ck.fail("empty node axis or job count table");
  if (!check_rounds(&ck, n, rs)) return -1;
  if (ck.bad) return -1;

  Temps t(c);
  auto* static_u = (uint8_t*)t.get((size_t)(u * n), err, errlen);
  auto* aff_u = (float*)t.get((size_t)(ua * n) * 4, err, errlen);
  if (!static_u || !aff_u) return -1;
  if ((u > 0 && n > 0) || ua > 0) {
    if (!launched(c, landscape_pair(P<int>(attrs), (int)n, (int)a, P<int>(con),
                                    (int)u, (int)nco, P<uint8_t>(luts),
                                    (int)luts->dims[0], (int)luts->dims[1],
                                    P<uint8_t>(elig), P<uint8_t>(base),
                                    P<int>(u_mask),
                                    node_ok ? P<uint8_t>(node_ok) : nullptr,
                                    static_u, P<int>(aff), (int)ua, (int)af,
                                    aff_u, c->stream),
                  L_PAIR, err, errlen))
      return -1;
  }
  const long long* s64 = seeds(c, seed, (int)g, &t, err, errlen);
  if (!s64) return -1;
  out[0] = alloc_like(c, T_S32, {r, (int64_t)rs + 16}, err, errlen);
  out[1] = out[0] ? alloc_like(c, T_S32, {n, 3}, err, errlen) : nullptr;
  out[2] = out[1] ? alloc_like(c, T_S32, {n}, err, errlen) : nullptr;
  if (!out[2]) return -1;
  if (r == 0) {
    // select.py: used.copy_(used_in), jc.copy_(job_count0[0])
    return d2d(c, out[1]->ptr, used0->ptr, used0->bytes, err, errlen) &&
                   d2d(c, out[2]->ptr, jc0->ptr, (size_t)n * 4, err, errlen)
               ? 0 : -1;
  }
  unsigned char* scratch = nullptr;
  if (!frame_scratch(&t, 1, (int)n, rs, 1, &scratch, err, errlen))
    return -1;
  return launched(c, multi_flat(P<int>(cap), P<int>(used0), P<int>(out[1]),
                                static_u, aff_u, P<int>(aff), P<int>(req),
                                P<int>(desired), P<int>(dh),
                                P<int>(g_static), P<int>(g_aff),
                                P<int>(g_job), s64, P<int>(jc0),
                                P<int>(round_g), P<int>(round_want),
                                P<int>(out[0]), P<int>(out[2]), (int)n,
                                (int)ua, (int)af, (int)r, spread, rs,
                                scratch, c->stream),
                  L_FLAT, err, errlen)
             ? 0 : -1;
}

// K1's affinity over the frames, then K2 (select.py _compact_launch with
// the non-chained entry's copy of used0)
int run_compact(NtbClient* c, Exec* x, Buf* const* in, Buf** out, char* err,
                size_t errlen) {
  Check ck{err, errlen, kProgramNames[P_COMPACT]};
  const int rs = (int)x->st[0], lanes = (int)x->st[1];
  const int spread = (int)x->st[2];
  const Buf* attrs = ck.in(in, 0, "attrs", T_S32, 2);
  const Buf* cap = ck.in(in, 1, "cap", T_S32, 2);
  const Buf* used0 = ck.in(in, 2, "used0", T_S32, 2);
  const Buf* luts = ck.in(in, 4, "luts", T_PRED, 2);
  const Buf* aff = ck.in(in, 8, "aff", T_S32, 3);
  const Buf* req = ck.in(in, 9, "req", T_S32, 2);
  const Buf* desired = ck.in(in, 10, "desired", T_S32, 1);
  const Buf* dh = ck.in(in, 11, "dh_limit", T_S32, 1);
  const Buf* g_aff = ck.in(in, 13, "g_aff", T_S32, 1);
  const Buf* g_job = ck.in(in, 14, "g_job", T_S32, 1);
  const Buf* jc0 = ck.in(in, 15, "job_count0", T_S32, 2);
  const Buf* round_g = ck.in(in, 16, "round_g", T_S32, 1);
  const Buf* round_want = ck.in(in, 17, "round_want", T_S32, 1);
  const Buf* seed = in[18];
  const Buf* rows = ck.in(in, 19, "cand_rows", T_S32, 2);
  const Buf* valid = ck.in(in, 20, "cand_valid", T_PRED, 2);
  if (ck.bad) return -1;
  const int64_t n = attrs->dims[0], a = attrs->dims[1];
  const int64_t g = req->dims[0], r = round_g->dims[0];
  const int64_t ua = aff->dims[0], af = aff->dims[1];
  const int64_t nc = rows->dims[1];
  ck.dim(cap, 0, n, "cap"); ck.dim(cap, 1, 3, "cap");
  ck.dim(used0, 0, n, "used0"); ck.dim(used0, 1, 3, "used0");
  ck.dim(aff, 2, 4, "aff"); ck.dim(req, 1, 3, "req");
  for (const Buf* b : {desired, dh, g_aff, g_job})
    ck.dim(b, 0, g, "per-group inputs");
  ck.dim(rows, 0, lanes, "cand_rows");
  ck.dim(valid, 0, lanes, "cand_valid"); ck.dim(valid, 1, nc, "cand_valid");
  ck.dim(jc0, 1, nc, "job_count0"); ck.dim(round_want, 0, r, "round_want");
  if (!ck.bad && r % lanes) ck.fail("the schedule is not whole steps");
  if (seed->dtype != T_S64 && seed->dtype != T_U32)
    ck.fail("seed must be int64 or uint32");
  else if (seed->dims.size() > 1 ||
           (seed->dims.size() == 1 && seed->dims[0] != g))
    ck.fail("seed must be 0-dim or [G]");
  if (!ck.bad && (a == 0 || luts->dims[0] == 0 || luts->dims[1] == 0 ||
                  n == 0))
    ck.fail("inconsistent shapes");
  if (!check_rounds(&ck, n, rs)) return -1;
  if (ck.bad) return -1;
  const int64_t steps = r / lanes;
  const int fill_k = rs < 32 ? rs : 32;   // select.FILL_K

  Temps t(c);
  auto* aff_cu = (float*)t.get((size_t)(lanes * ua * nc) * 4, err, errlen);
  if (!aff_cu) return -1;
  if (ua > 0 && lanes > 0 && nc > 0) {
    if (!launched(c, landscape_affinity(P<int>(attrs), (int)n, (int)a,
                                        P<int>(rows), lanes, (int)nc,
                                        P<int>(aff), (int)ua, (int)af,
                                        P<uint8_t>(luts), (int)luts->dims[0],
                                        (int)luts->dims[1], aff_cu,
                                        c->stream),
                  L_AFFINITY, err, errlen))
      return -1;
  }
  const long long* s64 = seeds(c, seed, (int)g, &t, err, errlen);
  if (!s64) return -1;
  out[0] = alloc_like(c, T_S32, {r, (int64_t)fill_k + 16}, err, errlen);
  out[1] = out[0] ? alloc_like(c, T_S32, {r, (int64_t)rs}, err, errlen)
                  : nullptr;
  out[2] = out[1] ? alloc_like(c, T_S32, {n, 3}, err, errlen) : nullptr;
  if (!out[2]) return -1;
  // select.py: used0.clone() (K2 writes only its frames' rows)
  if (!d2d(c, out[2]->ptr, used0->ptr, used0->bytes, err, errlen)) return -1;
  if (!(steps && nc)) {
    return cuda_bad(cudaMemsetAsync(out[0]->ptr, 0, out[0]->bytes, c->stream),
                    "cudaMemsetAsync", err, errlen) ||
                   cuda_bad(cudaMemsetAsync(out[1]->ptr, 0, out[1]->bytes,
                                            c->stream),
                            "cudaMemsetAsync", err, errlen)
               ? -1 : 0;
  }
  unsigned char* scratch = nullptr;
  if (!frame_scratch(&t, lanes, (int)nc, rs, 0, &scratch, err, errlen))
    return -1;
  return launched(c, multi_compact(P<int>(cap), P<int>(used0),
                                   P<int>(out[2]), P<int>(rows),
                                   P<uint8_t>(valid), aff_cu, P<int>(aff),
                                   P<int>(req), P<int>(desired), P<int>(dh),
                                   P<int>(g_aff), P<int>(g_job), s64,
                                   P<int>(jc0), P<int>(round_g),
                                   P<int>(round_want), P<int>(out[0]),
                                   P<int>(out[1]), (int)n, lanes, (int)nc,
                                   (int)ua, (int)af, (int)steps, spread, rs,
                                   fill_k, scratch, c->stream),
                  L_COMPACT, err, errlen)
             ? 0 : -1;
}

// K8's static row and K1's affinity of group g, then K6 (select.py
// _bulk_launch, full or scored layout)
int run_bulk(NtbClient* c, Exec* x, Buf* const* in, Buf** out, char* err,
             size_t errlen) {
  Check ck{err, errlen, kProgramNames[P_BULK]};
  const int rs = (int)x->st[0], n_rounds = (int)x->st[1];
  const int with_scores = (int)x->st[2], spread = (int)x->st[3];
  const int64_t gi = x->st[4], p_real = x->st[5];
  const unsigned seed = (unsigned)(x->st[6] & 0xffffffffll);
  const Buf* attrs = ck.in(in, 0, "attrs", T_S32, 2);
  const Buf* cap = ck.in(in, 1, "cap", T_S32, 2);
  const Buf* used0 = ck.in(in, 2, "used0", T_S32, 2);
  const Buf* elig = ck.in(in, 3, "elig", T_PRED, 1);
  const Buf* dc = ck.in(in, 4, "dc_mask", T_PRED, 1);
  const Buf* pool = ck.in(in, 5, "pool_mask", T_PRED, 1);
  const Buf* luts = ck.in(in, 6, "luts", T_PRED, 2);
  const Buf* con = ck.in(in, 7, "con", T_S32, 3);
  const Buf* aff = ck.in(in, 8, "aff", T_S32, 3);
  const Buf* req = ck.in(in, 9, "req", T_S32, 2);
  const Buf* desired = ck.in(in, 10, "desired", T_S32, 1);
  const Buf* dh = ck.in(in, 11, "dh_limit", T_S32, 1);
  const Buf* jc0 = ck.in(in, 12, "job_count0", T_S32, 1);
  if (ck.bad) return -1;
  const int64_t n = attrs->dims[0], a = attrs->dims[1];
  const int64_t g = req->dims[0], nco = con->dims[1], af = aff->dims[1];
  ck.dim(cap, 0, n, "cap"); ck.dim(cap, 1, 3, "cap");
  ck.dim(used0, 0, n, "used0"); ck.dim(used0, 1, 3, "used0");
  for (const Buf* b : {elig, dc, pool, jc0}) ck.dim(b, 0, n, "node rows");
  ck.dim(con, 0, g, "con"); ck.dim(con, 2, 3, "con");
  ck.dim(aff, 0, g, "aff"); ck.dim(aff, 2, 4, "aff");
  ck.dim(req, 1, 3, "req");
  for (const Buf* b : {desired, dh}) ck.dim(b, 0, g, "per-group inputs");
  if (!ck.bad && (gi < 0 || gi >= g || p_real < 0))
    ck.fail("inconsistent shapes");
  if (!ck.bad && (a == 0 || n == 0 || luts->dims[0] == 0 ||
                  luts->dims[1] == 0))
    ck.fail("inconsistent shapes");
  if (!check_rounds(&ck, n, rs)) return -1;
  if (ck.bad) return -1;

  Temps t(c);
  auto* srow = (uint8_t*)t.get((size_t)n, err, errlen);
  auto* arow = (float*)t.get((size_t)n * 4, err, errlen);
  if (!srow || !arow) return -1;
  const int* con_g = P<int>(con) + gi * nco * 3;
  const int* aff_g = P<int>(aff) + gi * af * 4;
  if (!launched(c, feasible_mask(P<int>(attrs), (int)n, (int)a, con_g, 1,
                                 (int)nco, P<uint8_t>(luts),
                                 (int)luts->dims[0], (int)luts->dims[1],
                                 P<uint8_t>(elig), P<uint8_t>(dc),
                                 P<uint8_t>(pool), srow, c->stream),
                L_FEASIBLE, err, errlen) ||
      !launched(c, landscape_affinity(P<int>(attrs), (int)n, (int)a, nullptr,
                                      1, (int)n, aff_g, 1, (int)af,
                                      P<uint8_t>(luts), (int)luts->dims[0],
                                      (int)luts->dims[1], arow, c->stream),
                L_AFFINITY, err, errlen))
    return -1;
  const int64_t width = (int64_t)rs + (with_scores ? rs : 0) + 16;
  out[0] = alloc_like(c, T_S32, {(int64_t)n_rounds, width}, err, errlen);
  out[1] = out[0] ? alloc_like(c, T_S32, {n, 3}, err, errlen) : nullptr;
  out[2] = out[1] ? alloc_like(c, T_S32, {n}, err, errlen) : nullptr;
  if (!out[2]) return -1;
  if (n_rounds == 0) {
    return d2d(c, out[1]->ptr, used0->ptr, used0->bytes, err, errlen) &&
                   d2d(c, out[2]->ptr, jc0->ptr, jc0->bytes, err, errlen)
               ? 0 : -1;
  }
  unsigned char* scratch = nullptr;
  if (!frame_scratch(&t, 1, (int)n, rs, 1, &scratch, err, errlen))
    return -1;
  return launched(c, multi_bulk(P<int>(cap), P<int>(used0), P<int>(out[1]),
                                srow, arow, aff_g, P<int>(req) + gi * 3,
                                P<int>(desired) + gi, P<int>(dh) + gi,
                                P<int>(jc0), P<int>(out[0]), nullptr,
                                P<int>(out[2]), (int)n, (int)af, n_rounds,
                                spread, rs, rs, with_scores, (int)p_real,
                                seed, scratch, c->stream),
                  L_BULK, err, errlen)
             ? 0 : -1;
}

int n_inputs(const Exec* x) {
  switch (x->program) {
    case P_FLAT: return x->st[2] ? 20 : 19;
    case P_COMPACT: return 21;
    default: return 13;
  }
}

}  // namespace

extern "C" {

// -------------------------------------------------- client and device

NtbClient* ntb_create(int device, char* err, size_t errlen) {
  int count = 0;
  if (cuda_bad(cudaGetDeviceCount(&count), "cudaGetDeviceCount", err, errlen))
    return nullptr;
  if (device < 0 || device >= count) {
    set_err(err, errlen, "CUDA device " + std::to_string(device) +
                             " requested, " + std::to_string(count) +
                             " present");
    return nullptr;
  }
  auto* c = new NtbClient();
  c->device = device;
  for (auto& l : c->launches) l.store(0);
  OnDevice on(device);
  cudaMemPoolProps props = {};
  props.allocType = cudaMemAllocationTypePinned;
  props.location.type = cudaMemLocationTypeDevice;
  props.location.id = device;
  unsigned long long keep = ~0ull;
  if (cuda_bad(on.err, "cudaSetDevice", err, errlen) ||
      cuda_bad(cudaStreamCreateWithFlags(&c->stream, cudaStreamNonBlocking),
               "cudaStreamCreate", err, errlen)) {
    delete c;
    return nullptr;
  }
  if (cuda_bad(cudaMemPoolCreate(&c->pool, &props), "cudaMemPoolCreate", err,
               errlen) ||
      cuda_bad(cudaMemPoolSetAttribute(
                   c->pool, cudaMemPoolAttrReleaseThreshold, &keep),
               "cudaMemPoolSetAttribute", err, errlen)) {
    if (c->pool) cudaMemPoolDestroy(c->pool);
    cudaStreamDestroy(c->stream);
    delete c;
    return nullptr;
  }
  return c;
}

// frees every buffer and executable the client still owns
void ntb_destroy(NtbClient* c) {
  if (!c) return;
  {
    OnDevice on(c->device);
    std::vector<Buf*> bufs(c->bufs.begin(), c->bufs.end());
    for (Buf* b : bufs) free_buf(c, b);
    for (Exec* x : c->execs) delete x;
    c->execs.clear();
    cudaStreamSynchronize(c->stream);
    cudaStreamDestroy(c->stream);
    cudaMemPoolDestroy(c->pool);
  }
  delete c;
}

int ntb_device_count(NtbClient* c) {
  int count = 0;
  if (!c || cudaGetDeviceCount(&count) != cudaSuccess) return 0;
  return count;
}

int ntb_platform(NtbClient* c, char* out, size_t outlen) {
  if (!c || !out || outlen < 4) return -1;
  snprintf(out, outlen, "gpu");
  return 0;
}

// ------------------------------------------------------------- compile

// `program` and its static arguments (see the top of this file); returns
// an executable handle, or NULL with the error in err
void* ntb_compile(NtbClient* c, const char* program, const int64_t* statics,
                  int n_statics, char* err, size_t errlen) {
  if (!c || !program) {
    set_err(err, errlen, "compile: no client or no program");
    return nullptr;
  }
  int p = -1;
  for (int i = 0; i < N_PROGRAMS; i++)
    if (strcmp(program, kProgramNames[i]) == 0) p = i;
  if (p < 0) {
    set_err(err, errlen, std::string("unknown program '") + program +
                             "' (expected place_multi_packed, "
                             "place_multi_compact_packed or "
                             "place_bulk_packed)");
    return nullptr;
  }
  if (n_statics != kProgramStatics[p]) {
    set_err(err, errlen, std::string(program) + " takes " +
                             std::to_string(kProgramStatics[p]) +
                             " static arguments (" + kProgramStaticNames[p] +
                             "), got " + std::to_string(n_statics));
    return nullptr;
  }
  const int64_t rs = statics[0];
  if (rs < 1 || rs > 1024) {
    set_err(err, errlen, std::string(program) + ": round_size " +
                             std::to_string(rs) + " outside 1..1024");
    return nullptr;
  }
  if (p == P_COMPACT && statics[1] < 1) {
    set_err(err, errlen, "place_multi_compact_packed: n_lanes < 1");
    return nullptr;
  }
  if (p == P_BULK && (statics[1] < 0 || statics[4] < 0 || statics[5] < 0)) {
    set_err(err, errlen, "place_bulk_packed: negative n_rounds, g or p_real");
    return nullptr;
  }
  auto* x = new Exec();
  x->program = p;
  for (int i = 0; i < n_statics; i++) x->st[i] = statics[i];
  std::lock_guard<std::mutex> g(c->mu);
  c->execs.insert(x);
  return x;
}

void ntb_executable_destroy(NtbClient* c, void* exec) {
  if (!c || !exec) return;
  auto* x = static_cast<Exec*>(exec);
  {
    std::lock_guard<std::mutex> g(c->mu);
    if (!c->execs.erase(x)) return;
  }
  delete x;
}

long ntb_num_outputs(NtbClient* c, void* exec, char* err, size_t errlen) {
  if (!c || !live_exec(c, static_cast<Exec*>(exec))) {
    set_err(err, errlen, "unknown executable");
    return -1;
  }
  return 3;
}

// ------------------------------------------------------ device buffers

// one host array into a new device buffer (the host array may be reused
// when this returns)
void* ntb_upload(NtbClient* c, int dtype, const int64_t* dims, int ndims,
                 const void* data, char* err, size_t errlen) {
  if (!c) return nullptr;
  OnDevice on(c->device);
  if (cuda_bad(on.err, "cudaSetDevice", err, errlen)) return nullptr;
  Buf* b = alloc_buf(c, dtype, dims, ndims, err, errlen);
  if (!b) return nullptr;
  if (b->bytes && cuda_bad(cudaMemcpyAsync(b->ptr, data, b->bytes,
                                           cudaMemcpyHostToDevice, c->stream),
                           "cudaMemcpyAsync", err, errlen)) {
    free_buf(c, b);
    return nullptr;
  }
  return b;
}

void ntb_buffer_free(NtbClient* c, void* buf) {
  if (!c || !buf) return;
  OnDevice on(c->device);
  free_buf(c, static_cast<Buf*>(buf));
}

// a buffer's type (PJRT code) and dims; returns its rank, -1 if unknown
int ntb_buffer_info(NtbClient* c, void* buf, int* dtype, int64_t* dims,
                    int max_dims) {
  if (!c || !buf) return -1;
  std::lock_guard<std::mutex> g(c->mu);
  auto* b = static_cast<Buf*>(buf);
  if (!c->bufs.count(b)) return -1;
  if (dtype) *dtype = b->dtype;
  const int nd = (int)b->dims.size();
  for (int i = 0; i < nd && i < max_dims; i++) dims[i] = b->dims[i];
  return nd;
}

// run a program on device buffers; its outputs come back as new buffers
// (the inputs are not written, so an output may feed a later execute:
// the proposed-usage chain).  Enqueues only: ntb_fetch synchronises.
int ntb_execute_resident(NtbClient* c, void* exec, int n_in,
                         void* const* in_bufs, int n_out, void** out_bufs,
                         char* err, size_t errlen) {
  if (!c) return -1;
  auto* x = static_cast<Exec*>(exec);
  if (!live_exec(c, x)) {
    set_err(err, errlen, "unknown executable");
    return -1;
  }
  if (n_out != 3) {
    set_err(err, errlen, "executable has 3 outputs, caller provided " +
                             std::to_string(n_out));
    return -1;
  }
  const int want = n_inputs(x);
  if (n_in != want) {
    set_err(err, errlen, std::string(kProgramNames[x->program]) + " takes " +
                             std::to_string(want) + " inputs, got " +
                             std::to_string(n_in));
    return -1;
  }
  std::vector<Buf*> ins(n_in);
  for (int i = 0; i < n_in; i++) {
    ins[i] = static_cast<Buf*>(in_bufs[i]);
    if (!ins[i] || !live(c, ins[i])) {
      set_err(err, errlen, "input " + std::to_string(i) +
                               " is not a live buffer");
      return -1;
    }
  }
  OnDevice on(c->device);
  if (cuda_bad(on.err, "cudaSetDevice", err, errlen)) return -1;
  Buf* outs[3] = {nullptr, nullptr, nullptr};
  int rc;
  switch (x->program) {
    case P_FLAT: rc = run_flat(c, x, ins.data(), outs, err, errlen); break;
    case P_COMPACT:
      rc = run_compact(c, x, ins.data(), outs, err, errlen);
      break;
    default: rc = run_bulk(c, x, ins.data(), outs, err, errlen); break;
  }
  if (rc != 0) {
    for (Buf* b : outs)
      if (b) free_buf(c, b);
    return -1;
  }
  for (int i = 0; i < 3; i++) out_bufs[i] = outs[i];
  return 0;
}

// one buffer to host, dense row-major, after everything enqueued before
// it: returns its byte size, or -1 on error (dst too small included)
int64_t ntb_fetch(NtbClient* c, void* buf, void* dst, int64_t cap,
                  char* err, size_t errlen) {
  if (!c) return -1;
  auto* b = static_cast<Buf*>(buf);
  if (!live(c, b)) {
    set_err(err, errlen, "fetch: not a live buffer");
    return -1;
  }
  if ((int64_t)b->bytes > cap) {
    set_err(err, errlen, "buffer needs " + std::to_string(b->bytes) +
                             " bytes, " + std::to_string(cap) + " provided");
    return -1;
  }
  OnDevice on(c->device);
  if (cuda_bad(on.err, "cudaSetDevice", err, errlen)) return -1;
  if (b->bytes && cuda_bad(cudaMemcpyAsync(dst, b->ptr, b->bytes,
                                           cudaMemcpyDeviceToHost, c->stream),
                           "cudaMemcpyAsync", err, errlen))
    return -1;
  if (cuda_bad(cudaStreamSynchronize(c->stream), "cudaStreamSynchronize",
               err, errlen))
    return -1;
  return (int64_t)b->bytes;
}

// One synchronous execution, host in and host out (the reference's
// ntb_execute): inputs as ntb_upload takes them back to back, outputs
// into n_out caller buffers of out_cap[i] bytes, their sizes into
// out_sizes.  out_dims_flat, out_ndims and out_elem are kept in the ABI.
int ntb_execute(NtbClient* c, void* exec, int n_in, const int* dtypes,
                const int64_t* dims_flat, const int* ndims,
                const void* const* data, int n_out, void* const* out_data,
                const int64_t* out_cap, const int64_t* out_dims_flat,
                const int* out_ndims, const int* out_elem,
                int64_t* out_sizes, char* err, size_t errlen) {
  (void)out_dims_flat;
  (void)out_ndims;
  (void)out_elem;
  if (ntb_num_outputs(c, exec, err, errlen) != n_out) {
    if (c && live_exec(c, static_cast<Exec*>(exec)))
      set_err(err, errlen, "executable has 3 outputs, caller provided " +
                               std::to_string(n_out));
    return -1;
  }
  std::vector<void*> ins;
  int rc = -1;
  void* outs[3] = {nullptr, nullptr, nullptr};
  size_t off = 0;
  for (int i = 0; i < n_in; i++) {
    void* h = ntb_upload(c, dtypes[i], dims_flat + off, ndims[i], data[i],
                         err, errlen);
    off += ndims[i];
    if (!h) goto cleanup;
    ins.push_back(h);
  }
  if (ntb_execute_resident(c, exec, n_in, ins.data(), n_out, outs, err,
                           errlen) != 0)
    goto cleanup;
  for (int i = 0; i < n_out; i++) {
    const int64_t got =
        ntb_fetch(c, outs[i], out_data[i], out_cap[i], err, errlen);
    if (got < 0) {
      set_err(err, errlen, "output " + std::to_string(i) + ": " + err);
      goto cleanup;
    }
    out_sizes[i] = got;
  }
  rc = 0;
cleanup:
  for (void* h : ins) ntb_buffer_free(c, h);
  for (void* h : outs)
    if (h) ntb_buffer_free(c, h);
  return rc;
}

// ------------------------------------------------------------- counters

int64_t ntb_live_buffers(NtbClient* c) {
  if (!c) return -1;
  std::lock_guard<std::mutex> g(c->mu);
  return (int64_t)c->bufs.size();
}

int64_t ntb_live_bytes(NtbClient* c) {
  if (!c) return -1;
  std::lock_guard<std::mutex> g(c->mu);
  return c->live_bytes;
}

int ntb_launcher_count(void) { return N_LAUNCHERS; }

const char* ntb_launcher_name(int i) {
  return i >= 0 && i < N_LAUNCHERS ? kLauncherNames[i] : nullptr;
}

// launches of launcher i by this client since creation or the last reset
int64_t ntb_launches(NtbClient* c, int i) {
  if (!c || i < 0 || i >= N_LAUNCHERS) return -1;
  return c->launches[i].load();
}

void ntb_reset_launches(NtbClient* c) {
  if (!c) return;
  for (auto& l : c->launches) l.store(0);
}

}  // extern "C"
