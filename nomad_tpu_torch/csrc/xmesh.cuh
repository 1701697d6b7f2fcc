// The exchange of a mesh across parts (parallel/xmesh.py): K9, K10, K11
// and K12 run one launch per part, each over the part's own rows, and
// the parts meet once per step or round through an exchange buffer in
// the global memory of the home part's card (reached from another card
// through peer access).  Included inside each source's anonymous
// namespace, after score_common.cuh.
//
// Protocol, per exchange number x (the same sequence in every part):
//  * block 0 of each part writes its post into its slot [x & 1][part]
//    (plain stores, each writing thread then fences at system scope),
//    and one thread stores the slot's stamp x + 1 with a release at
//    system scope;
//  * block 0's lanes r < parts then spin on slot r's stamp with acquire
//    loads at system scope, each wait bounded by a clock64() deadline
//    that sets the error word (word 0 of the buffer) and gives up;
//  * block 0 tells the other blocks of its cluster whether every post
//    is there (a release store at cluster scope into each peer's
//    `s_go`, which the peer's warp 0 acquires), so that every block of
//    a cluster reads the same posts or, after a failure, none, and no
//    block takes a path of cluster barriers that its peers do not take;
//  * every block reads the D posts in part order and decides alike.
// Two slots per part are enough: part q posts x + 2 into slot x & 1
// only after every part has posted x + 1, which each part's blocks do
// only after they have read the posts of x.
//
// After a failure the kernel runs on to its end with empty posts (no
// placement), so it never hangs its cluster; the wrapper reads the
// error word after the fetch and raises.

#pragma once

constexpr int XP_HEAD = 32;   // the buffer's header words: error word 0

struct XPart {
  int* buf;             // the exchange buffer (header, then the slots)
  int part, n_parts;    // this part and the part count (< 2: no parts)
  long long deadline;   // clock64() cycles a wait may take
};

__device__ __forceinline__ int xp_ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int xp_ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.sys.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void xp_st_release(int* p, int v) {
  asm volatile("st.release.sys.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// Wait until *stamp >= want: false once the error word is set, or when
// this wait's deadline passes (it then sets the error word).
__device__ __forceinline__ bool xp_wait(const int* stamp, int want, int* err,
                                        long long deadline) {
  const long long t0 = clock64();
  for (;;) {
    if (xp_ld_acquire(stamp) >= want) return true;
    if (xp_ld_relaxed(err) != 0) return false;
    if (clock64() - t0 > deadline) {
      atomicOr_system(err, 1);
      return false;
    }
    __nanosleep(32);
  }
}

// Block 0's warp 0: store `n` words of `post` (any lanes' copies alike)
// into `slot` after its stamp word, then stamp it `want`.
__device__ __forceinline__ void xp_post_warp(int* slot, const int* post,
                                             int n, int want) {
  const int lane = threadIdx.x & 31;
  for (int w = lane; w < n; w += 32) slot[1 + w] = post[w];
  __threadfence_system();
  __syncwarp();
  if (lane == 0) xp_st_release(slot, want);
}

// Warp 0 of every block of a part's cluster (`cb` blocks, this one
// `sh`), after block 0 posted exchange `want` - 1: block 0's lanes r <
// n_parts wait for slot r's stamp (slots `stride` words apart from
// `stamp0`), then block 0 releases its peers with the outcome.  True in
// every block of the cluster alike when every post is there; a failure
// sets *failed, and later exchanges then fail at once.
__device__ __forceinline__ bool xp_gather(const XPart& xp, int sh, int cb,
                                          const int* stamp0, long long stride,
                                          int want, unsigned* s_go,
                                          bool* failed) {
  const int lane = threadIdx.x & 31;
  unsigned v;
  if (sh == 0) {
    bool ok = !*failed;
    if (ok && lane < xp.n_parts)
      ok = xp_wait(stamp0 + lane * stride, want, xp.buf, xp.deadline);
    ok = __all_sync(FULL, ok);
    v = 2u * (unsigned)want + (ok ? 0u : 1u);
    if (lane >= 1 && lane < cb) {
      unsigned* peer = cg::this_cluster().map_shared_rank(s_go, lane);
      asm volatile("st.release.cluster.u32 [%0], %1;"
                   :: "l"(peer), "r"(v) : "memory");
    }
  } else {
    do {
      asm volatile("ld.acquire.cluster.u32 %0, [%1];"
                   : "=r"(v) : "l"(s_go) : "memory");
    } while ((v >> 1) < (unsigned)want);
    // the posts' stamps, acquired here too (block 0 saw them set)
    if ((v & 1u) == 0 && lane < xp.n_parts)
      while (xp_ld_acquire(stamp0 + lane * stride) < want) {
      }
  }
  __syncwarp();   // every lane reads after the acquires
  const bool ok = (v & 1u) == 0;
  if (!ok) *failed = true;
  return ok;
}
