// The exchange of a mesh across parts (parallel/xmesh.py): K9, K10, K11
// and K12 run one launch per part, each over the part's own rows, and
// the parts meet once per step or round through an exchange buffer in
// the global memory of the home part's card (reached from another card
// through peer access), or, where the cards lack peer access, in mapped
// pinned host memory that every card reaches over PCIe.  Every access
// below is valid on both: plain, vector and relaxed stores and loads,
// acquire and release at the mesh's scope, and the error word set by a
// plain store (an atomic on host memory need not be atomic over PCIe).
// Included inside each source's anonymous namespace, after
// score_common.cuh.
//
// The protocol (`xp_put_pair`, `xp_meet`), per exchange number x (the
// same sequence in every part):
//  * a post travels as (word, flag) pairs: block 0's lane w stores word
//    w of its part's post beside the flag x + 1 with one 8-byte store
//    into its slot [x & 1][part], two 32-bit words that land together
//    (as NCCL's LL protocol relies on); no fence, no stamp;
//  * warp 0 of EVERY block of the cluster reads every part's post
//    itself with 16-byte relaxed loads (two pairs each) until every
//    flag is x + 1, keeping the words in its shared memory as they
//    arrive: the wait and the copy are the same loads, and no block
//    waits for another's relay (the error word and the deadline are
//    read every 64 polls);
//  * the cluster still takes one path: the first block to propose an
//    outcome for x (compare-and-swap on a word in block 0's shared
//    memory, `2 (x + 1) + failed` over `2 x`) decides it for every
//    block; a block whose own wait ran out while another saw every
//    post reads again, without a deadline, posts known to be there;
//  * the scope follows the mesh (`XPart::sys`): GPU scope when every
//    part is on one card and the buffer is its memory, system scope
//    across cards or in host memory.
// K9 meets so every step; K10, K11 and K12 every computed round.  The
// rounds' wide exchange posts a list of up to 1,024 entries, too long
// for pairs: block 0's threads store the list, fence at the mesh's
// scope, and one thread stores the slot's stamp x + 1 with a release;
// warp 0 of every block waits for every part's stamp itself (acquire
// loads at the same scope) and the cluster agrees as above
// (`xp_meet_stamps`); the lists are then read in place.
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
  int sys;              // system scope (several cards or host memory)
};

__device__ __forceinline__ int xp_ld_acquire(const int* p, bool sys) {
  int v;
  if (sys)
    asm volatile("ld.acquire.sys.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int xp_ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.sys.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void xp_st_release(int* p, int v, bool sys) {
  if (sys)
    asm volatile("st.release.sys.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
  else
    asm volatile("st.release.gpu.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// The error word is only ever set to 1: a plain store at system scope,
// since an atomic on host memory over PCIe need not be atomic
__device__ __forceinline__ void xp_st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.sys.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

// ---- the flagged posts (see the head of this file)

// One (word, flag) pair of a post: one 8-byte store.
__device__ __forceinline__ void xp_put_pair(int* pair, int v, int flag,
                                            bool sys) {
  if (sys)
    asm volatile("st.relaxed.sys.v2.b32 [%0], {%1, %2};"
                 :: "l"(pair), "r"(v), "r"(flag) : "memory");
  else
    asm volatile("st.relaxed.gpu.v2.b32 [%0], {%1, %2};"
                 :: "l"(pair), "r"(v), "r"(flag) : "memory");
}

// Two pairs (word, flag, word, flag): one 16-byte load.
__device__ __forceinline__ int4 xp_get_quad(const int* p, bool sys) {
  int4 q;
  if (sys)
    asm volatile("ld.relaxed.sys.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(q.x), "=r"(q.y), "=r"(q.z), "=r"(q.w)
                 : "l"(p) : "memory");
  else
    asm volatile("ld.relaxed.gpu.v4.b32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(q.x), "=r"(q.y), "=r"(q.z), "=r"(q.w)
                 : "l"(p) : "memory");
  return q;
}

// Warp 0 of a block: read the posts of every part (`n` words each, n
// even; part r's pairs at `base` + r `stride`) until each pair's flag
// is `want`, the first `keep` words of part r into all[r * ld, ...).
// False once the error word is set, or (with `bounded`) when this
// lane's deadline passes (it then sets the error word).
__device__ __forceinline__ bool xp_read_posts(const XPart& xp,
                                              const int* base,
                                              long long stride, int n,
                                              int want, int* all, int ld,
                                              int keep, bool bounded) {
  const int lane = threadIdx.x & 31, per = n / 2;
  const long long t0 = clock64();
  int polls = 0;
  for (int j = lane; j < xp.n_parts * per; j += 32) {
    const int r = j / per, c = j - r * per;
    const int* src = base + r * stride + 4 * c;
    int4 q;
    for (;;) {
      q = xp_get_quad(src, xp.sys);
      if (q.y == want && q.w == want) break;
      if (bounded && (++polls & 63) == 0) {
        if (xp_ld_relaxed(xp.buf) != 0) return false;
        if (clock64() - t0 > xp.deadline) {
          xp_st_relaxed(xp.buf, 1);
          return false;
        }
      }
    }
    if (2 * c < keep) {
      all[r * ld + 2 * c] = q.x;
      all[r * ld + 2 * c + 1] = q.z;
    }
  }
  return true;
}

// Warp 0 of a block: the cluster's outcome of exchange `want`, the
// first proposal `ok` of its blocks (compare-and-swap on `dec0`, block
// 0's word, 2 (want - 1) before this exchange); true when it is success.
__device__ __forceinline__ bool xp_agree(bool ok, int want, unsigned* dec0) {
  unsigned d = 0u;
  if ((threadIdx.x & 31) == 0) {
    const unsigned before = 2u * (unsigned)(want - 1);
    const unsigned mine = 2u * (unsigned)want + (ok ? 0u : 1u);
    const unsigned old = atomicCAS(dec0, before, mine);
    d = old == before ? mine : old;
  }
  d = __shfl_sync(FULL, d, 0);
  return (d & 1u) == 0u;
}

// Warp 0 of every block of a part's cluster, after block 0 posted
// exchange `want` - 1: read every part's post (xp_read_posts), then
// agree on the outcome through `dec0` (block 0's word, 2 (want - 1)
// before this exchange).  True in every block alike when every post is
// there and in `all`; a failure sets *failed in every block, and later
// exchanges then fail at once.  (`t_mid`, when given: lane 0's
// clock64() where the reads end and the agreement begins.)
__device__ __forceinline__ bool xp_meet(const XPart& xp, const int* base,
                                        long long stride, int n, int want,
                                        int* all, int ld, int keep,
                                        unsigned* dec0, bool* failed,
                                        long long* t_mid = nullptr) {
  if (*failed) return false;
  bool ok = xp_read_posts(xp, base, stride, n, want, all, ld, keep, true);
  ok = __all_sync(FULL, ok);
  if (t_mid) *t_mid = clock64();
  const bool agreed = xp_agree(ok, want, dec0);
  if (agreed && !ok)
    xp_read_posts(xp, base, stride, n, want, all, ld, keep, false);
  __syncwarp();   // every lane's words in `all` before any lane reads
  if (!agreed) *failed = true;
  return agreed;
}

// Warp 0 of every block of a part's cluster, after each part's block 0
// released its stamp `want` (slots `stride` words apart from `stamp0`):
// lane r < n_parts waits for stamp r with acquire loads at the mesh's
// scope (the error word and the deadline read every 64 polls), then the
// cluster agrees on the outcome through `dec0` as in xp_meet.  True in
// every block alike when every stamp is set; a failure sets *failed in
// every block, and later exchanges then fail at once.  (`t_mid` as in
// xp_meet.)
__device__ __forceinline__ bool xp_meet_stamps(const XPart& xp,
                                               const int* stamp0,
                                               long long stride, int want,
                                               unsigned* dec0, bool* failed,
                                               long long* t_mid = nullptr) {
  const int lane = threadIdx.x & 31;
  if (*failed) return false;
  const int* stamp = stamp0 + lane * stride;
  auto wait = [&](bool bounded) {
    if (lane >= xp.n_parts) return true;
    const long long t0 = clock64();
    int polls = 0;
    while (xp_ld_acquire(stamp, xp.sys) < want) {
      if (bounded && (++polls & 63) == 0) {
        if (xp_ld_relaxed(xp.buf) != 0) return false;
        if (clock64() - t0 > xp.deadline) {
          xp_st_relaxed(xp.buf, 1);
          return false;
        }
      }
    }
    return true;
  };
  const bool ok = __all_sync(FULL, wait(true));
  if (t_mid) *t_mid = clock64();
  const bool agreed = xp_agree(ok, want, dec0);
  if (agreed && !ok) wait(false);
  __syncwarp();   // every lane reads after the acquires
  if (!agreed) *failed = true;
  return agreed;
}
