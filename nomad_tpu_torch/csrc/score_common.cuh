// Scoring helpers shared by the rounds kernels (compact_rounds.cu) and
// the exact scan (place_scan.cu): floor division, the C library's
// powf(10, x), the reference's tie-break hash, float <-> orderable key
// bits, the cluster launch of the sharded kernels, the exchange through
// distributed shared memory, and the PROF instantiations' phase clock.
// Included inside each source's anonymous namespace.

#pragma once

constexpr float NEG_INF = -1e30f;
constexpr float HALF_NEG_INF = -5e29f;
constexpr float NOISE_SCALE = (float)(1e-6 / 4294967296.0);
constexpr float INV18 = (float)(1.0 / 18.0);
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// 2^(i/32) as double bits, less i << 47 (the C library's exp2f table)
__constant__ unsigned long long EXP2_TAB[32] = {
    0x3ff0000000000000ull, 0x3fefd9b0d3158574ull, 0x3fefb5586cf9890full,
    0x3fef9301d0125b51ull, 0x3fef72b83c7d517bull, 0x3fef54873168b9aaull,
    0x3fef387a6e756238ull, 0x3fef1e9df51fdee1ull, 0x3fef06fe0a31b715ull,
    0x3feef1a7373aa9cbull, 0x3feedea64c123422ull, 0x3feece086061892dull,
    0x3feebfdad5362a27ull, 0x3feeb42b569d4f82ull, 0x3feeab07dd485429ull,
    0x3feea47eb03a5585ull, 0x3feea09e667f3bcdull, 0x3fee9f75e8ec5f74ull,
    0x3feea11473eb0187ull, 0x3feea589994cce13ull, 0x3feeace5422aa0dbull,
    0x3feeb737b0cdc5e5ull, 0x3feec49182a3f090ull, 0x3feed503b23e255dull,
    0x3feee89f995ad3adull, 0x3feeff76f2fb5e47ull, 0x3fef199bdd85529cull,
    0x3fef3720dcef9069ull, 0x3fef5818dcfba487ull, 0x3fef7c97337b9b5full,
    0x3fefa4afa2a490daull, 0x3fefd0765b6e4540ull};

// powf(10, x) as the C library computes it (glibc >= 2.28, from ARM's
// optimized-routines): log2(10) by its table-driven log2 (a constant,
// the base being fixed), then 2^(x log2 10) as 2^(k/32) * p(r) in double
// and one rounding to float.  Valid for |x| < 37 (no overflow or
// subnormal branch); the scores call it on [0, 1].
__device__ __forceinline__ float libm_pow10f(float x) {
  const double LOG2_10 = 0x1.a934f0979b22dp+1;
  const double SHIFT = 0x1.8p+47;   // 1.5 * 2^52 / 32
  const double C0 = 0x1.c6af84b912394p-5, C1 = 0x1.ebfce50fac4f3p-3,
               C2 = 0x1.62e42ff0c52d6p-1;
  const double xd = __dmul_rn((double)x, LOG2_10);
  double kd = __dadd_rn(xd, SHIFT);
  const unsigned long long ki = (unsigned long long)__double_as_longlong(kd);
  kd = __dsub_rn(kd, SHIFT);
  const double r = __dsub_rn(xd, kd);
  const double s = __longlong_as_double(
      (long long)(EXP2_TAB[ki % 32] + (ki << 47)));
  const double z = __fma_rn(C0, r, C1);
  const double r2 = __dmul_rn(r, r);
  double y = __fma_rn(C2, r, 1.0);
  y = __fma_rn(z, r2, y);
  return (float)__dmul_rn(y, s);
}

// The capacity part of a rounds kernel's intake for one row
// (round_scores_g): min over the dimensions of floor(free / req) (rs for
// a dimension not requested), clamped to [0, rs], and 0 when any
// dimension is over capacity.
__device__ __forceinline__ int rounds_kcap(const int* c, const int* u,
                                           const int* r, int rs) {
  int f0 = c[0] - u[0], f1 = c[1] - u[1], f2 = c[2] - u[2];
  int p0 = r[0] > 0 ? floordiv(f0, r[0]) : rs;
  int p1 = r[1] > 0 ? floordiv(f1, r[1]) : rs;
  int p2 = r[2] > 0 ? floordiv(f2, r[2]) : rs;
  int k = min(min(p0, p1), p2);
  k = min(max(k, 0), rs);
  if (f0 < 0 || f1 < 0 || f2 < 0) k = 0;
  return k;
}

// The binpack term of a rounds kernel's score for one row, in the
// reference's order of operations (binpack_score / 18).
__device__ __forceinline__ float rounds_binpack(const int* c, const int* u,
                                                const int* r, bool spread) {
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
  return ((cf0 > 0.0f && cf1 > 0.0f) ? s : 0.0f) * INV18;
}

__device__ __forceinline__ float tiebreak_noise(unsigned seed,
                                                unsigned row) {
  unsigned x = (row * 0x9E3779B1u) ^ (seed * 0x85EBCA77u);
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return ((float)x * NOISE_SCALE) * (seed != 0u ? 1.0f : 0.0f);
}

// float -> uint32 whose unsigned order is the float order (+0 canonical)
__device__ __forceinline__ unsigned orderable(float f) {
  unsigned b = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(unsigned o) {
  unsigned b = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(b);
}

constexpr int XCH_BLOCKS = 8;   // the portable cluster size

// Launch `kern` as clusters of `cluster` blocks of `threads` threads
// (past the portable 8 blocks only where the card allows it); refuses
// (cudaErrorLaunchOutOfResources) when the card cannot place one such
// cluster.
template <class... Args>
int launch_clusters_nt(void (*kern)(Args...), int n_blocks, int cluster,
                       int threads, size_t dyn, cudaStream_t stream,
                       Args... args) {
  cudaError_t e;
  // static and dynamic shared memory past 48 KB need the opt-in, so
  // state the dynamic amount whatever it is
  if (dyn > 0) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  if (cluster > XCH_BLOCKS) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n_clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&n_clusters, (const void*)kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (n_clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// launch_clusters_nt with blocks of BS threads
template <class... Args>
int launch_clusters(void (*kern)(Args...), int n_blocks, int cluster,
                    size_t dyn, cudaStream_t stream, Args... args) {
  return launch_clusters_nt(kern, n_blocks, cluster, BS, dyn, stream,
                            args...);
}

// ---- distributed shared memory exchange (K9, K5 and K2 on a cluster)

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ unsigned cluster_addr(unsigned a, unsigned r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(a), "r"(r));
  return out;
}

// The exchange slots of one block: post k of block r at slot[k & 1][r]
// (W words, clusters of up to NB blocks), the arrival of all posts of
// exchange k on bar[k & 1].
template <int W, int NB = XCH_BLOCKS>
struct XchT {
  int slot[2][NB][W];
  unsigned long long bar[2];
};

template <int W, int NB>
__device__ __forceinline__ void xch_init(XchT<W, NB>* x, int n_shards) {
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_u32(&x->bar[b])), "r"(n_shards) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// Warp 0 of every block of the cluster (S <= 32 blocks): lane r < S stores `post` (W
// words, the same in every lane) into slot [k & 1][sh] of block r and
// arrives on block r's barrier (release at cluster scope, after its
// stores); then every lane waits for this block's barrier of exchange k
// (acquire at cluster scope), after which slot[k & 1][0, S) holds the S
// posts.  Slot k & 1 of a peer is free again at exchange k + 2: the
// peer read it before it posted exchange k + 1, which this block waited
// for.
template <int W, int NB>
__device__ __forceinline__ void xch_meet(XchT<W, NB>* x, int k, int sh,
                                         int n_shards, const int* post) {
  const int lane = threadIdx.x & 31;
  const int b = k & 1;
  if (lane < n_shards) {
    const unsigned dst = cluster_addr(smem_u32(&x->slot[b][sh][0]), lane);
    for (int w = 0; w < W; w += 4)
      asm volatile(
          "st.shared::cluster.v4.s32 [%0], {%1, %2, %3, %4};"
          :: "r"(dst + 4 * w), "r"(post[w]), "r"(post[w + 1]),
          "r"(post[w + 2]), "r"(post[w + 3]) : "memory");
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
        :: "r"(cluster_addr(smem_u32(&x->bar[b]), lane)) : "memory");
  }
  const unsigned bar = smem_u32(&x->bar[b]);
  const unsigned parity = (unsigned)(k >> 1) & 1u;
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// Phase split of a PROF instantiation: block 0's thread 0 adds the
// clock64() cycles since the last mark to phase `ph` of the step's kind
// (active or not), after a block barrier so that every thread has ended
// the phase (mark_nb: warp 0's own work, no barrier).  The output holds
// 2 NPHASE + 4 words: cycles per phase of active steps [0, NPHASE), of
// inactive steps [NPHASE, 2 NPHASE), the two step counts, the set-up
// before the first step and the whole kernel.
template <bool PROF, int NPHASE>
struct PhaseClock {
  long long acc[2 * NPHASE + 2];
  long long begin, setup, last;
  bool on;
  __device__ void start(bool on_) {
    on = PROF && on_;
    if (on) {
      for (int i = 0; i < 2 * NPHASE + 2; ++i) acc[i] = 0;
      begin = last = clock64();
    }
  }
  __device__ void setup_done() {
    if (!PROF) return;
    __syncthreads();
    if (on) {
      last = clock64();
      setup = last - begin;
    }
  }
  __device__ void mark(int ph, bool act) {
    if (!PROF) return;
    __syncthreads();
    if (on) {
      const long long now = clock64();
      acc[(act ? 0 : NPHASE) + ph] += now - last;
      last = now;
    }
  }
  __device__ void mark_nb(int ph, bool act) {
    if (PROF && on) {
      const long long now = clock64();
      acc[(act ? 0 : NPHASE) + ph] += now - last;
      last = now;
    }
  }
  __device__ void step(bool act) {
    if (PROF && on) acc[2 * NPHASE + (act ? 0 : 1)] += 1;
  }
  __device__ void finish(long long* out) {
    if (!PROF) return;
    __syncthreads();
    if (!on) return;
    for (int i = 0; i < 2 * NPHASE + 2; ++i) out[i] = acc[i];
    out[2 * NPHASE + 2] = setup;
    out[2 * NPHASE + 3] = clock64() - begin;
  }
};
