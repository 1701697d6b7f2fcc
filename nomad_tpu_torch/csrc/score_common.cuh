// Scoring helpers shared by the rounds kernels (multi_rounds.cu) and the
// exact scan (place_scan.cu): floor division, the C library's powf(10, x),
// the reference's tie-break hash, float <-> orderable key bits, and the
// cluster launch of the sharded kernels.
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

// Launch `kern` as clusters of `cluster` blocks of `threads` threads;
// refuses (cudaErrorLaunchOutOfResources) when the card cannot place one
// such cluster.
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
