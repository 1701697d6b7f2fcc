"""Ranking components (reference: nomad_tpu/ops/scoring.py).

Plain PyTorch versions of the reference's score components, in the
reference's order of operations (the f32 results must agree bit for bit
with the JAX functions on the CPU, and with the CUDA kernels' arithmetic
on the card), plus the wrappers of kernel K1's affinity entry
(`affinity_landscape`) and of its entry that computes the static mask
and the affinity of the same rows in one launch (`landscapes`, the flat
multi-eval path's), both in `csrc/landscape.cu`.

Score components (all bounded like the reference's):
  binpack     [0, 18]   structs.ScoreFit exponential (or inverted for spread)
  job-anti-affinity  [-1, 0]   -(collisions / desired_count)
  node-reschedule-penalty  {-1, 0}  previous node of a rescheduled alloc
  node-affinity  [-1, 1]  sum(matched weights)/sum(|weights|)
  allocation-spread  [-1, 1]  per-property boost toward target percentages
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import kernels as K
from .feasibility import (
    _k1_launch,
    _row_predicates,
    and_rows,
    landscape_mask_plain,
)

MAX_FIT_SCORE = 18.0


# The C library's powf(10, x), step for step (glibc >= 2.28, from ARM's
# optimized-routines): log2(10) from its table-driven log2 (a constant,
# the base being fixed), then 2^(x log2 10) = 2^(k/32) * p(r) in double.
_LOG2_10 = float.fromhex("0x1.a934f0979b22dp+1")
_SHIFT = float.fromhex("0x1.8p+47")          # 1.5 * 2^52 / 32
_EXP2_C = tuple(float.fromhex(c) for c in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1"))
# bits of 2^(i/32) less i << 47 (the C library's exp2f table; the CUDA
# kernels carry the same EXP2_TAB)
_EXP2_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f,
    0x3fef9301d0125b51, 0x3fef72b83c7d517b, 0x3fef54873168b9aa,
    0x3fef387a6e756238, 0x3fef1e9df51fdee1, 0x3fef06fe0a31b715,
    0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429,
    0x3feea47eb03a5585, 0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74,
    0x3feea11473eb0187, 0x3feea589994cce13, 0x3feeace5422aa0db,
    0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c,
    0x3fef3720dcef9069, 0x3fef5818dcfba487, 0x3fef7c97337b9b5f,
    0x3fefa4afa2a490da, 0x3fefd0765b6e4540)


def pow10_libm(x: torch.Tensor) -> torch.Tensor:
    """10**x in float32 by the C library's powf algorithm, in float64
    tensor arithmetic on any device (the CUDA kernels' `libm_pow10f`
    computes the same steps).  Valid for |x| < 37."""
    xd = x.to(torch.float64) * _LOG2_10
    kd = (xd + _SHIFT) - _SHIFT                  # k/32, k = round(32 xd)
    r = xd - kd
    k = (kd * 32.0).to(torch.int64)
    tab = torch.tensor(_EXP2_TAB, dtype=torch.int64, device=x.device)
    i = k & 31
    s = (tab[i] + (i << 47) + ((k >> 5) << 52)).view(torch.float64)
    c0, c1, c2 = _EXP2_C
    z = c0 * r + c1
    y = (c2 * r + 1.0) + z * (r * r)
    return (y * s).to(torch.float32)


def pow10(x: torch.Tensor) -> torch.Tensor:
    """10**x in float32, as the C library's powf computes it (XLA's CPU
    pow is the C library's powf).

    On the CPU this calls powf itself: ATen's vectorised CPU pow is
    SLEEF's and differs from powf in the last bit for about 0.1% of
    inputs, so the exponent goes in through a strided view, and a
    non-contiguous inner loop runs ATen's scalar path, which calls powf
    element by element.  On the card, where pow is the device's powf,
    it runs `pow10_libm`."""
    if x.device.type != "cpu":
        return pow10_libm(x)
    buf = x.new_empty(x.shape + (2,))
    buf[..., 0] = x
    e = buf[..., 0]
    ten = torch.tensor(10.0, dtype=x.dtype, device=x.device)
    return torch.pow(ten.expand_as(e), e)


def pow10_on_card(x: torch.Tensor) -> torch.Tensor:
    """The kernels' device 10^x (`libm_pow10f`, csrc/score_common.cuh)
    over a float32 CUDA tensor, through csrc/compact_rounds.cu's
    `pow10_f32`, to hold it against the C library's powf.  The placement
    path never calls it, so it counts no launch."""
    K.check_cuda("pow10_f32", x=x)
    K.check_dtype("pow10_f32", x, torch.float32)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = K.MULTI_COMPACT.fn("pow10_f32")(
            x.data_ptr(), y.data_ptr(), x.numel(), K.stream_of(x))
    if rc != 0:
        raise RuntimeError(f"pow10_f32: CUDA launch failed with "
                           f"cudaError {rc}")
    return y


def binpack_score(cap: torch.Tensor,         # [..., 3] float32
                  used: torch.Tensor,        # [..., 3] float32
                  req: torch.Tensor,         # [..., 3] float32 broadcastable
                  spread_algo: bool = False,
                  ) -> torch.Tensor:
    """structs.ScoreFit vectorised: only cpu (0) and memory (1) count."""
    total_used = used + req
    safe_cap = torch.clamp(cap, min=1.0)
    free = 1.0 - torch.clamp(total_used / safe_cap, max=1.0)
    total = pow10(free[..., 0]) + pow10(free[..., 1])
    score = (total - 2.0) if spread_algo else (20.0 - total)
    score = torch.clamp(score, 0.0, MAX_FIT_SCORE)
    ok = (cap[..., 0] > 0) & (cap[..., 1] > 0)
    return torch.where(ok, score, 0.0)


def fmaf(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add, a * b + c rounded once, on any device.

    XLA's CPU backend contracts a multiply feeding an add into one fma
    inside a fusion (the reference's spread sum and preemption cost get
    it), so the plain versions must too: the product is exact in
    float64, the sum is taken in float64 rounded to odd (its TwoSum
    error moves an inexact even result one ulp toward the true value),
    and rounding that to float32 is the correctly rounded fma."""
    p = a.to(torch.float64) * torch.as_tensor(b, dtype=torch.float64,
                                              device=a.device)
    cd = c.to(torch.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits)
    return bits.view(torch.float64).to(torch.float32)


def capacity_fit(cap: torch.Tensor,          # [N, 3] int32
                 used: torch.Tensor,         # [N, 3] int32
                 req: torch.Tensor,          # [..., 3] int32
                 ) -> torch.Tensor:          # [...] bool
    """AllocsFit's dimension check (ports are checked on the host)."""
    return (used + req <= cap).all(dim=-1)


def spread_boost(sp_nodeval: torch.Tensor,   # [S, N] int32, -1 none
                 sp_weight: torch.Tensor,    # [S] float32 (0 = padding)
                 sp_expected: torch.Tensor,  # [S, K] float32
                 sp_counts: torch.Tensor,    # [S, K] float32
                 ) -> torch.Tensor:          # [N] float32
    """SpreadIterator: boost toward the target counts,
    (expected - count) / max(expected, 1) clipped to [-1, 1], 0 for a
    node whose value is not a target, weighted by weight/100 and averaged
    over the non-padding spreads.

    In the reference's order: `/ 100.0` compiles to a multiply by
    f32(0.01) (XLA's reciprocal rewrite), and the weighted sum over S
    runs from 0, one fma per spread (XLA fuses the product into the
    reduction)."""
    k = sp_counts.shape[1]
    val = sp_nodeval.long().clamp(0, k - 1)
    exp_n = sp_expected.gather(1, val)
    cnt_n = sp_counts.gather(1, val)
    boost = (exp_n - cnt_n) / torch.clamp(exp_n, min=1.0)
    boost = torch.clamp(boost, -1.0, 1.0)
    boost = torch.where(sp_nodeval >= 0, boost, 0.0)
    w = sp_weight * torch.tensor(0.01, dtype=torch.float32,
                                 device=sp_weight.device)
    n_active = torch.clamp((sp_weight > 0).sum(), min=1).to(torch.float32)
    acc = torch.zeros_like(boost[0])
    for s in range(boost.shape[0]):
        acc = fmaf(boost[s], w[s], acc)
    return acc / n_active


def job_anti_affinity(job_count: torch.Tensor,   # [..., N] int32
                      desired: torch.Tensor,     # [...] int32
                      ) -> torch.Tensor:         # [..., N] float32
    """-(collisions / max(desired, 1)) (reference JobAntiAffinityIterator)."""
    d = torch.clamp(desired.to(torch.float32), min=1.0)
    return -(job_count.to(torch.float32) / d)


def normalize_scores(components: Sequence[torch.Tensor],
                     active: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean of the components that apply (ScoreNormalizationIterator).
    The sum runs component by component from 0, the order of XLA's
    reduce over the stacked axis."""
    acc = torch.zeros_like(components[0])
    cnt = torch.zeros(components[0].shape, dtype=torch.int32,
                      device=components[0].device)
    for comp, act in zip(components, active):
        acc = acc + torch.where(act, comp, 0.0)
        cnt = cnt + act.to(torch.int32)
    return acc / torch.clamp(cnt, min=1).to(torch.float32)


def constraint_mask_rows(attrs, con, luts):
    """Per-row (no all-reduce) predicate evaluation: [G, C, N] bool;
    opcodes outside the five evaluate False."""
    return _row_predicates(attrs, con, luts, False)


def affinity_score(attrs: torch.Tensor,      # [N, A]
                   aff: torch.Tensor,        # [G, Af, 4] (col, op, arg, w)
                   luts: torch.Tensor,       # [L, V]
                   ) -> torch.Tensor:        # [G, N] float32
    """Normalised sum of matched affinity weights (NodeAffinityIterator);
    weight-0 padding rows contribute nothing."""
    matched = constraint_mask_rows(attrs, aff[..., :3], luts)   # [G, Af, N]
    w = aff[..., 3].to(torch.float32)                            # [G, Af]
    total = w.abs().sum(dim=1, keepdim=True)                     # [G, 1]
    # `+ 0.0`: an all-zero sum is +0.0, as the kernel's accumulator
    # (started at +0.0) gives it
    got = (matched.to(torch.float32) * w[..., None]).sum(dim=1) + 0.0
    return torch.where(total > 0, got / torch.clamp(total, min=1.0), 0.0)


def affinity_landscape_plain(attrs, aff, luts,
                             rows: Optional[torch.Tensor] = None):
    """Plain version of K1's affinity entry: [Ua, N], or with `rows`
    ([Lr, Nc] node rows, out-of-range rows clamped like a JAX gather)
    the per-frame [Lr, Ua, Nc] landscape."""
    if rows is None:
        return affinity_score(attrs, aff, luts)
    n = attrs.shape[0]
    return torch.stack([
        affinity_score(attrs[r.long().clamp(0, n - 1)], aff, luts)
        for r in rows])


def affinity_landscape(attrs: torch.Tensor, aff: torch.Tensor,
                       luts: torch.Tensor,
                       rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Affinity landscape per signature.  A CPU tensor takes the plain
    version; a CUDA tensor launches K1 (or raises)."""
    if attrs.is_cpu:
        return affinity_landscape_plain(attrs, aff, luts, rows)
    return _k1_launch("landscape_affinity", attrs, luts, aff=aff,
                      rows=rows)[1]


def landscapes(attrs, con, luts, elig, base_mask, u_mask, aff,
               node_ok: Optional[torch.Tensor] = None):
    """K1's two landscapes of the same N rows: (landscape_mask's [U, N]
    static mask, affinity_landscape's [Ua, N] affinity).  A CPU tensor
    takes the plain versions; a CUDA tensor launches K1 once for both
    (or raises)."""
    if attrs.is_cpu:
        return (landscape_mask_plain(attrs, con, luts,
                                     and_rows(elig, node_ok), base_mask,
                                     u_mask),
                affinity_landscape_plain(attrs, aff, luts))
    return _k1_launch("landscape_pair", attrs, luts,
                      mask=(con, elig, base_mask, u_mask, node_ok), aff=aff)
