"""Feasibility masks (reference: nomad_tpu/ops/feasibility.py).

`constraint_mask` / `feasible_mask_plain` are the plain PyTorch versions
of the reference's jnp functions: every packed constraint row evaluated
against every node.  Two wrappers launch kernels of `csrc/landscape.cu`:

  landscape_mask  K1's mask entry: the deduped per-signature static
                  landscape `constraint_mask(attrs, con, luts) & elig &
                  base_mask[u_mask]` that the multi-eval launches and the
                  lane prover consume, with an optional `node_ok` row
                  (the refuted nodes) ANDed in;
  feasible_mask   K8: the [G, N] static feasibility of the preemption
                  fallback, the system scheduler and the solo kernels'
                  statics: K1's mask pass with `dc_mask` the one base
                  row, `pool_mask` the node_ok row and no group map.

K1's affinity entry and its fused mask + affinity entry are in
scoring.py; all four go through `_k1_launch`.
"""

from __future__ import annotations

from typing import Optional

import torch

from nomad_tpu_torch.pack.interner import UNSET
from nomad_tpu_torch.pack.packer import (
    DOP_EQ,
    DOP_IS_NOT_SET,
    DOP_IS_SET,
    DOP_LUT,
    DOP_NEQ,
)

from . import kernels as K


def _row_predicates(attrs: torch.Tensor, con: torch.Tensor,
                    luts: torch.Tensor, other: bool) -> torch.Tensor:
    """[G, C, N] per-row predicate values; `other` is the value of an
    opcode outside the five (DOP_TRUE padding rows)."""
    n, a = attrs.shape
    cols = con[..., 0].long().clamp(0, a - 1)          # [G, C]
    ops = con[..., 1][..., None]                       # [G, C, 1]
    args = con[..., 2]                                 # [G, C]
    av = attrs[:, cols].permute(1, 2, 0)               # [G, C, N]
    is_set = av != UNSET
    arg_b = args[..., None]
    lut_rows = args.long().clamp(0, luts.shape[0] - 1)
    av_clip = av.long().clamp(0, luts.shape[1] - 1)
    lut_val = luts[lut_rows[..., None], av_clip]       # [G, C, N]
    fallback = torch.full_like(is_set, other)
    return torch.where(
        ops == DOP_EQ, is_set & (av == arg_b),
        torch.where(
            ops == DOP_NEQ, (~is_set) | (av != arg_b),
            torch.where(
                ops == DOP_IS_SET, is_set,
                torch.where(
                    ops == DOP_IS_NOT_SET, ~is_set,
                    torch.where(ops == DOP_LUT, is_set & lut_val,
                                fallback)))))


def constraint_mask(attrs: torch.Tensor,     # [N, A] int32
                    con: torch.Tensor,       # [G, C, 3] int32 (col, op, arg)
                    luts: torch.Tensor,      # [L, V] bool
                    ) -> torch.Tensor:       # [G, N] bool
    """Evaluate every packed constraint row against every node."""
    return _row_predicates(attrs, con, luts, True).all(dim=1)


def feasible_mask_plain(attrs, elig, dc_mask, pool_mask, con, luts):
    """Plain version of K8: eligibility, datacenter and node-pool
    membership, and the constraint rows ([G, N] bool)."""
    base = elig & dc_mask & pool_mask
    return constraint_mask(attrs, con, luts) & base[None, :]


def feasible_mask(attrs: torch.Tensor,       # [N, A] int32
                  elig: torch.Tensor,        # [N] bool
                  dc_mask: torch.Tensor,     # [N] bool
                  pool_mask: torch.Tensor,   # [N] bool
                  con: torch.Tensor,         # [G, C, 3] int32
                  luts: torch.Tensor,        # [L, V] bool
                  ) -> torch.Tensor:         # [G, N] bool
    """Full static feasibility (reference: feasibility.feasible_mask).  A
    CPU tensor takes the plain version; a CUDA tensor launches K8 (or
    raises): K1's pass in one launch, counted on K8, with `dc_mask` the
    one base row (a view) and `pool_mask` ANDed in as node_ok."""
    if attrs.is_cpu:
        return feasible_mask_plain(attrs, elig, dc_mask, pool_mask, con,
                                   luts)
    return _k1_launch("feasible_mask", attrs, luts,
                      mask=(con, elig, dc_mask[None], None, pool_mask),
                      kernel=K.FEASIBLE)[0]


def landscape_mask_plain(attrs, con, luts, elig, base_mask, u_mask):
    """Plain version of K1's mask entry: [U, N] bool."""
    return (constraint_mask(attrs, con, luts) & elig[None, :]
            & base_mask[u_mask.long()])


def landscape_mask(attrs: torch.Tensor,      # [N, A] int32
                   con: torch.Tensor,        # [U, C, 3] int32
                   luts: torch.Tensor,       # [L, V] bool
                   elig: torch.Tensor,       # [N] bool
                   base_mask: torch.Tensor,  # [M, N] bool
                   u_mask: torch.Tensor,     # [U] int32 -> base_mask row
                   node_ok: Optional[torch.Tensor] = None,  # [N] bool
                   ) -> torch.Tensor:        # [U, N] bool
    """Per-signature static landscape, `node_ok` (when given) ANDed into
    the eligibility.  A CPU tensor takes the plain version; a CUDA tensor
    launches K1 (or raises)."""
    if attrs.is_cpu:
        return landscape_mask_plain(attrs, con, luts, and_rows(elig, node_ok),
                                    base_mask, u_mask)
    return _k1_launch("landscape_mask", attrs, luts,
                      mask=(con, elig, base_mask, u_mask, node_ok))[0]


def and_rows(elig: torch.Tensor, node_ok: Optional[torch.Tensor]):
    """`elig & node_ok`, or `elig` without a node_ok row."""
    return elig if node_ok is None else elig & node_ok


_I32, _BOOL = torch.int32, torch.bool


def _k1_launch(symbol: str, attrs, luts, mask=None, aff=None, rows=None,
               kernel=None):
    """One launch of csrc/landscape.cu's K1 pass through entry `symbol`,
    counted on `kernel` (K1 unless given).  `mask` = (con, elig,
    base_mask, u_mask or None, node_ok or None) asks for the [U, N]
    static landscape (a None u_mask, K8's entry, maps every row to base
    row 0 and is not passed), `aff` ([Ua, Af, 4]) for
    the [Ua, N] affinity landscape, or with `rows` ([Lr, Nc] node rows)
    the per-frame [Lr, Ua, Nc] one.  Returns (mask, affinity), None where
    not asked.  The checks are one pass over the inputs (dtype and rank,
    then device and layout) and each output one allocation: the call's
    host time is most of its time."""
    specs = [("attrs", attrs, _I32, 2), ("luts", luts, _BOOL, 2)]
    if mask is not None:
        con, elig, base_mask, u_mask, node_ok = mask
        specs += [("con", con, _I32, 3), ("elig", elig, _BOOL, 1),
                  ("base_mask", base_mask, _BOOL, 2)]
        if u_mask is not None:
            specs.append(("u_mask", u_mask, _I32, 1))
        if node_ok is not None:
            specs.append(("node_ok", node_ok, _BOOL, 1))
    if aff is not None:
        specs.append(("aff", aff, _I32, 3))
        if rows is not None:
            specs.append(("rows", rows, _I32, 2))
    d = K.check_launch(symbol, specs)
    n, a = attrs.shape
    n_lut, n_vocab = luts.shape
    if a == 0 or n_lut == 0 or n_vocab == 0:
        raise ValueError(f"{symbol}: inconsistent shapes")
    args = [attrs.data_ptr(), n, a]
    m_out = a_out = None
    work = False
    if mask is not None:
        u, c, three = con.shape
        if (three != 3 or elig.shape[0] != n or base_mask.shape[1] != n
                or (u_mask is not None and u_mask.shape[0] != u)
                or (node_ok is not None and node_ok.shape[0] != n)):
            raise ValueError(f"{symbol}: inconsistent shapes")
        m_out = attrs.new_empty((u, n), dtype=_BOOL)
        work = u > 0 and n > 0
        args += [con.data_ptr(), u, c, luts.data_ptr(), n_lut, n_vocab,
                 elig.data_ptr(), base_mask.data_ptr()]
        if u_mask is not None:
            args.append(u_mask.data_ptr())
        args += [None if node_ok is None else node_ok.data_ptr(),
                 m_out.data_ptr()]
    if aff is not None:
        ua, af, four = aff.shape
        if four != 4 or n == 0:
            raise ValueError(f"{symbol}: inconsistent shapes")
        if rows is None:
            a_out = attrs.new_empty((ua, n), dtype=torch.float32)
            work = work or ua > 0
            if mask is None:
                args += [None, 1, n]
        else:
            n_sets, nc = rows.shape
            a_out = attrs.new_empty((n_sets, ua, nc), dtype=torch.float32)
            work = work or (ua > 0 and n_sets > 0 and nc > 0)
            args += [rows.data_ptr(), n_sets, nc]
        args += [aff.data_ptr(), ua, af]
        if mask is None:
            args += [luts.data_ptr(), n_lut, n_vocab]
        args.append(a_out.data_ptr())
    if work:
        (kernel or K.LANDSCAPE).launch(d, symbol, *args)
    return m_out, a_out

