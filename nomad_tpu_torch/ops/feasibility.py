"""Feasibility masks (reference: nomad_tpu/ops/feasibility.py).

`constraint_mask` / `feasible_mask_plain` are the plain PyTorch versions
of the reference's jnp functions: every packed constraint row evaluated
against every node.  Two wrappers launch kernels of `csrc/landscape.cu`:

  landscape_mask  K1's mask entry: the deduped per-signature static
                  landscape `constraint_mask(attrs, con, luts) & elig &
                  base_mask[u_mask]` that the multi-eval launches, the
                  solo kernels' statics and the lane prover consume;
  feasible_mask   K8: the [G, N] static feasibility of the preemption
                  fallback and the system scheduler (one base row
                  `elig & dc & pool`, every group mapped to it).
"""

from __future__ import annotations

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
    raises): K1's mask pass with one base row `dc & pool` and every
    group mapped to it."""
    if attrs.device.type == "cpu":
        return feasible_mask_plain(attrs, elig, dc_mask, pool_mask, con,
                                   luts)
    name = "feasible_mask"
    K.check_dtype(name, attrs, torch.int32, 2)
    K.check_dtype(name, con, torch.int32, 3)
    K.check_dtype(name, luts, torch.bool, 2)
    for key, t in (("elig", elig), ("dc_mask", dc_mask),
                   ("pool_mask", pool_mask)):
        K.check_dtype(f"{name}.{key}", t, torch.bool, 1)
    K.check_cuda(name, attrs=attrs, elig=elig, dc_mask=dc_mask,
                 pool_mask=pool_mask, con=con, luts=luts)
    if dc_mask.shape != pool_mask.shape:
        raise ValueError(f"{name}: inconsistent shapes")
    base = (dc_mask & pool_mask)[None]
    u_mask = torch.zeros(con.shape[0], dtype=torch.int32,
                         device=attrs.device)
    return _mask_launch(K.FEASIBLE, name, attrs, con, luts, elig, base,
                        u_mask)


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
                   ) -> torch.Tensor:        # [U, N] bool
    """Per-signature static landscape.  A CPU tensor takes the plain
    version; a CUDA tensor launches K1 (or raises)."""
    if attrs.device.type == "cpu":
        return landscape_mask_plain(attrs, con, luts, elig, base_mask,
                                    u_mask)
    return _mask_launch(K.LANDSCAPE, "landscape_mask", attrs, con, luts,
                        elig, base_mask, u_mask)


def _mask_launch(kernel, name, attrs, con, luts, elig, base_mask, u_mask):
    """One launch of csrc/landscape.cu's mask pass through `name`'s entry,
    counted on `kernel`."""
    K.check_cuda(name, attrs=attrs, con=con, luts=luts, elig=elig,
                 base_mask=base_mask, u_mask=u_mask)
    K.check_dtype(name, attrs, torch.int32, 2)
    K.check_dtype(name, con, torch.int32, 3)
    K.check_dtype(name, luts, torch.bool, 2)
    K.check_dtype(name, elig, torch.bool, 1)
    K.check_dtype(name, base_mask, torch.bool, 2)
    K.check_dtype(name, u_mask, torch.int32, 1)
    n, a = attrs.shape
    u, c, three = con.shape
    if (three != 3 or elig.shape[0] != n or base_mask.shape[1] != n
            or u_mask.shape[0] != u or 0 in luts.shape or a == 0):
        raise ValueError(f"{name}: inconsistent shapes")
    out = torch.empty((u, n), dtype=torch.bool, device=attrs.device)
    if u and n:
        kernel.launch(
            attrs.get_device(), name, attrs.data_ptr(), n, a,
            con.data_ptr(), u, c, luts.data_ptr(), luts.shape[0],
            luts.shape[1],
            elig.data_ptr(), base_mask.data_ptr(), u_mask.data_ptr(),
            out.data_ptr())
    return out
