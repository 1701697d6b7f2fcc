"""Numpy <-> port tensors for the kernels' inputs.

The reference's lowered inputs, converted to numpy arrays field by field,
become the port's `MultiEvalInputs`, `PlacementInputs`, `BulkInputs` or
`preempt_bulk` arguments on a given device (and back), so the JAX
kernels and the port's compute on identical packed cluster state.  The
candidate frames (`cand_rows`, `cand_valid`) convert the same way.  A
mesh engine's inputs convert alike: node axes padded to npad, compact
frames per shard [S, L, Nc_loc] and their seeds (`job_count0`)
[S, J', Nc_loc].
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .select import BulkInputs, MultiEvalInputs, PlacementInputs

_BOOL_FIELDS = ("elig", "luts", "base_mask", "node_ok")


def multi_inputs_from_numpy(arrays: Dict[str, np.ndarray],
                            device="cpu") -> MultiEvalInputs:
    """`arrays` holds one numpy array per MultiEvalInputs field (integer
    fields int32, masks bool, `seed` uint32 of shape [G] or [],
    `spread_algo` a bool scalar; `job_count0` [G, N], [J', Nc] or, on a
    mesh, [S, J', Nc_loc]); `node_ok` may be missing or None."""
    out = {}
    for name in MultiEvalInputs._fields:
        a = arrays[name] if name != "node_ok" else arrays.get(name)
        if name == "spread_algo":
            out[name] = bool(np.asarray(a))
        elif name == "seed":
            out[name] = torch.tensor(np.asarray(a, np.uint32).astype(np.int64),
                                     device=device)
        elif a is None:
            out[name] = None
        elif name in _BOOL_FIELDS:
            out[name] = torch.tensor(np.asarray(a, bool), device=device)
        else:
            out[name] = torch.tensor(np.asarray(a, np.int32), device=device)
    return MultiEvalInputs(**out)


def multi_inputs_to_numpy(inp: MultiEvalInputs) -> Dict[str, np.ndarray]:
    """Inverse of `multi_inputs_from_numpy`."""
    out = {}
    for name, v in zip(MultiEvalInputs._fields, inp):
        if name == "spread_algo":
            out[name] = np.bool_(v)
        elif name == "seed":
            out[name] = v.cpu().numpy().astype(np.uint32)
        elif v is None:
            out[name] = None
        else:
            out[name] = v.cpu().numpy()
    return out


def frames_from_numpy(cand_rows: np.ndarray, cand_valid: np.ndarray,
                      device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact candidate frames: [L, Nc] rows (padding = N), or a mesh
    engine's per-shard [S, L, Nc_loc] (global rows, padding = npad); and
    their validity."""
    cand_rows, cand_valid = np.asarray(cand_rows), np.asarray(cand_valid)
    if cand_rows.ndim not in (2, 3) or cand_rows.shape != cand_valid.shape:
        raise ValueError(f"frames must be [L, Nc] or [S, L, Nc_loc], got "
                         f"{cand_rows.shape} and {cand_valid.shape}")
    return (torch.tensor(cand_rows.astype(np.int32), device=device),
            torch.tensor(cand_valid.astype(bool), device=device))


# fields that are Python values in the port's solo inputs
_SCALAR_BOOL = ("spread_algo",)
_SCALAR_INT = ("seed", "g", "p_real")
_SOLO_BOOL = ("elig", "dc_mask", "pool_mask", "luts", "pd_apply", "active",
              "extra_mask")
_SOLO_F32 = ("sp_weight", "sp_expected", "sp_counts0")


def _solo_from_numpy(cls, arrays, device):
    out = {}
    for name in cls._fields:
        a = arrays.get(name)
        if name in _SCALAR_BOOL:
            out[name] = bool(np.asarray(a))
        elif name in _SCALAR_INT:
            out[name] = int(np.asarray(a if a is not None else 0))
        elif a is None:
            out[name] = None
        elif name in _SOLO_BOOL:
            out[name] = torch.tensor(np.asarray(a, bool), device=device)
        elif name in _SOLO_F32:
            out[name] = torch.tensor(np.asarray(a, np.float32),
                                     device=device)
        else:
            out[name] = torch.tensor(np.asarray(a, np.int32), device=device)
    return cls(**out)


def _solo_to_numpy(inp) -> Dict[str, np.ndarray]:
    out = {}
    for name, v in zip(type(inp)._fields, inp):
        if name in _SCALAR_BOOL:
            out[name] = np.bool_(v)
        elif name == "seed":
            out[name] = np.uint32(v)
        elif name in _SCALAR_INT:
            out[name] = np.int32(v)
        elif v is None:
            out[name] = None
        else:
            out[name] = v.cpu().numpy()
    return out


def placement_inputs_from_numpy(arrays: Dict[str, np.ndarray],
                                device="cpu") -> PlacementInputs:
    """`arrays` holds one numpy array per PlacementInputs field, as the
    reference's PlacementInputs carries them (`seed` a uint32 scalar,
    `spread_algo` a bool scalar, `extra_mask` optional)."""
    return _solo_from_numpy(PlacementInputs, arrays, device)


def placement_inputs_to_numpy(inp: PlacementInputs) -> Dict[str, np.ndarray]:
    """Inverse of `placement_inputs_from_numpy`."""
    return _solo_to_numpy(inp)


def bulk_inputs_from_numpy(arrays: Dict[str, np.ndarray],
                           device="cpu") -> BulkInputs:
    """One numpy array per BulkInputs field (`g`, `p_real` int32 and
    `seed` uint32 scalars)."""
    return _solo_from_numpy(BulkInputs, arrays, device)


def bulk_inputs_to_numpy(inp: BulkInputs) -> Dict[str, np.ndarray]:
    """Inverse of `bulk_inputs_from_numpy`."""
    return _solo_to_numpy(inp)


class PreemptArgs(NamedTuple):
    """`preempt.preempt_bulk`'s arguments, in its order."""
    cap: torch.Tensor         # [M, 3] int32
    used0: torch.Tensor       # [M, 3] int32
    static_g: torch.Tensor    # [M] bool
    dh_limit_g: int
    job_count0: torch.Tensor  # [M] int32
    pre_prio: torch.Tensor    # [M, A] int32
    pre_res: torch.Tensor     # [M, A, 3] int32
    req: torch.Tensor         # [3] int32
    k0: torch.Tensor          # [M] int32
    n_place: int
    n_real: int


def preempt_args_from_numpy(args, device="cpu") -> PreemptArgs:
    """The reference's positional `preempt_bulk` arguments (numpy arrays
    or scalars) as the port's."""
    out = []
    for name, a in zip(PreemptArgs._fields, args):
        if name in ("dh_limit_g", "n_place", "n_real"):
            out.append(int(np.asarray(a)))
        elif name == "static_g":
            out.append(torch.tensor(np.asarray(a, bool), device=device))
        else:
            out.append(torch.tensor(np.asarray(a, np.int32), device=device))
    return PreemptArgs(*out)
