"""K1's plain versions against the reference's constraint_mask and
affinity_score, every opcode included.

A parametrised table pins each opcode (EQ, NEQ, IS_SET, IS_NOT_SET, LUT
and the always-true padding row) on set and unset attributes; a
hypothesis search draws random packed constraint and affinity tables
over a small attribute matrix.  Masks must match exactly; affinity
scores are sums of integer weights over an integer total, so their f32
values must match exactly.  Values, not bits: the sign of an all-zero
sum follows XLA's lowering of the weight einsum (a one-row dot keeps
the product's -0.0), and it never reaches a score, where
normalize_scores adds it to +0.0.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from nomad_tpu.ops.feasibility import constraint_mask as ref_mask
from nomad_tpu.ops.feasibility import feasible_mask as ref_feasible
from nomad_tpu.ops.scoring import affinity_score as ref_affinity
from nomad_tpu.pack.packer import (
    DOP_EQ,
    DOP_IS_NOT_SET,
    DOP_IS_SET,
    DOP_LUT,
    DOP_NEQ,
    DOP_TRUE,
)
from nomad_tpu_torch.ops.feasibility import (
    constraint_mask,
    feasible_mask,
    landscape_mask,
)
from nomad_tpu_torch.ops.scoring import affinity_landscape, affinity_score

OPS = (DOP_TRUE, DOP_EQ, DOP_NEQ, DOP_IS_SET, DOP_IS_NOT_SET, DOP_LUT)
N_NODES, N_ATTR, N_LUT, N_VOCAB = 40, 4, 3, 6


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cluster(seed=0):
    rng = np.random.default_rng(seed)
    attrs = rng.integers(-1, N_VOCAB, (N_NODES, N_ATTR)).astype(np.int32)
    luts = rng.random((N_LUT, N_VOCAB)) < 0.5
    return attrs, luts


def _both_masks(attrs, con, luts):
    want = np.asarray(ref_mask(jnp.asarray(attrs), jnp.asarray(con),
                               jnp.asarray(luts)))
    got = constraint_mask(torch.tensor(attrs), torch.tensor(con),
                          torch.tensor(luts)).numpy()
    return want, got


def _both_affinity(attrs, aff, luts):
    want = np.asarray(ref_affinity(jnp.asarray(attrs), jnp.asarray(aff),
                                   jnp.asarray(luts)))
    got = affinity_score(torch.tensor(attrs), torch.tensor(aff),
                         torch.tensor(luts)).numpy()
    return want, got


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("arg", [0, 2, 5])
def test_each_opcode_matches_reference(op, arg):
    attrs, luts = _cluster()
    attrs[::5, 1] = -1                      # unset attribute rows
    con = np.array([[[1, op, arg]]], np.int32)
    want, got = _both_masks(attrs, con, luts)
    assert want.dtype == got.dtype and np.array_equal(want, got)
    aff = np.array([[[1, op, arg, 7], [2, DOP_EQ, 1, -3]]], np.int32)
    want, got = _both_affinity(attrs, aff, luts)
    assert want.dtype == got.dtype and np.array_equal(want, got)


rows = st.tuples(st.integers(0, N_ATTR - 1), st.sampled_from(OPS),
                 st.integers(-1, N_VOCAB + 1))


@settings(max_examples=60, deadline=None)
@given(con=st.lists(st.lists(rows, min_size=1, max_size=4),
                    min_size=1, max_size=3).filter(
                        lambda c: len({len(g) for g in c}) == 1),
       weights=st.lists(st.integers(-100, 100), min_size=4, max_size=4),
       seed=st.integers(0, 3))
def test_random_tables_match_reference(con, weights, seed):
    attrs, luts = _cluster(seed)
    con = np.array(con, np.int32)                     # [G, C, 3]
    want, got = _both_masks(attrs, con, luts)
    assert np.array_equal(want, got)
    g, c = con.shape[:2]
    w = np.resize(np.array(weights, np.int32), (g, c, 1))
    aff = np.concatenate([con, w], axis=2)            # [G, C, 4]
    want, got = _both_affinity(attrs, aff, luts)
    assert want.dtype == got.dtype and np.array_equal(want, got)


def test_feasible_mask_matches_reference():
    attrs, luts = _cluster(1)
    rng = np.random.default_rng(2)
    elig, dc, pool = (rng.random(N_NODES) < 0.8 for _ in range(3))
    con = np.array([[[0, DOP_LUT, 1], [2, DOP_NEQ, 3]],
                    [[3, DOP_IS_SET, 0], [0, DOP_TRUE, 0]]], np.int32)
    want = np.asarray(ref_feasible(*map(jnp.asarray,
                                        (attrs, elig, dc, pool, con, luts))))
    got = feasible_mask(*map(torch.tensor,
                             (attrs, elig, dc, pool, con, luts))).numpy()
    assert np.array_equal(want, got)


def test_landscape_entries_match_reference_expressions():
    """The wrapper's mask is the reference's per-signature expression
    `constraint_mask & elig & base_mask[u_mask]`; its frame affinity is
    affinity_score over the frame's rows (padding rows clamped)."""
    attrs, luts = _cluster(3)
    rng = np.random.default_rng(4)
    elig = rng.random(N_NODES) < 0.9
    base = rng.random((2, N_NODES)) < 0.7
    u_mask = np.array([1, 0, 1], np.int32)
    con = np.array([[[0, DOP_LUT, 0]], [[1, DOP_EQ, 2]], [[2, DOP_NEQ, 1]]],
                   np.int32)
    want = (np.asarray(ref_mask(jnp.asarray(attrs), jnp.asarray(con),
                                jnp.asarray(luts)))
            & elig[None] & base[u_mask])
    got = landscape_mask(*map(torch.tensor,
                              (attrs, con, luts, elig, base, u_mask)))
    assert np.array_equal(want, got.numpy())

    aff = np.array([[[0, DOP_LUT, 1, 5], [3, DOP_IS_SET, 0, -2]]], np.int32)
    frames = np.array([[0, 5, 9, N_NODES], [1, 2, 3, 4]], np.int32)
    got = affinity_landscape(torch.tensor(attrs), torch.tensor(aff),
                             torch.tensor(luts), torch.tensor(frames))
    for li, frame in enumerate(frames):
        sub = attrs[np.minimum(frame, N_NODES - 1)]
        want = np.asarray(ref_affinity(jnp.asarray(sub), jnp.asarray(aff),
                                       jnp.asarray(luts)))
        assert np.array_equal(want, got[li].numpy())


def _signature_tables(rng, u, c, ua, af):
    """Random packed constraint [u, c, 3] and affinity [ua, af, 4] tables
    over the small cluster, every opcode drawn."""
    def rows(g, k):
        return np.stack([rng.integers(0, N_ATTR, (g, k)),
                         rng.choice(OPS, (g, k)),
                         rng.integers(-1, N_VOCAB + 1, (g, k))],
                        axis=2).astype(np.int32)
    con = rows(u, c)
    aff = np.concatenate([rows(ua, af),
                          rng.integers(-50, 50, (ua, af, 1)).astype(np.int32)],
                         axis=2)
    return con, aff


# (signatures, constraint rows, affinity signatures, affinity rows,
# node_ok, base table rows)
FUSED_CASES = {
    "one_signature": (1, 3, 1, 2, False, 1),
    "five_signatures_node_ok": (5, 4, 2, 3, True, 3),
    "no_constraint_rows": (3, 0, 1, 1, True, 2),
    "resident_table": (4, 2, 3, 2, False, 8),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_landscapes_match_reference_expressions(case):
    """K1's one-launch pair (`scoring.landscapes`) and the mask's node_ok
    row against the reference's expressions: the mask is
    `constraint_mask & (elig & node_ok) & base_mask[u_mask]`, the refuted
    rows ANDed into `elig` as the reference's engine does, with base rows
    read by index from a table that holds rows no signature takes; the
    affinity is affinity_score over every row."""
    from nomad_tpu_torch.ops.scoring import landscapes

    u, c, ua, af, with_ok, m = FUSED_CASES[case]
    attrs, luts = _cluster(5)
    rng = np.random.default_rng(6)
    con, aff = _signature_tables(rng, u, c, ua, af)
    elig = rng.random(N_NODES) < 0.9
    base = rng.random((m, N_NODES)) < 0.7
    u_mask = rng.integers(0, m, u).astype(np.int32)
    node_ok = rng.random(N_NODES) < 0.8 if with_ok else None
    ok = elig if node_ok is None else elig & node_ok
    want_mask = (np.asarray(ref_mask(jnp.asarray(attrs), jnp.asarray(con),
                                     jnp.asarray(luts)))
                 & ok[None] & base[u_mask])
    want_aff = np.asarray(ref_affinity(jnp.asarray(attrs), jnp.asarray(aff),
                                       jnp.asarray(luts)))
    t = lambda x: None if x is None else torch.tensor(x)
    got_mask, got_aff = landscapes(t(attrs), t(con), t(luts), t(elig),
                                   t(base), t(u_mask), t(aff), t(node_ok))
    assert np.array_equal(want_mask, got_mask.numpy())
    assert want_aff.dtype == got_aff.numpy().dtype
    assert np.array_equal(want_aff, got_aff.numpy())
    got = landscape_mask(t(attrs), t(con), t(luts), t(elig), t(base),
                         t(u_mask), t(node_ok))
    assert np.array_equal(want_mask, got.numpy())
