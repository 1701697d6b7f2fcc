"""K5's plain version (`select.place` / `place_packed`) against the
reference's `place_jit` / `place_packed_jit` on the same seeded inputs.

Picks, top-k rows, metric columns, usage and job counts must match
exactly; the bitcast score columns agree to the bit.  Also pins the two
XLA habits the scan's spread score depends on: `sp_weight / 100.0` is a
multiply by f32(0.01), and the weighted sum over spreads is fused into
one fma per spread.
"""

import jax
import numpy as np
import pytest
import torch

from nomad_tpu.ops.scoring import spread_boost as ref_spread_boost
from nomad_tpu.ops.select import place_jit, place_packed_jit
from nomad_tpu_torch.ops.convert import (
    placement_inputs_from_numpy,
    placement_inputs_to_numpy,
)
from nomad_tpu_torch.ops.scoring import fmaf, spread_boost
from nomad_tpu_torch.ops.select import place, place_packed
from torch_parity import (
    MEMO_SCAN_CASES,
    memo_identity,
    random_placement_arrays,
    reference_placement_inputs,
)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


CASES = {
    "binpack": dict(),
    "spread_algo": dict(spread_algo=True),
    "spread_stanza_s2": dict(s=2, k=3, p=32),
    "spread_stanza_s3_k5": dict(s=3, k=5, p=32, tight=True),
    "affinity_no_seed": dict(seed=0),
    "distinct_hosts": dict(dh=True, tight=True, p=32),
    "distinct_property": dict(d=2, kd=3, p=32),
    "reschedule_prev_row": dict(prev=True),
    "extra_mask": dict(extra=True),
    "one_node": dict(n=1, g=3, p=8),
    "two_nodes": dict(n=2, p=8, p_real=5),
    # a pow2-padded batch: 27 real steps of 32, the last five inactive
    "padded_p": dict(p=32, p_real=27, tight=True, s=1, d=1, dh=True),
    "few_feasible": dict(n=6, p=16, tight=True),
}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("case", sorted(CASES))
def test_place_packed_matches_reference(case):
    for rep in range(2):
        arr = random_placement_arrays(np.random.default_rng(100 + rep),
                                      **CASES[case])
        want = place_packed_jit(reference_placement_inputs(arr))
        got = place_packed(placement_inputs_from_numpy(arr))
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("case", sorted(MEMO_SCAN_CASES))
def test_place_packed_matches_reference_on_memo_inputs(case):
    """The inputs of K5's memo cases (groups alternating, inactive steps
    between active ones, an infeasible group, N < 3 with padding)."""
    arr = random_placement_arrays(np.random.default_rng(150),
                                  **MEMO_SCAN_CASES[case])
    want = place_packed_jit(reference_placement_inputs(arr))
    got = place_packed(placement_inputs_from_numpy(arr))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("case", sorted(MEMO_SCAN_CASES))
def test_reference_output_has_the_memo_identity(case):
    """The reference's own scan output: steps of one group with no commit
    between them have equal metric columns, and such a step that is
    inactive, or follows one with no feasible row, places nothing.  The
    kernels' memo writes these rows without a pass."""
    arr = random_placement_arrays(np.random.default_rng(150),
                                  **MEMO_SCAN_CASES[case])
    buf = np.asarray(place_packed_jit(reference_placement_inputs(arr))[0])
    assert memo_identity(buf, arr["tg_idx"], arr["active"]) > 0


def test_place_outputs_match_reference():
    """The unpacked outputs field by field, on a case with every
    component active."""
    arr = random_placement_arrays(np.random.default_rng(7), s=2, d=1,
                                  prev=True, extra=True, dh=True, p=32,
                                  p_real=30, tight=True)
    want = place_jit(reference_placement_inputs(arr))
    got = place(placement_inputs_from_numpy(arr))
    assert got._fields == want._fields
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, f
        assert np.array_equal(_bits(w), _bits(g)), f


@pytest.mark.parametrize("case", ["binpack", "distinct_property",
                                  "one_node", "padded_p", "two_nodes"])
def test_ops_place_matches_reference_place(case):
    """`nomad_tpu_torch.ops.place`, exported where the reference exports
    `place` and `place_jit`: on CPU tensors it is the plain scan and
    equals `place_jit` field by field.  The card path unpacks K5's
    [P, 14] buffer (`unpack_outputs`); unpacking the packed plain
    outputs gives the same fields back, top lists of min(3, N)."""
    from nomad_tpu_torch.ops import place as ops_place
    from nomad_tpu_torch.ops.select import pack_outputs, unpack_outputs
    arr = random_placement_arrays(np.random.default_rng(40), **CASES[case])
    want = place_jit(reference_placement_inputs(arr))
    got = ops_place(placement_inputs_from_numpy(arr))
    back = unpack_outputs(*pack_outputs(got))
    for out in (got, back):
        assert out._fields == want._fields
        for f in want._fields:
            w, g = np.asarray(getattr(want, f)), getattr(out, f).numpy()
            assert w.dtype == g.dtype and w.shape == g.shape, f
            assert np.array_equal(_bits(w), _bits(g)), f


def test_inactive_steps_still_report_metrics():
    """Padding steps pick nothing but carry the step's feasibility
    counts, so the packed buffer equals the reference's whole."""
    arr = random_placement_arrays(np.random.default_rng(3), p=16,
                                  p_real=9)
    buf = place_packed(placement_inputs_from_numpy(arr))[0].numpy()
    assert (buf[9:, 0] == -1).all()
    assert (buf[9:, 8] > 0).all()
    assert np.array_equal(
        buf, np.asarray(place_packed_jit(reference_placement_inputs(arr))[0]))


def test_fewer_feasible_rows_than_top_k():
    """With fewer feasible rows than 3, the top-3 reports infeasible rows
    at score NEG_INF, lowest rows first (-1e30 + noise == -1e30 in f32);
    with N < 3 the missing slots pad with -1 and 0."""
    arr = random_placement_arrays(np.random.default_rng(2), n=5, p=8)
    arr["elig"][:] = False
    arr["elig"][3] = True
    arr["con"][:] = 0
    arr["extra_mask"] = None
    buf = place_packed(placement_inputs_from_numpy(arr))[0].numpy()
    assert np.array_equal(
        buf, np.asarray(place_packed_jit(reference_placement_inputs(arr))[0]))
    placed = buf[buf[:, 0] >= 0]
    assert len(placed)
    assert (placed[:, 2] == 3).all() and (placed[:, 3:5] == [0, 1]).all()
    assert (placed[:, 6:8].view(np.float32) == np.float32(-1e30)).all()
    arr = random_placement_arrays(np.random.default_rng(2), n=2, g=1, p=8)
    buf = place_packed(placement_inputs_from_numpy(arr))[0].numpy()
    assert (buf[:, 4] == -1).all() and (buf[:, 7] == 0).all()
    assert np.array_equal(
        buf, np.asarray(place_packed_jit(reference_placement_inputs(arr))[0]))


def test_over_capacity_unrequested_dimension_is_infeasible():
    """A node over capacity in a dimension the group does not request is
    infeasible (tests/test_ops.py:418's case, exact scan)."""
    n, p = 8, 64
    arr = random_placement_arrays(np.random.default_rng(0), n=n, g=1, p=p)
    arr.update(
        cap=np.tile(np.array([[4000, 8192, 1000]], np.int32), (n, 1)),
        used0=np.zeros((n, 3), np.int32), elig=np.ones(n, bool),
        dc_mask=np.ones(n, bool), pool_mask=np.ones(n, bool),
        con=np.zeros((1, 0, 3), np.int32), aff=np.zeros((1, 0, 4), np.int32),
        req=np.array([[100, 10, 0]], np.int32), extra_mask=None)
    arr["used0"][0, 2] = 1100
    got = place(placement_inputs_from_numpy(arr))
    assert (got.picks.numpy() != 0).all()
    want = place_jit(reference_placement_inputs(arr))
    assert np.array_equal(np.asarray(want.picks), got.picks.numpy())


def test_spread_weight_division_is_a_reciprocal_multiply():
    """XLA compiles `w / 100.0` as `w * f32(0.01)`, which differs from
    the IEEE division for some weights; the port multiplies."""
    w = (np.random.default_rng(1).random(20000) * 100).astype(np.float32)
    got = np.asarray(jax.jit(lambda v: v / 100.0)(w))
    mul = w * np.float32(0.01)
    assert np.array_equal(got, mul)
    assert not np.array_equal(got, w / np.float32(100.0))


@pytest.mark.parametrize("s", [1, 2, 3, 4])
def test_spread_boost_matches_reference(s):
    """The weighted sum over spreads is one fma per spread under XLA;
    the port's `fmaf` gives the same bits, where a separate multiply
    and add would not."""
    rng = np.random.default_rng(s)
    k, n = 6, 30000
    nodeval = rng.integers(-1, k, (s, n)).astype(np.int32)
    weight = (rng.random(s) * 100).astype(np.float32)
    expected = (rng.random((s, k)) * 300).astype(np.float32)
    counts = rng.integers(0, 300, (s, k)).astype(np.float32)
    want = np.asarray(jax.jit(ref_spread_boost)(nodeval, weight, expected,
                                                counts))
    args = [torch.tensor(x) for x in (nodeval, weight, expected, counts)]
    got = spread_boost(*args).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    if s > 1:
        # the unfused sum differs somewhere: the fma is load-bearing
        val = torch.tensor(nodeval).long().clamp(0, k - 1)
        e = args[2].gather(1, val)
        b = torch.clamp((e - args[3].gather(1, val)) / e.clamp(min=1.0),
                        -1.0, 1.0)
        b = torch.where(args[0] >= 0, b, 0.0)
        w = args[1] * torch.tensor(0.01)
        acc = torch.zeros(n)
        for i in range(s):
            acc = acc + b[i] * w[i]
        unfused = (acc / float(s)).numpy()
        assert not np.array_equal(unfused.view(np.int32), got.view(np.int32))


def test_fmaf_rounds_once():
    """`fmaf` equals the exactly rounded a * b + c (checked with
    Python's exact rationals) on random and cancelling operands."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.standard_normal(3000)
                                         * 1e-7)).astype(np.float32)
    got = fmaf(torch.tensor(a), torch.tensor(b), torch.tensor(c)).numpy()
    for i in range(0, 3000, 3):
        ex = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        f = np.float32(float(ex))
        near = [np.nextafter(f, np.float32(-np.inf)), f,
                np.nextafter(f, np.float32(np.inf))]
        best = min(near, key=lambda v: (abs(Fraction(float(v)) - ex),
                                        int(v.view(np.int32)) & 1))
        assert best.view(np.int32) == got[i].view(np.int32)


def test_numpy_round_trip():
    arr = random_placement_arrays(np.random.default_rng(4), s=1, extra=True)
    back = placement_inputs_to_numpy(placement_inputs_from_numpy(arr))
    for k, v in arr.items():
        assert np.array_equal(np.asarray(v), np.asarray(back[k])), k
