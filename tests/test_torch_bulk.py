"""K6's plain version (`select.place_bulk_packed`, and `place_bulk` on
top of it) against the reference's `place_bulk_packed_jit` in all three
output layouts and `place_bulk_jit`, on the same seeded inputs.

Covers a cluster smaller than the round (padded prefix slots), a
`p_real` that is not a multiple of the round, distinct_hosts limits,
the spread algorithm, a device AND-mask, and a node over capacity in a
dimension the group does not request (tests/test_ops.py:418).

K6 runs on the card as K3's flat mode at one group
(csrc/compact_rounds.cu `multi_bulk`): the reference's K6 equals its K3
on the inputs that the port's converter `select.bulk_as_flat` builds
(`test_reference_bulk_is_one_group_flat`), and the port's plain K3 on
them gives its plain K6 in every layout
(`test_bulk_as_flat_matches_bulk`)."""

import numpy as np
import pytest
import torch

from nomad_tpu.ops.select import (
    place_bulk_jit,
    place_bulk_packed_jit,
    place_multi_packed_jit,
)
from nomad_tpu_torch.ops.convert import (
    bulk_inputs_from_numpy,
    bulk_inputs_to_numpy,
    multi_inputs_to_numpy,
    placement_inputs_from_numpy,
)
from nomad_tpu_torch.ops.select import (
    bulk_as_flat,
    place_bulk,
    place_bulk_packed,
    place_bulk_packed_plain,
    place_multi_packed_plain,
)
from torch_parity import (
    BULK_FLAT_CASES,
    bulk_arrays,
    bulk_flat_case,
    random_placement_arrays,
    reference_bulk_inputs,
    reference_multi_inputs,
    reference_placement_inputs,
)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


MODES = {"full": (False, 0), "with_scores": (True, 0), "compact": (False, 8)}
# (arrays kwargs, round size, rounds, p_real)
CASES = {
    "binpack": (dict(n=60), 16, 3, 41),
    "n_below_round": (dict(n=5), 16, 2, 20),
    "spread_algo": (dict(n=60, spread_algo=True), 16, 3, 48),
    "dh_limit": (dict(n=30, dh=True, tight=True), 16, 4, 60),
    "extra_mask_tight": (dict(n=40, extra=True, tight=True), 32, 4, 128),
    "one_node": (dict(n=1), 8, 2, 11),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_bulk_packed_matches_reference(case, mode):
    kw, rs, rounds, p_real = CASES[case]
    ws, fk = MODES[mode]
    arr = random_placement_arrays(np.random.default_rng(9), g=2,
                                  p=rs * rounds, **kw)
    b = bulk_arrays(arr, 1, p_real)
    want = place_bulk_packed_jit(reference_bulk_inputs(b), rs, rounds,
                                 ws, fk)
    got = place_bulk_packed(bulk_inputs_from_numpy(b), rs, rounds, ws, fk)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_place_bulk_matches_reference(case):
    kw, rs, rounds, p_real = CASES[case]
    arr = random_placement_arrays(np.random.default_rng(9), g=2,
                                  p=rs * rounds, **kw)
    arr["tg_idx"] = np.ones(rs * rounds, np.int32)
    arr["active"] = np.arange(rs * rounds) < p_real
    want = place_bulk_jit(reference_placement_inputs(arr), rs)
    got = place_bulk(placement_inputs_from_numpy(arr), rs)
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, f
        if w.dtype == np.float32:
            w, g = w.view(np.int32), g.view(np.int32)
        assert np.array_equal(w, g), f


def test_over_capacity_unrequested_dimension_is_infeasible():
    n, rs = 8, 32
    arr = random_placement_arrays(np.random.default_rng(0), n=n, g=1,
                                  p=64)
    arr.update(
        cap=np.tile(np.array([[4000, 8192, 1000]], np.int32), (n, 1)),
        used0=np.zeros((n, 3), np.int32), elig=np.ones(n, bool),
        dc_mask=np.ones(n, bool), pool_mask=np.ones(n, bool),
        con=np.zeros((1, 0, 3), np.int32), aff=np.zeros((1, 0, 4), np.int32),
        req=np.array([[100, 10, 0]], np.int32), extra_mask=None,
        tg_idx=np.zeros(64, np.int32), active=np.ones(64, bool))
    arr["used0"][0, 2] = 1100
    got = place_bulk(placement_inputs_from_numpy(arr), rs)
    assert (got.picks.numpy() != 0).all()
    want = place_bulk_jit(reference_placement_inputs(arr), rs)
    assert np.array_equal(np.asarray(want.picks), got.picks.numpy())


def test_compact_prefix_overflows_into_full_fills():
    """A round that fills more nodes than the compact prefix holds: the
    small buffer's counts fall short of placed_total, and the full fills
    carry the rest (the engine's overflow protocol)."""
    kw, rs, rounds, p_real = dict(n=60, spread_algo=True), 16, 3, 48
    arr = random_placement_arrays(np.random.default_rng(9), g=2,
                                  p=rs * rounds, **kw)
    b = bulk_inputs_from_numpy(bulk_arrays(arr, 1, p_real))
    small, fills, _, _ = place_bulk_packed(b, rs, rounds, False, 4)
    short = (small[:, :4] & 2047).sum(1) < small[:, 4 + 12]
    assert short.any()
    assert torch.equal((fills & 2047).sum(1), small[:, 4 + 12])


def test_numpy_round_trip():
    arr = random_placement_arrays(np.random.default_rng(4), extra=True)
    b = bulk_arrays(arr, 1, 7)
    back = bulk_inputs_to_numpy(bulk_inputs_from_numpy(b))
    for k, v in b.items():
        assert np.array_equal(np.asarray(v), np.asarray(back[k])), k


def _same_bytes(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert w.dtype == g.dtype and w.shape == g.shape, i
        assert w.tobytes() == g.tobytes(), i


@pytest.mark.parametrize("case", sorted(BULK_FLAT_CASES))
def test_reference_bulk_is_one_group_flat(case):
    """The reference's K6 (full layout) equals its K3 at one group: one
    static signature dc & pool (& the group's extra_mask row), the job's
    count row carried from round to round, one seed, and round r
    wanting clip(p_real - r round_size, 0, round_size), as the port's
    `select.bulk_as_flat` builds them.  Buffer, usage and job count row
    are equal byte for byte.  This is what runs K6 on K3's flat mode
    (csrc/compact_rounds.cu `multi_bulk`)."""
    b, rs, rounds = bulk_flat_case(case)
    want = place_bulk_packed_jit(reference_bulk_inputs(b), rs, rounds,
                                 False, 0)
    flat = place_multi_packed_jit(reference_multi_inputs(
        multi_inputs_to_numpy(bulk_as_flat(bulk_inputs_from_numpy(b), rs,
                                           rounds))), rs)
    _same_bytes(want, flat)
    placed = np.asarray(want[0])[:, rs + 12]
    assert (placed.sum() > 0) == (case != "infeasible_group")
    if case == "p_real_not_multiple":
        assert placed.tolist()[-2:] == [226 - 3 * 64, 0]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(BULK_FLAT_CASES))
def test_bulk_as_flat_matches_bulk(case, mode):
    """`select.bulk_as_flat` builds the flat inputs of the identity
    above, and the port's plain K3 on them gives the port's plain K6's
    output in each layout: its fill slots and meta block are the full
    layout's buffer, the score layout's fills and meta, and the compact
    layout's prefix, meta and full fills.  The plain K6 equals the
    reference in that layout (the score block included)."""
    b, rs, rounds = bulk_flat_case(case)
    ws, fk = MODES[mode]
    binp = bulk_inputs_from_numpy(b)
    fin = bulk_as_flat(binp, rs, rounds)
    buf, used, jc = place_multi_packed_plain(fin, rs)
    got = place_bulk_packed_plain(binp, rs, rounds, ws, fk)
    _same_bytes(place_bulk_packed_jit(reference_bulk_inputs(b), rs, rounds,
                                      ws, fk), got)
    fills, meta = buf[:, :rs], buf[:, rs:]
    if fk:
        parts = (torch.cat([fills[:, :min(fk, rs)], meta], dim=1), fills)
    elif ws:
        parts = (torch.cat([fills, got[0][:, rs:2 * rs], meta], dim=1),)
    else:
        parts = (buf,)
    _same_bytes(got, parts + (used, jc))
