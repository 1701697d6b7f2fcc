"""K2/K3 plain versions against the JAX multi-eval kernels, and the
identity that puts K3 on K2's kernel.

The reference engine lowers each batch (`build_multi_inputs`); its
inputs go to numpy and into the port through `ops.convert`, so the JAX
function and the port's plain version compute on identical state.  The
packed buffers (fills, meta with the f32 top scores bitcast) and the
usage outputs must agree byte for byte.
"""

import numpy as np
import pytest
import torch

from nomad_tpu.ops import select as rsel
from nomad_tpu_torch.ops import select as psel
from nomad_tpu_torch.ops.convert import (
    frames_from_numpy,
    multi_inputs_from_numpy,
    multi_inputs_to_numpy,
)
from torch_parity import (
    COMPACT_CASES,
    COMPACT_TOPB,
    FLAT_CASES,
    add_jobs,
    build_flat_cluster,
    build_zoned_cluster,
    compact_case,
    compact_identities,
    engine,
    flat_case,
    reference_inputs_numpy,
    reference_multi_inputs,
    set_spread,
)

REF = "nomad_tpu"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _zoned_batch(seed, n_items=13, count=40, spread=False, n_nodes=300):
    h = build_zoned_cluster(REF, n_nodes=n_nodes)
    if spread:
        set_spread(REF, h)
    _, items = add_jobs(REF, h, n_items, count)
    built = engine(REF).build_multi_inputs(h.state.snapshot(), items,
                                           seed=seed)
    assert built["cand_rows"] is not None and built["n_lanes"] == 5
    return built


def _flat_batch(seed, n_items=9, count=30, with_allocs=False):
    h = build_flat_cluster(REF, n_nodes=150)
    jobs, items = add_jobs(REF, h, n_items, count, zones=0)
    if with_allocs:
        eng = engine(REF)
        first = eng.place_batch(h.state.snapshot(), items, seed=seed)
        _commit_allocs(h, first, items)
    built = engine(REF).build_multi_inputs(h.state.snapshot(), items,
                                           seed=seed)
    assert built["cand_rows"] is None and built["n_lanes"] == 1
    return built


def _commit_allocs(h, decisions, items):
    from nomad_tpu import mock
    from nomad_tpu.structs import Resources
    allocs = []
    for bd, it in zip(decisions, items):
        for p in bd.picks.tolist():
            if p >= 0:
                allocs.append(mock.alloc(
                    job=it.job, node_id=bd.node_ids[p],
                    task_group=it.tg.name,
                    resources=Resources(cpu=10, memory_mb=10),
                    client_status="running"))
    h.state.upsert_allocs(allocs)


def _port_inputs(built):
    arrs = reference_inputs_numpy(built["inp"])
    return arrs, multi_inputs_from_numpy(arrs)


def _assert_compact_equal(built, chained=False):
    arrs, inp = _port_inputs(built)
    rs, lanes = built["rs"], built["n_lanes"]
    if chained:
        import jax.numpy as jnp
        r_out = rsel.place_multi_compact_chained_jit(
            jnp.asarray(arrs["used0"]), built["inp"]._replace(used0=None),
            jnp.asarray(built["cand_rows"]), jnp.asarray(built["cand_valid"]),
            rs, lanes)
    else:
        r_out = rsel.place_multi_compact_packed_jit(
            built["inp"], built["cand_rows"], built["cand_valid"], rs, lanes)
    cr, cv = frames_from_numpy(built["cand_rows"], built["cand_valid"])
    if chained:
        used0 = inp.used0.clone()
        p_out = psel.place_multi_compact_chained(
            used0, inp._replace(used0=None), cr, cv, rs, lanes)
        assert p_out[2] is used0            # updated in place
    else:
        p_out = psel.place_multi_compact_packed(inp, cr, cv, rs, lanes)
        assert torch.equal(inp.used0, torch.tensor(arrs["used0"]))
    for name, r, p in zip(("buf_small", "fills", "used"), r_out, p_out):
        r = np.asarray(r)
        p = p.numpy()
        assert r.dtype == p.dtype and r.shape == p.shape, name
        assert r.tobytes() == p.tobytes(), name
    return np.asarray(r_out[0])


def _assert_flat_equal(built, chained=False):
    arrs, inp = _port_inputs(built)
    rs = built["rs"]
    if chained:
        import jax.numpy as jnp
        r_out = rsel.place_multi_chained_jit(
            jnp.asarray(arrs["used0"]), built["inp"]._replace(used0=None),
            rs)
        used0 = inp.used0.clone()
        p_out = psel.place_multi_chained(used0, inp._replace(used0=None), rs)
        assert p_out[1] is used0
    else:
        r_out = rsel.place_multi_packed_jit(built["inp"], rs)
        p_out = psel.place_multi_packed(inp, rs)
    for name, r, p in zip(("buf", "used", "job_count"), r_out, p_out):
        r = np.asarray(r)
        p = p.numpy()
        assert r.dtype == p.dtype and r.shape == p.shape, name
        assert r.tobytes() == p.tobytes(), name
    return np.asarray(r_out[0])


@pytest.mark.parametrize("seed", [0, 7])
def test_compact_binpack_matches_jax(seed):
    buf = _assert_compact_equal(_zoned_batch(seed))
    assert buf[:, 32 + 12].sum() == 13 * 40       # every placement made


def test_compact_spread_overflow_matches_jax():
    """Spread fans a round past the FILL_K small-buffer prefix: the full
    fills (fetched on overflow) must agree too."""
    built = _zoned_batch(5, n_items=6, count=psel.FILL_K + 26, spread=True)
    _assert_compact_equal(built)
    fills = np.asarray(rsel.place_multi_compact_packed_jit(
        built["inp"], built["cand_rows"], built["cand_valid"], built["rs"],
        built["n_lanes"])[1])
    assert ((fills & 2047) > 0).sum(axis=1).max() > psel.FILL_K


def test_compact_job_count_seeds_match_jax():
    """Jobs with live allocs place again: the compact [J', Nc] seed table
    carries their per-node counts into the anti-affinity term."""
    h = build_zoned_cluster(REF, n_nodes=60)
    _, items = add_jobs(REF, h, 4, 8, zones=2)
    first = engine(REF).place_batch(h.state.snapshot(), items, seed=3)
    _commit_allocs(h, first, items)
    built = engine(REF).build_multi_inputs(h.state.snapshot(), items,
                                           seed=4)
    assert built["cand_rows"] is not None
    assert int(np.asarray(built["inp"].job_count0).max()) > 0
    _assert_compact_equal(built)


@pytest.mark.parametrize("seed", [0, 7])
def test_compact_chained_matches_jax(seed):
    _assert_compact_equal(_zoned_batch(seed, n_items=10, count=30),
                          chained=True)


@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_compact_cases_match_jax(case):
    """K2's card cases (torch_parity.COMPACT_CASES: ragged and small
    frames, round sizes 1 and 1024, one lane, unequal lanes, padding
    lanes, changing requests, a frame past shared memory): the port's
    plain version equals the reference's function on each."""
    arrs, cr, cv, rs, lanes = compact_case(REF, case)
    r_out = rsel.place_multi_compact_packed_jit(
        reference_multi_inputs(arrs), cr, cv, rs, lanes)
    p_out = psel.place_multi_compact_packed(
        multi_inputs_from_numpy(arrs), *frames_from_numpy(cr, cv), rs, lanes)
    for name, r, p in zip(("buf_small", "fills", "used"), r_out, p_out):
        r = np.asarray(r)
        p = p.numpy()
        assert r.dtype == p.dtype and r.shape == p.shape, name
        assert r.tobytes() == p.tobytes(), name


@pytest.mark.parametrize("case", ["binpack", "mixed_requests",
                                  "padding_lanes", "spread",
                                  "unequal_lanes"])
def test_reference_compact_output_has_the_memo_identity(case):
    """The reference's own compact output: each round's fills are a
    prefix of its slots summing to its placed count, and a step that
    repeats the group and want of the lane's last computed step, after
    that step placed nothing, repeats its row; K2 writes such a row
    without a pass.  Binpack rounds fill at most COMPACT_TOPB rows, the
    rows K2 takes on its one-exchange path."""
    arrs, cr, cv, rs, lanes = compact_case(REF, case)
    buf, fills, _ = rsel.place_multi_compact_packed_jit(
        reference_multi_inputs(arrs), cr, cv, rs, lanes)
    held, short = compact_identities(np.asarray(buf), np.asarray(fills),
                                     arrs["round_g"], arrs["round_want"],
                                     lanes)
    assert held > 0
    if not COMPACT_CASES[case].get("spread"):
        assert short == arrs["round_g"].shape[0]


@pytest.mark.parametrize("seed", [0, 3])
def test_flat_matches_jax(seed):
    buf = _assert_flat_equal(_flat_batch(seed))
    assert buf[:, 64 + 12].sum() == 9 * 30


def test_flat_job_count_seeds_match_jax():
    built = _flat_batch(2, n_items=5, count=20, with_allocs=True)
    assert int(np.asarray(built["inp"].job_count0).max()) > 0
    _assert_flat_equal(built)


def test_flat_spread_matches_jax():
    h = build_flat_cluster(REF, n_nodes=150)
    set_spread(REF, h)
    _, items = add_jobs(REF, h, 6, 50, zones=0)
    built = engine(REF).build_multi_inputs(h.state.snapshot(), items,
                                           seed=11)
    _assert_flat_equal(built)


@pytest.mark.parametrize("seed", [0, 9])
def test_flat_chained_matches_jax(seed):
    _assert_flat_equal(_flat_batch(seed), chained=True)


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_flat_cases_match_jax(case):
    """K3's card cases (torch_parity.FLAT_CASES: two signatures
    alternating round by round, one job over two groups in consecutive
    rounds, 150 and 37 rows, round sizes 1 and 1024, idle and memoised
    rounds): the port's plain version equals the reference's function
    on each, buffer, usage and last job count row."""
    arrs, rs = flat_case(REF, case)
    r_out = rsel.place_multi_packed_jit(reference_multi_inputs(arrs), rs)
    p_out = psel.place_multi_packed(multi_inputs_from_numpy(arrs), rs)
    for name, r, p in zip(("buf", "used", "job_count"), r_out, p_out):
        r = np.asarray(r)
        p = p.numpy()
        assert r.dtype == p.dtype and r.shape == p.shape, name
        assert r.tobytes() == p.tobytes(), name
    assert int(np.asarray(r_out[0])[:, rs + 12].sum()) > 0


@pytest.mark.parametrize("case", ["binpack", "padding_rounds", "spread",
                                  "two_signatures"])
def test_reference_flat_output_has_the_memo_identity(case):
    """The reference's own flat output has what K3's frame on K2's
    kernel rests on (torch_parity.compact_identities at one lane, the
    buffer's fill slots as its fills): filled rows a prefix of the slots
    summing to the placed count, and a round that repeats the group and
    want of the last computed round, after that round placed nothing,
    repeats its row."""
    arrs, rs = flat_case(REF, case)
    buf = np.asarray(rsel.place_multi_packed_jit(
        reference_multi_inputs(arrs), rs)[0])
    held, short = compact_identities(buf, buf[:, :rs], arrs["round_g"],
                                     arrs["round_want"], 1)
    assert held > 0
    if not FLAT_CASES[case].get("spread"):
        assert short == arrs["round_g"].shape[0]


@pytest.mark.parametrize("case", ["binpack", "spread"])
def test_reference_flat_is_one_lane_compact(case):
    """At one signature, with no job over two groups in consecutive
    rounds, the reference's K3 equals its K2 with one lane whose frame
    is every row (valid where the signature's static row is): the
    buffer's fill slots are K2's full fills, its meta block K2's, and
    the usage K2's."""
    import jax.numpy as jnp
    from nomad_tpu.ops.feasibility import constraint_mask
    arrs, rs = flat_case(REF, case)
    assert arrs["con"].shape[0] == 1          # U = 1
    inp = reference_multi_inputs(arrs)
    static = np.asarray(constraint_mask(inp.attrs, inp.con, inp.luts)
                        & inp.elig[None, :]
                        & inp.base_mask[inp.u_mask])[0]
    n = arrs["cap"].shape[0]
    buf, used, _ = rsel.place_multi_packed_jit(inp, rs)
    small, fills, used2 = rsel.place_multi_compact_packed_jit(
        inp, jnp.arange(n, dtype=jnp.int32)[None], jnp.asarray(static)[None],
        rs, 1)
    buf, small = np.asarray(buf), np.asarray(small)
    fill_k = min(psel.FILL_K, rs)
    assert np.array_equal(buf[:, :rs], np.asarray(fills))
    assert np.array_equal(buf[:, rs:], small[:, fill_k:])
    assert np.array_equal(np.asarray(used), np.asarray(used2))


def test_convert_round_trip():
    built = _zoned_batch(7, n_items=5, count=10)
    arrs, inp = _port_inputs(built)
    back = multi_inputs_to_numpy(inp)
    for name, a in arrs.items():
        assert np.array_equal(np.asarray(back[name]), a), name
        assert np.asarray(back[name]).dtype == a.dtype, name


def test_tiebreak_noise_matches_jax():
    import jax.numpy as jnp
    rows = np.arange(0, 1 << 20, 997, dtype=np.int32)
    for seed in (0, 1, 0x9E3779B9, 0xFFFFFFFF):
        r = np.asarray(rsel.tiebreak_noise(jnp.uint32(seed),
                                           jnp.asarray(rows)))
        p = psel.tiebreak_noise(torch.tensor(seed, dtype=torch.int64),
                                torch.tensor(rows)).numpy()
        assert r.tobytes() == p.tobytes()

