"""K9-K13 plain versions (nomad_tpu_torch/parallel/mesh.py) against the
reference's sharded functions (nomad_tpu/parallel/mesh.py) on the
8-device virtual CPU mesh that tests/conftest.py sets up.

Both sides get the same numpy inputs, made from a seed, over a node
axis padded to a multiple of 8 as the reference engine pads it (padding
rows ineligible, attributes UNSET).  Tolerance: exact.  Every output
word must be equal, the f32 scores bitcast into the packed buffers
included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.ops import select as rsel
from nomad_tpu.parallel import mesh as rmesh
from nomad_tpu.parallel import place_sharded_fn
from nomad_tpu_torch.ops.convert import (
    bulk_inputs_from_numpy,
    frames_from_numpy,
    multi_inputs_from_numpy,
    placement_inputs_from_numpy,
)
from nomad_tpu_torch.ops import select as psel
from nomad_tpu_torch.ops.select import pack_outputs
from nomad_tpu_torch.parallel import mesh as pmesh
from nomad_tpu_torch.parallel import place_sharded
from torch_parity import (
    MEMO_SCAN_CASES,
    SCATTER_ROW_CASES,
    add_jobs,
    build_flat_cluster,
    build_zoned_cluster,
    bulk_arrays,
    memo_identity,
    pad_arrays,
    random_placement_arrays,
    reference_inputs_numpy,
    reference_bulk_inputs,
    reference_multi_inputs,
    reference_placement_inputs,
    scatter_case,
    set_spread,
)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual mesh")

S = 8


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ref_mesh():
    return rmesh.make_mesh(S)


def assert_equal(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, i
        assert w.tobytes() == g.tobytes(), i


# ------------------------------------------------------------------ K9

SCAN_CASES = {
    # 37 nodes -> 3 padding rows; two spreads and a distinct_property
    "padding_spread_distinct": dict(n=37, s=2, k=3, d=1, kd=3, p=32),
    "spread_algo": dict(n=40, spread_algo=True, p=16),
    # n_loc = 2 < 3: each shard offers two local winners
    "n_loc_below_3": dict(n=13, p=16, s=1),
    # few feasible rows: the gathered top 3 carries row -1
    "few_feasible": dict(n=6, p=16, tight=True),
    "reschedule_extra_dh": dict(n=48, prev=True, extra=True, dh=True,
                                tight=True, p=32, p_real=29),
    "no_seed": dict(n=40, seed=0, s=1, p=16),
    "one_node": dict(n=1, g=3, p=8),
}


def _scan_arrays(case, rep):
    kw = dict(SCAN_CASES[case])
    arr = random_placement_arrays(np.random.default_rng(300 + rep), **kw)
    return pad_arrays(arr, pmesh.pad_nodes(kw["n"], S))


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_k9_scan_matches_reference(case, ref_mesh):
    fn = rmesh.place_sharded_packed_fn(ref_mesh)
    for rep in range(2):
        arr = _scan_arrays(case, rep)
        want = fn(reference_placement_inputs(arr))
        got = pmesh.place_sharded_packed(placement_inputs_from_numpy(arr),
                                         pmesh.make_mesh(S, "cpu"))
        assert_equal(want, got)


@pytest.mark.parametrize("case", sorted(MEMO_SCAN_CASES))
def test_k9_scan_matches_reference_on_memo_inputs(case, ref_mesh):
    """The inputs of K9's memo cases, padded to the mesh; the reference's
    output also has the identity the memo rests on."""
    kw = MEMO_SCAN_CASES[case]
    arr = pad_arrays(random_placement_arrays(np.random.default_rng(350),
                                             **kw),
                     pmesh.pad_nodes(kw["n"], S))
    want = rmesh.place_sharded_packed_fn(ref_mesh)(
        reference_placement_inputs(arr))
    got = pmesh.place_sharded_packed(placement_inputs_from_numpy(arr),
                                     pmesh.make_mesh(S, "cpu"))
    assert_equal(want, got)
    assert memo_identity(np.asarray(want[0]), arr["tg_idx"],
                         arr["active"]) > 0


# tests/test_parallel.py's sharded-placement shapes (16 nodes x 12
# placements, a spread over 12 nodes x 10, 10 nodes padded to 16 x 8),
# and two eligible rows of 32, fewer than the top 3
PLACE_SHARDED_CASES = {
    "sixteen_nodes": dict(n=16, p=12),
    "spread": dict(n=12, p=10, s=1, k=3),
    "padded_to_16": dict(n=10, p=8),
    "fewer_feasible_than_top_k": dict(n=32, p=16, tight=True),
}


def _place_sharded_arrays(case):
    kw = PLACE_SHARDED_CASES[case]
    arr = random_placement_arrays(np.random.default_rng(400), **kw)
    if case == "fewer_feasible_than_top_k":
        arr["elig"][:] = False
        arr["elig"][[9, 30]] = True
        arr["con"][:] = 0
        arr["used0"][:] = 0
    return pad_arrays(arr, pmesh.pad_nodes(kw["n"], S))


@pytest.mark.parametrize("case", sorted(PLACE_SHARDED_CASES))
def test_place_sharded_matches_reference(case, ref_mesh):
    """`parallel.place_sharded` on a CPU mesh against the reference's
    `place_sharded_fn` on the 8-device mesh: picks, top-k rows, the
    metric columns, `used` and `job_count` (npad rows) exactly; scores
    and top-k scores to 1e-6 (they agree to the bit so far)."""
    arr = _place_sharded_arrays(case)
    want = place_sharded_fn(ref_mesh)(reference_placement_inputs(arr))
    got = place_sharded(placement_inputs_from_numpy(arr),
                        pmesh.make_mesh(S, "cpu"))
    assert got._fields == want._fields
    for f in got._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, f
        if f in ("scores", "topk_scores"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
        else:
            assert np.array_equal(w, g), f
    assert got.used.shape[0] == pmesh.pad_nodes(arr["attrs"].shape[0], S)
    picks, top = got.picks.numpy(), got.topk_rows.numpy()
    assert (picks >= 0).any()
    if case == "fewer_feasible_than_top_k":
        assert ((picks >= 0) & (top == -1).any(axis=1)).any()


def test_k9_shard_without_feasible_rows(ref_mesh):
    """Shard 0's rows all ineligible, and only two feasible rows left in
    the cluster: the global top 3 holds -1 rows at 0.0."""
    arr = random_placement_arrays(np.random.default_rng(5), n=32, p=16,
                                  tight=True)
    arr["elig"][:] = False
    arr["elig"][[9, 30]] = True
    arr["dc_mask"][:] = True
    arr["pool_mask"][:] = True
    arr["con"][:] = 0
    arr["used0"][:] = 0
    want = rmesh.place_sharded_packed_fn(ref_mesh)(
        reference_placement_inputs(arr))
    got = pmesh.place_sharded_packed(placement_inputs_from_numpy(arr),
                                     pmesh.make_mesh(S, "cpu"))
    assert_equal(want, got)
    buf = got[0].numpy()
    assert set(buf[:, 0].tolist()) <= {9, 30, -1}
    assert (buf[buf[:, 0] >= 0, 4] == -1).all()


def test_k9_scores_are_key_less_noise():
    """The sharded scan reports key - noise(row); the single-device scan
    reports the score itself.  Picks agree, and the two scores differ by
    at most the two roundings of (score + noise) - noise: one ulp of the
    larger of |score| and the noise's 1e-6."""
    from nomad_tpu_torch.ops.select import place_packed
    arr = pad_arrays(random_placement_arrays(np.random.default_rng(0),
                                             n=300, p=64, s=2, k=3), 304)
    inp = placement_inputs_from_numpy(arr)
    got = pmesh.place_sharded_packed(inp, pmesh.make_mesh(S, "cpu"))[0]
    solo = place_packed(inp)[0]
    assert (got[:, 0] >= 0).all()
    assert np.array_equal(got[:, 0].numpy(), solo[:, 0].numpy())
    g = got[:, 1].numpy().view(np.float32)
    s = solo[:, 1].numpy().view(np.float32)
    ulp = np.spacing(np.maximum(np.abs(s), np.float32(1e-6)))
    assert (np.abs(g - s) <= ulp).all()


# ----------------------------------------------------------------- K10

BULK_CASES = {
    # (arrays kwargs, round size, rounds, p_real): n_loc = 8 < round
    "n_loc_below_round": (dict(n=60), 16, 3, 41),
    "padding_small": (dict(n=5), 16, 2, 20),
    "spread_algo": (dict(n=60, spread_algo=True), 16, 3, 48),
    "dh_limit": (dict(n=30, dh=True, tight=True), 16, 4, 60),
    "extra_mask_tight": (dict(n=44, extra=True, tight=True), 32, 4, 128),
}


def _bulk_arrays(case):
    kw, rs, rounds, p_real = BULK_CASES[case]
    arr = random_placement_arrays(np.random.default_rng(11), g=2,
                                  p=rs * rounds, **kw)
    arr = pad_arrays(arr, pmesh.pad_nodes(kw["n"], S))
    return bulk_arrays(arr, 1, p_real), rs, rounds


@pytest.mark.parametrize("case", sorted(BULK_CASES))
def test_k10_bulk_matches_reference(case, ref_mesh):
    b, rs, rounds = _bulk_arrays(case)
    want = rmesh.place_bulk_sharded_packed_fn(ref_mesh, rs, rounds)(
        reference_bulk_inputs(b))
    got = pmesh.place_bulk_sharded_packed(
        bulk_inputs_from_numpy(b), pmesh.make_mesh(S, "cpu"), rs, rounds)
    assert_equal(want, got)


# K10 = K6 on the npad rows: (nodes, spread, variant) -> round size, rows
# a shard (8 shards), p_real, rounds
K10_IDENTITY_CASES = {
    # 150 rows padded to 152: every shard gives all of its 19 rows
    "padded_150_binpack": ((150, False, None), (64, 19, 150, 3)),
    "padded_150_spread": ((150, True, None), (64, 19, 150, 3)),
    # 1,001 rows padded to 1,008: a shard gives its top 64 of 126
    "padded_1001_binpack": ((1001, False, None), (64, 126, 300, 5)),
    "padded_1001_spread": ((1001, True, None), (256, 126, 700, 3)),
    # every 13th row eligible: 47 feasible rows against a round of 64,
    # so each round's fill prefix ends in NEG_INF picks
    "few_feasible": ((600, False, "few_feasible"), (64, 75, 150, 3)),
}


@pytest.mark.parametrize("case", sorted(K10_IDENTITY_CASES))
def test_reference_k10_is_k6_on_padded_rows(ref_mesh, case):
    """The reference's K10 equals the reference's K6 (full layout) on the
    same npad rows, the padding rows statically infeasible: as for K11,
    the stable top round_size of the shards' top min(round_size, n_loc)
    lists laid out shard-major is the exact top round_size in row order,
    the noise runs over global rows and the counts and metrics are sums
    over the mesh.  The port's plain K10 and K6 equal both.  This is
    what runs K10 as K6's entry in K3's flat mode over the npad rows
    (csrc/compact_rounds.cu `multi_bulk_sharded`)."""
    (n, spread, variant), (rs, n_loc, p_real, rounds) = \
        K10_IDENTITY_CASES[case]
    arr = random_placement_arrays(np.random.default_rng(12), n=n, g=2,
                                  p=rs * rounds, spread_algo=spread)
    if variant == "few_feasible":
        arr["elig"][:] = False
        arr["elig"][::13] = True
        arr["dc_mask"][:] = True
        arr["pool_mask"][:] = True
    arr = pad_arrays(arr, pmesh.pad_nodes(n, S))
    assert arr["attrs"].shape[0] == S * n_loc
    b = bulk_arrays(arr, 1, p_real)
    ref = reference_bulk_inputs(b)
    want = rmesh.place_bulk_sharded_packed_fn(ref_mesh, rs, rounds)(ref)
    k6 = rsel.place_bulk_packed_jit(ref, rs, rounds, False, 0)
    for w, k in zip(want, k6):
        w, k = np.asarray(w), np.asarray(k)
        assert w.dtype == k.dtype and w.shape == k.shape
        assert w.tobytes() == k.tobytes()
    binp = bulk_inputs_from_numpy(b)
    assert_equal(want, pmesh.place_bulk_sharded_plain(binp, S, rs, rounds))
    assert_equal(want, psel.place_bulk_packed_plain(binp, rs, rounds))
    buf = np.asarray(want[0])
    placed = buf[:, rs + 12]
    assert placed.sum() > 0
    if variant == "few_feasible":
        n_feas = buf[placed > 0, rs + 6]
        assert 0 < n_feas.max() < rs


# ---------------------------------------------------------- K11 / K12

def _mesh_engine():
    from nomad_tpu.ops import PlacementEngine
    return PlacementEngine(mesh=rmesh.make_mesh(S))


def _flat_built(seed=3, spread=False, n_nodes=150, count=30):
    h = build_flat_cluster("nomad_tpu", n_nodes=n_nodes)
    if spread:
        set_spread("nomad_tpu", h)
    _, items = add_jobs("nomad_tpu", h, 9, count, zones=0)
    built = _mesh_engine().build_multi_inputs(h.state.snapshot(), items,
                                              seed=seed)
    assert built["cand_rows"] is None
    assert built["npad"] == -(-n_nodes // S) * S
    return built


def _zoned_built(seed=4, n_zones=5, n_nodes=300, spread=False, count=40):
    h = build_zoned_cluster("nomad_tpu", n_nodes=n_nodes, n_zones=n_zones)
    if spread:
        set_spread("nomad_tpu", h)
    _, items = add_jobs("nomad_tpu", h, 11, count, zones=n_zones)
    built = _mesh_engine().build_multi_inputs(h.state.snapshot(), items,
                                              seed=seed)
    assert built["cand_rows"].shape[:2] == (S, n_zones)
    return built


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("chained", [False, True])
def test_k11_flat_matches_reference(ref_mesh, chained, spread):
    built = _flat_built(spread=spread)
    arrs = reference_inputs_numpy(built["inp"])
    inp = multi_inputs_from_numpy(arrs)
    rs = built["rs"]
    mesh = pmesh.make_mesh(S, "cpu")
    if chained:
        fn = rmesh.place_multi_sharded_packed_fn(ref_mesh, rs, chained=True)
        want = fn(jnp.asarray(arrs["used0"]), built["inp"]._replace(
            used0=None))
        used0 = inp.used0.clone()
        got = pmesh.place_multi_sharded_chained(
            used0, inp._replace(used0=None), mesh, rs)
        assert got[1] is used0
    else:
        want = rmesh.place_multi_sharded_packed_fn(ref_mesh, rs)(
            built["inp"])
        got = pmesh.place_multi_sharded_packed(inp, mesh, rs)
        assert np.array_equal(inp.used0.numpy(), arrs["used0"])
    assert_equal(want, got)


@pytest.mark.parametrize("case", ["five_lanes", "two_lanes", "chained",
                                  "spread"])
def test_k12_compact_matches_reference(ref_mesh, case):
    built = _zoned_built(n_zones=2 if case == "two_lanes" else 5,
                         spread=case == "spread")
    arrs = reference_inputs_numpy(built["inp"])
    inp = multi_inputs_from_numpy(arrs)
    rs, lanes = built["rs"], built["n_lanes"]
    cr, cv = frames_from_numpy(built["cand_rows"], built["cand_valid"])
    mesh = pmesh.make_mesh(S, "cpu")
    if case == "chained":
        fn = rmesh.place_multi_compact_sharded_fn(ref_mesh, rs, lanes,
                                                  chained=True)
        want = fn(jnp.asarray(arrs["used0"]),
                  built["inp"]._replace(used0=None),
                  jnp.asarray(built["cand_rows"]),
                  jnp.asarray(built["cand_valid"]))
        used0 = inp.used0.clone()
        got = pmesh.place_multi_compact_sharded_chained(
            used0, inp._replace(used0=None), cr, cv, mesh, rs, lanes)
        assert got[2] is used0
    else:
        want = rmesh.place_multi_compact_sharded_fn(ref_mesh, rs, lanes)(
            built["inp"], built["cand_rows"], built["cand_valid"])
        got = pmesh.place_multi_compact_sharded(inp, cr, cv, mesh, rs,
                                                lanes)
    assert_equal(want, got)
    assert (got[0].numpy()[:, -16 + 12] > 0).any()


# K12 = K2 on each lane's shard frames laid end to end: (nodes, count,
# spread) -> round size, all on 5 lanes and 8 shards
IDENTITY_CASES = {
    "n300_rs64": ((300, 40, False), 64),
    "n300_rs64_spread": ((300, 40, True), 64),
    "n120_rs256": ((120, 200, False), 256),
    "n2000_rs512_spread": ((2000, 300, True), 512),
}


@pytest.mark.parametrize("case", sorted(IDENTITY_CASES))
def test_k12_is_k2_on_shard_major_frames(ref_mesh, case):
    """The reference's K12 equals the reference's K2 on frames [L, S *
    Nc_loc] and seeds [J', S * Nc_loc] laid out shard-major (slot
    s * Nc_loc + j holds shard s's slot j, as pmesh.lane_frames builds
    them): the two-stage top-k is the exact top round_size in that slot
    order.  The port's plain K12 equals the port's plain K2 on the same
    frames.  This is what runs K12 on K2's kernel
    (csrc/compact_rounds.cu)."""
    (n_nodes, count, spread), rs = IDENTITY_CASES[case]
    built = _zoned_built(n_nodes=n_nodes, spread=spread, count=count)
    assert built["rs"] == rs and built["n_lanes"] == 5
    arrs = reference_inputs_numpy(built["inp"])
    want = rmesh.place_multi_compact_sharded_fn(ref_mesh, rs, 5)(
        built["inp"], built["cand_rows"], built["cand_valid"])
    cr, cv = frames_from_numpy(built["cand_rows"], built["cand_valid"])
    inp = multi_inputs_from_numpy(arrs)
    fr, fv, fj = pmesh.lane_frames(cr, cv, inp.job_count0)
    k2 = rsel.place_multi_compact_packed_jit(
        built["inp"]._replace(job_count0=jnp.asarray(fj.numpy())),
        fr.numpy(), fv.numpy(), rs, 5)
    for w, k in zip(want, k2):
        w, k = np.asarray(w), np.asarray(k)
        assert w.dtype == k.dtype and w.shape == k.shape
        assert w.tobytes() == k.tobytes()
    got = pmesh.place_multi_compact_sharded_plain(inp, cr, cv, S, rs, 5)
    assert_equal(want, got)
    assert_equal(want, psel.place_multi_compact_packed_plain(
        inp._replace(job_count0=fj), fr, fv, rs, 5))


# K11 = K3 on the npad rows: (nodes, count, spread, variant, chained) ->
# (round size, rows a shard), all on 8 shards
K11_IDENTITY_CASES = {
    # 150 rows padded to 152: every shard gives all of its 19 rows
    "padded_binpack": ((150, 30, False, None, False), (64, 19)),
    "padded_spread": ((150, 30, True, None, False), (64, 19)),
    "padded_chained": ((150, 30, False, None, True), (64, 19)),
    # a shard gives its top 64 of 125 rows
    "rs_below_shard": ((1000, 30, False, None, False), (64, 125)),
    "rs256_spread": ((300, 200, True, None, False), (256, 38)),
    # every 13th row eligible: 47 rows < 64, so each round's
    # fill prefix ends in NEG_INF picks (the lowest infeasible rows)
    "few_feasible": ((600, 30, False, "few_feasible", False), (64, 75)),
    "few_feasible_spread": ((600, 30, True, "few_feasible", False),
                            (64, 75)),
    # odd groups take a second signature (every third row removed)
    "two_signatures": ((150, 30, False, "two_signatures", True), (64, 19)),
}


def _k11_arrays(n_nodes, count, spread, variant):
    built = _flat_built(spread=spread, n_nodes=n_nodes, count=count)
    arrs = reference_inputs_numpy(built["inp"])
    if variant == "few_feasible":
        elig = np.zeros_like(arrs["elig"])
        elig[:n_nodes:13] = True
        arrs["elig"] = elig
    elif variant == "two_signatures":
        u = arrs["con"].shape[0]
        extra = arrs["base_mask"][arrs["u_mask"][0]].copy()
        extra[::3] = False
        arrs["u_mask"] = np.append(arrs["u_mask"], arrs["base_mask"].shape[0]
                                   ).astype(np.int32)
        arrs["base_mask"] = np.concatenate([arrs["base_mask"], extra[None]])
        arrs["con"] = np.concatenate([arrs["con"], arrs["con"][:1]])
        g = np.arange(arrs["req"].shape[0])
        arrs["g_static"] = np.where(g % 2 == 1, u, arrs["g_static"]
                                    ).astype(np.int32)
    return built["rs"], arrs


@pytest.mark.parametrize("case", sorted(K11_IDENTITY_CASES))
def test_k11_is_k3_on_padded_rows(ref_mesh, case):
    """The reference's K11 equals the reference's K3 on the same npad
    rows: shard s owns rows [s n_loc, (s + 1) n_loc), so the stable top
    round_size of the shards' top min(round_size, n_loc) lists, laid out
    shard-major, is the exact top round_size over all rows in row order
    (NEG_INF picks included: the lowest infeasible rows); the noise runs
    over global rows, and the counts and metrics are sums over the mesh.
    The port's plain K11 equals the port's plain K3 on those inputs.
    This is what runs K11 on K3's flat mode (csrc/compact_rounds.cu)."""
    (n_nodes, count, spread, variant, chained), (rs, n_loc) = \
        K11_IDENTITY_CASES[case]
    built_rs, arrs = _k11_arrays(n_nodes, count, spread, variant)
    npad = arrs["attrs"].shape[0]
    assert built_rs == rs and npad == S * n_loc
    rinp = reference_multi_inputs(arrs)
    inp = multi_inputs_from_numpy(arrs)
    if chained:
        sharded = rmesh.place_multi_sharded_packed_fn(ref_mesh, rs,
                                                      chained=True)
        want = sharded(jnp.asarray(arrs["used0"]), rinp._replace(used0=None))
        k3 = rsel.place_multi_chained_jit(jnp.asarray(arrs["used0"]),
                                          rinp._replace(used0=None), rs)
        mesh = pmesh.make_mesh(S, "cpu")
        got = pmesh.place_multi_sharded_chained(
            inp.used0.clone(), inp._replace(used0=None), mesh, rs)
        k3p = psel.place_multi_chained(inp.used0.clone(),
                                       inp._replace(used0=None), rs)
    else:
        want = rmesh.place_multi_sharded_packed_fn(ref_mesh, rs)(rinp)
        k3 = rsel.place_multi_packed_jit(rinp, rs)
        got = pmesh.place_multi_sharded_plain(inp, S, rs)
        k3p = psel.place_multi_packed_plain(inp, rs)
    assert len(want) == len(k3) == 3
    for w, k in zip(want, k3):
        w, k = np.asarray(w), np.asarray(k)
        assert w.dtype == k.dtype and w.shape == k.shape
        assert w.tobytes() == k.tobytes()
    assert_equal(want, got)
    assert_equal(want, k3p)
    buf = np.asarray(want[0])
    placed = buf[:, -16 + 12]
    assert placed.sum() > 0
    if variant == "few_feasible":
        # every real round has fewer feasible rows than its round size,
        # so its top round_size holds NEG_INF picks
        n_feas = buf[placed > 0, -16 + 6]
        assert 0 < n_feas.max() < rs


# ----------------------------------------------------------------- K13

def test_k13_scatter_matches_reference(ref_mesh):
    from nomad_tpu.ops.engine import _sharded_fn
    rng = np.random.default_rng(2)
    npad = 40
    used = rng.integers(0, 1000, (npad, 3)).astype(np.int32)
    rows = rng.integers(0, npad, 512).astype(np.int32)   # repeats
    vals = rng.integers(-50, 50, (512, 3)).astype(np.int32)
    want = _sharded_fn(ref_mesh, "scatter")(jnp.asarray(used),
                                            jnp.asarray(rows),
                                            jnp.asarray(vals))
    got = torch.tensor(used)
    out = pmesh.scatter_add_sharded_(got, torch.tensor(rows),
                                     torch.tensor(vals),
                                     pmesh.make_mesh(S, "cpu"))
    assert out is got
    assert np.array_equal(np.asarray(want), got.numpy())


def _k13_reference(ref_mesh, used, rows, vals):
    from nomad_tpu.ops.engine import _sharded_fn
    return np.asarray(_sharded_fn(ref_mesh, "scatter")(
        jnp.asarray(used), jnp.asarray(rows), jnp.asarray(vals)))


def test_k13_drops_rows_outside_the_table(ref_mesh):
    """A 16-row table in 8 shards: -1 wraps to row 15 and -16 to row 0,
    16, 99 and -17 drop, as in the reference."""
    used = np.zeros((16, 3), np.int32)
    rows = np.array([-1, 0, 15, 16, 99, -16, -17], np.int32)
    vals = np.ones((7, 3), np.int32)
    want = _k13_reference(ref_mesh, used, rows, vals)
    got = pmesh.scatter_add_sharded_plain(torch.tensor(used),
                                          torch.tensor(rows),
                                          torch.tensor(vals), S)
    assert want[:, 0].tolist() == [2] + [0] * 14 + [2]
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("case", SCATTER_ROW_CASES)
def test_k13_row_sets_match_reference(ref_mesh, case):
    rng = np.random.default_rng(len(case))
    npad = 40
    used = rng.integers(0, 1000, (npad, 3)).astype(np.int32)
    rows, vals = scatter_case(case, npad, 512, rng)
    want = _k13_reference(ref_mesh, used, rows, vals)
    got = pmesh.scatter_add_sharded_(torch.tensor(used), torch.tensor(rows),
                                     torch.tensor(vals),
                                     pmesh.make_mesh(S, "cpu"))
    assert np.array_equal(want, got.numpy())


# ------------------------------------------------------------- the mesh

def test_mesh_shape_rules():
    m = pmesh.make_mesh(8, "cpu")
    assert (m.n_shards, m.device.type, pmesh.AXIS) == (8, "cpu", "nodes")
    assert pmesh.pad_nodes(13, 8) == 16 and pmesh.pad_nodes(16, 8) == 16
    with pytest.raises(ValueError):
        pmesh.make_mesh(9, "cpu")
    with pytest.raises(ValueError):
        pmesh.make_mesh(0, "cpu")
    # a mesh of parts: a 2-part mesh's parts and shard split; a shard
    # count that is not a multiple of the parts raises; a CUDA mesh on a
    # host without CUDA raises
    m2 = pmesh.make_mesh(4, ["cpu", "cpu"])
    assert (m2.device.type, m2.n_parts, m2.shards_per_part) == ("cpu", 2, 2)
    assert [d.type for d in m2.parts] == ["cpu", "cpu"]
    with pytest.raises(ValueError, match="do not split"):
        pmesh.make_mesh(6, ["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.make_mesh(8, ["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="pad_nodes"):
        pmesh.scatter_add_sharded_plain(
            torch.zeros((13, 3), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 3), dtype=torch.int32), 8)


def test_plain_packed_scan_equals_pack_of_outputs():
    arr = _scan_arrays("n_loc_below_3", 1)
    inp = placement_inputs_from_numpy(arr)
    a = pmesh.place_sharded_packed(inp, pmesh.make_mesh(S, "cpu"))
    b = pack_outputs(pmesh.place_sharded_plain(inp, S))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
