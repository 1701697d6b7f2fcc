"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it runs on a GPU machine without the reference's
stack (tests/conftest.py imports jax, hence `--noconftest` there):

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels.py

Every card test takes the `cuda_device` fixture and skips without a
card; the CPU tests pin the wrappers' device dispatch.  Inputs come from
the port's own engine on small seeded clusters (CPU lowering, then moved
to the card), so kernel and plain version see identical tensors.
Integer outputs and f32 score bits must match exactly, both against the
plain version on the card and against the plain version on CPU copies of
the same inputs: the CPU one is what matches the JAX reference bit for
bit (tests/test_torch_multi.py), its 10^x being the C library's powf.
"""

import numpy as np
import pytest
import torch

from nomad_tpu_torch.ops import kernels as K
from nomad_tpu_torch.ops import select as psel
from nomad_tpu_torch.ops.convert import (
    bulk_inputs_from_numpy,
    frames_from_numpy,
    multi_inputs_from_numpy,
    multi_inputs_to_numpy,
    placement_inputs_from_numpy,
    preempt_args_from_numpy,
)
from nomad_tpu_torch.ops.engine import scatter_add_, scatter_add_plain
from nomad_tpu_torch.ops.feasibility import (
    feasible_mask,
    feasible_mask_plain,
    landscape_mask,
    landscape_mask_plain,
)
from nomad_tpu_torch.ops.preempt import preempt_bulk, preempt_bulk_plain
from nomad_tpu_torch.ops.scoring import (
    affinity_landscape,
    affinity_landscape_plain,
    pow10,
    pow10_libm,
    pow10_on_card,
)
from torch_parity import (  # noqa: F401
    COMPACT_CASES,
    FLAT_CASES,
    MEMO_SCAN_CASES,
    add_jobs,
    add_zoned_cluster,
    build_flat_cluster,
    build_zoned_cluster,
    compact_case,
    cuda_device,
    engine,
    flat_case,
    make_evals,
    random_placement_arrays,
    random_preempt_args,
    set_spread,
)

PORT = "nomad_tpu_torch"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _zoned_built(seed=7, spread=False, n_items=13, count=40):
    h = build_zoned_cluster(PORT)
    if spread:
        set_spread(PORT, h)
    _, items = add_jobs(PORT, h, n_items, count)
    built = engine(PORT).build_multi_inputs(h.state.snapshot(), items,
                                            seed=seed)
    assert built["cand_rows"] is not None
    return built


def _flat_built(seed=3, spread=False):
    h = build_flat_cluster(PORT, n_nodes=150)
    if spread:
        set_spread(PORT, h)
    _, items = add_jobs(PORT, h, 9, 30, zones=0)
    built = engine(PORT).build_multi_inputs(h.state.snapshot(), items,
                                            seed=seed)
    assert built["cand_rows"] is None
    return built


def _on(inp, device):
    return multi_inputs_from_numpy(multi_inputs_to_numpy(inp), device)


def _bits(t):
    """A tensor as its raw words on the CPU (f32 compared bit for bit)."""
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(got, *wants):
    for want in wants:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g), _bits(w))


def test_pow10_libm_matches_c_library():
    """The card's 10^x steps (`pow10_libm`, which `libm_pow10f` in
    csrc/score_common.cuh mirrors) against the C library's powf on a
    strided sweep of every float in [0, 1] and on the capacity ratios
    the binpack score takes."""
    x = (torch.arange(0, 0x3F800001, 997, dtype=torch.int64)
         .to(torch.int32).view(torch.float32))
    cap = torch.arange(1, 1200, dtype=torch.float32)
    used = torch.arange(0, 1200, dtype=torch.float32)
    ratio = (1.0 - torch.clamp(used[None, :] / cap[:, None], max=1.0))
    for v in (x, ratio.flatten()):
        assert torch.equal(_bits(pow10_libm(v)), _bits(pow10(v)))


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel: results equal the plain
    versions and no launch is counted."""
    K.reset_launches()
    built = _zoned_built(n_items=5, count=10)
    inp = built["inp"]
    cr, cv = frames_from_numpy(built["cand_rows"], built["cand_valid"])
    got = psel.place_multi_compact_packed(inp, cr, cv, built["rs"],
                                          built["n_lanes"])
    want = psel.place_multi_compact_packed_plain(inp, cr, cv, built["rs"],
                                                 built["n_lanes"])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    used = torch.zeros((4, 3), dtype=torch.int32)
    scatter_add_(used, torch.tensor([1, 1, 3], dtype=torch.int32),
                 torch.ones((3, 3), dtype=torch.int32))
    assert used[:, 0].tolist() == [0, 2, 0, 1]
    assert all(k.launches == 0 for k in K.KERNELS)


def _random_landscape_inputs(case, device, n=3000, n_lut=4, vocab=20):
    """Seeded K1 inputs of LANDSCAPE_CASES[case]: attributes [n, a] (-1
    unset), LUTs [n_lut, vocab], constraint [u, c, 3] and affinity
    [ua, af, 4] tables drawing every opcode, eligibility, a base table
    [4, n] with u_mask into it, a node_ok row or None, and frames
    [3, 700] of rows (some past n)."""
    u, c, ua, af, with_ok, a = LANDSCAPE_CASES[case]
    rng = np.random.default_rng(len(case))
    ops = rng.integers(0, 6, (u, c))         # DOP_TRUE .. DOP_LUT

    def rows(g, k, ops):
        return np.stack([rng.integers(0, a, (g, k)), ops,
                         rng.integers(-1, vocab + 1, (g, k))], axis=2)

    t = lambda x, dt: torch.tensor(np.asarray(x), dtype=dt, device=device)
    aff = np.concatenate([rows(ua, af, rng.integers(0, 6, (ua, af))),
                          rng.integers(-50, 50, (ua, af, 1))], axis=2)
    return dict(
        attrs=t(rng.integers(-1, vocab, (n, a)), torch.int32),
        luts=t(rng.random((n_lut, vocab)) < 0.5, torch.bool),
        con=t(rows(u, c, ops), torch.int32),
        elig=t(rng.random(n) < 0.9, torch.bool),
        base=t(rng.random((4, n)) < 0.8, torch.bool),
        u_mask=t(rng.integers(0, 4, u), torch.int32),
        node_ok=t(rng.random(n) < 0.8, torch.bool) if with_ok else None,
        aff=t(aff, torch.int32),
        frames=t(rng.integers(0, n + 50, (3, 700)), torch.int32))


# (signatures, constraint rows, affinity signatures, affinity rows,
# node_ok, attribute columns): "many_signatures" fills 550 grid rows,
# "wide_rows" has 700 constraint and 600 affinity rows a signature,
# "wide_attrs" reads 80-column attribute rows
LANDSCAPE_CASES = {
    "node_ok": (5, 4, 2, 3, True, 6),
    "no_constraint_rows": (3, 0, 2, 0, True, 6),
    "many_signatures": (400, 4, 150, 8, False, 6),
    "wide_rows": (3, 700, 2, 600, True, 6),
    "wide_attrs": (9, 4, 3, 2, True, 80),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zoned"] + sorted(LANDSCAPE_CASES))
def test_landscape_matches_plain(cuda_device, case):
    """K1's three entries (the mask with or without a node_ok row, the
    affinity over every row or through frames, both in one launch)
    against their plain versions on the card and on CPU copies: at the
    zoned wave's inputs, and on random tables with no constraint rows,
    hundreds of signatures, hundreds of predicate rows and wide attribute
    rows.  One launch per call."""
    from nomad_tpu_torch.ops.scoring import landscapes

    if case == "zoned":
        built = _zoned_built()
        inp = _on(built["inp"], cuda_device)
        cr, _ = frames_from_numpy(built["cand_rows"], built["cand_valid"],
                                  cuda_device)
        d = dict(attrs=inp.attrs, luts=inp.luts, con=inp.con, elig=inp.elig,
                 base=inp.base_mask, u_mask=inp.u_mask, node_ok=None,
                 aff=inp.aff, frames=cr)
    else:
        d = _random_landscape_inputs(case, cuda_device)
    c = {k: None if v is None else v.cpu() for k, v in d.items()}
    for x in (d, c):
        x["ok"] = (x["elig"] if x["node_ok"] is None
                   else x["elig"] & x["node_ok"])

    def mask_args(x):
        return x["attrs"], x["con"], x["luts"], x["elig"], x["base"], \
            x["u_mask"], x["node_ok"]

    def plain_mask(x):
        return landscape_mask_plain(x["attrs"], x["con"], x["luts"],
                                    x["ok"], x["base"], x["u_mask"])

    K.reset_launches()
    got = landscape_mask(*mask_args(d))
    _same([got], [plain_mask(d)], [plain_mask(c)])
    for rows in (None, "frames"):
        r = None if rows is None else d[rows]
        got = affinity_landscape(d["attrs"], d["aff"], d["luts"], r)
        want = affinity_landscape_plain(d["attrs"], d["aff"], d["luts"], r)
        want_cpu = affinity_landscape_plain(
            c["attrs"], c["aff"], c["luts"], None if r is None else c[rows])
        torch.cuda.synchronize()
        _same([got], [want], [want_cpu])
    got = landscapes(*mask_args(d)[:6], d["aff"], d["node_ok"])
    torch.cuda.synchronize()
    _same(got, [plain_mask(d),
                affinity_landscape_plain(d["attrs"], d["aff"], d["luts"])],
          [plain_mask(c),
           affinity_landscape_plain(c["attrs"], c["aff"], c["luts"])])
    assert K.LANDSCAPE.launches == 4


@pytest.mark.gpu
@pytest.mark.parametrize("spread", [False, True])
def test_multi_compact_matches_plain(cuda_device, spread):
    built = _zoned_built(spread=spread)
    inp = _on(built["inp"], cuda_device)
    cr, cv = frames_from_numpy(built["cand_rows"], built["cand_valid"],
                               cuda_device)
    args = (cr, cv, built["rs"], built["n_lanes"])
    got = psel.place_multi_compact_packed(inp, *args)
    want = psel.place_multi_compact_packed_plain(inp, *args)
    want_cpu = psel.place_multi_compact_packed_plain(
        built["inp"], *frames_from_numpy(built["cand_rows"],
                                         built["cand_valid"]),
        built["rs"], built["n_lanes"])
    torch.cuda.synchronize()
    _same(got, want, want_cpu)
    used0 = inp.used0.clone()
    chained = psel.place_multi_compact_chained(
        used0, inp._replace(used0=None), *args)
    assert chained[2] is used0
    _same(chained, want_cpu)


def _compact_on(case, device):
    """One of COMPACT_CASES on `device`: (inputs, frames, round size,
    lanes)."""
    arrs, cr, cv, rs, lanes = compact_case(PORT, case)
    return (multi_inputs_from_numpy(arrs, device),
            frames_from_numpy(cr, cv, device), rs, lanes)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_multi_compact_cases_match_plain(cuda_device, case):
    """K2 (csrc/compact_rounds.cu) against its plain version on the card
    and on CPU copies, to the bit, on every case of COMPACT_CASES, and
    its chained form in place."""
    inp, (cr, cv), rs, lanes = _compact_on(case, cuda_device)
    cpu, (ccr, ccv), _, _ = _compact_on(case, "cpu")
    K.reset_launches()
    got = psel.place_multi_compact_packed(inp, cr, cv, rs, lanes)
    torch.cuda.synchronize()
    assert K.MULTI_COMPACT.launches == 1
    want = psel.place_multi_compact_packed_plain(inp, cr, cv, rs, lanes)
    want_cpu = psel.place_multi_compact_packed_plain(cpu, ccr, ccv, rs,
                                                     lanes)
    _same(got, want, want_cpu)
    used0 = inp.used0.clone()
    chained = psel.place_multi_compact_chained(
        used0, inp._replace(used0=None), cr, cv, rs, lanes)
    torch.cuda.synchronize()
    assert chained[2] is used0
    _same(chained, want_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["global_frame", "padding_lanes", "spread"])
def test_multi_compact_prof_entry(cuda_device, case):
    """K2's PROF instantiation gives the main path's outputs and counts
    its real and padding steps, and a call of the main entry is one
    launch."""
    inp, (cr, cv), rs, lanes = _compact_on(case, cuda_device)
    K.reset_launches()
    got = psel.place_multi_compact_packed(inp, cr, cv, rs, lanes)
    assert K.MULTI_COMPACT.launches == 1
    # csrc/compact_rounds.cu PhaseClock: 7 phases a step kind, the step
    # counts, the set-up and the whole launch
    prof = torch.zeros(18, dtype=torch.int64, device=cuda_device)
    again = psel._compact_launch(inp.used0.clone(), inp.used0, inp, cr, cv,
                                 rs, lanes, prof=prof)
    torch.cuda.synchronize()
    _same(again, got)
    c = prof.tolist()
    # block 0 is lane 0's first block: its steps are the wave's
    steps = inp.round_g.shape[0] // lanes
    real = int((inp.round_want.view(steps, lanes)[:, 0] > 0).sum())
    assert c[14] == real and c[14] + c[15] == steps
    assert c[17] > 0


@pytest.mark.gpu
def test_multi_compact_refuses_bad_inputs(cuda_device):
    """K2's wrapper raises on a CPU tensor among CUDA ones, a wrong
    dtype or a round size the kernel does not take; nothing launches."""
    inp, (cr, cv), rs, lanes = _compact_on("binpack", cuda_device)
    K.reset_launches()
    with pytest.raises(ValueError, match="not CUDA"):
        psel.place_multi_compact_packed(inp, cr.cpu(), cv, rs, lanes)
    with pytest.raises(ValueError, match="int32"):
        psel.place_multi_compact_packed(inp, cr.long(), cv, rs, lanes)
    with pytest.raises(ValueError, match="rounds <= 1024"):
        psel.place_multi_compact_packed(inp, cr, cv, 2048, lanes)
    assert K.MULTI_COMPACT.launches == 0


@pytest.mark.gpu
@pytest.mark.parametrize("spread", [False, True])
def test_multi_flat_matches_plain(cuda_device, spread):
    built = _flat_built(spread=spread)
    inp = _on(built["inp"], cuda_device)
    got = psel.place_multi_packed(inp, built["rs"])
    want = psel.place_multi_packed_plain(inp, built["rs"])
    want_cpu = psel.place_multi_packed_plain(built["inp"], built["rs"])
    torch.cuda.synchronize()
    _same(got, want, want_cpu)


def _flat_on(case, device, n_rows=None):
    """One of FLAT_CASES on `device`: (inputs, round size)."""
    arrs, rs = flat_case(PORT, case, n_rows=n_rows)
    return multi_inputs_from_numpy(arrs, device), rs


def _flat_matches_plain(cuda_device, case, n_rows=None):
    """K3 (csrc/compact_rounds.cu flat mode) at one of FLAT_CASES against
    its plain version on the card and on CPU copies, to the bit: one
    launch, `inp.used0` untouched; then the chained form in place."""
    inp, rs = _flat_on(case, cuda_device, n_rows)
    cpu, _ = _flat_on(case, "cpu", n_rows)
    used0 = inp.used0.clone()
    K.reset_launches()
    got = psel.place_multi_packed(inp, rs)
    torch.cuda.synchronize()
    assert K.MULTI_FLAT.launches == 1
    assert torch.equal(inp.used0, used0)
    want = psel.place_multi_packed_plain(inp, rs)
    want_cpu = psel.place_multi_packed_plain(cpu, rs)
    _same(got, want, want_cpu)
    chained = psel.place_multi_chained(used0, inp._replace(used0=None), rs)
    torch.cuda.synchronize()
    assert chained[1] is used0
    _same(chained, want_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_multi_flat_cases_match_plain(cuda_device, case):
    """K3 on every case of FLAT_CASES (two alternating signatures, a job
    over two groups, spread, round sizes 1 and 1024, idle and memoised
    rounds, 37 rows), and its chained form."""
    _flat_matches_plain(cuda_device, case)


# K3's two layouts (csrc/compact_rounds.cu plan) at round size 64: the
# flat wave's 50,000 rows fit in the shared memory of a 16-block
# cluster; 100,000 rows do not, and take 8 blocks with the frame in
# global scratch
FLAT_LAYOUTS = {50000: (16, False), 100000: (8, True)}


def _flat_layout(n_rows):
    blocks, glob = FLAT_LAYOUTS[n_rows]
    assert K.MULTI_FLAT.fn("multi_compact_blocks")(n_rows, 64, 1, 1) == blocks
    scratch = K.MULTI_FLAT.fn("multi_compact_scratch_bytes")(1, n_rows, 64,
                                                             1, 1)
    assert (scratch > 0) == glob


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", sorted(FLAT_LAYOUTS))
@pytest.mark.parametrize("case", ["binpack", "spread"])
def test_multi_flat_wide_frame_matches_plain(cuda_device, case, n_rows):
    """K3 over 50,000 rows (the flat wave's width, the case's node axis
    tiled) on a cluster of 16 blocks with the frame in shared memory,
    and over 100,000 rows on 8 blocks with the frame in global
    scratch."""
    _flat_layout(n_rows)
    _flat_matches_plain(cuda_device, case, n_rows)


@pytest.mark.gpu
@pytest.mark.parametrize("n_rows", sorted(FLAT_LAYOUTS))
def test_multi_flat_prof_entry(cuda_device, n_rows):
    """K3's PROF instantiation gives the main path's outputs and counts
    its real and padding steps, in both layouts."""
    _flat_layout(n_rows)
    inp, rs = _flat_on("padding_rounds", cuda_device, n_rows)
    got = psel._flat_launch(torch.empty_like(inp.used0), inp.used0, inp, rs)
    prof = torch.zeros(18, dtype=torch.int64, device=cuda_device)
    again = psel._flat_launch(torch.empty_like(inp.used0), inp.used0, inp,
                              rs, prof=prof)
    torch.cuda.synchronize()
    _same(again, got)
    c = prof.tolist()
    real = int((inp.round_want > 0).sum())
    assert c[14] == real and c[14] + c[15] == inp.round_g.shape[0]
    assert c[17] > 0


@pytest.mark.gpu
def test_scatter_add_matches_plain(cuda_device):
    rng = np.random.default_rng(0)
    used = torch.tensor(rng.integers(0, 1000, (500, 3)), dtype=torch.int32,
                        device=cuda_device)
    rows = torch.tensor(rng.integers(0, 500, 20000), dtype=torch.int32,
                        device=cuda_device)
    vals = torch.tensor(rng.integers(-50, 50, (20000, 3)),
                        dtype=torch.int32, device=cuda_device)
    want = scatter_add_plain(used.clone(), rows, vals)
    want_cpu = scatter_add_plain(used.cpu(), rows.cpu(), vals.cpu())
    got = scatter_add_(used, rows, vals)
    torch.cuda.synchronize()
    _same([got], [want], [want_cpu])


@pytest.mark.gpu
def test_device_pow10_matches_c_library(cuda_device):
    """The rounds kernels' device 10^x against the C library's powf (the
    CPU plain version) on every float32 in [0, 1], the exponents the
    binpack score can take."""
    chunk = 1 << 25
    bad = 0
    for lo in range(0, 0x3F800001, chunk):
        hi = min(lo + chunk, 0x3F800001)
        x = (torch.arange(lo, hi, dtype=torch.int64).to(torch.int32)
             .view(torch.float32))
        got = pow10_on_card(x.to(cuda_device)).cpu()
        bad += int((got.view(torch.int32)
                    != pow10(x).view(torch.int32)).sum())
    assert bad == 0


@pytest.mark.gpu
def test_wrapper_refuses_wrong_dtype(cuda_device):
    used = torch.zeros((4, 3), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        scatter_add_(used, torch.zeros(1, dtype=torch.int32,
                                       device=cuda_device),
                     torch.zeros((1, 3), dtype=torch.int32,
                                 device=cuda_device))


# ------------------------------------------------------- solo kernels

SCAN_CASES = {
    "binpack": dict(),
    "spread_algo": dict(spread_algo=True),
    "spread_affinity": dict(n=300, p=64, s=2, k=3),
    "distinct_prev_extra": dict(s=1, k=4, d=2, prev=True, extra=True,
                                dh=True, p=32, p_real=27, tight=True),
    "one_node": dict(n=1, g=3, p=8),
    "two_nodes": dict(n=2, p=8, p_real=5),
    **MEMO_SCAN_CASES,
    # the [G, N] caches past shared memory: flags, noise and the spread
    # and distinct values there, the rest in global memory
    "caches_in_global": dict(n=4000, g=60, p=32, s=1, d=1, dh=True),
    # the group statics and counts past shared memory
    "groups_in_global": dict(n=8, g=4500, p=16, s=1, d=1),
}


def _scan_inputs(case, device="cpu"):
    arr = random_placement_arrays(np.random.default_rng(11), **SCAN_CASES[case])
    return placement_inputs_from_numpy(arr, device)


def _bulk_inputs(device="cpu", spread_algo=False, n=200, p_real=700,
                 extra=True):
    arr = random_placement_arrays(np.random.default_rng(5), n=n, g=2,
                                  p=8, spread_algo=spread_algo, dh=True,
                                  extra=extra)
    arr = {k: arr[k] for k in psel.BulkInputs._fields if k in arr}
    arr.update(g=np.int32(1), p_real=np.int32(p_real))
    return bulk_inputs_from_numpy(arr, device)


def _preempt_args(device="cpu", **kw):
    return preempt_args_from_numpy(
        random_preempt_args(np.random.default_rng(3), **kw), device)


BULK_MODES = {"full": (False, 0), "scores": (True, 0), "compact": (False, 32)}
# K6 on the card at a round size of 256, 3 rounds: (rows, p_real, a device
# AND-mask)
BULK_CARD_CASES = {
    "extra_mask": (200, 700, True),
    "n_below_round": (50, 600, True),          # 50 rows < round size
    "no_extra_mask": (200, 768, False),        # p_real = 3 whole rounds
    "p_real_not_multiple": (200, 300, False),  # 256, 44, then padding
}


def test_solo_wrappers_take_plain_versions_on_cpu():
    """CPU tensors never reach K5-K8: results equal the plain versions
    and no launch is counted."""
    K.reset_launches()
    inp = _scan_inputs("distinct_prev_extra")
    got = psel.place_packed(inp)
    _same(got, psel.pack_outputs(psel.place_plain(inp)))
    _same(psel.place(inp), psel.place_plain(inp))
    b = _bulk_inputs()
    for ws, fk in BULK_MODES.values():
        _same(psel.place_bulk_packed(b, 256, 4, ws, fk),
              psel.place_bulk_packed_plain(b, 256, 4, ws, fk))
    args = _preempt_args(m=40, a=4)
    _same(preempt_bulk(*args), preempt_bulk_plain(*args))
    fm = (inp.attrs, inp.elig, inp.dc_mask, inp.pool_mask, inp.con, inp.luts)
    _same([feasible_mask(*fm)], [feasible_mask_plain(*fm)])
    assert all(k.launches == 0 for k in K.KERNELS)


def test_solo_launches_refuse_wrong_dtypes_and_cpu_tensors():
    """The launch paths check dtypes first, then that every tensor is on
    one CUDA device: a wrong dtype or a CPU tensor raises before any
    launch."""
    inp = _scan_inputs("binpack")
    with pytest.raises(ValueError, match="int32"):
        psel._scan_launch(inp._replace(req=inp.req.long()))
    with pytest.raises(ValueError, match="float32"):
        psel._scan_launch(inp._replace(sp_weight=inp.sp_weight.double()))
    with pytest.raises(ValueError, match="not CUDA"):
        psel._scan_launch(inp)
    b = _bulk_inputs()
    with pytest.raises(ValueError, match="bool"):
        psel._bulk_launch(b._replace(elig=b.elig.int()), 256, 4, False, 0)
    with pytest.raises(ValueError, match="not CUDA"):
        psel._bulk_launch(b, 256, 4, False, 0)
    with pytest.raises(ValueError, match="not CUDA"):
        psel._bulk_launch(b, 256, 4, False, 32)
    args = _preempt_args(m=8, a=2)
    from nomad_tpu_torch.ops import preempt as P
    meta = args._replace(cap=args.cap.to("meta"))
    with pytest.raises(ValueError, match="int32"):
        P.preempt_bulk(*meta._replace(k0=args.k0.to("meta").long()))
    with pytest.raises(ValueError, match="not CUDA"):
        P.preempt_bulk(*meta)
    fm = [inp.attrs.to("meta"), inp.elig, inp.dc_mask, inp.pool_mask,
          inp.con, inp.luts]
    with pytest.raises(ValueError, match="bool"):
        feasible_mask(*fm[:4], inp.con, inp.luts.int())
    with pytest.raises(ValueError, match="not CUDA"):
        feasible_mask(*fm)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_place_scan_matches_plain(cuda_device, case):
    inp = _scan_inputs(case, cuda_device)
    got = psel.place_packed(inp)
    want = psel.pack_outputs(psel.place_plain(inp))
    want_cpu = psel.place_packed(_scan_inputs(case))
    torch.cuda.synchronize()
    _same(got, want, want_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["distinct_prev_extra", "one_node",
                                  "two_nodes"])
def test_ops_place_on_card_launches_k5(cuda_device, case):
    """`ops.place` on CUDA tensors launches K5 once (no plain step loop on
    the card) and its unpacked outputs equal the plain scan's on CPU
    copies of the inputs."""
    inp = _scan_inputs(case, cuda_device)
    K.reset_launches()
    got = psel.place(inp)
    torch.cuda.synchronize()
    assert K.PLACE_SCAN.launches == 1
    assert all(t.device.type == "cuda" for t in got)
    want_cpu = psel.place_plain(_scan_inputs(case))
    assert got._fields == want_cpu._fields
    _same(got, want_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BULK_CARD_CASES))
@pytest.mark.parametrize("mode", sorted(BULK_MODES))
@pytest.mark.parametrize("spread_algo", [False, True])
def test_bulk_matches_plain(cuda_device, mode, spread_algo, case):
    """K6 (K3's flat mode at one group, csrc/compact_rounds.cu
    `multi_bulk`) in each layout: one launch of its entry, equal to the
    plain version on the card and on CPU copies."""
    ws, fk = BULK_MODES[mode]
    n, p_real, extra = BULK_CARD_CASES[case]
    b = _bulk_inputs(cuda_device, spread_algo, n, p_real, extra)
    K.reset_launches()
    got = psel.place_bulk_packed(b, 256, 3, ws, fk)
    assert K.MULTI_BULK.source == "compact_rounds.cu"
    assert K.MULTI_BULK.launches == 1
    want = psel.place_bulk_packed_plain(b, 256, 3, ws, fk)
    want_cpu = psel.place_bulk_packed(
        _bulk_inputs("cpu", spread_algo, n, p_real, extra), 256, 3, ws, fk)
    torch.cuda.synchronize()
    _same(got, want, want_cpu)


def _device_kernels(fn, windows: int = 5):
    """`fn()` under a torch.profiler window, with the kernels' launch and
    eager-op counts zeroed just before it: its result and the names of
    the device activities (kernels, copies, fills) it ran.  A window in
    which the profiler recorded no device activity at all is a missed
    measurement, not a result: `fn` is run again in a fresh window (the
    counts zeroed again), up to `windows` times, and the test fails with
    that reason if every window came back empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        torch.cuda.synchronize()
        K.reset_launches()
        K.reset_eager()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        ops = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        if ops:
            return out, ops
    pytest.fail(f"torch.profiler recorded no device activity in {windows} "
                "windows: the launch was not measured")


# K7's card cases beyond the first four: one row, every row infeasible,
# padding steps (n_real < n_place), ties on every row, the 65,536 rows of
# a 50,000-node cluster with one victim a node, the engine's largest
# table at 32 victims, and one row past what the kernel keeps in shared
# memory (its launcher `preempt_smem_rows`)
PREEMPT_CARD_CASES = {
    "one_row": dict(m=1, a=4, n_fail=6),
    "every_row_infeasible": dict(m=64, a=4, n_fail=20),
    "padding_steps": dict(m=100, a=2, n_fail=37),
    "ties_every_row": dict(m=128, a=2, ties=True, n_fail=100),
    "rows_65536_a1": dict(m=65536, a=1, n_fail=256),
    "rows_8192_a32": dict(m=8192, a=32, big=True, k0max=3, n_fail=64),
    "past_shared_memory": dict(a=4, k0max=2, n_fail=120),
}


def _preempt_case(case, device):
    kw = dict(PREEMPT_CARD_CASES[case])
    if case == "past_shared_memory":
        kw["m"] = K.PREEMPT_BULK.fn("preempt_smem_rows")() + 1
    args = _preempt_args(device, **kw)
    if case == "every_row_infeasible":
        args = args._replace(static_g=torch.zeros_like(args.static_g))
    return args


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(m=300, a=1), dict(m=500, a=32, big=True,
                                k0max=5, n_fail=60),
                                dict(m=64, a=8, ties=True, n_fail=40),
                                dict(m=40, a=16, dh=1, n_fail=20)]
                         + [pytest.param(c, id=c)
                            for c in sorted(PREEMPT_CARD_CASES)])
def test_preempt_matches_plain(cuda_device, kw):
    """K7 (csrc/preempt.cu) equal to its plain version on the card and on
    CPU copies; one launch, and no other device op in the wrapper (the
    profiler sees one kernel)."""
    if isinstance(kw, str):
        args = _preempt_case(kw, cuda_device)
        args_cpu = _preempt_case(kw, "cpu")
    else:
        args = _preempt_args(cuda_device, **kw)
        args_cpu = _preempt_args("cpu", **kw)
    preempt_bulk(*args)                    # built and bound
    got, ops = _device_kernels(lambda: preempt_bulk(*args))
    assert K.PREEMPT_BULK.launches == 1 and not K.EAGER
    assert len(ops) == 1 and "preempt" in ops[0], ops
    want = preempt_bulk_plain(*args)
    want_cpu = preempt_bulk(*args_cpu)
    torch.cuda.synchronize()
    _same(got, want, want_cpu)
    if kw == "every_row_infeasible":
        assert (got[0] == -1).all()
    elif isinstance(kw, str):
        assert (got[0][:args.n_real] >= 0).any()
        assert (got[0][args.n_real:] == -1).all()


def _feasible_inputs(case, device="cpu"):
    """K8's arguments from a scan case; `dc_pool_differ` draws datacenter
    and pool rows that differ over a case with ineligible rows."""
    if case != "dc_pool_differ":
        i = _scan_inputs(case, device)
        return [i.attrs, i.elig, i.dc_mask, i.pool_mask, i.con, i.luts]
    rng = np.random.default_rng(8)
    i = _scan_inputs("spread_affinity")
    n = i.attrs.shape[0]
    fm = [i.attrs, i.elig, torch.from_numpy(rng.random(n) < 0.7),
          torch.from_numpy(rng.random(n) < 0.7), i.con, i.luts]
    assert not torch.equal(fm[2], fm[3]) and not fm[1].all()
    return [t.to(device) for t in fm]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["spread_affinity", "distinct_prev_extra",
                                  "dc_pool_differ"])
def test_feasible_mask_matches_plain(cuda_device, case):
    """K8: one launch of K1's pass counted on K8 (none on K1), no other
    device op in the wrapper, equal to its plain version on the card and
    on CPU copies."""
    fm = _feasible_inputs(case, cuda_device)
    feasible_mask(*fm)                     # built and bound
    got, ops = _device_kernels(lambda: feasible_mask(*fm))
    assert K.FEASIBLE.launches == 1 and K.LANDSCAPE.launches == 0
    assert not K.EAGER and len(ops) == 1 and "landscape" in ops[0], ops
    want = feasible_mask_plain(*fm)
    want_cpu = feasible_mask_plain(*_feasible_inputs(case))
    torch.cuda.synchronize()
    _same([got], [want], [want_cpu])


@pytest.mark.gpu
def test_solo_wrappers_refuse_wrong_dtype_on_card(cuda_device):
    inp = _scan_inputs("binpack", cuda_device)
    with pytest.raises(ValueError):
        psel.place_packed(inp._replace(tg_idx=inp.tg_idx.long()))
    args = _preempt_args(cuda_device, m=8, a=2)
    with pytest.raises(ValueError):
        preempt_bulk(*args._replace(req=args.req.float()))


# ------------------------------------------------------ mesh kernels

from nomad_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from nomad_tpu_torch.parallel import place_sharded  # noqa: E402
from torch_parity import pad_arrays  # noqa: E402

S = 8
MESH_SCAN_CASES = {
    "padding_spread_distinct": dict(n=37, s=2, k=3, d=1, kd=3, p=32),
    "n_loc_below_3": dict(n=13, p=16, s=1),
    "few_feasible": dict(n=6, p=16, tight=True),
    "reschedule_extra_dh": dict(n=300, prev=True, extra=True, dh=True,
                                tight=True, p=64, p_real=59),
    # spread counts past shared memory: each block's copy in global memory
    "counts_in_global": dict(n=64, s=1, k=41000, p=16),
    # a part's post across parts past its 64 words in shared memory
    # (XW + S + D = 65): the pick's values read from the exchange buffer
    "posts_past_shared": dict(n=37, s=47, k=3, d=2, kd=40, p=32),
    **MEMO_SCAN_CASES,
    # 2,000 rows a shard: flags, noise and values in shared memory, the
    # [G, N] scores in global memory
    "caches_in_global": dict(n=16000, g=60, p=16, s=1, d=1),
}


def _mesh_scan_inputs(case, device="cpu"):
    kw = MESH_SCAN_CASES[case]
    arr = random_placement_arrays(np.random.default_rng(21), **kw)
    return placement_inputs_from_numpy(
        pad_arrays(arr, pmesh.pad_nodes(kw["n"], S)), device)


def _mesh_bulk_inputs(device="cpu", spread_algo=False, n=200, p_real=700):
    arr = random_placement_arrays(np.random.default_rng(5), n=n, g=2,
                                  p=8, spread_algo=spread_algo, dh=True,
                                  extra=True)
    arr = pad_arrays(arr, pmesh.pad_nodes(n, S))
    arr = {k: arr[k] for k in psel.BulkInputs._fields if k in arr}
    arr.update(g=np.int32(1), p_real=np.int32(p_real))
    return bulk_inputs_from_numpy(arr, device)


def _mesh_engine():
    from nomad_tpu_torch.ops import PlacementEngine
    return PlacementEngine(device="cpu", mesh=pmesh.make_mesh(S, "cpu"))


def _mesh_built(zoned, spread=False, n_zones=5, count=40, n_flat=150):
    if zoned:
        h = build_zoned_cluster(PORT, n_nodes=301, n_zones=n_zones)
        n_items, zones = 11, n_zones
    else:
        h = build_flat_cluster(PORT, n_nodes=n_flat)
        n_items, count, zones = 9, 30, 0
    if spread:
        set_spread(PORT, h)
    _, items = add_jobs(PORT, h, n_items, count, zones=zones)
    built = _mesh_engine().build_multi_inputs(h.state.snapshot(), items,
                                              seed=4)
    assert (built["cand_rows"] is not None) == zoned
    return built


def test_mesh_wrappers_take_plain_versions_on_cpu():
    """CPU tensors never reach K9-K13: results equal the plain versions
    and no launch is counted; CPU tensors on a CUDA mesh raise."""
    K.reset_launches()
    mesh = pmesh.make_mesh(S, "cpu")
    inp = _mesh_scan_inputs("padding_spread_distinct")
    _same(pmesh.place_sharded_packed(inp, mesh),
          psel.pack_outputs(pmesh.place_sharded_plain(inp, S)))
    b = _mesh_bulk_inputs()
    _same(pmesh.place_bulk_sharded_packed(b, mesh, 256, 3),
          pmesh.place_bulk_sharded_plain(b, S, 256, 3))
    built = _mesh_built(True)
    cr, cv = frames_from_numpy(built["cand_rows"], built["cand_valid"])
    args = (cr, cv, mesh, built["rs"], built["n_lanes"])
    _same(pmesh.place_multi_compact_sharded(built["inp"], *args),
          pmesh.place_multi_compact_sharded_plain(
              built["inp"], cr, cv, S, built["rs"], built["n_lanes"]))
    used = torch.zeros((16, 3), dtype=torch.int32)
    pmesh.scatter_add_sharded_(used, torch.tensor([1, 9, 9], dtype=torch.int32),
                               torch.ones((3, 3), dtype=torch.int32), mesh)
    assert used[:, 0].tolist()[:10] == [0, 1, 0, 0, 0, 0, 0, 0, 0, 2]
    assert all(k.launches == 0 for k in K.KERNELS)
    with pytest.raises(ValueError, match="mesh on cuda"):
        pmesh.place_sharded_packed(inp, pmesh.make_mesh(S, "cuda"))
    with pytest.raises(ValueError, match="not CUDA"):
        psel._scan_launch(inp, n_shards=S)
    with pytest.raises(ValueError, match="shards"):
        psel._scan_launch(_scan_inputs("binpack"), n_shards=3)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(MESH_SCAN_CASES))
def test_k9_sharded_scan_matches_plain(cuda_device, case):
    mesh = pmesh.make_mesh(S, cuda_device)
    inp = _mesh_scan_inputs(case, cuda_device)
    got = pmesh.place_sharded_packed(inp, mesh)
    want = psel.pack_outputs(pmesh.place_sharded_plain(inp, S))
    want_cpu = pmesh.place_sharded_packed(_mesh_scan_inputs(case),
                                          pmesh.make_mesh(S, "cpu"))
    torch.cuda.synchronize()
    _same(got, want, want_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["padding_spread_distinct", "few_feasible",
                                  "n_loc_below_3"])
def test_place_sharded_on_card_launches_k9(cuda_device, case):
    """`parallel.place_sharded` on a card mesh launches K9 once and
    equals `unpack_outputs` of K9's packed output and the plain version
    on CPU copies."""
    mesh = pmesh.make_mesh(S, cuda_device)
    inp = _mesh_scan_inputs(case, cuda_device)
    K.reset_launches()
    got = place_sharded(inp, mesh)
    torch.cuda.synchronize()
    assert K.PLACE_SCAN_SHARDED.launches == 1
    assert all(t.device.type == "cuda" for t in got)
    want = psel.unpack_outputs(*pmesh.place_sharded_packed(inp, mesh))
    want_cpu = place_sharded(_mesh_scan_inputs(case),
                             pmesh.make_mesh(S, "cpu"))
    torch.cuda.synchronize()
    assert got._fields == want_cpu._fields
    _same(got, want, want_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("spread_algo", [False, True])
def test_k10_sharded_bulk_matches_plain(cuda_device, spread_algo):
    """K10 (K6's entry over the npad rows, csrc/compact_rounds.cu
    `multi_bulk_sharded`): one launch each, equal to the plain version
    on the card and on CPU copies."""
    mesh = pmesh.make_mesh(S, cuda_device)
    for n, p_real in ((200, 700), (50, 600)):   # n_loc < round size
        b = _mesh_bulk_inputs(cuda_device, spread_algo, n, p_real)
        K.reset_launches()
        got = pmesh.place_bulk_sharded_packed(b, mesh, 256, 3)
        assert K.MULTI_BULK_SHARDED.source == "compact_rounds.cu"
        assert K.MULTI_BULK_SHARDED.launches == 1
        want = pmesh.place_bulk_sharded_plain(b, S, 256, 3)
        want_cpu = pmesh.place_bulk_sharded_plain(
            _mesh_bulk_inputs("cpu", spread_algo, n, p_real), S, 256, 3)
        torch.cuda.synchronize()
        _same(got, want, want_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["binpack", "spread", "padded_1001",
                                  "few_feasible"])
def test_k11_sharded_flat_matches_plain(cuda_device, case):
    """K11 (K3's flat mode over the npad rows, csrc/compact_rounds.cu):
    one launch of its entry there, and every kernel's source among the
    sources that build.  150 and
    1,001 rows pad to 152 and 1,008 (rows a shard below and above the
    round size); few_feasible: every 13th row eligible, fewer feasible
    rows than a round."""
    mesh = pmesh.make_mesh(S, cuda_device)
    built = _mesh_built(False, case == "spread",
                        n_flat=1001 if case == "padded_1001" else 150)
    cpu = built["inp"]
    if case == "few_feasible":
        elig = torch.zeros_like(cpu.elig)
        elig[:150:13] = True
        cpu = cpu._replace(elig=elig)
    inp = _on(cpu, cuda_device)
    rs = built["rs"]
    K.reset_launches()
    got = pmesh.place_multi_sharded_packed(inp, mesh, rs)
    assert K.MULTI_FLAT_SHARDED.source == "compact_rounds.cu"
    assert K.MULTI_FLAT_SHARDED.launches == 1
    assert all(k.source in K.SOURCES for k in K.KERNELS)
    want = pmesh.place_multi_sharded_plain(inp, S, rs)
    want_cpu = pmesh.place_multi_sharded_plain(cpu, S, rs)
    torch.cuda.synchronize()
    _same(got, want, want_cpu)
    assert torch.equal(inp.used0.cpu(), cpu.used0)
    used0 = inp.used0.clone()
    chained = pmesh.place_multi_sharded_chained(
        used0, inp._replace(used0=None), mesh, rs)
    assert chained[1] is used0
    _same(chained, want_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["five_lanes", "two_lanes", "spread",
                                  "round_512", "empty_shards"])
def test_k12_sharded_compact_matches_plain(cuda_device, case):
    """K12 (csrc/compact_rounds.cu over shard-major frames, one block a
    shard).  round_512: a round past 48 KB of shared memory with the
    static arrays; empty_shards: lane 0 without rows on shards 0-2."""
    mesh = pmesh.make_mesh(S, cuda_device)
    built = _mesh_built(True, case == "spread",
                        2 if case == "two_lanes" else 5,
                        300 if case == "round_512" else 40)
    assert built["rs"] == (512 if case == "round_512" else 64)
    inp = _on(built["inp"], cuda_device)
    rs, lanes = built["rs"], built["n_lanes"]
    crn, cvn = built["cand_rows"].copy(), built["cand_valid"].copy()
    if case == "empty_shards":
        crn[:3, 0] = inp.attrs.shape[0]
        cvn[:3, 0] = False
    cr, cv = frames_from_numpy(crn, cvn, cuda_device)
    K.reset_launches()
    got = pmesh.place_multi_compact_sharded(inp, cr, cv, mesh, rs, lanes)
    assert K.MULTI_COMPACT_SHARDED.launches == 1
    want = pmesh.place_multi_compact_sharded_plain(inp, cr, cv, S, rs, lanes)
    want_cpu = pmesh.place_multi_compact_sharded_plain(
        built["inp"], cr.cpu(), cv.cpu(), S, rs, lanes)
    torch.cuda.synchronize()
    _same(got, want, want_cpu)
    used0 = inp.used0.clone()
    chained = pmesh.place_multi_compact_sharded_chained(
        used0, inp._replace(used0=None), cr, cv, mesh, rs, lanes)
    assert chained[2] is used0
    _same(chained, want_cpu)


@pytest.mark.gpu
def test_k12_prof_entry(cuda_device):
    """K12's PROF instantiation gives the main path's outputs and counts
    lane 0's real and padding steps."""
    mesh = pmesh.make_mesh(S, cuda_device)
    built = _mesh_built(True)
    inp = _on(built["inp"], cuda_device)
    rs, lanes = built["rs"], built["n_lanes"]
    cr, cv = frames_from_numpy(built["cand_rows"], built["cand_valid"],
                               cuda_device)
    got = pmesh.place_multi_compact_sharded(inp, cr, cv, mesh, rs, lanes)
    prof = torch.zeros(18, dtype=torch.int64, device=cuda_device)
    again = psel._compact_launch(inp.used0.clone(), inp.used0, inp, cr, cv,
                                 rs, lanes, n_shards=S, prof=prof)
    torch.cuda.synchronize()
    _same(again, got)
    c = prof.tolist()
    steps = inp.round_g.shape[0] // lanes
    real = int((inp.round_want.view(steps, lanes)[:, 0] > 0).sum())
    assert c[14] == real and c[14] + c[15] == steps


@pytest.mark.gpu
def test_k13_sharded_scatter_matches_plain(cuda_device):
    rng = np.random.default_rng(1)
    npad = 504
    used = torch.tensor(rng.integers(0, 1000, (npad, 3)), dtype=torch.int32,
                        device=cuda_device)
    rows = torch.tensor(rng.integers(-3, npad + 3, 20000), dtype=torch.int32,
                        device=cuda_device)
    vals = torch.tensor(rng.integers(-50, 50, (20000, 3)),
                        dtype=torch.int32, device=cuda_device)
    want = pmesh.scatter_add_sharded_plain(used.clone(), rows, vals, S)
    want_cpu = pmesh.scatter_add_sharded_plain(used.cpu(), rows.cpu(),
                                               vals.cpu(), S)
    got = pmesh.scatter_add_sharded_(used, rows, vals,
                                     pmesh.make_mesh(S, cuda_device))
    torch.cuda.synchronize()
    _same([got], [want], [want_cpu])


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards", [0, S])
def test_scan_prof_entry_and_one_launch_per_call(cuda_device, n_shards):
    """One place_packed / place_sharded_packed call is one launch of its
    kernel; the PROF instantiation (both block sizes) gives the same
    outputs and counts its steps."""
    case = "inactive_after_commit"
    inp = (_mesh_scan_inputs if n_shards else _scan_inputs)(case,
                                                            cuda_device)
    mesh = pmesh.make_mesh(S, cuda_device)
    kern = K.PLACE_SCAN_SHARDED if n_shards else K.PLACE_SCAN
    K.reset_launches()
    got = (pmesh.place_sharded_packed(inp, mesh) if n_shards
           else psel.place_packed(inp))
    assert kern.launches == 1
    for nt in (256, 1024):
        # csrc/place_scan.cu PhaseClock: 7 phases a step kind, the step
        # counts, the set-up and the whole launch
        prof = torch.zeros(18, dtype=torch.int64, device=cuda_device)
        again = psel._scan_launch(inp, n_shards, prof, nt)
        torch.cuda.synchronize()
        _same(again, got)
        c = prof.tolist()
        assert c[14] == int(inp.active.sum())
        assert c[14] + c[15] == inp.tg_idx.shape[0]
        assert c[17] > 0


@pytest.mark.gpu
def test_dsmem_exchange_probe_runs(cuda_device):
    sink = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    rc = K.PLACE_SCAN.fn("dsmem_exchange_probe")(
        100, S, sink.data_ptr(), K.stream_of(sink))
    torch.cuda.synchronize()
    assert rc == 0


@pytest.mark.gpu
def test_barrier_probe_runs(cuda_device):
    """The block barrier probe that prices every depth (chip_smoke.py),
    from csrc/compact_rounds.cu."""
    sink = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    rc = K.MULTI_COMPACT.fn("barrier_probe")(100, sink.data_ptr(),
                                             K.stream_of(sink))
    torch.cuda.synchronize()
    assert rc == 0


# ------------------------------------------------ usage delta replay

from torch_parity import SCATTER_ROW_CASES, scatter_case  # noqa: E402

# chunk sizes around the 256-thread block and the engine's full chunk
SCATTER_M = [0, 1, 255, 256, 257, 16384]


def _replay(kernel, used, rows, vals):
    """(kernel result, plain result on the card, plain result on CPU
    copies) of K4 or K13 (8 shards) on a copy of `used` each."""
    if kernel == "k4":
        run = scatter_add_
        plain = scatter_add_plain
    else:
        def run(u, r, v):
            return pmesh.scatter_add_sharded_(u, r, v,
                                              pmesh.make_mesh(S, u.device))

        def plain(u, r, v):
            return pmesh.scatter_add_sharded_plain(u, r, v, S)
    want = plain(used.clone(), rows, vals)
    want_cpu = plain(used.cpu(), rows.cpu(), vals.cpu())
    got = run(used.clone(), rows, vals)
    torch.cuda.synchronize()
    return got, want, want_cpu


def _replay_inputs(device, rows, seed=0, npad=504):
    rng = np.random.default_rng(seed)
    used = torch.tensor(rng.integers(0, 1000, (npad, 3)), dtype=torch.int32,
                        device=device)
    rows = torch.tensor(np.asarray(rows, np.int32), device=device)
    vals = torch.tensor(rng.integers(-50, 50, (rows.shape[0], 3)),
                        dtype=torch.int32, device=device)
    return used, rows, vals


@pytest.mark.gpu
@pytest.mark.parametrize("m", SCATTER_M)
@pytest.mark.parametrize("kernel", ["k4", "k13"])
def test_replay_matches_plain_at_chunk_sizes(cuda_device, kernel, m):
    """Rows in [-2 npad, 2 npad): wrapped, kept and dropped ones."""
    rows = np.random.default_rng(m).integers(-1008, 1008, m)
    got, want, want_cpu = _replay(kernel,
                                  *_replay_inputs(cuda_device, rows, m))
    _same([got], [want], [want_cpu])


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCATTER_ROW_CASES)
@pytest.mark.parametrize("kernel", ["k4", "k13"])
def test_replay_matches_plain_on_row_sets(cuda_device, kernel, case):
    rows, _ = scatter_case(case, 504, 3000, np.random.default_rng(9))
    got, want, want_cpu = _replay(kernel,
                                  *_replay_inputs(cuda_device, rows, 9))
    _same([got], [want], [want_cpu])


@pytest.mark.gpu
@pytest.mark.parametrize("row", [0, 503, -1])
@pytest.mark.parametrize("kernel", ["k4", "k13"])
def test_replay_every_row_equal(cuda_device, kernel, row):
    """A full chunk onto one row: every thread's atomics meet."""
    got, want, want_cpu = _replay(
        kernel, *_replay_inputs(cuda_device, [row] * 16384, 4))
    _same([got], [want], [want_cpu])


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["k4", "k13"])
def test_replay_rows_on_shard_boundaries(cuda_device, kernel):
    n_loc = 504 // S
    edges = [s * n_loc + d for s in range(S + 1) for d in (-1, 0)]
    rows = edges + [-r for r in edges] + [-504 - 1, 504]
    got, want, want_cpu = _replay(kernel,
                                  *_replay_inputs(cuda_device, rows * 40, 5))
    _same([got], [want], [want_cpu])


@pytest.mark.gpu
def test_replay_counts_one_launch_per_call(cuda_device):
    used, rows, vals = _replay_inputs(cuda_device, [1, -2, 3])
    K.reset_launches()
    scatter_add_(used, rows, vals)
    assert (K.SCATTER_ADD.launches, K.SCATTER_ADD_SHARDED.launches) == (1, 0)
    pmesh.scatter_add_sharded_(used, rows, vals,
                               pmesh.make_mesh(S, cuda_device))
    assert (K.SCATTER_ADD.launches, K.SCATTER_ADD_SHARDED.launches) == (1, 1)
    scatter_add_(used, rows[:0], vals[:0])          # nothing to launch
    torch.cuda.synchronize()
    assert sum(k.launches for k in K.KERNELS) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["k4", "k13"])
def test_replay_wrappers_refuse_bad_tensors(cuda_device, kernel):
    """A CPU/CUDA mix, a wrong dtype or a non-contiguous tensor raises
    before any launch."""
    used, rows, vals = _replay_inputs(cuda_device, [1, 2, 3, 4])
    if kernel == "k4":
        run = scatter_add_
    else:
        def run(u, r, v):
            return pmesh.scatter_add_sharded_(u, r, v,
                                              pmesh.make_mesh(S, cuda_device))
    K.reset_launches()
    wide = torch.zeros((4, 6), dtype=torch.int32, device=cuda_device)
    for bad in ((used, rows.cpu(), vals), (used, rows, vals.cpu()),
                (used, rows.long(), vals), (used.float(), rows, vals),
                (used, rows, vals.short()), (used, rows, wide[:, ::2]),
                (used.t().contiguous().t(), rows, vals),
                (used, rows, vals[:3])):
        with pytest.raises(ValueError):
            run(*bad)
    if kernel == "k13":                       # card tensors, CPU mesh
        with pytest.raises(ValueError, match="mesh on cpu"):
            pmesh.scatter_add_sharded_(used, rows, vals,
                                       pmesh.make_mesh(S, "cpu"))
    torch.cuda.synchronize()
    assert sum(k.launches for k in K.KERNELS) == 0


# ------------------------------------------ the executor seam on the card

def _card_harness(cuda_device, n_items=13, count=40):
    """A zoned test cluster whose engine lies on the card."""
    from nomad_tpu_torch.ops import PlacementEngine
    h = build_zoned_cluster(PORT)
    h.engine = PlacementEngine(device=cuda_device)
    h.engine.packer.attach(h.state)
    _, items = add_jobs(PORT, h, n_items, count)
    _, items2 = add_jobs(PORT, h, 7, 30, prefix="second")
    return h, items, items2


@pytest.mark.gpu
def test_executor_wave_on_card_equals_bare_engine(cuda_device):
    """A zoned wave, then a wave chained on its usage (claimed from the
    executor's slot), through TorchExecutor equal the same waves through
    the bare engine, to the bit."""
    from nomad_tpu_torch.ops import TorchExecutor
    runs = []
    for through in (False, True):
        h, items, items2 = _card_harness(cuda_device)
        ex = TorchExecutor(h.engine) if through else h.engine
        snap = h.state.snapshot()
        seeds = list(range(1, len(items) + 1))
        p1 = ex.dispatch_batch(snap, items, seed=seeds)
        d1 = ex.collect_batch(p1)
        chain = (p1["used"], p1["node_version"], p1["npad"])
        if through:
            ex.retain_chain("b1", 0, ex.chain_state(p1))
            chain = ex.claim_chain()[2]
        p2 = ex.dispatch_batch(snap, items2, seed=7, used0_dev=chain)
        d2 = ex.collect_batch(p2)
        assert p2["chained"]
        torch.cuda.synchronize()
        runs.append((p1["buf"].numpy().copy(), p2["buf"].numpy().copy(),
                     p2["used"].cpu(), d1 + d2))
        if through:
            assert ex.stats["dispatches"] == 2
            assert ex.stats["resident_waves"] == 1
    (a1, a2, au, ad), (b1, b2, bu, bd) = runs
    assert np.array_equal(a1, b1) and np.array_equal(a2, b2)
    assert torch.equal(au, bu)
    for x, y in zip(ad, bd):
        assert np.array_equal(x.picks, y.picks)
        assert [m.nodes_filtered for m in x.metrics] == \
            [m.nodes_filtered for m in y.metrics]


@pytest.mark.gpu
def test_executor_meters_count_the_bytes_that_moved(cuda_device):
    from nomad_tpu_torch.ops import TorchExecutor
    h, items, _ = _card_harness(cuda_device)
    ex = TorchExecutor(h.engine)
    snap = h.state.snapshot()
    pend = ex.dispatch_batch(snap, items)
    ex.collect_batch(pend)
    torch.cuda.synchronize()
    t = h.engine.packer.update(snap)
    # the node tensors and the usage, each uploaded once as the host
    # arrays are
    assert ex.stats["uploads"] == 2
    assert ex.upload_bytes_by_cause == {
        "initial-upload": (t.attrs.nbytes + t.cap.nbytes + t.elig.nbytes
                           + t.used.nbytes)}
    # the result buffer's pinned copy, and the full fills only when the
    # compact prefix overflowed
    fills = (pend["fills_full"].nbytes if ex.stats["d2h_fetches"] == 2
             else 0)
    assert ex.stats["d2h_bytes"] == pend["buf"].nbytes + fills
    resident = h.engine.device_resident_bytes()
    assert 0 < resident <= torch.cuda.memory_allocated(cuda_device)
    led = ex.ledger()
    assert 0 < led["hbm_resident_bytes"] <= \
        torch.cuda.memory_allocated(cuda_device)


@pytest.mark.gpu
def test_nvcc_builds_are_noted_in_the_compile_ledger(cuda_device, tmp_path,
                                                     monkeypatch):
    """A build into a fresh directory notes one miss per source on
    kernels.nvcc/<source>; a cached build notes nothing."""
    from nomad_tpu_torch.core.profiling import COMPILE
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(K, "build_seconds", K.build_seconds)

    def nvcc_sites():
        return {s: dict(v) for s, v in COMPILE.snapshot()["sites"].items()
                if s.startswith("kernels.nvcc/")}

    before = nvcc_sites()
    K.build_all()
    after = nvcc_sites()
    assert {s: v["misses"] - before.get(s, {}).get("misses", 0)
            for s, v in after.items()} == \
        {f"kernels.nvcc/{src}": 1 for src in K.SOURCES}
    assert all(v["first_launch_s"] > 0 for v in after.values())
    K.build_all()
    assert nvcc_sites() == after


# ----------------------------------------- the server loop on the card

def _card_server(device, dev_mode=True, n_items=12, count=30):
    """A port Server (one worker, eval_batch 16) over a zoned test
    cluster, its evals pinned (so their tie-break seeds are), on
    `device`.  Returns (server, evals)."""
    from nomad_tpu_torch.core.server import Server
    s = Server(dev_mode=dev_mode, num_workers=1, eval_batch=16,
               heartbeat_ttl=1e9, profile_hz=0, device=device)
    s.establish_leadership()
    add_zoned_cluster(PORT, s.state)
    jobs, _ = add_jobs(PORT, s, n_items, count)
    evals = make_evals(PORT, jobs)
    s.apply_eval_update(evals)
    return s, evals


def _server_fingerprint(s):
    snap = s.state.snapshot()
    return sorted((a.job_id, a.name, a.node_id, a.resources.cpu)
                  for j in snap.jobs()
                  for a in snap.allocs_by_job(j.namespace, j.id)
                  if not a.terminal_status())


def _drain_threaded(s, evals, deadline_s=120.0):
    import time
    s.start_scheduling()
    try:
        end = time.monotonic() + deadline_s
        while time.monotonic() < end and not all(
                s.state.eval_by_id(e.id).status == "complete"
                for e in evals):
            time.sleep(0.01)
    finally:
        s.stop_scheduling()


@pytest.mark.gpu
def test_server_wave_on_card_equals_cpu(cuda_device):
    """One batched wave through the port's Server in dev_mode on the
    card places what the same Server places on the CPU, launching K1
    and K2 and no solo kernel."""
    prints = []
    for device in ("cpu", cuda_device):
        s, evals = _card_server(device)
        try:
            K.reset_launches()
            assert s.process_all() == len(evals)
            torch.cuda.synchronize()
            launches = {k.name: k.launches for k in K.KERNELS}
            assert [s.state.eval_by_id(e.id).status for e in evals] == \
                ["complete"] * len(evals)
            prints.append(_server_fingerprint(s))
            assert s.workers[0].pipeline.stats["waves"] >= 1
        finally:
            s.shutdown()
    assert len(prints[0]) == 12 * 30
    assert prints[0] == prints[1]
    assert launches["landscape"] >= 1 and launches["multi_compact"] >= 1
    assert launches["place_scan"] == launches["multi_bulk"] == 0


@pytest.mark.gpu
def test_threaded_server_records_a_device_interval_per_wave(cuda_device):
    s, evals = _card_server(cuda_device, dev_mode=False)
    try:
        K.reset_launches()
        _drain_threaded(s, evals)
        assert [s.state.eval_by_id(e.id).status for e in evals] == \
            ["complete"] * len(evals)
        waves = s.workers[0].pipeline.stats["waves"]
        assert waves >= 1
        assert s.stage_timers.counts()["device"] == waves
        for _, t0, t1 in s.stage_timers.intervals("device"):
            assert t1 >= t0
        assert K.MULTI_COMPACT.launches >= 1
    finally:
        s.shutdown()


@pytest.mark.gpu
def test_failed_batched_launch_writes_the_worker_record(cuda_device):
    """A chain whose usage tensor is int64 (K2's wrapper refuses it
    before its launch): the worker logs "batch launch failed; going
    solo" and places the evals through the solo kernels, which is what
    chip_smoke.py's server phase gates on."""
    from nomad_tpu_torch.core.logging import RING
    s, evals = _card_server(cuda_device)
    try:
        t = s.engine.packer.update(s.state.snapshot())
        npad = s.engine._padded_n(t.n)
        bad = torch.zeros((npad, 3), dtype=torch.int64, device=cuda_device)
        s.workers[0].pipeline.claim_chain = \
            lambda: ("bad-chain", 0, (bad, t.version, npad))
        sub = RING.subscribe(maxsize=1 << 16)
        try:
            K.reset_launches()
            s.process_all()
            torch.cuda.synchronize()
        finally:
            RING.unsubscribe(sub)
        records = []
        while not sub.empty():
            records.append(sub.get_nowait())
        msgs = [(r["component"], r["msg"]) for r in records
                if r["level"] in ("warn", "error")]
        assert ("worker", "batch launch failed; going solo") in msgs
        assert K.MULTI_COMPACT.launches == 0
        assert K.PLACE_SCAN.launches + K.MULTI_BULK.launches >= 1
    finally:
        s.shutdown()


# ----------------------------------------- the agent on the card

def _card_agent(device, data_dir):
    """A started port Agent on `device`: one worker, no in-process
    clients, HTTP on a free port, no heartbeat expiry, sampler off."""
    from nomad_tpu_torch.agent import Agent
    return Agent(num_clients=0, heartbeat_ttl=1e9, profile_hz=0,
                 data_dir=str(data_dir), device=device).start()


def _wait_evals(api, eval_ids, deadline_s=120.0):
    import time
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        status = [api.evaluations.info(e)["Status"] for e in eval_ids]
        if all(s == "complete" for s in status):
            return
        time.sleep(0.02)
    raise AssertionError(f"evals unsettled: {status}")


@pytest.mark.gpu
def test_agent_on_card_takes_a_job_through_http(cuda_device, tmp_path):
    """A port Agent on the card: nodes through `PUT /v1/nodes`, one job
    through `PUT /v1/jobs`, placed by the card's kernels."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.api.client import APIClient
    from nomad_tpu_torch.structs import codec
    agent = _card_agent(cuda_device, tmp_path)
    try:
        assert agent.server.engine.device.type == "cuda"
        api = APIClient(address=agent.address)
        for i in range(6):
            api.nodes.register(codec.encode(mock.node(id=f"card-{i}")))
        job = mock.batch_job(id="card-job")
        job.task_groups[0].count = 4
        K.reset_launches()
        resp = api.jobs.register(codec.encode(job))
        _wait_evals(api, [resp["EvalID"]])
        torch.cuda.synchronize()
        launched = {k.name: k.launches for k in K.KERNELS if k.launches}
        allocs = api.jobs.allocations("card-job")
    finally:
        agent.shutdown()
    assert launched, "no kernel launched on the card"
    assert len(allocs) == 4
    assert {a["NodeID"] for a in allocs} <= {f"card-{i}" for i in range(6)}


@pytest.mark.gpu
def test_agent_launch_failure_surfaces_as_the_worker_record(cuda_device,
                                                            tmp_path):
    """A wave whose claimed chain holds an int64 usage tensor (K2's
    wrapper refuses it before its launch), driven through the agent's
    HTTP API: the worker's recovery record reaches the log ring, the
    evals are placed through the solo kernels, and K2 never launched; a
    refused launch is never a silent success."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.api.client import APIClient
    from nomad_tpu_torch.core.logging import RING
    from nomad_tpu_torch.structs import VolumeRequest, codec
    agent = _card_agent(cuda_device, tmp_path)
    s = agent.server
    s.eval_batch = 16
    try:
        api = APIClient(address=agent.address)
        add_zoned_cluster(PORT, s.state)
        s.stop_scheduling()
        jobs = []
        for i in range(6):
            job = mock.batch_job(id=f"fail-{i:04d}")
            job.datacenters = ["dc1", "dc2", "dc3"]
            tg = job.task_groups[0]
            tg.count = 10
            tg.volumes = {"data": VolumeRequest(
                name="data", type="csi", source=f"vol-zone{i % 5}",
                read_only=True)}
            jobs.append(job)
        eval_ids = [api.jobs.register(codec.encode(j))["EvalID"]
                    for j in jobs]
        t = s.engine.packer.update(s.state.snapshot())
        npad = s.engine._padded_n(t.n)
        bad = torch.zeros((npad, 3), dtype=torch.int64, device=cuda_device)
        s.workers[0].pipeline.claim_chain = \
            lambda: ("bad-chain", 0, (bad, t.version, npad))
        sub = RING.subscribe(maxsize=1 << 16)
        try:
            K.reset_launches()
            s.start_scheduling()
            _wait_evals(api, eval_ids)
            torch.cuda.synchronize()
        finally:
            RING.unsubscribe(sub)
        records = []
        while not sub.empty():
            records.append(sub.get_nowait())
        allocs = [api.jobs.allocations(j.id) for j in jobs]
    finally:
        agent.shutdown()
    msgs = [(r["component"], r["msg"]) for r in records
            if r["level"] in ("warn", "error")]
    assert ("worker", "batch launch failed; going solo") in msgs
    assert K.MULTI_COMPACT.launches == 0
    assert K.PLACE_SCAN.launches + K.MULTI_BULK.launches >= 1
    assert [len(a) for a in allocs] == [10] * 6


# ------------------------------------------- the native CUDA bridge
# (csrc/bridge.cu through native/bridge.py's ctypes bindings): each
# program word for word against the same kernels through their Python
# launchers, the resident chain, the compile error, the handle counts,
# the library's dependencies, a process without torch, and the executor

@pytest.fixture
def cuda_bridge(cuda_device):
    from nomad_tpu_torch.native.bridge import CudaBridge
    br = CudaBridge(torch.cuda.current_device())
    yield br
    br.close()
    assert br.leaked == 0


def _host_np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bridge_run(br, program, statics, leaves):
    """One program through the library, every input uploaded from the
    host: its three outputs fetched (as CPU tensors), every handle
    freed."""
    ex = br.compile(program, statics)
    ins = [br.upload(_host_np(lf)) for _, lf in leaves]
    outs = br.execute_resident(ex, ins, 3)
    got = [torch.from_numpy(br.fetch(h)) for h in outs]
    for h in ins + outs:
        br.buffer_free(h)
    return got


def _bridge_case(case, device):
    """(program, statics, leaves, the Python entry's outputs on the card,
    the library's launchers that must run once) of one BRIDGE_CASES
    case."""
    from nomad_tpu_torch.native.bridge import bulk_program, multi_program
    if case.startswith("k3"):
        built = _flat_built(spread=case == "k3_spread")
        inp = _on(built["inp"], device)
        launchers = {"landscape_pair": 1, "multi_flat": 1}
        if case == "k3_node_ok_scalar_seed":
            ok = torch.ones(inp.attrs.shape[0], dtype=torch.bool)
            ok[::7] = False
            inp = inp._replace(node_ok=ok.to(device),
                               seed=torch.tensor(3054198966, device=device))
            launchers["seed_widen"] = 1
        prog, st, leaves = multi_program(inp, built["rs"])
        want = psel.place_multi_packed(inp, built["rs"])
        if case == "k3_uint32_seed":
            leaves = [(k, inp.seed.cpu().numpy().astype(np.uint32)
                       if k == "seed" else v) for k, v in leaves]
            launchers["seed_widen"] = 1
    elif case.startswith("k2"):
        built = _zoned_built(spread=case == "k2_spread")
        inp = _on(built["inp"], device)
        cr, cv = frames_from_numpy(built["cand_rows"], built["cand_valid"],
                                   device)
        prog, st, leaves = multi_program(inp, built["rs"], cr, cv,
                                         built["n_lanes"])
        want = psel.place_multi_compact_packed(inp, cr, cv, built["rs"],
                                               built["n_lanes"])
        launchers = {"landscape_affinity": 1, "multi_compact": 1}
    else:
        b = _bulk_inputs(device, case == "k6_spread", 200, 700, extra=False)
        ws = case == "k6_scores"
        prog, st, leaves = bulk_program(b, 256, 3, ws)
        want = psel.place_bulk_packed(b, 256, 3, ws)
        launchers = {"feasible_mask": 1, "landscape_affinity": 1,
                     "multi_bulk": 1}
    return prog, st, leaves, want, launchers


BRIDGE_CASES = ("k3", "k3_spread", "k3_node_ok_scalar_seed",
                "k3_uint32_seed", "k2", "k2_spread", "k6", "k6_spread",
                "k6_scores")


@pytest.mark.gpu
@pytest.mark.parametrize("case", BRIDGE_CASES)
def test_bridge_program_equals_python_launchers(cuda_device, cuda_bridge,
                                                case):
    """K3, K2 and K6 (with their K1/K8 landscapes) through the library
    equal the same kernels through their Python launchers word for word
    (f32 score columns as bits); the library launches each of its
    launchers once and the Python wrappers not at all, and leaves no
    buffer."""
    br = cuda_bridge
    prog, st, leaves, want, launchers = _bridge_case(case, cuda_device)
    torch.cuda.synchronize()
    K.reset_launches()
    br.reset_launches()
    got = _bridge_run(br, prog, st, leaves)
    assert {k: v for k, v in br.launches().items() if v} == launchers
    assert all(k.launches == 0 for k in K.KERNELS)
    assert br.live_buffers() == 0 and br.live_bytes() == 0
    _same(got, [w.cpu() for w in want])


@pytest.mark.gpu
def test_bridge_resident_chain(cuda_device, cuda_bridge):
    """Upload once, execute on handles, chain wave 1's usage output into
    wave 2 (the usage strictly grows), equal to the Python launcher run
    from the same usage."""
    from nomad_tpu_torch.native.bridge import bulk_program, program_inputs
    br = cuda_bridge
    b = _bulk_inputs(cuda_device, False, 200, 300, extra=False)
    prog, st, leaves = bulk_program(b, 256, 2)
    ex = br.compile(prog, st)
    handles = [br.upload(_host_np(lf)) for _, lf in leaves]
    outs = br.execute_resident(ex, handles, 3)
    used = br.fetch(outs[1])
    chain = list(handles)
    chain[program_inputs(prog, st).index("used0")] = outs[1]
    outs2 = br.execute_resident(ex, chain, 3)
    used2 = br.fetch(outs2[1])
    assert used2.sum() > used.sum() > 0
    want = psel.place_bulk_packed(
        b._replace(used0=torch.from_numpy(used).to(cuda_device)), 256, 2)
    _same([torch.from_numpy(br.fetch(h)) for h in outs2],
          [w.cpu() for w in want])
    # host in, host out (ntb_execute): wave 1 again
    host = br.execute(ex, [_host_np(lf) for _, lf in leaves],
                      [br.buffer_info(h) for h in outs])
    _same([torch.from_numpy(x) for x in host],
          [torch.from_numpy(br.fetch(h)) for h in outs])
    for h in handles + outs + outs2:
        br.buffer_free(h)
    assert br.live_buffers() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("program,statics,match", [
    ("not a program", (), "unknown program"),
    ("place_multi_packed", (64, 0), "takes 3 static arguments"),
    ("place_multi_compact_packed", (2048, 5, 0), "round_size"),
])
def test_bridge_compile_error_surfaces(cuda_device, cuda_bridge, program,
                                       statics, match):
    from nomad_tpu_torch.native.bridge import BridgeError
    with pytest.raises(BridgeError, match=match):
        cuda_bridge.compile(program, statics)


@pytest.mark.gpu
def test_bridge_execute_refuses_bad_inputs(cuda_device, cuda_bridge):
    """A wrong input count or type comes back as an error, with nothing
    allocated."""
    from nomad_tpu_torch.native.bridge import BridgeError, bulk_program
    br = cuda_bridge
    b = _bulk_inputs(cuda_device, False, 200, 300, extra=False)
    prog, st, leaves = bulk_program(b, 256, 2)
    ex = br.compile(prog, st)
    handles = [br.upload(_host_np(lf)) for _, lf in leaves]
    with pytest.raises(BridgeError, match="takes 13 inputs"):
        br.execute_resident(ex, handles[:-1], 3)
    bad = list(handles)
    bad[1] = br.upload(_host_np(b.cap).astype(np.int64))
    with pytest.raises(BridgeError, match="cap .* is int64"):
        br.execute_resident(ex, bad, 3)
    for h in handles + [bad[1]]:
        br.buffer_free(h)
    assert br.live_buffers() == 0


@pytest.mark.gpu
def test_bridge_library_links_no_python_or_torch(cuda_device):
    import subprocess

    from nomad_tpu_torch.native.bridge import build_bridge
    out = subprocess.run(["readelf", "-d", build_bridge()], check=True,
                         capture_output=True, text=True).stdout
    needed = [ln.split("[")[1].rstrip("]") for ln in out.splitlines()
              if "(NEEDED)" in ln]
    assert needed
    assert not [n for n in needed
                if n.startswith(("libpython", "libtorch", "libc10"))]


@pytest.mark.gpu
def test_bridge_driven_without_torch(cuda_device, cuda_bridge, tmp_path):
    """A process that cannot import torch drives the K2 program through
    ctypes and numpy alone and gets the same output bytes."""
    import hashlib
    import json
    import subprocess
    import sys

    from nomad_tpu_torch.native.bridge import save_program
    prog, st, leaves, _, _ = _bridge_case("k2", cuda_device)
    got = _bridge_run(cuda_bridge, prog, st, leaves)
    save_program(str(tmp_path / "call.npz"), prog, st, leaves)
    code = ("import sys; sys.modules['torch'] = None; "
            "from nomad_tpu_torch.native.bridge import main; "
            "raise SystemExit(main(sys.argv[1:]))")
    out = subprocess.run(
        [sys.executable, "-c", code, cuda_bridge.lib_path,
         str(tmp_path / "call.npz"), str(torch.cuda.current_device())],
        check=True, capture_output=True, text=True, timeout=120)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["platform"] == "gpu" and line["live_buffers"] == 0
    assert line["sha256"] == [hashlib.sha256(g.numpy().tobytes()).hexdigest()
                              for g in got]


@pytest.mark.gpu
def test_bridge_executor_waves_equal_torch_executor(cuda_device):
    """A zoned wave, a wave chained on its usage and a flat wave through
    BridgeExecutor equal the same waves through TorchExecutor on the
    card, to the bit; K2, K3 launched through the library only."""
    from nomad_tpu_torch.ops import BridgeExecutor, TorchExecutor
    runs = []
    for backend in (TorchExecutor, BridgeExecutor):
        h, items, items2 = _card_harness(cuda_device)
        _, flat = add_jobs(PORT, h, 6, 20, zones=0, prefix="flat")
        ex = backend(h.engine)
        snap = h.state.snapshot()
        K.reset_launches()
        p1 = ex.dispatch_batch(snap, items,
                               seed=list(range(1, len(items) + 1)))
        d1 = ex.collect_batch(p1)
        ex.retain_chain("b1", 0, ex.chain_state(p1))
        p2 = ex.dispatch_batch(snap, items2, seed=7,
                               used0_dev=ex.claim_chain()[2])
        d2 = ex.collect_batch(p2)
        p3 = ex.dispatch_batch(snap, flat, seed=5)
        d3 = ex.collect_batch(p3)
        torch.cuda.synchronize()
        assert p2["chained"] and p3["cand_rows"] is None
        runs.append([np.array(p["buf"].numpy(), copy=True)
                     for p in (p1, p2, p3)]
                    + [_host_np(p2["used"]).copy(), _host_np(p3["used"]),
                       [d.picks.tolist() for d in d1 + d2 + d3]])
        if backend is BridgeExecutor:
            assert K.MULTI_COMPACT.launches == K.MULTI_FLAT.launches == 0
            lib = ex._bridge.launches()
            assert lib["multi_compact"] == 2 and lib["multi_flat"] == 1
            del p1, p2, p3
            ex.close()
            assert ex._bridge.leaked == 0
    for a, b in zip(*runs):
        if isinstance(a, list):
            assert a == b
        else:
            assert np.array_equal(a, b)


# ------------------------------------------- the mesh across parts

from nomad_tpu_torch.parallel import xmesh  # noqa: E402

# the parts of the card cases: two parts of one card, the same meeting
# in host memory (the exchange of cards without peer access, forced by
# the rule's private override), S parts of one shard each on one card
# (the automatic mesh's shard a part), one part a card across two cards
# where more than one is visible, one part on each of every visible
# card where more than two are, and one part a card on every visible
# card meeting in host memory where more than one is
XMESH_LAYOUTS = ("one_card", "one_card_host", "one_card_shard_a_part",
                 "cross_card", "every_card", "every_card_host")


def _host_mesh(parts):
    pmesh._FORCE_HOST_EXCHANGE = True
    try:
        return pmesh.make_mesh(S, parts)
    finally:
        pmesh._FORCE_HOST_EXCHANGE = False


def _xmesh(layout, cuda_device):
    if layout == "one_card":
        return pmesh.make_mesh(S, [cuda_device, cuda_device])
    if layout == "one_card_host":
        mesh = _host_mesh([cuda_device, cuda_device])
        assert mesh.exchange == "host"
        return mesh
    if layout == "one_card_shard_a_part":
        return pmesh.make_mesh(S, [cuda_device] * S)
    n = torch.cuda.device_count()
    if layout == "cross_card":
        if n < 2:
            pytest.skip("needs two cards")
        return pmesh.make_mesh(S, ["cuda:0", "cuda:1"])
    if layout == "every_card_host":
        if n < 2 or S % n:
            pytest.skip(f"needs more than one card dividing {S} shards")
        return _host_mesh([f"cuda:{i}" for i in range(n)])
    if n < 3 or S % n:
        pytest.skip(f"needs more than two cards dividing {S} shards")
    return pmesh.make_mesh(S, [f"cuda:{i}" for i in range(n)])


def _cpu_parts(n_parts=2):
    return pmesh.make_mesh(S, ["cpu"] * n_parts)


def _host(t):
    return t.cpu() if isinstance(t, xmesh.Parts) else _bits(t)


def _same_parts(got, *wants):
    for want in wants:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(_bits(_host(g)), _bits(_host(w)))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", XMESH_LAYOUTS)
@pytest.mark.parametrize("case", ["padding_spread_distinct", "n_loc_below_3",
                                  "reschedule_extra_dh", "few_feasible",
                                  "posts_past_shared"])
def test_k9_xmesh_matches_plain(cuda_device, case, layout):
    """K9 across parts: one launch a part, equal to the plain version
    across parts on CPU copies and to the one-card 8-shard mesh; each
    part's usage on its own card with npad / D rows."""
    mesh = _xmesh(layout, cuda_device)
    inp = _mesh_scan_inputs(case, cuda_device)
    K.reset_launches()
    got = pmesh.place_sharded_packed(inp, mesh)
    assert K.PLACE_SCAN_XMESH.launches == mesh.n_parts
    xmesh.check(mesh)
    want_cpu = pmesh.place_sharded_packed(_mesh_scan_inputs(case),
                                          _cpu_parts())
    one_card = pmesh.place_sharded_packed(inp, pmesh.make_mesh(S,
                                                               cuda_device))
    torch.cuda.synchronize()
    _same_parts(got, want_cpu, one_card)
    npad = inp.attrs.shape[0]
    d = mesh.n_parts
    assert [b.shape[0] for b in got[1].blocks] == [npad // d] * d
    assert [b.device for b in got[1].blocks] == mesh.parts


@pytest.mark.gpu
@pytest.mark.parametrize("layout", XMESH_LAYOUTS)
@pytest.mark.parametrize("spread_algo", [False, True])
def test_k10_xmesh_matches_plain(cuda_device, spread_algo, layout):
    mesh = _xmesh(layout, cuda_device)
    for n, p_real in ((200, 700), (50, 600)):
        b = _mesh_bulk_inputs(cuda_device, spread_algo, n, p_real)
        K.reset_launches()
        got = pmesh.place_bulk_sharded_packed(b, mesh, 256, 3)
        assert K.MULTI_BULK_XMESH.launches == mesh.n_parts
        xmesh.check(mesh)
        want_cpu = pmesh.place_bulk_sharded_packed(
            _mesh_bulk_inputs("cpu", spread_algo, n, p_real), _cpu_parts(),
            256, 3)
        one_card = pmesh.place_bulk_sharded_packed(
            b, pmesh.make_mesh(S, cuda_device), 256, 3)
        torch.cuda.synchronize()
        _same_parts(got, want_cpu, one_card)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", XMESH_LAYOUTS)
@pytest.mark.parametrize("case", ["binpack", "spread", "padded_1001",
                                  "wide_full"])
def test_k11_xmesh_matches_plain(cuda_device, case, layout):
    """K11 across parts against the plain version on CPU copies and the
    one-card mesh; `wide_full`: 40 rows under the spread algorithm, so
    each wide step's list holds its part's every row."""
    mesh = _xmesh(layout, cuda_device)
    built = _mesh_built(False, case in ("spread", "wide_full"),
                        n_flat={"padded_1001": 1001,
                                "wide_full": 40}.get(case, 150))
    cpu = built["inp"]
    inp = _on(cpu, cuda_device)
    rs = built["rs"]
    K.reset_launches()
    got = pmesh.place_multi_sharded_packed(inp, mesh, rs)
    assert K.MULTI_FLAT_XMESH.launches == mesh.n_parts
    xmesh.check(mesh)
    want_cpu = pmesh.place_multi_sharded_packed(cpu, _cpu_parts(), rs)
    one_card = pmesh.place_multi_sharded_packed(
        inp, pmesh.make_mesh(S, cuda_device), rs)
    torch.cuda.synchronize()
    _same_parts(got, want_cpu, one_card)
    used0 = xmesh.split(inp.used0.clone(), mesh)
    chained = pmesh.place_multi_sharded_chained(
        used0, inp._replace(used0=None), mesh, rs)
    xmesh.check(mesh)
    assert chained[1] is used0
    _same_parts(chained, want_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", XMESH_LAYOUTS)
@pytest.mark.parametrize("case", ["five_lanes", "two_lanes", "spread",
                                  "round_512", "wide_full"])
def test_k12_xmesh_matches_plain(cuda_device, case, layout):
    """K12 across parts against the plain version on CPU copies and the
    one-card mesh; `wide_full`: 300 placements a job under the spread
    algorithm, so each wide step's list holds its part's whole frame."""
    mesh = _xmesh(layout, cuda_device)
    built = _mesh_built(True, case in ("spread", "wide_full"),
                        2 if case == "two_lanes" else 5,
                        300 if case in ("round_512", "wide_full") else 40)
    inp = _on(built["inp"], cuda_device)
    rs, lanes = built["rs"], built["n_lanes"]
    cr, cv = frames_from_numpy(built["cand_rows"], built["cand_valid"],
                               cuda_device)
    K.reset_launches()
    got = pmesh.place_multi_compact_sharded(inp, cr, cv, mesh, rs, lanes)
    assert K.MULTI_COMPACT_XMESH.launches == mesh.n_parts
    xmesh.check(mesh)
    want_cpu = pmesh.place_multi_compact_sharded(
        built["inp"], cr.cpu(), cv.cpu(), _cpu_parts(), rs, lanes)
    one_card = pmesh.place_multi_compact_sharded(
        inp, cr, cv, pmesh.make_mesh(S, cuda_device), rs, lanes)
    torch.cuda.synchronize()
    _same_parts(got, want_cpu, one_card)
    used0 = xmesh.split(inp.used0.clone(), mesh)
    chained = pmesh.place_multi_compact_sharded_chained(
        used0, inp._replace(used0=None), cr, cv, mesh, rs, lanes)
    xmesh.check(mesh)
    assert chained[2] is used0
    _same_parts(chained, want_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", XMESH_LAYOUTS)
def test_k13_xmesh_matches_plain(cuda_device, layout):
    mesh = _xmesh(layout, cuda_device)
    used, rows, vals = _replay_inputs(cuda_device,
                                      np.random.default_rng(3).integers(
                                          -510, 510, 20000))
    want_cpu = pmesh.scatter_add_sharded_(
        xmesh.split(used.cpu(), _cpu_parts()), rows.cpu(), vals.cpu(),
        _cpu_parts())
    one_card = pmesh.scatter_add_sharded_(used.clone(), rows, vals,
                                          pmesh.make_mesh(S, cuda_device))
    # one launch a card for each chunk of up to xmesh.K13_SLOT_ROWS rows,
    # whichever device the chunk starts on (a CPU chunk is read from
    # pinned host memory by every card)
    cards = len({d.index for d in mesh.parts})
    pieces = -(-rows.shape[0] // xmesh.K13_SLOT_ROWS)
    for r, v in ((rows, vals), (rows.cpu(), vals.cpu())):
        K.reset_launches()
        got = pmesh.scatter_add_sharded_(xmesh.split(used.clone(), mesh),
                                         r, v, mesh)
        assert K.SCATTER_ADD_XMESH.launches == cards * (
            1 if r.is_cuda else pieces)
        torch.cuda.synchronize()
        _same_parts([got], [want_cpu], [one_card])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", XMESH_LAYOUTS)
def test_xmesh_threads_share_a_mesh(cuda_device, layout):
    """Two threads launching across one mesh at once (K12 in one, K11 in
    the other, as two workers of a Server share an engine): the mesh's
    lock queues each call's parts together on the streams they share, so
    no call waits out the deadline, and each thread's results equal the
    plain version's."""
    import threading

    mesh = _xmesh(layout, cuda_device)
    mesh.deadline = 1 << 31           # about a second: a stall fails fast
    zb = _mesh_built(True, False, 5, 40)
    fb = _mesh_built(False, False, n_flat=150)
    zin, fin = _on(zb["inp"], cuda_device), _on(fb["inp"], cuda_device)
    cr, cv = frames_from_numpy(zb["cand_rows"], zb["cand_valid"],
                               cuda_device)
    runs = {
        "k12": (lambda: pmesh.place_multi_compact_sharded(
            zin, cr, cv, mesh, zb["rs"], zb["n_lanes"]),
            pmesh.place_multi_compact_sharded(
                zb["inp"], cr.cpu(), cv.cpu(), _cpu_parts(), zb["rs"],
                zb["n_lanes"])),
        "k11": (lambda: pmesh.place_multi_sharded_packed(
            fin, mesh, fb["rs"]),
            pmesh.place_multi_sharded_packed(fb["inp"], _cpu_parts(),
                                             fb["rs"])),
    }
    errors = []
    start = threading.Barrier(len(runs))

    def loop(name):
        launch, want = runs[name]
        try:
            start.wait()
            for _ in range(25):
                got = launch()
                xmesh.check(mesh)
                _same_parts(got, want)
        except BaseException as e:          # noqa: BLE001 - reported below
            errors.append((name, e))

    threads = [threading.Thread(target=loop, args=(k,)) for k in runs]
    K.reset_launches()
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert K.MULTI_COMPACT_XMESH.launches == 25 * mesh.n_parts
    assert K.MULTI_FLAT_XMESH.launches == 25 * mesh.n_parts


@pytest.mark.gpu
@pytest.mark.parametrize("exchange", ["device", "host"])
@pytest.mark.parametrize("kernel", ["k9", "k11", "k12"])
def test_xmesh_deadline_raises(cuda_device, kernel, exchange):
    """A part whose peer never launches runs out its wait deadline (K9,
    and the rounds across parts, K11 and K12): the kernel ends (no
    hang), sets the error word (in the card's memory or in host memory),
    and `check` raises; the mesh then runs a whole call again."""
    parts = [cuda_device, cuda_device]
    mesh = (_host_mesh(parts) if exchange == "host"
            else pmesh.make_mesh(S, parts))
    assert mesh.exchange == exchange
    mesh.deadline = 1 << 20
    if kernel == "k9":
        inp = _mesh_scan_inputs("n_loc_below_3", cuda_device)
        name = "place_scan_xmesh"
        words = K.PLACE_SCAN_XMESH.fn("place_scan_xmesh_words")(
            2, inp.sp_counts0.shape[0], inp.pd_counts0.shape[0])

        def launch0(xp):
            return psel._scan_launch(xmesh.part_inputs(inp, mesh, 0),
                                     n_shards=4, xp=xp)
    elif kernel == "k11":
        built = _mesh_built(False, True, n_flat=150)
        inp = _on(built["inp"], cuda_device)
        rs, n = built["rs"], inp.attrs.shape[0]
        name = "multi_flat_xmesh"
        words = xmesh._rounds_words(1, 2, min(rs, n))

        def launch0(xp):
            q = xmesh.part_inputs(inp._replace(used0=None), mesh, 0)
            used_in = xmesh.block(inp.used0, mesh, 0)
            return psel._flat_launch(torch.empty_like(used_in), used_in, q,
                                     rs, xp=xp)
    else:
        built = _mesh_built(True, True, 5, 40)
        inp = _on(built["inp"], cuda_device)
        cr, cv = frames_from_numpy(built["cand_rows"], built["cand_valid"],
                                   cuda_device)
        rs, lanes = built["rs"], built["n_lanes"]
        name = "multi_compact_xmesh"
        words = xmesh._rounds_words(lanes, 2, min(rs, S * cr.shape[-1]))

        def launch0(xp):
            q = xmesh.part_inputs(inp._replace(used0=None), mesh, 0,
                                  xmesh._frame_axes())
            used_in = xmesh.block(inp.used0, mesh, 0)
            return psel._compact_launch(
                used_in.clone(), used_in, q, xmesh.block(cr, mesh, 0),
                xmesh.block(cv, mesh, 0), rs, lanes,
                n_shards=mesh.shards_per_part, xp=xp)

    xmesh._run_parts(mesh, name, words,
                     lambda p, xp: launch0(xp) if p == 0 else None)
    with pytest.raises(RuntimeError, match="ran out its wait"):
        xmesh.check(mesh)
    ms = xmesh.exchange_probe(mesh, 100)
    assert ms > 0
    if kernel != "k9":
        run, want, used0 = _rounds_xmesh_runs(kernel, mesh, cuda_device)
        used_in = xmesh.split(used0, mesh)
        got = run(xmesh.Parts([b.clone() for b in used_in.blocks]), used_in)
        xmesh.check(mesh)
        _same_parts(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["one_card", "one_card_host"])
def test_k9_xmesh_prof_entry(cuda_device, layout):
    """K9 across parts' PROF instantiation gives the main path's outputs
    and writes part 0's split (K9's 18 words, then the exchange's
    sub-phases of block 0 and of the cluster's last block)."""
    mesh = _xmesh(layout, cuda_device)
    inp = _mesh_scan_inputs("padding_spread_distinct", cuda_device)
    got = pmesh.place_sharded_packed(inp, mesh)
    xmesh.check(mesh)
    profs = [torch.zeros(34, dtype=torch.int64, device=d)
             for d in mesh.parts]
    words = K.PLACE_SCAN_XMESH.fn("place_scan_xmesh_words")(
        mesh.n_parts, inp.sp_counts0.shape[0], inp.pd_counts0.shape[0])
    outs = xmesh._run_parts(
        mesh, "place_scan_xmesh_prof", words,
        lambda p, xp: psel._scan_launch(xmesh.part_inputs(inp, mesh, p),
                                        n_shards=mesh.shards_per_part,
                                        prof=profs[p], xp=xp))
    xmesh.check(mesh)
    torch.cuda.synchronize()
    _same_parts((outs[0][0], xmesh.Parts([o[1] for o in outs]),
                 xmesh.Parts([o[2] for o in outs])), got)
    c = profs[0].tolist()
    assert c[14] == int(inp.active.sum())
    assert c[14] + c[15] == inp.tg_idx.shape[0]
    assert c[17] > 0
    assert c[18] > 0 and c[19] > 0         # block 0's post and wait
    assert c[26 + 1] + c[26 + 2] > 0       # a peer's wait and relay


def _rounds_xmesh_runs(kernel, mesh, cuda_device):
    """K11's or K12's launch across parts at a small input with wide
    steps (the spread algorithm): (run(used, used_in, profs=None), the
    plain version's outputs on CPU copies, the whole usage)."""
    if kernel == "k12":
        built = _mesh_built(True, True, 5, 40)
        cr, cv = frames_from_numpy(built["cand_rows"], built["cand_valid"],
                                   cuda_device)
        inp = _on(built["inp"], cuda_device)
        rs, lanes = built["rs"], built["n_lanes"]
        want = pmesh.place_multi_compact_sharded(
            built["inp"], cr.cpu(), cv.cpu(), _cpu_parts(), rs, lanes)
        return (lambda used, used_in, profs=None:
                xmesh.place_multi_compact_xmesh_launch(
                    used, used_in, inp, cr, cv, mesh, rs, lanes,
                    profs=profs)), want, inp.used0
    built = _mesh_built(False, True, n_flat=150)
    inp = _on(built["inp"], cuda_device)
    want = pmesh.place_multi_sharded_packed(built["inp"], _cpu_parts(),
                                            built["rs"])
    return (lambda used, used_in, profs=None:
            xmesh.place_multi_xmesh_launch(used, used_in, inp, mesh,
                                           built["rs"], profs=profs)), \
        want, inp.used0


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["one_card", "one_card_host"])
@pytest.mark.parametrize("kernel", ["k11", "k12"])
def test_rounds_xmesh_prof_entry(cuda_device, kernel, layout):
    """K11's and K12's PROF instantiations across parts
    (`multi_flat_xmesh_prof`, `multi_compact_xmesh_prof`) give the main
    path's outputs and write part 0's split: K2's 18 words, the
    exchanges' sub-phases of block 0 and of the cluster's last block,
    and block 0's narrow and wide exchange counts."""
    mesh = _xmesh(layout, cuda_device)
    run, want, used0 = _rounds_xmesh_runs(kernel, mesh, cuda_device)
    used_in = xmesh.split(used0, mesh)
    profs = [torch.zeros(psel.XPROF_WORDS, dtype=torch.int64, device=d)
             for d in mesh.parts]
    K.reset_launches()
    got = run(xmesh.Parts([b.clone() for b in used_in.blocks]), used_in,
              profs)
    xmesh.check(mesh)
    torch.cuda.synchronize()
    assert sum(k.launches for k in (K.MULTI_FLAT_XMESH,
                                    K.MULTI_COMPACT_XMESH)) == mesh.n_parts
    _same_parts(got, want)
    c = profs[0].tolist()
    nx, base = 9, 18
    assert c[14] > 0 and c[17] > 0
    narrow, wide = c[base + 4 * nx], c[base + 4 * nx + 1]
    assert narrow > 0 and wide > 0          # the spread algorithm's rounds
    assert c[base + 1] + c[base + nx + 1] > 0     # block 0's post
    assert c[base + 2] + c[base + nx + 2] > 0     # and wait
    assert sum(c[base + 5:base + 9]) + sum(c[base + nx + 5:base + 2 * nx]) > 0
