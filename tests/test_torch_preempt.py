"""K7's plain version (`preempt.preempt_bulk`) against the reference's
`preempt_bulk_jit`, and the engine-level eviction sets of both routes
(device kernel, host Preemptor) against the reference's
(tests/test_preemption.py::TestDevicePreemptParity).

The kernel's cost prefix is an f32 cumulative sum: XLA's CPU backend
sums up to 16 victims in order and longer tables in blocks of 16, and
the victim cost (prio + 1) * 1000 + resources is one fma.  The cases pin
both, with victims large enough that the sums are inexact in f32, and
with equal costs on many candidates so the argmin's tie order (lowest
row) is held too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nomad_tpu.ops.preempt import preempt_bulk_jit
from nomad_tpu_torch.ops.convert import preempt_args_from_numpy
from nomad_tpu_torch.ops.preempt import preempt_bulk, xla_cumsum
from torch_parity import harness, pkg, random_preempt_args

NOW = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


CASES = {
    "a1": dict(m=40, a=1, n_fail=20),
    "a4_k0": dict(m=37, a=4, k0max=2),
    "a16_dh": dict(m=40, a=16, dh=1, n_fail=20),
    "a32_inexact_k0": dict(m=64, a=32, big=True, k0max=5, n_fail=40),
    "a8_inexact": dict(m=50, a=8, big=True, n_fail=30),
    "ties": dict(m=50, a=2, ties=True, n_fail=30),
    "ties_a32": dict(m=20, a=32, ties=True, n_fail=25, k0max=3),
    "more_asks_than_room": dict(m=6, a=2, n_fail=30),
}


def _ref(args):
    return [np.asarray(x) for x in preempt_bulk_jit(
        *[x if isinstance(x, int) else jnp.asarray(x) for x in args])]


@pytest.mark.parametrize("case", sorted(CASES))
def test_preempt_bulk_matches_reference(case):
    for rep in range(2):
        args = random_preempt_args(np.random.default_rng(rep), **CASES[case])
        want = _ref(args)
        got = preempt_bulk(*preempt_args_from_numpy(args))
        for w, g in zip(want, got):
            assert w.dtype == g.numpy().dtype
            assert np.array_equal(w, g.numpy())
        assert (want[0][args[10]:] == -1).all()     # padding steps


def _chained(args):
    """The reference's launch over all of `args`' steps, and the same
    steps as a chain of one-step launches: each step's usage and job
    count carried, and its row's consumed victims carried as a count
    (`k0 += ks` on the chosen row).  Returns (whole, chain, states):
    `states[t]` is (used, job_count, k0) before step t, and the last
    entry the state after the chain."""
    cap, used, static, dh, jc, prio, res, req, k0, n_place, n_real = args
    whole = _ref(args)
    k0 = k0.copy()
    best, ks, states = [], [], [(used, jc, k0.copy())]
    for t in range(n_place):
        b, k, used, jc = _ref((cap, used, static, dh, jc, prio, res, req,
                               k0, 1, np.int32(1 if t < n_real else 0)))
        if b[0] >= 0:
            k0[b[0]] += k[0]
        best.append(b[0])
        ks.append(k[0])
        states.append((used, jc, k0.copy()))
    chain = [np.array(best, np.int32), np.array(ks, np.int32), used, jc]
    return whole, chain, states


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_consumed_is_a_prefix(case):
    """The reference's consumed victims of a row are always a prefix of
    its table, so a count carries them: one-step launches chained with
    `k0 += ks` equal one launch of every step (best rows, counts, usage,
    job counts).  K7 keeps a count a row on this identity
    (csrc/preempt.cu)."""
    for rep in range(2):
        args = random_preempt_args(np.random.default_rng(rep), **CASES[case])
        whole, chain, _ = _chained(args)
        for w, c in zip(whole, chain):
            assert w.dtype == c.dtype and np.array_equal(w, c)
        assert (whole[0] >= 0).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_step_changes_one_row(case):
    """Row locality: a step of the reference changes the usage, job
    count and consumed count of its chosen row and of no other row (none
    at all when it places nothing).  So every other row's key carries
    over to the next step, and K7 recomputes one key a step."""
    for rep in range(2):
        args = random_preempt_args(np.random.default_rng(rep), **CASES[case])
        _, chain, states = _chained(args)
        m = args[0].shape[0]
        for t, b in enumerate(chain[0]):
            before, after = states[t], states[t + 1]
            others = np.arange(m) != b
            for x, y in zip(before, after):
                assert np.array_equal(x[others], y[others])
            if b >= 0:
                assert any(not np.array_equal(x[b], y[b])
                           for x, y in zip(before, after))


def test_inexact_costs_and_ties_are_exercised():
    """The f32 cost prefixes of the `big` tables are inexact (a float64
    sum differs), and the `ties` tables hold equal costs on many rows."""
    args = random_preempt_args(np.random.default_rng(0),
                               **CASES["a32_inexact_k0"])
    prio, res = args[5], args[6]
    cost = ((prio.astype(np.float32) + 1.0) * 1000.0
            + res.sum(2).astype(np.float32)).astype(np.float32)
    f64 = np.cumsum(cost.astype(np.float64), axis=1)
    assert (f64.astype(np.float32) != np.cumsum(cost, axis=1)).any()
    args = random_preempt_args(np.random.default_rng(0), **CASES["ties"])
    first = args[5][:, 0] * 1000 + args[6][:, 0].sum(1)
    assert (first == first[0]).sum() > 10


@pytest.mark.parametrize("a", [1, 2, 4, 8, 16, 32])
def test_xla_cumsum_order(a):
    """`xla_cumsum` reproduces jnp.cumsum's f32 bits; at 32 terms XLA's
    blocked order differs from a plain running sum."""
    rng = np.random.default_rng(a)
    x = ((rng.integers(0, 2 ** 20, (4000, a)) + 1.0) * 1000.0
         + rng.integers(0, 10 ** 6, (4000, a))).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=1))(x))
    got = xla_cumsum(torch.tensor(x)).numpy()
    assert np.array_equal(want.view(np.int32), got.view(np.int32))
    if a == 32:
        run = np.zeros_like(x)
        acc = np.zeros(len(x), np.float32)
        for i in range(a):
            acc = acc + x[:, i]
            run[:, i] = acc
        assert not np.array_equal(run, want)


# --------------------------------------------- engine-level eviction sets

def _cluster(name, n_nodes=40, n_low_jobs=3):
    """TestDevicePreemptParity's cluster from explicit ids: full nodes
    holding one alloc of each of three low-priority bands."""
    mock = pkg(name, "mock")
    structs = pkg(name, "structs")
    h = harness(name)
    h.state.set_scheduler_config(structs.SchedulerConfiguration(
        preemption_config=structs.PreemptionConfig(
            batch_scheduler_enabled=True, service_scheduler_enabled=True)))
    nodes = []
    for i in range(n_nodes):
        n = mock.node(id=f"node-{i:05d}", name=f"node-{i:05d}")
        n.resources = type(n.resources)(cpu=4000, memory_mb=8192,
                                        disk_mb=100000)
        n.reserved = type(n.reserved)()
        nodes.append(n)
    h.state.upsert_nodes(nodes)
    for p in range(n_low_jobs):
        low = mock.batch_job(id=f"low{p}", priority=10 + p * 10)
        low.task_groups[0].count = n_nodes
        low.task_groups[0].tasks[0].resources = structs.Resources(
            cpu=1200, memory_mb=256)
        h.state.upsert_job(low)
        e = mock.eval(id=f"eval-low{p}-0000-0000-000000000000", job_id=low.id,
                      type="batch")
        assert h.process("batch", e, now=NOW) is None
    hi = mock.job(id="hi", priority=90)
    hi.task_groups[0].count = 20
    hi.task_groups[0].tasks[0].resources = structs.Resources(
        cpu=2000, memory_mb=128)
    h.state.upsert_job(hi)
    return h, hi


def _evict(name, device: bool):
    h, hi = _cluster(name)
    snap = h.snapshot()
    eng = pkg(name, "ops").PlacementEngine
    eng = (eng(mesh=False) if name == "nomad_tpu"
           else eng(device="cpu"))
    if not device:
        eng.PREEMPT_DEVICE_MIN_FAILED = 10 ** 9     # host Preemptor only
    ds = eng.place(snap, hi, hi.task_groups, None, seed=3,
                   block=(hi.task_groups[0].name, 20))
    return ([d.node_id for d in ds],
            [sorted((v.job_id, v.name) for v in d.evictions) for d in ds])


@pytest.mark.parametrize("device", [True, False], ids=["kernel", "host"])
def test_eviction_sets_match_reference(device):
    """Each route gives the reference's picks and victims, per placement
    and in order."""
    ref = _evict("nomad_tpu", device)
    port = _evict("nomad_tpu_torch", device)
    assert all(p is not None for p in port[0])
    assert port == ref


def test_kernel_and_host_routes_agree():
    """Homogeneous priority bands: the port's two routes choose the same
    nodes and evict the same victims (the reference's own claim)."""
    dev = _evict("nomad_tpu_torch", True)
    host = _evict("nomad_tpu_torch", False)
    assert sorted(dev[0]) == sorted(host[0])
    assert sorted(v for e in dev[1] for v in e) == \
        sorted(v for e in host[1] for v in e)
