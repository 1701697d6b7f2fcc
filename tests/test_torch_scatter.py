"""K4's plain version (the usage delta replay) against the reference's
`_scatter_add_jit`, with rows that repeat, wrap or fall outside the
table, the engine's chunked replay onto its resident usage tensor, and
K13's plain version against K4's on the padded table (the premise of
K13's one pass).  Tolerance: exact (integer adds)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nomad_tpu.ops.engine import _scatter_add_jit
from nomad_tpu_torch.ops import engine as pengine
from nomad_tpu_torch.ops.engine import scatter_add_, scatter_add_plain
from nomad_tpu_torch.parallel import mesh as pmesh
from torch_parity import (
    SCATTER_ROW_CASES,
    add_jobs,
    build_zoned_cluster,
    scatter_case,
)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("m", [1, 700, 5000])
def test_repeated_rows_match_reference(m):
    rng = np.random.default_rng(m)
    used = rng.integers(0, 10_000, (300, 3)).astype(np.int32)
    rows = rng.integers(0, 300, m).astype(np.int32)
    rows[: m // 2] = rows[0]                 # heavy repetition
    vals = rng.integers(-500, 500, (m, 3)).astype(np.int32)
    want = np.asarray(_scatter_add_jit(jnp.asarray(used), jnp.asarray(rows),
                                       jnp.asarray(vals)))
    got = torch.tensor(used)
    out = scatter_add_(got, torch.tensor(rows), torch.tensor(vals))
    assert out is got                        # in place
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("case", SCATTER_ROW_CASES)
def test_row_sets_match_reference(case):
    """Rows in [-N, 0) wrap to r + N, rows below -N or at N and above
    drop, repeats sum, and an empty chunk changes nothing: as the
    reference's `u.at[r].add(v)`."""
    rng = np.random.default_rng(len(case))
    used = rng.integers(0, 10_000, (300, 3)).astype(np.int32)
    rows, vals = scatter_case(case, 300, 2000, rng)
    want = np.asarray(_scatter_add_jit(jnp.asarray(used), jnp.asarray(rows),
                                       jnp.asarray(vals)))
    got = scatter_add_plain(torch.tensor(used), torch.tensor(rows),
                            torch.tensor(vals))
    assert np.array_equal(want, got.numpy())


def test_negative_rows_example():
    """Five rows, rows [-1, -5, -6, 5, 7], all deltas 1: -1 adds to row
    4, -5 to row 0, the rest drop."""
    rows = np.array([-1, -5, -6, 5, 7], np.int32)
    vals = np.ones((5, 3), np.int32)
    zero = np.zeros((5, 3), np.int32)
    want = np.asarray(_scatter_add_jit(jnp.asarray(zero), jnp.asarray(rows),
                                       jnp.asarray(vals)))
    got = scatter_add_(torch.tensor(zero), torch.tensor(rows),
                       torch.tensor(vals))
    assert want[:, 0].tolist() == [1, 0, 0, 0, 1]
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_sharded_replay_is_one_pass_over_the_padded_table(n_shards):
    """K13's plain version (each shard adds the rows it owns) equals
    K4's on the padded table [npad, 3] for rows in [-2 npad, 2 npad):
    the shards of one card are one contiguous tensor, so one pass over
    the rows does K13's work."""
    rng = np.random.default_rng(n_shards)
    npad = pmesh.pad_nodes(37, n_shards) * 3
    used = rng.integers(0, 1000, (npad, 3)).astype(np.int32)
    rows = rng.integers(-2 * npad, 2 * npad, 3000).astype(np.int32)
    vals = rng.integers(-50, 50, (3000, 3)).astype(np.int32)
    one_pass = scatter_add_plain(torch.tensor(used), torch.tensor(rows),
                                 torch.tensor(vals))
    sharded = pmesh.scatter_add_sharded_plain(
        torch.tensor(used), torch.tensor(rows), torch.tensor(vals), n_shards)
    assert torch.equal(one_pass, sharded)


def test_engine_replays_deltas_through_chunks(monkeypatch):
    """After plans commit, the engine's resident usage catches up by
    replaying the packer's delta log in SCATTER_CHUNK pieces and equals
    the packer's host usage exactly."""
    monkeypatch.setattr(pengine, "SCATTER_CHUNK", 64)
    h = build_zoned_cluster("nomad_tpu_torch", n_nodes=200)
    eng = h.engine
    t = eng.packer.update(h.state.snapshot())
    before = eng._used_device(t).clone()
    _, items = add_jobs("nomad_tpu_torch", h, 10, 30)
    decisions = eng.place_batch(h.state.snapshot(), items, seed=5)
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Resources
    allocs = [mock.alloc(job=it.job, node_id=bd.node_ids[p],
                         task_group=it.tg.name,
                         resources=Resources(cpu=10, memory_mb=10),
                         client_status="running")
              for bd, it in zip(decisions, items) for p in bd.picks.tolist()]
    h.state.upsert_allocs(allocs)
    t = eng.packer.update(h.state.snapshot())
    deltas = eng.packer.used_deltas_since(eng._used_version)
    assert deltas is not None and sum(len(d[0]) for d in deltas) > 64
    after = eng._used_device(t)
    assert np.array_equal(after.numpy(), t.used)
    assert int((after - before)[:, 0].sum()) == 10 * len(allocs)
