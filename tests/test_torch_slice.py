"""The slice end to end: the same seeded cluster and evals through the
reference's Harness batch flow and the port's (device="cpu") —
prepare_batch per eval, one multi-eval launch, submit_batched /
finalize_batched into the state store — must give identical
BulkDecisions picks and the same (job id, alloc name) -> node id map.
Covers the zoned wave (compact laned kernel), a chained second wave
started from the first wave's usage, and a single-signature wave (flat
kernel)."""

import numpy as np
import pytest
import torch

from torch_parity import (
    PACKAGES,
    add_jobs,
    alloc_map,
    build_flat_cluster,
    build_zoned_cluster,
    make_evals,
    run_batch_wave,
)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _zoned(name):
    h = build_zoned_cluster(name, n_nodes=300)
    jobs, _ = add_jobs(name, h, 12, 40)
    jobs2, _ = add_jobs(name, h, 10, 30, prefix="wave2")
    return h, jobs, jobs2


def _chain_key(name, pending):
    if name == "nomad_tpu":
        return (pending["used"], pending["node_version"], pending["npad"])
    return (pending["used"], pending["node_version"], pending["n"])


def test_zoned_waves_match_reference():
    runs = {}
    for name in PACKAGES:
        h, jobs, jobs2 = _zoned(name)
        pend1, d1 = run_batch_wave(name, h, make_evals(name, jobs))
        assert pend1["fills_full"] is not None       # compact kernel
        # wave 2 chains on wave 1's proposed usage
        pend2, d2 = run_batch_wave(name, h, make_evals(name, jobs2, "ev2"),
                                   used0_dev=_chain_key(name, pend1))
        assert pend2["chained"]
        runs[name] = (d1 + d2, alloc_map(h, jobs + jobs2))
    (d_r, m_r), (d_p, m_p) = runs["nomad_tpu"], runs["nomad_tpu_torch"]
    for a, b in zip(d_r, d_p):
        assert np.array_equal(a.picks, b.picks)
        assert [m.nodes_exhausted for m in a.metrics] == \
            [m.nodes_exhausted for m in b.metrics]
    assert len(m_r) == 12 * 40 + 10 * 30
    assert m_r == m_p


def test_flat_wave_matches_reference():
    runs = {}
    for name in PACKAGES:
        h = build_flat_cluster(name, n_nodes=150)
        jobs, _ = add_jobs(name, h, 8, 25, zones=0)
        pend, d = run_batch_wave(name, h, make_evals(name, jobs))
        assert pend["fills_full"] is None            # flat kernel
        runs[name] = (d, alloc_map(h, jobs))
    (d_r, m_r), (d_p, m_p) = runs["nomad_tpu"], runs["nomad_tpu_torch"]
    for a, b in zip(d_r, d_p):
        assert np.array_equal(a.picks, b.picks)
    assert len(m_r) == 8 * 25
    assert m_r == m_p

