"""The benchmark's frozen copies equal the program's functions they were
copied from, at small sizes (CPU)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paxbench import trace, yardstick
from tpu_paxos_torch.config import SimConfig
from tpu_paxos_torch.core import ballot, fastwin, sim, simkern


@pytest.mark.parametrize("n_instances", [1, 100, 1023, 4096, 1 << 16])
@pytest.mark.parametrize("n_proposers", [1, 2, 3])
def test_default_workload_equals_port(n_instances, n_proposers):
    cfg = SimConfig(n_nodes=5, n_instances=n_instances, proposers=tuple(range(n_proposers)))
    ours = yardstick.default_workload(n_instances, n_proposers)
    theirs = sim.default_workload(cfg)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n_instances,window", [
    (1024, 256), (4096, 512), (1 << 23, 1 << 20), (1 << 26, 1 << 20), (100, 256)])
def test_assign_window_is_the_bench_rule(n_instances, window):
    # bench.py's bench_sim_record: max(256, min(1 << 20, i // 8))
    assert yardstick.assign_window(n_instances) == window


def test_bump_past_equals_port():
    rng = np.random.default_rng(3)
    for _ in range(500):
        count = int(rng.integers(0, 100))
        node = int(rng.integers(0, 7))
        max_seen = int(rng.integers(-1, 200 << 16))
        _, b = ballot.bump_past(torch.tensor(count, dtype=torch.int32),
                                torch.tensor(node, dtype=torch.int32),
                                torch.tensor(max_seen, dtype=torch.int32))
        assert yardstick.bump_past(count, node, max_seen) == int(b)


@pytest.mark.parametrize("a,i", [(3, 65536), (5, 1 << 27), (7, 1000)])
@pytest.mark.parametrize("iota", [True, False])
def test_fastwin_bytes_equal_port(a, i, iota):
    assert yardstick.fastwin_bytes_per_launch(a, i, iota) == fastwin.bytes_per_launch(a, i, iota)


def test_takeover_bytes_are_104_an_instance_at_five_nodes():
    assert yardstick.takeover_bytes(5, 1 << 27) == 104 * (1 << 27)


def _store_operands(rng, a, p, i):
    acc_ballot = np.where(rng.random((a, i)) < 0.3, rng.integers(1, 4, (a, i)) << 16, -1)
    acc_vid = np.where(acc_ballot != -1, rng.integers(0, 1 << 20, (a, i)), -1)
    learned = np.where(rng.random((a, i)) < 0.2, rng.integers(0, 1 << 20, (a, i)), -1)
    abat = np.where(rng.random((p, i)) < 0.5, rng.integers(0, 1 << 20, (p, i)), -1)
    abal = ((np.arange(p) + 2) << 16).astype(np.int32)
    elig = rng.random((p, a)) < 0.6
    t = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
         for x in (acc_ballot, acc_vid, learned, abat)]
    return (*t, torch.from_numpy(abal), torch.from_numpy(elig))


def _ack_operands(rng, a, p, i):
    acc_ballot, acc_vid, learned, cur_batch, ballot, amatch = _store_operands(rng, a, p, i)
    acks = torch.from_numpy((rng.random((p, a, i)) < 0.3).astype(np.int8))
    return acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("a,p,i", [(5, 2, 4096), (3, 1, 1000), (7, 3, 777)])
def test_simkern_bytes_needed_equal_port(seed, a, p, i):
    rng = np.random.default_rng(seed)
    ops = _store_operands(rng, a, p, i)
    assert (yardstick.simkern_bytes_needed("store_accepts", *ops)
            == simkern.bytes_needed("store_accepts", *ops))
    ops = _ack_operands(rng, a, p, i)
    assert (yardstick.simkern_bytes_needed("accum_acks", *ops)
            == simkern.bytes_needed("accum_acks", *ops))


def test_trace_sums_device_events_and_splits_gaps_over_the_innermost_blocks():
    dev = [(0, 10, "k1"), (20, 25, "k2"), (25, 40, "k1"), (100, 110, "copy")]
    ranges = [(0, 200, "outer"), (12, 30, "inner"), (50, 60, "other")]
    got = trace.summarize_events(dev, ranges, window_s=2e-4)
    # disjoint device events: the union is the profile script's plain sum
    assert got["busy_s"] == pytest.approx(sum(e - s for s, e, _ in dev) * 1e-6)
    assert got["ops"]["k1"] == [2, pytest.approx(25e-6)]
    # gap 10-20: outer 10-12, inner 12-20; gap 40-100: outer but other's 50-60
    assert got["gaps"] == {"outer": pytest.approx(52e-6), "inner": pytest.approx(8e-6),
                           "other": pytest.approx(10e-6)}


def test_trace_gap_outside_every_range_and_a_union_never_counts_twice():
    got = trace.summarize_events([(0, 10, "a"), (5, 12, "b"), (20, 30, "c")],
                                 [(14, 16, "x")], 1.0)
    assert got["busy_s"] == pytest.approx(22e-6)
    assert got["gaps"] == {trace.OUTSIDE: pytest.approx(6e-6), "x": pytest.approx(2e-6)}
