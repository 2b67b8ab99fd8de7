"""The admission controller on a card: a controlled run and a controlled
fleet that shed, with both ``simkern`` kernels launching, equal the same
runs on the CPU: the device shed counter, the decisions, the shed
records and the combined decision-log sha256.

These tests need a CUDA card and skip without one.  The file imports
neither ``jax`` nor ``tpu_paxos`` (the card's machine has neither), so
run it there without the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_control_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch.core import simkern as tsk
from tpu_paxos_torch.serve import arrivals as tarr
from tpu_paxos_torch.serve import control as tctl
from tpu_paxos_torch.serve import fleet as tfl
from tpu_paxos_torch.serve import harness as th


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the simkern kernels have no CPU mode")
    return torch.device("cuda")


def _spike(n, seed):
    rounds = tarr.spike_rounds(n, 2000, seed, factor=4, start_frac=0.25, len_frac=0.5)
    return tarr.split_round_robin(np.arange(n, dtype=np.int32), rounds, 2)


def _cfg(n_instances):
    return tcfg.SimConfig(n_nodes=3, n_instances=n_instances, proposers=(0, 1), seed=3,
                          max_rounds=8000, assign_window=8)


_SLO = th.ServeSLO(latency_rounds=16, budget_milli=150)


def _single(device):
    streams, arrs = _spike(1000, 0)
    return tctl.controlled_serve_run(
        _cfg(2048), streams, arrs, priorities=[tarr.tier_priorities(s) for s in streams],
        control=tctl.ControlPolicy(n_tiers=3, defer_tier=1, shed_tier=2, ladder=(1, 2)),
        slo=_SLO, rounds_per_window=4, window_rounds=32, keep_state=True, device=device)


@pytest.mark.cuda
def test_controlled_run_on_card_equals_cpu(card):
    want = _single("cpu")
    tsk.reset_counts()
    got = _single(card)
    assert min(tsk.LAUNCHES.values()) >= 1
    assert got.shed_count == want.shed_count > 0
    assert got.decisions == want.decisions and got.sheds == want.sheds
    assert got.decision_log_sha256 == want.decision_log_sha256
    assert got.final_state.ctl.cpu().tolist() == want.final_state.ctl.tolist()
    assert got.summary == want.summary and got.slo == want.slo


def _fleet(device):
    lanes = [tfl.ServeLane(*_spike(400, a), seed) for seed, a in ((3, 0), (4, 1))]
    return tctl.controlled_fleet_run(
        _cfg(1024), lanes, control=tctl.ControlPolicy(n_tiers=3, defer_tier=1, shed_tier=2),
        slo=_SLO, rounds_per_window=4, windows_per_dispatch=2, window_rounds=32, device=device)


@pytest.mark.cuda
def test_controlled_fleet_on_card_equals_cpu(card):
    want = _fleet("cpu")
    tsk.reset_counts()
    got = _fleet(card)
    assert min(tsk.LAUNCHES.values()) >= 1
    assert got.lane_shed == want.lane_shed and got.shed_total > 0
    assert got.decisions == want.decisions and got.sheds == want.sheds
    assert got.final.ctl.cpu().tolist() == want.final.ctl.tolist()
    assert got.breach.tolist() == want.breach.tolist() and got.slo == want.slo
    for i in range(got.n_lanes):
        for g, w in zip(got.lane_chosen(i), want.lane_chosen(i)):
            np.testing.assert_array_equal(g, w)
