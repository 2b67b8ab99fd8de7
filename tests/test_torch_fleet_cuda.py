"""The fleet runner's 2048-lane timing dispatch on a card (cut from
``chip_smoke.py``'s phase 9 to make room for phase 19): the
headline knob cycle at ``bench.py``'s fleet configuration over 2048 lanes,
its lanes/s, ms and host syncs a round printed, and 8 of its lanes that
decide within 400 rounds re-run as single ``sim.run(lane_cfg(i))`` on the
card, each equal to its fleet lane exactly.

This test needs a CUDA card and skips without one.  The file imports
neither ``jax`` nor ``tpu_paxos``, so run it there without the suite's
conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_fleet_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from tpu_paxos_torch import config as cfgm
from tpu_paxos_torch.core import sim
from tpu_paxos_torch.fleet import runner as frun
from tpu_paxos_torch.fleet import search
from tpu_paxos_torch.harness import stress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")
FLEET_WIDE = 2048  # lanes of the timing-only dispatch
FLEET_SINGLES = 8  # lanes of it re-run as single runs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the simkern kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fleet_2048_lanes_and_single_reruns_on_the_card(card):
    with open(GOLDENS) as f:
        gold = json.load(f)["fleet"]
    c = gold["config"]
    wl, gates, _ = stress._workload(2, np.random.default_rng(0))
    cfg = cfgm.SimConfig(
        n_nodes=c["n_nodes"], n_instances=c["n_instances"], proposers=tuple(c["proposers"]),
        seed=c["seed"], max_rounds=c["max_rounds"], faults=cfgm.FaultConfig(**c["faults"]),
    )
    rng = np.random.default_rng(1)  # phase 9's draws: its 128 lanes are the first
    scheds = [search.sample_schedule(rng, 5, 4, 96) for _ in range(FLEET_WIDE)]
    mixes = gold["headline"]["knob_mixes"]
    seeds = [gold["headline"]["first_seed"] + i for i in range(FLEET_WIDE)]
    knobs = [cfgm.FaultConfig(**mixes[i % len(mixes)]) for i in range(FLEET_WIDE)]
    runner = frun.FleetRunner(cfg, wl, gates, device=card)
    runner.run(seeds[:8], scheds[:8], knobs=knobs[:8])  # first launches outside the timing
    chip_smoke.DEV = str(card)
    torch.cuda.synchronize()
    it = {}
    # the syncs are counted in the timed run itself: the warnings cost
    # about 10 us each, under 0.5% of its wall
    syncs = chip_smoke.count_syncs(lambda: it.setdefault("rep", runner.run(seeds, scheds, knobs=knobs)))
    rep = it["rep"]
    v = rep.verdict
    print(f"fleet [headline] {FLEET_WIDE} lanes: lanes_per_sec={rep.lanes_per_sec:.2f} "
          f"seconds={rep.seconds:.3f} rounds_max={int(v.rounds.max())} iterations={rep.iterations} "
          f"ms_per_round={rep.seconds / rep.iterations * 1e3:.3f} "
          f"syncs_per_round={syncs / rep.iterations:.2f} ok={int(v.ok.sum())}/{FLEET_WIDE} | "
          f"{chip_smoke._card_line()}")
    # the first 128 lanes are phase 9's, whose decision logs are JAX's
    assert [chip_smoke._lane_sha(rep, i, gold["stride"]) for i in range(c["lanes"])] == \
        gold["headline"]["decision_log_sha256"]
    done = rep.final.done.cpu().numpy()
    cand = [i for i in range(FLEET_WIDE) if done[i] and v.rounds[i] <= 400]
    picks = [cand[k * len(cand) // FLEET_SINGLES] for k in range(FLEET_SINGLES)]
    for i in picks:
        single = sim.run(rep.lane_cfg(i), wl, gates, device=card)
        assert chip_smoke._same_result(rep.lane_result(i), single), f"lane {i}"
