"""The plain reference accepts the program's outputs at small sizes and
rejects planted faults (CPU); the card test runs every cell on the card
at small sizes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paxbench import faults, harness, yardstick
from paxbench.reference import sim_guarantees
from paxbench.tests import small
from tpu_paxos_torch.config import FaultConfig, SimConfig
from tpu_paxos_torch.core import sim

I = 4096
MIXES = {
    "debugconf": ((0, 1), FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2)),
    "reliable": ((0,), FaultConfig()),
}


def _run(mix: str, seed: int):
    props, fc = MIXES[mix]
    wl = yardstick.default_workload(I, len(props))
    cfg = SimConfig(n_nodes=5, n_instances=I, proposers=props, seed=seed,
                    assign_window=yardstick.assign_window(I), max_rounds=20_000, faults=fc)
    return sim.run(cfg, wl, device="cpu"), wl, props


def _check(res, wl, props, learned=None, chosen=None, done=None):
    return sim_guarantees.check_run(
        res.learned if learned is None else learned,
        res.chosen_vid if chosen is None else chosen,
        res.done if done is None else done, wl, props, I)


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim_reference_accepts_the_port(mix, seed):
    res, wl, props = _run(mix, seed)
    assert _check(res, wl, props) == dict.fromkeys(sim_guarantees.GUARANTEES, 0)


@pytest.fixture(scope="module")
def run0():
    return _run("debugconf", 0)


def test_sim_reference_rejects_a_node_learning_another_value(run0):
    res, wl, props = run0
    learned = res.learned.copy()
    learned[7, 2] = res.chosen_vid[9]
    got = _check(res, wl, props, learned=learned)
    assert got["agreement"] == 1


def test_sim_reference_rejects_a_value_chosen_twice(run0):
    res, wl, props = run0
    chosen = res.chosen_vid.copy()
    chosen[5] = chosen[6]
    learned = np.repeat(chosen[:, None], res.learned.shape[1], axis=1)
    got = _check(res, wl, props, learned=learned, chosen=chosen)
    assert got["duplicates"] == 1 and got["missing"] == 1


def test_sim_reference_rejects_a_missing_value_in_a_done_run(run0):
    res, wl, props = run0
    chosen = res.chosen_vid.copy()
    top = int(np.flatnonzero(chosen != -1)[-1])
    chosen[top] = -1
    learned = np.repeat(chosen[:, None], res.learned.shape[1], axis=1)
    got = _check(res, wl, props, learned=learned, chosen=chosen, done=True)
    assert got["missing"] == 1


def test_sim_reference_rejects_a_foreign_value_a_hole_and_an_unfinished_run(run0):
    res, wl, props = run0
    chosen = res.chosen_vid.copy()
    chosen[3] = 1 << 28  # no proposer was given it
    chosen[4] = -1  # a hole below the top
    chosen[5] = -(2 + 1 * I + 6)  # a no-op filled for another instance
    learned = np.repeat(chosen[:, None], res.learned.shape[1], axis=1)
    got = _check(res, wl, props, learned=learned, chosen=chosen, done=False)
    assert got["validity"] == 2 and got["holes"] == 1 and got["not_done"] == 1


@pytest.mark.parametrize("cell", ["fast_steady_2p27", "fast_takeover_2p27"])
def test_fast_reference_accepts_the_port(cell, tmp_path):
    out = harness.run_cell(cell, 2**32 + 5, 0.3, False, device="cpu",
                           manifest_path=small.manifest(tmp_path))
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("cell", ["fast_steady_2p27", "fast_takeover_2p27"])
def test_fast_reference_rejects_vids_shifted_by_one(cell, tmp_path):
    kind = harness.cell_kind(cell)
    out = harness.run_cell(cell, 11, 0.3, False, device="cpu",
                           manifest_path=small.manifest(tmp_path),
                           fault=lambda: faults.plant(kind, "answer_altered"))
    assert not out["correct"]
    name = "cell_mismatch" if cell == "fast_steady_2p27" else "sampled_cell_mismatch"
    assert out["checks"][name]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", small.cells())
def test_cells_on_the_card_at_small_sizes(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    path = small.manifest(tmp_path)
    out = harness.run_cell(cell, 2**31 + 77, 1.0, False, manifest_path=path)
    assert out["correct"], out["checks"]
    kind = harness.cell_kind(cell)
    out = harness.run_cell(cell, 2**31 + 78, 1.0, False, manifest_path=path,
                           fault=lambda: faults.plant(kind, "answer_altered"))
    assert not out["correct"]
