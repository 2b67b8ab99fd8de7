"""The harness's comparison calls a run not correct when the timed path is
broken underneath: every fault of ``faults.py`` in every cell, driven
through the whole run at small sizes on the CPU (the look for a card
skipped).  ``answer_altered`` is the control that the card's runs of the
cells at their own sizes read too."""

from __future__ import annotations

import os

import pytest

from paxbench import faults, harness
from paxbench.tests import small


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("cell", small.cells())
def test_fault_makes_the_run_not_correct(cell, fault, tmp_path):
    kind = harness.cell_kind(cell)
    out = harness.run_cell(cell, 2**33 + 1, 0.3, False, device="cpu",
                           manifest_path=small.manifest(tmp_path), grace_s=2.0,
                           fault=lambda: faults.plant(kind, fault))
    assert not out["correct"]
    assert out["failed"] >= 1


def _window_cells() -> list:
    """The cells whose fast-path step runs windows."""
    man = harness.load_json(harness.MANIFEST)
    return [w["name"] for w in man["workloads"]
            if harness.load_json(os.path.join(harness.HERE, "traffic", f"{w['traffic']}.json"))
            .get("step") == "windows"]


@pytest.mark.parametrize("cell", _window_cells())
def test_a_stale_window_shows_in_the_window_probe_alone(cell, tmp_path):
    """Every window given the last window's vids leaves the counts and the
    final state as a sound step's: only the probe of each window sees it."""
    out = harness.run_cell(cell, 2**33 + 3, 0.3, False, device="cpu",
                           manifest_path=small.manifest(tmp_path), grace_s=2.0,
                           fault=lambda: faults.plant("fast_steps", "stale_window_vids"))
    checks = {name: c["value"] for name, c in out["checks"].items()}
    assert not out["correct"]
    assert checks["window_mismatch"] > 0
    assert checks["count_mismatch"] == 0 and checks["cell_mismatch"] == 0
