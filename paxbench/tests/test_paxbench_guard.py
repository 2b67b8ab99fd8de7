"""What the harness loads: never ``jax``, ``jaxlib``, ``flax`` or the JAX
package (top-level names compared whole: ``tpu_paxos_torch`` begins with
``tpu_paxos``), and the reference loads nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import pytest

from paxbench import harness
from paxbench.tests import small

ROOT = harness.ROOT

BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.partition(".")[0] in ("jax", "jaxlib", "flax", "tpu_paxos"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def _fresh(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", BLOCKER + code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_cell_loads_neither_jax_nor_the_jax_package(tmp_path):
    path = small.manifest(tmp_path)
    loaded = _fresh(f"""
import json
from paxbench import harness
for cell in {small.cells()!r}:
    for trace in (False, True):
        out = harness.run_cell(cell, 12345, 0.2, trace, device="cpu", manifest_path={path!r})
        assert out["correct"], (cell, trace, out["checks"])
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
""")
    assert not set(loaded) & set(harness.FORBIDDEN)
    assert "tpu_paxos_torch" in loaded and "paxbench" in loaded


def test_the_reference_loads_nothing_of_the_program():
    loaded = _fresh("""
import json
import paxbench.reference.sim_guarantees, paxbench.reference.fast_reference
import paxbench.yardstick
print(json.dumps(sorted({m.partition(".")[0] for m in sys.modules})))
""")
    assert "tpu_paxos_torch" not in loaded
    assert not set(loaded) & set(harness.FORBIDDEN)


def test_a_loaded_jax_package_gives_no_result(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_paxos", types.ModuleType("tpu_paxos"))
    with pytest.raises(harness.NoResult, match="tpu_paxos"):
        harness.run_cell("fast_steady_2p27", 1, 0.1, False, device="cpu",
                         manifest_path=small.manifest(tmp_path))


def test_the_command_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, also on a card's host
    out = subprocess.run([sys.executable, "-m", "paxbench.run", "--workload",
                          "fast_steady_2p27", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_in_a_tree_without_the_program_prints_no_result(tmp_path):
    os.symlink(os.path.join(ROOT, "paxbench"), tmp_path / "paxbench")
    os.symlink(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "paxbench.run", "--workload",
                          "fast_steady_2p27", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
