"""A later change adds a configuration, a mix, a cell and a per-layer
metric as new files and manifest entries only: in a temporary copy of
the benchmark, the harness finds and runs them, and no file the
benchmark had is edited."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from paxbench import harness


def _digests(top: str) -> dict:
    out = {}
    for base, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, top)] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_new_config_mix_cell_and_metric_need_no_edit(tmp_path):
    copy = tmp_path / "tree"
    shutil.copytree(os.path.join(harness.ROOT, "paxbench"), copy / "paxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.MANIFEST, copy / "BENCHMARK.json")
    os.symlink(os.path.join(harness.ROOT, "tpu_paxos_torch"), copy / "tpu_paxos_torch")
    before = _digests(str(copy / "paxbench"))

    (copy / "paxbench" / "configs" / "multi3_tiny.json").write_text(json.dumps(
        {"name": "multi3_tiny", "n_nodes": 3, "n_instances": 1024, "assign_window": 256,
         "max_rounds": 20000, "reduced": ["n_instances"]}))
    (copy / "paxbench" / "traffic" / "lossy_solo.json").write_text(json.dumps(
        {"kind": "sim_runs", "proposers": [1], "drop_rate": 2000, "dup_rate": 0,
         "min_delay": 0, "max_delay": 1}))
    (copy / "paxbench" / "metrics" / "runs_in_window.tiny.py").write_text(
        '"""Runs the window held."""\n\n\ndef read(r):\n    return len(r.steps)\n')
    man = json.loads((copy / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "multi3_tiny", "source": "a test", "reduced": ["n_instances"],
                           "file": "paxbench/configs/multi3_tiny.json", "why": "a test"})
    man["workloads"].append({"name": "tiny_lossy", "config": "multi3_tiny",
                             "traffic": "lossy_solo", "chips": 1, "why": "a test"})
    man["end_to_end"][0]["workloads"].append("tiny_lossy")
    man["per_layer"].append({"name": "runs_in_window.tiny", "unit": "count", "better": "higher",
                             "source": "host_clock", "layer": "run loop",
                             "moves": "sim_values_per_s", "workloads": ["tiny_lossy"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(man))

    code = """
import json
from paxbench import harness
outs = [harness.run_cell("tiny_lossy", 9, 0.3, t, device="cpu") for t in (False, True)]
print(json.dumps(outs))
"""
    got = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True,
                         text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    plain, traced = json.loads(got.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"sim_values_per_s", "setup_s"}
    assert traced["metrics"]["runs_in_window.tiny"]["value"] >= 1
    after = _digests(str(copy / "paxbench"))
    assert {k: after[k] for k in before} == before
