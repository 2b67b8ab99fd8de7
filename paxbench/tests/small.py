"""Small copies of the benchmark's configurations, for tests on the CPU.

:func:`manifest` writes ``BENCHMARK.json`` with every configuration cut to
a size a test run holds (the general engine at 4096 instances, the fast
path at one 65536-instance tile) under a temporary directory and returns
its path; the cells, mixes and metrics are the benchmark's own.
"""

from __future__ import annotations

import json
import os

from paxbench import harness, yardstick

SIZES = {
    "multi5_2p26": {"n_instances": 4096, "assign_window": yardstick.assign_window(4096)},
    "multi5_fast_2p27": {"n_instances": 65536},
}


def manifest(tmp_dir) -> str:
    man = harness.load_json(harness.MANIFEST)
    for conf in man["configs"]:
        cfg = harness.load_json(os.path.join(harness.ROOT, conf["file"]))
        cfg.update(SIZES[conf["name"]])
        path = os.path.join(str(tmp_dir), f"{conf['name']}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        conf["file"] = path
    path = os.path.join(str(tmp_dir), "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(man, f)
    return path


def cells() -> list:
    return [w["name"] for w in harness.load_json(harness.MANIFEST)["workloads"]]
