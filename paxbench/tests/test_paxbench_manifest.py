"""``BENCHMARK.json`` keeps to the benchmark's contract as far as a file
can show it: its keys and names, and a file of its own for every
configuration, mix and metric."""

from __future__ import annotations

import json
import os
import re

import pytest

from paxbench import harness

MAN = harness.load_json(harness.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"][:2] == ["python3", "-m"] and len(MAN["command"]) <= 32
    assert MAN["paths"] == ["paxbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert os.path.getsize(harness.MANIFEST) <= 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("paxbench/") and os.path.exists(
            os.path.join(harness.ROOT, c["file"]))
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] and not any(WIDTH.search(k) for k in c["reduced"])
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["config"] in names
        assert os.path.exists(os.path.join(harness.HERE, "traffic", f"{w['traffic']}.json"))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(harness.HERE, "metrics", f"{m['name']}.py"))
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    every = [x["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MAN[sec]]
    assert len(every) == len(set(every)) and all(NAME.match(n) for n in every)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric(cell):
    e2e = {m["name"] for m in harness.metrics_for(MAN, "end_to_end", cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_for(MAN, "per_layer", cell)


def test_every_mix_names_a_kind_with_a_driver():
    for w in MAN["workloads"]:
        mix = harness.load_json(os.path.join(harness.HERE, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(harness.HERE, "traffic", f"{mix['kind']}.py"))


def test_the_manifest_is_plain_json_on_disk():
    with open(harness.MANIFEST) as f:
        assert json.load(f) == MAN
