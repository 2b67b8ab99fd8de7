"""``python -m tpu_paxos_torch trace`` and the port's Chrome-trace
exporter (tpu_paxos_torch/telemetry/export.py) against the JAX
package's: the trace JSON of both committed repro artifacts equals JAX's
``trace_artifact`` of the same path from the same directory, byte for
byte, and leaves the artifact untouched; a crafted run renders the same
events; ``--serve`` and sharded artifacts exit 2 by name, and malformed
or missing artifacts give JAX's exit-2 schema JSON."""

import contextlib
import hashlib
import io
import json
import os
import shutil
import types

import numpy as np
import pytest

from tpu_paxos.config import FaultConfig as JFC
from tpu_paxos.config import SimConfig as JSC
from tpu_paxos.core import faults as jflt
from tpu_paxos.fleet import envelope as jenv
from tpu_paxos.harness import shrink as jshr
from tpu_paxos.telemetry import export as jex
from tpu_paxos.telemetry import recorder as jrec
from tpu_paxos_torch import __main__ as tcli
from tpu_paxos_torch.config import FaultConfig as TFC
from tpu_paxos_torch.config import SimConfig as TSC
from tpu_paxos_torch.core import faults as tflt
from tpu_paxos_torch.fleet import envelope as tenv
from tpu_paxos_torch.telemetry import export as tex
from tpu_paxos_torch.telemetry import recorder as trec

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tpu_paxos_torch", "data")
#: the committed JAX-written artifacts, with the environment their shrink ran in
ARTIFACTS = {
    "repro_culprit.json": {},
    "repro_takeover.json": {"TPU_PAXOS_SEEDED_WEDGE": "takeover"},
}


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_trace_cli_equals_jax_trace_artifact(name, monkeypatch):
    monkeypatch.chdir(DATA)
    for k, v in sorted(ARTIFACTS[name].items()):
        monkeypatch.setenv(k, v)
    tenv.clear_cache()
    jenv.clear_cache()
    before = _sha(name)
    rc, out, _ = _cli(["trace", name, "--stdout", "--device", "cpu"])
    assert rc == 0
    want = json.dumps(jex.trace_artifact(name), indent=1, sort_keys=True) + "\n"
    assert out == want
    assert _sha(name) == before
    trace = json.loads(out)
    assert trace["otherData"]["artifact"] == name and trace["otherData"]["telemetry"]["windows"]
    tenv.clear_cache()
    jenv.clear_cache()


def test_trace_writes_the_file_beside_the_artifact(tmp_path):
    path = str(tmp_path / "a.json")
    shutil.copy(os.path.join(DATA, "repro_culprit.json"), path)
    rc, out, _ = _cli(["trace", path, "--json", "--device", "cpu"])
    assert rc == 0
    status = json.loads(out.strip().splitlines()[-1])
    assert status["ok"] and status["out"] == path + ".trace.json"
    with open(path + ".trace.json") as f:
        trace = json.load(f)
    assert status["events"] == len(trace["traceEvents"])
    assert status["decided"] == trace["otherData"]["decided"] > 0


@pytest.mark.parametrize("argv", [
    ["--serve"],
    ["--serve", "--values", "24", "--rate-milli", "16000", "--stdout"],
])
def test_trace_serve_exits_2_by_name(argv):
    rc, _, err = _cli(["trace"] + argv + ["--device", "cpu"])
    assert rc == 2 and "'trace --serve' is not ported yet" in err


def test_trace_of_a_sharded_artifact_exits_2_by_name(tmp_path):
    with open(os.path.join(DATA, "repro_culprit.json")) as f:
        art = json.load(f)
    art.update(engine="sharded", devices=2)
    path = str(tmp_path / "sharded.json")
    with open(path, "w") as f:
        json.dump(art, f)
    rc, _, err = _cli(["trace", path, "--stdout", "--device", "cpu"])
    assert rc == 2 and "engine 'sharded'" in err and "not ported yet" in err


@pytest.mark.parametrize("kind", ["missing", "truncated", "bad_field"])
def test_malformed_artifacts_give_jax_schema_json(kind, tmp_path):
    path = str(tmp_path / f"{kind}.json")
    if kind == "truncated":
        with open(path, "w") as f:
            f.write('{"format": ')
    elif kind == "bad_field":
        with open(os.path.join(DATA, "repro_culprit.json")) as f:
            art = json.load(f)
        art["cfg"]["n_nodes"] = "five"
        with open(path, "w") as f:
            json.dump(art, f)
    with pytest.raises(jshr.ArtifactSchemaError) as je:
        jshr.load_artifact(path)
    want = {"engine": "trace", "ok": False,
            "schema_error": {"field": je.value.field, "problem": je.value.problem}}
    rc, out, _ = _cli(["trace", path, "--json", "--device", "cpu"])
    assert rc == 2
    assert out == json.dumps(want, sort_keys=True) + "\n"


def _crafted(C, F, flt, rec, ex, **kw):
    sched = flt.FaultSchedule((
        flt.partition(2, 6, (0,)),
        flt.one_way(3, 7, (1,), (2,)),
        flt.pause(4, 8, 2),
        flt.burst(5, 9, 2000),
        flt.gray(1, 5, 1, delay=2),
        flt.crash(9, 2),
    ))
    cfg = C(n_nodes=3, proposers=(0, 1), n_instances=4,
            faults=F(max_delay=2, schedule=sched))
    result = types.SimpleNamespace(
        chosen_vid=np.asarray([100, -1, 200, 101], np.int32),
        chosen_round=np.asarray([5, -1, 5, 9], np.int32),
        chosen_ballot=np.asarray([1, -1, 2, 1], np.int32),
        rounds=11, done=True,
    )
    lat = np.zeros((rec.NUM_WINDOWS, rec.NUM_LAT_BUCKETS), np.int32)
    lat[0, 2] = 3
    w = rec.NUM_WINDOWS
    windows = rec.WindowSummary(
        offered=np.full(w, 9, np.int32), dropped=np.ones(w, np.int32),
        duped=np.zeros(w, np.int32), delayed=np.zeros(w, np.int32),
        stall_max=np.arange(w, dtype=np.int32), takeovers=np.zeros(w, np.int32),
        restarts=np.zeros(w, np.int32), cut=np.eye(w, dtype=np.int32)[1] * 4,
        backlog_max=np.full(w, 2, np.int32), node_offered=np.full((w, 3), 6, np.int32),
        node_delay=np.full((w, 3), 3, np.int32), decided=lat.sum(axis=1),
        lat_hist=lat, phase_hist=np.stack([lat] * rec.NUM_PHASES, axis=1),
    )
    off = np.zeros((8, 8), np.int32)
    off[:3, :3] = 5
    summary = rec.TelemetrySummary(
        msgs=np.arange(7, dtype=np.int32), offered=np.full(7, 10, np.int32),
        dropped=np.ones(7, np.int32), duped=np.zeros(7, np.int32), delayed=np.zeros(7, np.int32),
        learns=np.int32(9), commit_acks=np.int32(3), takeovers=np.int32(1),
        requeues=np.int32(0), restarts=np.int32(1), decided=np.int32(3),
        lat_hist=lat[0], lat_max=np.int32(4), heal_gap=np.int32(2), stall_max=np.int32(3),
        duel_max=np.int32(2), takeover_round=np.asarray([-1, 6], np.int32),
        rounds=np.int32(11), quiescent=np.bool_(True), region_offered=off,
        region_dropped=off // 5, region_cut=off // 5,
    )
    sd = rec.summary_to_dict(summary, windows, 16, ("us", "eu", "ap"))
    ledger = {
        "admit_round": np.asarray([1, -1, 2, 3], np.int32),
        "batch_round": np.asarray([1, -1, 2, 3], np.int32),
        "learned_round": np.asarray([6, -1, 7, -1], np.int32),
        "committed_round": np.asarray([7, -1, -1, 10], np.int32),
    }
    diagnosis = {"windows": [{"window": 0, "span": [0, 16], "cause": "partition",
                              "ambiguous": False, "candidates": [{"cause": "partition"}]}]}
    return ex.chrome_trace(cfg, result, sd, label="crafted", phase_ledger=ledger,
                           diagnosis=diagnosis, **kw)


@pytest.mark.parametrize("caps", [{}, {"max_decision_events": 1, "max_flow_instances": 2},
                                  {"max_decision_events": 0, "max_flow_instances": 0}])
def test_chrome_trace_of_a_crafted_run_equals_jax(caps):
    want = _crafted(JSC, JFC, jflt, jrec, jex, **caps)
    got = _crafted(TSC, TFC, tflt, trec, tex, **caps)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert any(e["ph"] == "X" and e["name"].startswith("gray") for e in got["traceEvents"])


def test_chrome_trace_without_a_recorder_equals_jax():
    result = types.SimpleNamespace(
        chosen_vid=np.asarray([100, 200, -1, 101], np.int32),
        chosen_round=np.asarray([5, 5, -1, 9], np.int32),
        chosen_ballot=np.asarray([1, 2, -1, 1], np.int32), rounds=11, done=True,
    )
    want = jex.chrome_trace(JSC(n_nodes=3, proposers=(0, 1), n_instances=4, faults=JFC(
        schedule=jflt.FaultSchedule((jflt.pause(4, 8, 2),)))), result, None)
    got = tex.chrome_trace(TSC(n_nodes=3, proposers=(0, 1), n_instances=4, faults=TFC(
        schedule=tflt.FaultSchedule((tflt.pause(4, 8, 2),)))), result, None)
    assert got == want and "telemetry" not in got["otherData"]
