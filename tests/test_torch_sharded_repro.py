"""Repro artifacts of the port's sharded engine against the JAX package's,
on the CPU under the conftest's 8 virtual JAX devices: a failing sharded
case saves as ``engine="sharded"`` with its device count, in JAX's bytes;
it replays through ``parallel/sharded_sim.py`` on a mesh of the recorded
rank count; the committed JAX-written artifact at 8 devices replays to
JAX's ``repro --json`` stdout.  Mirrors ``tests/test_sharded_repro.py``."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_paxos.analysis.artifact_schema import ArtifactSchemaError as JSchemaError
from tpu_paxos.harness import shrink as jshr
from tpu_paxos_torch import __main__ as tcli
from tpu_paxos_torch.analysis.artifact_schema import ArtifactSchemaError
from tpu_paxos_torch.harness import shrink as tshr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tpu_paxos_torch", "data")
DEVICES = 2  # ranks of the port's mesh; of the conftest's 8 devices for JAX


def _golden_script():
    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(ROOT, "scripts", "torch_port_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_script = _golden_script()


def _cases(extra, devices=DEVICES):
    out = []
    for port in (False, True):
        case = _script.sharded_repro_case(_script.sharded_modules(port=port), devices)
        out.append(dataclasses.replace(case, extra_checks=extra))
    return out


def _goldens():
    with open(os.path.join(DATA, "goldens.json")) as f:
        return json.load(f)


def test_sharded_artifact_roundtrip_and_reproduce(tmp_path):
    jcase, tcase = _cases({"decision_round_max": 25})
    _, jviol = jshr.run_case(jcase)
    _, viol = tshr.run_case(tcase, device="cpu")
    assert viol == jviol and "decision_round_max" in viol
    path, jpath = str(tmp_path / "repro_sharded.json"), str(tmp_path / "jax.json")
    art = tshr.save_artifact(path, tcase, viol, device="cpu")
    jshr.save_artifact(jpath, jcase, jviol)
    assert art["engine"] == "sharded" and art["devices"] == DEVICES
    assert open(path, "rb").read() == open(jpath, "rb").read()
    loaded, _ = tshr.load_artifact(path)
    assert loaded.engine == "sharded" and loaded.devices == DEVICES
    rep = tshr.reproduce(path, device="cpu")
    assert rep["match"], rep
    # schema: the engine selector and the device count, as JAX names them
    bad_art = json.loads(open(path).read())
    bad = tmp_path / "bad.json"
    for field, value in (("engine", "warp-drive"), ("devices", 0)):
        bad_art.update(engine="sharded", devices=DEVICES)
        bad_art[field] = value
        bad.write_text(json.dumps(bad_art))
        with pytest.raises(ArtifactSchemaError, match=field) as te:
            tshr.load_artifact(str(bad))
        with pytest.raises(JSchemaError) as je:
            jshr.load_artifact(str(bad))
        assert str(te.value) == str(je.value)


def test_committed_sharded_artifact_replays_as_jax(monkeypatch, capsys):
    """The committed JAX-written artifact at 8 devices: ``repro --json``
    on an 8-rank mesh prints JAX's stdout (run in the artifact's
    directory: the summary names the path as given) with ``match``."""
    gold = _goldens()["sharded_repro"]
    monkeypatch.setenv("TPU_PAXOS_DETERMINISTIC", "1")
    monkeypatch.chdir(DATA)
    assert _script._file_sha256(gold["artifact"]) == gold["artifact_sha256"]
    assert tcli.main(["repro", gold["artifact"], "--json", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out == gold["stdout"]
    assert json.loads(out.splitlines()[-1])["match"] is True


@pytest.mark.slow
def test_sharded_and_unsharded_runs_differ_only_in_placement():
    """The sharded log differs from the unsharded one (shard-local
    placement), which is why the artifact records its engine; the chosen
    multiset does not, and both are green."""
    _, tcase = _cases({})
    r_sh, v_sh = tshr.run_case(tcase, device="cpu")
    r_un, v_un = tshr.run_case(tshr.ReproCase(cfg=tcase.cfg, workload=tcase.workload, gates=None,
                                              chains=tcase.chains), device="cpu")
    assert v_sh is None and v_un is None
    chosen_sh = np.sort(r_sh.chosen_vid[r_sh.chosen_vid >= 0])
    chosen_un = np.sort(r_un.chosen_vid[r_un.chosen_vid >= 0])
    assert (chosen_sh == chosen_un).all()
    jr, _ = jshr.run_case(_cases({})[0])
    assert np.array_equal(jr.chosen_vid, r_sh.chosen_vid)


@pytest.mark.slow
def test_sharded_artifact_cli_repro(tmp_path):
    """End to end in fresh processes: ``python -m tpu_paxos_torch repro``
    replays on a mesh of the recorded rank count, with the JAX CLI's
    stdout."""
    jcase, tcase = _cases({"decision_round_max": 25})
    _, viol = tshr.run_case(tcase, device="cpu")
    path = str(tmp_path / "repro_sharded.json")
    tshr.save_artifact(path, tcase, viol, device="cpu")
    env = dict(os.environ, JAX_PLATFORMS="cpu", TPU_PAXOS_DETERMINISTIC="1",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    outs = []
    for argv in ([sys.executable, "-m", "tpu_paxos", "repro", path, "--json", "--backend", "cpu"],
                 [sys.executable, "-m", "tpu_paxos_torch", "repro", path, "--json", "--device", "cpu"]):
        proc = subprocess.run(argv, capture_output=True, text=True, timeout=560, env=env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout)
    assert outs[1] == outs[0]
    out = json.loads(outs[1].strip().splitlines()[-1])
    assert out["ok"] and out["match"], out
