"""The port's CLI (``python -m tpu_paxos_torch``, general engine and fast
path) against the JAX CLI, the port's import boundary (no ``jax``, no
``tpu_paxos``), and the committed JAX goldens that ``chip_smoke.py``
holds the card run to."""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_paxos_torch import __main__ as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")
DEBUG_ARGS = ["4", "4", "10", "--seed=0", "--net-drop-rate=500",
              "--net-dup-rate=1000", "--net-max-delay=2"]


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    return env


def _python(*args, timeout=240):
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, env=_env(), capture_output=True,
        text=True, timeout=timeout,
    )


def _goldens():
    with open(GOLDENS) as f:
        return json.load(f)


def test_cli_stdout_is_byte_identical_to_the_jax_cli():
    jax_run = _python("-m", "tpu_paxos", *DEBUG_ARGS, "--backend", "cpu")
    port_run = _python("-m", "tpu_paxos_torch", *DEBUG_ARGS, "--device", "cpu")
    assert jax_run.returncode == 0, jax_run.stderr
    assert port_run.returncode == 0, port_run.stderr
    assert port_run.stdout == jax_run.stdout
    assert "ALL INVARIANTS GREEN" in port_run.stdout.splitlines()[-1]
    # the decision log (all but the verdict line) is the committed golden
    log = "".join(port_run.stdout.splitlines(keepends=True)[:-1])
    gold = _goldens()["cli_4_4_10"]
    assert hashlib.sha256(log.encode()).hexdigest() == gold["decision_log_sha256"]


def test_cli_json_summary_equals_the_jax_cli(capsys):
    """A crash loses the crashed proposer's queued value, so both CLIs
    must report the same failed verdict and exit 1."""
    from tpu_paxos import __main__ as jcli

    argv = ["3", "2", "6", "--seed=4", "--net-drop-rate=900",
            "--crash-rate=20000", "--net-max-delay=1", "--json"]
    assert jcli.main(argv) == tcli.main(argv + ["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:]
    summary = json.loads(out.splitlines()[-1])
    assert (summary["ok"], summary["crashed"], summary["done"]) == (False, 1, True)


@pytest.mark.parametrize("args", [["4", "4", "10"], ["5", "4", "10"]])
@pytest.mark.parametrize("as_json", [False, True])
def test_fast_engine_equals_the_jax_cli(args, as_json, tmp_path, capsys):
    """``--engine=fast``: the same stdout (verdict line or ``--json``
    summary) and the same ``--save-state`` arrays as the JAX CLI."""
    from tpu_paxos import __main__ as jcli

    argv = args + ["--engine=fast"] + (["--json"] if as_json else [])
    assert jcli.main(argv + ["--save-state", str(tmp_path / "j.npz")]) == 0
    jax_out = capsys.readouterr().out
    assert tcli.main(argv + ["--save-state", str(tmp_path / "t.npz"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == jax_out
    with np.load(tmp_path / "j.npz") as want, np.load(tmp_path / "t.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_fast_cli_at_2p23_prints_the_committed_golden(capsys):
    """The full-size fast CLI run that the card repeats: the port on the
    CPU prints the JAX CLI's committed stdout."""
    gold = _goldens()["fast_cli_2p23"]
    assert tcli.main(gold["args"] + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == gold["stdout"]


@pytest.mark.parametrize("argv,what", [
    (["4", "4", "10", "--engine=fast", "--mesh", "2"], "--engine=fast"),
    (["4", "4", "10", "--engine=member"], "--engine=member"),
    (["4", "4", "10", "--mesh", "2"], "--mesh"),
    # trace is ported; its serve mode is not (kept under the case's id)
    pytest.param(["trace", "--serve"], "'trace --serve'", id="argv3-'trace'"),
    # fleet is ported; lint is not (kept under the case's id)
    pytest.param(["lint"], "'lint'", id="argv4-'fleet'"),
    (["serve", "--values", "8"], "'serve'"),
    (["evolve"], "'evolve'"),
    (["mc", "--scope", "quick"], "'mc'"),
])
def test_unported_cli_surfaces_exit_2(argv, what, capsys):
    assert tcli.main(argv + ["--device", "cpu"]) == 2
    assert f"{what} is not ported yet" in capsys.readouterr().err


def test_repro_is_ported(tmp_path, capsys):
    """``repro`` is no longer a refused subcommand: a missing artifact is
    the schema surface's exit 2 (a JSON summary naming the problem), not
    'not ported'."""
    path = str(tmp_path / "missing.json")
    assert tcli.main(["repro", path, "--json", "--device", "cpu"]) == 2
    out = capsys.readouterr()
    assert "not ported" not in out.err
    assert "unreadable artifact" in json.loads(out.out)["schema_error"]["problem"]


@pytest.mark.parametrize("flag", ["--fleet", "--sharded"])
def test_stress_cli_unported_sweeps_exit_2(flag, capsys):
    """``--sharded`` exits 2 by name; ``--fleet`` is ported, and with
    ``--sharded`` beside it the sharded sweep still refuses before any
    sweep runs."""
    from tpu_paxos_torch.harness import stress

    extra = ["--sharded"] if flag == "--fleet" else []
    assert stress.main(["--seeds", "1", flag, *extra, "--device", "cpu"]) == 2
    out = capsys.readouterr()
    assert "--sharded is not ported yet" in out.err and out.out == ""


_BLOCKED_IMPORT_PROBE = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_paxos"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import tpu_paxos_torch
mods = [m.name for m in pkgutil.walk_packages(tpu_paxos_torch.__path__, "tpu_paxos_torch.")]
for m in mods:
    importlib.import_module(m)
import torch
from tpu_paxos_torch import config
from tpu_paxos_torch.core import fast, fastwin, faults, sim
res = sim.run(config.SimConfig(n_nodes=3, n_instances=16, proposers=(0, 1)), device="cpu")
sched = faults.FaultSchedule((faults.partition(1, 5, (0,), (1, 2)), faults.gray(2, 6, 1, delay=1)))
res2 = sim.run(config.SimConfig(n_nodes=3, n_instances=16, proposers=(0, 1),
               faults=config.FaultConfig(max_delay=1, schedule=sched)), device="cpu")
st, n = fast.choose_all(fast.init_state(16, 3, device="cpu"),
                        torch.arange(16, dtype=torch.int32), proposer=0, quorum=2)
_, counts = fastwin.steady_state_windows_fused(
    fast.init_state(fastwin.TILE, 3, device="cpu"), None, reps=2, quorum=2, iota_vids=True)
from tpu_paxos_torch.fleet import envelope
fleet = envelope.runner_for(config.SimConfig(n_nodes=3, n_instances=16, proposers=(0, 1)),
                            [[100, 101], [200]], device="cpu")
rep = fleet.run([0, 1], [sched, None], workloads=[([[100, 101], [200]], None)] * 2,
                knobs=[config.FaultConfig(max_delay=1), config.FaultConfig(drop_rate=500)])
import contextlib, io, json, os, tempfile
from tpu_paxos_torch import __main__ as cli
from tpu_paxos_torch.analysis import artifact_schema, chunking
from tpu_paxos_torch.harness import shrink, stress
case = shrink.ReproCase(
    cfg=config.SimConfig(n_nodes=3, n_instances=16, proposers=(0, 1), faults=config.FaultConfig(
        max_delay=1, schedule=faults.FaultSchedule((faults.partition(2, 9, (0,), (1, 2)),)))),
    workload=[[100, 101], [200]], gates=None, chains=[[], []],
    extra_checks={"decision_round_max": 3})
small, viol = shrink.shrink_case(case, max_evals=6, device="cpu")
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "a.json")
    shrink.save_artifact(path, small, viol, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["repro", path, "--device", "cpu"])
summary = stress.sweep(n_seeds=1, mixes=stress.MIXES[:1], verbose=False, device="cpu")
from tpu_paxos_torch.telemetry import diagnose, recorder
armed, summ, wins = sim.run_with_telemetry(
    config.SimConfig(n_nodes=3, n_instances=16, proposers=(0, 1),
                     faults=config.FaultConfig(max_delay=1, schedule=sched)), device="cpu")
tele = envelope.runner_for(config.SimConfig(n_nodes=3, n_instances=16, proposers=(0, 1)),
                           [[100, 101], [200]], telemetry=True, device="cpu").run(
    [0, 1], [sched, None], workloads=[([[100, 101], [200]], None)] * 2,
    knobs=[config.FaultConfig(max_delay=1)] * 2, regions=[[0, 1, 2], None])
diag = diagnose.diagnose_series(recorder.summary_to_dict(summ, wins)["windows"])
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "a.json")
    shrink.save_artifact(path, small, viol, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc_trace = cli.main(["trace", path, "--stdout", "--device", "cpu"])
    trace = json.loads(buf.getvalue())
from tpu_paxos_torch.core import geom
from tpu_paxos_torch.fleet import search
genv = geom.GeometryEnvelope(((3, (0,)), (5, (0, 1))))
padded = envelope.runner_for(config.SimConfig(n_nodes=3, n_instances=16, proposers=(0,)),
                             [[100, 101]], geometry=genv, device="cpu")
prep = padded.run([0, 1], [sched, None], workloads=[([[100, 101]], None)] * 2,
                  knobs=[config.FaultConfig(max_delay=1)] * 2, geometry=(3, (0,)))
found = search.search(n_lanes=2, generations=1, max_episodes=1, horizon=16, verbose=False,
                      device="cpu")
stress.MIXES, stress.EPISODE_MIXES, stress.WAN_MIXES = stress.MIXES[:1], stress.EPISODE_MIXES[:1], []
with contextlib.redirect_stdout(io.StringIO()) as buf:
    rc_fleet = cli.main(["fleet", "--lanes", "2", "--generations", "1", "--max-episodes", "1",
                         "--quiet", "--device", "cpu"])
    rc_stress = stress.main(["--fleet", "--seeds", "1", "--device", "cpu"])
lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_paxos"))
ok = (res.done and res2.done and int(n) == 16 and counts.tolist() == [fastwin.TILE] * 2
      and bool(rep.verdict.ok.all()) and rc == 0 and summary["ok"]
      and chunking.chunk_pad([1], 2) == [([1, 1], 1)]
      and armed.done and int(summ.decided) == 8 and tele.lane_telemetry(1)["decided"] == 3
      and isinstance(diag, dict) and rc_trace == 0 and trace["otherData"]["decided"] >= 1
      and bool(prep.verdict.ok.all()) and prep.cfg.n_nodes == 3 and found["lanes_total"] == 2
      and rc_fleet == rc_stress == 0
      and [d["metric"] for d in lines] == ["fleet_search", "stress_sweep", "stress_sweep_fleet"])
print(len(mods), bool(ok), loaded)
"""


def test_port_imports_and_runs_with_jax_and_tpu_paxos_blocked():
    proc = _python("-c", _BLOCKED_IMPORT_PROBE, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_mods, done, loaded = proc.stdout.split(maxsplit=2)
    assert int(n_mods) >= 38  # every module of the package was imported, telemetry/ too
    assert done == "True"
    assert loaded.strip() == "[]"


def _golden_script():
    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(ROOT, "scripts", "torch_port_goldens.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_committed_goldens_recompute_from_jax():
    """The full-size golden (2**23 instances) recomputed from the JAX
    package equals the committed file, byte for byte."""
    script = _golden_script()
    text = json.dumps(script.compute(), indent=1, sort_keys=True) + "\n"
    with open(GOLDENS) as f:
        assert f.read() == text
