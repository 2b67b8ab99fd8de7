"""The port's CLI (``python -m tpu_paxos_torch``, general engine and fast
path) against the JAX CLI, the port's import boundary (no ``jax``, no
``tpu_paxos``), and the committed JAX goldens that ``chip_smoke.py``
holds the card run to.  The JAX CLI's stdout for the heavier lines is
:func:`jax_goldens`, committed as ``goldens.json``'s ``tests.cli`` by
``scripts/torch_port_goldens.py`` (the slow tier recomputes it)."""

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
GOLDENS_DIR = os.path.join(ROOT, "tpu_paxos_torch", "data")
GOLDENS = os.path.join(GOLDENS_DIR, "goldens.json")
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


#: the crash run of test_cli_json_summary_equals_the_jax_cli
CRASH_ARGS = ["3", "2", "6", "--seed=4", "--net-drop-rate=900", "--crash-rate=20000",
              "--net-max-delay=1", "--json"]


def _want():
    return _goldens()["tests"]["cli"]


def _jax_cli(argv) -> dict:
    """The JAX CLI's exit code and stdout for ``argv`` (in process,
    deterministic log stamps)."""
    import contextlib
    import io

    from tpu_paxos import __main__ as jcli

    buf = io.StringIO()
    old = os.environ.get("TPU_PAXOS_DETERMINISTIC")
    os.environ["TPU_PAXOS_DETERMINISTIC"] = "1"
    try:
        with contextlib.redirect_stdout(buf):
            rc = jcli.main(list(argv))
    finally:
        if old is None:
            os.environ.pop("TPU_PAXOS_DETERMINISTIC")
        else:
            os.environ["TPU_PAXOS_DETERMINISTIC"] = old
    return {"rc": rc, "stdout": buf.getvalue()}


def _npz(path) -> dict:
    """Each array of an ``.npz`` as its dtype, shape and bytes' sha256."""
    with np.load(path) as z:
        return {k: {"dtype": str(z[k].dtype), "shape": list(z[k].shape),
                    "sha256": hashlib.sha256(np.ascontiguousarray(z[k]).tobytes()).hexdigest()}
                for k in z.files}


def jax_goldens(tmp: str) -> dict:
    """The JAX CLI's side of this file's heavier lines, as
    ``goldens.json``'s ``tests.cli`` holds it: the debug line's stdout,
    the crash run's, the sharded surfaces' (exit code and stdout), the
    serve CLIs' (exit code and summary less the wall fields), and the
    member CLIs' (stdout and ``--save-state`` arrays)."""
    debug = _python("-m", "tpu_paxos", *DEBUG_ARGS, "--backend", "cpu")
    assert debug.returncode == 0, debug.stderr
    out = {"debug": debug.stdout, "crash": _jax_cli(CRASH_ARGS)}
    art = _sharded_artifact(tmp)
    out["surfaces"] = {}
    for argv in _JAX_SURFACES:
        got = _jax_cli([art if a == _SHARDED_ART else a for a in argv] + ["--backend", "cpu"])
        out["surfaces"][" ".join(argv)] = {"rc": got["rc"],
                                           "stdout": got["stdout"].replace(art, _SHARDED_ART)}
    serve = {}
    for argv in _SERVE_CLIS:
        got = _jax_cli(argv + ["--backend", "cpu"])
        serve[" ".join(argv)] = {"rc": got["rc"],
                                 "summary": less_wall(json.loads(got["stdout"].splitlines()[-1]))}
    out["serve"] = serve
    member = {}
    gold = _goldens()["member"]["cli"]
    for extra in _MEMBER_EXTRA:
        path = os.path.join(tmp, "j.npz")
        got = _jax_cli(gold["args"] + extra + ["--save-state", path])
        member[" ".join(extra)] = {**got, "state": _npz(path)}
    out["member"] = member
    return json.loads(json.dumps(out, sort_keys=True))


def test_cli_stdout_is_byte_identical_to_the_jax_cli():
    port_run = _python("-m", "tpu_paxos_torch", *DEBUG_ARGS, "--device", "cpu")
    assert port_run.returncode == 0, port_run.stderr
    assert port_run.stdout == _want()["debug"]
    assert "ALL INVARIANTS GREEN" in port_run.stdout.splitlines()[-1]
    # the decision log (all but the verdict line) is the committed golden
    log = "".join(port_run.stdout.splitlines(keepends=True)[:-1])
    gold = _goldens()["cli_4_4_10"]
    assert hashlib.sha256(log.encode()).hexdigest() == gold["decision_log_sha256"]


def test_cli_json_summary_equals_the_jax_cli(capsys):
    """A crash loses the crashed proposer's queued value, so both CLIs
    must report the same failed verdict and exit 1."""
    want = _want()["crash"]
    assert tcli.main(CRASH_ARGS + ["--device", "cpu"]) == want["rc"] == 1
    out = capsys.readouterr().out
    assert out == want["stdout"]
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


#: The placeholder replaced by a written sharded artifact.
_SHARDED_ART = "{sharded artifact}"
#: The surfaces that compare with the JAX CLI's stdout (``what`` None).
_JAX_SURFACES = [
    ["4", "4", "10", "--engine=fast", "--mesh", "2"],
    ["4", "4", "10", "--mesh", "2"],
    ["repro", _SHARDED_ART],
    ["trace", _SHARDED_ART, "--stdout"],
    ["repro", _SHARDED_ART, "--json"],
]


def _sharded_artifact(tmp: str) -> str:
    """The committed culprit artifact re-stamped as a sharded one at 2
    devices, written as ``tmp/sharded.json``."""
    with open(os.path.join(GOLDENS_DIR, "repro_culprit.json")) as f:
        art = json.load(f)
    art.update(engine="sharded", devices=2)
    path = os.path.join(tmp, "sharded.json")
    with open(path, "w") as f:
        json.dump(art, f)
    return path


def _member_json():
    return _goldens()["member"]["cli"]["record_stdout"]


class _Runs:
    """A ported subcommand that takes no ``--device`` of the harness's:
    it runs as given and exits ``rc`` with ``text`` in its stdout (or, for
    ``stream="err"``, in stderr, as argparse reports a usage error)."""

    def __init__(self, rc: int, text: str, stream: str = "out"):
        self.rc, self.text, self.stream = rc, text, stream


class _Tiled:
    """A lane-tile CLI case: its last JSON line, less the wall fields
    (``less``), equals the JAX golden's summary at ``path`` in
    goldens.json, JAX's unmeshed CLI at the padded lane count (JAX's
    own tiled CLI indexes lane-sharded arrays on the host, which jax
    0.9.0 refuses)."""

    def __init__(self, path, less):
        self.path, self.less = path, less

    def golden(self):
        """The golden's exit code (0 where it records none) and summary."""
        gold = _goldens()
        for key in self.path[:-1]:
            gold = gold[key]
        return gold.get("rc", 0), gold[self.path[-1]]


def _evolve_less(summary):
    return _golden_script().evolve_less(summary)


def _serve_less(summary):
    return _golden_script().less_wall(summary)


#: evolve-quick's arguments with the lane count cut to 5: ``--mesh 4``
#: pads it to the golden's 8
_EVOLVE_TILED = ["--lanes", "5", "--generations", "2", "--seed", "2",
                 "--decision-round-max", "35", "--max-wedges", "1", "--mesh", "4",
                 "--triage-dir", "{tmp}", "--quiet"]


@pytest.mark.parametrize("argv,what", [
    # --mesh shards the instance axis of the general engine and the fast
    # path (tests/test_torch_sharded*.py); these cases keep their ids and
    # now compare stdout and exit code with the JAX CLI's (what None)
    pytest.param(["4", "4", "10", "--engine=fast", "--mesh", "2"], None,
                 id="argv0---engine=fast"),
    # JAX's run_member never reads --mesh: the member CLI's JSON line is
    # the committed JAX golden's (what: the golden's stdout)
    pytest.param(["4", "4", "10", "--engine=member", "--mesh", "2", "--json"], _member_json,
                 id="argv1---engine=member"),
    pytest.param(["4", "4", "10", "--mesh", "2"], None, id="argv2---mesh"),
    # trace is ported, of every artifact engine (the trace of a controller
    # model checker's artifact fails the repro schema as JAX's does:
    # test_torch_mc_control.py); audit is ported, and the HLO tier it
    # replaces has no counterpart: --hlo is refused as an unknown flag
    # (kept under the case's id)
    pytest.param(["audit", "--hlo"], _Runs(2, "unrecognized arguments: --hlo", stream="err"),
                 id="argv3-'trace'"),
    # fleet is ported; so is lint, which exits 0 on the port against its
    # baseline (kept under the case's id)
    pytest.param(["lint"], _Runs(0, ", 0 findings, "), id="argv4-'fleet'"),
    # serve and its admission controller are ported; so is audit, which
    # exits 0 on the CPU against the committed budget (kept under the
    # case's id)
    pytest.param(["audit", "--device", "cpu"], _Runs(0, "0 sweep problems, 0 budget violations"),
                 id="argv5-'serve'"),
    # evolve is ported on all three axes (tests/test_torch_evolve.py,
    # test_evolve_cli_equals_the_jax_cli), and so is its lane tile: these
    # cases keep their ids and hold the tiled CLIs to the JAX goldens
    pytest.param(["evolve", *_EVOLVE_TILED], _Tiled(("evolve", "quick", "summary"), _evolve_less),
                 id="argv6-'evolve'"),
    # mc is ported (test_mc_cli_routes_to_the_model_checker)
    pytest.param(["evolve", "--axis", "member", "--lanes", "4", "--generations", "2",
                  "--seed", "0", "--hunt", "duel-churn", "--max-wedges", "2", "--mesh", "2",
                  "--quiet"], _Tiled(("evolve", "member", "summary"), _evolve_less),
                 id="argv7-'mc'"),
    pytest.param(["serve", "--fleet", "--lanes", "8", "--mesh", "2"],
                 _Tiled(("serve", "cli", "serve --fleet --lanes 8", "summary"), _serve_less),
                 id="argv8-'serve --fleet --mesh'"),
    # the controller's surfaces below are ported (tests/test_torch_control.py
    # and test_serve_control_cli_equals_the_jax_cli); their cases keep their
    # ids on the controlled fleet's lane tile and on the replay and trace
    # of sharded artifacts, which compare with the JAX CLI's
    pytest.param(["serve", "--fleet", "--lanes", "8", "--control", "--slo-latency", "16",
                  "--slo-budget-milli", "150", "--rate-milli", "16000", "--mesh", "4"],
                 _Tiled(("control", "cli", "serve --fleet --lanes 8 --control --slo-latency 16 "
                         "--slo-budget-milli 150 --rate-milli 16000", "summary"), _serve_less),
                 id="argv9-'serve --fleet --control'"),
    pytest.param(["repro", _SHARDED_ART], None, id="argv10-'serve --control-ab'"),
    pytest.param(["trace", _SHARDED_ART, "--stdout"], None,
                 id="argv11-'serve --save-artifact'"),
    pytest.param(["repro", _SHARDED_ART, "--json"], None,
                 id="argv12-repro of engine 'serve' artifacts (the serve admission controller)"),
])
def test_unported_cli_surfaces_exit_2(argv, what, capsys, tmp_path, monkeypatch):
    """Some cases keep the id of a surface since ported.  A refused
    surface exits 2 naming itself; a ported one (``what`` None) prints the
    JAX CLI's stdout with its exit code (``what`` callable: the committed
    JAX golden's stdout, exit 0; a :class:`_Tiled` case: the golden's
    summary, less the wall fields, and exit code; a :class:`_Runs` case:
    its exit code and a line of its output).  Each failure names the
    command line it ran."""
    surface = f"{what}: {' '.join(argv)}"
    key = " ".join(argv)
    argv = [str(tmp_path) if a == "{tmp}" else a for a in argv]
    art = _sharded_artifact(str(tmp_path))
    argv = [art if a == _SHARDED_ART else a for a in argv]
    if what is None:
        # the artifact's path, in the stdout, stands as its placeholder
        monkeypatch.setenv("TPU_PAXOS_DETERMINISTIC", "1")
        jax = _want()["surfaces"][key]
        rc_jax, want = jax["rc"], jax["stdout"]
        assert tcli.main(argv + ["--device", "cpu"]) == rc_jax, surface
        assert capsys.readouterr().out.replace(art, _SHARDED_ART) == want, surface
        assert want, surface
        return
    if isinstance(what, _Tiled):
        from tpu_paxos_torch.fleet import envelope

        envelope.clear_cache()
        monkeypatch.chdir(str(tmp_path))
        rc, want = what.golden()
        assert tcli.main(argv + ["--device", "cpu"]) == rc, surface
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert what.less(got) == want, surface
        return
    if isinstance(what, _Runs):
        try:
            rc = tcli.main(argv)
        except SystemExit as e:
            rc = e.code
        out = capsys.readouterr()
        assert rc == what.rc, surface
        assert what.text in (out.err if what.stream == "err" else out.out), surface
        return
    if callable(what):
        assert tcli.main(argv + ["--device", "cpu"]) == 0, surface
        assert capsys.readouterr().out == what(), surface
        return
    assert tcli.main(argv + ["--device", "cpu"]) == 2, surface
    out = capsys.readouterr()
    assert f"{what} is not ported yet" in out.err and out.out == "", surface


def test_mc_cli_routes_to_the_model_checker(capsys):
    """``mc`` is ported: an unknown scope is the checker's scope error
    (exit 2, named on stderr, nothing on stdout), as in the JAX CLI."""
    gold = _goldens()["mc"]
    assert tcli.main(gold["config"]["nosuch_cli"] + ["--device", "cpu"]) == 2
    out = capsys.readouterr()
    assert (2, out.out) == (gold["nosuch_cli"]["rc"], gold["nosuch_cli"]["stdout"])
    assert "scope 'nosuch' not in" in out.err and "not ported" not in out.err


def test_evolve_cli_equals_the_jax_cli(tmp_path, capsys, monkeypatch):
    """``evolve`` is ported: ``make evolve-quick``'s line on the port's
    CPU prints JAX's summary line, less the wall fields (the generation-0
    build count by its zero pattern), and writes JAX's artifact bytes."""
    from tpu_paxos_torch.fleet import envelope

    script = _golden_script()
    gold = _goldens()["evolve"]
    envelope.clear_cache()
    monkeypatch.chdir(str(tmp_path))
    capsys.readouterr()
    rc = tcli.main(["evolve", *gold["config"]["quick"], "--triage-dir", str(tmp_path),
                    "--quiet", "--device", "cpu"])
    out = capsys.readouterr().out
    want = json.loads(gold["quick"]["stdout"].strip().splitlines()[-1])
    got = json.loads(out.strip().splitlines()[-1])
    assert rc == gold["quick"]["rc"] == 0
    assert len(out.splitlines()) == len(gold["quick"]["stdout"].splitlines())
    assert script.evolve_less(got) == script.evolve_less(want) == gold["quick"]["summary"]
    with open(got["artifact"], "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == gold["quick"]["artifact_sha256"]


def test_repro_routes_mc_control_artifacts(tmp_path, capsys, monkeypatch):
    """``repro`` of an ``engine: "mc-control"`` artifact goes to
    ``analysis/mc_control.reproduce`` and prints the JAX CLI's stdout."""
    from tpu_paxos_torch.analysis import mc_control

    calls = []
    real = mc_control.reproduce
    monkeypatch.setattr(mc_control, "reproduce",
                        lambda path, device=None: calls.append(path) or real(path, device))
    gold = _goldens()["mc"]["tiny_control"]
    name = sorted(gold["artifacts"])[0]
    (tmp_path / name).write_text(gold["artifacts"][name])
    with _in_dir(str(tmp_path)):
        rc = tcli.main(["repro", name, "--device", "cpu"])
    want = gold["cli"][f"repro {name}"]
    assert (rc, capsys.readouterr().out) == (want["rc"], want["stdout"])
    assert calls == [name]


def _control_gold():
    return _goldens()["control"]


def _cli_in(cwd, argv, capsys):
    """``tcli.main(argv)`` on the CPU with ``cwd`` as the working
    directory; returns (exit code, stdout)."""
    with _in_dir(cwd):
        rc = tcli.main(argv + ["--device", "cpu"])
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("i", range(3), ids=["control-save-artifact", "control-ab", "fleet-control"])
def test_serve_control_cli_equals_the_jax_cli(i, tmp_path, capsys):
    """``serve --control --save-artifact``, ``serve --control-ab`` (the
    committed spike A/B) and ``serve --fleet --control``: the exit code
    and the JSON line, less the wall fields, equal the JAX CLI's
    (``goldens.json``'s ``control.cli``, the card's phase 16d); the saved
    artifact's bytes equal JAX's."""
    gold = _control_gold()
    argv = gold["config"]["cli"][i]
    rc, out = _cli_in(tmp_path, argv, capsys)
    want = gold["cli"][" ".join(argv)]
    assert rc == want["rc"]
    assert less_wall(json.loads(out.strip().splitlines()[-1])) == want["summary"]
    if "--save-artifact" in argv:
        with open(tmp_path / gold["config"]["artifact"], "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == gold["cli"]["artifact_sha256"]


def test_repro_of_serve_artifacts_equals_the_jax_cli(tmp_path, capsys):
    """``repro`` of a controlled-serve artifact: the one ``serve --control
    --save-artifact`` writes and the committed spike artifact both replay
    (``match``) with the JAX CLI's stdout, byte for byte."""
    gold = _control_gold()
    _cli_in(tmp_path, gold["config"]["cli"][0], capsys)
    rc, out = _cli_in(tmp_path, gold["config"]["repro"], capsys)
    assert rc == gold["cli"]["repro"]["rc"] == 0
    assert hashlib.sha256(out.encode()).hexdigest() == gold["cli"]["repro"]["stdout_sha256"]
    assert json.loads(out.strip().splitlines()[-1])["match"]
    committed = gold["committed"]
    rc, out = _cli_in(ROOT, committed["repro"]["args"], capsys)
    assert rc == committed["repro"]["rc"] == 0
    assert hashlib.sha256(out.encode()).hexdigest() == committed["repro"]["stdout_sha256"]
    with open(os.path.join(ROOT, gold["config"]["committed_artifact"]), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == committed["artifact_sha256"]


#: The serve CLIs of the card's phase 15d, less the wall fields.
_SERVE_CLIS = [
    ["serve"],
    ["serve", "--fleet", "--lanes", "8"],
    ["serve", "--values", "48", "--rate-milli", "3000", "--nodes", "3", "--slo-latency", "8",
     "--sequential"],
    ["serve", "--values", "40", "--sweep", "2000,8000,32000", "--slo-latency", "16"],
    ["serve", "--fleet", "--lanes", "2", "--lane-counts", "1,2", "--sweep", "2000,8000",
     "--values", "32", "--slo-latency", "16"],
]


def less_wall(d):
    """A serve summary less its wall-clock fields, at every depth."""
    if isinstance(d, list):
        return [less_wall(x) for x in d]
    if not isinstance(d, dict):
        return d
    return {k: less_wall(v) for k, v in d.items()
            if k not in ("wall_seconds", "values_per_sec", "values_per_sec_surface")}


@pytest.mark.parametrize("argv", _SERVE_CLIS, ids=lambda a: " ".join(a[:4]))
def test_serve_cli_equals_the_jax_cli(argv, capsys):
    """``serve`` and ``serve --fleet``: the same exit code and the same
    JSON line as the JAX CLI, less the wall fields (a single stream at
    the defaults and sequentially with an SLO, the load sweep, the fleet
    and its (lanes x rates) surface); the first two are the committed
    goldens the card holds."""
    jax = _want()["serve"][" ".join(argv)]
    rc_t = tcli.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc_t == jax["rc"]
    assert json.loads(json.dumps(less_wall(got))) == jax["summary"]
    gold = _goldens().get("serve", {}).get("cli", {})
    key = " ".join(argv)
    if key in gold:
        assert less_wall(got) == gold[key]["summary"]


def _in_dir(path):
    """A context that runs the body with ``path`` as the working
    directory (the member CLI's injection logs name relative paths)."""
    import contextlib

    @contextlib.contextmanager
    def cd():
        old = os.getcwd()
        os.chdir(path)
        try:
            yield
        finally:
            os.chdir(old)

    return cd()


_MEMBER_EXTRA = [[], ["--crash-rate=5000"], ["--crash-rate=2000", "--seed=3"]]


@pytest.mark.parametrize("extra", _MEMBER_EXTRA)
def test_member_cli_equals_the_jax_cli(extra, tmp_path, capsys):
    """``--engine=member --json``: the same stdout and exit code as the JAX
    CLI, and the same ``--save-state`` checkpoint arrays; the first two are
    the committed goldens the card holds."""
    gold = _goldens()["member"]["cli"]
    jax = _want()["member"][" ".join(extra)]
    argv = gold["args"] + extra
    assert jax["rc"] == 0
    assert tcli.main(argv + ["--save-state", str(tmp_path / "t.npz"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out == jax["stdout"]
    if not extra:
        assert out == gold["record_stdout"]
    elif extra == [f"--crash-rate={gold['crash_rate']}"]:
        assert out == gold["crash_stdout"]
    assert _npz(tmp_path / "t.npz") == jax["state"]


def test_member_cli_record_replay_equals_the_jax_cli(tmp_path, capsys):
    """``--record-injections`` then ``--replay-injections``: stdouts and
    the injection log's bytes equal the JAX CLI's (the committed golden
    of ``python -m tpu_paxos``'s same lines); the two flags together
    refuse as JAX's do."""
    gold = _goldens()["member"]["cli"]
    name = gold["injections"]
    dev = ["--device", "cpu"]
    with _in_dir(tmp_path):
        assert tcli.main(gold["args"] + ["--record-injections", name] + dev) == 0
        rec = capsys.readouterr().out
        assert tcli.main(gold["args"] + ["--replay-injections", name] + dev) == 0
        rep = capsys.readouterr().out
        with pytest.raises(SystemExit, match="mutually exclusive"):
            tcli.main(gold["args"] + ["--replay-injections", name, "--record-injections", "x"]
                      + dev)
    assert (rec, rep, (tmp_path / name).read_text()) == (
        gold["record_stdout"], gold["replay_stdout"], gold["injection_log"])


def test_repro_is_ported(tmp_path, capsys):
    """``repro`` is no longer a refused subcommand: a missing artifact is
    the schema surface's exit 2 (a JSON summary naming the problem), not
    'not ported'."""
    path = str(tmp_path / "missing.json")
    assert tcli.main(["repro", path, "--json", "--device", "cpu"]) == 2
    out = capsys.readouterr()
    assert "not ported" not in out.err
    assert "unreadable artifact" in json.loads(out.out)["schema_error"]["problem"]


#: The real sharded sweep's summary, computed once for both cases below.
_SHARDED_SWEEP = {}


@pytest.mark.parametrize("flag", ["--fleet", "--sharded"])
def test_stress_cli_unported_sweeps_exit_2(flag, capsys, monkeypatch):
    """``--sharded`` is ported (the test keeps its name): after the
    host-loop line (with ``--fleet`` beside it, after the host-loop and
    fleet pair) the CLI runs the sharded sweep on 8 ranks and prints its
    summary, and exits 0.  Here the sweep runs its two i.i.d. mixes (the
    episode mixes emptied: 4 runs, once for both cases), whose summary is
    JAX's ``stress_sharded`` golden at 4 runs; the whole sweep is held to
    the golden in the slow tier (tests/test_torch_sharded_sim.py) and on
    the card (tests/test_torch_sharded_cuda.py), one of its episode runs
    in tier 1.  The host-loop and fleet sweeps are held to JAX's in
    tests/test_torch_stress.py, so here they return their summaries
    unrun."""
    from tpu_paxos_torch.harness import stress

    real = stress.sweep_sharded

    def sharded(*args, **kw):
        key = (args, tuple(sorted(kw.items())))
        if key not in _SHARDED_SWEEP:
            _SHARDED_SWEEP[key] = real(*args, **kw)
        return _SHARDED_SWEEP[key]

    monkeypatch.setattr(stress, "EPISODE_MIXES", [])
    monkeypatch.setattr(stress, "sweep_sharded", sharded)
    for name in ("sweep", "sweep_fleet"):
        monkeypatch.setattr(stress, name, lambda *a, _m=f"stress_{name}", **kw: {"metric": _m, "ok": True})
    extra = ["--sharded"] if flag == "--fleet" else []
    assert stress.main(["--seeds", "1", flag, *extra, "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    want = ["stress_sweep"] + (["stress_sweep_fleet"] if flag == "--fleet" else [])
    assert [d["metric"] for d in lines] == want + ["stress_sweep_sharded"]
    got = {k: v for k, v in lines[-1].items() if k not in ("seconds", "platform")}
    assert got == {**_goldens()["stress_sharded"]["summary"], "runs": 4}
    assert lines[-1]["platform"] == "cpu"


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
import numpy as np
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
from tpu_paxos_torch import checkpoint
from tpu_paxos_torch.fleet import member_runner
from tpu_paxos_torch.membership import MemberSim, ChurnEngine, grow_shrink_schedule
churn = ChurnEngine(4, 16, churn=grow_shrink_schedule(4, 2), crash_rate=500, device="cpu").run(seed=1)
ms = MemberSim(3, 16, seed=0, device="cpu")
cv = ms.add_acceptor(1)
member_ok = ms.run_until(lambda: ms.applied(cv), max_rounds=200)
mfleet = envelope.member_runner_for(3, 8, max_rounds=200, device="cpu").run(
    list(range(8)), [search.sample_churn_schedule(np.random.default_rng(i), 3) for i in range(8)],
    [None] * 8)
with tempfile.TemporaryDirectory() as tmp:
    checkpoint.save(os.path.join(tmp, "m.npz"), ms.state)
    back, _ = checkpoint.restore(os.path.join(tmp, "m.npz"), ms.state)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc_member = cli.main(["4", "4", "10", "--engine=member", "--json", "--device", "cpu",
                              "--record-injections", os.path.join(tmp, "i.json")])
        rc_replay = cli.main(["4", "4", "10", "--engine=member", "--json", "--device", "cpu",
                              "--replay-injections", os.path.join(tmp, "i.json")])
    member_lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
bufs = [io.StringIO() for _ in range(3)]
with contextlib.redirect_stdout(bufs[0]):
    rc_serve = cli.main(["serve", "--values", "24", "--rate-milli", "3000", "--nodes", "3",
                         "--slo-latency", "16", "--device", "cpu"])
with contextlib.redirect_stdout(bufs[1]):
    rc_sfleet = cli.main(["serve", "--fleet", "--lanes", "2", "--values", "16", "--nodes", "3",
                          "--device", "cpu"])
with contextlib.redirect_stdout(bufs[2]):
    rc_tserve = cli.main(["trace", "--serve", "--stdout", "--values", "16", "--nodes", "3",
                          "--lanes", "2", "--lane", "1", "--device", "cpu"])
serve_out = [json.loads(b.getvalue()) for b in bufs]
from tpu_paxos_torch.serve import arrivals, control, harness
spike = arrivals.spike_rounds(200, 2000, 0, factor=4, start_frac=0.25, len_frac=0.5)
c_streams, c_arrs = arrivals.split_round_robin(np.arange(200, dtype=np.int32), spike, 2)
ctl = control.controlled_serve_run(
    config.SimConfig(n_nodes=3, n_instances=512, proposers=(0, 1), seed=3, assign_window=8),
    c_streams, c_arrs, priorities=[arrivals.tier_priorities(s) for s in c_streams],
    control=control.ControlPolicy(ladder=(1, 2)), slo=harness.ServeSLO(latency_rounds=16),
    rounds_per_window=4, window_rounds=32, device="cpu")
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "serve.json")
    control.save_artifact(path, ctl)
    with contextlib.redirect_stdout(io.StringIO()):
        rc_ctl = cli.main(["repro", path, "--device", "cpu"])
from tpu_paxos_torch.fleet import evolve
from tpu_paxos_torch.serve import breach
from tpu_paxos_torch.analysis import shard_audit
from tpu_paxos_torch.parallel import mesh as pmesh
evo = evolve.evolve(axis="member", n_lanes=2, generations=1, verbose=False, device="cpu")
evo_tiled = evolve.evolve(axis="member", n_lanes=2, generations=1, verbose=False, device="cpu",
                          mesh=pmesh.make_instance_mesh(2, device="cpu"))
tile_ok = not shard_audit.check_certificate(((2, 1),), device="cpu",
                                            entries=["member.fleet_lanes"])
evo_ok = (tile_ok and evo_tiled["population_sha256"] == evo["population_sha256"]
          and evo["generations_run"] == 1 and evo["lanes_total"] == 2
          and len(evo["population_sha256"]) == 64
          and breach.sample_serve_genome(np.random.default_rng(0), [[1], [2]], "calm").weather
          == "calm")
from tpu_paxos_torch.analysis import mc_control, mc_member, modelcheck, triage
tiny = mc_control.ControlScope.from_dict({
    "tier_bands": [[3, 1, 2]], "patiences": [1], "ladders": [[]],
    "window_sets": [[], ["gray-region"]], "burn_tiers": [900], "max_dispatches": 1})
with contextlib.redirect_stderr(io.StringIO()):
    rc_nosuch = cli.main(["mc", "--scope", "nosuch", "--device", "cpu"])
mc_ok = (rc_nosuch == 2 and mc_control.run_scope(tiny, verbose=False, device="cpu")["ok"]
         and len(mc_member.ChurnEnum(modelcheck.load_scopes()["churn"]).reduced) == 302
         and triage.dump_name("mc", "scenario_1", "json") == "mc_scenario_1.json")
from tpu_paxos_torch.parallel import sharded, sharded_sim
smesh = pmesh.make_instance_mesh(2, device="cpu")
sres = sharded_sim.run_sharded(config.SimConfig(n_nodes=3, n_instances=16, proposers=(0, 1)), smesh)
_, sn = sharded.sharded_choose_all(smesh, proposer=0, quorum=2)(
    sharded.init_sharded_state(smesh, 16, 3), pmesh.shard_instances(smesh, np.arange(16, dtype=np.int32)))
with contextlib.redirect_stdout(io.StringIO()):
    rc_mesh = cli.main(["3", "2", "4", "--mesh", "2", "--device", "cpu"])
sharded_ok = sres.done and sn == 16 and rc_mesh == 0 and smesh.calls[0] > 0
from tpu_paxos_torch import native
from tpu_paxos_torch.analysis import audit, buildcount, lint, registry, shard_audit
from tpu_paxos_torch.utils import dump
lint_ok = [f.rule for f in lint.lint_source("import time\\ndef f():\\n    return time.time()\\n")] == ["DET001"]
aud = audit.run_audit(providers=("tpu_paxos_torch.core.fast", "tpu_paxos_torch.core.simkern"),
                      device="cpu")
tools_ok = (lint_ok and aud["ok"] and len(registry.collect()) == 28
            and native.check_agreement(np.zeros((4, 3), np.int32)) is None
            and dump.dump_hex(b"\\x01\\xff") == "01 FF" and "census" in dir(buildcount))
import runpy
import torch
from tpu_paxos_torch.core import apply, ballot, values
from tpu_paxos_torch.harness import reference_runner
from tpu_paxos_torch.utils import log as tlog
eq, _ = reference_runner.run_equivalent_sim(3, 2, 4, device="cpu")
with tempfile.TemporaryDirectory() as tmp:
    with tlog.profile_trace(tmp, "cpu"):
        values.real_vid(1, 2, 10)
    traced = os.path.exists(os.path.join(tmp, tlog.TRACE_FILE))
for script in ("torch_replay_diff_member", "torch_check_smoke"):
    runpy.run_path(os.path.join("scripts", script + ".py"), run_name="probe")
lib_ok = (eq.done and eq.value_status(0)["status"] == "applied" and eq.rounds_to_chosen.size == 8
          and int(apply.frontiers(torch.from_numpy(eq.learned)).min()) == 8
          and int(ballot.node_of(65537)) == 1 and values.decode_host(-3, 10, 8) == (0, 1, True)
          and traced and reference_runner.fast_reference_args()[3] == "10")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_paxos"))
ok = (res.done and res2.done and int(n) == 16 and counts.tolist() == [fastwin.TILE] * 2
      and bool(rep.verdict.ok.all()) and rc == 0 and summary["ok"]
      and chunking.chunk_pad([1], 2) == [([1, 1], 1)]
      and armed.done and int(summ.decided) == 8 and tele.lane_telemetry(1)["decided"] == 3
      and isinstance(diag, dict) and rc_trace == 0 and trace["otherData"]["decided"] >= 1
      and bool(prep.verdict.ok.all()) and prep.cfg.n_nodes == 3 and found["lanes_total"] == 2
      and rc_fleet == rc_stress == 0
      and [d["metric"] for d in lines] == ["fleet_search", "stress_sweep", "stress_sweep_fleet"]
      and churn.done and member_ok and bool(mfleet.verdict.ok.all()) and mfleet.n_lanes == 8
      and bool((back.learned == ms.state.learned).all()) and rc_member == rc_replay == 0
      and member_lines[0]["decision_log_sha256"] == member_lines[1]["decision_log_sha256"]
      and rc_serve == rc_sfleet == rc_tserve == 0
      and [serve_out[0]["metric"], serve_out[1]["metric"]] == ["serve", "serve_fleet"]
      and serve_out[0]["decided"] == 24 and serve_out[1]["decided"] == 32
      and serve_out[2]["otherData"]["engine"] == "serve_fleet"
      and ctl.done and ctl.backlog == 0 and rc_ctl == 0 and mc_ok and evo_ok and sharded_ok
      and tools_ok and lib_ok)
print(len(mods), bool(ok), loaded)
"""


def test_port_imports_and_runs_with_jax_and_tpu_paxos_blocked():
    proc = _python("-c", _BLOCKED_IMPORT_PROBE, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_mods, done, loaded = proc.stdout.split(maxsplit=2)
    # every module of the package was imported, the parallel package and
    # the analysis tooling too
    assert int(n_mods) >= 72
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


@pytest.mark.slow
def test_jax_goldens_recompute(tmp_path):
    """The JAX CLI's side of this file, recomputed, equals the committed
    golden."""
    assert jax_goldens(str(tmp_path)) == _want()
