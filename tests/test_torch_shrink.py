"""The port's failure triage (``tpu_paxos_torch/harness/shrink.py`` and
the ``repro`` CLI) against the JAX package's, live on the CPU, with exact
equality (all protocol state is integer): the greedy shrinker lands on the
same case by the same accepted moves and eval count, batched and one
candidate at a time, at a generous budget and at one that runs out
mid-pass; the two packages write the same artifact bytes and replay each
other's artifacts; a real seeded wedge (``TPU_PAXOS_SEEDED_WEDGE=
takeover``) fails, shrinks and replays alike; and the CLI exits 0, 1 and
2 where the JAX CLI does.  JAX's side of the runs is :func:`jax_goldens`,
committed as ``goldens.json``'s ``tests.shrink`` by
``scripts/torch_port_goldens.py`` (the slow tier recomputes it); the
port replays the JAX-written artifacts."""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest

from tpu_paxos import __main__ as jcli
from tpu_paxos import config as jc
from tpu_paxos.core import faults as jf
from tpu_paxos.fleet import envelope as jenv
from tpu_paxos.harness import shrink as jshr
from tpu_paxos_torch import __main__ as tcli
from tpu_paxos_torch import config as tc
from tpu_paxos_torch.core import faults as tf
from tpu_paxos_torch.fleet import envelope as tenv
from tpu_paxos_torch.harness import shrink as tshr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tpu_paxos_torch", "data")
PKGS = {"jax": (jc, jf, jshr, {}), "port": (tc, tf, tshr, {"device": "cpu"})}


def _goldens():
    with open(os.path.join(DATA, "goldens.json")) as f:
        return json.load(f)


def _culprit(pkg, extra=None, episodes=3):
    """The three-episode case of tests/test_shrink.py: a partition that
    delays decisions past ``decision_round_max`` and two irrelevant
    episodes."""
    C, F, S, _ = PKGS[pkg]
    eps = (
        F.partition(5, 45, (0, 1), (2, 3, 4)),  # the culprit
        F.pause(50, 60, 3),  # after all decisions
        F.burst(2, 8, 1500),  # too short to matter
    )[:episodes]
    cfg = C.SimConfig(
        n_nodes=5, n_instances=64, proposers=(0, 1), seed=7, max_rounds=4000,
        faults=C.FaultConfig(drop_rate=300, dup_rate=500, max_delay=2,
                             schedule=F.FaultSchedule(eps)),
    )
    return S.ReproCase(
        cfg=cfg,
        workload=[np.arange(100, 110, dtype=np.int32), np.arange(200, 210, dtype=np.int32)],
        gates=None, chains=[np.zeros(0, np.int32)] * 2,
        extra_checks={"decision_round_max": 40} if extra is None else extra,
    )


def _from_spec(pkg, spec):
    """A golden triage input (artifact-shaped JSON) as ``pkg``'s case."""
    S = PKGS[pkg][2]
    return S.ReproCase(
        cfg=S._cfg_from_dict(spec["cfg"]),
        workload=[np.asarray(w, np.int32) for w in spec["workload"]],
        gates=None if spec["gates"] is None else [np.asarray(g, np.int32) for g in spec["gates"]],
        chains=[np.asarray(c, np.int32) for c in spec["chains"]],
        extra_checks=dict(spec["extra_checks"]),
    )


class _Moves:
    def __init__(self):
        self.moves = []

    def info(self, fmt, *args):
        self.moves.append(fmt % args)


def _shrink(pkg, case, **kw):
    S, extra = PKGS[pkg][2], PKGS[pkg][3]
    logger, stats = _Moves(), {}
    small, viol = S.shrink_case(case, logger=logger, stats=stats, **kw, **extra)
    return S._cfg_to_dict(small.cfg), viol, logger.moves, stats["evals"]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _clear_caches():
    jenv.clear_cache()
    tenv.clear_cache()


@pytest.fixture
def wedge(monkeypatch):
    """The takeover wedge armed for this test only.  The flag is part of
    both envelope caches' keys, so an armed runner is never reused for a
    plain case; the caches are cleared on the way out all the same, which
    is why the armed tests come last in this file (the plain ones share
    one JAX compile per runner shape)."""
    monkeypatch.setenv("TPU_PAXOS_SEEDED_WEDGE", "takeover")
    yield
    _clear_caches()


SHRINKS = [(batch, max_evals) for batch in (True, False) for max_evals in (40, 5)]
#: the repro CLI cases whose JAX stdout is committed (artifact variants)
REPRO_KINDS = ("match", "drift", "sharded", "serve", "mc-control")
#: the placeholder for an artifact's path in a committed stdout
ARTIFACT = "{artifact}"
RESULT_FIELDS = ("learned", "chosen_vid", "chosen_round", "chosen_ballot", "crashed", "msgs")


def _json(x):
    """``x`` as JSON reads it back (the form a golden is committed in)."""
    return json.loads(json.dumps(x, sort_keys=True))


def _want():
    return _goldens()["tests"]["shrink"]


def _read(path) -> str:
    with open(path) as f:
        return f.read()


def _jax_repro_cli(tmp: str) -> dict:
    """JAX's ``repro --json`` exit code and stdout for each variant of
    :data:`REPRO_KINDS` (deterministic log stamps)."""
    import contextlib
    import io
    import pathlib

    out = {}
    for kind in REPRO_KINDS:
        d = pathlib.Path(tmp) / kind
        d.mkdir()
        buf = io.StringIO()
        path = _artifact_variant(d, kind)
        with contextlib.redirect_stdout(buf):
            rc = jcli.run_repro([path, "--json"])
        out[kind] = {"rc": rc, "stdout": buf.getvalue().replace(path, ARTIFACT)}
    return out


def jax_goldens(tmp: str) -> dict:
    """JAX's side of this file's runs, as ``goldens.json``'s
    ``tests.shrink`` holds it."""
    out = {"shrink_case": {f"{b}-{m}": _shrink("jax", _culprit("jax"), max_evals=m, batch=b)
                           for b, m in SHRINKS}}
    jcase = _culprit("jax", {"decision_round_max": 25}, episodes=1)
    _, viol = jshr.run_case(jcase)
    jpath = os.path.join(tmp, "j.json")
    art = jshr.save_artifact(jpath, jcase, viol)
    rep = jshr.reproduce(jpath)
    out["artifact"] = {"violation": viol, "artifact": art, "text": _read(jpath),
                       "reproduce": {k: rep[k] for k in ("match", "decision_log_sha256")}}
    tpath = os.path.join(tmp, "t.json")
    tri = jshr.triage(_culprit("jax"), tpath, max_evals=20)
    tri.pop("shrink_seconds")
    out["triage"] = {"artifact": tri, "sha256": _sha(tpath)}
    jr, jv = jshr.run_case(dataclasses.replace(_culprit("jax", {}, episodes=0), engine="sharded",
                                               devices=2))
    out["sharded"] = {"violation": jv, "rounds": int(jr.rounds),
                      "arrays": {f: np.asarray(getattr(jr, f)).tolist() for f in RESULT_FIELDS}}
    old = {k: os.environ.get(k) for k in ("TPU_PAXOS_DETERMINISTIC", "TPU_PAXOS_SEEDED_WEDGE")}
    try:
        os.environ["TPU_PAXOS_DETERMINISTIC"] = "1"
        out["repro_cli"] = _jax_repro_cli(tmp)
        os.environ["TPU_PAXOS_SEEDED_WEDGE"] = "takeover"
        jcase = _from_spec("jax", _goldens()["triage_wedge"]["cases"]["takeover"])
        out["takeover"] = {"violation": jshr.run_case(jcase)[1], "shrink": _shrink("jax", jcase)}
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _clear_caches()
    return _json(out)


@pytest.mark.parametrize("max_evals", [40, 5])
@pytest.mark.parametrize("batch", [True, False])
def test_shrink_case_equals_jax(batch, max_evals):
    """The same final case, violation, accepted moves and eval count as
    the JAX shrinker: at 40 evals (both irrelevant episodes dropped, the
    partition bisected to one round, dup zeroed) and at 5, where the
    budget runs out inside the bisection pass."""
    want = _want()["shrink_case"][f"{batch}-{max_evals}"]
    got = _json(_shrink("port", _culprit("port"), max_evals=max_evals, batch=batch))
    assert got == want
    assert got[3] == min(25, max_evals)
    if max_evals == 40:
        assert [e["kind"] for e in got[0]["faults"]["schedule"]["episodes"]] == ["partition"]


def test_batched_and_one_lane_evaluators_agree_lane_for_lane():
    """Every padded 8-lane dispatch judges its real lanes as the one-lane
    evaluator does; padding lanes are dropped."""
    case = _culprit("port")
    one = tshr._runtime_candidate_eval(case, device="cpu")
    many = tshr._runtime_batch_eval(case, device="cpu")
    sched = case.cfg.faults.schedule
    cands = [case.with_schedule(sched.without(j)) for j in range(3)] + [
        case.with_schedule(sched.replaced(0, sched.episodes[0].shifted(5, 25 + k)))
        for k in range(7)
    ]
    verdicts = many(cands)
    assert len(verdicts) == len(cands) == 10  # two dispatches, 6 lanes padded
    assert verdicts == [one(c) for c in cands]
    assert verdicts[0] is None and verdicts[1] is not None


def test_artifacts_are_byte_equal_and_replay_across_packages(tmp_path):
    """For the same failing case both packages write the same artifact
    bytes, and each replays the other's with ``match`` and an equal
    decision-log sha256."""
    want = _want()["artifact"]
    tcase = _culprit("port", {"decision_round_max": 25}, episodes=1)
    r, viol = tshr.run_case(tcase, device="cpu")
    assert viol == want["violation"] and "decision_round_max" in viol
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    jpath.write_text(want["text"])
    jart = want["artifact"]
    tart = tshr.save_artifact(str(tpath), tcase, viol, device="cpu")
    assert _json(tart) == jart
    assert tpath.read_text() == want["text"]
    rep = tshr.reproduce(str(jpath), device="cpu")
    assert rep["match"] and rep["decision_log_sha256"] == jart["decision_log_sha256"]
    assert rep["rounds"] == r.rounds == jart["rounds"]
    # JAX replays its artifact, whose bytes the port's are, with a match
    assert want["reproduce"] == {"match": True, "decision_log_sha256": tart["decision_log_sha256"]}
    loaded, _ = tshr.load_artifact(str(tpath))
    assert loaded.cfg == tcase.cfg


def test_committed_artifacts_replay_in_port(monkeypatch):
    """The JAX-written artifacts committed beside the goldens replay in
    the port with the recorded violation and decision-log sha256 (the
    takeover one under its wedge)."""
    gold = _goldens()["triage_wedge"]["cases"]
    for name, spec in sorted(gold.items()):
        path = os.path.join(DATA, spec["artifact"])
        assert _sha(path) == spec["artifact_sha256"]
        for k, v in spec["env"].items():
            monkeypatch.setenv(k, v)
        rep = tshr.reproduce(path, device="cpu")
        assert rep["match"], (name, rep["violation"])
        assert (rep["decision_log_sha256"], rep["rounds"]) == (
            spec["decision_log_sha256"], spec["rounds"])
        for k in spec["env"]:
            monkeypatch.delenv(k)


def test_triage_writes_the_shrunk_artifact_as_jax(tmp_path):
    """``triage`` (the sweep's hook) returns the artifact plus its shrink
    stats, and writes the same file as JAX's."""
    want = _want()["triage"]
    tart = tshr.triage(_culprit("port"), str(tmp_path / "t.json"), max_evals=20, device="cpu")
    tart.pop("shrink_seconds")
    assert _json(tart) == want["artifact"] and tart["shrink_evals"] == 20
    assert _sha(tmp_path / "t.json") == want["sha256"]
    assert tshr.reproduce(str(tmp_path / "t.json"), device="cpu")["match"]


def test_green_case_refuses_shrink_and_sharded_raises():
    """A green case refuses to shrink.  A sharded case no longer raises
    (the test keeps its name): it runs on a mesh of its recorded device
    count and equals JAX's sharded run_case, result and verdict."""
    case = _culprit("port", {}, episodes=0)
    _, v = tshr.run_case(case, device="cpu")
    assert v is None
    with pytest.raises(ValueError, match="does not fail"):
        tshr.shrink_case(case, device="cpu")
    r, v = tshr.run_case(dataclasses.replace(case, engine="sharded", devices=2), device="cpu")
    want = _want()["sharded"]
    assert v == want["violation"] is None and r.rounds == want["rounds"]
    for f in RESULT_FIELDS:
        assert np.array_equal(getattr(r, f), np.asarray(want["arrays"][f])), f


def _artifact_variant(tmp_path, kind):
    """The committed culprit artifact as is (``match``), with another
    recorded sha256 (``drift``), or re-stamped as another engine (a
    sharded one at 2 devices)."""
    with open(os.path.join(DATA, "repro_culprit.json")) as f:
        art = json.load(f)
    if kind == "drift":
        art["decision_log_sha256"] = "0" * 64
    elif kind != "match":
        art["engine"] = kind
        if kind == "sharded":
            art["devices"] = 2
    path = tmp_path / "repro_culprit.json"
    path.write_text(json.dumps(art, indent=1))
    return str(path)


@pytest.mark.parametrize("kind,rc", [("match", 0), ("drift", 1)])
def test_repro_cli_exit_code_and_stdout_equal_jax(kind, rc, tmp_path, monkeypatch, capsys):
    """Exit 0 on a reproducing artifact and 1 on one whose recorded log
    differs, with stdout (decision log + JSON summary) byte-equal to the
    JAX CLI's."""
    monkeypatch.setenv("TPU_PAXOS_DETERMINISTIC", "1")
    path = _artifact_variant(tmp_path, kind)
    jax = _want()["repro_cli"][kind]
    want = jax["stdout"]
    assert jax["rc"] == rc
    assert tcli.main(["repro", path, "--json", "--device", "cpu"]) == rc
    assert capsys.readouterr().out.replace(path, ARTIFACT) == want
    assert json.loads(want.splitlines()[-1])["match"] is (rc == 0)


@pytest.mark.parametrize("engine", ["sharded", "serve", "mc-control"])
def test_repro_cli_unported_engine_exits_2(engine, tmp_path, capsys, monkeypatch):
    """Every engine's artifacts replay now (the test keeps its name).  A
    sim artifact re-stamped ``sharded`` at 2 devices replays on a 2-rank
    mesh: its sharded log differs from the recorded unsharded one, so
    both CLIs print the same non-matching replay and exit 1.  Serve
    artifacts replay through the admission controller
    (tests/test_torch_control.py) and mc-control ones through the
    controller model checker (tests/test_torch_mc_control.py); a sim
    artifact re-stamped ``serve`` without its ``serve`` block or
    ``mc-control`` without its policy exits 2 with JAX's schema error,
    stdout for stdout."""
    monkeypatch.setenv("TPU_PAXOS_DETERMINISTIC", "1")
    path = _artifact_variant(tmp_path, engine)
    jax = _want()["repro_cli"][engine]
    want = jax["stdout"]
    if engine == "sharded":
        assert tcli.main(["repro", path, "--json", "--device", "cpu"]) == jax["rc"]
        assert capsys.readouterr().out.replace(path, ARTIFACT) == want
        assert json.loads(want.splitlines()[-1])["engine"] == "repro"
        return
    assert jax["rc"] == 2
    assert tcli.main(["repro", path, "--json", "--device", "cpu"]) == 2
    assert capsys.readouterr().out.replace(path, ARTIFACT) == want
    assert json.loads(want)["schema_error"]["field"] == (
        "serve" if engine == "serve" else "policy")


def test_seeded_wedge_found_shrunk_and_replayed_as_jax(tmp_path, wedge, monkeypatch):
    """The takeover wedge armed: the real wedge case (a partition of node
    0 and a crash of node 1 at round 8) fails by non-quiescence in both
    packages, shrinks by the same moves, and the port writes the bytes of
    the committed JAX artifact, which replays under the wedge and not
    without it.  (The stress sweep under the wedge is
    tests/test_torch_stress.py's.)"""
    spec = _goldens()["triage_wedge"]["cases"]["takeover"]
    want = _want()["takeover"]
    tcase = _from_spec("port", spec)
    r, viol = tshr.run_case(tcase, device="cpu")
    assert viol == want["violation"] == f"no quiescence in {r.rounds} rounds"
    got = _shrink("port", tcase)
    assert _json(got) == want["shrink"]
    assert got[1] == spec["violation"] and got[2] == spec["moves"]
    final = dataclasses.replace(tcase, cfg=tshr._cfg_from_dict(got[0]))
    path = str(tmp_path / spec["artifact"])
    tshr.save_artifact(path, final, got[1], device="cpu")
    committed = os.path.join(DATA, spec["artifact"])
    assert _sha(path) == _sha(committed) == spec["artifact_sha256"]
    assert tshr.reproduce(path, device="cpu")["match"]
    monkeypatch.delenv("TPU_PAXOS_SEEDED_WEDGE")
    unarmed = tshr.reproduce(path, device="cpu")
    assert not unarmed["match"] and unarmed["violation"] is None


@pytest.mark.slow
def test_jax_goldens_recompute(tmp_path):
    """JAX's side of this file, recomputed, equals the committed golden."""
    assert jax_goldens(str(tmp_path)) == _want()
