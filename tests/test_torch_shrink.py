"""The port's failure triage (``tpu_paxos_torch/harness/shrink.py`` and
the ``repro`` CLI) against the JAX package's, live on the CPU, with exact
equality (all protocol state is integer): the greedy shrinker lands on the
same case by the same accepted moves and eval count, batched and one
candidate at a time, at a generous budget and at one that runs out
mid-pass; the two packages write the same artifact bytes and replay each
other's artifacts; a real seeded wedge (``TPU_PAXOS_SEEDED_WEDGE=
takeover``) fails, shrinks and replays alike; and the CLI exits 0, 1 and
2 where the JAX CLI does."""

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


_JAX_SHRINKS: dict = {}


@pytest.mark.parametrize("max_evals", [40, 5])
@pytest.mark.parametrize("batch", [True, False])
def test_shrink_case_equals_jax(batch, max_evals):
    """The same final case, violation, accepted moves and eval count as
    the JAX shrinker: at 40 evals (both irrelevant episodes dropped, the
    partition bisected to one round, dup zeroed) and at 5, where the
    budget runs out inside the bisection pass."""
    key = (batch, max_evals)
    if key not in _JAX_SHRINKS:
        _JAX_SHRINKS[key] = _shrink("jax", _culprit("jax"), max_evals=max_evals, batch=batch)
    want = _JAX_SHRINKS[key]
    got = _shrink("port", _culprit("port"), max_evals=max_evals, batch=batch)
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
    jcase = _culprit("jax", {"decision_round_max": 25}, episodes=1)
    tcase = _culprit("port", {"decision_round_max": 25}, episodes=1)
    _, viol = jshr.run_case(jcase)
    r, tviol = tshr.run_case(tcase, device="cpu")
    assert tviol == viol and "decision_round_max" in viol
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jart = jshr.save_artifact(jpath, jcase, viol)
    tart = tshr.save_artifact(tpath, tcase, viol, device="cpu")
    assert tart == jart
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()
    rep = tshr.reproduce(jpath, device="cpu")
    assert rep["match"] and rep["decision_log_sha256"] == jart["decision_log_sha256"]
    assert rep["rounds"] == r.rounds == jart["rounds"]
    back = jshr.reproduce(tpath)
    assert back["match"] and back["decision_log_sha256"] == tart["decision_log_sha256"]
    loaded, _ = tshr.load_artifact(tpath)
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
    jart = jshr.triage(_culprit("jax"), str(tmp_path / "j.json"), max_evals=20)
    tart = tshr.triage(_culprit("port"), str(tmp_path / "t.json"), max_evals=20, device="cpu")
    jart.pop("shrink_seconds"), tart.pop("shrink_seconds")
    assert tart == jart and tart["shrink_evals"] == 20
    assert _sha(tmp_path / "t.json") == _sha(tmp_path / "j.json")
    assert tshr.reproduce(str(tmp_path / "t.json"), device="cpu")["match"]


def test_green_case_refuses_shrink_and_sharded_raises():
    case = _culprit("port", {}, episodes=0)
    _, v = tshr.run_case(case, device="cpu")
    assert v is None
    with pytest.raises(ValueError, match="does not fail"):
        tshr.shrink_case(case, device="cpu")
    with pytest.raises(NotImplementedError, match="sharded"):
        tshr.run_case(dataclasses.replace(case, engine="sharded", devices=2), device="cpu")


def _artifact_variant(tmp_path, kind):
    """The committed culprit artifact as is (``match``), with another
    recorded sha256 (``drift``), or re-stamped as an engine the port does
    not replay yet."""
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
    assert jcli.run_repro([path, "--json"]) == rc
    want = capsys.readouterr().out
    assert tcli.main(["repro", path, "--json", "--device", "cpu"]) == rc
    assert capsys.readouterr().out == want
    assert json.loads(want.splitlines()[-1])["match"] is (rc == 0)


@pytest.mark.parametrize("engine", ["sharded", "serve", "mc-control"])
def test_repro_cli_unported_engine_exits_2(engine, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("TPU_PAXOS_DETERMINISTIC", "1")
    path = _artifact_variant(tmp_path, engine)
    assert tcli.main(["repro", path, "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert f"engine '{engine}'" in err and "not ported yet" in err


def test_seeded_wedge_found_shrunk_and_replayed_as_jax(tmp_path, wedge, monkeypatch):
    """The takeover wedge armed: the real wedge case (a partition of node
    0 and a crash of node 1 at round 8) fails by non-quiescence in both
    packages, shrinks by the same moves, and the port writes the bytes of
    the committed JAX artifact, which replays under the wedge and not
    without it.  (The stress sweep under the wedge is
    tests/test_torch_stress.py's.)"""
    spec = _goldens()["triage_wedge"]["cases"]["takeover"]
    jcase, tcase = _from_spec("jax", spec), _from_spec("port", spec)
    r, viol = tshr.run_case(tcase, device="cpu")
    assert viol == jshr.run_case(jcase)[1] == f"no quiescence in {r.rounds} rounds"
    got = _shrink("port", tcase)
    assert got == _shrink("jax", jcase)
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
