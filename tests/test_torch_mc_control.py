"""The port's controller checker (``tpu_paxos_torch/analysis/mc_control.py``)
against the JAX package's: every contract of ``tests/test_mc_control.py``
mirrored on the port on the CPU (the sequence and scenario codecs, the
host-plane oracle, the seeded shed-on-gray wedge found, shrunk and
replayed, the artifact's schema; the committed scope with its e2e cells
and the ``repro`` CLI in the slow tier), plus exact parity with JAX:
``judge_sequence`` decisions and bits over every sequence of the tiny
scope, clean and wedged, and the committed scope's letters, policies and
``describe()`` (live on both sides, host only), and the tiny scope's
summaries, mc-control artifact bytes and ``repro``/``trace`` stdout
against JAX's (``tpu_paxos_torch/data/goldens.json``)."""

import json
import os
import subprocess
import sys

import pytest

from tpu_paxos.analysis import mc_control as jmcc
from tpu_paxos.serve import control as jctl
from tpu_paxos_torch import __main__ as tcli
from tpu_paxos_torch.analysis import mc_control as mcc
from tpu_paxos_torch.analysis import modelcheck as mc
from tpu_paxos_torch.analysis.artifact_schema import ArtifactSchemaError
from tpu_paxos_torch.serve import control as ctl
from tpu_paxos_torch.telemetry import diagnose as diag

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")
DEV = "cpu"

TINY = {
    "tier_bands": [[3, 1, 2]], "patiences": [1], "ladders": [[]],
    "window_sets": [[], ["gray-region"], ["saturation"]],
    "burn_tiers": [0, 900], "max_dispatches": 2, "plan_values": 4,
    "chunk_lanes": 16,
}


def _committed():
    return mc.load_scopes()["control"]


def _tiny_host_scope(**over):
    return mcc.ControlScope.from_dict(dict(TINY, **over))


def _mc_gold():
    with open(GOLDENS) as f:
        return json.load(f)["mc"]


def _golden_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(ROOT, "scripts", "torch_port_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: The goldens script's normalization of a summary (timing, device and
#: artifact paths out; runner builds cut to their zero pattern).
_less = _golden_script().mc_less


# ---------------- scope parse / validate ----------------

def test_committed_control_scope_loads_and_registers():
    scope = _committed()
    assert mc.scope_type(scope) == "control"
    enum = mc.enum_for(scope)
    assert isinstance(enum, mcc.ControlEnum)
    assert enum.reduced == list(range(enum.total))
    assert enum.total == enum.host_total + enum.n_e2e


def test_validator_named_rules():
    with pytest.raises(mc.ScopeError, match="defer"):
        _tiny_host_scope(tier_bands=[[3, 2, 1]])
    with pytest.raises(mc.ScopeError, match="unknown cause name"):
        _tiny_host_scope(window_sets=[["not-a-cause"]])
    with pytest.raises(mc.ScopeError, match="ascend"):
        _tiny_host_scope(ladders=[[2, 1]])
    with pytest.raises(mc.ScopeError, match=rf"\[1, {mcc.MAX_CTL_DISPATCHES}\]"):
        _tiny_host_scope(max_dispatches=mcc.MAX_CTL_DISPATCHES + 1)
    with pytest.raises(mc.ScopeError, match="come together"):
        _tiny_host_scope(e2e_policies=[0])
    with pytest.raises(mc.ScopeError, match="outside the policy grid"):
        _tiny_host_scope(e2e_policies=[1], e2e_arrival_seeds=[0])
    with pytest.raises(mc.ScopeError, match="unknown scope field"):
        _tiny_host_scope(n_nodes=3)


# ---------------- codec ----------------

def test_sequence_codec_inverse_exhaustive():
    enum = mcc.ControlEnum(_committed())
    for r in range(enum.n_seq):
        seq = enum.seq_unrank(r)
        assert 1 <= len(seq) <= enum.scope.max_dispatches
        assert all(0 <= d < enum.n_letters for d in seq)
        assert enum.seq_rank(seq) == r


def test_scenario_codec_boundaries_and_e2e_tail():
    enum = mcc.ControlEnum(_committed())
    for i in (0, enum.host_total - 1, enum.host_total, enum.total - 1):
        sc = enum.decode(i)
        assert enum.encode(sc) == i
        assert (sc.seq is None) == (i >= enum.host_total)
    tail = enum.decode(enum.host_total)
    assert tail.e2e_seed == int(enum.scope.e2e_arrival_seeds[0])
    assert tail.policy == int(enum.scope.e2e_policies[0])
    with pytest.raises(IndexError):
        enum.decode(enum.total)


def test_policy_grid_shape_and_order():
    scope = _committed()
    pols = mcc.policy_grid(scope)
    assert len(pols) == len(scope.tier_bands) * len(scope.patiences) * len(scope.ladders)
    p0 = pols[0]
    assert (p0.n_tiers, p0.defer_tier, p0.shed_tier) == scope.tier_bands[0]
    assert p0.patience == scope.patiences[0]


# ---------------- the host oracle ----------------

def test_clean_policy_grid_certifies_over_all_letters():
    scope = _committed()
    enum = mcc.ControlEnum(scope)
    for pi in range(enum.n_policies):
        for letter in enum.letters:
            _, bits = mcc.judge_sequence(enum.policies[pi], [letter], scope.plan_values)
            assert all(bits.values()), (pi, letter, bits)


def test_gray_veto_catches_wedged_policy():
    scope = _committed()
    enum = mcc.ControlEnum(scope)
    wedged = ctl.wedged_policy(enum.policies[0])
    for names in (("gray-region",), ("gray-region", "saturation")):
        _, bits = mcc.judge_sequence(wedged, [(names, 900)], scope.plan_values)
        assert not bits["veto"]
        assert mcc.violation_of(bits) == "ctl-gray-veto"
    _, bits = mcc.judge_sequence(wedged, [(("saturation",), 900)], scope.plan_values)
    assert bits["veto"]


def test_wedge_env_arms_policy_materialization(monkeypatch):
    enum = mcc.ControlEnum(_committed())
    gray = diag.CAUSE_IDS["gray-region"]
    assert dict(enum.policy_of(0).table).get(gray) != "shed"
    monkeypatch.setenv("TPU_PAXOS_SEEDED_WEDGE", ctl.WEDGE_SHED_ON_GRAY)
    assert dict(enum.policy_of(0).table)[gray] == "shed"


def test_trail_legality_rejects_bad_trails():
    p = mcc.policy_grid(_committed())[1]
    top = p.top_level
    assert top > 0
    assert mcc._trail_legal(p, [])
    assert not mcc._trail_legal(p, [{"action": "degrade", "level": top, "degraded": True}])
    assert not mcc._trail_legal(p, [{"action": "restore", "level": top, "degraded": False}])
    assert not mcc._trail_legal(p, [{"action": "panic", "level": top, "degraded": False}])
    assert mcc._trail_legal(p, [
        {"action": "degrade", "level": top - 1, "degraded": True},
        {"action": "restore", "level": top, "degraded": False},
    ])


def test_admission_exact_over_degraded_timelines():
    for p in mcc.policy_grid(_committed()):
        assert mcc._admission_exact(p, [True, False, True, True], 6)


def test_shrink_reaches_a_single_dispatch():
    scope = _committed()
    enum = mcc.ControlEnum(scope)
    wedged = ctl.wedged_policy(enum.policies[0])
    gray_li = next(li for li, (ws, b) in enumerate(enum.letters)
                   if "gray-region" in ws and b > 0)
    quiet_li = next(li for li, (ws, _) in enumerate(enum.letters) if not ws)
    small = mcc.shrink_sequence(wedged, enum.letters, (quiet_li, gray_li, quiet_li),
                                scope.plan_values)
    assert small == (gray_li,)


# ---------------- artifact replay ----------------

def _artifact(tmp_path):
    scope = _committed()
    enum = mcc.ControlEnum(scope)
    wedged = ctl.wedged_policy(enum.policies[0])
    letters = [(("gray-region",), 900)]
    decisions, bits = mcc.judge_sequence(wedged, letters, scope.plan_values)
    path = str(tmp_path / "mc_ctl_scenario_0.json")
    mcc.save_ctl_artifact(path, scope, wedged, letters, mcc.violation_of(bits), decisions)
    return path


def test_artifact_replays_byte_identically(tmp_path, monkeypatch):
    path = _artifact(tmp_path)
    monkeypatch.delenv("TPU_PAXOS_SEEDED_WEDGE", raising=False)
    rep = mcc.reproduce(path)
    assert rep["match"] and rep["decisions_match"]
    assert rep["violation"] == rep["recorded_violation"] == "ctl-gray-veto"
    assert rep["decision_log_sha256"] == rep["recorded_sha256"]
    assert "[ctl 1] degrade" in rep["decision_log"]


def test_artifact_tamper_and_schema_errors(tmp_path):
    path = _artifact(tmp_path)
    with open(path) as f:
        art = json.load(f)
    art["decisions"] = []
    art["violation"] = "none"
    with open(path, "w") as f:
        json.dump(art, f)
    rep = mcc.reproduce(path)
    assert not rep["match"] and not rep["decisions_match"]
    bad = dict(art)
    del bad["control_log_sha256"]
    with open(path, "w") as f:
        json.dump(bad, f)
    with pytest.raises(ArtifactSchemaError, match="control_log_sha256"):
        mcc.reproduce(path)
    with open(path, "w") as f:
        json.dump(dict(art, engine="serve"), f)
    with pytest.raises(ArtifactSchemaError, match="mc-control"):
        mcc.reproduce(path)


# ---------------- host-plane run_scope ----------------

def test_run_scope_host_only_certifies_clean(tmp_path):
    """A host-only scope runs with no device work: every nibble f, no
    runner build in any chunk, and the summary equals JAX's."""
    scope = _tiny_host_scope()
    summary = mcc.run_scope(scope, triage_dir=str(tmp_path), verbose=False, device=DEV)
    assert summary["ok"]
    assert set(summary["verdict_bits"]) == {"f"}
    assert summary["scenarios_full"] == summary["scenarios_reduced"]
    assert all(c == 0 for c in summary["compiles_per_chunk"])
    assert summary["seeded_wedge"] == ""
    assert not os.listdir(tmp_path)
    assert _less(summary) == _mc_gold()["tiny_control"]["clean"]


def test_run_scope_finds_and_shrinks_the_seeded_wedge(tmp_path, monkeypatch):
    """The recall pin: with the wedge armed every gray-naming host
    scenario fails the veto, the first counterexamples shrink to one
    dispatch, and the dumped artifact replays with the env var unset.
    The summary and the artifacts' bytes equal JAX's."""
    monkeypatch.setenv("TPU_PAXOS_SEEDED_WEDGE", ctl.WEDGE_SHED_ON_GRAY)
    scope = _tiny_host_scope()
    summary = mcc.run_scope(scope, triage_dir=str(tmp_path), verbose=False,
                            max_counterexamples=3, device=DEV)
    assert not summary["ok"]
    assert summary["seeded_wedge"] == ctl.WEDGE_SHED_ON_GRAY
    cx = summary["counterexamples"][0]
    assert cx["violation"] == "ctl-gray-veto"
    assert cx["shrunk_dispatches"] == 1
    assert os.path.basename(cx["artifact"]).startswith("mc_ctl_scenario_")
    monkeypatch.delenv("TPU_PAXOS_SEEDED_WEDGE")
    rep = mcc.reproduce(cx["artifact"])
    assert rep["match"]
    assert rep["violation"] == "ctl-gray-veto"
    gold = _mc_gold()["tiny_control"]
    assert _less(summary) == gold["wedged"]
    got = {n: (tmp_path / n).read_text() for n in sorted(os.listdir(tmp_path))}
    assert got == gold["artifacts"] and len(got) == 3


# ---------------- parity with the JAX package ----------------

def _judge_all(mcc_mod, ctl_mod, scope_dict, wedged: bool):
    scope = mcc_mod.ControlScope.from_dict(scope_dict)
    enum = mcc_mod.ControlEnum(scope)
    out = []
    for pi, p in enumerate(enum.policies):
        pol = ctl_mod.wedged_policy(p) if wedged else p
        for r in range(enum.n_seq):
            letters = [enum.letters[li] for li in enum.seq_unrank(r)]
            out.append(mcc_mod.judge_sequence(pol, letters, scope.plan_values))
    return out


@pytest.mark.parametrize("wedged", [False, True], ids=["clean", "wedged"])
def test_judge_sequence_equals_jax_over_the_tiny_scope(wedged):
    """Every sequence of the tiny scope under its policy, clean and with
    the shed-on-gray wedge: the decision trail and the three bits equal
    JAX's, scenario for scenario (the wedged bits are not all true)."""
    got = _judge_all(mcc, ctl, TINY, wedged)
    assert got == _judge_all(jmcc, jctl, TINY, wedged)
    assert any(not all(bits.values()) for _, bits in got) == wedged


def test_committed_control_scope_enumerates_as_jax():
    """The committed scope's letters, policies and every scenario's
    ``describe()`` equal JAX's."""
    with open(mc.DEFAULT_SCOPE) as f:
        raw = {k: v for k, v in json.load(f)["control"].items() if k != "type"}

    def record(mod):
        scope = mod.ControlScope.from_dict(raw)
        enum = mod.ControlEnum(scope)
        return (scope.sha256(), enum.letters, enum.reduced,
                [enum.describe(enum.decode(i)) for i in enum.reduced])
    assert record(mcc) == record(jmcc)


def _in_dir(path):
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


@pytest.mark.parametrize("key", ["repro", "repro --json", "trace --stdout"])
def test_repro_and_trace_of_mc_control_artifacts_equal_the_jax_cli(key, tmp_path, capsys):
    """``repro`` routes an mc-control artifact to ``mc_control.reproduce``
    and prints JAX's stdout with its exit code; ``trace`` of one fails the
    repro schema as JAX's does (the schema error line, exit 2)."""
    gold = _mc_gold()["tiny_control"]
    name = sorted(gold["artifacts"])[0]
    (tmp_path / name).write_text(gold["artifacts"][name])
    args = key.split()
    argv = [args[0], name, *args[1:]]
    want = gold["cli"][" ".join(argv)]
    with _in_dir(tmp_path):
        rc = tcli.main(argv + ["--device", DEV])
    assert (rc, capsys.readouterr().out) == (want["rc"], want["stdout"])


# ---------------- committed scope + e2e cells (slow tier) -----------

@pytest.mark.slow
def test_control_scope_certifies_committed_with_e2e():
    from tpu_paxos_torch.fleet import envelope

    envelope.clear_cache()
    ctl.clear_cache()
    scope = _committed()
    summary = mcc.run_scope(scope, verbose=False, device=DEV)
    cert = mc.load_certificates()["control"]
    assert summary["ok"], summary["counterexamples"][:2]
    assert summary["verdict_bits_sha256"] == cert["verdict_bits_sha256"]
    assert summary["e2e_cells"] == 2
    assert summary["compiles_per_chunk"][0] > 0
    assert all(c == 0 for c in summary["compiles_per_chunk"][1:]), summary["compiles_per_chunk"]


@pytest.mark.slow
def test_cli_repro_routes_mc_control_artifacts(tmp_path):
    """A cold ``python -m tpu_paxos_torch repro`` routes engine=mc-control
    through ``analysis/mc_control.reproduce`` and exits 0 on a byte-exact
    replay."""
    path = _artifact(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "TPU_PAXOS_SEEDED_WEDGE"}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    p = subprocess.run([sys.executable, "-m", "tpu_paxos_torch", "repro", path, "--device", DEV],
                       capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "[ctl 1] degrade" in p.stdout
