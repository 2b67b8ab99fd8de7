"""The port's churn checker (``tpu_paxos_torch/analysis/mc_member.py``)
against the JAX package's: every contract of ``tests/test_mc_member.py``
mirrored on the port on the CPU (the (variant x fault-combo x seed) codec,
the churn grammar, the named feasibility rule, gray's data-driven
rejection; the committed scope certified and the counterexample dump in
the slow tier), plus exact parity with JAX: the committed churn scope's
letters, variants, reduced list and every ``describe()`` (live on both
sides, host only), and the counterexample dumps' bytes against JAX's
(``tpu_paxos_torch/data/goldens.json``)."""

import json
import os

import pytest

from tpu_paxos.analysis import mc_member as jmcm
from tpu_paxos_torch.analysis import mc_member as mcm
from tpu_paxos_torch.analysis import modelcheck as mc
from tpu_paxos_torch.membership import churn_table as ctm
from tpu_paxos_torch.membership import engine as meng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")
DEV = "cpu"

TINY = {
    "n_nodes": 3, "n_instances": 8, "max_rounds": 100, "horizon": 12,
    "plain_values": 1, "add_targets": [1], "del_targets": [1],
    "t0_grid": [0, 4], "wait_gates": [ctm.WAIT_NONE, ctm.WAIT_APPLIED],
    "max_events": 2,
}


def _committed():
    return mc.load_scopes()["churn"]


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

def test_committed_churn_scope_loads_and_registers():
    scope = _committed()
    assert mc.scope_type(scope) == "churn"
    assert isinstance(mc.enum_for(scope), mcm.ChurnEnum)
    assert mcm.ChurnScope.from_dict(
        {k: v for k, v in scope.to_dict().items() if k != "type"}
    ).sha256() == scope.sha256()


def test_gray_rejected_by_the_data_driven_table():
    assert "gray" in mcm.MEMBER_UNSUPPORTED_KINDS
    with pytest.raises(mc.ScopeError) as ei:
        mcm.ChurnScope.from_dict(dict(TINY, kinds=["gray"], intervals=[[2, 8]]))
    assert mcm.MEMBER_UNSUPPORTED_KINDS["gray"] in str(ei.value)
    for kind in mc.UNSUPPORTED_KINDS:
        with pytest.raises(mc.ScopeError, match="churn checker"):
            mcm.ChurnScope.from_dict(dict(TINY, kinds=[kind], intervals=[[2, 8]]))


def test_validator_named_rules():
    with pytest.raises(mc.ScopeError, match="node 0"):
        mcm.ChurnScope.from_dict(dict(TINY, add_targets=[0]))
    with pytest.raises(mc.ScopeError, match="subset of add_targets"):
        mcm.ChurnScope.from_dict(dict(TINY, del_targets=[2]))
    with pytest.raises(mc.ScopeError, match="horizon"):
        mcm.ChurnScope.from_dict(dict(TINY, t0_grid=[12]))
    with pytest.raises(mc.ScopeError, match="wait_gates"):
        mcm.ChurnScope.from_dict(dict(TINY, wait_gates=[7]))
    with pytest.raises(mc.ScopeError, match=rf"\[1, {ctm.MAX_EVENTS}\]"):
        mcm.ChurnScope.from_dict(dict(TINY, max_events=ctm.MAX_EVENTS + 1))
    with pytest.raises(mc.ScopeError, match="no churn letters"):
        mcm.ChurnScope.from_dict(dict(TINY, plain_values=0, add_targets=[], del_targets=[]))
    with pytest.raises(mc.ScopeError, match="unknown scope field"):
        mcm.ChurnScope.from_dict(dict(TINY, proposers=2))


# ---------------- codec ----------------

def test_codec_bijection_exhaustive_committed():
    enum = mcm.ChurnEnum(_committed())
    for i in range(enum.total):
        assert enum.encode(enum.decode(i)) == i
    for bad in (-1, enum.total):
        with pytest.raises(IndexError):
            enum.decode(bad)


def test_codec_boundaries_at_churn_grid_edges():
    enum = mcm.ChurnEnum(_committed())
    per_variant = enum.n_fault_combos * enum.n_seeds
    for vi in range(enum.n_variants):
        lo = enum.decode(vi * per_variant)
        hi = enum.decode((vi + 1) * per_variant - 1)
        assert lo.variant == hi.variant == vi
        assert lo.seed == 0
        assert mc.combo_rank(lo.combo, enum.m, enum.scope.max_fault_episodes) == 0
        assert hi.seed == enum.n_seeds - 1
        assert mc.combo_rank(hi.combo, enum.m, enum.scope.max_fault_episodes) == \
            enum.n_fault_combos - 1


def test_variant_zero_is_the_fault_only_baseline():
    enum = mcm.ChurnEnum(_committed())
    assert enum.variants[0] is None
    sc = enum.decode(0)
    assert sc.variant == 0
    assert enum.churn_of(sc) is None


# ---------------- variant grammar ----------------

def test_variants_obey_the_schedule_grammar():
    scope = _committed()
    enum = mcm.ChurnEnum(scope)
    assert enum.n_variants == len(set(map(str, enum.variants)))
    for vi in range(1, enum.n_variants):
        churn = enum.churn_of(mcm.ChurnScenario(0, vi, (), 0))
        vids = [e.vid for e in churn.events]
        assert len(vids) == len(set(vids)), vi
        assert churn.events[0].wait == ctm.WAIT_NONE, vi
        assert all(e.wait in scope.wait_gates for e in churn.events[1:]), vi
        added = set()
        for e in churn.events:
            if e.vid >= meng.CHANGE_BASE:
                node, kind = meng.decode_change(e.vid)
                if kind == meng.DEL_ACCEPTOR:
                    assert node in added, vi
                else:
                    added.add(node)


def test_plain_and_change_vids_never_collide():
    scope = _committed()
    assert mcm.PLAIN_VID_BASE + scope.plain_values <= meng.CHANGE_BASE
    enum = mcm.ChurnEnum(scope)
    plain = {mcm.PLAIN_VID_BASE + arg for kind, arg, _ in enum.letters if kind == mcm.EV_PLAIN}
    change = {
        meng.change_vid(arg, k)
        for kind, arg, _ in enum.letters if kind != mcm.EV_PLAIN
        for k in (meng.ADD_ACCEPTOR, meng.DEL_ACCEPTOR)
    }
    assert not plain & change


# ---------------- feasibility ----------------

def test_feasibility_excludes_protected_crashes():
    enum = mcm.ChurnEnum(_committed())
    assert len(enum.reduced) < enum.total
    reduced = set(enum.reduced)
    for i in range(enum.total):
        sc = enum.decode(i)
        protected = {0} | enum.variant_targets(sc.variant)
        crashes = {
            n
            for ci in sc.combo
            for n in enum.fault_alphabet[ci].nodes
            if enum.fault_alphabet[ci].kind == "crash"
        }
        assert (i in reduced) == (not crashes & protected), i


def test_describe_names_the_scenario():
    enum = mcm.ChurnEnum(_committed())
    sc = enum.decode(enum.reduced[-1])
    d = enum.describe(sc)
    assert d["index"] == sc.index
    assert {e["kind"] for e in d["events"]} <= {mcm.EV_PLAIN, mcm.EV_ADD, mcm.EV_DEL}
    assert d["seed"] == int(enum.scope.seeds[sc.seed])
    json.dumps(d)


# ---------------- parity with the JAX package ----------------

def _enum_record(mod, scope_dict):
    scope = mod.ChurnScope.from_dict(scope_dict)
    enum = mod.ChurnEnum(scope)
    churns = []
    for vi in range(enum.n_variants):
        c = enum.churn_of(mod.ChurnScenario(0, vi, (), 0))
        churns.append(None if c is None else [(e.vid, e.t0, e.wait) for e in c.events])
    return {
        "sha256": scope.sha256(),
        "letters": enum.letters,
        "variants": [None if v is None else [list(v[0]), list(v[1])] for v in enum.variants],
        "churns": churns,
        "reduced": enum.reduced,
        "describe": [enum.describe(enum.decode(i)) for i in enum.reduced],
    }


def test_committed_churn_scope_enumerates_as_jax():
    """Letters, variants, their materialized churn schedules, the reduced
    list and every reduced scenario's ``describe()`` equal JAX's."""
    with open(mc.DEFAULT_SCOPE) as f:
        raw = {k: v for k, v in json.load(f)["churn"].items() if k != "type"}
    assert _enum_record(mcm, raw) == _enum_record(jmcm, raw)


def test_churn_counterexample_dumps_equal_jax_bytes(tmp_path):
    """A budget too small to finish churn fails every churn-bearing lane:
    the summary and the ``mc_member_scenario_<index>.json`` dumps (scope
    hash, verdict, the lane's decision-log sha256) equal JAX's byte for
    byte."""
    mc_gold = _mc_gold()
    gold, conf = mc_gold["churn_cx"], mc_gold["config"]
    s = mcm.run_scope(mcm.ChurnScope.from_dict(conf["churn_cx"]), triage_dir=str(tmp_path),
                      verbose=False, max_counterexamples=conf["churn_cx_max"], device=DEV)
    assert _less(s) == gold["summary"]
    got = {n: (tmp_path / n).read_text() for n in sorted(os.listdir(tmp_path))}
    assert got == gold["artifacts"] and len(got) == conf["churn_cx_max"]


# ---------------- device dispatch (slow tier) ----------------

@pytest.mark.slow
def test_churn_scope_certifies_clean_on_device():
    from tpu_paxos_torch.fleet import envelope

    envelope.clear_cache()
    scope = _committed()
    summary = mcm.run_scope(scope, verbose=False, device=DEV)
    cert = mc.load_certificates()["churn"]
    assert summary["ok"], summary["counterexamples"][:2]
    assert summary["verdict_bits_sha256"] == cert["verdict_bits_sha256"]
    assert summary["scenarios_reduced"] == cert["scenarios_reduced"]
    assert summary["compiles_per_chunk"][0] > 0
    assert all(c == 0 for c in summary["compiles_per_chunk"][1:]), summary["compiles_per_chunk"]


@pytest.mark.slow
def test_churn_counterexample_dumps_named_artifact(tmp_path):
    """A convergence budget too small to finish churn fails the
    churn-bearing lanes: the counterexample path dumps deterministic
    ``mc_member_scenario_<index>.json`` artifacts carrying the scope hash
    and the lane's decision-log sha.  The scope adds nodes 1 and 2 over
    two events: the JAX test's own grid (one plain value, no add) decides
    within its 4 rounds in both packages, so it finds nothing to dump."""
    scope = mcm.ChurnScope.from_dict({
        "n_nodes": 3, "n_instances": 8, "max_rounds": 4, "horizon": 2,
        "plain_values": 1, "add_targets": [1, 2], "t0_grid": [0],
        "max_events": 2, "seeds": [0], "chunk_lanes": 4,
    })
    summary = mcm.run_scope(scope, triage_dir=str(tmp_path), verbose=False,
                            max_counterexamples=2, device=DEV)
    assert not summary["ok"]
    cx = summary["counterexamples"][0]
    assert os.path.basename(cx["artifact"]).startswith("mc_member_scenario_")
    with open(cx["artifact"]) as f:
        art = json.load(f)
    assert art["scope_sha256"] == scope.sha256()
    assert art["decision_log_sha256"] == cx["decision_log_sha256"]
