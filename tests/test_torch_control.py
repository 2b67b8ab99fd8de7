"""The port's admission controller (``tpu_paxos_torch/serve/control.py``)
against the JAX package's (``tpu_paxos/serve/control.py``), on the CPU.

Every non-slow test of ``tests/test_control.py`` is mirrored here, port
against JAX on the same inputs, at its module geometry (3 nodes, 48
instances, two 10-value streams, R = 8, S = 2, K = 10, 32-round
buckets): the stable cause codes, the policy plane and ``decide`` on
seeded cause schedules, ``ControlledPlan``'s shed/defer ledger, the
inert-controller parity with ``serve_run`` and ``serve_fleet_run``, the
controlled run and its artifact (saved bytes equal to JAX's), the serve
artifact schema, the sweep verdict's floor rule and the fleet's
argument checks, the bench record's guards and its committed record.
Beside them: the committed ``artifacts/serve_control_spike.json``
replays through the port to its ``decision_log_sha256``; ``spike_ab`` at
``bench.py``'s configuration gives ``BENCH_serve_control.json`` (through
JAX's own ``bench._serve_control_record``); an armed policy with a defer
band and a ladder makes JAX's decisions and shed records; a mid-run JAX
loop state (``interop.control_state_from_jax``) continues in the port
dispatch for dispatch; a controlled fleet that sheds equals JAX's lane
for lane; the window cache builds once for an A/B's twins.  All equality
is exact: the state is integer and the judges' floats are the same
float64 host arithmetic.

JAX runs are shared: each is made once per module (``_jax_*``), at the
shapes test_control.py compiles.
"""

import copy
import dataclasses
import functools
import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_paxos import config as jcfg
from tpu_paxos.analysis import artifact_schema as jschema
from tpu_paxos.serve import arrivals as jarr
from tpu_paxos.serve import control as jctl
from tpu_paxos.serve import fleet as jfl
from tpu_paxos.serve import harness as jh
from tpu_paxos.telemetry import diagnose as jdg
from tpu_paxos.utils import prng as jprng
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch import interop
from tpu_paxos_torch.analysis import artifact_schema as tschema
from tpu_paxos_torch.fleet import envelope as tenv
from tpu_paxos_torch.replay.decision_log import decision_log
from tpu_paxos_torch.serve import arrivals as tarr
from tpu_paxos_torch.serve import control as tctl
from tpu_paxos_torch.serve import fleet as tfl
from tpu_paxos_torch.serve import harness as th
from tpu_paxos_torch.telemetry import diagnose as tdg
from tpu_paxos_torch.utils import prng as tprng

WL = [np.arange(0, 10, dtype=np.int32), np.arange(20, 30, dtype=np.int32)]
R_WINDOW = 8
S_DISPATCH = 2
ADMIT_W = 10
W_ROUNDS = 32

SAT = tdg.CAUSE_IDS["saturation"]
GRAY = tdg.CAUSE_IDS["gray-region"]
DUEL = tdg.CAUSE_IDS["duel-churn"]
PART = tdg.CAUSE_IDS["partition"]

SPIKE_ARTIFACT = "artifacts/serve_control_spike.json"
SPIKE_SHA = "f2dfeea4cc96373d8ab4212230a0183997e1f0d54e308ff74ea4ca800de29a64"


def _cfgs(seed=3):
    kw = dict(n_nodes=3, n_instances=48, proposers=(0, 1), seed=seed, max_rounds=4000)
    return (
        jcfg.SimConfig(faults=jcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2), **kw),
        tcfg.SimConfig(faults=tcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2), **kw),
    )


def _arrs(seed=7, rate=4000):
    rounds = jarr.poisson_rounds(20, rate, seed)
    return [np.sort(rounds[0::2]), np.sort(rounds[1::2])]


def _sha(cv, cb):
    return hashlib.sha256(
        decision_log(cv, cb, stride=30, n_instances=len(cv)).encode()
    ).hexdigest()


def _geom():
    return dict(rounds_per_window=R_WINDOW, windows_per_dispatch=S_DISPATCH,
                admit_width=ADMIT_W, window_rounds=W_ROUNDS)


_REPORT_FIELDS = (
    "n_values", "rounds_per_window", "windows_per_dispatch", "admit_width", "window_rounds",
    "ladder", "dispatches", "rounds", "done", "decided_values", "shed_count", "p50", "p99",
    "latency_max", "summary", "windows", "slo", "decisions", "sheds", "window_decided",
    "decision_log_sha256", "slo_first_breach_dispatch", "backlog",
)


def assert_same_report(got, want):
    for f in _REPORT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.chosen_vid, np.asarray(want.chosen_vid))
    np.testing.assert_array_equal(got.chosen_ballot, np.asarray(want.chosen_ballot))


# ---- the JAX side, once per module ----


@functools.lru_cache(maxsize=None)
def _jax_inert():
    return jctl.controlled_serve_run(_cfgs()[0], WL, _arrs(), control=None, **_geom())


@functools.lru_cache(maxsize=None)
def _jax_armed():
    return jctl.controlled_serve_run(
        _cfgs()[0], WL, _arrs(), control=jctl.ControlPolicy(),
        slo=jh.ServeSLO(latency_rounds=16, budget_milli=150), **_geom())


def _port_armed():
    return tctl.controlled_serve_run(
        _cfgs()[1], WL, _arrs(), control=tctl.ControlPolicy(),
        slo=th.ServeSLO(latency_rounds=16, budget_milli=150), device="cpu", **_geom())


#: The defer-band case: bench.py's spike config (3 nodes, 2048 instances,
#: assign_window 8, 1000 values, 4x spike over the middle half) under a
#: policy with a defer band (tier 1) and a two-step ladder (S in {1, 2}).
_DEFER = dict(n=1000, rate=2000, factor=4, start=0.25, length=0.5)


def _defer_inputs(arr_mod):
    rounds = arr_mod.spike_rounds(_DEFER["n"], _DEFER["rate"], 0, factor=_DEFER["factor"],
                                  start_frac=_DEFER["start"], len_frac=_DEFER["length"])
    vids = np.arange(_DEFER["n"], dtype=np.int32)
    streams, arrs = arr_mod.split_round_robin(vids, rounds, 2)
    prios = arr_mod.tier_priorities(vids, 3)
    return streams, arrs, [prios[0::2], prios[1::2]]


def _bench_cfg(cfgm):
    return cfgm.SimConfig(n_nodes=3, n_instances=2048, proposers=(0, 1), seed=3,
                          max_rounds=8000, assign_window=8)


def _defer_run(pkg, cfgm, arr_mod, **dev):
    streams, arrs, prios = _defer_inputs(arr_mod)
    return pkg.controlled_serve_run(
        _bench_cfg(cfgm), streams, arrs, priorities=prios,
        control=pkg.ControlPolicy(n_tiers=3, defer_tier=1, shed_tier=2, ladder=(1, 2)),
        slo=(jh if pkg is jctl else th).ServeSLO(latency_rounds=16, budget_milli=150),
        rounds_per_window=4, window_rounds=32, **dev)


@functools.lru_cache(maxsize=None)
def _jax_defer():
    return _defer_run(jctl, jcfg, jarr)


@pytest.fixture(scope="module")
def port_ab(tmp_path_factory):
    """bench.py's spike A/B (``bench_serve_control_record``), through the
    port, its artifact saved and replayed."""
    return tctl.spike_ab(
        _bench_cfg(tcfg), 1000, 2000, slo=th.ServeSLO(latency_rounds=16, budget_milli=150),
        seed=0, rounds_per_window=4, windows_per_dispatch=2, spike_factor=4,
        spike_start_frac=0.25, spike_len_frac=0.5, window_rounds=32,
        artifact_path=str(tmp_path_factory.mktemp("ab") / "spike.json"), device="cpu",
    )


def _bench_config(ab):
    """``bench_serve_control_record``'s config block for this A/B."""
    return {
        "n_nodes": 3, "n_instances": 2048, "assign_window": 8, "n_values": 1000,
        "rate_milli": 2000, "spike_factor": 4, "spike_start_frac": 0.25,
        "spike_len_frac": 0.5, "rounds_per_window": 4, "windows_per_dispatch": 2,
        "window_rounds": 32, "admit_width": ab["admit_width"],
        "faults": "none (gray-region must stay quiet for the never-shed-on-gray clause to "
                  "be a live check)",
        "arrivals": "poisson + mid-run spike", "slo": ab["slo"],
        "latency_unit": "rounds (virtual clock)", "devices": 1, "platform": "cpu",
    }


# ---------------- stable cause codes --------------------------------


def test_cause_ids_pinned_exactly():
    assert tdg.CAUSE_IDS == jdg.CAUSE_IDS == {
        "unknown": 0, "duel-churn": 1, "gray-region": 2, "partition": 3, "saturation": 4,
    }
    assert tdg.CAUSE_NAMES == jdg.CAUSE_NAMES and tdg.CAUSE_NAMES[4] == "saturation"
    for name in ("gray-region", "never-heard-of-it", "saturation"):
        assert tdg.cause_code(name) == jdg.cause_code(name)
    assert tdg.cause_code("never-heard-of-it") == tdg.CAUSE_IDS["unknown"]


# ---------------- policy declaration --------------------------------


def test_policy_defaults_and_table():
    p = tctl.ControlPolicy()
    assert p.table == jctl.ControlPolicy().table == tctl.default_table() == jctl.default_table()
    t = dict(p.table)
    assert (t[SAT], t[GRAY], t[DUEL], t[PART]) == ("shed", "never", "hold", "hold")
    assert tctl.ACTIONS == jctl.ACTIONS and tctl.DECISION_ACTIONS == jctl.DECISION_ACTIONS
    assert tctl.LOG_STRIDE == jctl.LOG_STRIDE
    assert tctl.policy_to_dict(p) == jctl.policy_to_dict(jctl.ControlPolicy())


def test_policy_validation_rejects_bad_shapes():
    for kw in (dict(n_tiers=2, defer_tier=2, shed_tier=1), dict(ladder=(4, 2)),
               dict(table=((SAT, "explode"),)), dict(table=((SAT, "shed"), (SAT, "hold"))),
               dict(n_tiers=0), dict(patience=0), dict(ladder=(0, 2)), dict(table=((9, "shed"),))):
        with pytest.raises(ValueError) as je:
            jctl.ControlPolicy(**kw)
        with pytest.raises(ValueError) as te:
            tctl.ControlPolicy(**kw)
        assert str(te.value) == str(je.value)


def test_policy_dict_roundtrip_exact():
    kw = dict(n_tiers=4, defer_tier=2, shed_tier=3, burn_low_milli=250, patience=3,
              ladder=(1, 2, 4))
    p = tctl.ControlPolicy(**kw)
    assert tctl.policy_from_dict(tctl.policy_to_dict(p)) == p
    assert tctl.policy_to_dict(p) == jctl.policy_to_dict(jctl.ControlPolicy(**kw))
    w = tctl.wedged_policy(p)
    assert tctl.policy_to_dict(w) == jctl.policy_to_dict(jctl.wedged_policy(jctl.ControlPolicy(**kw)))
    assert dict(w.table)[GRAY] == "shed"
    assert tctl.WEDGE_SHED_ON_GRAY == jctl.WEDGE_SHED_ON_GRAY and not tctl.seeded_policy_wedge()


# ---------------- decide(): the cause-aware policy table ------------


def _decide_both(policy_kw, steps):
    """Run ``decide`` over ``steps`` ((dispatch, burn_milli, new_windows))
    in both packages from the top level; returns the port's records and
    states after each step, asserted equal to JAX's."""
    out = []
    tp, jp = tctl.ControlPolicy(**policy_kw), jctl.ControlPolicy(**policy_kw)
    ts, js = tctl.ControllerState(level=tp.top_level), jctl.ControllerState(level=jp.top_level)
    for d, burn, new in steps:
        tr = tctl.decide(tp, ts, dispatch=d, burn_milli=burn, new_windows=new)
        jr = jctl.decide(jp, js, dispatch=d, burn_milli=burn, new_windows=new)
        assert tr == jr
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        out.append((tr, dataclasses.replace(ts)))
    return out


def test_decide_sheds_on_saturation():
    (rec, st), = _decide_both({}, [(3, 2000, [(5, (SAT,))])])
    assert rec["action"] == "degrade" and rec["windows"] == [5] and rec["cause_ids"] == [SAT]
    assert st.degraded


def test_decide_never_sheds_on_gray_region():
    (rec, st), = _decide_both({}, [(3, 2000, [(5, (GRAY,))])])
    assert rec["action"] == "hold" and not st.degraded


def test_decide_gray_vetoes_saturation_in_same_window():
    (rec, st), = _decide_both({}, [(3, 2000, [(5, (SAT, GRAY))])])
    assert rec["action"] == "hold" and not st.degraded


def test_decide_holds_through_duel_churn_and_partition():
    for code in (DUEL, PART):
        (rec, st), = _decide_both({}, [(2, 2000, [(1, (code,))])])
        assert rec["action"] == "hold" and not st.degraded and st.calm == 0


def test_decide_restore_after_patience_calm_dispatches():
    steps = _decide_both({"patience": 2}, [(1, 2000, [(0, (SAT,))]), (2, 0, []), (3, 0, [])])
    assert steps[0][1].degraded and steps[1][0] is None
    assert steps[2][0]["action"] == "restore" and not steps[2][1].degraded
    hot = _decide_both({"patience": 2}, [(1, 2000, [(0, (SAT,))]), (2, 0, []), (3, 9000, [])])
    assert hot[-1][1].calm == 0 and hot[-1][1].degraded


def test_decide_ladder_steps_down_then_back_up():
    steps = _decide_both({"ladder": (1, 2, 4), "patience": 1}, [
        (1, 2000, [(0, (SAT,))]), (2, 2000, [(1, (SAT,))]), (3, 2000, [(2, (SAT,))]),
        (4, 0, []), (5, 0, []), (6, 0, []),
    ])
    assert [st.level for _, st in steps[:3]] == [1, 0, 0]
    assert steps[-1][1].level == 2 and not steps[-1][1].degraded


# ---------------- ControlledPlan: the admission queue ---------------


def _plans(prios=None, rate=500, n=12):
    vids = np.arange(n, dtype=np.int32)
    rounds = jarr.poisson_rounds(n, rate, 5) if rate else jarr.immediate_rounds(n)
    streams, arrs = jarr.split_round_robin(vids, rounds, 2)
    pr = None if prios is None else [
        np.asarray([prios[int(v)] for v in s], np.int32) for s in streams]
    return (streams, arrs, tctl.ControlledPlan(streams, arrs, pr, R_WINDOW),
            jctl.ControlledPlan(streams, arrs, pr, R_WINDOW))


def _take_both(tp, jp, j, k, **floors):
    got, want = tp.take(j, k, **floors), jp.take(j, k, **floors)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tp.shed_records == jp.shed_records and tp.queued == jp.queued
    assert tp.exhausted == jp.exhausted
    return got


def test_controlled_plan_inert_matches_arrival_plan_block():
    streams, arrs, tp, jp = _plans()
    ap = tarr.ArrivalPlan(streams, arrs, R_WINDOW)
    assert (tp.n_windows, tp.max_block, tp.n_values) == (jp.n_windows, jp.max_block, jp.n_values)
    for j in range(ap.n_windows):
        admit, arr = ap.block(j, ADMIT_W)
        a2, r2, keep = _take_both(tp, jp, j, ADMIT_W)
        np.testing.assert_array_equal(admit, a2)
        np.testing.assert_array_equal(arr, r2)
        assert keep[a2 != tarr.NONE].all() and not keep[a2 == tarr.NONE].any()
    assert tp.exhausted and tp.shed_count == 0


def test_controlled_plan_window_order_enforced():
    _, _, tp, jp = _plans()
    _take_both(tp, jp, 0, ADMIT_W)
    with pytest.raises(ValueError) as te:
        tp.take(2, ADMIT_W)
    with pytest.raises(ValueError) as je:
        jp.take(2, ADMIT_W)
    assert str(te.value) == str(je.value)


def test_controlled_plan_shed_floor_sheds_declared_tier_once():
    prios = {v: (2 if v % 3 == 2 else 0) for v in range(12)}
    _, _, tp, jp = _plans(prios)
    admitted, j = [], 0
    while not tp.exhausted:
        admit, _, keep = _take_both(tp, jp, j, ADMIT_W, shed_floor=2)
        admitted += [int(v) for v in admit[keep]]
        j += 1
    shed = [r["vid"] for r in tp.shed_records]
    assert sorted(admitted + shed) == list(range(12))
    assert set(shed) == {v for v, t in prios.items() if t == 2}
    assert tp.shed_count == len(shed) == jp.shed_count
    assert all(r["tier"] == 2 for r in tp.shed_records)


def test_controlled_plan_defer_charges_true_arrival():
    prios = {v: (1 if v < 4 else 0) for v in range(12)}
    streams, arrs, tp, jp = _plans(prios)
    orig = {int(v): int(r) for s, a in zip(streams, arrs) for v, r in zip(s, a)}
    seen, j = {}, 0
    while not tp.exhausted:
        floors = {"defer_floor": 1} if j == 0 else {}
        admit, arr, keep = _take_both(tp, jp, j, ADMIT_W, **floors)
        seen.update({int(v): int(r) for v, r in zip(admit[keep], arr[keep])})
        j += 1
    assert seen == orig and tp.shed_count == 0


def test_controlled_plan_deferred_rejoin_ahead_fifo_within_tier():
    streams, _, tp, jp = _plans({v: 1 for v in range(12)})
    _, _, k0 = _take_both(tp, jp, 0, ADMIT_W, defer_floor=1)
    assert not k0.any()
    order, j = {0: [], 1: []}, 1
    while not tp.exhausted:
        admit, _, keep = _take_both(tp, jp, j, ADMIT_W)
        for pi in range(2):
            order[pi] += [int(v) for v in admit[pi][keep[pi]]]
        j += 1
    for pi, s in enumerate(streams):
        assert order[pi] == [int(v) for v in s]


def test_controlled_plan_width_spill_stays_queued():
    _, _, tp, jp = _plans(rate=0)
    got, j = [], 0
    while not tp.exhausted:
        admit, _, keep = _take_both(tp, jp, j, 3)
        assert keep.sum() <= 6
        got += [int(v) for v in admit[keep]]
        j += 1
    assert sorted(got) == list(range(12))


# ---------------- inert parity + determinism (engine) ---------------


def test_inert_controller_decision_log_sha_matches_serve_run():
    """Controller-off is the plain serving path, decision for decision,
    and equals JAX's inert controlled run field for field."""
    _, tc = _cfgs()
    base = th.serve_run(tc, WL, _arrs(), device="cpu", **_geom())
    rep = tctl.controlled_serve_run(tc, WL, _arrs(), control=None, device="cpu", **_geom())
    assert rep.decisions == [] and rep.shed_count == 0
    assert _sha(rep.chosen_vid, rep.chosen_ballot) == _sha(base.chosen_vid, base.chosen_ballot)
    assert rep.decision_log_sha256 == hashlib.sha256(
        (decision_log(rep.chosen_vid, rep.chosen_ballot, stride=30,
                      n_instances=len(rep.chosen_vid)) + tctl.control_log([])).encode()
    ).hexdigest()
    assert_same_report(rep, _jax_inert())


def test_controlled_run_deterministic_and_artifact_replays(tmp_path):
    a, b = _port_armed(), _port_armed()
    assert a.decision_log_sha256 == b.decision_log_sha256 and a.decisions == b.decisions
    assert_same_report(a, _jax_armed())
    path, jpath = str(tmp_path / "ctl.json"), str(tmp_path / "ctl_jax.json")
    art = tctl.save_artifact(path, a)
    tschema.validate_artifact(art)
    jctl.save_artifact(jpath, _jax_armed())
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()  # the artifact bytes JAX writes
    out = tctl.reproduce(path, device="cpu")
    assert out["match"] and out["decisions_match"]
    assert out["decision_log_sha256"] == a.decision_log_sha256
    assert tctl.reproduce(jpath, device="cpu")["match"]


# ---------------- artifact schema: serve block ----------------------


def _serve_art():
    with open(SPIKE_ARTIFACT) as f:
        return json.load(f)


def _same_rejection(art):
    with pytest.raises(jschema.ArtifactSchemaError) as je:
        jschema.validate_artifact(art)
    with pytest.raises(tschema.ArtifactSchemaError) as te:
        tschema.validate_artifact(art)
    assert (te.value.field, te.value.problem) == (je.value.field, je.value.problem)
    return te.value


def test_committed_spike_artifact_schema_valid():
    tschema.validate_artifact(_serve_art())
    tart = tctl.load_artifact(SPIKE_ARTIFACT)
    assert tart == jctl.load_artifact(SPIKE_ARTIFACT)


def test_serve_engine_requires_serve_block_and_vice_versa():
    a = copy.deepcopy(_serve_art())
    del a["serve"]
    _same_rejection(a)
    b = copy.deepcopy(_serve_art())
    b["engine"] = "sim"
    _same_rejection(b)


def test_serve_block_is_schema_closed():
    art = copy.deepcopy(_serve_art())
    art["serve"]["control"]["surprise"] = 1
    assert "surprise" in str(_same_rejection(art))
    art2 = copy.deepcopy(_serve_art())
    art2["serve"]["control"]["table"][0]["action"] = "explode"
    _same_rejection(art2)


def test_serve_arrivals_rows_must_match_workload():
    art = copy.deepcopy(_serve_art())
    art["serve"]["arrivals"] = art["serve"]["arrivals"][:1]
    _same_rejection(art)


# ---------------- fleet: controlled lanes + sweep verdict -----------


def _fleet_kw(pkg, slo_lat=128):
    return dict(_geom(), slo=pkg.ServeSLO(latency_rounds=slo_lat, budget_milli=150))


def _spike_lane(seed, aseed, n=400):
    rounds = jarr.spike_rounds(n, 2000, aseed, factor=4, start_frac=0.25, len_frac=0.5)
    streams, arrs = jarr.split_round_robin(np.arange(n, dtype=np.int32), rounds, 2)
    return (streams, arrs, seed)


#: name -> (cfg keywords, lanes, policy keywords, run keywords): "inert"
#: is test_control.py's; "armed" two spike lanes on an admission-capped
#: engine (3 nodes, 1024 instances, assign_window 8) under a policy with
#: a defer band, the bench A/B's windows and SLO.
_FLEETS = {
    "inert": ({}, [(WL, _arrs(), 0), (WL, _arrs(), 1)], {}, {}),
    "armed": (
        dict(n_instances=1024, max_rounds=8000, assign_window=8, faults=None),
        [_spike_lane(3, 0), _spike_lane(4, 1)],
        {"n_tiers": 3, "defer_tier": 1, "shed_tier": 2},
        dict(rounds_per_window=4, windows_per_dispatch=2, admit_width=None, window_rounds=32,
             slo_lat=16),
    ),
}


def _fleet_args(name, cfgm, h):
    over, lanes, policy, run = _FLEETS[name]
    cfg = _cfgs()[0 if cfgm is jcfg else 1]
    if over:
        over = dict(over)
        over["faults"] = cfgm.FaultConfig()
        cfg = dataclasses.replace(cfg, **over)
    run = dict(run)
    kw = _fleet_kw(h, run.pop("slo_lat", 128))
    kw.update(run)
    return cfg, lanes, policy, kw


@functools.lru_cache(maxsize=None)
def _jax_fleet(name):
    cfg, lanes, policy, kw = _fleet_args(name, jcfg, jh)
    return jctl.controlled_fleet_run(cfg, [jfl.ServeLane(*ln) for ln in lanes],
                                     control=jctl.ControlPolicy(**policy), **kw)


def _port_fleet(name):
    cfg, lanes, policy, kw = _fleet_args(name, tcfg, th)
    return tctl.controlled_fleet_run(cfg, [tfl.ServeLane(*ln) for ln in lanes],
                                     control=tctl.ControlPolicy(**policy), device="cpu", **kw)


def _same_fleet(got, want):
    for f in ("n_lanes", "seeds", "dispatches", "rounds", "done", "n_values",
              "first_breach_dispatch", "decisions", "sheds", "shed_total", "lane_shed",
              "backlog", "slo", "admit_width", "window_rounds"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.decided, np.asarray(want.decided))
    np.testing.assert_array_equal(got.breach, np.asarray(want.breach))
    for i in range(got.n_lanes):
        for g, w in zip(got.lane_chosen(i), want.lane_chosen(i)):
            np.testing.assert_array_equal(g, np.asarray(w))
        assert got.lane_summary(i) == want.lane_summary(i)


def test_controlled_fleet_inert_matches_serve_fleet():
    _, tc = _cfgs()
    lanes = [tfl.ServeLane(WL, _arrs(), 0), tfl.ServeLane(WL, _arrs(), 1)]
    base = tfl.serve_fleet_run(tc, lanes, device="cpu", **_fleet_kw(th))
    rep = _port_fleet("inert")
    assert isinstance(rep, tctl.ControlFleetReport)
    assert rep.shed_total == 0 and rep.lane_shed == [0, 0]
    assert rep.done and rep.backlog == 0
    for i in range(2):
        assert _sha(*rep.lane_chosen(i)) == _sha(*base.lane_chosen(i))
    _same_fleet(rep, _jax_fleet("inert"))


def test_controlled_fleet_that_sheds_equals_jax_lane_for_lane():
    """Two spike lanes on an admission-capped engine under a policy with
    a defer band: the per-lane decisions, shed records and counts, the
    host-confirmed verdicts and every lane's decisions and summary equal
    JAX's; the device shed counter equals the host ledger."""
    rep = _port_fleet("armed")
    _same_fleet(rep, _jax_fleet("armed"))
    assert rep.shed_total > 0 and any(d["action"] == "degrade" for d in rep.decisions)
    ctl = rep.final.ctl.numpy()
    assert ctl[:, 0].tolist() == rep.lane_shed
    assert (ctl[:, 1] + ctl[:, 0]).tolist() == rep.n_values


def _verdict_summary(ctl_mod, *, controlled, floor_shed=0, floor_slo_ok=True,
                     high_slo_ok=False, sustained=True):
    def pt(rate, shed, ok):
        p = {"rate_milli": rate, "sustained": sustained, "slo": {"0": {"ok": ok}}}
        if controlled:
            p["shed"] = shed
        return p

    s = {"cells": {"1": {"points": [pt(1000, floor_shed, floor_slo_ok), pt(8000, 5, high_slo_ok)]}}}
    if controlled:
        s["control"] = ctl_mod.policy_to_dict(ctl_mod.ControlPolicy())
    return s


def test_sweep_verdict_floor_shed_cannot_exit_zero():
    cases = [
        (dict(controlled=True, floor_shed=0), True),
        (dict(controlled=True, floor_shed=3), False),
        (dict(controlled=True, floor_slo_ok=False), False),
        (dict(controlled=True, high_slo_ok=False), True),
        (dict(controlled=False, high_slo_ok=False), False),
        (dict(controlled=False, high_slo_ok=True), True),
        (dict(controlled=False, sustained=False), False),
    ]
    for kw, want in cases:
        assert tfl.sweep_verdict(_verdict_summary(tctl, **kw)) is want
        assert jfl.sweep_verdict(_verdict_summary(jctl, **kw)) is want
    assert not tfl.sweep_verdict({"cells": {}})


def test_controlled_sweep_equals_jax():
    """``sweep_fleet_load(control=)``: the (lanes x rates) surface with
    every cell controlled carries JAX's shed and decision ledgers and
    ``control`` block, the floor-rule verdict is JAX's, and the warm sweep
    builds no runner (every cell on the one ``serve_control_for``)."""
    jc, tc = _cfgs()
    kw = dict(rounds_per_window=R_WINDOW, windows_per_dispatch=S_DISPATCH, admit_width=ADMIT_W,
              seed=1)
    want = jfl.sweep_fleet_load(jc, 12, [2], [1500, 6000], slo=jh.ServeSLO(latency_rounds=8),
                                control=jctl.ControlPolicy(), **kw)
    got = tfl.sweep_fleet_load(tc, 12, [2], [1500, 6000], slo=th.ServeSLO(latency_rounds=8),
                               control=tctl.ControlPolicy(), device="cpu", **kw)
    assert tfl.sweep_verdict(got) == jfl.sweep_verdict(want)
    assert got["control"] == tctl.policy_to_dict(tctl.ControlPolicy())
    for sm in (want, got):
        sm.pop("values_per_sec_surface")
        for cell in sm["cells"].values():
            for pt in cell["points"]:
                pt.pop("wall_seconds"), pt.pop("values_per_sec")
    assert got == want
    assert all("control_decisions" in pt for pt in got["cells"]["2"]["points"])
    before = tenv.cache_misses()  # a warm controlled sweep builds no runner
    tfl.sweep_fleet_load(tc, 12, [2], [1500, 6000], slo=th.ServeSLO(latency_rounds=8),
                         control=tctl.ControlPolicy(), device="cpu", **kw)
    assert tenv.cache_misses() == before
    with pytest.raises(ValueError, match="declare an slo"):
        tfl.sweep_fleet_load(tc, 12, [2], [1500], control=tctl.ControlPolicy(), device="cpu")


def test_fleet_policy_rejects_ladder_and_missing_slo():
    jc, tc = _cfgs()
    for kw in (dict(control="ladder", slo=16), dict(control="plain", slo=None)):
        errs = []
        for ctl_mod, fl, h, cfg, extra in ((jctl, jfl, jh, jc, {}), (tctl, tfl, th, tc, {"device": "cpu"})):
            pol = ctl_mod.ControlPolicy(ladder=(1, 2)) if kw["control"] == "ladder" \
                else ctl_mod.ControlPolicy()
            slo = None if kw["slo"] is None else h.ServeSLO(latency_rounds=kw["slo"])
            with pytest.raises(ValueError) as e:
                ctl_mod.controlled_fleet_run(cfg, [fl.ServeLane(WL, _arrs(), 0)], control=pol,
                                             slo=slo, **extra)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    # the lane tile refuses a lane count that does not tile its mesh, by
    # JAX's name
    from tpu_paxos_torch.parallel import mesh as pmesh

    with pytest.raises(ValueError, match="^1 lanes do not tile over 2 devices$"):
        tctl.controlled_fleet_run(tc, [tfl.ServeLane(WL, _arrs(), 0)], control=tctl.ControlPolicy(),
                                  slo=th.ServeSLO(latency_rounds=16),
                                  mesh=pmesh.make_instance_mesh(2, device="cpu"), device="cpu")


# ---------------- bench guard: the record-or-error gate -------------


def test_bench_serve_control_record_guards(port_ab):
    """``bench._serve_control_record`` (JAX's record-or-error gate) takes
    the port's A/B as it takes JAX's: the clean A/B is recorded, and each
    withhold arm fires on the port's A/B with its reason."""
    import bench

    config = _bench_config(port_ab)
    ok = bench._serve_control_record(port_ab, 0, config)
    assert "error" not in ok and ok["value"] == {"off": 128, "on": 96}
    for over, compiles, why in [
        ({}, 2, "compile"),
        ({"off": dict(port_ab["off"], breach_windows=[])}, 0, "breached nowhere"),
        ({"gray_shed_violations": [6]}, 0, "gray"),
        ({"fewer_breach_windows": False}, 0, "strictly"),
        ({"sheds": 0}, 0, "zero shed"),
        ({"replay": {"match": False}}, 0, "replay"),
    ]:
        bad = bench._serve_control_record({**port_ab, **over}, compiles, config)
        assert "error" in bad and why in bad["error"]


def test_committed_bench_record_is_a_passing_record(port_ab):
    with open("BENCH_serve_control.json") as f:
        rec = json.load(f)
    assert rec["engine"] == "serve_control" and "error" not in rec
    assert rec["value"]["on"] < rec["value"]["off"]
    assert rec["sheds"] > 0 and rec["gray_shed_violations"] == []
    assert rec["warm_compiles_measured"] == 0 and rec["replay"]["match"]
    assert rec["value"] == {"off": port_ab["breach_rounds_off"], "on": port_ab["breach_rounds_on"]}
    assert rec["sheds"] == port_ab["sheds"] and rec["decisions"] == port_ab["decisions"]


# ---------------- what the port adds ----------------


def test_committed_spike_artifact_replays_through_the_port():
    out = tctl.reproduce(SPIKE_ARTIFACT, device="cpu")
    assert out["match"] and out["decisions_match"] and out["done"]
    assert out["decision_log_sha256"] == out["recorded_sha256"] == SPIKE_SHA
    assert out["rounds"] == _serve_art()["rounds"]


def test_spike_ab_at_the_bench_config_equals_bench_serve_control_json(port_ab):
    """The JAX slow test's contract, against the committed record: the
    port's A/B through JAX's bench gate is ``BENCH_serve_control.json``,
    key for key (off [5, 6, 7, 8] vs on [5, 6, 7], 51 sheds, 5 decisions,
    both decision-log sha256), and its artifact replays."""
    import bench

    with open("BENCH_serve_control.json") as f:
        committed = json.load(f)
    assert port_ab["ok"] and port_ab["replay"]["match"]
    assert port_ab["replay"]["decision_log_sha256"] == SPIKE_SHA
    assert bench._serve_control_record(port_ab, 0, _bench_config(port_ab)) == committed
    assert set(port_ab["on"]["breach_windows"]) <= set(port_ab["off"]["breach_windows"])
    assert "saturation" in port_ab["on"]["causes"]


def test_armed_defer_band_and_ladder_equal_jax():
    """A policy with a defer band and a two-step ladder on the spike:
    degrade steps S down to 1, restore back to 2; the decisions, the shed
    records, every report field and the decision log equal JAX's."""
    rep = _defer_run(tctl, tcfg, tarr, device="cpu")
    assert_same_report(rep, _jax_defer())
    acts = [d["action"] for d in rep.decisions]
    assert "degrade" in acts and "restore" in acts and rep.shed_count > 0
    assert rep.ladder == (1, 2) and rep.backlog == 0


def test_mid_run_jax_state_continues_in_the_port():
    """``interop.control_state_from_jax``: JAX's controlled loop state
    after one dispatch that sheds, continued one dispatch in each
    package, comes out equal leaf for leaf (the ``ctl`` counter too)."""
    jc, tc = _cfgs()
    vb, ww = 30, W_ROUNDS
    root = jprng.root_key(jc.seed)
    jcs, c = jctl.init_control_state(jc, WL, vb, root, window_rounds=ww)
    tinit, tc_cap = tctl.init_control_state(tc, WL, vb, tprng.root_key(tc.seed),
                                            window_rounds=ww, device="cpu")
    assert tc_cap == c
    _same_tree(interop.control_state_to_numpy(tinit), jax.tree.map(np.asarray, jcs))
    plan = tarr.ArrivalPlan(WL, _arrs(), R_WINDOW)
    blocks = [plan.block(i, ADMIT_W) for i in range(2 * S_DISPATCH)]
    admits = np.stack([b[0] for b in blocks]).reshape(2, S_DISPATCH, 2, ADMIT_W)
    arrs = np.stack([b[1] for b in blocks]).reshape(2, S_DISPATCH, 2, ADMIT_W)
    keeps = admits != tarr.NONE
    keeps[0, 0, 0, :2] = False  # two sheds in the first dispatch
    jfn = jctl.control_window_for(jc, c, vb, R_WINDOW, ww)
    jcs = jfn(jcs, root, jnp.asarray(admits[0]), jnp.asarray(arrs[0]), jnp.asarray(keeps[0]))[0]
    mid = jax.tree.map(np.asarray, jcs)
    tcs = interop.control_state_from_jax(mid, device="cpu")
    tfn = tctl.control_window_for(tc, c, vb, R_WINDOW, ww, device="cpu")
    jout = jfn(jcs, root, jnp.asarray(admits[1]), jnp.asarray(arrs[1]), jnp.asarray(keeps[1]))
    tout = tfn(tcs, tprng.root_key(tc.seed), admits[1], arrs[1], keeps[1])
    _same_tree(interop.control_state_to_numpy(tout[0]), jax.tree.map(np.asarray, jout[0]))
    assert int(tout[2]) == int(jout[2]) == 2 * S_DISPATCH * R_WINDOW
    for k in (3, 4):
        _same_tree(interop.control_state_to_numpy(tout[k]), jax.tree.map(np.asarray, jout[k]))
    live = admits != tarr.NONE
    assert tout[0].ctl.tolist() == [2, int(live.sum()) - 2]


def _same_tree(got, want, path="state"):
    if isinstance(want, np.ndarray) or np.isscalar(want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)
        assert np.asarray(got).shape == np.asarray(want).shape, path
        return
    names = getattr(want, "_fields", None) or range(len(want))
    for k in names:
        g = getattr(got, k) if isinstance(k, str) else got[k]
        w = getattr(want, k) if isinstance(k, str) else want[k]
        _same_tree(g, w, f"{path}.{k}")


def test_window_cache_builds_once_for_the_ab_twins_and_refuses_schedules():
    """``control_window_for`` and ``envelope.serve_control_for`` count
    their builds in ``cache_misses``; an inert and an armed run of one
    envelope share one window (a warm A/B builds nothing)."""
    jc, tc = _cfgs()
    tctl.clear_cache()
    before = tenv.cache_misses()
    tctl.controlled_serve_run(tc, WL, _arrs(), control=None, device="cpu", **_geom())
    assert tenv.cache_misses() - before == 1
    _port_armed()
    assert tenv.cache_misses() - before == 1
    fn = tctl.control_window_for(tc, 68, 30, R_WINDOW, W_ROUNDS, device="cpu")
    assert fn is tctl.control_window_for(dataclasses.replace(tc, seed=9), 68, 30, R_WINDOW,
                                         W_ROUNDS, device="cpu")
    r1 = tenv.serve_control_for(tc, 68, 30, R_WINDOW, window_rounds=32, device="cpu")
    assert r1 is tenv.serve_control_for(tc, 68, 30, R_WINDOW, window_rounds=32, device="cpu")
    assert r1 is not tenv.serve_fleet_for(tc, 68, 30, R_WINDOW, window_rounds=32, device="cpu")
    from tpu_paxos_torch.core import faults as tflt
    from tpu_paxos.core import faults as jflt

    sched = dataclasses.replace(tc, faults=dataclasses.replace(
        tc.faults, schedule=tflt.FaultSchedule((tflt.pause(1, 3, 0),))))
    jsched = dataclasses.replace(jc, faults=dataclasses.replace(
        jc.faults, schedule=jflt.FaultSchedule((jflt.pause(1, 3, 0),))))
    for tcall, jcall in (
        (lambda: tctl.control_window_for(sched, 68, 30, R_WINDOW, W_ROUNDS, device="cpu"),
         lambda: jctl.control_window_for(jsched, 68, 30, R_WINDOW, W_ROUNDS)),
        (lambda: tctl.build_control_window(tc, 68, 30, R_WINDOW, 0, device="cpu"),
         lambda: jctl.build_control_window(jc, 68, 30, R_WINDOW, 0)),
        (lambda: tctl.ControlFleetRunner(tc, 68, 30, R_WINDOW, 0, device="cpu"),
         lambda: jctl.ControlFleetRunner(jc, 68, 30, R_WINDOW, 0)),
        (lambda: tenv.serve_control_for(sched, 68, 30, R_WINDOW, window_rounds=32, device="cpu"),
         lambda: __import__("tpu_paxos.fleet.envelope", fromlist=["x"]).serve_control_for(
             jsched, 68, 30, R_WINDOW, window_rounds=32)),
    ):
        with pytest.raises(ValueError) as te:
            tcall()
        with pytest.raises(ValueError) as je:
            jcall()
        assert str(te.value) == str(je.value)
    # the lane tile is ported: a tiled runner is cached apart from the
    # untiled one, and shared by meshes of one layout
    from tpu_paxos_torch.parallel import mesh as pmesh

    m2 = pmesh.make_instance_mesh(2, device="cpu")
    tiled = tenv.serve_control_for(tc, 68, 30, R_WINDOW, window_rounds=32, mesh=m2, device="cpu")
    assert tiled.mesh is m2 and isinstance(tiled, tctl.ControlFleetRunner)
    assert tiled is not tenv.serve_control_for(tc, 68, 30, R_WINDOW, window_rounds=32,
                                               device="cpu")
    assert tenv.serve_control_for(tc, 68, 30, R_WINDOW, window_rounds=32, device="cpu",
                                  mesh=pmesh.make_instance_mesh(2, device="cpu")) is tiled
    assert tctl.ControlFleetRunner(tc, 68, 30, R_WINDOW, 32, mesh=m2, device="cpu").mesh is m2
    # audit_entries is ported (analysis/registry.py): JAX's entry names
    assert [e.name for e in tctl.audit_entries()] == [e.name for e in jctl.audit_entries()]


def test_controlled_run_argument_errors_equal_jax():
    jc, tc = _cfgs()
    for kw in (dict(control="p"), dict(admit_width=2), dict(windows_per_dispatch=0),
               dict(window_rounds=0), dict(control="p", slo=16, priorities=[[5] * 10] * 2)):
        errs = []
        for ctl_mod, h, cfg, extra in ((jctl, jh, jc, {}), (tctl, th, tc, {"device": "cpu"})):
            k = dict(kw, **extra)
            if k.get("control") == "p":
                k["control"] = ctl_mod.ControlPolicy()
            if "slo" in k:
                k["slo"] = h.ServeSLO(latency_rounds=k["slo"])
            with pytest.raises(ValueError) as e:
                ctl_mod.controlled_serve_run(cfg, WL, _arrs(), **k)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    with pytest.raises(ValueError, match="one value stream per proposer"):
        tctl.controlled_serve_run(tc, WL[:1], _arrs()[:1], device="cpu")
