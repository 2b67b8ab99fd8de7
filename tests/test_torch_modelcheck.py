"""The port's model checker (``tpu_paxos_torch/analysis/modelcheck.py``)
against the JAX package's: every contract of ``tests/test_modelcheck.py``
mirrored on the port on the CPU (codec bijection, symmetry-reduction
canonical forms, chunk coverage, crash points, the certificate, the
seeded-wedge recall and the batched shrinker in the slow tier), plus
exact parity with JAX: the reduced index list, the alphabet and every
reduced scenario's ``describe()`` of the committed fault scopes (live on
both sides, host only), the tiny scope's summary and the quick scope's
first chunks lane by lane (against ``tpu_paxos_torch/data/goldens.json``,
written by JAX on the CPU), and the data files byte for byte.

The port counts runner builds where JAX counts XLA compiles, so
``compiles_per_chunk`` is compared by its zero pattern; the certificate
check compares verdict bits on every device (JAX's skips them off the
pinning backend), and the drift test asserts that stricter behaviour.
"""

import dataclasses
import hashlib
import json
import os
import random

import numpy as np
import pytest

from tpu_paxos.analysis import modelcheck as jmc
from tpu_paxos_torch.analysis import modelcheck as mc
from tpu_paxos_torch.analysis import triage
from tpu_paxos_torch.core import faults as flt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")
DEV = "cpu"


def _committed_scopes():
    return mc.load_scopes()


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


TINY = {
    "n_nodes": 3, "proposers": 2, "horizon": 12, "max_rounds": 400,
    "intervals": [[2, 8]], "kinds": ["pause", "burst", "crash"],
    "pause_set_sizes": [1], "burst_rates": [2000],
    "crash_rounds": [4], "crash_set_sizes": [1], "max_episodes": 2,
    "knob_tiers": [{"drop_rate": 500, "max_delay": 2}],
    "gate_tiers": [True, False], "seeds": [0], "chunk_lanes": 4,
    "n_ids": 2, "n_free": 2,
}


# ---------------- codec ----------------

def test_codec_roundtrip_bijection_committed_scopes():
    """index -> scenario -> index is the identity over every committed
    scope (fault, churn and control, each through its own codec; large
    scopes over a stride plus both boundary indices), dispatched through
    ``mc.enum_for`` as the CLI does."""
    scopes = _committed_scopes()
    assert {"quick", "full", "gray", "churn", "control"} <= set(scopes)
    for name, scope in scopes.items():
        enum = mc.enum_for(scope)
        idxs = (
            range(enum.total) if enum.total <= 5000
            else [*range(0, enum.total, 97), 0, enum.total - 1]
        )
        for i in idxs:
            sc = enum.decode(i)
            assert enum.encode(sc) == i, (name, i)
        with pytest.raises(IndexError):
            enum.decode(enum.total)
        with pytest.raises(IndexError):
            enum.decode(-1)


def test_combo_rank_unrank_inverse_all_sizes():
    m, k_max = 7, 3
    n = mc.n_combos(m, k_max)
    seen = set()
    for r in range(n):
        combo = mc.combo_unrank(r, m, k_max)
        assert len(combo) <= k_max
        assert list(combo) == sorted(set(combo))
        assert mc.combo_rank(combo, m, k_max) == r
        seen.add(combo)
    assert len(seen) == n
    with pytest.raises(IndexError):
        mc.combo_unrank(n, m, k_max)
    with pytest.raises(ValueError):
        mc.combo_rank((1, 1), m, k_max)


def test_decoded_scenarios_materialize_and_are_distinct():
    scope = _committed_scopes()["quick"]
    enum = mc.ScopeEnum(scope)
    for i in enum.reduced[:200]:
        sc = enum.decode(i)
        sched = enum.schedule_of(sc)
        if sched is not None:
            assert len(sched.episodes) <= scope.max_episodes
            assert sched.horizon <= scope.horizon
        enum.faults_of(sc)
        assert enum.describe(sc)["index"] == i


# ---------------- symmetry reduction ----------------

def test_canonical_form_idempotent_and_unique_per_orbit():
    scope = _committed_scopes()["quick"]
    enum = mc.ScopeEnum(scope)
    assert enum._perms, "quick scope should have movable nodes"
    orbits = {}
    for cr in range(enum.n_combos):
        combo = mc.combo_unrank(cr, enum.m, scope.max_episodes)
        canon = enum.canon_combo(combo)
        assert enum.canon_combo(canon) == canon
        orbits.setdefault(canon, set()).add(combo)
    for canon, members in orbits.items():
        assert sum(1 for c in members if enum.canon_combo(c) == c) == 1, (canon, members)
        assert canon in members


def test_reduction_preserves_scenario_blocks():
    scope = _committed_scopes()["quick"]
    enum = mc.ScopeEnum(scope)
    per_combo = enum.n_tiers * enum.n_gates * enum.n_seeds
    kept = set()
    for cr in range(enum.n_combos):
        combo = mc.combo_unrank(cr, enum.m, scope.max_episodes)
        if enum.canon_combo(combo) == combo and enum.combo_feasible(combo):
            kept.add(cr)
    expect = [i for cr in sorted(kept) for i in range(cr * per_combo, (cr + 1) * per_combo)]
    assert enum.reduced == expect


def test_crash_minority_cap_filters_combos():
    scope = mc.McScope.from_dict(dict(TINY, crash_rounds=[4, 6], max_episodes=2))
    enum = mc.ScopeEnum(scope)  # 3 nodes -> minority cap is 1
    over = [
        combo for cr in range(enum.n_combos)
        for combo in [mc.combo_unrank(cr, enum.m, scope.max_episodes)]
        if not enum.combo_feasible(combo)
    ]
    assert over, "expected some two-node crash combos"
    for combo in over:
        crashed = set()
        for i in combo:
            e = enum.alphabet[i]
            if e.kind == "crash":
                crashed.update(e.nodes)
        assert len(crashed) > 1
        cr = mc.combo_rank(combo, enum.m, scope.max_episodes)
        per = enum.n_tiers * enum.n_gates * enum.n_seeds
        assert not (set(enum.reduced) & set(range(cr * per, (cr + 1) * per)))


# ---------------- chunking ----------------

def test_chunk_boundary_coverage():
    scope = _committed_scopes()["quick"]
    enum = mc.ScopeEnum(scope)
    lanes = scope.chunk_lanes
    chunks = mc.chunk_pad(enum.reduced, lanes)
    assert [i for chunk, n_real in chunks for i in chunk[:n_real]] == enum.reduced
    for chunk, n_real in chunks[:-1]:
        assert n_real == lanes
    last, n_real = chunks[-1]
    assert len(last) == lanes
    assert last[n_real:] == [last[n_real - 1]] * (lanes - n_real)
    assert mc.chunk_pad([], lanes) == []
    with pytest.raises(ValueError):
        mc.chunk_pad([1], 0)


# ---------------- scope validation ----------------

def test_scope_validation_errors():
    with pytest.raises(mc.ScopeError, match="unknown scope field"):
        mc.McScope.from_dict(dict(TINY, bogus=1))
    with pytest.raises(mc.ScopeError, match="missing field"):
        mc.McScope.from_dict({"n_nodes": 3})
    with pytest.raises(mc.ScopeError, match="unknown episode kind"):
        mc.McScope.from_dict(dict(TINY, kinds=["pause", "meteor"]))
    with pytest.raises(mc.ScopeError, match="crash_rounds"):
        mc.McScope.from_dict(dict(TINY, crash_rounds=[]))
    with pytest.raises(mc.ScopeError, match="interval"):
        mc.McScope.from_dict(dict(TINY, intervals=[[8, 2]]))
    with pytest.raises(mc.ScopeError, match="knob tier"):
        mc.McScope.from_dict(dict(TINY, knob_tiers=[{"drop_rate": 99999}]))
    with pytest.raises(mc.ScopeError, match="schedule"):
        mc.McScope.from_dict(dict(TINY, knob_tiers=[{"schedule": None}]))


def test_mc_cli_exits_2_on_scope_errors(tmp_path):
    assert mc.main(["--scope-file", str(tmp_path / "nope.json"), "--device", DEV]) == 2
    bad = tmp_path / "scopes.json"
    bad.write_text("{}")
    assert mc.main(["--scope-file", str(bad), "--device", DEV]) == 2
    bad.write_text(json.dumps({"quick": dict(TINY, kinds=["meteor"])}))
    assert mc.main(["--scope-file", str(bad), "--scope", "quick", "--device", DEV]) == 2


# ---------------- crash points (faults layer) ----------------

def test_crash_episode_tables_and_compiled_rows():
    e = flt.crash(4, 1)
    assert (e.t0, e.t1, e.nodes) == (4, 5, (1,))
    cut, paused, extra, cmask, _gray = flt.episode_tables(e, 3)
    assert not cut.any() and not paused.any() and extra == 0
    assert cmask.tolist() == [False, True, False]
    with pytest.raises(ValueError, match="t0 \\+ 1"):
        flt.Episode("crash", 2, 9, nodes=(1,))
    with pytest.raises(ValueError, match="at least one node"):
        flt.Episode("crash", 2, 3)
    sched = flt.FaultSchedule((flt.pause(2, 8, 0), flt.crash(4, 1)))
    comp = flt.compile_schedule(sched, 3)
    assert comp.has_crash and comp.horizon == 8
    assert not comp.crashed[:4].any()
    assert comp.crashed[4:, 1].all()
    assert not comp.crashed[:, [0, 2]].any()


def test_crashes_at_matches_compiled_rows():
    from tpu_paxos_torch.fleet import schedule_table as stm

    sched = flt.FaultSchedule((flt.crash(3, 2), flt.pause(1, 6, 0), flt.crash(7, 0)))
    comp = flt.compile_schedule(sched, 4)
    tab = stm.encode_schedule(sched, 4, max_episodes=4)
    for t in range(comp.horizon + 3):
        want = comp.crashed[min(t, comp.horizon)]
        got = np.asarray(stm.crashes_at(tab, t))
        assert (got == want).all(), t
        reach, paused, extra, _gray = stm.masks_at(tab, t)
        assert np.asarray(reach).all()


def test_membership_engine_accepts_crash_episodes():
    from tpu_paxos_torch.membership import engine as mem

    ms = mem.MemberSim(3, n_instances=64, schedule=flt.FaultSchedule((flt.crash(2, 1),)),
                       device=DEV)
    ms.propose(0, 9)
    assert ms.run_until(lambda: ms.chosen(9), max_rounds=200)
    ms.run_rounds(4)
    assert 1 in ms.crashed_set()
    with pytest.raises(ValueError, match="node 0"):
        mem.MemberSim(3, n_instances=64, schedule=flt.FaultSchedule((flt.crash(2, 0),)),
                      device=DEV)


# ---------------- dispatch + certificate (tiny scope) ----------------

@pytest.fixture(scope="module")
def tiny_run():
    from tpu_paxos_torch.fleet import envelope

    envelope.clear_cache()  # chunk 0 builds the runner, as a cold JAX process compiles
    scope = mc.McScope.from_dict(TINY)
    return scope, mc.run_scope(scope, verbose=False, device=DEV)


def test_tiny_scope_runs_clean_with_zero_warm_compiles(tiny_run):
    scope, s = tiny_run
    enum = mc.ScopeEnum(scope)
    assert s["ok"] and not s["counterexamples"] and not s["anomalies"]
    assert s["scenarios_reduced"] == len(enum.reduced)
    assert s["verdict_bits"] == "f" * len(enum.reduced)
    # the envelope contract: the runner build is charged to chunk 0 and
    # no later chunk builds anything
    assert s["compiles_per_chunk"][0] > 0
    assert all(c == 0 for c in s["compiles_per_chunk"][1:])
    assert s["backend"] == "cpu"


def test_tiny_scope_summary_equals_jax(tiny_run):
    """The summary, less timing and device, equals JAX's run of the same
    scope (the verdict bits, counts and runner-build zero pattern)."""
    _, s = tiny_run
    assert _less(s) == _mc_gold()["tiny_fault"]


def test_certificate_roundtrip_and_drift_naming(tiny_run, tmp_path):
    scope, s = tiny_run
    enum = mc.ScopeEnum(scope)
    cert = mc.make_certificate(s)
    path = str(tmp_path / "cert.json")
    mc.save_certificate(path, "tiny", cert)
    pinned = mc.load_certificates(path)["tiny"]
    assert mc.check_certificate(pinned, s, enum) == []
    drifted = dict(s)
    bits = list(s["verdict_bits"])
    bits[3] = "7"
    drifted["verdict_bits"] = "".join(bits)
    fails = mc.check_certificate(pinned, drifted, enum)
    assert len(fails) == 1
    assert f"scenario index {enum.reduced[3]}" in fails[0]
    fails = mc.check_certificate(dict(pinned, scope_sha256="0" * 64), s, enum)
    assert "scope_sha256" in fails[0]
    # the port compares verdict bits whatever backend pinned them (JAX's
    # checker skips them off the pinning backend): a pin from another
    # device with other bits is a drift, named by scenario index
    fails = mc.check_certificate(
        dict(pinned, backend="tpu", verdict_bits="0" * len(s["verdict_bits"])), s, enum)
    assert len(fails) == 1 and f"scenario index {enum.reduced[0]}" in fails[0]
    assert mc.check_certificate(dict(pinned, backend="cuda"), s, enum) == []
    with pytest.raises(ValueError, match="chunk-limited"):
        mc.make_certificate(dict(s, chunks_run=s["chunks"] - 1))


def test_mc_cli_certifies_and_never_pins(tiny_run, tmp_path, monkeypatch, capsys):
    """The port's ``mc`` checks the certificate file and never writes it,
    the JAX package's re-pin variable set or not; it has no ``--pin``."""
    scope, s = tiny_run
    scopes = tmp_path / "scope.json"
    scopes.write_text(json.dumps({"tiny": TINY}))
    cert = tmp_path / "cert.json"
    drifted = dict(mc.make_certificate(s), verdict_bits="7" + s["verdict_bits"][1:])
    cert.write_text(json.dumps({"tiny": drifted}))
    before = cert.read_bytes()
    monkeypatch.setenv("TPU_PAXOS_MC_PIN", "1")
    argv = ["--scope-file", str(scopes), "--scope", "tiny", "--cert-file", str(cert),
            "--chunk-limit", "1", "--device", DEV, "--json", "--quiet"]
    assert mc.main(argv) == 1
    got = json.loads(capsys.readouterr().out)
    assert "pinned" not in got
    assert len(got["certificate_failures"]) == 1
    assert f"scenario index {mc.ScopeEnum(scope).reduced[0]}" in got["certificate_failures"][0]
    assert cert.read_bytes() == before
    with pytest.raises(SystemExit) as e:
        mc.main(argv + ["--pin"])
    assert e.value.code == 2 and cert.read_bytes() == before


def test_scope_episode_ceiling_matches_fleet_envelope():
    from tpu_paxos_torch.fleet import runner as frun

    assert mc.MAX_SCOPE_EPISODES == frun.MAX_EPISODES
    with pytest.raises(mc.ScopeError, match="max_episodes"):
        mc.McScope.from_dict(dict(TINY, max_episodes=mc.MAX_SCOPE_EPISODES + 1))


# ---------------- gray axis ----------------

def test_gray_delay_ceiling_matches_fleet_envelope():
    from tpu_paxos_torch.fleet import envelope

    assert mc.MAX_GRAY_DELAY == envelope.MAX_DELAY_BOUND
    gray = dict(TINY, kinds=["gray"], gray_set_sizes=[1], gray_delays=[2],
                knob_tiers=[{"drop_rate": 0, "max_delay": 4}])
    mc.McScope.from_dict(gray).validate()
    with pytest.raises(mc.ScopeError, match=r"\[1, 8\]"):
        mc.McScope.from_dict(dict(gray, gray_delays=[9])).validate()
    with pytest.raises(mc.ScopeError, match="distinct"):
        mc.McScope.from_dict(dict(gray, gray_delays=[2, 2])).validate()
    with pytest.raises(mc.ScopeError, match="max_delay >= 1"):
        mc.McScope.from_dict(dict(gray, knob_tiers=[{"drop_rate": 0}])).validate()


def test_gray_letters_materialize_at_tier_boundaries():
    scope = _committed_scopes()["gray"]
    enum = mc.enum_for(scope)
    grays = [ep for ep in mc.episode_alphabet(scope) if ep.kind == "gray"]
    assert grays
    assert {ep.delay for ep in grays} == set(scope.gray_delays)
    per_combo = enum.n_tiers * enum.n_gates * enum.n_seeds
    for cr in range(enum.n_combos):
        for i in (cr * per_combo, (cr + 1) * per_combo - 1):
            sc = enum.decode(i)
            assert enum.encode(sc) == i
            sched = enum.schedule_of(sc)
            if sched is not None:
                for ep in sched.episodes:
                    if ep.kind == "gray":
                        assert ep.delay in scope.gray_delays


def test_gray_broken_symmetry_one_canonical_per_orbit():
    scope = _committed_scopes()["gray"]
    enum = mc.enum_for(scope)
    assert enum._perms
    orbits = {}
    for cr in range(enum.n_combos):
        combo = mc.combo_unrank(cr, enum.m, scope.max_episodes)
        canon = enum.canon_combo(combo)
        assert enum.canon_combo(canon) == canon
        orbits.setdefault(canon, set()).add(combo)
    for canon, members in orbits.items():
        assert sum(1 for c in members if enum.canon_combo(c) == c) == 1, (canon, members)


# ---------------- committed certificates ----------------

def test_committed_certificates_pin_all_scopes_and_counts():
    certs = mc.load_certificates()
    expect_counts = {
        "quick": (2116, 928), "full": (25674, 7242), "gray": (121, 52),
        "churn": (441, 302), "control": (8882, 8882),
    }
    for name, scope in _committed_scopes().items():
        enum = mc.enum_for(scope)
        cert = certs[name]
        assert cert["scope_sha256"] == scope.sha256(), name
        assert cert["scenarios_full"] == enum.total == expect_counts[name][0], name
        assert cert["scenarios_reduced"] == len(enum.reduced) == expect_counts[name][1], name
        assert cert["counterexamples"] == 0, name
        assert len(cert["verdict_bits"]) == len(enum.reduced), name


def test_mc_artifacts_live_in_the_triage_namespace():
    assert "mc_" in triage.DUMP_PREFIXES
    assert triage.dump_name("mc", "scenario_42", "json") == "mc_scenario_42.json"


# ---------------- parity with the JAX package ----------------

def test_scope_and_certificate_files_are_byte_copies_of_jax():
    for name in ("mc_scope.json", "mc_certificate.json"):
        with open(os.path.join(ROOT, "tpu_paxos", "analysis", name), "rb") as f:
            want = f.read()
        with open(os.path.join(ROOT, "tpu_paxos_torch", "analysis", name), "rb") as f:
            assert f.read() == want, name
    assert os.path.basename(mc.DEFAULT_SCOPE) == "mc_scope.json"
    assert os.path.dirname(mc.DEFAULT_CERT) == os.path.dirname(mc.__file__)


def _sha(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def _describe_all(mod, scope_dict, indices=None):
    scope = mod.McScope.from_dict(scope_dict)
    enum = mod.ScopeEnum(scope)
    idx = enum.reduced if indices is None else indices(enum)
    return {
        "sha256": scope.sha256(),
        "reduced": _sha(enum.reduced),
        "alphabet": [
            mod.fltm.FaultSchedule((e,)).to_dict()["episodes"][0] for e in enum.alphabet
        ],
        "describe": _sha([enum.describe(enum.decode(i)) for i in idx]),
    }


@pytest.mark.parametrize("name", ["quick", "gray", "full-sample"])
def test_reduced_scenarios_equal_jax(name):
    """The reduced list (the certificate's index space), the alphabet and
    ``describe()`` of every reduced scenario equal JAX's, live on both
    sides; the full scope over a seeded sample of 2000 of its 7242."""
    with open(mc.DEFAULT_SCOPE) as f:
        raw = json.load(f)
    indices = None
    if name == "full-sample":
        name = "full"

        def indices(enum):
            return sorted(random.Random(0).sample(enum.reduced, 2000))
    assert _describe_all(mc, raw[name], indices) == _describe_all(jmc, raw[name], indices)


def test_quick_scope_first_chunks_equal_jax_lane_for_lane():
    """The quick scope's first two 16-lane chunks of ``run_scope``'s own
    run: each lane's decision-log sha256 equals JAX's (the verdict bits
    alone, all ``f``, could not show this)."""
    script = _golden_script()
    m = script.mc_modules(port=True)
    with script.mc_first_reports(m, 2) as reports:
        s = mc.run_scope(mc.load_scopes()["quick"], verbose=False, chunk_limit=2, device=DEV)
    assert s["chunks_run"] == len(reports) == 2
    got = script.mc_lane_shas(m, reports)
    assert got == _mc_gold()["quick_lanes"]
    assert len(got) == 32


# ---------------- seeded-wedge recall (slow) ----------------

@pytest.mark.slow
def test_seeded_wedge_found_shrunk_and_replayed(tmp_path, monkeypatch):
    """With the takeover wedge re-introduced, the quick scope finds a
    counterexample, shrinks it into ``mc_scenario_<index>.json`` and the
    artifact replays byte-identically; the pinned quick certificate
    names the drift by scenario index.  The index, the violation, the
    artifact's bytes and the certificate failure equal JAX's."""
    from tpu_paxos_torch.fleet import envelope
    from tpu_paxos_torch.harness import shrink as shr

    monkeypatch.setenv("TPU_PAXOS_SEEDED_WEDGE", "takeover")
    envelope.clear_cache()
    scope = _committed_scopes()["quick"]
    enum = mc.ScopeEnum(scope)
    s = mc.run_scope(scope, verbose=False, triage_dir=str(tmp_path), max_counterexamples=1,
                     device=DEV)
    assert not s["ok"] and s["counterexamples"]
    assert s["seeded_wedge"] == "takeover"
    cx = s["counterexamples"][0]
    idx = cx["scenario"]["index"]
    assert "crash" in {e["kind"] for e in cx["scenario"]["episodes"]}
    art_path = cx["artifact"]
    assert os.path.basename(art_path) == f"mc_scenario_{idx}.json"
    assert cx.get("triage_error") is None
    rep = shr.reproduce(art_path, device=DEV)
    assert rep["match"], rep
    case, _ = shr.load_artifact(art_path)
    sched = case.cfg.faults.schedule
    assert sched is not None and any(e.kind == "crash" for e in sched.episodes)
    pinned = mc.load_certificates()["quick"]
    fails = mc.check_certificate(
        dict(pinned, verdict_bits=pinned["verdict_bits"][:len(s["verdict_bits"])]), s, enum)
    assert fails and "scenario index" in fails[0]
    gold = _mc_gold()["recall"]
    assert _less(s) == gold["summary"]
    assert fails == gold["certificate_failures"]
    with open(art_path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == gold["artifact_sha256"]
    envelope.clear_cache()


# ---------------- batched shrinker parity (slow) ----------------

@pytest.mark.slow
def test_batched_shrink_parity_with_sequential():
    from tpu_paxos_torch.config import FaultConfig, SimConfig
    from tpu_paxos_torch.harness import shrink as shr

    sched = flt.FaultSchedule((flt.partition(5, 35, (0, 1), (2, 3, 4)), flt.pause(10, 20, 3)))
    cfg = SimConfig(n_nodes=5, n_instances=64, proposers=(0, 1), seed=7, max_rounds=4000,
                    faults=FaultConfig(drop_rate=300, dup_rate=500, max_delay=2,
                                       schedule=sched))
    wl = [np.arange(100, 110, dtype=np.int32), np.arange(200, 210, dtype=np.int32)]
    case = shr.ReproCase(cfg=cfg, workload=wl, gates=None, chains=[np.zeros(0, np.int32)] * 2,
                         extra_checks={"decision_round_max": 25})
    ev = shr._runtime_candidate_eval(case, device=DEV)
    batch = shr._runtime_batch_eval(case, device=DEV)
    assert ev is not None and batch is not None
    cands = [
        case.with_schedule(sched.without(0)),
        case.with_schedule(sched.without(1)),
        case.with_faults(dataclasses.replace(cfg.faults, drop_rate=0)),
        dataclasses.replace(case, cfg=dataclasses.replace(cfg, seed=0)),
    ]
    assert batch(cands) == [ev(c) for c in cands]
    small_b, viol_b = shr.shrink_case(case, batch=True, device=DEV)
    small_s, viol_s = shr.shrink_case(case, batch=False, device=DEV)
    assert viol_b == viol_s
    assert small_b.cfg == small_s.cfg
    assert [w.tolist() for w in small_b.workload] == [w.tolist() for w in small_s.workload]
    assert shr._runtime_batch_eval(dataclasses.replace(case, engine="sharded", devices=2),
                                   device=DEV) is None


# ---------------- full-scope certificate smoke (slow) ----------------

@pytest.mark.slow
def test_full_scope_counts_and_verdict_prefix_match_certificate():
    """The full scope's enumeration matches its certificate and the first
    chunks' verdict bits reproduce the pinned prefix, compared on this
    device (the port's certificate check has no backend gate)."""
    scope = _committed_scopes()["full"]
    enum = mc.ScopeEnum(scope)
    pinned = mc.load_certificates()["full"]
    assert pinned["scope_sha256"] == scope.sha256()
    assert pinned["scenarios_full"] == enum.total
    assert pinned["scenarios_reduced"] == len(enum.reduced)
    assert pinned["counterexamples"] == 0
    s = mc.run_scope(scope, verbose=False, chunk_limit=2, device=DEV)
    assert s["ok"]
    fails = mc.check_certificate(
        dict(pinned, verdict_bits=pinned["verdict_bits"][:len(s["verdict_bits"])]), s, enum)
    assert fails == [], fails
