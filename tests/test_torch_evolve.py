"""The port's selection loop (``tpu_paxos_torch/fleet/evolve.py`` and
``serve/breach.py``) against the JAX package's: every test of
``tests/test_evolve.py`` mirrored on the port on the CPU under its name
(fitness reducers, deterministic elitist selection, cause-targeted
mutation, the shared grammar alphabet, churn-schedule genes, serve
genomes, the certificate budget and bench guards; its slow engine-backed
cells stay slow here), plus exact parity with JAX:

- the pure operators' seeded sweep (``draw_episode``, ``jitter_episode``,
  ``mutate_schedule``, ``crossover_schedules``, ``fresh_schedule`` with
  and without a hunt, ``select`` at 8 lanes), live on both sides: no
  engine runs;
- evolve-quick, the member axis, the serve axis and the one-lane
  ``lane_causes`` case on the port's CPU, against
  ``tpu_paxos_torch/data/goldens.json`` (written by JAX on the CPU):
  ``population_sha256``, wedges, violations, causes, burns, artifact
  bytes and ``repro`` stdout.  The goldens script's ``evolve_less``
  removes only the wall fields, artifact directories and the value of
  the generation-0 build count (JAX counts XLA compiles, the port runner
  builds), whose zero pattern is compared.

One module-scoped fixture serves each engine-backed run, as JAX's
``quick_loop`` does, each from a cold envelope.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from tpu_paxos.fleet import evolve as jevo
from tpu_paxos_torch import __main__ as tcli
from tpu_paxos_torch.analysis import mc_member
from tpu_paxos_torch.analysis import modelcheck as mc
from tpu_paxos_torch.core import faults as fltm
from tpu_paxos_torch.fleet import envelope
from tpu_paxos_torch.fleet import evolve as evo
from tpu_paxos_torch.fleet import search as srch
from tpu_paxos_torch.membership import churn_table as ctm
from tpu_paxos_torch.membership import engine as meng
from tpu_paxos_torch.serve import breach as sbr
from tpu_paxos_torch.telemetry import recorder as telem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")
DEV = "cpu"


def _golden_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(ROOT, "scripts", "torch_port_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_script = _golden_script()
_less = _script.evolve_less


def _gold():
    with open(GOLDENS) as f:
        return json.load(f)["evolve"]


class _Windows:
    """Just enough of a WindowSummary for the stall reducers."""

    def __init__(self, stall_max):
        self.stall_max = stall_max


# ---------------- fitness reducers (pure numpy) ----------------


def test_lane_stall_margins_ordering():
    """Per-LANE margins keep the lane axis (min over windows of the
    headroom), and their minimum equals the across-lane
    ``stall_margin_series`` minimum."""
    stall = np.array([
        [3, 7, 1],   # worst window 7 -> margin 20-7 = 13
        [0, 0, 0],   # idle lane      -> margin 20
        [5, 19, 2],  # near-miss      -> margin 1
    ])
    margins = telem.lane_stall_margins(_Windows(stall), 20)
    assert margins == [13, 20, 1]
    assert sorted(range(3), key=lambda i: margins[i]) == [2, 0, 1]
    agg = telem.stall_margin_series(_Windows(stall), 20)
    assert min(margins) == min(agg)
    assert telem.lane_stall_margins(_Windows(stall[2]), 20) == [1]


def test_lane_burn_rates_matches_judge_formula():
    """Per-lane burn mirrors serve/harness._judge_series: bad mass is
    everything at latency buckets STRICTLY above the SLO threshold,
    burn = bad/total/budget, and the lane's fitness is its worst
    window."""
    B = len(telem.LAT_EDGES) + 1
    hist = np.zeros((2, 2, B), np.int64)
    hist[0, 0, 1] = 8
    hist[0, 0, 4] = 2   # burn = 2/10 / 0.2 = 1.0
    hist[0, 1, 0] = 4   # burn = 0
    hist[1, 1, 5] = 5   # burn = 5/5 / 0.2 = 5.0
    burns = telem.lane_burn_rates(hist, 8, 200)
    assert burns == [1.0, 5.0]
    assert telem.lane_burn_rates(hist[1], 8, 200) == [5.0]
    assert telem.lane_burn_rates(np.zeros((1, 2, B)), 8, 200) == [0.0]


# ---------------- selection (deterministic, elitist) ----------------


def test_select_elites_children_immigrants():
    pop = list("abcdefgh")
    scores = [5.0, 1.0, 7.0, 0.0, 9.0, 2.0, 8.0, 6.0]
    rng = np.random.default_rng(0)
    out = evo.select(
        rng, pop, scores,
        lambda r, pa, pb: ("child", pa, pb),
        make_fresh=lambda r: "fresh",
    )
    assert len(out) == 8
    n_elite = max(1, int(evo.ELITE_FRAC * 8))
    assert out[:n_elite] == ["d", "b"]
    n_fresh = int(evo.IMMIGRANT_FRAC * 8)
    assert out[-n_fresh:] == ["fresh"] * n_fresh
    top_half = {"d", "b", "f", "a"}
    for c in out[n_elite:-n_fresh]:
        assert c[0] == "child" and {c[1], c[2]} <= top_half
    rng = np.random.default_rng(0)
    out2 = evo.select(rng, pop, scores, lambda r, pa, pb: "c")
    assert "fresh" not in out2 and len(out2) == 8
    # and JAX's select, fed the same stream, picks the same parents
    rng = np.random.default_rng(0)
    assert jevo.select(rng, pop, scores, lambda r, pa, pb: ("child", pa, pb),
                       make_fresh=lambda r: "fresh") == out


def test_select_tie_break_is_lane_index():
    rng = np.random.default_rng(0)
    out = evo.select(
        rng, ["x", "y", "z", "w"], [1.0, 1.0, 1.0, 1.0],
        lambda r, pa, pb: "c",
    )
    assert out[0] == "x"


def _seeded_population(seed, n=6, n_nodes=5):
    alphabet = srch.Alphabet.classic()
    rng = np.random.default_rng(seed)
    return alphabet, [
        evo.Genome(
            schedule=alphabet.sample(rng, n_nodes),
            seed=int(rng.integers(0, 1 << 16)),
            churn=srch.sample_churn_schedule(rng, 3),
        )
        for _ in range(n)
    ]


def test_population_sha_pins_elitism_determinism():
    """The same rng seed produces byte-for-byte the same next population
    (sha256 over stable genome JSON), and the sha sees the genes."""
    alphabet, pop = _seeded_population(7)
    scores = [3.0, -1.0, 4.0, 0.0, 2.0, 1.0]

    def child(rng, pa, pb):
        sched = evo.crossover_schedules(
            rng, pa.schedule, pb.schedule, alphabet, 5
        )
        return evo.Genome(
            schedule=evo.mutate_schedule(rng, sched, alphabet, 5),
            seed=int(rng.integers(0, 1 << 16)),
        )

    def fresh(rng):
        return evo.Genome(
            schedule=evo.fresh_schedule(rng, alphabet, 5),
            seed=int(rng.integers(0, 1 << 16)),
        )

    shas = []
    for _ in range(2):
        rng = np.random.default_rng((11, 1, 11))
        nxt = evo.select(rng, pop, scores, child, make_fresh=fresh)
        shas.append(evo.population_sha(nxt))
    assert shas[0] == shas[1]
    bumped = list(pop)
    bumped[0] = dataclasses.replace(bumped[0], seed=bumped[0].seed + 1)
    assert evo.population_sha(bumped) != evo.population_sha(pop)


# ---------------- mutation / crossover legality ----------------


def test_mutate_schedule_keeps_crash_discipline():
    alphabet = srch.Alphabet.classic()
    rng = np.random.default_rng(3)
    protected = {0}
    for _ in range(200):
        sched = alphabet.sample(rng, 5)
        out = evo.mutate_schedule(
            rng, sched, alphabet, 5, hunt="duel-churn",
            protected=protected,
        )
        assert 1 <= len(out.episodes) <= alphabet.max_episodes
        crashed = set()
        for e in out.episodes:
            assert e.kind in alphabet.kinds
            if e.kind == "crash":
                crashed |= set(int(n) for n in e.nodes)
        assert len(crashed) <= (5 - 1) // 2
        assert not crashed & protected


def test_crossover_schedules_legal_child():
    alphabet = srch.Alphabet.classic()
    rng = np.random.default_rng(4)
    for _ in range(200):
        a = alphabet.sample(rng, 5)
        b = alphabet.sample(rng, 5)
        out = evo.crossover_schedules(rng, a, b, alphabet, 5)
        assert 1 <= len(out.episodes) <= alphabet.max_episodes
        crashed = {
            int(n) for e in out.episodes if e.kind == "crash"
            for n in e.nodes
        }
        assert len(crashed) <= (5 - 1) // 2


def test_jitter_episode_preserves_width_and_bounds():
    rng = np.random.default_rng(5)
    e = fltm.pause(40, 60, 1)
    for _ in range(50):
        j = evo.jitter_episode(rng, e, 96)
        assert j.t1 - j.t0 == 20
        assert 0 <= j.t0 and j.t1 <= 96 + 20
        assert j.t0 <= 96 - 20


# ---------------- cause-targeted hunting ----------------


def test_hunt_kinds_intersects_alphabet():
    lan = srch.Alphabet.classic()
    gray = srch.Alphabet.classic(gray=True)
    assert evo.hunt_kinds(lan, "gray-region") == ()
    assert evo.hunt_kinds(gray, "gray-region") == ("gray",)
    assert evo.hunt_kinds(lan, "duel-churn") == ("pause", "crash")
    assert evo.hunt_kinds(lan, "saturation") == ("burst",)
    assert evo.hunt_kinds(lan, None) == ()
    assert evo.CAUSE_FAMILIES == jevo.CAUSE_FAMILIES


def test_draw_episode_bias_lands_in_hunted_family():
    """With a hunt armed, the overwhelming majority of mutation draws
    land inside the hunted cause's episode family."""
    alphabet = srch.Alphabet.classic(gray=True)
    rng = np.random.default_rng(6)
    hits = sum(
        evo.draw_episode(rng, alphabet, 5, hunt="gray-region").kind
        == "gray"
        for _ in range(400)
    )
    assert hits >= 0.7 * 400
    rng = np.random.default_rng(6)
    kinds = {
        evo.draw_episode(rng, alphabet, 5).kind for _ in range(400)
    }
    assert kinds == set(srch.KINDS_GRAY)


def test_fresh_schedule_always_carries_hunted_gene():
    alphabet = srch.Alphabet.classic()
    rng = np.random.default_rng(8)
    fam = set(evo.CAUSE_FAMILIES["duel-churn"])
    for _ in range(100):
        sched = evo.fresh_schedule(rng, alphabet, 5, hunt="duel-churn")
        assert any(e.kind in fam for e in sched.episodes)


# ---------------- shared alphabet ----------------


def test_alphabet_classic_preserves_draw_sequence():
    for gray in (False, True):
        a = srch.Alphabet.classic(gray=gray)
        s1 = a.sample(np.random.default_rng(123), 5)
        s2 = srch.sample_schedule(
            np.random.default_rng(123), 5,
            kinds=srch.KINDS_GRAY if gray else srch.KINDS,
        )
        assert s1.to_dict() == s2.to_dict()


def test_alphabet_member_subset_and_protocol():
    a = srch.Alphabet.classic(gray=True, wan=True)
    m = a.member()
    assert "gray" not in m.kinds and not m.wan
    assert m.protocol() is None
    assert a.protocol() is not None
    with pytest.raises(ValueError):
        srch.Alphabet(kinds=("gray",)).member()
    with pytest.raises(ValueError):
        srch.Alphabet(kinds=("nope",))
    with pytest.raises(ValueError):
        a.sample_episode(np.random.default_rng(0), 5, kinds=("bogus",))


# ---------------- churn-schedule genes ----------------


def test_sample_churn_schedule_legal_by_construction():
    rng = np.random.default_rng(9)
    step = max(1, 96 // srch.CHURN_T0_GRID)
    drew_some = 0
    for _ in range(300):
        ch = srch.sample_churn_schedule(rng, 3)
        if ch is None:
            continue
        drew_some += 1
        evs = ch.events
        assert 1 <= len(evs) <= 3
        assert evs[0].wait == ctm.WAIT_NONE
        vids = [int(e.vid) for e in evs]
        assert len(set(vids)) == len(vids)
        added = set()
        for e in evs:
            assert int(e.t0) % step == 0
            if int(e.vid) >= meng.CHANGE_BASE:
                tgt, kind = meng.decode_change(int(e.vid))
                assert tgt != 0
                if kind == meng.ADD_ACCEPTOR:
                    assert tgt not in added
                    added.add(tgt)
                else:
                    assert kind == meng.DEL_ACCEPTOR
                    assert tgt in added
            else:
                assert int(e.vid) >= srch.CHURN_PLAIN_VID_BASE
        assert srch.churn_targets(ch) == {
            meng.decode_change(v)[0] for v in vids
            if v >= meng.CHANGE_BASE
        }
    assert drew_some > 100


def test_churn_plain_vid_base_pins_mc_member():
    assert srch.CHURN_PLAIN_VID_BASE == mc_member.PLAIN_VID_BASE


def test_sample_member_schedule_protects_churn_targets():
    rng = np.random.default_rng(10)
    for _ in range(200):
        ch = srch.sample_churn_schedule(rng, 3)
        sched = srch.sample_member_schedule(rng, 3, ch)
        protected = {0} | srch.churn_targets(ch)
        for e in sched.episodes:
            if e.kind == "crash":
                assert not set(int(n) for n in e.nodes) & protected


# ---------------- serve-axis genomes ----------------


def test_serve_genome_validation_and_weather_cfg():
    from tpu_paxos_torch.config import SimConfig

    with pytest.raises(ValueError):
        sbr.ServeGenome("monsoon", ("poisson",), (250,), 0, 0)
    with pytest.raises(ValueError):
        sbr.ServeGenome("calm", ("poisson",), (333,), 0, 0)
    with pytest.raises(ValueError):
        sbr.ServeGenome("calm", ("poisson", "spike"), (250,), 0, 0)
    cfg = SimConfig(n_nodes=3, n_instances=8)
    assert sbr.weather_cfg(cfg, "squall").faults.drop_rate == 2000
    assert sbr.weather_cfg(cfg, "calm").faults.drop_rate == 0


def test_serve_mutation_never_flips_weather():
    """Weather is the runner-build axis, so no mutation move may leave
    the slot's preset; the draws equal JAX's, genome for genome, and
    each genome's arrival plan equals JAX's lane."""
    from tpu_paxos.serve import breach as jbr

    rng, jrng = np.random.default_rng(12), np.random.default_rng(12)
    wl = [np.arange(10), np.arange(10)]
    g = sbr.sample_serve_genome(rng, wl, "breezy", hunt="saturation")
    jg = jbr.sample_serve_genome(jrng, wl, "breezy", hunt="saturation")
    assert g.weather == "breezy"
    assert all(k in sbr.HUNT_KINDS["saturation"] for k in g.kinds)
    for _ in range(100):
        g = sbr.mutate_serve_genome(rng, g, hunt="saturation")
        jg = jbr.mutate_serve_genome(jrng, jg, hunt="saturation")
        assert dataclasses.asdict(g) == dataclasses.asdict(jg)
        assert g.weather == "breezy"
        assert all(k in sbr.ARRIVAL_KINDS for k in g.kinds)
        assert all(r in sbr.RATE_GRID for r in g.rates)
    for a, b in zip(sbr.lane_of(g, wl).arrivals, jbr.lane_of(jg, wl).arrivals):
        np.testing.assert_array_equal(a, b)
    assert (sbr.WEATHERS, sbr.ARRIVAL_KINDS, sbr.RATE_GRID, sbr.HUNT_KINDS) == (
        jbr.WEATHERS, jbr.ARRIVAL_KINDS, jbr.RATE_GRID, jbr.HUNT_KINDS)


# ---------------- certificate budget + bench guards ----------------


def test_budget_lanes_reads_mc_certificate():
    """The certified-recall denominator comes from the port's byte copy
    of the mc certificate, never hard-coded."""
    certs = mc.load_certificates()
    for axis, scope in evo.BUDGET_SCOPES.items():
        budget, name, denom = evo._budget_lanes(axis, None)
        assert name == scope
        assert denom == int(certs[scope]["scenarios_reduced"])
        assert budget == denom // evo.BUDGET_DIV
        assert (budget, name, denom) == jevo._budget_lanes(axis, None)
    assert evo._budget_lanes("serve", None) == (None, None, None)


def test_bench_record_withheld_unless_certified():
    assert evo.bench_record({"certified": None}, "takeover") is None
    assert evo.bench_record({"certified": False}, "takeover") is None
    summary = {
        "certified": True, "axis": "fleet", "hunt": "duel-churn",
        "lanes": 8, "base_seed": 0, "budget_scope": "quick",
        "budget_denominator": 928, "budget_lanes": 232,
        "lanes_to_first_find": 56, "lanes_to_shrunk_artifact": 74,
        "replay_match": True, "warm_compiles": 0,
        "generations_run": 7, "compiles_per_generation": [2] + [0] * 6,
    }
    rec = evo.bench_record(summary, "takeover")
    assert rec["metric"] == "evolve_recall"
    assert rec["seeded_wedge"] == "takeover"
    assert rec["lanes_to_shrunk_artifact"] == 74
    assert rec["warm_compiles"] == 0
    assert rec == jevo.bench_record(summary, "takeover")


def test_evolve_rejects_unknown_axis_and_hunt():
    with pytest.raises(ValueError):
        evo.evolve(axis="bogus", device=DEV)
    with pytest.raises(ValueError):
        evo.evolve(axis="fleet", hunt="not-a-cause", device=DEV)
    # the lane tile: a population that does not tile the mesh is refused
    # by JAX's name
    from tpu_paxos_torch.parallel import mesh as pmesh

    with pytest.raises(ValueError, match="^3 lanes do not tile over 2 devices$"):
        evo.evolve(axis="fleet", n_lanes=3, generations=1, verbose=False,
                   mesh=pmesh.make_instance_mesh(2, device=DEV), device=DEV)


def test_certified_needs_certificate(tmp_path):
    with pytest.raises(ValueError):
        evo.evolve(
            axis="fleet", certified=True,
            cert_path=str(tmp_path / "missing.json"), device=DEV,
        )


# ---------------- parity: the pure operators, live ----------------


@pytest.mark.parametrize("alphabet", _script.EVOLVE["sweep"]["alphabets"])
def test_operator_sweep_equals_jax(alphabet):
    """``draw_episode``, ``jitter_episode``, ``mutate_schedule``,
    ``crossover_schedules``, ``fresh_schedule`` (with and without a
    hunt) and ``select`` at 8 lanes over 20 seeds of one alphabet: the
    port's outputs equal JAX's, live, and the committed golden."""
    want = [r for r in _gold()["sweep"] if r["alphabet"] == alphabet]
    got = [r for r in _script.evolve_operator_sweep(_script.evolve_modules(port=True))
           if r["alphabet"] == alphabet]
    live = [r for r in _script.evolve_operator_sweep(_script.evolve_modules(port=False))
            if r["alphabet"] == alphabet]
    assert len(got) == _script.EVOLVE["sweep"]["seeds"]
    assert got == live == want


# ---------------- engine-backed loops ----------------


def _run_axis(key: str):
    return _script.evolve_axis(_script.evolve_modules(port=True), key, device=DEV)


@pytest.fixture(scope="module")
def quick_loop(tmp_path_factory):
    """One evolve-quick-shaped run shared by the fleet cells (``make
    evolve-quick``'s arguments), from a cold envelope: synthetic
    decision_round_max wedge, 8 lanes, find -> shrink -> artifact in
    generation 0."""
    tdir = tmp_path_factory.mktemp("evolve-triage")
    envelope.clear_cache()
    return evo.evolve(
        axis="fleet", n_lanes=8, generations=2, base_seed=2,
        decision_round_max=35, max_wedges=1, triage_dir=str(tdir),
        verbose=False, device=DEV,
    ), tdir


@pytest.fixture(scope="module")
def member_loop():
    return _run_axis("member")


@pytest.fixture(scope="module")
def serve_loop():
    return _run_axis("serve")


@pytest.fixture(scope="module")
def lane_causes_loop():
    return _run_axis("lane_causes")


@pytest.mark.slow
def test_fleet_loop_synthetic_end_to_end(quick_loop):
    """sample -> dispatch -> flag -> single-run re-derive -> shrink ->
    schema-closed artifact -> byte-identical replay, with the recall
    accounting split into fleet lanes and shrinker evaluations."""
    s, _ = quick_loop
    assert s["ok"] is True
    assert s["wedges_found"] == 1 and s["real_violations"] == 0
    w = s["wedges"][0]
    assert w["synthetic"] and "decision_round_max" in w["violation"]
    assert s["replay_match"] is True
    assert os.path.exists(s["artifact"])
    assert (
        s["lanes_to_shrunk_artifact"]
        == s["lanes_to_first_find"] + w["shrink_evals"]
    )
    assert s["budget_lanes"] == s["budget_denominator"] // evo.BUDGET_DIV
    assert len(s["population_sha256"]) == 64
    with open(s["artifact"]) as f:
        assert "shrink_evals" not in json.load(f)


@pytest.mark.slow
def test_fleet_loop_zero_warm_compiles(quick_loop):
    """Generation 0 builds the fleet runner (the envelope was cold);
    every later generation builds nothing."""
    s, _ = quick_loop
    assert s["warm_compiles"] == 0
    assert s["compiles_per_generation"][0] >= 1
    assert all(c == 0 for c in s["compiles_per_generation"][1:])


def test_evolve_quick_equals_jax_golden(quick_loop, monkeypatch, capsys):
    """evolve-quick on the port's CPU equals JAX's: the summary less the
    wall fields (the zero pattern of runner builds kept), the shrunk
    artifact's bytes and ``repro --json`` of it, run in its directory."""
    import hashlib

    s, tdir = quick_loop
    gold = _gold()["quick"]
    assert _less(s) == gold["summary"]
    assert s["compiles_per_generation"][0] >= 1  # the cold envelope's build
    with open(s["artifact"], "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == gold["artifact_sha256"]
    monkeypatch.chdir(str(tdir))
    capsys.readouterr()
    assert tcli.main(["repro", os.path.basename(s["artifact"]), "--json",
                      "--device", DEV]) == 0
    assert capsys.readouterr().out == gold["repro_stdout"]


@pytest.mark.slow
def test_lane_causes_match_aggregate_on_single_lane(lane_causes_loop):
    """Per-lane breach attribution and the generation AGGREGATE
    cause_series coincide on a ONE-lane fleet."""
    s = lane_causes_loop["summary"]
    m = s["generation_telemetry"][0]["margins"]
    assert "lane_causes" in m, "flagged lane must carry attribution"
    assert m["lane_causes"]["0"] == m["cause_series"]


def test_lane_causes_case_equals_jax_golden(lane_causes_loop):
    """The one-lane ``lane_causes`` case (hunt duel-churn, the synthetic
    bound at round 1) equals JAX's summary, its margins and causes
    included."""
    s = lane_causes_loop["summary"]
    assert _less(s) == _gold()["lane_causes"]["summary"]
    assert s["warm_compiles"] == 0 and s["compiles_per_generation"][0] >= 1


@pytest.mark.slow
def test_member_axis_loop_smoke(member_loop):
    """The churn+fault axis: genomes carry ChurnSchedule genes, the loop
    dispatches MemberFleetRunner lanes, and recall is metered against
    the churn certificate denominator."""
    s = member_loop["summary"]
    assert s["axis"] == "member"
    assert s["budget_scope"] == "churn"
    certs = mc.load_certificates()
    assert s["budget_denominator"] == int(
        certs["churn"]["scenarios_reduced"]
    )
    assert s["warm_compiles"] == 0
    assert s["generations_run"] == 2 and s["lanes_total"] == 8
    assert s["ok"] is (s["real_violations"] == 0)


def test_member_axis_equals_jax_golden(member_loop):
    """The member axis (4 lanes, 2 generations, duel-churn) equals JAX's:
    populations, wedges and verdicts, its counterexample files, and the
    zero pattern of runner builds (generation 0 builds, generation 1
    nothing)."""
    gold = _gold()["member"]
    s = member_loop["summary"]
    assert _less(s) == gold["summary"]
    assert member_loop["files"] == gold["files"]
    assert s["compiles_per_generation"][0] >= 1 and s["compiles_per_generation"][1:] == [0]


@pytest.mark.slow
def test_serve_axis_surfaces_diagnosed_breach(serve_loop):
    """Offered-load genomes under quantized weather slots drive a
    windowed SLO breach whose attached diagnosis names the hunted
    cause."""
    s = serve_loop["summary"]
    assert s["warm_compiles"] == 0
    assert s["wedges_found"] >= 1
    assert any(
        "saturation" in w.get("causes", ()) for w in s["wedges"]
    ), s["wedges"]
    assert s["ok"] is False and s["real_violations"] >= 1


def test_serve_axis_equals_jax_golden(serve_loop):
    """The serve axis (6 lanes, 3 generations, saturation) equals JAX's:
    genomes, burns, causes, the breach records' bytes, and one runner
    build per weather preset in generation 0."""
    gold = _gold()["serve"]
    s = serve_loop["summary"]
    assert _less(s) == gold["summary"]
    assert serve_loop["files"] == gold["files"]
    assert s["compiles_per_generation"][0] == len(sbr.WEATHERS)


@pytest.mark.slow
def test_certified_recall_beats_quarter_budget(tmp_path, monkeypatch):
    """THE recall pin (BENCH_evolve.json's contract): with the takeover
    wedge re-armed, the duel-churn hunt finds AND shrinks the wedge
    within a QUARTER of the quick scope's lane budget, the artifact
    replays byte-identically, no generation after the first builds
    anything, and the run equals JAX's golden."""
    import hashlib

    from tpu_paxos_torch.harness import shrink as shr

    monkeypatch.setenv("TPU_PAXOS_SEEDED_WEDGE", "takeover")
    envelope.clear_cache()
    try:
        s = evo.evolve(
            axis="fleet", n_lanes=8, generations=29, base_seed=0,
            hunt="duel-churn", certified=True, max_wedges=1,
            triage_dir=str(tmp_path), verbose=False, device=DEV,
        )
    finally:
        envelope.clear_cache()
    assert s["certified"] is True and s["ok"] is True, {
        k: s[k] for k in ("lanes_to_first_find",
                          "lanes_to_shrunk_artifact", "budget_lanes",
                          "replay_match", "warm_compiles")
    }
    assert s["budget_lanes"] == s["budget_denominator"] // 4
    assert s["lanes_to_first_find"] <= s["budget_lanes"]
    assert s["lanes_to_shrunk_artifact"] <= s["budget_lanes"]
    assert s["replay_match"] is True and s["warm_compiles"] == 0
    case, _ = shr.load_artifact(s["artifact"])
    kinds = {e.kind for e in case.cfg.faults.schedule.episodes}
    assert "crash" in kinds
    rec = evo.bench_record(s, "takeover")
    assert rec is not None and rec["lanes_to_first_find"] <= 232
    gold = _gold()["certified"]
    assert _less(s) == gold["summary"]
    with open(s["artifact"], "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == gold["artifact_sha256"]
    with open(os.path.join(ROOT, "BENCH_evolve.json")) as f:
        bench = json.load(f)
    assert _script.evolve_bench_less(rec) == _script.evolve_bench_less(bench)
