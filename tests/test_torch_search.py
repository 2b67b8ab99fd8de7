"""The port's schedule search (``tpu_paxos_torch/fleet/search.py``:
``search``, ``_generation_margins``, ``lane_cause_series`` and the
``python -m tpu_paxos_torch fleet`` CLI) against the JAX package's on the
CPU: the same summary less its wall-clock keys (``seconds``,
``lanes_per_sec``, each wedge's ``shrink_seconds``), with and without a
triage directory, the wedge artifact byte for byte, the gray/WAN grammar,
and the margins and per-lane causes of one armed report.  JAX's side of
those runs is :func:`jax_goldens`, committed as ``goldens.json``'s
``tests.search`` by ``scripts/torch_port_goldens.py`` (the slow tier
recomputes it); the samplers are held to JAX live.  The committed
phase-13 goldens are JAX's own summaries."""

import hashlib
import json
import os

import numpy as np
import pytest

from tpu_paxos import config as jcfg
from tpu_paxos.fleet import envelope as jenv
from tpu_paxos.fleet import runner as jrun
from tpu_paxos.fleet import search as jsearch
from tpu_paxos.harness import stress as jstress
from tpu_paxos_torch import __main__ as tcli
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch.fleet import envelope as tenv
from tpu_paxos_torch.fleet import runner as trun
from tpu_paxos_torch.fleet import search as tsearch
from tpu_paxos_torch.harness import stress as tstress
from tpu_paxos_torch.telemetry import recorder as trec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(n_lanes=4, generations=1, base_seed=2, decision_round_max=35, max_episodes=2,
          horizon=48, max_wedges=1, verbose=False)
GRAY_WAN = dict(n_lanes=4, generations=1, base_seed=0, gray=True, wan=True, verbose=False)
TIMING = ("seconds", "lanes_per_sec")


def _less_timing(summary: dict) -> dict:
    """A summary less its wall-clock keys, with artifact paths cut to
    their basename (the triage directories differ)."""
    out = json.loads(json.dumps(summary, sort_keys=True))
    for k in TIMING:
        out.pop(k)
    for w in out["wedges"]:
        w.pop("shrink_seconds", None)
        if "artifact" in w:
            w["artifact"] = os.path.basename(w["artifact"])
    return out


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _json(x):
    """``x`` as JSON reads it back (the form a golden is committed in)."""
    return json.loads(json.dumps(x, sort_keys=True))


FLAGGED = ((), (1, 3))


def _armed_report(cfgm, search, stress, env, run, **kw):
    """One armed 4-lane dispatch of the search's own envelope (gray
    schedules; lanes 1 and 3 are flagged by hand in the margins)."""
    wl, gates, _ = stress._workload(2, np.random.default_rng(2))
    cfg = cfgm.SimConfig(n_nodes=5, n_instances=56, proposers=(0, 1), seed=2,
                         max_rounds=20_000,
                         faults=cfgm.FaultConfig(drop_rate=300, dup_rate=500, max_delay=2))
    runner = env.runner_for(cfg, wl, gates, max_episodes=run.MAX_EPISODES, telemetry=True,
                            **kw)
    rng = np.random.default_rng(9)
    alpha = search.Alphabet.classic(gray=True)
    scheds = [alpha.sample(rng, 5) for _ in range(4)]
    return runner.run([40, 41, 42, 43], scheds, workloads=[(wl, gates)] * 4,
                      knobs=[cfg.faults] * 4)


def _margins(search, rep) -> dict:
    return _json({"margins": [search._generation_margins(rep, flagged=set(f)) for f in FLAGGED],
                  "causes": search.lane_cause_series(rep, [3, 0])})


def jax_goldens(tmp: str) -> dict:
    """JAX's side of this file's runs, as ``goldens.json``'s
    ``tests.search`` holds it: the triaged search's summary (less timing),
    its triage directory's files and their sha256, the untriaged and the
    gray/WAN searches' summaries, and the armed report's margins and
    causes."""
    j = jsearch.search(triage_dir=tmp, **KW)
    return {
        "triaged": _less_timing(j),
        "triage_files": {name: _sha(os.path.join(tmp, name)) for name in sorted(os.listdir(tmp))},
        "untriaged": _less_timing(jsearch.search(**KW)),
        "gray_wan": _less_timing(jsearch.search(**GRAY_WAN)),
        "armed": _margins(jsearch, _armed_report(jcfg, jsearch, jstress, jenv, jrun)),
    }


@pytest.fixture(scope="module")
def want():
    with open(os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")) as f:
        return json.load(f)["tests"]["search"]


@pytest.fixture(scope="module")
def triaged(tmp_path_factory):
    """The small synthetic-wedge search on the port, with a triage
    directory."""
    tdir = tmp_path_factory.mktemp("port")
    return tsearch.search(triage_dir=str(tdir), device="cpu", **KW), tdir


def test_search_with_triage_equals_jax(triaged, want):
    t, tdir = triaged
    assert _less_timing(t) == want["triaged"]
    assert t["wedges_found"] == 1 and t["ok"] and t["wedges"][0]["synthetic"]
    assert t["wedges"][0]["shrink_seconds"] >= 0
    names = sorted(os.listdir(tdir))
    assert names == sorted(want["triage_files"]) == ["repro_fleet_g0_lane0.json"]
    assert _sha(tdir / names[0]) == want["triage_files"][names[0]]


def test_search_without_triage_equals_jax(want):
    t = tsearch.search(device="cpu", **KW)
    assert _less_timing(t) == want["untriaged"]
    assert "artifact" not in t["wedges"][0]
    # every generation's margins carry the windowed series and causes
    m = t["generation_telemetry"][0]["margins"]
    assert len(m["stall_margin_series"]) == len(m["cause_series"]) == trec.NUM_WINDOWS
    assert sorted(m["lane_causes"]) == ["0", "1", "2", "3"]


def test_gray_wan_search_equals_jax(want):
    t = tsearch.search(device="cpu", **GRAY_WAN)
    assert _less_timing(t) == want["gray_wan"]
    assert t["ok"] and t["lanes_total"] == 4


def test_generation_margins_and_lane_causes_equal_jax(want):
    trep = _armed_report(tcfg, tsearch, tstress, tenv, trun, device="cpu")
    assert _margins(tsearch, trep) == want["armed"]
    # a recorder-free report has no margins, as in JAX
    wl, gates, _ = tstress._workload(2, np.random.default_rng(2))
    rep = trun.FleetRunner(trep.cfg, wl, gates, device="cpu").run([1], [None])
    assert tsearch._generation_margins(rep) == {} and tsearch.lane_cause_series(rep, [0]) == {}


def test_fleet_cli_prints_the_search_summary(want, capsys):
    """``python -m tpu_paxos_torch fleet`` (here in process) prints the
    search's one sorted JSON line and exits 0 on a synthetic wedge."""
    argv = ["fleet", "--lanes", "4", "--generations", "1", "--seed", "2",
            "--decision-round-max", "35", "--max-episodes", "2", "--horizon", "48",
            "--max-wedges", "1", "--quiet", "--device", "cpu"]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("\n") == 1
    got = json.loads(out)
    assert out.strip() == json.dumps(got, sort_keys=True)
    summary = _json(want["triaged"])
    for w in summary["wedges"]:
        w.pop("artifact", None)
    assert _less_timing(got) == summary


def test_unported_search_surfaces_raise_by_name(capsys):
    # the lane tile is ported: search refuses lanes that do not tile the
    # mesh by JAX's name, and the CLI pads the lane count to tile it
    from tpu_paxos_torch.parallel import mesh as pmesh

    with pytest.raises(ValueError, match="^3 lanes do not tile over 2 devices$"):
        tsearch.search(n_lanes=3, generations=1, verbose=False,
                       mesh=pmesh.make_instance_mesh(2, device="cpu"), device="cpu")
    assert tsearch.main(["--mesh", "2", "--lanes", "1", "--generations", "0", "--quiet",
                         "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["lanes"] == 2
    # the membership samplers are ported (test_member_samplers_equal_jax)
    assert tsearch.churn_targets(None) == set()


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("n_nodes", [3, 5])
def test_member_samplers_equal_jax(seed, n_nodes):
    """The membership-axis draws equal JAX's for the same Generator seed:
    the churn schedule, its protected targets and the member-legal fault
    schedule, draw after draw, with the generators left in one state."""
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for max_events in (0, 3, 6):
        jc = jsearch.sample_churn_schedule(jr, n_nodes, max_events=max_events, horizon=64)
        tc = tsearch.sample_churn_schedule(tr, n_nodes, max_events=max_events, horizon=64)
        assert (tc is None) == (jc is None)
        if jc is not None:
            assert tc.to_dict() == jc.to_dict()
        assert tsearch.churn_targets(tc) == jsearch.churn_targets(jc)
        js = jsearch.sample_member_schedule(jr, n_nodes, churn=jc, max_episodes=3, horizon=64)
        ts = tsearch.sample_member_schedule(tr, n_nodes, churn=tc, max_episodes=3, horizon=64)
        assert ts.to_dict() == js.to_dict()
        assert all(e.kind != "gray" for e in ts.episodes)
    assert tr.integers(1 << 30) == jr.integers(1 << 30)
    gates = (0, 1, 2)
    jc = jsearch.sample_churn_schedule(jr, n_nodes, wait_gates=gates, plain_values=4)
    tc = tsearch.sample_churn_schedule(tr, n_nodes, wait_gates=gates, plain_values=4)
    assert (tc.to_dict() if tc else None) == (jc.to_dict() if jc else None)


def test_member_alphabet_equals_jax():
    for gray, wan in ((False, False), (True, True)):
        ja = jsearch.Alphabet.classic(gray=gray, wan=wan).member()
        ta = tsearch.Alphabet.classic(gray=gray, wan=wan).member()
        assert (ta.kinds, ta.wan, ta.max_episodes, ta.horizon) == (
            ja.kinds, ja.wan, ja.max_episodes, ja.horizon)
    with pytest.raises(ValueError, match="no member-legal kinds"):
        tsearch.Alphabet(kinds=("gray",)).member()
    with pytest.raises(ValueError, match="no member-legal kinds"):
        jsearch.Alphabet(kinds=("gray",)).member()
    assert (tsearch.CHURN_T0_GRID, tsearch.CHURN_PLAIN_VID_BASE) == (
        jsearch.CHURN_T0_GRID, jsearch.CHURN_PLAIN_VID_BASE)


def test_member_fleet_genomes_equal_the_golden():
    """The card's phase-14d lanes, drawn by the port's samplers, are the
    genomes the committed member-fleet golden was computed on."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(ROOT, "scripts", "torch_port_goldens.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    with open(os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")) as f:
        gold = json.load(f)["member"]["fleet"]
    c = gold["config"]
    drawn = script.member_fleet_lanes(tsearch, c["lanes"], c["n_nodes"], c["rng_seed"],
                                      c["horizon"], c["max_episodes"])
    assert script.genomes_sha256(*drawn) == gold["genomes_sha256"]
    jdrawn = script.member_fleet_lanes(jsearch, 8, c["n_nodes"], c["rng_seed"], c["horizon"],
                                       c["max_episodes"])
    assert script.genomes_sha256(*jdrawn) == script.genomes_sha256(*[x[:8] for x in drawn])


def test_phase13_search_goldens_are_jax_summaries():
    """The committed fleet-quick and wide-search goldens (the card's
    phases 13a-b) are green JAX summaries of the arguments they name, and
    the committed wedge artifact is the one they name."""
    with open(os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")) as f:
        gold = json.load(f)["search"]
    quick, wide = gold["fleet_quick"], gold["search_wide"]
    assert quick["args"] == ["--lanes", "8", "--generations", "1", "--seed", "2",
                             "--decision-round-max", "35", "--max-wedges", "1"]
    s = quick["summary"]
    assert (s["lanes"], s["wedges_found"], s["ok"]) == (8, 1, True)
    assert s["wedges"][0]["artifact"] == quick["artifact"] == "repro_fleet_g0_lane0.json"
    path = os.path.join(ROOT, "tpu_paxos_torch", "data", quick["artifact"])
    assert _sha(path) == quick["artifact_sha256"]
    assert (wide["lanes"], wide["summary"]["lanes_total"], wide["summary"]["ok"]) == (128, 256, True)
    assert len(wide["summary"]["generation_telemetry"]) == 2


@pytest.mark.slow
def test_jax_goldens_recompute(tmp_path, want):
    """JAX's side of this file, recomputed, equals the committed golden."""
    assert _json(jax_goldens(str(tmp_path))) == want
