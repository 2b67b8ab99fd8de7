"""The port's schedule search (``tpu_paxos_torch/fleet/search.py``:
``search``, ``_generation_margins``, ``lane_cause_series`` and the
``python -m tpu_paxos_torch fleet`` CLI) against the JAX package's, live on
the CPU: the same summary less its wall-clock keys (``seconds``,
``lanes_per_sec``, each wedge's ``shrink_seconds``), with and without a
triage directory, the wedge artifact byte for byte, the gray/WAN grammar,
and the margins and per-lane causes of one armed report.  The committed
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


@pytest.fixture(scope="module")
def triaged(tmp_path_factory):
    """The small synthetic-wedge search, both packages, with a triage
    directory each (the JAX compiles are the expensive part)."""
    jdir, tdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    j = jsearch.search(triage_dir=str(jdir), **KW)
    t = tsearch.search(triage_dir=str(tdir), device="cpu", **KW)
    return j, t, jdir, tdir


def test_search_with_triage_equals_jax(triaged):
    j, t, jdir, tdir = triaged
    assert _less_timing(t) == _less_timing(j)
    assert t["wedges_found"] == 1 and t["ok"] and t["wedges"][0]["synthetic"]
    assert t["wedges"][0]["shrink_seconds"] >= 0
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) == ["repro_fleet_g0_lane0.json"]
    assert _sha(tdir / names[0]) == _sha(jdir / names[0])


def test_search_without_triage_equals_jax():
    j = jsearch.search(**KW)
    t = tsearch.search(device="cpu", **KW)
    assert _less_timing(t) == _less_timing(j)
    assert "artifact" not in t["wedges"][0]
    # every generation's margins carry the windowed series and causes
    m = t["generation_telemetry"][0]["margins"]
    assert len(m["stall_margin_series"]) == len(m["cause_series"]) == trec.NUM_WINDOWS
    assert sorted(m["lane_causes"]) == ["0", "1", "2", "3"]


def test_gray_wan_search_equals_jax():
    j = jsearch.search(**GRAY_WAN)
    t = tsearch.search(device="cpu", **GRAY_WAN)
    assert _less_timing(t) == _less_timing(j)
    assert t["ok"] and t["lanes_total"] == 4


def _armed_reports():
    """One armed 4-lane dispatch of the search's own envelope, both
    packages (gray schedules, lanes 1 and 3 flagged by hand)."""
    reps = []
    for cfgm, search, stress, env, run in ((jcfg, jsearch, jstress, jenv, jrun),
                                           (tcfg, tsearch, tstress, tenv, trun)):
        wl, gates, _ = stress._workload(2, np.random.default_rng(2))
        cfg = cfgm.SimConfig(n_nodes=5, n_instances=56, proposers=(0, 1), seed=2,
                             max_rounds=20_000,
                             faults=cfgm.FaultConfig(drop_rate=300, dup_rate=500, max_delay=2))
        kw = {} if run is jrun else {"device": "cpu"}
        runner = env.runner_for(cfg, wl, gates, max_episodes=run.MAX_EPISODES, telemetry=True,
                                **kw)
        rng = np.random.default_rng(9)
        alpha = search.Alphabet.classic(gray=True)
        scheds = [alpha.sample(rng, 5) for _ in range(4)]
        reps.append(runner.run([40, 41, 42, 43], scheds, workloads=[(wl, gates)] * 4,
                               knobs=[cfg.faults] * 4))
    return reps


def test_generation_margins_and_lane_causes_equal_jax():
    jrep, trep = _armed_reports()
    for flagged in ((), (1, 3)):
        assert tsearch._generation_margins(trep, flagged=set(flagged)) == \
            jsearch._generation_margins(jrep, flagged=set(flagged))
    assert tsearch.lane_cause_series(trep, [3, 0]) == jsearch.lane_cause_series(jrep, [3, 0])
    # a recorder-free report has no margins, as in JAX
    wl, gates, _ = tstress._workload(2, np.random.default_rng(2))
    rep = trun.FleetRunner(trep.cfg, wl, gates, device="cpu").run([1], [None])
    assert tsearch._generation_margins(rep) == {} and tsearch.lane_cause_series(rep, [0]) == {}


def test_fleet_cli_prints_the_search_summary(triaged, capsys):
    """``python -m tpu_paxos_torch fleet`` (here in process) prints the
    search's one sorted JSON line and exits 0 on a synthetic wedge."""
    j = triaged[0]
    argv = ["fleet", "--lanes", "4", "--generations", "1", "--seed", "2",
            "--decision-round-max", "35", "--max-episodes", "2", "--horizon", "48",
            "--max-wedges", "1", "--quiet", "--device", "cpu"]
    assert tcli.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("\n") == 1
    got = json.loads(out)
    assert out.strip() == json.dumps(got, sort_keys=True)
    want = _less_timing(j)
    for w in want["wedges"]:
        w.pop("artifact", None)
    assert _less_timing(got) == want


def test_unported_search_surfaces_raise_by_name():
    with pytest.raises(NotImplementedError, match="mesh"):
        tsearch.search(n_lanes=2, generations=1, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="--mesh"):
        tsearch.main(["--mesh", "2", "--device", "cpu"])
    for name in ("sample_churn_schedule", "churn_targets", "sample_member_schedule"):
        with pytest.raises(NotImplementedError, match=name):
            getattr(tsearch, name)(np.random.default_rng(0), 5)
    with pytest.raises(NotImplementedError, match="member"):
        tsearch.Alphabet.classic().member()


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
