"""The port's host-loop stress sweep (``tpu_paxos_torch/harness/
stress.py``: ``sweep`` and its CLI) against the JAX package's, live on the
CPU: the same summary (less its wall ``seconds``) and the same run, round
for round and decision for decision, for every (mix, seed); the
``_validate_run`` seam's injected failures reach triage and are reported
as the JAX sweep reports them; and ``make stress-quick``'s committed
golden."""

import json
import os

import pytest

from tpu_paxos.fleet import envelope as jenv
from tpu_paxos.harness import stress as jstress
from tpu_paxos.replay.decision_log import decision_log
from tpu_paxos_torch.fleet import envelope as tenv
from tpu_paxos_torch.harness import stress as tstress
from tpu_paxos_torch.harness import validate as tvalidate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _less_seconds(summary):
    return {k: v for k, v in summary.items() if k != "seconds"}


def _recording(monkeypatch, mod):
    """Wrap ``mod._validate_run`` so every judged run is recorded as
    (proposers, rounds, done, crashed, decision log) on the way."""
    seen = []
    real = mod._validate_run

    def rec(r, cfg, workload, chains):
        seen.append((cfg.proposers, int(r.rounds), bool(r.done), r.crashed.tolist(),
                     decision_log(r.chosen_vid, r.chosen_ballot, 1024, cfg.n_instances)))
        return real(r, cfg, workload, chains)

    monkeypatch.setattr(mod, "_validate_run", rec)
    return seen


@pytest.mark.parametrize("mix", ["debug.conf", "crashy", "pause-crash"])
def test_sweep_equals_jax_run_for_run(mix, monkeypatch):
    """Two seeds of one mix: equal summaries, and each seed's run (rounds,
    done, crashed nodes, decision log) equal to the JAX sweep's."""
    jmix = [m for m in jstress.MIXES if m[0] == mix]
    tmix = [m for m in tstress.MIXES if m[0] == mix]
    jseen = _recording(monkeypatch, jstress)
    tseen = _recording(monkeypatch, tstress)
    js = jstress.sweep(n_seeds=2, mixes=jmix, verbose=False)
    ts = tstress.sweep(n_seeds=2, mixes=tmix, verbose=False, device="cpu")
    assert _less_seconds(ts) == _less_seconds(js)
    assert ts["ok"] and ts["runs"] == 2
    assert len(tseen) == 2 and tseen == jseen


def test_injected_failure_reaches_triage_as_in_jax(tmp_path, monkeypatch):
    """A failure injected through the ``_validate_run`` seam fails the
    seed; the shrinker judges candidates by the real suite, finds the case
    green and refuses, so triage records a ``triage_error`` and never
    masks the failure (the JAX sweep's behaviour, summary for summary)."""
    def broken(module):
        def fail(r, cfg, workload, chains):
            raise module.validate.InvariantViolation("injected: always fails")
        return fail

    monkeypatch.setattr(jstress, "_validate_run", broken(jstress))
    monkeypatch.setattr(tstress, "_validate_run", broken(tstress))
    jenv.clear_cache()
    tenv.clear_cache()
    js = jstress.sweep(n_seeds=1, mixes=[jstress.MIXES[1]], verbose=False,
                       triage_dir=str(tmp_path))
    ts = tstress.sweep(n_seeds=1, mixes=[tstress.MIXES[1]], verbose=False,
                       triage_dir=str(tmp_path), device="cpu")
    assert _less_seconds(ts) == _less_seconds(js)
    failure = ts["failures"][0]
    assert not ts["ok"] and failure["error"].startswith("injected")
    assert "does not fail" in failure["triage_error"]
    assert tvalidate.InvariantViolation is tstress.validate.InvariantViolation
    assert not os.listdir(tmp_path)


def test_seeded_wedge_sweep_equals_jax(tmp_path, monkeypatch):
    """``TPU_PAXOS_SEEDED_WEDGE=takeover`` armed (read when each package
    builds its engine): the pause-crash sweep's two seeds find no failing
    seed in either package, summary for summary and run for run, and no
    artifact is written."""
    monkeypatch.setenv("TPU_PAXOS_SEEDED_WEDGE", "takeover")
    jmix = [m for m in jstress.MIXES if m[0] == "pause-crash"]
    tmix = [m for m in tstress.MIXES if m[0] == "pause-crash"]
    jseen = _recording(monkeypatch, jstress)
    tseen = _recording(monkeypatch, tstress)
    try:
        js = jstress.sweep(n_seeds=2, mixes=jmix, verbose=False, triage_dir=str(tmp_path))
        ts = tstress.sweep(n_seeds=2, mixes=tmix, verbose=False, triage_dir=str(tmp_path),
                           device="cpu")
    finally:
        jenv.clear_cache()
        tenv.clear_cache()
    assert _less_seconds(ts) == _less_seconds(js)
    assert ts["ok"] and tseen == jseen and len(tseen) == 2
    assert not os.listdir(tmp_path)


def test_stress_cli_prints_the_sweep_summary(monkeypatch, capsys):
    """``python -m tpu_paxos_torch.harness.stress`` on the CPU: one JSON
    summary line, exit 0 on a green sweep."""
    monkeypatch.setattr(tstress, "MIXES", [tstress.MIXES[0]])
    assert tstress.main(["--seeds", "1", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert (summary["metric"], summary["runs"], summary["ok"]) == ("stress_sweep", 1, True)


def test_mixes_and_workload_equal_jax():
    import numpy as np

    assert [m[0] for m in tstress.MIXES] == [m[0] for m in jstress.MIXES]
    for (_, tk, tn, tp), (_, jk, jn, jp) in zip(tstress.MIXES, jstress.MIXES):
        assert (tn, tp, sorted(tk)) == (jn, jp, sorted(jk))
    for a, b in zip(tstress._workload(2, np.random.default_rng(5)),
                    jstress._workload(2, np.random.default_rng(5))):
        assert [x.tolist() for x in a] == [x.tolist() for x in b]


def test_stress_quick_golden_is_jax_summary():
    """The committed ``stress_quick`` golden (``make stress-quick``'s
    sweep at one seed a mix, the card's phase 11a) is JAX's summary: 10
    mixes, all green."""
    with open(os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")) as f:
        gold = json.load(f)["stress_quick"]["summary"]
    assert gold == {"metric": "stress_sweep", "runs": 10, "mixes": len(tstress.MIXES),
                    "seeds_per_mix": 1, "failures": [], "ok": True}


# ---------------------------------------------------------------- the fleet sweep

FLEET_TIMING = ("seconds", "lanes_per_sec", "compiles_per_mix")


def _less_fleet_timing(summary):
    return {k: v for k, v in summary.items() if k not in FLEET_TIMING}


def test_wan_region_tables_equal_jax():
    assert sorted(tstress.WAN_REGIONS) == sorted(jstress.WAN_REGIONS)
    for label, rmap in jstress.WAN_REGIONS.items():
        assert tstress.WAN_REGIONS[label].tolist() == rmap.tolist()
    assert tstress.WAN_NAMES == jstress.WAN_NAMES


def test_sweep_fleet_reproduces_the_stress_telemetry_golden():
    """``tests/data/stress_telemetry_golden.json`` (JAX's partition-flap
    telemetry block at two seeds) from the port's fleet sweep, exactly;
    the first mix builds its envelope's runner."""
    tenv.clear_cache()
    summary = tstress.sweep_fleet(n_seeds=2, verbose=False, mixes=tstress.EPISODE_MIXES[:1],
                                  device="cpu")
    with open(os.path.join(ROOT, "tests", "data", "stress_telemetry_golden.json")) as f:
        assert summary["telemetry"] == json.load(f)
    assert summary["ok"] and summary["compiles_per_mix"] == {"partition-flap": 1}
    tenv.clear_cache()


def test_sweep_fleet_wan_mix_equals_jax():
    """One WAN mix (per-edge tables, gray and one-way episodes, the
    preset's region map and names) through both fleet sweeps: equal
    summaries less the timing keys, and a second mix of the same
    envelope builds no runner."""
    jmix = [m for m in jstress.WAN_MIXES if m[0] == "wan-3region"]
    tmix = [m for m in tstress.WAN_MIXES if m[0] == "wan-3region"]
    tenv.clear_cache()
    js = jstress.sweep_fleet(n_seeds=2, verbose=False, mixes=jmix)
    ts = tstress.sweep_fleet(n_seeds=2, verbose=False, mixes=tmix, device="cpu")
    assert _less_fleet_timing(ts) == _less_fleet_timing(js)
    assert ts["ok"] and ts["telemetry"]["wan-3region"]["region_pairs"]["n_regions"] == 3
    again = tstress.sweep_fleet(n_seeds=1, verbose=False, mixes=tstress.EPISODE_MIXES[:1],
                                device="cpu")
    assert again["compiles_per_mix"] == {"partition-flap": 0}
    tenv.clear_cache()


def test_stress_fleet_cli_prints_jax_lines(monkeypatch, capsys):
    """``stress --fleet`` prints JAX's two lines, the host-loop sweep over
    the i.i.d.-only mixes and then the fleet summary over the episode and
    WAN mixes (cut here to one of each kind), less the timing keys."""
    for mod in (jstress, tstress):
        monkeypatch.setattr(mod, "MIXES", [m for m in mod.MIXES
                                           if m[0] in ("debug.conf", "pause-heavy")])
        monkeypatch.setattr(mod, "EPISODE_MIXES", [m for m in mod.MIXES if m[0] == "pause-heavy"])
        monkeypatch.setattr(mod, "WAN_MIXES", mod.WAN_MIXES[1:])
    assert jstress.main(["--fleet", "--seeds", "1"]) == 0
    jlines = capsys.readouterr().out.splitlines()
    assert tstress.main(["--fleet", "--seeds", "1", "--device", "cpu"]) == 0
    tlines = capsys.readouterr().out.splitlines()
    assert len(tlines) == len(jlines) == 2
    host = [_less_seconds(json.loads(x)) for x in (tlines[0], jlines[0])]
    fleet = [_less_fleet_timing(json.loads(x)) for x in (tlines[1], jlines[1])]
    assert host[0] == host[1] and host[0]["mixes"] == 1
    assert fleet[0] == fleet[1] and sorted(fleet[0]["telemetry"]) == ["pause-heavy", "wan-5region"]


def test_stress_fleet_golden_is_jax_summary():
    """The committed ``stress_fleet`` golden (``stress --fleet --seeds 8``,
    the card's phase 13c) holds JAX's two green summaries: 6 i.i.d. mixes
    on the host loop, 4 episode and 2 WAN mixes as fleet lanes."""
    with open(os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")) as f:
        gold = json.load(f)["stress_fleet"]
    host, fleet = gold["host"], gold["fleet"]
    assert gold["seeds"] == 8
    assert host == {"metric": "stress_sweep", "runs": 48, "mixes": 6, "seeds_per_mix": 8,
                    "failures": [], "ok": True}
    assert (fleet["metric"], fleet["runs"], fleet["lanes"], fleet["ok"]) == \
        ("stress_sweep_fleet", 48, 48, True)
    assert sorted(fleet["telemetry"]) == sorted(m[0] for m in tstress.EPISODE_MIXES
                                                + tstress.WAN_MIXES)
