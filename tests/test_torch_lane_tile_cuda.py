"""The lane tile on a card, past ``chip_smoke.py``'s time (its phase 20
runs 20a): phase 15c's 256-lane serve fleet (20b), the shard
certificate's four lane drivers at D = 8 and on the (2, 4) mesh and the
tiled ``fleet`` and ``serve --fleet`` CLIs (20c), phase 16c's 256-lane
controlled fleet and phase 14d's 128-lane member fleet, each on 8 ranks
of one mesh, against their JAX goldens; and 20a's run without its
instrumentation, timed beside phase 9's untiled headline.  The ranks are threads of one
process, all on the one card; lanes are independent, so the tile makes
no collective.

These tests need a CUDA card and skip without one.  The file imports
neither ``jax`` nor ``tpu_paxos`` (the card's machine has neither), so
run it there without the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_lane_tile_cuda.py
"""

import hashlib
import json
import os
import time

import pytest
import torch

import chip_smoke
from tpu_paxos_torch.fleet import envelope
from tpu_paxos_torch.parallel import mesh as pmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")
RANKS = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the simkern kernels have no CPU mode")
    return torch.device("cuda")


def _goldens():
    with open(GOLDENS) as f:
        return json.load(f)


def _timed(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9


@pytest.mark.cuda
def test_controlled_fleet_on_the_tile_equals_16c(card):
    """Phase 16c's controlled 256-lane fleet (15c's 128000-milli cell) on
    8 ranks: decisions, sheds, breach vector, verdicts and every lane's
    decision-log sha256 equal JAX's golden; both kernels launch on every
    rank."""
    script = chip_smoke._goldens_script(ROOT)
    gold = _goldens()["control"]
    m = script.serve_modules(port=True)
    envelope.clear_cache()
    mesh = pmesh.make_instance_mesh(RANKS, device="cuda")
    rep, wall, peak = _timed(lambda: script.control_fleet_run(m, device="cuda", mesh=mesh))
    launches = mesh.launch_totals
    rec = script.control_fleet_record(m, rep)
    calls = rep.dispatches * rep.windows_per_dispatch * rep.rounds_per_window
    print(f"\ntiled control fleet: {rep.n_lanes} lanes over {RANKS} ranks, wall_s={wall:.3f} "
          f"round_calls={calls} ms_per_round={wall / calls * 1e3:.3f} (8 ranks) "
          f"lanes_per_sec={rep.n_lanes / wall:.2f} peak_gb={peak:.3f} "
          f"launches_per_rank={json.dumps(launches)} | {chip_smoke._card_line()}")
    assert rec == gold["fleet"]
    assert all(min(c.values()) >= 1 for c in launches)
    envelope.clear_cache()


@pytest.mark.cuda
def test_member_fleet_on_the_tile_equals_14d(card):
    """Phase 14d's 128 member-fleet lanes on 8 ranks (16 a rank): verdicts
    and every lane's decision-log sha256 equal JAX's golden; the member
    round launches no kernel."""
    from tpu_paxos_torch.fleet import member_runner as mrun
    from tpu_paxos_torch.fleet import search

    script = chip_smoke._goldens_script(ROOT)
    gold = _goldens()["member"]["fleet"]
    c = gold["config"]
    lanes = script.member_fleet_lanes(search, c["lanes"], c["n_nodes"], c["rng_seed"],
                                      c["horizon"], c["max_episodes"])
    assert script.genomes_sha256(*lanes) == gold["genomes_sha256"]
    mesh = pmesh.make_instance_mesh(RANKS, device="cuda")
    runner = mrun.MemberFleetRunner(c["n_nodes"], c["n_instances"], max_episodes=c["max_episodes"],
                                    max_rounds=c["max_rounds"], mesh=mesh, device="cuda")
    rep, wall, peak = _timed(lambda: runner.run(*lanes))
    print(f"\ntiled member fleet: {rep.n_lanes} lanes over {RANKS} ranks, wall_s={wall:.3f} "
          f"lanes_per_sec={rep.n_lanes / wall:.2f} rounds_max={rep.iterations} peak_gb={peak:.3f} "
          f"launches_per_rank={json.dumps(mesh.launches)} | {chip_smoke._card_line()}")
    v = rep.verdict
    assert [f for f in v._fields if [x.item() for x in getattr(v, f)] != gold[f]] == []
    shas = [hashlib.sha256(rep.lane_log(i).encode()).hexdigest() for i in range(rep.n_lanes)]
    assert shas == gold["decision_log_sha256"]
    assert all(sum(n.values()) == 0 for n in mesh.launches)


@pytest.mark.cuda
def test_serve_fleet_on_the_tile_equals_15c(card):
    """20b: phase 15c's 256-lane serve fleet at 128000 milli on 8 ranks:
    its record equals 15c's golden, both kernels on every rank."""
    chip_smoke.DEV = str(card)
    envelope.clear_cache()
    mesh = pmesh.make_instance_mesh(RANKS, device="cuda")
    line = chip_smoke.run_tile_serve(chip_smoke._goldens_script(ROOT), _goldens(), mesh, chip_smoke._card_line())
    assert line["round_calls"] == 256
    envelope.clear_cache()


@pytest.mark.cuda
def test_certificate_drivers_and_tiled_clis_on_the_card(card, tmp_path):
    """20c: the four lane drivers at D = 8 and on (2, 4) equal
    ``shard_certificate.json``; ``fleet --mesh 8`` and ``serve --fleet
    --lanes 8 --mesh 8``, started first, print JAX's summaries."""
    chip_smoke.DEV = str(card)
    goldens = _goldens()
    started = chip_smoke.start_tile_clis(goldens, ROOT, str(tmp_path))
    try:
        walls = chip_smoke.run_tile_certificate(chip_smoke._card_line())
    except BaseException:
        for proc, _ in started.values():
            proc.kill()
        raise
    chip_smoke.finish_tile_clis(goldens, chip_smoke._goldens_script(ROOT), started, str(tmp_path), chip_smoke._card_line())
    assert sorted(walls) == ["2x4", "8"]


@pytest.mark.cuda
def test_headline_on_the_tile_clean_timing(card):
    """20a's run without its instrumentation (no sync count, no operand
    copies) beside phase 9's untiled headline run, both timed alike in
    one process: every lane's verdict and decision-log sha256 equal phase
    9's JAX golden on both."""
    import numpy as np

    from tpu_paxos_torch.fleet import runner as frun

    chip_smoke.DEV = str(card)
    goldens = _goldens()
    gold = goldens["fleet"]
    cfg, wl, gates = chip_smoke._fleet_config(goldens)
    seeds, sch, knobs = chip_smoke._fleet_cycle(goldens, "headline")
    mesh = pmesh.make_instance_mesh(RANKS, device="cuda")
    walls = {}
    for name, m in (("untiled", None), ("tiled", mesh)):
        runner = frun.FleetRunner(cfg, wl, gates, mesh=m, device="cuda")
        rep, walls[name], peak = _timed(lambda: runner.run(seeds, sch, knobs=knobs))
        v = rep.verdict
        calls = sum(rep.rank_iterations) if m is not None else rep.iterations
        print(f"\nheadline {name}, clean: wall_s={walls[name]:.3f} round_calls={calls} "
              f"ms_per_round={walls[name] / calls * 1e3:.3f} peak_gb={peak:.3f} "
              f"| {chip_smoke._card_line()}")
        assert [f for f in v._fields
                if np.asarray(getattr(v, f)).tolist() != gold["headline"][f]] == []
        assert [chip_smoke._lane_sha(rep, i, gold["stride"]) for i in range(rep.n_lanes)] == \
            gold["headline"]["decision_log_sha256"]
    print(f"headline tiled over untiled, clean: {walls['tiled'] / walls['untiled']:.2f}x")
