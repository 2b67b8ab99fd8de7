"""The port's fleet serving (``tpu_paxos_torch/serve/fleet.py``,
``fleet/envelope.serve_fleet_for``) against the JAX package's, on the
CPU.  Mirrors every non-slow, non-mesh test of
``tests/test_serve_fleet.py``: a 2-lane heterogeneous dispatch equals
JAX's fleet lane for lane and the port's own ``serve_run`` twins; the
per-region series equal the single harness's host twin; the on-device
SLO verdict is a superset of the host judge and equals JAX's exactly;
flagged lanes are confirmed and named per region as JAX names them; the
envelope cache keys and refuses as JAX's; lane validation messages are
JAX's.  The lane tile (``mesh=``) is tests/test_torch_lane_tile_serve.py's
(the controller is tests/test_torch_control.py's).

The module shares one JAX fleet shape (2 lanes, S = 2, K = 10) and one
JAX ``serve_run`` shape, as test_serve_fleet.py does.
"""

import dataclasses
import functools
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_paxos import config as jcfg
from tpu_paxos.core import faults as jflt
from tpu_paxos.core import sim as jsim
from tpu_paxos.fleet import envelope as jenv
from tpu_paxos.serve import arrivals as jarr
from tpu_paxos.serve import fleet as jfl
from tpu_paxos.serve import harness as jh
from tpu_paxos.telemetry import recorder as jrec
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch.core import faults as tflt
from tpu_paxos_torch.core import sim as tsim
from tpu_paxos_torch.fleet import envelope as tenv
from tpu_paxos_torch.replay.decision_log import decision_log
from tpu_paxos_torch.serve import fleet as tfl
from tpu_paxos_torch.serve import harness as th
from tpu_paxos_torch.telemetry import recorder as trec

WL = [np.arange(0, 10, dtype=np.int32), np.arange(20, 30, dtype=np.int32)]
R_WINDOW = 8
S_DISPATCH = 2
ADMIT_W = 10
RMAP = np.asarray([0, 1, 0], np.int32)  # proposer 0 -> us, 1 -> eu


def _cfgs(seed=3):
    kw = dict(n_nodes=3, n_instances=48, proposers=(0, 1), seed=seed, max_rounds=4000)
    return (
        jcfg.SimConfig(faults=jcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2), **kw),
        tcfg.SimConfig(faults=tcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2), **kw),
    )


def _sha(chosen_vid, chosen_ballot):
    text = decision_log(chosen_vid, chosen_ballot, stride=30, n_instances=len(chosen_vid))
    return hashlib.sha256(text.encode()).hexdigest()


def _lane_at_rate(rate_milli, aseed, seed):
    rounds = (jarr.poisson_rounds(20, rate_milli, aseed) if rate_milli > 0
              else jarr.immediate_rounds(20))
    return (WL, [np.sort(rounds[0::2]), np.sort(rounds[1::2])], seed)


_BURST = [np.asarray(sorted([i * 40 for i in range(7)] + [128] * 3), np.int32)] * 2
_CALM = [np.asarray([i * 40 for i in range(10)], np.int32)] * 2

#: name -> (lanes, SLO (latency, budget, regions) or None, region map?)
CELLS = {
    "hetero": ([_lane_at_rate(1500, 7, 3), _lane_at_rate(4000, 8, 4)], None, False),
    "regions": ([_lane_at_rate(1500, 7, 3), _lane_at_rate(4000, 8, 4)], None, True),
    "breach": ([(WL, _BURST, 3), (WL, _CALM, 3)], (16, 400, (("us", 16),)), True),
    "warm": ([_lane_at_rate(2500, 17, 13), _lane_at_rate(6000, 18, 14)], (32, 200, ()), True),
}


def _kwargs(pkg, name, **over):
    lanes, slo, regions = CELLS[name]
    kw = dict(rounds_per_window=R_WINDOW, windows_per_dispatch=S_DISPATCH, admit_width=ADMIT_W)
    if slo is not None:
        kw["slo"] = pkg.ServeSLO(latency_rounds=slo[0], budget_milli=slo[1], regions=slo[2])
    if regions:
        kw["region_map"] = RMAP
        kw["region_names"] = ("us", "eu")
    kw.update(over)
    return lanes, kw


@functools.lru_cache(maxsize=None)
def _jax(name, pipelined=True):
    lanes, kw = _kwargs(jh, name, pipelined=pipelined)
    return jfl.serve_fleet_run(_cfgs()[0], [jfl.ServeLane(*ln) for ln in lanes], **kw)


@functools.lru_cache(maxsize=None)
def _port(name, pipelined=True):
    lanes, kw = _kwargs(th, name, pipelined=pipelined)
    return tfl.serve_fleet_run(_cfgs()[1], [tfl.ServeLane(*ln) for ln in lanes], device="cpu", **kw)


def _serve_twin(name, li):
    lanes, kw = _kwargs(th, name)
    wl, arrs, seed = lanes[li]
    kw.pop("slo", None)
    return th.serve_run(dataclasses.replace(_cfgs()[1], seed=seed), wl, arrs, device="cpu", **kw)


def _strip(d):
    return {k: v for k, v in d.items() if k not in ("wall_seconds", "values_per_sec")}


@pytest.mark.parametrize("name,pipelined", [
    ("hetero", True), ("hetero", False), ("regions", True), ("breach", True), ("breach", False),
    ("warm", True),
])
def test_fleet_equals_jax_lane_for_lane(name, pipelined):
    """Every report field, the ``[lanes]`` breach vector, the confirmed
    verdicts, and per lane the decisions, the summary dict (windows
    included) and the per-region series equal JAX's fleet."""
    got, want = _port(name, pipelined), _jax(name, pipelined)
    for f in ("n_lanes", "seeds", "rounds_per_window", "windows_per_dispatch", "admit_width",
              "window_rounds", "dispatches", "rounds", "done", "n_values",
              "first_breach_dispatch", "slo", "region_names"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("decided", "breach"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    for li in range(got.n_lanes):
        for g, w in zip(got.lane_chosen(li), want.lane_chosen(li)):
            np.testing.assert_array_equal(g, w)
        assert got.lane_summary(li) == want.lane_summary(li), li
        np.testing.assert_array_equal(got.lane_region_windows(li), want.lane_region_windows(li))
    assert _strip(tfl._fleet_point(9, got)) == _strip(jfl._fleet_point(9, want))


def test_single_lane_parity_two_lane_heterogeneous():
    """Each lane is decision-log sha256-identical to the port's own
    single-stream harness run of its (stream, seed)."""
    rep = _port("hetero")
    assert rep.done and rep.backlog == 0
    for li in range(2):
        single = _serve_twin("hetero", li)
        cv, cb = rep.lane_chosen(li)
        assert _sha(cv, cb) == _sha(single.chosen_vid, single.chosen_ballot), li
        assert int(rep.decided[li]) == single.decided_values
        lw = rep.lane_summary(li)["windows"]
        assert lw["lat_hist"] == single.windows["lat_hist"]
        assert lw["decided"] == single.windows["decided"]


def test_single_lane_region_series_match_host_twin():
    rep = _port("regions")
    for li in range(2):
        single = _serve_twin("regions", li)
        rw = rep.lane_region_windows(li)
        np.testing.assert_array_equal(rw, single.region_windows)
        assert rw.sum(axis=0).tolist() == rep.lane_summary(li)["windows"]["lat_hist"]
        assert rw[0].sum() > 0 and rw[1].sum() > 0


def test_zero_load_one_lane_fleet_equals_closed_loop_run():
    _, tc = _cfgs()
    lane = _lane_at_rate(0, 0, 3)
    rep = tfl.serve_fleet_run(tc, [lane], rounds_per_window=R_WINDOW,
                              windows_per_dispatch=S_DISPATCH, admit_width=ADMIT_W, device="cpu")
    closed = tsim.run(tc, WL, device="cpu")
    cv, cb = rep.lane_chosen(0)
    assert _sha(cv, cb) == _sha(closed.chosen_vid, closed.chosen_ballot)


# ---------------- the on-device SLO verdict ----------------


def _crafted():
    w, b, r = trec.NUM_WINDOWS, trec.NUM_LAT_BUCKETS, trec.NUM_REGIONS
    hists = np.zeros((5, w, b), np.int64)
    rws = np.zeros((5, r, w, b), np.int64)
    hists[0, 0, 1] = 40
    hists[1, 2, 1], hists[1, 2, 6] = 20, 20
    hists[2, 3, 1], hists[2, 3, 6] = 30, 10  # burn exactly at the threshold
    hists[3, 1, 2] = 40
    rws[3, 0, 1, 4] = 40  # region 'us' breaches on its own series
    hists[4, 0, 1] = 40
    rws[4, 0, 0, 1] = 40
    for i in range(5):
        if not rws[i].any():
            rws[i, 0] = hists[i]
    return hists, rws


def _host_breach_lanes(hists, region_hists, slo, region_names):
    out = []
    for i in range(hists.shape[0]):
        v = th.slo_windows({"window_rounds": 32, "lat_hist": hists[i]}, slo,
                           region_series=region_hists[i], region_names=region_names)
        out.append(bool(v["breach_windows"]) or any(
            r["breach_windows"] for r in v.get("regions", {}).values()))
    return np.asarray(out)


@pytest.mark.parametrize("budget,burn", [(250, 1.0), (100, 1.0), (250, 0.5), (333, 1.7)])
def test_device_slo_verdict_superset_of_host_judge(budget, burn):
    """Every lane the host judge flags is flagged on the device, and the
    device vector equals JAX's ``_slo_breach`` exactly (float32 on both
    sides), thresholds on the boundary included."""
    hists, rws = _crafted()
    tslo = th.ServeSLO(latency_rounds=16, budget_milli=budget, burn_breach=burn,
                       regions=(("us", 8),))
    jslo = jh.ServeSLO(latency_rounds=16, budget_milli=budget, burn_breach=burn,
                       regions=(("us", 8),))
    host = _host_breach_lanes(hists, rws, tslo, ("us",))
    targs = tfl._slo_args(tslo, ("us",))
    jargs = jfl._slo_args(jslo, ("us",))
    for g, w in zip(targs, jargs):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    dev = tfl._slo_breach(torch.from_numpy(hists).to(torch.int32),
                          torch.from_numpy(rws).to(torch.int32), *targs).numpy()
    want = np.asarray(jfl._slo_breach(jnp.asarray(hists, jnp.int32), jnp.asarray(rws, jnp.int32),
                                      *[jnp.asarray(x) for x in jargs]))
    np.testing.assert_array_equal(dev, want)
    assert (dev | ~host).all(), (dev, host)
    if (budget, burn) == (250, 1.0):
        assert host.tolist() == dev.tolist() == [False, True, True, True, False]


def test_slo_args_inert_and_fallback_thresholds():
    b = trec.NUM_LAT_BUCKETS
    k, rk, budget, burn = tfl._slo_args(None, ())
    assert int(k) == b and (rk == b).all()
    for slo_args in ((dict(latency_rounds=16, budget_milli=100,
                           regions=(("us", 8), ("ap", 64))), ("us",)),
                     (dict(latency_rounds=4, budget_milli=0, burn_breach=2.5), ())):
        got = tfl._slo_args(th.ServeSLO(**slo_args[0]), slo_args[1])
        want = jfl._slo_args(jh.ServeSLO(**slo_args[0]), slo_args[1])
        for g, w in zip(got, want):
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_breaching_lanes_only_confirmed_and_named_per_region():
    rep = _port("breach")
    assert rep.done and rep.backlog == 0
    flagged = set(int(i) for i in np.flatnonzero(rep.breach))
    assert set(rep.slo) == flagged and 0 in flagged
    v = rep.slo[0]
    assert 4 in v["breach_windows"] and v["regions"]["us"]["series"] == "region"
    assert rep.first_breach_dispatch[0] is not None
    assert rep.first_breach_dispatch[0] <= rep.dispatches


# ---------------- envelope cache ----------------


def test_envelope_cache_identity_and_schedule_rejection():
    jc, tc = _cfgs()
    _, _, _, c = tsim.prepare_queues(tc, WL)
    tenv.clear_cache()
    before = tenv.cache_misses()
    r1 = tenv.serve_fleet_for(tc, c, 30, R_WINDOW, window_rounds=32, device="cpu")
    assert r1 is tenv.serve_fleet_for(tc, c, 30, R_WINDOW, window_rounds=32, device="cpu")
    assert tenv.serve_fleet_for(dataclasses.replace(tc, seed=99), c, 30, R_WINDOW,
                                window_rounds=32, device="cpu") is r1
    assert tenv.serve_fleet_for(tc, c, 30, R_WINDOW, window_rounds=64, device="cpu") is not r1
    assert tenv.cache_misses() - before == 2
    tkey = tenv.serve_envelope_key(tc, c, 30, R_WINDOW, 32)
    jkey = jenv.serve_envelope_key(jc, c, 30, R_WINDOW, 32, None)
    assert tkey == jkey + (None,)
    sched = dataclasses.replace(tc, faults=dataclasses.replace(
        tc.faults, schedule=tflt.FaultSchedule((tflt.pause(1, 3, 0),))))
    jsched = dataclasses.replace(jc, faults=dataclasses.replace(
        jc.faults, schedule=jflt.FaultSchedule((jflt.pause(1, 3, 0),))))
    with pytest.raises(ValueError, match="no fault schedule") as te:
        tenv.serve_fleet_for(sched, c, 30, R_WINDOW, window_rounds=32, device="cpu")
    with pytest.raises(ValueError) as je:
        jenv.serve_fleet_for(jsched, c, 30, R_WINDOW, window_rounds=32)
    assert str(te.value) == str(je.value)
    # the lane tile is ported: a tiled runner has a cache entry of its
    # own, which meshes of one layout share, and a lane count that does
    # not tile the mesh is refused by JAX's name
    from tpu_paxos_torch.parallel import mesh as pmesh

    m2 = pmesh.make_instance_mesh(2, device="cpu")
    for fn in (tenv.serve_fleet_for, tenv.serve_control_for):
        tiled = fn(tc, c, 30, R_WINDOW, window_rounds=32, mesh=m2, device="cpu")
        assert tiled.mesh is m2 and tiled is not fn(tc, c, 30, R_WINDOW, window_rounds=32,
                                                    device="cpu")
        assert fn(tc, c, 30, R_WINDOW, window_rounds=32, device="cpu",
                  mesh=pmesh.make_instance_mesh(2, device="cpu")) is tiled
    assert tfl.ServeFleetRunner(tc, c, 30, R_WINDOW, 32, mesh=m2, device="cpu").mesh is m2
    with pytest.raises(ValueError, match="^1 lanes do not tile over 2 devices$"):
        tfl.sweep_fleet_load(tc, 8, [1], [1000], mesh=m2, device="cpu")
    tenv.clear_cache()


# ---------------- validation ----------------


def test_lane_validation_errors():
    jc, tc = _cfgs()
    for call in (
        lambda m, cfg, kw: m.serve_fleet_run(cfg, [], **kw),
        lambda m, cfg, kw: m.serve_fleet_run(
            cfg, [m.ServeLane([WL[0]], [np.zeros(10, np.int32)], 0)], **kw),
        lambda m, cfg, kw: m.serve_fleet_run(cfg, [m.ServeLane(*_lane_at_rate(0, 0, 3))],
                                             admit_width=2, **kw),
        lambda m, cfg, kw: m.serve_fleet_run(cfg, [m.ServeLane(*_lane_at_rate(0, 0, 3))],
                                             windows_per_dispatch=0, **kw),
        lambda m, cfg, kw: m.ServeFleetRunner(cfg, 64, 30, R_WINDOW, 0, **kw),
    ):
        with pytest.raises(ValueError) as je:
            call(jfl, jc, {})
        with pytest.raises(ValueError) as te:
            call(tfl, tc, {"device": "cpu"})
        assert str(te.value) == str(je.value)


def test_sweep_fleet_load_and_verdict_equal_jax():
    """The (lanes x rates) surface at two lane counts and two rates,
    less the wall fields, and its exit verdict."""
    jc, tc = _cfgs()
    kw = dict(rounds_per_window=R_WINDOW, windows_per_dispatch=S_DISPATCH, admit_width=ADMIT_W,
              seed=1)
    want = jfl.sweep_fleet_load(jc, 12, [2], [1500, 6000],
                                slo=jh.ServeSLO(latency_rounds=16), **kw)
    got = tfl.sweep_fleet_load(tc, 12, [2], [1500, 6000], slo=th.ServeSLO(latency_rounds=16),
                               device="cpu", **kw)
    assert tfl.sweep_verdict(got) == jfl.sweep_verdict(want)
    for s in (want, got):
        s.pop("values_per_sec_surface")
        for cell in s["cells"].values():
            cell["points"] = [_strip(pt) for pt in cell["points"]]
    assert got == want
    assert tfl.grid_admit_width(tc, 12, [1, 2], [1500, 6000]) == jfl.grid_admit_width(
        jc, 12, [1, 2], [1500, 6000])
    assert [ln.seed for ln in tfl.fleet_lanes(tc, 3, 12, 2000, 5, "bursty")] == [5, 6, 7]
    for g, w in zip(tfl.fleet_lanes(tc, 3, 12, 2000, 5, "bursty"),
                    jfl.fleet_lanes(jc, 3, 12, 2000, 5, "bursty")):
        for a, b in zip(g.arrivals + g.workload, w.arrivals + w.workload):
            np.testing.assert_array_equal(a, b)


def test_region_window_hist_partitions_the_windowed_histogram():
    rep = _port("regions")
    rw = rep.region_windows.sum(dim=1)
    np.testing.assert_array_equal(rw.numpy(), rep.windows.lat_hist.numpy())
    np.testing.assert_array_equal(rep.region_windows.numpy(),
                                  np.stack([np.asarray(_jax("regions").region_windows[i])
                                            for i in range(2)]))
    assert jrec.NUM_REGIONS == trec.NUM_REGIONS
