"""The port's open-loop serving (``tpu_paxos_torch/serve/``: arrivals,
``core/sim.admit_block``, the recorder's serve helpers, the driver and
the harness) against the JAX package's, on the CPU.

Every non-slow test of ``tests/test_serve.py`` is mirrored here, port
against JAX at the same small size (3 nodes, 48 instances, two 10-value
streams, R = 8, S = 2, K = 10), plus what the port must show beside
them: the arrival draws and plans seed for seed, the dispatch-granularity
twins (S = 1 sequential and the ``window_rounds = 0`` plain program)
with JAX's dispatch counts, ``sweep_load``, a region-map run's
``region_windows``, one dispatch's loop state field by field through
``interop``, and the geometry-padded window.  All equality is exact:
the state is integer and the SLO judge's floats are the same float64
host arithmetic.

JAX compiles are shared: each JAX run is made once per module
(``_jax``), at the one (S, K) shape test_serve.py uses wherever it can.
"""

import dataclasses
import functools
import hashlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_paxos import config as jcfg
from tpu_paxos.core import faults as jflt
from tpu_paxos.core import sim as jsim
from tpu_paxos.serve import arrivals as jarr
from tpu_paxos.serve import driver as jdrv
from tpu_paxos.serve import harness as jh
from tpu_paxos.telemetry import recorder as jrec
from tpu_paxos.utils import prng as jprng
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch import interop
from tpu_paxos_torch.core import geom as tgeo
from tpu_paxos_torch.core import sim as tsim
from tpu_paxos_torch.core import values as tval
from tpu_paxos_torch.replay.decision_log import decision_log
from tpu_paxos_torch.serve import arrivals as tarr
from tpu_paxos_torch.serve import driver as tdrv
from tpu_paxos_torch.serve import harness as th
from tpu_paxos_torch.telemetry import recorder as trec
from tpu_paxos_torch.utils import prng as tprng

NONE = int(tval.NONE)
WL = [np.arange(0, 10, dtype=np.int32), np.arange(20, 30, dtype=np.int32)]
R_WINDOW = 8
S_DISPATCH = 2
ADMIT_W = 10

_MID_STREAM_ARRS = [np.sort(a) for a in (
    np.asarray([0, 2, 3, 9, 9, 11, 17, 20, 21, 33], np.int32),
    np.asarray([0, 0, 5, 8, 13, 13, 14, 25, 30, 31], np.int32),
)]  # mid-stream lulls: the engine quiesces between arrivals
_BURST_ARRS = [
    np.asarray(sorted([i * 40 for i in range(7)] + [128] * 3), np.int32)
    for _ in range(2)
]  # a trickle, then a 6-value burst at round 128 (bucket 4)
_ZERO_ARRS = [np.zeros(10, np.int32)] * 2
_STALL = R_WINDOW - 1
_TRUE_ARRS = [np.asarray([j * R_WINDOW + 1 for j in range(10)], np.int32)] * 2
_CO_ARRS = [a + _STALL for a in _TRUE_ARRS]
_POISSON = jarr.poisson_rounds(20, 1500, seed=7)
_POISSON_ARRS = [np.sort(_POISSON[0::2]), np.sort(_POISSON[1::2])]
_RMAP = np.asarray([0, 1, 0], np.int32)


def _cfgs(seed=3):
    kw = dict(n_nodes=3, n_instances=48, proposers=(0, 1), seed=seed, max_rounds=4000)
    return (
        jcfg.SimConfig(faults=jcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2), **kw),
        tcfg.SimConfig(faults=tcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2), **kw),
    )


def _sha(chosen_vid, chosen_ballot):
    text = decision_log(chosen_vid, chosen_ballot, stride=30, n_instances=len(chosen_vid))
    return hashlib.sha256(text.encode()).hexdigest()


#: The scenarios: (arrivals, serve_run keywords, SLO latency/budget or None, region map).
SCENARIOS = {
    "zero": (_ZERO_ARRS, {}, None, False),
    "mid_pipelined": (_MID_STREAM_ARRS, {"pipelined": True}, None, False),
    "mid_sequential": (_MID_STREAM_ARRS, {"pipelined": False}, None, False),
    "mid_s1": (_MID_STREAM_ARRS, {"windows_per_dispatch": 1, "pipelined": False}, None, False),
    "mid_plain": (_MID_STREAM_ARRS, {"window_rounds": 0}, None, False),
    "poisson": (_POISSON_ARRS, {}, None, False),
    "burst_slo": (_BURST_ARRS, {}, (16, 400), False),
    "burst_slo_seq": (_BURST_ARRS, {"pipelined": False}, (16, 400), False),
    "true_arrs": (_TRUE_ARRS, {}, None, False),
    "co_arrs": (_CO_ARRS, {}, None, False),
    "regions": (_POISSON_ARRS, {}, (16, 400), True),
}


def _kwargs(pkg, name):
    arrs, kw, slo, regions = SCENARIOS[name]
    kw = dict(kw)
    kw.setdefault("rounds_per_window", R_WINDOW)
    kw.setdefault("windows_per_dispatch", S_DISPATCH)
    kw.setdefault("admit_width", ADMIT_W)
    if slo is not None:
        extra = {"regions": (("us", 8), ("eu", 32))} if regions else {}
        kw["slo"] = pkg.ServeSLO(latency_rounds=slo[0], budget_milli=slo[1], **extra)
    if regions:
        kw["region_map"] = _RMAP
        kw["region_names"] = ("us", "eu")
    return arrs, kw


@functools.lru_cache(maxsize=None)
def _jax(name):
    arrs, kw = _kwargs(jh, name)
    return jh.serve_run(_cfgs()[0], WL, arrs, **kw)


def _port(name):
    arrs, kw = _kwargs(th, name)
    return th.serve_run(_cfgs()[1], WL, arrs, device="cpu", **kw)


_FIELDS = ("n_values", "rounds_per_window", "windows_per_dispatch", "admit_width",
           "pipelined", "dispatches", "windows_count", "rounds", "done", "decided_values",
           "backlog", "p50", "p99", "p999", "latency_max", "summary", "window_decided",
           "window_rounds", "windows", "slo", "region_names", "slo_first_breach_dispatch")


def assert_same_report(got, want):
    for f in _FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.chosen_vid, want.chosen_vid)
    np.testing.assert_array_equal(got.chosen_ballot, want.chosen_ballot)
    if want.region_windows is None:
        assert got.region_windows is None
    else:
        np.testing.assert_array_equal(got.region_windows, want.region_windows)


# ---------------- arrival processes (pure host) ----------------


@pytest.mark.parametrize("name", sorted(tarr.ARRIVAL_BUILDERS))
@pytest.mark.parametrize("n,rate,seed", [(64, 2000, 9), (96, 200, 5), (256, 16000, 0), (0, 2000, 5)])
def test_arrival_builders_draw_as_jax(name, n, rate, seed):
    got = tarr.ARRIVAL_BUILDERS[name](n, rate, seed)
    want = jarr.ARRIVAL_BUILDERS[name](n, rate, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_poisson_rounds_deterministic_and_sorted():
    a = tarr.poisson_rounds(64, 2000, seed=9)
    np.testing.assert_array_equal(a, tarr.poisson_rounds(64, 2000, seed=9))
    assert (np.diff(a) >= 0).all() and (tarr.poisson_rounds(64, 2000, seed=10) != a).any()
    assert tarr.poisson_rounds(64, 20_000, seed=9)[-1] < a[-1]
    with pytest.raises(ValueError, match="immediate_rounds"):
        tarr.poisson_rounds(8, 0, seed=0)


def test_realism_builder_shapes_and_rejections_equal_jax():
    for kw in (dict(alpha=2.5), dict(alpha=1.1)):
        np.testing.assert_array_equal(tarr.pareto_rounds(50, 800, 3, **kw),
                                      jarr.pareto_rounds(50, 800, 3, **kw))
    np.testing.assert_array_equal(tarr.bursty_rounds(96, 2000, 5, burst=4),
                                  jarr.bursty_rounds(96, 2000, 5, burst=4))
    np.testing.assert_array_equal(tarr.diurnal_rounds(256, 2000, 5, period=512, depth=0.8),
                                  jarr.diurnal_rounds(256, 2000, 5, period=512, depth=0.8))
    np.testing.assert_array_equal(tarr.spike_rounds(200, 1000, 2, factor=4),
                                  jarr.spike_rounds(200, 1000, 2, factor=4))
    for call in (
        lambda m: m.pareto_rounds(8, 1000, 0, alpha=1.0),
        lambda m: m.bursty_rounds(8, 1000, 0, burst=0),
        lambda m: m.diurnal_rounds(8, 1000, 0, depth=1.0),
        lambda m: m.diurnal_rounds(8, 1000, 0, period=1),
        lambda m: m.spike_rounds(8, 1000, 0, factor=0),
        lambda m: m.tier_priorities([1, 2], n_tiers=0),
        lambda m: m.split_round_robin([1, 2], [0], 2),
    ):
        with pytest.raises(ValueError) as je:
            call(jarr)
        with pytest.raises(ValueError) as te:
            call(tarr)
        assert str(te.value) == str(je.value)
    np.testing.assert_array_equal(tarr.tier_priorities(np.arange(9)), jarr.tier_priorities(np.arange(9)))


def test_arrivals_imports_torch_and_jax_free():
    """The admission planner is numpy only: importing the port's serve
    package and its arrivals module loads neither torch nor jax nor the
    JAX package."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "import tpu_paxos_torch.serve\n"
         "from tpu_paxos_torch.serve import arrivals\n"
         "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'torch', 'tpu_paxos')]\n"
         "assert not bad, bad\n"
         "assert arrivals.poisson_rounds(4, 1000, 0).dtype.kind == 'i'\n"],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_trace_rounds_validation():
    assert (tarr.trace_rounds([0, 1, 1, 5]) == [0, 1, 1, 5]).all()
    for bad, msg in (([3, 2], "nondecreasing"), ([-1, 2], "nonnegative")):
        with pytest.raises(ValueError, match=msg) as te:
            tarr.trace_rounds(bad)
        with pytest.raises(ValueError) as je:
            jarr.trace_rounds(bad)
        assert str(te.value) == str(je.value)
    assert (tarr.immediate_rounds(3) == 0).all()


def test_split_round_robin_preserves_order():
    vids = np.arange(7, dtype=np.int32)
    rounds = np.asarray([0, 0, 1, 2, 2, 3, 9], np.int32)
    for n_prop in (1, 2, 3):
        got = tarr.split_round_robin(vids, rounds, n_prop)
        want = jarr.split_round_robin(vids, rounds, n_prop)
        for g, w in zip(got, want):
            assert [x.tolist() for x in g] == [x.tolist() for x in w]
    streams, arrs = tarr.split_round_robin(vids, rounds, 2)
    assert [s.tolist() for s in streams] == [[0, 2, 4, 6], [1, 3, 5]]


@pytest.mark.parametrize("r_win", [1, 4, 8])
def test_arrival_plan_blocks_equal_jax(r_win):
    """Every window's upload block (values, arrival rounds, priority
    tiers) equals JAX's plan, drain windows included, and each value is
    admitted once at the first boundary at or after its arrival."""
    rng = np.random.default_rng(4)
    rounds = np.sort(rng.integers(0, 40, size=23)).astype(np.int32)
    vids = np.arange(23, dtype=np.int32)
    streams, arrs = tarr.split_round_robin(vids, rounds, 2)
    prios = [tarr.tier_priorities(s) for s in streams]
    tp = tarr.ArrivalPlan(streams, arrs, r_win, prios=prios)
    jp = jarr.ArrivalPlan(streams, arrs, r_win, prios=prios)
    assert (tp.n_windows, tp.n_values, tp.max_block) == (jp.n_windows, jp.n_values, jp.max_block)
    seen = {}
    for j in range(tp.n_windows + 2):
        for g, w in zip(tp.block(j, tp.max_block), jp.block(j, jp.max_block)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tp.prio_block(j, tp.max_block), jp.prio_block(j, jp.max_block))
        admit, arr = tp.block(j, tp.max_block)
        for pi in range(2):
            got = admit[pi][admit[pi] != NONE]
            assert (admit[pi][len(got):] == NONE).all()
            for o, v in enumerate(got):
                assert int(v) not in seen
                seen[int(v)] = (j, int(arr[pi, o]))
    assert len(seen) == 23
    for v, (j, a_round) in seen.items():
        assert a_round == int(rounds[v]) and j * r_win >= a_round
        assert j == 0 or (j - 1) * r_win < a_round


def test_arrival_plan_rejects_too_narrow_width():
    for m in (tarr, jarr):
        plan = m.ArrivalPlan([np.arange(6, dtype=np.int32)], [np.zeros(6, np.int32)], 4)
        with pytest.raises(ValueError, match="admit_width"):
            plan.block(0, plan.max_block - 1)
    for bad in (lambda m: m.ArrivalPlan([WL[0]], [], 4),
                lambda m: m.ArrivalPlan([WL[0]], [np.zeros(9, np.int32)], 4),
                lambda m: m.ArrivalPlan([WL[0]], [np.zeros(10, np.int32)], 0),
                lambda m: m.ArrivalPlan([WL[0]], [np.zeros(10, np.int32)], 4).prio_block(0, 10)):
        with pytest.raises(ValueError) as je:
            bad(jarr)
        with pytest.raises(ValueError) as te:
            bad(tarr)
        assert str(te.value) == str(je.value)


# ---------------- device-side admission + stamping ----------------


def _empty_states(pend0=None, tail0=None):
    jc, tc = _cfgs()
    pend, gate, tail, c = jsim.prepare_queues(jc, WL)
    pend0 = np.full_like(pend, NONE) if pend0 is None else pend0
    tail0 = np.zeros_like(tail) if tail0 is None else tail0
    jst = jsim.init_state(jc, pend0, gate, tail0, jprng.root_key(0))
    tst = tsim.init_state(tc, pend0, gate, tail0, tprng.root_key(0), device="cpu")
    return jst, tst, pend.shape[1]


def _same_queues(tst, jst):
    np.testing.assert_array_equal(tst.prop.pend.numpy(), np.asarray(jst.prop.pend))
    np.testing.assert_array_equal(tst.prop.tail.numpy(), np.asarray(jst.prop.tail))
    np.testing.assert_array_equal(tst.prop.gate.numpy(), np.asarray(jst.prop.gate))


def test_admit_block_appends_at_tail_and_preserves_padding():
    jst, tst, _ = _empty_states()
    for blk in (
        np.asarray([[0, 1, 2, NONE], [20, NONE, NONE, NONE]], np.int32),
        np.asarray([[3, NONE, NONE, NONE], [21, 22, NONE, NONE]], np.int32),
    ):
        jst, tst = jsim.admit_block(jst, blk), tsim.admit_block(tst, blk)
        _same_queues(tst, jst)
    pend2 = tst.prop.pend.numpy()
    assert pend2[0, :4].tolist() == [0, 1, 2, 3] and pend2[1, :3].tolist() == [20, 21, 22]
    assert tst.prop.tail.tolist() == [4, 3]
    assert (pend2[0, 4:] == NONE).all() and (pend2[1, 3:] == NONE).all()


def test_admit_block_wide_block_near_capacity_never_clamps():
    """A block wider than the room left (tail + K past the row end) must
    write through a K-padded row: live entries below the tail stay."""
    _, _, width = _empty_states()
    pend0 = np.full((2, width), NONE, np.int32)
    near = width - 3
    pend0[0, :near] = np.arange(near, dtype=np.int32) + 1000
    jst, tst, _ = _empty_states(pend0, np.asarray([near, 0], np.int32))
    blk = np.full((2, width), NONE, np.int32)
    blk[0, 0] = 7
    jst, tst = jsim.admit_block(jst, blk), tsim.admit_block(tst, blk)
    _same_queues(tst, jst)
    out = tst.prop.pend.numpy()
    assert (out[0, :near] == pend0[0, :near]).all() and out[0, near] == 7
    assert (out[0, near + 1:] == NONE).all() and tst.prop.tail.tolist() == [near + 1, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admit_block_keep_mask_compacts_as_jax(seed):
    """The shed mask: kept values compact to the front in plan order
    (stable), shed ones become NONE, on a lane-stacked state too."""
    rng = np.random.default_rng(seed)
    jst, tst, _ = _empty_states()
    for _ in range(3):
        blk = np.full((2, 6), NONE, np.int32)
        for pi in range(2):
            n = int(rng.integers(0, 7))
            blk[pi, :n] = rng.integers(0, 30, size=n)
        keep = rng.random((2, 6)) < 0.6
        jst = jsim.admit_block(jst, jnp.asarray(blk), jnp.asarray(keep))
        tst = tsim.admit_block(tst, blk, keep)
        _same_queues(tst, jst)
    lanes = tsim.lanes_view(tst)
    two = tsim.admit_block(lanes, torch.from_numpy(blk)[None],
                           torch.from_numpy(keep)[None])
    one = tsim.admit_block(tst, blk, keep)
    np.testing.assert_array_equal(two.prop.pend[0].numpy(), one.prop.pend.numpy())


def test_serve_admit_rounds_filters_noops_and_undecided():
    ingest = np.asarray([5, NONE, 7, 9], np.int32)
    chosen = np.asarray([0, 2, NONE, int(tval.NOOP_BASE) - 3, 3, 99], np.int32)
    want = np.asarray(jrec.serve_admit_rounds(jnp.asarray(ingest), jnp.asarray(chosen)))
    got = trec.serve_admit_rounds(torch.from_numpy(ingest)[None], torch.from_numpy(chosen)[None])
    assert got.shape == (1, 6) and got[0].tolist() == want.tolist() == [5, 7, -1, -1, 9, -1]
    flat = trec.serve_admit_rounds(torch.from_numpy(ingest), torch.from_numpy(chosen))
    assert flat.tolist() == want.tolist()


@pytest.mark.parametrize("seed", [0, 1])
def test_region_window_hist_device_and_host_equal_jax(seed):
    rng = np.random.default_rng(seed)
    v, i, ww = 40, 64, 8
    ingest = np.where(rng.random(v) < 0.8, rng.integers(0, 90, v), NONE).astype(np.int32)
    chosen = rng.integers(-3, v + 5, i).astype(np.int32)
    chosen_round = rng.integers(0, 200, i).astype(np.int32)
    vid_region = rng.integers(-1, 10, v).astype(np.int32)
    adm = jrec.serve_admit_rounds(jnp.asarray(ingest), jnp.asarray(chosen))
    want = np.asarray(jrec.region_window_hist(adm, jnp.asarray(chosen), jnp.asarray(chosen_round),
                                              jnp.asarray(vid_region), ww))
    t = [torch.from_numpy(x)[None] for x in (ingest, chosen, chosen_round, vid_region)]
    got = trec.region_window_hist(trec.serve_admit_rounds(t[0], t[1]), t[1], t[2], t[3], ww)
    np.testing.assert_array_equal(got[0].numpy(), want)
    host = trec.region_window_hist_host(ingest, chosen, chosen_round, vid_region, ww)
    np.testing.assert_array_equal(host, jrec.region_window_hist_host(
        ingest, chosen, chosen_round, vid_region, ww))
    np.testing.assert_array_equal(host, want)


# ---------------- the serving loop ----------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_serve_run_equals_jax(name):
    """Every report field, histogram, windowed series, SLO verdict (its
    diagnosis included), per-region series and decision array equals
    JAX's ``serve_run`` on the same stream."""
    assert_same_report(_port(name), _jax(name))


def test_zero_load_parity_decision_log_sha256():
    """Offered-load-∞ is decision-log-identical to the closed-loop
    ``sim.run``; serve windows run fixed spans past quiescence."""
    rep = _port("zero")
    closed = tsim.run(_cfgs()[1], WL, device="cpu")
    assert rep.done and rep.backlog == 0
    assert _sha(closed.chosen_vid, closed.chosen_ballot) == _sha(rep.chosen_vid, rep.chosen_ballot)
    assert rep.rounds >= closed.rounds


def test_pipelined_sequential_and_plain_twins_run_one_trajectory():
    """Pipelined, sequential, S = 1 and the unwindowed program: the same
    decisions and histogram; only the dispatch counts differ, as JAX's."""
    reps = {n: _port(n) for n in ("mid_pipelined", "mid_sequential", "mid_s1", "mid_plain")}
    base = reps["mid_pipelined"]
    for name, rep in reps.items():
        np.testing.assert_array_equal(rep.chosen_vid, base.chosen_vid)
        np.testing.assert_array_equal(rep.chosen_ballot, base.chosen_ballot)
        for f in ("p50", "p99", "p999", "latency_max", "decided_values", "backlog"):
            assert getattr(rep, f) == getattr(base, f), (name, f)
        assert rep.summary["latency_hist"] == base.summary["latency_hist"]
        assert (rep.dispatches, rep.rounds) == (_jax(name).dispatches, _jax(name).rounds)
    assert reps["mid_s1"].dispatches > base.dispatches
    assert reps["mid_plain"].windows is None and reps["mid_plain"].window_rounds == 0


def test_ingest_stamps_defeat_coordinated_omission():
    a, b = _port("true_arrs"), _port("co_arrs")
    np.testing.assert_array_equal(a.chosen_vid, b.chosen_vid)
    assert a.decided_values == b.decided_values == 20
    assert a.latency_max == b.latency_max + _STALL
    ha, hb = np.cumsum(a.summary["latency_hist"]), np.cumsum(b.summary["latency_hist"])
    assert (ha <= hb).all() and (ha < hb).any()


def test_poisson_open_loop_drains_and_measures_latency():
    rep = _port("poisson")
    assert rep.done and rep.decided_values == 20 and rep.backlog == 0
    assert 0 <= rep.p50 <= rep.p99 <= rep.p999 <= rep.latency_max
    assert rep.window_decided == sorted(rep.window_decided)
    assert rep.dispatches >= 2 and rep.windows_count == rep.dispatches * S_DISPATCH


def test_slo_mid_run_breach_run_total_green():
    rep = _port("burst_slo")
    assert rep.done and rep.slo["total_ok"] and not rep.slo["ok"]
    assert 4 in rep.slo["breach_windows"]
    assert rep.slo["breach_spans"][rep.slo["breach_windows"].index(4)] == [128, 160]
    assert rep.slo_first_breach_dispatch is not None
    assert rep.slo_first_breach_dispatch <= rep.dispatches
    pt, jpt = th._point(0, rep), jh._point(0, _jax("burst_slo"))
    for key in ("wall_seconds", "values_per_sec"):
        pt.pop(key), jpt.pop(key)
    assert pt == jpt and pt["p50_steady"] >= 1


def test_serve_windowed_plane_consistency():
    rep = _port("mid_pipelined")
    w = rep.windows
    assert w is not None and rep.window_rounds == 4 * R_WINDOW
    assert sum(w["decided"]) == rep.summary["decided"]
    assert np.asarray(w["lat_hist"]).sum(axis=0).tolist() == rep.summary["latency_hist"]
    assert sum(w["dropped"]) == rep.summary["dropped_total"]


def test_region_map_run_names_each_region_on_its_own_series():
    rep = _port("regions")
    assert rep.region_windows.shape == (trec.NUM_REGIONS, trec.NUM_WINDOWS, trec.NUM_LAT_BUCKETS)
    assert rep.region_windows.sum(axis=0).tolist() == rep.windows["lat_hist"]
    assert rep.region_windows[0].sum() > 0 and rep.region_windows[1].sum() > 0
    assert {v["series"] for v in rep.slo["regions"].values()} == {"region"}


def test_window_cache_reuses_the_window_and_refuses_schedules():
    _, tc = _cfgs()
    _, _, _, c = tsim.prepare_queues(tc, WL)
    vb = tdrv.vid_bound_of(WL)
    one = tdrv.window_for(tc, c, vb, R_WINDOW, device="cpu")
    assert one is tdrv.window_for(tc, c, vb, R_WINDOW, device="cpu")
    assert tdrv.window_for(tc, c, vb, R_WINDOW + 1, device="cpu") is not one
    assert tdrv.engine_static_key(tc) == jdrv.engine_static_key(_cfgs()[0])
    from tpu_paxos_torch.core import faults as tflt

    sched = dataclasses.replace(tc, faults=dataclasses.replace(
        tc.faults, schedule=tflt.FaultSchedule((tflt.pause(1, 3, 0),))))
    jsched = dataclasses.replace(_cfgs()[0], faults=dataclasses.replace(
        _cfgs()[0].faults, schedule=jflt.FaultSchedule((jflt.pause(1, 3, 0),))))
    with pytest.raises(ValueError, match="no fault schedule") as te:
        tdrv.window_for(sched, c, vb, R_WINDOW, device="cpu")
    with pytest.raises(ValueError) as je:
        jdrv.window_for(jsched, c, vb, R_WINDOW)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="no fault schedule"):
        tdrv.build_serve_window(sched, c, vb, R_WINDOW, device="cpu")
    # audit_entries is ported (analysis/registry.py): JAX's entry names
    assert [e.name for e in tdrv.audit_entries()] == [e.name for e in jdrv.audit_entries()]
    with pytest.raises(ValueError, match="at least one value"):
        tdrv.vid_bound_of([np.zeros(0, np.int32)])


def test_serve_run_argument_errors_equal_jax():
    jc, tc = _cfgs()
    for kw in (dict(admit_width=2), dict(windows_per_dispatch=0),
               dict(window_rounds=0, slo="slo")):
        for pkg, cfg, extra in ((jh, jc, {}), (th, tc, {"device": "cpu"})):
            k = dict(kw, **extra)
            if k.get("slo") == "slo":
                k["slo"] = pkg.ServeSLO(latency_rounds=8)
            with pytest.raises(ValueError) as e:
                pkg.serve_run(cfg, WL, _ZERO_ARRS, **k)
            if pkg is jh:
                want = str(e.value)
        assert str(e.value) == want
    with pytest.raises(ValueError, match="one value stream per proposer"):
        th.serve_run(tc, WL[:1], _ZERO_ARRS[:1], device="cpu")
    with pytest.raises(ValueError, match="unknown region"):
        from tpu_paxos_torch.core import wan as twan

        th.region_slo(twan.PRESETS["wan-3region"], {"mars": 4}, latency_rounds=8)


def test_one_dispatch_state_equals_jax_field_for_field():
    """The loop state crosses both ways (``interop``): JAX's initial
    state, given to the port's window, comes out of one S = 2 dispatch
    equal to JAX's dispatch of it, leaf for leaf, with the summaries."""
    jc, tc = _cfgs()
    vb = jdrv.vid_bound_of(WL)
    ww = 4 * R_WINDOW
    root = jprng.root_key(jc.seed)
    jss, c = jdrv.init_serve_state(jc, WL, vb, root, window_rounds=ww)
    start = jax.tree.map(np.asarray, jss)
    tss = interop.serve_state_from_jax(start, device="cpu")
    t_init, _ = tdrv.init_serve_state(tc, WL, vb, tprng.root_key(tc.seed), window_rounds=ww,
                                      device="cpu")
    _same_tree(interop.serve_state_to_numpy(t_init), start)
    plan = jarr.ArrivalPlan(WL, _MID_STREAM_ARRS, R_WINDOW)
    admits = np.stack([plan.block(i, ADMIT_W)[0] for i in range(S_DISPATCH)])
    arrs = np.stack([plan.block(i, ADMIT_W)[1] for i in range(S_DISPATCH)])
    jfn = jdrv.window_for(jc, c, vb, R_WINDOW, window_rounds=ww)
    jout = jfn(jss, root, jnp.asarray(admits), jnp.asarray(arrs))
    tfn = tdrv.window_for(tc, c, vb, R_WINDOW, window_rounds=ww, device="cpu")
    tout = tfn(tss, tprng.root_key(tc.seed), admits, arrs)
    _same_tree(interop.serve_state_to_numpy(tout[0]), jax.tree.map(np.asarray, jout[0]))
    assert bool(tout[1]) == bool(jout[1]) and int(tout[2]) == int(jout[2]) == 2 * R_WINDOW
    _same_tree(interop.serve_state_to_numpy(tout[3]), jax.tree.map(np.asarray, jout[3]))
    _same_tree(interop.serve_state_to_numpy(tout[4]), jax.tree.map(np.asarray, jout[4]))


def _same_tree(got, want, path="state"):
    if isinstance(want, np.ndarray) or np.isscalar(want):
        want = np.asarray(want)
        got = np.asarray(got)
        assert got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    names = getattr(want, "_fields", None) or range(len(want))
    for k in names:
        g = getattr(got, k) if isinstance(k, str) else got[k]
        w = getattr(want, k) if isinstance(k, str) else want[k]
        _same_tree(g, w, f"{path}.{k}")


def _drive(fn, ss, root, plan, n_prop, *gp):
    """Dispatches of ``fn`` over ``plan`` until a dispatch past every
    admission reports done (the sequential loop)."""
    n_disp = (plan.n_windows + S_DISPATCH - 1) // S_DISPATCH
    for d in range(200):
        blocks = [plan.block(d * S_DISPATCH + i, ADMIT_W) for i in range(S_DISPATCH)]
        admits = np.full((S_DISPATCH, n_prop, ADMIT_W), NONE, np.int32)
        arrs = np.zeros((S_DISPATCH, n_prop, ADMIT_W), np.int32)
        for i, (a, r) in enumerate(blocks):
            admits[i, :a.shape[0]], arrs[i, :r.shape[0]] = a, r
        out = fn(ss, root, admits, arrs, *gp)
        ss = out[0]
        if d + 1 >= n_disp and bool(out[1]):
            return ss, out
    raise AssertionError("the stream did not drain")


def test_geometry_padded_window_equals_the_unpadded_one():
    """``build_serve_window(geometry=)``: the 3-node, 2-proposer tenant
    served through the 5-node, 3-proposer bound makes the unpadded
    window's decisions, round for round."""
    _, tc = _cfgs()
    genv = tgeo.GeometryEnvelope(menu=((3, (0, 1)), (5, (0, 1, 2))))
    bcfg = genv.bound_cfg(tc)
    gm = tgeo.geometry_for(genv, 3, (0, 1))
    pkn = tgeo.protocol_knobs(tc.protocol, stall_patience=tsim.IDLE_RESTART_ROUNDS)
    vb, ww = tdrv.vid_bound_of(WL), 4 * R_WINDOW
    root = tprng.root_key(tc.seed)
    plan = tarr.ArrivalPlan(WL, _MID_STREAM_ARRS, R_WINDOW)
    ss, c = tdrv.init_serve_state(tc, WL, vb, root, window_rounds=ww, device="cpu")
    flat, fout = _drive(tdrv.window_for(tc, c, vb, R_WINDOW, window_rounds=ww, device="cpu"),
                        ss, root, plan, 2)
    wl3 = WL + [np.zeros((0,), np.int32)]
    pss, pc = tdrv.init_serve_state(bcfg, wl3, vb, root, window_rounds=ww, geometry=genv,
                                    geom=gm, pknobs=pkn, device="cpu")
    fn = tdrv.window_for(bcfg, pc, vb, R_WINDOW, window_rounds=ww, geometry=genv, device="cpu")
    padded, pout = _drive(fn, pss, root, plan, 3, gm, pkn)
    assert int(pout[2]) == int(fout[2])
    for f in ("chosen_vid", "chosen_round", "chosen_ballot"):
        np.testing.assert_array_equal(getattr(padded.sim.met, f).numpy(),
                                      getattr(flat.sim.met, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(padded.sim.learned[:3].numpy(), flat.sim.learned.numpy())
    np.testing.assert_array_equal(padded.ingest.numpy(), flat.ingest.numpy())
    assert pout[3].lat_hist.tolist() == fout[3].lat_hist.tolist()


def test_sweep_load_equals_jax():
    """The latency-at-load sweep and its knee, less the wall fields."""
    jc, tc = _cfgs()
    kw = dict(rounds_per_window=R_WINDOW, windows_per_dispatch=S_DISPATCH, admit_width=ADMIT_W,
              seed=2)
    want = jh.sweep_load(jc, 20, [1500, 6000], slo=jh.ServeSLO(latency_rounds=16), **kw)
    got = th.sweep_load(tc, 20, [1500, 6000], slo=th.ServeSLO(latency_rounds=16), device="cpu",
                        **kw)
    for s in (want, got):
        for pt in s["points"]:
            pt.pop("wall_seconds"), pt.pop("values_per_sec")
    assert got == want


# ---------------- knee judgment (pure host) ----------------


def test_judge_knee_brackets_saturation():
    points = [
        {"rate_milli": 1000, "p50": 10, "sustained": True},
        {"rate_milli": 2000, "p50": 12, "sustained": True},
        {"rate_milli": 4000, "p50": 25, "sustained": True},
        {"rate_milli": 8000, "p50": 400, "sustained": False},
    ]
    for pts in (points, points[:2], []):
        assert th.judge_knee(pts, factor=2.0) == jh.judge_knee(pts, factor=2.0)
    k = th.judge_knee(points, factor=2.0)
    assert (k["last_sustained_milli"], k["first_saturated_milli"]) == (2000, 4000)


def test_judge_knee_prefers_windowed_steady_median():
    points = [
        {"rate_milli": 1000, "p50": 10, "p50_steady": 10, "sustained": True},
        {"rate_milli": 2000, "p50": 16, "p50_steady": 40, "sustained": True},
    ]
    bare = [{k: v for k, v in pt.items() if k != "p50_steady"} for pt in points]
    for pts in (points, bare):
        assert th.judge_knee(pts) == jh.judge_knee(pts)
    assert th.judge_knee(points)["first_saturated_milli"] == 2000
    assert th.judge_knee(bare)["first_saturated_milli"] is None


def test_serve_point_shape():
    pt = th._point(2000, _port("zero"))
    jpt = jh._point(2000, _jax("zero"))
    assert pt["sustained"] and pt["decided"] == 20 and pt["backlog"] == 0
    assert set(pt) == set(jpt)
    assert {k: v for k, v in pt.items() if k not in ("wall_seconds", "values_per_sec")} == {
        k: v for k, v in jpt.items() if k not in ("wall_seconds", "values_per_sec")}
