"""The port's flight recorder (tpu_paxos_torch/telemetry/recorder.py and
the armed engine and fleet) against the JAX package's, on the CPU, at
exact equality: all recorder state is integer.

- A single armed run equals the plain run's decisions and JAX's
  ``run_with_telemetry`` summary, windows and phase ledger, with and
  without the windowed plane and a region map.
- The armed round makes the plain round's host reads, no more.
- An armed fleet with ``run(regions=)`` equals JAX's armed
  ``FleetRunner`` lane for lane (summaries, windows, dicts), and its
  decisions equal the plain fleet's.
- A lane parked at a fixed point gives the windows and summary of JAX's
  run that counts every round to the budget.
- The device reductions on crafted inputs and every host helper on
  JAX's crafted cases equal JAX's.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_paxos import config as jcfg
from tpu_paxos.core import faults as jflt
from tpu_paxos.core import sim as jsim
from tpu_paxos.core import wan as jwan
from tpu_paxos.fleet import envelope as jenv
from tpu_paxos.fleet import runner as jrun
from tpu_paxos.telemetry import recorder as jrec
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch.core import faults as tflt
from tpu_paxos_torch.core import sim as tsim
from tpu_paxos_torch.fleet import envelope as tenv
from tpu_paxos_torch.fleet import runner as trun
from tpu_paxos_torch.harness import stress as tstress
from tpu_paxos_torch.replay.decision_log import decision_log as tlog
from tpu_paxos_torch.telemetry import recorder as trec

WL = [np.arange(100, 108, dtype=np.int32), np.arange(200, 208, dtype=np.int32)]
W = trec.NUM_WINDOWS
B = trec.NUM_LAT_BUCKETS


def _sched(f):
    return f.FaultSchedule((
        f.partition(2, 10, (0,), (1, 2)),
        f.pause(3, 8, 2),
        f.burst(4, 9, 1500),
    ))


def _single_cfg(m, f):
    """tests/test_telemetry.py's single-run parity config: 3 nodes, 32
    instances, a schedule and drop/dup/delay/crash."""
    return m.SimConfig(
        n_nodes=3, proposers=(0, 1), n_instances=32, seed=3, max_rounds=4000,
        faults=m.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2,
                             crash_rate=1000, schedule=_sched(f)),
    )


def _sha(r, stride=208):
    return hashlib.sha256(tlog(
        np.asarray(r.chosen_vid), np.asarray(r.chosen_ballot), stride, len(r.chosen_vid),
    ).encode()).hexdigest()


def _same_tree(j, t, what):
    assert type(t).__name__ == type(j).__name__
    for name in j._fields:
        np.testing.assert_array_equal(np.asarray(getattr(t, name)), np.asarray(getattr(j, name)),
                                      err_msg=f"{what}.{name}")


def _same_result(a, b):
    for f in ("learned", "chosen_vid", "chosen_round", "chosen_ballot", "crashed", "msgs"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.rounds, a.done) == (b.rounds, b.done)


# ---------------- the single armed run ----------------


@pytest.mark.parametrize("window_rounds,region_map", [
    (16, None), (16, [2, 0, 1]), (0, None),
])
def test_single_run_equals_plain_and_jax(window_rounds, region_map):
    jc, tc = _single_cfg(jcfg, jflt), _single_cfg(tcfg, tflt)
    plain = tsim.run(tc, WL, device="cpu")
    res, summ, wsum, ledger = tsim.run_with_telemetry(
        tc, WL, window_rounds=window_rounds, region_map=region_map, return_ledger=True,
        device="cpu",
    )
    _same_result(res, plain)
    jres, jsumm, jwsum, jledger = jsim.run_with_telemetry(
        jc, WL, window_rounds=window_rounds, region_map=region_map, return_ledger=True,
    )
    _same_result(res, jres)
    _same_tree(jsumm, summ, "summary")
    if window_rounds:
        _same_tree(jwsum, wsum, "windows")
        assert int(np.asarray(wsum.decided).sum()) == int(summ.decided)
    else:
        assert wsum is None and jwsum is None
    assert list(ledger) == list(jledger)
    for k in jledger:
        np.testing.assert_array_equal(ledger[k], np.asarray(jledger[k]), err_msg=k)
    wr = window_rounds or trec.WINDOW_ROUNDS
    assert trec.summary_to_dict(summ, wsum, wr) == jrec.summary_to_dict(jsumm, jwsum, wr)
    assert int(summ.heal_gap) >= 0 and int(summ.lat_max) >= 1


def test_armed_round_makes_the_plain_rounds_host_reads(monkeypatch):
    """Every host read of a round goes through ``sim._any`` (a predicate
    read to the host) or ``sim._global_max`` (the packed reads: the
    window test and the round's completion, conflict and send tests);
    ``_lane_any`` stays on the device.  The armed round calls each
    exactly as often as the plain round."""
    tc = _single_cfg(tcfg, tflt)
    calls = {"_any": 0, "_lane_any": 0, "_global_max": 0}
    for name in calls:
        real = getattr(tsim, name)

        def counting(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(tsim, name, counting)
    plain = tsim.run(tc, WL, device="cpu")
    plain_calls = dict(calls)
    calls.update({k: 0 for k in calls})
    armed, _, _ = tsim.run_with_telemetry(tc, WL, device="cpu")
    assert armed.rounds == plain.rounds
    assert calls == plain_calls and plain_calls["_any"] > plain.rounds
    assert plain_calls["_global_max"] >= 2 * plain.rounds


def test_round_fn_takes_and_returns_the_recorder():
    """``round_fn`` refuses a missing recorder with JAX's message, and
    one round of an armed single run returns ``(state, tele)``;
    ``window_rounds`` without ``telemetry`` is JAX's ValueError."""
    jc, tc = _single_cfg(jcfg, jflt), _single_cfg(tcfg, tflt)
    pend, gate, tail, c = tsim.prepare_queues(tc, WL)
    with pytest.raises(ValueError) as je:
        jsim.build_engine(jc, c, window_rounds=16)
    with pytest.raises(ValueError) as te:
        tsim.build_engine(tc, c, device="cpu", window_rounds=16)
    assert str(te.value) == str(je.value)
    root = tsim.prng.root_key(tc.seed)
    st = tsim.init_state(tc, pend, gate, tail, root, device="cpu")
    rf = tsim.build_engine(tc, c, device="cpu", telemetry=True, window_rounds=16)
    with pytest.raises(TypeError) as te:
        rf(root, st)
    jrf = jsim.build_engine(jc, c, telemetry=True)
    with pytest.raises(TypeError) as je:
        jrf(None, None)
    assert str(te.value) == str(je.value)
    tele = (tsim.lane_of(trec.init_telemetry(32, 2, 3, device="cpu"), 0),
            tsim.lane_of(trec.init_windows(3, device="cpu"), 0))
    for _ in range(4):
        st, tele = rf(root, st, tele=tele)
    assert int(st.t) == 4 and tele[0].offered.shape == (7,)
    assert tele[1].offered.shape == (W,) and int(tele[1].offered.sum()) == int(tele[0].offered.sum())


# ---------------- the armed fleet ----------------

SCHEDS = [
    lambda f: f.FaultSchedule((f.partition(5, 20, (0, 1), (2, 3, 4)),)),
    lambda f: f.FaultSchedule((f.one_way(5, 25, (0,), (2, 3)),)),
    lambda f: f.FaultSchedule((f.pause(4, 20, 1), f.burst(8, 18, 2000))),
    lambda f: None,
]
LANES = [(k, seed) for k in range(len(SCHEDS)) for seed in (0, 1)]
FLEET_WL = [np.arange(100, 110, dtype=np.int32), np.arange(200, 210, dtype=np.int32)]
REGIONS = [jwan.node_regions(jwan.WAN3, 5).tolist(), None,
           jwan.node_regions(jwan.WAN5, 5).tolist(), [4, 4, 0, 0, 9]] * 2


def _fleet_cfg(m):
    return m.SimConfig(
        n_nodes=5, n_instances=64, proposers=(0, 1), seed=0, max_rounds=4000,
        faults=m.FaultConfig(drop_rate=300, dup_rate=500, max_delay=2),
    )


@pytest.fixture(scope="module")
def armed_fleets():
    """JAX's armed 8-lane dispatch, the port's armed and plain ones."""
    seeds = [s for _, s in LANES]
    jrep = jrun.FleetRunner(_fleet_cfg(jcfg), FLEET_WL, telemetry=True).run(
        seeds, [SCHEDS[k](jflt) for k, _ in LANES], regions=REGIONS)
    trep = trun.FleetRunner(_fleet_cfg(tcfg), FLEET_WL, device="cpu", telemetry=True).run(
        seeds, [SCHEDS[k](tflt) for k, _ in LANES], regions=REGIONS)
    plain = trun.FleetRunner(_fleet_cfg(tcfg), FLEET_WL, device="cpu").run(
        seeds, [SCHEDS[k](tflt) for k, _ in LANES])
    return jrep, trep, plain


def test_armed_fleet_equals_jax_lane_by_lane(armed_fleets):
    jrep, trep, _ = armed_fleets
    _same_tree(jax.tree.map(np.asarray, jrep.telemetry), trep.telemetry, "telemetry")
    _same_tree(jax.tree.map(np.asarray, jrep.windows), trep.windows, "windows")
    for i in range(8):
        assert trep.lane_telemetry(i) == jrep.lane_telemetry(i), f"lane {i}"
    for f in jrep.verdict._fields:
        np.testing.assert_array_equal(np.asarray(getattr(trep.verdict, f)),
                                      np.asarray(getattr(jrep.verdict, f)), err_msg=f)
    # a region map puts its pairs' traffic where it says
    assert trep.lane_telemetry(0)["region_pairs"]["n_regions"] == 3
    assert trep.lane_telemetry(1)["region_pairs"]["n_regions"] == 1


def test_armed_fleet_decides_as_the_plain_fleet(armed_fleets):
    _, trep, plain = armed_fleets
    assert plain.telemetry is None and plain.lane_telemetry(0) is None
    for i in range(8):
        a, b = trep.lane_result(i), plain.lane_result(i)
        _same_result(a, b)
        assert _sha(a, 211) == _sha(b, 211)
    # each armed lane's summary is its single armed run's
    lane = 4
    res, summ, wsum = tsim.run_with_telemetry(
        trep.lane_cfg(lane), FLEET_WL, region_map=REGIONS[lane], device="cpu")
    assert trep.lane_telemetry(lane) == trec.summary_to_dict(summ, wsum, trec.WINDOW_ROUNDS)


def test_armed_envelope_is_its_own_cache_slot():
    tenv.clear_cache()
    jenv.clear_cache()
    tc = _fleet_cfg(tcfg)
    plain = tenv.runner_for(tc, FLEET_WL, device="cpu")
    armed = tenv.runner_for(tc, FLEET_WL, telemetry=True, device="cpu")
    assert armed is not plain and armed.telemetry and not plain.telemetry
    assert tenv.runner_for(tc, FLEET_WL, telemetry=True, device="cpu") is armed
    assert armed.explicit_inputs_only
    tenv.clear_cache()


def test_parked_lane_windows_equal_the_full_loop():
    """Node 3 is cut off while both proposers crash with values still
    queued: the lane never finishes.  The port parks it at its fixed
    point; JAX runs every round to the budget, writing the lane's
    constant backlog into every bucket on the way.  The windows and the
    summary (rounds at the budget, no heal gap) are equal, on the fleet
    and on a single run."""
    wl, gates, _ = tstress._workload(2, np.random.default_rng(0))
    cfg = tcfg.SimConfig(
        n_nodes=5, n_instances=56, proposers=(0, 1), max_rounds=300,
        faults=tcfg.FaultConfig(max_delay=8),
    )

    def dead(f):
        return f.FaultSchedule((f.partition(2, 10, (1, 2, 4, 0), (3,)), f.crash(6, 0, 1)))

    rep = trun.FleetRunner(cfg, wl, gates, device="cpu", telemetry=True).run(
        [12, 3], [dead(tflt), None],
        knobs=[tcfg.FaultConfig(), tcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2)],
    )
    budget = cfg.max_rounds + dead(tflt).horizon
    assert rep.iterations < budget // 2  # parked, not run out
    jc = jcfg.SimConfig(n_nodes=5, n_instances=56, proposers=(0, 1), max_rounds=300, seed=12,
                        faults=jcfg.FaultConfig(schedule=dead(jflt)))
    _, jsumm, jwsum = jsim.run_with_telemetry(jc, wl, gates)
    want = jrec.summary_to_dict(jsumm, jwsum, jrec.WINDOW_ROUNDS)
    assert rep.lane_telemetry(0) == want
    assert want["rounds"] == budget and want["heal_gap"] == -1
    # the backlog outlives the crash in every bucket up to the budget
    assert min(want["windows"]["backlog_max"]) > 0
    res, summ, wsum = tsim.run_with_telemetry(rep.lane_cfg(0), wl, gates, device="cpu")
    assert res.rounds == budget
    assert trec.summary_to_dict(summ, wsum, trec.WINDOW_ROUNDS) == want


# ---------------- device reductions on crafted inputs ----------------


def test_window_bucket_boundaries():
    ts = [0, 15, 16, 17, 31, 32, 16 * (W - 1) - 1, 16 * (W - 1), 10_000]
    want = [int(jrec.window_bucket(t, 16)) for t in ts]
    assert [trec.window_bucket(t, 16) for t in ts] == want
    got = trec.window_bucket(torch.tensor(ts, dtype=torch.int32), 16)
    assert got.tolist() == want == [0, 0, 1, 1, 1, 2, W - 2, W - 1, W - 1]


@pytest.mark.parametrize("case", ["short_run", "boundary_overflow", "phases", "random"])
def test_summarize_windows_equals_jax(case):
    rng = np.random.default_rng(5)
    if case == "short_run":
        cv, cr, adm = [100, 101, -1, 102], [3, 7, -1, 9], [1, 1, -1, 2]
        stamps = None
    elif case == "boundary_overflow":
        hi = 16 * (W + 3)
        cv, cr, adm = [100, 101, 102, -1, -3], [15, 16, hi, -1, 20], [10, 10, 10, -1, -1]
        stamps = None
    else:
        n = 300 if case == "random" else 40
        cr = rng.integers(0, 400, n)
        cv = np.where(rng.random(n) < 0.8, rng.integers(-5, 1000, n), -1)
        cr = np.where(cv == -1, -1, cr)
        adm = np.where(rng.random(n) < 0.9, np.maximum(cr - rng.integers(0, 300, n), 0), -1)
        stamps = [np.where(rng.random(n) < 0.7, cr + rng.integers(0, 600, n), -1) for _ in range(2)]
    cv, cr, adm = (np.asarray(x, np.int32) for x in (cv, cr, adm))
    jw = jrec.init_windows(3)
    jw = jw._replace(offered=jnp.arange(W, dtype=jnp.int32))
    kw_j, kw_t = {}, {}
    if stamps is not None:
        st = [np.asarray(s, np.int32) for s in stamps]
        kw_j = dict(batch_round=jnp.asarray(adm), learned_round=jnp.asarray(st[0]),
                    committed_round=jnp.asarray(st[1]))
        kw_t = {k: torch.from_numpy(np.array(v))[None] for k, v in kw_j.items()}
    want = jrec.summarize_windows(jw, jnp.asarray(adm), jnp.asarray(cv), jnp.asarray(cr), 16, **kw_j)
    tw = trec.init_windows(3, device="cpu")
    tw = tw._replace(offered=torch.arange(W, dtype=torch.int32)[None])
    got = trec.summarize_windows(
        tw, torch.from_numpy(adm)[None], torch.from_numpy(cv)[None], torch.from_numpy(cr)[None],
        16, **kw_t)
    _same_tree(jax.tree.map(np.asarray, want), trec.lane(got, 0), case)


def test_count_copies_and_region_reduce_equal_jax():
    rng = np.random.default_rng(7)
    for shape in ((2, 5), (5, 2), (3, 3)):
        al = rng.random((4, *shape)) < 0.7
        dl = rng.integers(0, 4, (4, *shape)).astype(np.int32)
        mask = rng.random(shape) < 0.6
        want = jrec.count_copies(jnp.asarray(al), jnp.asarray(dl), jnp.asarray(mask))
        got = trec.count_copies(torch.from_numpy(al)[None], torch.from_numpy(dl)[None],
                                torch.from_numpy(mask)[None])
        assert [int(x[0]) for x in got] == [int(x) for x in want]
    counts = rng.integers(0, 50, (5, 5)).astype(np.int32)
    for rmap in ([0, 0, 1, 1, 2], [7, 9, -3, 2, 2], None):
        want = np.asarray(jrec.region_reduce(
            jnp.asarray(counts), jnp.zeros(5, jnp.int32) if rmap is None else jnp.asarray(rmap)))
        got = trec.region_reduce(torch.from_numpy(counts)[None],
                                 None if rmap is None else np.asarray(rmap))
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_init_accumulators_equal_jax():
    _same_tree(jax.tree.map(np.asarray, jrec.init_telemetry(12, 2, 5)),
               trec.lane(trec.init_telemetry(12, 2, 5, device="cpu"), 0), "telemetry")
    _same_tree(jax.tree.map(np.asarray, jrec.init_windows(5)),
               trec.lane(trec.init_windows(5, device="cpu"), 0), "windows")
    lanes = trec.init_telemetry(12, 2, 5, lanes=3, device="cpu")
    assert lanes.admit_round.shape == (3, 12) and lanes.edge_cut.shape == (3, 5, 5)


@pytest.mark.parametrize("name,n_args", [
    ("serve_admit_rounds", 2), ("region_window_hist", 5), ("region_window_hist_host", 5),
])
def test_serve_only_helpers_raise_by_name(name, n_args):
    """The serve-only helpers once raised by name; they are ported now
    (serving), and each equals JAX's on a crafted stream whose tables
    hold no-op fills, undecided and out-of-table vids and clamped
    regions (the cases keep their names)."""
    rng = np.random.default_rng(n_args)
    ingest = np.where(rng.random(24) < 0.8, rng.integers(0, 60, 24), -1).astype(np.int32)
    chosen = rng.integers(-4, 30, 40).astype(np.int32)
    rounds = rng.integers(0, 300, 40).astype(np.int32)
    regions = rng.integers(-2, 11, 24).astype(np.int32)
    jadm = jrec.serve_admit_rounds(jnp.asarray(ingest), jnp.asarray(chosen))
    tin = [torch.from_numpy(x)[None] for x in (ingest, chosen, rounds, regions)]
    tadm = trec.serve_admit_rounds(tin[0], tin[1])
    if name == "serve_admit_rounds":
        got, want = tadm[0].numpy(), np.asarray(jadm)
    elif name == "region_window_hist":
        got = trec.region_window_hist(tadm, tin[1], tin[2], tin[3], 16)[0].numpy()
        want = np.asarray(jrec.region_window_hist(
            jadm, jnp.asarray(chosen), jnp.asarray(rounds), jnp.asarray(regions), 16))
    else:
        got = trec.region_window_hist_host(ingest, chosen, rounds, regions, 16)
        want = jrec.region_window_hist_host(ingest, chosen, rounds, regions, 16)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------- host helpers on JAX's crafted cases ----------------


def _mk_summary(m, **over):
    base = dict(
        msgs=np.arange(7, dtype=np.int32), offered=np.full(7, 100, np.int32),
        dropped=np.full(7, 5, np.int32), duped=np.full(7, 2, np.int32),
        delayed=np.full(7, 3, np.int32), learns=np.int32(48), commit_acks=np.int32(9),
        takeovers=np.int32(1), requeues=np.int32(4), restarts=np.int32(2),
        decided=np.int32(16),
        lat_hist=np.asarray([0, 8, 0, 8, 0, 0, 0, 0, 0, 0], np.int32),
        lat_max=np.int32(5), heal_gap=np.int32(24), stall_max=np.int32(3),
        duel_max=np.int32(4), takeover_round=np.asarray([7, -1], np.int32),
        rounds=np.int32(34), quiescent=np.bool_(True),
        region_offered=np.zeros((8, 8), np.int32), region_dropped=np.zeros((8, 8), np.int32),
        region_cut=np.zeros((8, 8), np.int32),
    )
    base["region_offered"][0, 2], base["region_dropped"][0, 2] = 40, 7
    base["region_cut"][2, 1] = 3
    base.update(over)
    return m.TelemetrySummary(**base)


def _mk_windows(m, **over):
    lat = np.zeros((W, B), np.int32)
    lat[0, 1], lat[2, 4] = 4, 6
    phase = np.zeros((W, m.NUM_PHASES, B), np.int32)
    phase[:, m.PHASE_CONSENSUS, :] = lat
    base = dict(
        offered=np.asarray([100] + [10] * (W - 1), np.int32),
        dropped=np.asarray([10] + [1] * (W - 1), np.int32),
        duped=np.full(W, 2, np.int32), delayed=np.full(W, 3, np.int32),
        stall_max=np.asarray([0, 5] + [1] * (W - 2), np.int32),
        takeovers=np.asarray([0, 1] + [0] * (W - 2), np.int32),
        restarts=np.asarray([2] + [0] * (W - 1), np.int32),
        cut=np.zeros(W, np.int32), backlog_max=np.asarray([3] + [0] * (W - 1), np.int32),
        node_offered=np.full((W, 3), 10, np.int32), node_delay=np.zeros((W, 3), np.int32),
        decided=lat.sum(axis=1).astype(np.int32), lat_hist=lat, phase_hist=phase,
    )
    base.update(over)
    return m.WindowSummary(**base)


def _stack(trees):
    return type(trees[0])(*[np.stack(xs) for xs in zip(*trees)])


def _lane_stacks(m):
    lane2_lat = np.zeros((W, B), np.int32)
    lane2_lat[2, 6] = 2
    s = _stack([
        _mk_summary(m),
        _mk_summary(m, heal_gap=np.int32(-1), stall_max=np.int32(9), lat_max=np.int32(7),
                    duel_max=np.int32(2), rounds=np.int32(500), quiescent=np.bool_(False)),
        _mk_summary(m, heal_gap=np.int32(3)),
    ])
    w = _stack([
        _mk_windows(m),
        _mk_windows(m, stall_max=np.asarray([7] + [0] * (W - 1), np.int32), lat_hist=lane2_lat,
                    decided=lane2_lat.sum(axis=1).astype(np.int32)),
        _mk_windows(m),
    ])
    return s, w


HOST_CASES = {
    "latency_quantile": lambda m: [
        m.latency_quantile(h, q, mx)
        for h in (np.zeros(10, np.int32), np.asarray([0, 3, 1, 0, 2, 0, 0, 0, 0, 1], np.int32),
                  np.eye(10, dtype=np.int32)[3] * 8, np.eye(10, dtype=np.int32)[9] * 4)
        for q in (0.5, 0.99) for mx in (-1, 1, 5, 7, 413)
    ],
    "summary_to_dict": lambda m: m.summary_to_dict(_mk_summary(m)),
    "summary_to_dict_windows": lambda m: m.summary_to_dict(
        _mk_summary(m), _mk_windows(m), 16, ("us", "eu", "ap")),
    "summary_to_dict_zero_offered": lambda m: m.summary_to_dict(_mk_summary(
        m, offered=np.zeros(7, np.int32), dropped=np.zeros(7, np.int32))),
    "margins_vector": lambda m: m.margins_vector(_mk_summary(m)),
    "windows_to_dict": lambda m: m.windows_to_dict(_mk_windows(m), 16, lat_max=14),
    "reduce_lanes": lambda m: m.reduce_lanes(*_lane_stacks(m), 16, ("us", "eu")),
    "reduce_lanes_bare": lambda m: m.reduce_lanes(_lane_stacks(m)[0]),
    "reduce_lanes_windows": lambda m: m.reduce_lanes_windows(_lane_stacks(m)[1], 16, lat_max=40),
    "stall_margin_series": lambda m: [m.stall_margin_series(_lane_stacks(m)[1], 8),
                                      m.stall_margin_series(_mk_windows(m), 8)],
    "lane_stall_margins": lambda m: [m.lane_stall_margins(_lane_stacks(m)[1], 8),
                                     m.lane_stall_margins(_mk_windows(m), 8)],
    "lane_burn_rates": lambda m: [m.lane_burn_rates(_lane_stacks(m)[1].lat_hist, r, b)
                                  for r in (2, 8, 300) for b in (0, 100)]
    + [m.lane_burn_rates(_mk_windows(m).lat_hist, 4, 50)],
    "region_pairs_dict": lambda m: [
        m.region_pairs_dict(s.region_offered, s.region_dropped, c, n)
        for s in (_mk_summary(m),) for c in (None, s.region_cut) for n in ((), ("us",))
    ] + [m.region_pairs_dict(np.zeros((8, 8)), np.zeros((8, 8)))],
    "region_names": lambda m: [m.region_pair_name(("us", "eu", "ap"), 0, 2),
                               m.region_pair_name((), 1, 2), m.region_prefix_names(("us",), 3)],
    "constants": lambda m: [m.MSG_NAMES, m.LAT_EDGES, m.NUM_LAT_BUCKETS, m.NUM_WINDOWS,
                            m.WINDOW_ROUNDS, m.PHASE_NAMES, m.NUM_REGIONS, m.PHASE_LAT_CAP,
                            list(m.Telemetry._fields), list(m.TelemetryWindows._fields),
                            list(m.WindowSummary._fields), list(m.TelemetrySummary._fields)],
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_helpers_equal_jax(case):
    assert HOST_CASES[case](trec) == HOST_CASES[case](jrec)


def test_lane_picks_one_lane():
    s, w = _lane_stacks(trec)
    one = trec.lane(s, 1)
    assert int(one.stall_max) == 9 and one.takeover_round.tolist() == [7, -1]
    assert trec.summary_to_dict(trec.lane(s, 0), trec.lane(w, 0)) == jrec.summary_to_dict(
        jax.tree.map(lambda x: x[0], _lane_stacks(jrec)[0]),
        jax.tree.map(lambda x: x[0], _lane_stacks(jrec)[1]))
