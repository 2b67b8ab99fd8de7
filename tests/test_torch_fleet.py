"""The port's fleet runner (tpu_paxos_torch/fleet/) against the JAX
package's on the CPU, and against the port's own single runs: lane for
lane the verdict vectors, the final state and the decision-log sha256
equal JAX's ``FleetRunner`` dispatch, and each lane equals the single
``sim.run`` of its ``lane_cfg``; the knob and schedule tables equal the
constant path, finished lanes stay as they were, the on-device verdict
reds on each dimension, the rejections match JAX's, the envelope cache
keys alike, and the lane-batched simkern plain versions equal ``jax.vmap``
of the Pallas kernels."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_simkern_cuda import assert_same_state, ack_operands, store_operands
from tpu_paxos import config as jcfg
from tpu_paxos.core import faults as jflt
from tpu_paxos.core import simkern as jsk
from tpu_paxos.fleet import envelope as jenv
from tpu_paxos.fleet import runner as jrun
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch import interop
from tpu_paxos_torch.core import faults as tflt
from tpu_paxos_torch.core import sim as tsim
from tpu_paxos_torch.core import simkern as tsk
from tpu_paxos_torch.core import wan as twan
from tpu_paxos_torch.fleet import envelope as tenv
from tpu_paxos_torch.fleet import runner as trun
from tpu_paxos_torch.fleet import verdict as tvdt
from tpu_paxos_torch.harness import stress as tstress
from tpu_paxos_torch.replay.decision_log import decision_log as tlog

# tests/test_fleet.py's 8-lane fixture: one schedule per episode kind
# (partition / one-way / pause+burst / none) x 2 seeds
SCHEDS = [
    lambda f: f.FaultSchedule((f.partition(5, 20, (0, 1), (2, 3, 4)),)),
    lambda f: f.FaultSchedule((f.one_way(5, 25, (0,), (2, 3)),)),
    lambda f: f.FaultSchedule((f.pause(4, 20, 1), f.burst(8, 18, 2000))),
    lambda f: None,
]
LANES = [(k, seed) for k in range(len(SCHEDS)) for seed in (0, 1)]
WL = [np.arange(100, 110, dtype=np.int32), np.arange(200, 210, dtype=np.int32)]
FAULTS = dict(drop_rate=300, dup_rate=500, max_delay=2)


def _cfg(m, **faults):
    return m.SimConfig(
        n_nodes=5, n_instances=64, proposers=(0, 1), seed=0, max_rounds=4000,
        faults=m.FaultConfig(**(faults or FAULTS)),
    )


def _sha(chosen_vid, chosen_ballot, stride=211, n=64):
    return hashlib.sha256(
        tlog(np.asarray(chosen_vid), np.asarray(chosen_ballot), stride, n).encode()
    ).hexdigest()


@pytest.fixture(scope="module")
def fleets():
    """One JAX dispatch and one port dispatch of the 8 lanes (the JAX
    compile is the expensive part)."""
    seeds = [s for _, s in LANES]
    jrep = jrun.FleetRunner(_cfg(jcfg), WL).run(seeds, [SCHEDS[k](jflt) for k, _ in LANES])
    trep = trun.FleetRunner(_cfg(tcfg), WL, device="cpu").run(
        seeds, [SCHEDS[k](tflt) for k, _ in LANES]
    )
    return jrep, trep


def test_fleet_equals_jax_fleet_lane_by_lane(fleets):
    jrep, trep = fleets
    assert trep.n_lanes == jrep.n_lanes == 8
    for f in jrep.verdict._fields:
        a, b = np.asarray(getattr(jrep.verdict, f)), np.asarray(getattr(trep.verdict, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert trep.verdict.ok.all()
    # the whole lane-stacked final state, leaf by leaf
    jfinal = jax.tree.map(np.asarray, jrep.final)
    assert_same_state(interop.sim_state_to_numpy(trep.final), jfinal)
    # JAX's lane-stacked states judged by the port's device verdict
    cfg = _cfg(tcfg)
    exp, own = tvdt.expected_owners(cfg, WL)
    v = tvdt.lane_verdict(
        cfg, interop.sim_state_from_jax(jfinal, device="cpu"),
        torch.from_numpy(np.tile(exp, (8, 1))), torch.from_numpy(np.tile(own, (8, 1))),
        int(exp.max()) + 1,
    )
    for f in jrep.verdict._fields:
        np.testing.assert_array_equal(v._asdict()[f].numpy(), np.asarray(getattr(jrep.verdict, f)))
    for i in range(8):
        jr, tr = jrep.lane_result(i), trep.lane_result(i)
        for f in ("learned", "chosen_vid", "chosen_round", "chosen_ballot", "crashed", "msgs",
                  "expected_vids"):
            np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f), err_msg=f"lane {i} {f}")
        assert (tr.rounds, tr.done) == (jr.rounds, jr.done)
        assert _sha(tr.chosen_vid, tr.chosen_ballot) == _sha(jr.chosen_vid, jr.chosen_ballot)
    assert trep.lane_cfg(0).seed == 0 and trep.lane_cfg(7).faults.schedule is None
    assert trep.lane_cfg(0).faults.schedule == SCHEDS[0](tflt)


def test_each_lane_equals_its_single_run(fleets):
    """Lanes that finish at different rounds each equal the constant
    path's single run of their ``lane_cfg``: a lane touched after it
    finished would differ."""
    _, trep = fleets
    assert len(set(trep.verdict.rounds.tolist())) > 2
    assert trep.iterations == int(trep.verdict.rounds.max())
    for i in range(8):
        single = tsim.run(trep.lane_cfg(i), WL, device="cpu")
        lane = trep.lane_result(i)
        assert (lane.rounds, lane.done) == (single.rounds, single.done), f"lane {i}"
        for f in ("learned", "chosen_vid", "chosen_round", "chosen_ballot", "crashed", "msgs"):
            np.testing.assert_array_equal(getattr(lane, f), getattr(single, f), err_msg=f"lane {i} {f}")


def _wan_edges():
    return twan.edge_faults(twan.WAN3, 5)


def test_knob_tables_equal_the_constant_path():
    """One dispatch over a knob grid (zero, debug.conf, a delay span off
    zero, a WAN edge matrix at the ring edge with a gray episode, a crash
    rate under pauses), with per-lane schedules and the stress workload's
    gates: every lane equals the constant path's single run."""
    wl, gates, _ = tstress._workload(2, np.random.default_rng(3))
    cfg = tcfg.SimConfig(
        n_nodes=5, n_instances=56, proposers=(0, 1), max_rounds=2000,
        faults=tcfg.FaultConfig(max_delay=8),
    )
    knobs = [
        tcfg.FaultConfig(),
        tcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2),
        tcfg.FaultConfig(drop_rate=200, dup_rate=200, min_delay=1, max_delay=3),
        tcfg.FaultConfig(max_delay=8, edges=_wan_edges()),
        tcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2, crash_rate=30_000),
    ]
    scheds = [
        None,
        tstress.SCHED_PARTITION_FLAP,
        tflt.FaultSchedule((tflt.burst(3, 20, 4000), tflt.one_way(5, 15, (0,), (2, 3)))),
        tstress.SCHED_WAN_GRAY,
        tstress.SCHED_PAUSE_CRASH,
    ]
    rep = trun.FleetRunner(cfg, wl, gates, device="cpu").run(
        [7, 8, 9, 10, 11], scheds, knobs=knobs
    )
    assert rep.verdict.ok.all(), rep.verdict
    assert rep.lane_cfg(3).faults.edges == knobs[3].edges
    for i in range(5):
        single = tsim.run(rep.lane_cfg(i), wl, gates, device="cpu")
        lane = rep.lane_result(i)
        assert (lane.rounds, lane.done) == (single.rounds, single.done), f"lane {i}"
        for f in ("learned", "chosen_vid", "chosen_round", "chosen_ballot", "crashed", "msgs"):
            np.testing.assert_array_equal(getattr(lane, f), getattr(single, f), err_msg=f"lane {i} {f}")
    assert rep.verdict.rounds[4] > 0 and rep.lane_result(4).crashed.any()


def test_lane_parked_at_a_fixed_point_equals_its_single_run():
    """A lane whose proposers both crash before node 3 (cut off until
    then) has learned the decisions never finishes: it runs to its
    budget.  The loop parks it once a round changes nothing and sets its
    round counter to the budget; its state equals the single run that
    counts every round, and so does the lane that runs on beside it."""
    wl, gates, _ = tstress._workload(2, np.random.default_rng(0))
    cfg = tcfg.SimConfig(
        n_nodes=5, n_instances=56, proposers=(0, 1), max_rounds=300,
        faults=tcfg.FaultConfig(max_delay=8),
    )
    dead = tflt.FaultSchedule((tflt.partition(28, 63, (1, 2, 4, 0), (3,)), tflt.crash(63, 0, 1)))
    rep = trun.FleetRunner(cfg, wl, gates, device="cpu").run(
        [12, 3], [dead, None],
        knobs=[tcfg.FaultConfig(), tcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2)],
    )
    budget = cfg.max_rounds + dead.horizon
    assert rep.iterations < budget // 2  # the dead lane was parked, not run out
    assert rep.verdict.rounds.tolist()[0] == budget
    assert rep.verdict.quiescent.all() and not rep.lane_result(0).done
    for i in range(2):
        c = rep.lane_cfg(i)
        pend, gate, tail, cap = tsim.prepare_queues(c, wl, gates)
        root = tsim.prng.root_key(c.seed)
        rf = tsim.build_engine(c, cap, vid_cap=tsim.gates_vid_cap(wl, gates), device="cpu")
        st = tsim.init_state(c, pend, gate, tail, root, device="cpu")
        while not bool(st.done) and int(st.t) < c.round_budget:  # every round, none parked
            st = rf(root, st)
        single = interop.sim_state_to_numpy(st)
        lane = interop.sim_state_to_numpy(tsim.lane_of(rep.final, i))
        # the fleet's ring is the envelope's bound, the single run's its
        # own (ring size is decision-neutral): every other field is equal
        assert_same_state(lane._replace(net=single.net), single, f"lane {i}")


def test_verdict_green_and_each_red_dimension(fleets):
    """Lane 7 of the port's dispatch (no schedule), doctored along each
    verdict dimension."""
    _, trep = fleets
    cfg = _cfg(tcfg)
    final = tsim.lanes_view(tsim.lane_of(trep.final, 7))
    expected, owner = tvdt.expected_owners(cfg, WL)
    exp = torch.from_numpy(expected)[None]
    own = torch.from_numpy(owner)[None]
    vid_cap = int(expected.max()) + 1

    def judge(st):
        return tvdt.LaneVerdict(*(bool(x[0]) for x in tvdt.lane_verdict(cfg, st, exp, own, vid_cap)[:4]),
                                None, None)

    v = judge(final)
    assert v.ok and v.agreement and v.coverage and v.quiescent

    bad = final.learned.clone()
    bad[0, 0, 0], bad[0, 1, 0] = 100, 101
    v2 = judge(final._replace(learned=bad))
    assert not v2.agreement and not v2.ok

    gone = int(expected[0])
    cv = torch.where(final.met.chosen_vid == gone, -1, final.met.chosen_vid)
    v3 = judge(final._replace(met=final.met._replace(chosen_vid=cv)))
    assert not v3.coverage and not v3.ok

    crashed = final.crashed.clone()
    crashed[0, int(owner[0])] = True
    v4 = judge(final._replace(met=final.met._replace(chosen_vid=cv), crashed=crashed))
    assert v4.coverage

    v5 = judge(final._replace(done=torch.zeros_like(final.done)))
    assert not v5.quiescent and not v5.ok
    all_crashed = final.crashed.clone()
    all_crashed[0, :2] = True
    v6 = judge(final._replace(done=torch.zeros_like(final.done), crashed=all_crashed))
    assert v6.quiescent


def test_expected_owners_equals_jax():
    from tpu_paxos.fleet import verdict as jvdt

    wl = [np.asarray([5, 3, 9, 3], np.int32), np.asarray([9, 1, 7], np.int32), np.zeros(0, np.int32)]
    cfg_j = jcfg.SimConfig(n_nodes=5, n_instances=16, proposers=(1, 2, 4))
    cfg_t = tcfg.SimConfig(n_nodes=5, n_instances=16, proposers=(1, 2, 4))
    for a, b in zip(jvdt.expected_owners(cfg_j, wl), tvdt.expected_owners(cfg_t, wl)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def _same_error(jcall, tcall, exc=ValueError):
    with pytest.raises(exc) as je:
        jcall()
    with pytest.raises(exc) as te:
        tcall()
    assert str(te.value) == str(je.value)


def test_runner_rejections_match_jax():
    _same_error(lambda: jrun.FleetRunner(_cfg(jcfg, schedule=SCHEDS[0](jflt), **FAULTS), WL),
                lambda: trun.FleetRunner(_cfg(tcfg, schedule=SCHEDS[0](tflt), **FAULTS), WL,
                                         device="cpu"))
    jr = jrun.FleetRunner(_cfg(jcfg), WL)
    tr = trun.FleetRunner(_cfg(tcfg), WL, device="cpu")
    _same_error(lambda: jr.run([0, 1], [None]), lambda: tr.run([0, 1], [None]))
    other = [np.arange(300, 310, dtype=np.int32), np.arange(400, 410, dtype=np.int32)]
    _same_error(lambda: jr.run([0], [None], workloads=[(other, None)]),
                lambda: tr.run([0], [None], workloads=[(other, None)]))
    wider = [np.arange(100, 111, dtype=np.int32), WL[1]]
    _same_error(lambda: jr.run([0], [None], workloads=[(wider, None)]),
                lambda: tr.run([0], [None], workloads=[(wider, None)]))
    gates = [np.full(10, -1, np.int32), np.asarray([-1, 200] + [-1] * 8, np.int32)]
    _same_error(lambda: jr.run([0], [None], workloads=[(WL, gates)]),
                lambda: tr.run([0], [None], workloads=[(WL, gates)]))
    longer = [np.full(11, 100, np.int32), WL[1]]  # same vids, one more entry
    _same_error(lambda: jr.run([0], [None], workloads=[(longer, None)]),
                lambda: tr.run([0], [None], workloads=[(longer, None)]))
    knob_cases = [
        ([jcfg.FaultConfig()] * 2, [tcfg.FaultConfig()] * 2),  # one knob set per lane
        ([jcfg.FaultConfig(max_delay=3)], [tcfg.FaultConfig(max_delay=3)]),  # ring bound
        ([jcfg.FaultConfig(delivery_cut=True)], [tcfg.FaultConfig(delivery_cut=True)]),
        ([jcfg.FaultConfig(schedule=SCHEDS[0](jflt))], [tcfg.FaultConfig(schedule=SCHEDS[0](tflt))]),
    ]
    for jk, tk in knob_cases:
        _same_error(lambda: jr.run([0], [None], knobs=jk), lambda: tr.run([0], [None], knobs=tk))
    _same_error(lambda: jr.run([0], [None], knobs=["x"]), lambda: tr.run([0], [None], knobs=["x"]),
                TypeError)
    gray = [lambda f: f.FaultSchedule((f.gray(1, 4, 2, delay=2),))]
    _same_error(lambda: jr.run([0], [gray[0](jflt)], knobs=[jcfg.FaultConfig()]),
                lambda: tr.run([0], [gray[0](tflt)], knobs=[tcfg.FaultConfig()]))
    _same_error(lambda: jr.run([0], [None], geometry=(5, (0, 1))),
                lambda: tr.run([0], [None], geometry=(5, (0, 1))))
    _same_error(lambda: jrun._pad_geometry_workload(WL + WL, None, 3),
                lambda: trun._pad_geometry_workload(WL + WL, None, 3))
    padded, g = trun._pad_geometry_workload(WL, [WL[0], WL[1]], 3)
    assert [len(w) for w in padded] == [10, 10, 0] and len(g) == 3


@pytest.mark.parametrize("what", ["telemetry", "geometry", "mesh", "regions"])
def test_unported_runner_options_raise_by_name(what):
    """``mesh=`` is not ported and raises by name.  The recorder is:
    ``telemetry`` pins JAX's refusal of region maps on a plain runner,
    ``regions`` its refusal of a wrong number of maps.  The padded runner
    is: ``geometry`` pins JAX's refusal of one built off its envelope's
    bound."""
    cfg = _cfg(tcfg)
    if what == "geometry":
        from tpu_paxos.core import geom as jgeo
        from tpu_paxos_torch.core import geom as tgeo

        menu = ((3, (0,)), (7, (0, 1, 2)))
        _same_error(lambda: jrun.FleetRunner(_cfg(jcfg), WL, geometry=jgeo.GeometryEnvelope(menu)),
                    lambda: trun.FleetRunner(cfg, WL, device="cpu",
                                             geometry=tgeo.GeometryEnvelope(menu)))
        return
    if what == "telemetry":
        _same_error(lambda: jrun.FleetRunner(_cfg(jcfg), WL).run([0], [None], regions=[None]),
                    lambda: trun.FleetRunner(cfg, WL, device="cpu").run([0], [None], regions=[None]))
        return
    if what == "regions":
        _same_error(
            lambda: jrun.FleetRunner(_cfg(jcfg), WL, telemetry=True).run(
                [0, 1], [None] * 2, regions=[None]),
            lambda: trun.FleetRunner(cfg, WL, device="cpu", telemetry=True).run(
                [0, 1], [None] * 2, regions=[None]),
        )
        return
    with pytest.raises(NotImplementedError, match=what):
        trun.FleetRunner(cfg, WL, device="cpu", **{what: object()})


def test_envelope_cache_identity_and_keying():
    tenv.clear_cache()
    jenv.clear_cache()

    def cfg(max_rounds=4000, **f):
        return (dataclasses.replace(_cfg(jcfg, **f), max_rounds=max_rounds),
                dataclasses.replace(_cfg(tcfg, **f), max_rounds=max_rounds))

    jc, tc = cfg(max_delay=2)
    t1 = tenv.runner_for(tc, WL, device="cpu")
    j1 = jenv.runner_for(jc, WL)
    # a different knob mix of the same envelope: the same runner
    jc2, tc2 = cfg(drop_rate=2000, dup_rate=500, max_delay=4)
    assert tenv.runner_for(tc2, WL, device="cpu") is t1
    assert jenv.runner_for(jc2, WL) is j1
    assert t1.cfg.faults.schedule is None
    assert t1.cfg.faults.max_delay == tenv.MAX_DELAY_BOUND == jenv.MAX_DELAY_BOUND
    assert t1.cfg.faults == tcfg.FaultConfig(max_delay=tenv.MAX_DELAY_BOUND)
    # budget and ring-bound changes are different envelopes
    assert tenv.runner_for(cfg(max_rounds=2000, max_delay=2)[1], WL, device="cpu") is not t1
    assert tenv.runner_for(tc, WL, delay_bound=12, device="cpu") is not t1
    # the same facts as JAX's key (the geometry entry included), without
    # its mesh entry, and with the device; the recorder flag leads both
    key = tenv.envelope_key(tc, WL, None, trun.MAX_EPISODES, 8)
    jkey = jenv.envelope_key(jc, WL, None, jrun.MAX_EPISODES, 8, None)
    assert jkey[0] is False and jkey[9] is None and jkey[-1] is None
    assert key == jkey[:-1] + (None,)
    tkey = tenv.envelope_key(tc, WL, None, trun.MAX_EPISODES, 8, telemetry=True)
    jtkey = jenv.envelope_key(jc, WL, None, jrun.MAX_EPISODES, 8, None, telemetry=True)
    assert tkey == jtkey[:-1] + (None,) and tkey != key
    _same_error(lambda: jenv.runner_for(cfg(max_delay=6)[0], WL, delay_bound=4),
                lambda: tenv.runner_for(cfg(max_delay=6)[1], WL, delay_bound=4, device="cpu"))
    # cache-shared runners refuse implicit inputs
    _same_error(lambda: j1.run([0], [None], workloads=[(WL, None)]),
                lambda: t1.run([0], [None], workloads=[(WL, None)]))
    _same_error(lambda: j1.run([0], [None], knobs=[jcfg.FaultConfig()]),
                lambda: t1.run([0], [None], knobs=[tcfg.FaultConfig()]))
    for name in ("serve_fleet_for", "member_runner_for"):
        with pytest.raises(NotImplementedError, match=name):
            getattr(tenv, name)()
    tenv.clear_cache()
    jenv.clear_cache()


def test_default_lane_count():
    assert trun.default_lane_count("cuda") == jrun.default_lane_count("gpu") == 128
    assert trun.default_lane_count("cpu") == jrun.default_lane_count("cpu") == 8


LANE_I = jsk.TILE  # one whole Pallas tile


def _vmapped(fn, ops):
    return jax.vmap(lambda *x: fn(*x, interpret=True))(*[jnp.asarray(o) for o in ops])


@pytest.mark.parametrize("lanes", [1, 3])
def test_lane_batched_plain_simkern_equals_per_lane_and_jax_vmap(lanes):
    """Lane-stacked operands (each lane its own kind, one with its
    ``elig``/``amatch`` all false as a finished lane's are): the plain
    versions equal each lane run alone and ``jax.vmap`` of the JAX
    kernels in interpret mode; the all-false lane is left as it was."""
    kinds = ["window", "random", "window"]
    store = [store_operands(lanes * 10 + k, 5, 2, LANE_I, kinds[k]) for k in range(lanes)]
    ack = [ack_operands(lanes * 10 + k, 5, 2, LANE_I, kinds[k]) for k in range(lanes)]
    frozen = lanes - 1
    store[frozen][5][:] = False
    ack[frozen][6][:] = False
    s_ops = [np.stack([s[j] for s in store]) for j in range(6)]
    a_ops = [np.stack([s[j] for s in ack]) for j in range(7)]
    got_s = tsk.store_accepts_plain(*[torch.from_numpy(x) for x in s_ops])
    got_a = tsk.accum_acks_plain(*[torch.from_numpy(x) for x in a_ops])
    for lane in range(lanes):
        one = tsk.store_accepts_plain(*[torch.from_numpy(x) for x in store[lane]])
        assert all(torch.equal(g[lane], w) for g, w in zip(got_s, one))
        one = tsk.accum_acks_plain(*[torch.from_numpy(x) for x in ack[lane]])
        assert all(torch.equal(g[lane], w) for g, w in zip(got_a, one))
    assert torch.equal(got_s[0][frozen], torch.from_numpy(store[frozen][0]))
    assert torch.equal(got_a[0][frozen], torch.from_numpy(ack[frozen][0]))
    want_s = _vmapped(jsk.store_accepts, s_ops)
    want_a = _vmapped(jsk.accum_acks, a_ops)
    for g, w in zip(list(got_s) + list(got_a), list(want_s) + list(want_a)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the in-place dispatch on CPU tensors writes the same back
    ops = [torch.from_numpy(x.copy()) for x in s_ops]
    tsk.store_accepts(*ops)
    assert torch.equal(ops[0], got_s[0]) and torch.equal(ops[1], got_s[1])


def test_lane_batched_bytes_count_every_lane():
    """``bytes_per_launch`` and ``bytes_needed`` of lane-stacked operands
    are the sums over the lanes (rows of a multiple of 8 instances keep
    every lane's sectors apart)."""
    i = 4096
    store = [store_operands(k, 5, 2, i, "window") for k in range(3)]
    ack = [ack_operands(k, 5, 2, i, "window") for k in range(3)]
    for name, per in (("store_accepts", store), ("accum_acks", ack)):
        stacked = [torch.from_numpy(np.stack([s[j] for s in per])) for j in range(len(per[0]))]
        one = sum(tsk.bytes_needed(name, *[torch.from_numpy(x) for x in s]) for s in per)
        assert tsk.bytes_needed(name, *stacked) == one
        assert tsk.bytes_per_launch(name, 5, 2, i, lanes=3) == 3 * tsk.bytes_per_launch(name, 5, 2, i)
