"""The port's churn tables and churn drivers (``membership/churn_table.py``,
``membership/engine.ChurnEngine``) against the JAX package's, on the CPU:
the encoders' arrays and the JSON round trip equal JAX's, ``run`` (decided
from the tensors) == ``run_host`` (decided from numpy reads) == JAX's
``run`` state for state and decision log for decision log, in the compiled
and the runtime-table builds, the compiled and runtime rounds are equal
round by round (and equal to JAX's), the geometry-padded round equals the
bound-free one, and a scheduled crash fail-stops like the host crash."""

import hashlib

import jax
import numpy as np
import pytest
import torch

from test_torch_membership import _same_error, assert_same_state
from tpu_paxos.core import faults as jflt
from tpu_paxos.membership import churn_table as jct
from tpu_paxos.membership import engine as jm
from tpu_paxos.utils import prng as jprng
from tpu_paxos_torch.core import faults as tflt
from tpu_paxos_torch.core import geom as tgeo
from tpu_paxos_torch.core.sim import lane_of
from tpu_paxos_torch.fleet import schedule_table as tstm
from tpu_paxos_torch.harness import validate as tval
from tpu_paxos_torch.membership import churn_table as tct
from tpu_paxos_torch.membership import engine as tm
from tpu_paxos_torch.utils import prng as tprng


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def _both(fn):
    """``fn(ct, flt)`` built with each package's churn-table and faults
    modules: ``(jax, port)``."""
    return fn(jct, jflt), fn(tct, tflt)


# ---------------- data model ----------------

@pytest.mark.parametrize("kw", [
    dict(vid=-1), dict(vid=1, wait=7), dict(vid=1, t0=-2), dict(vid=1, via=-1),
])
def test_churn_event_validation_equals_jax(kw):
    _same_error(lambda: jct.ChurnEvent(**kw), lambda: tct.ChurnEvent(**kw))


def test_churn_schedule_validation_equals_jax():
    for mk in (
        lambda ct: ct.ChurnSchedule((ct.ChurnEvent(vid=1, wait=ct.WAIT_CHOSEN),)),
        lambda ct: ct.ChurnSchedule((ct.ChurnEvent(vid=1),
                                     ct.ChurnEvent(vid=1, wait=ct.WAIT_CHOSEN))),
        lambda ct: ct.grow_shrink_schedule(3, 4),
    ):
        _same_error(lambda: mk(jct), lambda: mk(tct))


@pytest.mark.parametrize("args", [(4, 2, 2), (7, 5, 1), (3, 1, 0), (5, 5, 3)])
def test_grow_shrink_and_json_equal_jax(args):
    j, t = jct.grow_shrink_schedule(*args), tct.grow_shrink_schedule(*args)
    assert t.to_dict() == j.to_dict()
    assert tct.ChurnSchedule.from_dict(j.to_dict()) == t
    assert jct.ChurnSchedule.from_dict(t.to_dict()) == j
    assert tct.ChurnSchedule.from_dict({"events": []}) == tct.ChurnSchedule()
    if args == (7, 5, 1):
        assert len(t.events) == 14 and t.events[-1].wait == tct.WAIT_APPLIED


def _assert_tables(a, b):
    assert type(a)._fields == type(b)._fields
    for f, x, y in zip(type(a)._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert (x.shape, x.dtype) == (y.shape, y.dtype), f
        np.testing.assert_array_equal(y, x, err_msg=f)


def test_encode_churn_and_batch_equal_jax():
    def scheds(ct, _f):
        return [
            ct.ChurnSchedule((ct.ChurnEvent(vid=5, via=1, t0=3),
                              ct.ChurnEvent(vid=6, wait=ct.WAIT_APPLIED))),
            ct.grow_shrink_schedule(3, 2),
            None,
        ]

    js, ts = _both(scheds)
    for m in (None, 4, 24):
        _assert_tables(jct.encode_churn(js[0], 3, m), tct.encode_churn(ts[0], 3, m))
    _assert_tables(jct.encode_churn(None, 3), tct.encode_churn(None, 3))
    _assert_tables(jct.encode_churn_batch(js, 3), tct.encode_churn_batch(ts, 3))
    _assert_tables(jct.encode_churn_batch(js, 3, 16), tct.encode_churn_batch(ts, 3, 16))
    _same_error(lambda: jct.encode_churn(js[0], 3, 1), lambda: tct.encode_churn(ts[0], 3, 1))
    _same_error(lambda: jct.encode_churn_batch([], 3), lambda: tct.encode_churn_batch([], 3))
    bad = _both(lambda ct, _f: ct.ChurnSchedule((ct.ChurnEvent(vid=1, via=9),)))
    _same_error(lambda: jct.encode_churn(bad[0], 3), lambda: tct.encode_churn(bad[1], 3))
    chg = _both(lambda ct, _f: ct.ChurnSchedule((ct.ChurnEvent(vid=tm.change_vid(5, 6)),)))
    _same_error(lambda: jct.encode_churn(chg[0], 3), lambda: tct.encode_churn(chg[1], 3))


# ---------------- the two drivers against JAX ----------------

def _mix(ct, f):
    return (ct.grow_shrink_schedule(4, 2, values_per_step=1),
            f.FaultSchedule((f.pause(5, 11, 2), f.crash(18, 3))))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's compiled-constant run of the churn + crash + pause mix at two
    seeds (the JAX compile is the expensive part)."""
    churn, sched = _mix(jct, jflt)
    eng = jm.ChurnEngine(4, 24, churn=churn, schedule=sched, crash_rate=500, max_rounds=400)
    return {seed: eng.run(seed=seed) for seed in (2, 9)}


@pytest.mark.parametrize("seed", [2, 9])
@pytest.mark.parametrize("runtime", [False, True])
def test_run_and_run_host_equal_jax(jax_runs, seed, runtime):
    want = jax_runs[seed]
    churn, sched = _mix(tct, tflt)
    if runtime:
        eng = tm.ChurnEngine(4, 24, runtime_tables=True, max_events=16, max_episodes=4,
                             crash_rate=500, max_rounds=400, device="cpu")
        kw = dict(churn=churn, schedule=sched)
    else:
        eng = tm.ChurnEngine(4, 24, churn=churn, schedule=sched, crash_rate=500,
                             max_rounds=400, device="cpu")
        kw = {}
    for got in (eng.run(seed=seed, **kw), eng.run_host(seed=seed, **kw)):
        assert (got.rounds, got.done, got.injected) == (want.rounds, want.done, want.injected)
        assert_same_state(want.state, got.state)
        assert _sha(got.decision_log()) == _sha(want.decision_log())


def test_config5_shape_small_equals_jax():
    """The config-5 churn shape (grow 1 -> 7, shrink to 5) at 96 instances:
    both drivers equal JAX's, and the logs are prefix-consistent."""
    churn_j = jct.grow_shrink_schedule(7, 5, values_per_step=1)
    want = jm.ChurnEngine(7, 96, churn=churn_j, max_rounds=4000).run(seed=5)
    eng = tm.ChurnEngine(7, 96, churn=tct.grow_shrink_schedule(7, 5, values_per_step=1),
                         max_rounds=4000, device="cpu")
    for got in (eng.run(seed=5), eng.run_host(seed=5)):
        assert (got.rounds, got.done, got.injected) == (want.rounds, want.done, want.injected)
        assert_same_state(want.state, got.state)
    logs = [tm.applied_log_of(got.state, a) for a in range(7)]
    tval.check_prefix_consistency(logs)
    assert sorted(logs[0].tolist()) == list(range(100, 106))


def test_device_churn_scenario_converges_prefix_consistent():
    churn = tct.grow_shrink_schedule(5, 3, values_per_step=1)
    res = tm.ChurnEngine(5, 32, churn=churn, max_rounds=600, device="cpu").run(seed=0)
    assert res.done and res.injected == len(churn.events)
    logs = [tm.applied_log_of(res.state, a) for a in range(5)]
    tval.check_prefix_consistency(logs)
    plain = sorted(e.vid for e in churn.events if e.vid < tm.CHANGE_BASE)
    assert sorted(logs[0].tolist()) == plain
    assert (np.unique(logs[0], return_counts=True)[1] == 1).all()


def test_churn_engine_validation_equals_jax():
    one = _both(lambda ct, _f: ct.ChurnSchedule((ct.ChurnEvent(vid=1),)))
    node0 = _both(lambda _c, f: f.FaultSchedule((f.crash(2, 0),)))
    gray = _both(lambda _c, f: f.FaultSchedule((f.gray(2, 5, 1),)))
    _same_error(lambda: jm.ChurnEngine(3, 16, churn=one[0], runtime_tables=True),
                lambda: tm.ChurnEngine(3, 16, churn=one[1], runtime_tables=True, device="cpu"))
    je, te = jm.ChurnEngine(3, 16, churn=one[0]), tm.ChurnEngine(3, 16, churn=one[1], device="cpu")
    _same_error(lambda: je.run(seed=0, churn=one[0]), lambda: te.run(seed=0, churn=one[1]))
    jr = jm.ChurnEngine(3, 16, runtime_tables=True, max_events=2)
    tr = tm.ChurnEngine(3, 16, runtime_tables=True, max_events=2, device="cpu")
    for k in (0, 1):
        sched = (node0, gray)[k]
        _same_error(lambda: jr.run(seed=0, churn=one[0], schedule=sched[0]),
                    lambda: tr.run(seed=0, churn=one[1], schedule=sched[1]))
        _same_error(lambda: jm.MemberSim(3, 8, schedule=sched[0]),
                    lambda: tm.MemberSim(3, 8, schedule=sched[1], device="cpu"))
    i = 4
    many = _both(lambda ct, _f: ct.ChurnSchedule(tuple(
        ct.ChurnEvent(vid=100 + k) for k in range(2 * i + 8 - i + 1))))
    _same_error(lambda: jm.ChurnEngine(3, i, churn=many[0], max_rounds=50),
                lambda: tm.ChurnEngine(3, i, churn=many[1], max_rounds=50, device="cpu"))


# ---------------- compiled vs runtime rounds, round by round ----------------

def _active(st, pend_set):
    """The initial state with queued work at node 0."""
    vids = [100, tm.change_vid(1, tm.ADD_ACCEPTOR), 101]
    return pend_set(st, vids)


def test_const_vs_runtime_round_parity_per_round():
    """The compiled-constant and runtime-table rounds of the port are equal
    round by round, on a partition + pause + crash-point schedule, and
    equal JAX's compiled round at every round."""
    n, i = 4, 16
    c = i * 2 + 8
    jsched, tsched = _both(lambda _c, f: f.FaultSchedule((
        f.partition(2, 6, (0, 1), (2, 3)), f.pause(4, 9, 2), f.crash(7, 3))))
    jrf = jax.jit(jm._build_round(n, i, c, crash_rate=500,
                                  comp=jflt.compile_schedule(jsched, n)))
    rf_c = tm._build_round(n, i, c, crash_rate=500, comp=tflt.compile_schedule(tsched, n),
                           device="cpu")
    rf_r = tm._build_round(n, i, c, crash_rate=500, runtime_schedule=True, device="cpu")
    tab = tstm.encode_schedule(tsched, n, 5)
    jroot, troot = jprng.root_key(3), tprng.root_key(3)

    def jset(st, vids):
        pend = st.pend
        for k, v in enumerate(vids):
            pend = pend.at[0, k].set(v)
        return st._replace(pend=pend, tail=st.tail.at[0].set(len(vids)))

    def tset(st, vids):
        pend, tail = st.pend.clone(), st.tail.clone()
        pend[0, :len(vids)] = torch.tensor(vids, dtype=pend.dtype)
        tail[0] = len(vids)
        return st._replace(pend=pend, tail=tail)

    js = _active(jm._init(n, i, c), jset)
    sc = sr = _active(tm._init(n, i, c, "cpu"), tset)
    for t in range(jsched.horizon + 4):
        js = jrf(jroot, js)
        sc = rf_c(troot, sc, t=t)
        sr = rf_r(troot, sr, tab)
        assert_same_state(js, sc)
        assert_same_state(js, sr)
    assert bool(sc.crashed[3])


def test_padded_round_equals_bound_free():
    """The geometry-padded member round (menu 3/5, bound 5) at 3 true nodes
    makes the 3-node round's decisions round by round: the true block of
    every state field equals the bound-free state, and the pad nodes stay
    out of every view."""
    genv = tgeo.GeometryEnvelope(((3, (0,)), (5, (0,))))
    i = 16
    c = 2 * i + 8
    sched = tflt.FaultSchedule((tflt.pause(3, 7, 2),))
    rf = tm._build_round(3, i, c, crash_rate=20000, runtime_schedule=True, device="cpu")
    rp = tm._build_round(5, i, c, crash_rate=20000, runtime_schedule=True, geometry=genv,
                         device="cpu")
    eng = tm.ChurnEngine(3, i, runtime_tables=True, max_events=16, max_episodes=2,
                         crash_rate=20000, max_rounds=200, device="cpu")
    churn = tct.grow_shrink_schedule(3, 2, values_per_step=1)
    want = eng.run(seed=4, churn=churn, schedule=sched)
    roots = tprng.root_keys([4])
    ctab3 = tct.encode_churn_batch([churn], 3, 16)
    ctab5 = tct.encode_churn_batch([churn], 5, 16)
    f3, c3, d3 = tm._run_churn_lanes(rf, roots, tm._init_lanes(3, i, c, 1, "cpu"), ctab3,
                                     tstm.encode_batch([sched], 3, 2), [200 + sched.horizon])
    f5, c5, d5 = tm._run_churn_lanes(rp, roots, tm._init_lanes(5, i, c, 1, "cpu"), ctab5,
                                     tstm.encode_batch([sched], 5, 2), [200 + sched.horizon],
                                     gidx=genv.index_of_nodes(3))
    assert bool(d3[0]) and bool(d5[0]) and int(c3[0]) == int(c5[0]) == want.injected
    a, b = lane_of(f3, 0), lane_of(f5, 0)
    assert_same_state(want.state, a)
    for f in tm.MemberState._fields:
        x, y = getattr(a, f), getattr(b, f)
        # the true block: node axes cut to the 3 true nodes
        idx = tuple(slice(0, 3) if d == 5 and x.shape[k] == 3 else slice(None)
                    for k, d in enumerate(y.shape))
        assert (y[idx] == x).all(), f
    assert not b.acceptors[:, 3:].any() and not b.learners[:, 3:].any()
    assert tm.decision_log_of(b, 3) == want.decision_log()


# ---------------- deterministic crash episodes ----------------

def test_member_crash_episode_fail_stops_like_host_crash():
    def drive(ms):
        a = ms.add_acceptor(1)
        seen = [ms.run_until(lambda: ms.applied(a), max_rounds=200)]
        b = ms.add_acceptor(2)
        seen.append(ms.run_until(lambda: ms.applied(b), max_rounds=200))
        ms.run_rounds(max(0, 8 - int(ms.state.t)))
        seen += [ms.crashed_set(), 2 in ms._crash_round, ms.acceptor_set(0)]
        ms.propose(0, 55)
        seen.append(ms.run_until(lambda: ms.chosen(55), max_rounds=400))
        return seen

    js, ts = _both(lambda _c, f: f.FaultSchedule((f.crash(6, 2),)))
    j = jm.MemberSim(3, n_instances=24, seed=0, schedule=js)
    t = tm.MemberSim(3, n_instances=24, seed=0, schedule=ts, device="cpu")
    seen = drive(t)
    assert seen == drive(j)
    assert seen[2] == {2} and seen[3] and seen[4] == {0, 1, 2} and seen[5]
    assert_same_state(j.state, t.state)
    assert t._crash_round == j._crash_round
