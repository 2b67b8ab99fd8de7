"""The port's membership fleet (``fleet/member_runner.py``,
``fleet/envelope.member_runner_for``) against the JAX package's, on the
CPU: an 8-lane dispatch equals JAX's ``MemberFleetRunner`` dispatch state
for state, verdict for verdict and decision log for decision log; a lane
equals its single ``ChurnEngine.run``; the on-device verdict reds on each
crafted violation as JAX's does; the geometry-padded dispatch equals the
bound-free one (and JAX's padded dispatch); the envelope cache keys as
JAX's does; the lane tile (``mesh=``) refuses a lane count that does not
tile it (tests/test_torch_lane_tile.py holds the tile itself)."""

import numpy as np
import pytest
import torch

from test_torch_membership import _same_error, assert_same_state
from tpu_paxos.core import faults as jflt
from tpu_paxos.core import geom as jgeo
from tpu_paxos.fleet import envelope as jenv
from tpu_paxos.fleet import member_runner as jmr
from tpu_paxos.membership import churn_table as jct
from tpu_paxos.membership import engine as jm
from tpu_paxos_torch.core import faults as tflt
from tpu_paxos_torch.core import geom as tgeo
from tpu_paxos_torch.core.sim import lanes_view
from tpu_paxos_torch.fleet import envelope as tenv
from tpu_paxos_torch.fleet import member_runner as tmr
from tpu_paxos_torch.membership import churn_table as tct
from tpu_paxos_torch.membership import engine as tm

N, I = 4, 24
ENV = dict(max_events=16, max_episodes=4, max_rounds=500, crash_rate=3000)


def _churns(ct):
    return [ct.grow_shrink_schedule(4, 2, values_per_step=1),
            ct.grow_shrink_schedule(3, 1, values_per_step=2)]


def _scheds(f):
    return [
        None,
        f.FaultSchedule((f.pause(4, 9, 2),)),
        f.FaultSchedule((f.crash(16, 3), f.pause(2, 6, 1))),
        f.FaultSchedule((f.partition(3, 8, (0, 1), (2, 3)),)),
    ]


def _lanes(ct, f):
    """tests/test_member_fleet.py's mixed grid, cycled over 8 lanes."""
    return (list(range(8)), [_churns(ct)[i % 2] for i in range(8)],
            [_scheds(f)[i % 4] for i in range(8)])


@pytest.fixture(scope="module")
def fleets():
    """One JAX dispatch and one port dispatch of the 8 lanes."""
    jrep = jmr.MemberFleetRunner(N, I, **ENV).run(*_lanes(jct, jflt))
    trep = tmr.MemberFleetRunner(N, I, **ENV, device="cpu").run(*_lanes(tct, tflt))
    return jrep, trep


def test_fleet_equals_jax_fleet_lane_by_lane(fleets):
    jrep, trep = fleets
    assert trep.n_lanes == jrep.n_lanes == 8
    for f in jrep.verdict._fields:
        want = np.asarray(getattr(jrep.verdict, f))
        got = getattr(trep.verdict, f)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert trep.verdict.ok.all()
    np.testing.assert_array_equal(trep.injected, np.asarray(jrep.injected))
    assert_same_state(jrep.final, trep.final)
    for i in range(8):
        assert trep.lane_log(i) == jrep.lane_log(i), i
    assert trep.failing == jrep.failing == []
    assert trep.iterations == int(trep.verdict.rounds.max())


@pytest.mark.parametrize("lane", [0, 5])
def test_lane_equals_its_single_run(fleets, lane):
    _, trep = fleets
    eng = tm.ChurnEngine(N, I, runtime_tables=True, max_events=16, max_episodes=4,
                         crash_rate=3000, max_rounds=500, device="cpu")
    single = eng.run(seed=trep.seeds[lane], churn=trep.churns[lane],
                     schedule=trep.schedules[lane])
    assert trep.lane_log(lane) == single.decision_log()
    assert int(trep.verdict.rounds[lane]) == single.rounds
    assert int(trep.injected[lane]) == single.injected
    assert_same_state(trep.lane_state(lane), single.state)


# ---------------- crafted verdict cases ----------------

def _clean(m, ct, dev):
    kw = {} if dev is None else {"device": dev}
    res = m.ChurnEngine(N, I, churn=ct.grow_shrink_schedule(4, 2, values_per_step=1),
                        max_rounds=500, **kw).run(seed=1)
    assert res.done
    return res.state, ct.encode_churn(ct.grow_shrink_schedule(4, 2, values_per_step=1), N, 16)


def _verdicts(edit):
    """JAX's verdict and the port's on the same crafted final state."""
    import jax
    import jax.numpy as jnp

    js, jtab = _clean(jm, jct, None)
    ts, ttab = _clean(tm, tct, "cpu")
    js, ts = edit(js, ts)
    jv = jmr.member_lane_verdict(js, jax.tree.map(jnp.asarray, jtab), jnp.bool_(True))
    tv = tmr.member_lane_verdict(lanes_view(ts), tct.ChurnTable(
        *[torch.from_numpy(np.asarray(x))[None] for x in ttab]), torch.tensor([True]))
    got = {f: bool(getattr(tv, f)[0]) if f != "rounds" else int(tv.rounds[0])
           for f in tv._fields}
    want = {f: bool(getattr(jv, f)) if f != "rounds" else int(jv.rounds) for f in jv._fields}
    assert got == want
    return got


def _first_chosen(st):
    return int(np.flatnonzero(np.asarray(st.chosen_vid) != -1)[0])


def _set(st, field, idx, value):
    x = getattr(st, field)
    if isinstance(x, torch.Tensor):
        x = x.clone()
        x[idx] = value
    else:
        x = x.at[idx].set(value)
    return st._replace(**{field: x})


def test_verdict_clean_state_passes():
    v = _verdicts(lambda j, t: (j, t))
    assert all(v[f] for f in ("ok", "quorum", "catchup", "coverage", "completed"))


def test_verdict_flags_seeded_quorum_violation():
    v = _verdicts(lambda j, t: (_set(j, "learned", (_first_chosen(j), 1), 999_999),
                                _set(t, "learned", (_first_chosen(t), 1), 999_999)))
    assert not v["quorum"] and not v["ok"] and v["coverage"]


def test_verdict_flags_seeded_catchup_violation():
    v = _verdicts(lambda j, t: (_set(j, "learned", (_first_chosen(j), 1), -1),
                                _set(t, "learned", (_first_chosen(t), 1), -1)))
    assert not v["catchup"] and not v["ok"] and v["quorum"]


def test_verdict_crash_excuses_coverage():
    """Events via a node the lane's schedule crashed are excused from
    coverage; the lane still fails on completed=False."""
    def churn(ct):
        return ct.ChurnSchedule((ct.ChurnEvent(vid=300, via=1),
                                 ct.ChurnEvent(vid=301, via=1, wait=ct.WAIT_CHOSEN, t0=30)))

    kw = dict(max_events=4, max_episodes=2, max_rounds=60)
    jrep = jmr.MemberFleetRunner(N, I, **kw).run(
        [0], [churn(jct)], [jflt.FaultSchedule((jflt.crash(5, 1),))])
    trep = tmr.MemberFleetRunner(N, I, **kw, device="cpu").run(
        [0], [churn(tct)], [tflt.FaultSchedule((tflt.crash(5, 1),))])
    for f in jrep.verdict._fields:
        np.testing.assert_array_equal(getattr(trep.verdict, f),
                                      np.asarray(getattr(jrep.verdict, f)), err_msg=f)
    assert not trep.verdict.completed[0] and trep.verdict.coverage[0]
    assert trep.failing == [0]
    assert bool(trep.lane_state(0).crashed[1])
    assert_same_state(jrep.lane_state(0), trep.lane_state(0))


# ---------------- geometry padding ----------------

def test_padded_dispatch_equals_bound_free_and_jax():
    """Menu 3/5: one padded runner serves both true node counts; each
    dispatch equals its bound-free twin lane for lane (and JAX's padded
    dispatch at 3 nodes, state for state)."""
    kw = dict(max_events=16, max_episodes=2, max_rounds=300, crash_rate=20000)
    tmenu = tgeo.GeometryEnvelope(((3, (0,)), (5, (0,))))
    padded = tmr.MemberFleetRunner(5, 16, geometry=tmenu, **kw, device="cpu")
    for n in (3, 5):
        churn = tct.grow_shrink_schedule(n, 2, values_per_step=1)
        sched = tflt.FaultSchedule((tflt.pause(3, 8, n - 1),))
        args = ([1, 2, 3], [churn, None, churn], [sched, sched, None])
        prep = padded.run(*args, n_nodes=n)
        free = tmr.MemberFleetRunner(n, 16, **kw, device="cpu").run(*args)
        assert prep.n_nodes == n
        for f in free.verdict._fields:
            np.testing.assert_array_equal(getattr(prep.verdict, f), getattr(free.verdict, f))
        for i in range(3):
            assert prep.lane_log(i) == free.lane_log(i), (n, i)
    jmenu = jgeo.GeometryEnvelope(((3, (0,)), (5, (0,))))
    jchurn = jct.grow_shrink_schedule(3, 2, values_per_step=1)
    jsched = jflt.FaultSchedule((jflt.pause(3, 8, 2),))
    jrep = jmr.MemberFleetRunner(5, 16, geometry=jmenu, **kw).run(
        [1, 2, 3], [jchurn, None, jchurn], [jsched, jsched, None], n_nodes=3)
    churn = tct.grow_shrink_schedule(3, 2, values_per_step=1)
    sched = tflt.FaultSchedule((tflt.pause(3, 8, 2),))
    trep = padded.run([1, 2, 3], [churn, None, churn], [sched, sched, None], n_nodes=3)
    assert_same_state(jrep.final, trep.final)
    for i in range(3):
        assert trep.lane_log(i) == jrep.lane_log(i)
    _same_error(lambda: jmr.MemberFleetRunner(3, 16, geometry=jmenu),
                lambda: tmr.MemberFleetRunner(3, 16, geometry=tmenu, device="cpu"))
    _same_error(lambda: jmr.MemberFleetRunner(5, 16, geometry=jmenu, **kw).run([0], [None], [None]),
                lambda: padded.run([0], [None], [None]))
    _same_error(lambda: jmr.MemberFleetRunner(5, 16, geometry=jmenu, **kw).run(
                    [0], [None], [None], n_nodes=4),
                lambda: padded.run([0], [None], [None], n_nodes=4))


# ---------------- envelope cache, validation, unported ----------------

def test_member_envelope_cache_and_key_equal_jax():
    tenv.clear_cache()
    before = tenv.cache_misses()
    a = tenv.member_runner_for(N, I, max_events=16, max_episodes=4, max_rounds=500,
                               device="cpu")
    assert tenv.member_runner_for(N, I, max_events=16, max_episodes=4, max_rounds=500,
                                  device="cpu") is a
    b = tenv.member_runner_for(N, I, max_events=8, max_episodes=4, max_rounds=500,
                               device="cpu")
    assert b is not a and tenv.cache_misses() - before == 2
    jkey = jenv.member_envelope_key(N, I, 16, 4, 0, 500)
    # JAX's key, then the lane tile's mesh entry and the device
    assert tenv.member_envelope_key(N, I, 16, 4, 0, 500) == jkey + (None, None)
    jg = jgeo.GeometryEnvelope(((3, (0,)), (5, (0,))))
    tg = tgeo.GeometryEnvelope(((3, (0,)), (5, (0,))))
    assert tenv.member_envelope_key(5, I, 16, 4, 0, 500, geometry=tg) == (
        jenv.member_envelope_key(5, I, 16, 4, 0, 500, geometry=jg) + (None, None))
    g3 = tenv.member_runner_for(3, I, geometry=tg, device="cpu")
    assert tenv.member_runner_for(5, I, geometry=tg, device="cpu") is g3 and g3.n == 5
    _same_error(lambda: jenv.member_runner_for(4, I, geometry=jg),
                lambda: tenv.member_runner_for(4, I, geometry=tg, device="cpu"))
    tenv.clear_cache()


def test_lane_shape_validation_equals_jax():
    jr = jmr.MemberFleetRunner(N, I, max_events=16, max_episodes=4, max_rounds=500)
    tr = tmr.MemberFleetRunner(N, I, max_events=16, max_episodes=4, max_rounds=500,
                               device="cpu")
    jc, tc = _churns(jct)[0], _churns(tct)[0]
    _same_error(lambda: jr.run([0, 1], [jc], [None, None]),
                lambda: tr.run([0, 1], [tc], [None, None]))
    _same_error(lambda: jr.run([0], [jc], [jflt.FaultSchedule((jflt.crash(2, 0),))]),
                lambda: tr.run([0], [tc], [tflt.FaultSchedule((tflt.crash(2, 0),))]))
    _same_error(lambda: jr.run([0], [jc], [None], n_nodes=4),
                lambda: tr.run([0], [tc], [None], n_nodes=4))
    k = tr.c - I + 1
    big_j = jct.ChurnSchedule(tuple(jct.ChurnEvent(vid=100 + x) for x in range(k)))
    big_t = tct.ChurnSchedule(tuple(tct.ChurnEvent(vid=100 + x) for x in range(k)))
    _same_error(lambda: jmr.MemberFleetRunner(N, I, max_events=k).run([0], [big_j], [None]),
                lambda: tmr.MemberFleetRunner(N, I, max_events=k, device="cpu").run(
                    [0], [big_t], [None]))


def test_unported_member_fleet_surfaces_raise_by_name():
    # the lane tile is ported: it refuses a lane count that does not tile
    # its mesh, by JAX's name
    from tpu_paxos_torch.parallel import mesh as pmesh

    tiled = tmr.MemberFleetRunner(N, I, mesh=pmesh.make_instance_mesh(2, device="cpu"),
                                  device="cpu")
    with pytest.raises(ValueError, match="^1 lanes do not tile over 2 devices$"):
        tiled.run([0], [_churns(tct)[0]], [None])
    # audit_entries is ported (analysis/registry.py): JAX's entry names
    assert [e.name for e in tmr.audit_entries()] == [e.name for e in jmr.audit_entries()]
    assert [e.name for e in tm.audit_entries()] == [e.name for e in jm.audit_entries()]
