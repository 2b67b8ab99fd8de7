"""Geometry-padded envelopes in the port (``tpu_paxos_torch/core/geom.py``,
``net.pad_matrix_knobs``, ``sim.build_engine(geometry=,
runtime_protocol=)``, the padded ``FleetRunner`` and ``runner_for``)
against the JAX package, live on the CPU: every ``geom`` function, the
menu-switched draws word for word, and each named rejection with JAX's
type and message.  A padded dispatch equals the port's own bound-free
dispatch of the true geometry (decision-log sha256, rounds, verdicts,
learned rows, crashes, message counts, and the recorder less its pad
columns), one small padded dispatch equals JAX's padded ``FleetRunner``
state for state (its compile is the costly part: one case), and the wide
grid of ``bench.py``'s envelope configuration equals the committed JAX
goldens lane for lane.  All state is integer: equality is exact."""

import dataclasses
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_simkern_cuda import assert_same_state
from tpu_paxos import config as jcfg
from tpu_paxos.core import faults as jflt
from tpu_paxos.core import geom as jgeo
from tpu_paxos.core import net as jnet
from tpu_paxos.core import sim as jsim
from tpu_paxos.fleet import envelope as jenv
from tpu_paxos.fleet import runner as jrun
from tpu_paxos.utils import prng as jprng
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch import interop
from tpu_paxos_torch.core import faults as tflt
from tpu_paxos_torch.core import geom as tgeo
from tpu_paxos_torch.core import net as tnet
from tpu_paxos_torch.core import sim as tsim
from tpu_paxos_torch.fleet import envelope as tenv
from tpu_paxos_torch.fleet import runner as trun
from tpu_paxos_torch.replay.decision_log import decision_log
from tpu_paxos_torch.utils import prng as tprng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MENU35 = ((3, (0,)), (5, (0, 1)))
MENU357 = ((3, (0,)), (5, (0, 1)), (7, (0, 1, 2)))
ENV35, ENV357 = tgeo.GeometryEnvelope(MENU35), tgeo.GeometryEnvelope(MENU357)
JENV35 = jgeo.GeometryEnvelope(MENU35)

# tests/test_envelope_pad.py's template, lanes and episode mixes
TMPL = [np.arange(100, 108, dtype=np.int32), np.arange(200, 208, dtype=np.int32)]
WL3 = [np.arange(100, 108, dtype=np.int32)]


def _sched3(f):
    return f.FaultSchedule((f.pause(1, 4, 1), f.burst(5, 10, 1500)))


def _sched5(f):
    return f.FaultSchedule((
        f.partition(4, 16, (0, 1), (2, 3, 4)), f.pause(6, 14, 2), f.burst(5, 12, 1500),
    ))


def _gray5(f):
    return f.FaultSchedule((
        f.partition(2, 8, (0, 1), (2, 3, 4)), f.gray(3, 9, 2, delay=2), f.crash(20, 4),
    ))


def _cfg(m, n_nodes, proposers, seed=3, max_rounds=4000, **faults):
    return m.SimConfig(
        n_nodes=n_nodes, n_instances=16, proposers=proposers, seed=seed,
        max_rounds=max_rounds, faults=m.FaultConfig(**faults),
    )


def _same_error(jcall, tcall, exc=ValueError):
    with pytest.raises(exc) as je:
        jcall()
    with pytest.raises(exc) as te:
        tcall()
    assert type(te.value) is type(je.value)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------- geom.py


@pytest.mark.parametrize("menu", [MENU35, MENU357, ((7, (2, 0, 2)), (4, ())), ((1, (0,)),)])
def test_envelope_properties_equal_jax(menu):
    j, t = jgeo.GeometryEnvelope(menu), tgeo.GeometryEnvelope(menu)
    assert t.menu == j.menu and hash(t.menu) == hash(j.menu)
    assert (t.bound_nodes, t.bound_proposers) == (j.bound_nodes, j.bound_proposers)
    bt, bj = t.bound_cfg(_cfg(tcfg, 1, (0,))), j.bound_cfg(_cfg(jcfg, 1, (0,)))
    assert (bt.n_nodes, bt.proposers) == (bj.n_nodes, bj.proposers)
    for n, props in j.menu:
        assert t.index_of(n, props) == j.index_of(n, props)
        assert t.index_of(n, tuple(reversed(props))) == j.index_of(n, props)
        assert t.index_of_nodes(n) == j.index_of_nodes(n)
    for axis in ("nodes", "proposers"):
        assert tgeo.menu_lengths(t, axis) == jgeo.menu_lengths(j, axis)


@pytest.mark.parametrize("call", [
    lambda g: g.GeometryEnvelope(()),
    lambda g: g.GeometryEnvelope(((0, (0,)),)),
    lambda g: g.GeometryEnvelope(((3, (5,)),)),
    lambda g: g.GeometryEnvelope(((3, (0,)), (3, (0, 0)))),
    lambda g: g.GeometryEnvelope(MENU35).index_of(9, (0,)),
    lambda g: g.GeometryEnvelope(MENU35).index_of(5, (0, 1, 2)),
    lambda g: g.GeometryEnvelope(MENU35).index_of(4, (0,)),
    lambda g: g.GeometryEnvelope(MENU35).index_of_nodes(9),
    lambda g: g.GeometryEnvelope(MENU35).index_of_nodes(4),
    lambda g: g.geometry_for(g.GeometryEnvelope(MENU35), 5, (0, 2)),
    lambda g: g.menu_lengths(g.GeometryEnvelope(MENU35), "lanes"),
])
def test_envelope_rejections_equal_jax(call):
    _same_error(lambda: call(jgeo), lambda: call(tgeo))


@pytest.mark.parametrize("menu", [MENU35, MENU357])
def test_geometry_for_equals_jax(menu):
    j, t = jgeo.GeometryEnvelope(menu), tgeo.GeometryEnvelope(menu)
    for n, props in menu:
        jg, tg = jgeo.geometry_for(j, n, props), tgeo.geometry_for(t, n, props)
        assert tg._fields == jg._fields
        for f in jg._fields:
            a, b = np.asarray(getattr(jg, f)), np.asarray(getattr(tg, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(b, a, err_msg=f)


PROTOCOLS = [
    {},
    {"prepare_delay_min": 1, "prepare_delay_max": 6, "prepare_retry_count": 2,
     "prepare_retry_timeout": 3, "accept_retry_count": 2, "accept_retry_timeout": 3,
     "commit_retry_timeout": 3},
]


@pytest.mark.parametrize("pc", PROTOCOLS)
@pytest.mark.parametrize("patience", [1, 8, 1024])
def test_protocol_knobs_equal_jax(pc, patience):
    jk = jgeo.protocol_knobs(jcfg.ProtocolConfig(**pc), stall_patience=patience)
    tk = tgeo.protocol_knobs(tcfg.ProtocolConfig(**pc), stall_patience=patience)
    assert tk._fields == jk._fields
    assert [(type(x), int(x)) for x in tk] == [(type(x), int(x)) for x in jk]
    js = jgeo.static_protocol(jcfg.ProtocolConfig(**pc), stall_patience=patience)
    ts = tgeo.static_protocol(tcfg.ProtocolConfig(**pc), stall_patience=patience)
    assert tuple(ts) == tuple(js)


@pytest.mark.parametrize("name,value", [
    ("stall_patience", 0), ("stall_patience", 2000), ("prepare_retry_timeout", 10_000),
    ("prepare_delay_max", 65), ("commit_retry_timeout", 0),
])
def test_protocol_knob_span_rejections_equal_jax(name, value):
    def call(cfgm, geo):
        if name == "stall_patience":
            return geo.protocol_knobs(cfgm.ProtocolConfig(), stall_patience=value)
        return geo.protocol_knobs(cfgm.ProtocolConfig(**{name: value}))

    _same_error(lambda: call(jcfg, jgeo), lambda: call(tcfg, tgeo))


@pytest.mark.parametrize("menu", [MENU35, MENU357])
@pytest.mark.parametrize("axis,lo,hi,pad", [
    ("proposers", 0, 5, 0), ("proposers", 1, 7, 0), ("nodes", 0, 1_000_000, 1_000_000),
])
def test_menu_randint_words_equal_jax(menu, axis, lo, hi, pad):
    """Each entry draws at its true length and pads, as JAX's
    ``lax.switch`` branches do; one key or a stack of lane keys."""
    j, t = jgeo.GeometryEnvelope(menu), tgeo.GeometryEnvelope(menu)
    seeds = [0, 3, 977]
    for idx in range(len(menu)):
        lanes = []
        for s in seeds:
            jk = jprng.stream(jprng.root_key(s), jprng.STREAM_PREPARE_DELAY, 5)
            want = np.asarray(jgeo.menu_randint(j, jnp.int32(idx), jk, axis, lo, hi, pad))
            tk = tprng.stream(tprng.root_key(s), tprng.STREAM_PREPARE_DELAY, 5)
            got = tgeo.menu_randint(t, idx, tk, axis, lo, hi, pad)
            np.testing.assert_array_equal(got.numpy(), want)
            lanes.append((tk, want))
        keys = np.asarray([k for k, _ in lanes], np.uint64)
        got = tgeo.menu_randint(t, idx, keys, axis, lo, hi, pad)
        np.testing.assert_array_equal(got.numpy(), np.stack([w for _, w in lanes]))


def test_pad_matrix_knobs_equals_jax():
    fcs = [
        dict(drop_rate=500, dup_rate=1000, max_delay=2, crash_rate=300),
        dict(max_delay=4, edges=lambda m: m.EdgeFaultConfig(
            drop_rate=np.arange(9, dtype=np.int32).reshape(3, 3) * 100,
            dup_rate=np.full((3, 3), 200, np.int32),
            min_delay=np.zeros((3, 3), np.int32),
            max_delay=np.full((3, 3), 3, np.int32))),
    ]
    for kw in fcs:
        def fc(m):
            return m.FaultConfig(**{k: (v(m) if callable(v) else v) for k, v in kw.items()})

        jk = jnet.pad_matrix_knobs(jnet.matrix_knobs(fc(jcfg), 3), 7)
        tk = tnet.pad_matrix_knobs(tnet.matrix_knobs(fc(tcfg), 3), 7)
        for f in jk._fields:
            np.testing.assert_array_equal(np.asarray(getattr(tk, f)), np.asarray(getattr(jk, f)),
                                          err_msg=f)
    # lane-stacked tables pad on their last two axes; scalars pass through
    stacked = tnet.FaultKnobs(*(np.stack([np.full((3, 3), v, np.int32)] * 2) for v in (1, 2, 3, 4)),
                              crash_rate=np.int32(5), delay_bound=np.int32(6))
    jstacked = jnet.FaultKnobs(*stacked)
    for f in stacked._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(tnet.pad_matrix_knobs(stacked, 5), f)),
            np.asarray(getattr(jnet.pad_matrix_knobs(jstacked, 5), f)), err_msg=f)
    _same_error(lambda: jnet.pad_matrix_knobs(jnet.matrix_knobs(jcfg.FaultConfig(max_delay=2), 7), 5),
                lambda: tnet.pad_matrix_knobs(tnet.matrix_knobs(tcfg.FaultConfig(max_delay=2), 7), 5))


# ---------------------------------------------------------------- rejections


def test_engine_and_round_rejections_equal_jax():
    """The padded and runtime-protocol builds refuse what JAX's refuse,
    with JAX's type and message: a cfg off the bound, a padded round
    without its Geometry, a bound-free round given one, a
    runtime-protocol round without its ProtocolKnobs."""
    j3, t3 = _cfg(jcfg, 3, (0,)), _cfg(tcfg, 3, (0,))
    _same_error(lambda: jsim.build_engine(j3, 32, geometry=JENV35),
                lambda: tsim.build_engine(t3, 32, geometry=ENV35, device="cpu"))
    jb, tb = JENV35.bound_cfg(j3), ENV35.bound_cfg(t3)
    jgm, tgm = jgeo.geometry_for(JENV35, 3, (0,)), tgeo.geometry_for(ENV35, 3, (0,))
    jpk = jgeo.protocol_knobs(jb.protocol)
    tpk = tgeo.protocol_knobs(tb.protocol)

    def states(wl):
        jp, jg, jt, c = jsim.prepare_queues(jb, wl)
        tp, tg, tt, _ = tsim.prepare_queues(tb, wl)
        js = jsim.init_state(jb, jp, jg, jt, jprng.root_key(0), geometry=JENV35, geom=jgm,
                             pknobs=jpk)
        ts = tsim.init_state(tb, tp, tg, tt, tprng.root_key(0), device="cpu", geometry=ENV35,
                             geom=tgm, pknobs=tpk)
        return js, ts, c

    wl = [np.arange(100, 104, dtype=np.int32), np.zeros(0, np.int32)]
    js, ts, c = states(wl)
    jrf = jsim.build_engine(jb, c, geometry=JENV35, runtime_protocol=True)
    trf = tsim.build_engine(tb, c, geometry=ENV35, runtime_protocol=True, device="cpu")
    jroot, troot = jprng.root_key(0), tprng.root_key(0)
    _same_error(lambda: jrf(jroot, js, pknobs=jpk), lambda: trf(troot, ts, pknobs=tpk), TypeError)
    _same_error(lambda: jrf(jroot, js, geom=jgm), lambda: trf(troot, ts, geom=tgm), TypeError)
    jfree = jsim.build_engine(jb, c)
    tfree = tsim.build_engine(tb, c, device="cpu")
    _same_error(lambda: jfree(jroot, js, geom=jgm), lambda: tfree(troot, ts, geom=tgm), TypeError)


def test_runner_rejections_equal_jax():
    j3, t3 = _cfg(jcfg, 3, (0,), max_delay=2), _cfg(tcfg, 3, (0,), max_delay=2)
    _same_error(lambda: jrun.FleetRunner(j3, WL3, geometry=JENV35),
                lambda: trun.FleetRunner(t3, WL3, geometry=ENV35, device="cpu"))
    _same_error(lambda: jenv.runner_for(_cfg(jcfg, 7, (0, 1, 2)), TMPL, geometry=JENV35),
                lambda: tenv.runner_for(_cfg(tcfg, 7, (0, 1, 2)), TMPL, geometry=ENV35,
                                        device="cpu"))
    _same_error(lambda: jrun._pad_geometry_workload([np.arange(3)] * 3, None, 2),
                lambda: trun._pad_geometry_workload([np.arange(3)] * 3, None, 2))
    jr = jenv.runner_for(j3, TMPL, geometry=JENV35)
    tr = tenv.runner_for(t3, TMPL, geometry=ENV35, device="cpu")
    kw = lambda m: dict(workloads=[(WL3, None)], knobs=[m.FaultConfig()])  # noqa: E731
    _same_error(lambda: jr.run([3], [None], **kw(jcfg)), lambda: tr.run([3], [None], **kw(tcfg)))
    _same_error(lambda: jr.run([3], [None], geometry=(4, (0,)), **kw(jcfg)),
                lambda: tr.run([3], [None], geometry=(4, (0,)), **kw(tcfg)))
    _same_error(lambda: jr.run([3], [None], geometry=(9, (0,)), **kw(jcfg)),
                lambda: tr.run([3], [None], geometry=(9, (0,)), **kw(tcfg)))
    _same_error(
        lambda: jr.run([3], [None], geometry=(3, (0,)),
                       protocol=jcfg.ProtocolConfig(prepare_retry_timeout=10_000), **kw(jcfg)),
        lambda: tr.run([3], [None], geometry=(3, (0,)),
                       protocol=tcfg.ProtocolConfig(prepare_retry_timeout=10_000), **kw(tcfg)))
    jd = jrun.FleetRunner(JENV35.bound_cfg(j3), TMPL, geometry=JENV35)
    td = trun.FleetRunner(ENV35.bound_cfg(t3), TMPL, geometry=ENV35, device="cpu")
    _same_error(lambda: jd.run([3], [None], knobs=[jcfg.FaultConfig()], geometry=(3, (0,))),
                lambda: td.run([3], [None], knobs=[tcfg.FaultConfig()], geometry=(3, (0,))))
    # a true geometry's edge table wider than the bound
    wide = tcfg.FaultConfig(max_delay=2, edges=tcfg.EdgeFaultConfig.uniform(7, drop_rate=100))
    jwide = jcfg.FaultConfig(max_delay=2, edges=jcfg.EdgeFaultConfig.uniform(7, drop_rate=100))
    _same_error(lambda: jd.run([3], [None], workloads=[(WL3, None)], knobs=[jwide],
                               geometry=(3, (0,))),
                lambda: td.run([3], [None], workloads=[(WL3, None)], knobs=[wide],
                               geometry=(3, (0,))))


def test_envelope_cache_collapses_over_geometry_and_protocol():
    tenv.clear_cache()
    before = tenv.cache_misses()
    c3 = _cfg(tcfg, 3, (0,), max_delay=2)
    c5 = dataclasses.replace(_cfg(tcfg, 5, (0, 1), drop_rate=500, max_delay=4),
                             protocol=tcfg.ProtocolConfig(**PROTOCOLS[1]))
    rp = tenv.runner_for(c3, TMPL, geometry=ENV35, device="cpu")
    assert tenv.runner_for(c5, TMPL, geometry=ENV35, device="cpu") is rp
    assert tenv.cache_misses() - before == 1
    assert (rp.cfg.n_nodes, rp.cfg.proposers, rp.geometry) == (5, (0, 1), ENV35)
    # the same facts as JAX's padded key, less its mesh entry, with the device
    bound, jbound = ENV35.bound_cfg(c3), JENV35.bound_cfg(_cfg(jcfg, 3, (0,), max_delay=2))
    key = tenv.envelope_key(bound, TMPL, None, trun.MAX_EPISODES, 8, geometry=ENV35)
    jkey = jenv.envelope_key(jbound, TMPL, None, jrun.MAX_EPISODES, 8, None, geometry=JENV35)
    assert key == jkey[:-1] + (None,)
    assert tenv.runner_for(c3, TMPL, geometry=ENV35, device="cpu", telemetry=True) is not rp
    tenv.clear_cache()


# ---------------------------------------------------------------- padded == bound-free


def _sha(r):
    text = decision_log(r.chosen_vid, r.chosen_ballot, 208, len(r.chosen_vid))
    return hashlib.sha256(text.encode()).hexdigest()


def _assert_pad_parity(rep_true, rep_pad, n_true):
    """Lane for lane: the padded dispatch makes the bound-free dispatch's
    decisions, rounds, learned rows, crashes, message counts and verdicts;
    pad nodes never crash and never learn."""
    assert rep_true.n_lanes == rep_pad.n_lanes
    for i in range(rep_true.n_lanes):
        a, b = rep_true.lane_result(i), rep_pad.lane_result(i)
        assert (a.rounds, a.done) == (b.rounds, b.done), i
        assert _sha(a) == _sha(b), i
        for f in ("chosen_vid", "chosen_round", "chosen_ballot", "msgs"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f"lane {i} {f}")
        np.testing.assert_array_equal(b.learned[:, :n_true], a.learned)
        assert (b.learned[:, n_true:] == -1).all()
        np.testing.assert_array_equal(b.crashed[:n_true], a.crashed)
        assert not b.crashed[n_true:].any(), f"lane {i}: a pad node crashed"
        for f in ("ok", "agreement", "coverage", "quiescent", "rounds", "max_round"):
            assert getattr(rep_true.verdict, f)[i] == getattr(rep_pad.verdict, f)[i], (i, f)


def _wan5():
    return tcfg.FaultConfig(max_delay=4, edges=tcfg.EdgeFaultConfig(
        drop_rate=np.full((5, 5), 300, np.int32), dup_rate=np.full((5, 5), 200, np.int32),
        min_delay=np.zeros((5, 5), np.int32), max_delay=np.full((5, 5), 3, np.int32)))


CELLS = {
    "3in5-debug": (MENU35, 3, (0,), _sched3, dict(drop_rate=500, dup_rate=1000, max_delay=2)),
    "5in7-clean": (MENU357, 5, (0, 1), _sched5, {}),
    "5in7-crashy": (MENU357, 5, (0, 1), _sched5,
                    dict(drop_rate=500, dup_rate=1000, max_delay=2, crash_rate=3000)),
    "5in7-gray-crash": (MENU357, 5, (0, 1), _gray5, dict(drop_rate=300, max_delay=4,
                                                         crash_rate=800)),
    "5in7-wan": (MENU357, 5, (0, 1), None, "wan"),
    "3in7": (MENU357, 3, (0,), _sched3, dict(drop_rate=500, max_delay=2)),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_padded_dispatch_equals_bound_free(cell):
    """tests/test_envelope_pad.py's parity cells in the port: through one
    cached padded runner, with the cell's protocol knobs as dispatch
    data."""
    menu, n, props, sched, fkw = CELLS[cell]
    genv = tgeo.GeometryEnvelope(menu)
    fc = _wan5() if fkw == "wan" else tcfg.FaultConfig(**fkw)
    wl = TMPL[: len(props)]
    scheds = [None if sched is None else sched(tflt)] * 2
    free = trun.FleetRunner(_cfg(tcfg, n, props, max_delay=4), wl, device="cpu")
    rep = free.run([3, 5], scheds, workloads=[(wl, None)] * 2, knobs=[fc] * 2)
    padded = tenv.runner_for(_cfg(tcfg, n, props, max_delay=4), TMPL, geometry=genv,
                             device="cpu")
    prep = padded.run([3, 5], scheds, workloads=[(wl, None)] * 2, knobs=[fc] * 2,
                      geometry=(n, props), protocol=tcfg.ProtocolConfig())
    _assert_pad_parity(rep, prep, n)
    # the report replays as the TRUE geometry
    assert (prep.lane_cfg(1).n_nodes, prep.lane_cfg(1).proposers) == (n, props)
    assert prep.lane_cfg(1).faults == dataclasses.replace(fc, schedule=scheds[1])


def test_padded_armed_runner_equals_bound_free_less_its_pad():
    """The flight recorder under a geometry: each lane's summary equals the
    bound-free armed runner's once the pad nodes' and pad proposers'
    columns are cut, and those columns hold nothing."""
    wl = TMPL
    free = trun.FleetRunner(_cfg(tcfg, 5, (0, 1), max_delay=4), wl, device="cpu", telemetry=True)
    padded = tenv.runner_for(_cfg(tcfg, 5, (0, 1), max_delay=4), TMPL, geometry=ENV357,
                             device="cpu", telemetry=True)
    fc = tcfg.FaultConfig(drop_rate=300, max_delay=4, crash_rate=800)
    scheds = [_gray5(tflt), _sched5(tflt)]
    a = free.run([3, 5], scheds, workloads=[(wl, None)] * 2, knobs=[fc] * 2)
    b = padded.run([3, 5], scheds, workloads=[(wl, None)] * 2, knobs=[fc] * 2,
                   geometry=(5, (0, 1)))
    _assert_pad_parity(a, b, 5)
    for i in range(2):
        da, db = a.lane_telemetry(i), b.lane_telemetry(i)
        assert db.pop("takeover_round") == da.pop("takeover_round") + [-1]
        wa, wb = da.pop("windows"), db.pop("windows")
        assert db == da
        for k in ("node_offered", "node_delay"):
            assert [row[:5] for row in wb.pop(k)] == wa.pop(k)
        assert wb == wa


def test_padded_single_run_build_equals_sim_run():
    """``build_engine(geometry=, runtime_protocol=True)`` on the constant
    path (a baked schedule, static i.i.d. knobs, crash coins), driven by
    ``run_lanes`` with the call's Geometry and ProtocolKnobs, makes the
    true geometry's ``sim.run`` decisions."""
    pc = tcfg.ProtocolConfig(**PROTOCOLS[1])
    for n, props in ((3, (0,)), (5, (0, 1))):
        cfg = dataclasses.replace(
            _cfg(tcfg, n, props, drop_rate=500, dup_rate=1000, max_delay=2, crash_rate=2000,
                 schedule=_sched3(tflt)), protocol=pc)
        wl = TMPL[: len(props)]
        want = tsim.run(cfg, wl, device="cpu")
        bcfg = ENV357.bound_cfg(cfg)
        pad, _ = trun._pad_geometry_workload(wl, None, ENV357.bound_proposers)
        pend, gate, tail, c = tsim.prepare_queues(bcfg, pad)
        gm = tgeo.geometry_for(ENV357, n, props)
        pkn = tgeo.protocol_knobs(pc, stall_patience=tsim.IDLE_RESTART_ROUNDS)
        root = tprng.root_key(cfg.seed)
        st = tsim.init_state(bcfg, pend, gate, tail, root, device="cpu", geometry=ENV357,
                             geom=gm, pknobs=pkn)
        rf = tsim.build_engine(bcfg, c, device="cpu", geometry=ENV357, runtime_protocol=True)
        final, _ = tsim.run_lanes(rf, np.asarray([root], np.uint64), tsim.lanes_view(st),
                                  [cfg.round_budget], geom=gm, pknobs=pkn)
        got = tsim.to_result(tsim.lane_of(final, 0), want.expected_vids)
        assert (got.rounds, got.done) == (want.rounds, want.done)
        for f in ("chosen_vid", "chosen_round", "chosen_ballot", "msgs"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        np.testing.assert_array_equal(got.learned[:, :n], want.learned)
        np.testing.assert_array_equal(got.crashed[:n], want.crashed)


def test_envelope_golden_grid_equals_jax():
    """``bench.py``'s envelope configuration (the card's phase 13d) on the
    CPU: 3/5/7 tenants x both protocol configs x both rates, 64 lanes a
    cell, through ONE padded runner; every lane's rounds, verdict and
    decision-log sha256 equal the committed JAX goldens."""
    with open(os.path.join(ROOT, "tpu_paxos_torch", "data", "goldens.json")) as f:
        gold = json.load(f)["envelope"]
    e = gold["config"]
    genv = tgeo.GeometryEnvelope(tuple((n, tuple(p)) for n, p in e["menu"]))
    tmpl = [np.arange(lo, hi, dtype=np.int32) for lo, hi in e["template"]]
    lanes = e["lanes"]
    seeds = [e["first_seed"] + i for i in range(lanes)]
    tenv.clear_cache()
    before = tenv.cache_misses()
    for c in gold["cells"]:
        n, props = c["n_nodes"], tuple(c["proposers"])
        pc = tcfg.ProtocolConfig(**e["protocols"][c["protocol"]])
        cfg = tcfg.SimConfig(n_nodes=n, n_instances=e["n_instances"], proposers=props, seed=0,
                             max_rounds=e["max_rounds"], faults=tcfg.FaultConfig(max_delay=2),
                             protocol=pc)
        runner = tenv.runner_for(cfg, tmpl, geometry=genv, device="cpu")
        wl = tmpl[: len(props)]
        rep = runner.run(seeds, [None] * lanes, workloads=[(wl, None)] * lanes,
                         knobs=[tcfg.FaultConfig(**e["rates"][c["rate"]])] * lanes,
                         geometry=(n, props), protocol=pc)
        cv, cb = rep.final.met.chosen_vid.numpy(), rep.final.met.chosen_ballot.numpy()
        shas = [hashlib.sha256(decision_log(cv[i], cb[i], e["stride"], e["n_instances"])
                               .encode()).hexdigest() for i in range(lanes)]
        assert shas == c["decision_log_sha256"], (n, c["protocol"], c["rate"])
        assert rep.verdict.rounds.tolist() == c["rounds"]
        assert rep.verdict.ok.tolist() == c["ok"]
    assert tenv.cache_misses() - before == 1
    tenv.clear_cache()


def test_padded_fleet_equals_jax_padded_fleet_state_for_state():
    """One small padded dispatch live against JAX's padded FleetRunner
    (3-in-5, two lanes, a pause + burst schedule, crash coins, the second
    protocol config): the whole lane-stacked final state at the bound,
    leaf by leaf, and the verdict vectors."""
    pcs = {m: m.ProtocolConfig(**PROTOCOLS[1]) for m in (jcfg, tcfg)}
    kn = {m: m.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2, crash_rate=3000)
          for m in (jcfg, tcfg)}
    jr = jrun.FleetRunner(JENV35.bound_cfg(_cfg(jcfg, 3, (0,), max_delay=2)), TMPL,
                          geometry=JENV35)
    tr = trun.FleetRunner(ENV35.bound_cfg(_cfg(tcfg, 3, (0,), max_delay=2)), TMPL,
                          geometry=ENV35, device="cpu")
    jrep = jr.run([3, 5], [_sched3(jflt)] * 2, workloads=[(WL3, None)] * 2,
                  knobs=[kn[jcfg]] * 2, geometry=(3, (0,)), protocol=pcs[jcfg])
    trep = tr.run([3, 5], [_sched3(tflt)] * 2, workloads=[(WL3, None)] * 2,
                  knobs=[kn[tcfg]] * 2, geometry=(3, (0,)), protocol=pcs[tcfg])
    for f in jrep.verdict._fields:
        np.testing.assert_array_equal(np.asarray(getattr(trep.verdict, f)),
                                      np.asarray(getattr(jrep.verdict, f)), err_msg=f)
    assert_same_state(interop.sim_state_to_numpy(trep.final),
                      jax.tree.map(np.asarray, jrep.final))
    assert trep.cfg.n_nodes == jrep.cfg.n_nodes == 3
    assert trep.cfg.protocol == pcs[tcfg]
