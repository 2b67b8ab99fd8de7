"""Correlated faults in the port against the JAX package on the CPU:
schedule lowering (tpu_paxos_torch/core/faults.py), WAN presets
(core/wan.py), the matrix-knob, burst and gray copy plans and the
delivery cut (core/net.py), and the general engine under every episode
and WAN mix of ``tpu_paxos/harness/stress.py`` (core/sim.py).
Everything must be equal exactly."""

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sim import _jax_states, _port_round
from test_torch_simkern_cuda import assert_same_state
from tpu_paxos import config as jcfg
from tpu_paxos.core import faults as jflt
from tpu_paxos.core import net as jnet
from tpu_paxos.core import sim as jsim
from tpu_paxos.core import wan as jwan
from tpu_paxos.harness import stress
from tpu_paxos.replay.decision_log import decision_log as jlog
from tpu_paxos.utils import prng as jprng
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch.core import faults as tflt
from tpu_paxos_torch.core import net as tnet
from tpu_paxos_torch.core import sim as tsim
from tpu_paxos_torch.core import wan as twan
from tpu_paxos_torch.replay.decision_log import decision_log as tlog
from tpu_paxos_torch.utils import prng as tprng

N = 5
EPISODES = {
    "partition": lambda f: f.partition(2, 9, (0, 1), (3,)),
    "one_way": lambda f: f.one_way(1, 6, (0, 4), (1, 2, 4)),
    "pause": lambda f: f.pause(3, 8, 1, 3),
    "burst": lambda f: f.burst(0, 5, 2500),
    "crash": lambda f: f.crash(4, 2),
    "gray": lambda f: f.gray(2, 7, 0, 4, delay=3),
}
# every kind at once, overlapping (cuts AND, bursts add past 1e4,
# grays add, the crash stays)
ALL_KINDS = lambda f: f.FaultSchedule((  # noqa: E731
    *(make(f) for make in EPISODES.values()),
    f.burst(3, 10, 9000), f.gray(5, 12, 4, delay=2), f.partition(6, 11, (2, 4)),
))


def _sched(kind):
    if kind == "all":
        return ALL_KINDS(jflt), ALL_KINDS(tflt)
    return (jflt.FaultSchedule((EPISODES[kind](jflt),)),
            tflt.FaultSchedule((EPISODES[kind](tflt),)))


@pytest.mark.parametrize("kind", [*EPISODES, "all"])
def test_compile_schedule_equals_jax(kind):
    js, ts = _sched(kind)
    jc, tc = jflt.compile_schedule(js, N), tflt.compile_schedule(ts, N)
    assert tc._fields == jc._fields
    for name in jc._fields:
        a, b = getattr(jc, name), getattr(tc, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            assert a == b, name
    for e_j, e_t in zip(js.episodes, ts.episodes):
        for x, y in zip(jflt.episode_tables(e_j, N), tflt.episode_tables(e_t, N)):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    assert tflt.compile_schedule(None, N) is None
    assert tflt.compile_schedule(tflt.FaultSchedule(()), N) is None


@pytest.mark.parametrize("bad", ["node_out_of_range", "single_group"])
def test_validate_episode_same_errors_as_jax(bad):
    make = {
        "node_out_of_range": lambda f: f.pause(0, 3, N),
        "single_group": lambda f: f.partition(0, 3, tuple(range(N))),
    }[bad]
    with pytest.raises(ValueError) as je:
        jflt.validate_episode(make(jflt), N)
    with pytest.raises(ValueError) as te:
        tflt.validate_episode(make(tflt), N)
    assert str(te.value) == str(je.value)


def _edges(seed, n=N, bound=4):
    r = np.random.default_rng(seed)
    lo = r.integers(0, 3, (n, n))
    return dict(
        drop_rate=r.choice([0, 300, 2500], (n, n)), dup_rate=r.choice([0, 1000, 4000], (n, n)),
        min_delay=lo, max_delay=np.minimum(lo + r.integers(0, 3, (n, n)), bound),
    )


def _jt(x):
    return jnp.asarray(np.asarray(x))


@pytest.mark.parametrize("pa", [True, False])
@pytest.mark.parametrize("extra_drop", [None, 2500])
@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("matrix", [False, True])
def test_copy_plan_matrix_burst_gray_equal_jax(pa, extra_drop, gray, matrix):
    pn = [1, 3]
    kw = dict(max_delay=4)
    if matrix:
        e = _edges(7)
        jfc = jcfg.FaultConfig(edges=jcfg.EdgeFaultConfig(**e), **kw)
        tfc = tcfg.FaultConfig(edges=tcfg.EdgeFaultConfig(**e), **kw)
    else:
        kw.update(drop_rate=500, dup_rate=1000, min_delay=1)
        jfc, tfc = jcfg.FaultConfig(**kw), tcfg.FaultConfig(**kw)
    rows, cols = (pn, range(N)) if pa else (range(N), pn)
    shape = (len(pn), N) if pa else (N, len(pn))
    jkn = jnet.edge_knobs(jnet.matrix_knobs(jfc), np.asarray(rows), np.asarray(cols)) if matrix else None
    tkn = tnet.edge_knobs(tnet.matrix_knobs(tfc), rows, cols) if matrix else None
    g = np.asarray([3, 0, 1, 2, 5], np.int32)
    grow = (g[pn][:, None] + g[None, :]) if pa else (g[:, None] + g[pn][None, :])
    jkey = jprng.stream(jprng.root_key(5), jprng.STREAM_NET_DROP, 3)
    tkey = tprng.stream(tprng.root_key(5), tprng.STREAM_NET_DROP, 3)
    ja, jd = jnet.copy_plan(
        jkey, shape, jfc, extra_drop=None if extra_drop is None else jnp.int32(extra_drop),
        knobs=jkn, gray=_jt(grow) if gray else None, delay_bound=jfc.max_delay)
    ta, td = tnet.copy_plan(
        tkey, shape, tfc, extra_drop=extra_drop, knobs=tkn,
        gray=grow if gray else None, delay_bound=tfc.max_delay)
    assert ta.dtype == torch.bool and td.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("extra_drop", [None, 700])
def test_uniform_matrix_plan_equals_scalar_plan(extra_drop):
    """The FaultKnobs parity contract (tests/test_geo.py): a uniform
    matrix draws exactly what the scalar knobs draw."""
    kw = dict(drop_rate=500, dup_rate=1000, min_delay=1, max_delay=3)
    tfc = tcfg.FaultConfig(**kw)
    key = tprng.root_key(11)
    sa, sd = tnet.copy_plan(key, (2, 5), tfc, extra_drop=extra_drop)
    mk = tnet.edge_knobs(tnet.matrix_knobs(tfc, N), [0, 2], range(N))
    ma, md = tnet.copy_plan(key, (2, 5), tfc, extra_drop=extra_drop, knobs=mk)
    assert torch.equal(sa, ma) and torch.equal(sd, md)


def test_delivery_mask_equals_jax():
    r = np.random.default_rng(3)
    p, a = 2, N
    ar = jnet.NetBuffers(
        prep_req=r.integers(-1, 9, (p, a)), prep_echo=r.integers(-1, 9, (a, p)),
        rej=r.integers(-1, 9, (a, p)), acc_req=r.integers(-1, 9, (p, a)),
        acc_echo=r.integers(-1, 9, (a, p)), com_pres=r.random((p, a)) < 0.5,
        com_rep=r.random((a, p)) < 0.5,
    )
    ar = ar._replace(**{f: np.asarray(getattr(ar, f)).astype(
        np.int32 if f not in ("com_pres", "com_rep") else bool) for f in ar._fields})
    reach = r.random((a, a)) < 0.6
    pn = [0, 3]
    want = jnet.delivery_mask(jax.tree.map(jnp.asarray, ar), _jt(reach[pn]), _jt(reach[:, pn]))
    got = tnet.delivery_mask(
        tnet.NetBuffers(*[torch.from_numpy(np.asarray(x)) for x in ar]),
        torch.from_numpy(reach[pn]), torch.from_numpy(np.ascontiguousarray(reach[:, pn])))
    for f in jnet.NetBuffers._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("preset", ["wan-3region", "wan-5region"])
def test_wan_presets_equal_jax(preset):
    jp, tp = jwan.PRESETS[preset], twan.PRESETS[preset]
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    assert twan.PRESET_DELAY_BOUND == jwan.PRESET_DELAY_BOUND
    for n in (3, 5, 7):
        np.testing.assert_array_equal(twan.node_regions(tp, n), jwan.node_regions(jp, n))
        assert twan.edge_faults(tp, n).to_dict() == jwan.edge_faults(jp, n).to_dict()
    jf, tf = jwan.wan_fault_config(jp, 5, crash_rate=7), twan.wan_fault_config(tp, 5, crash_rate=7)
    assert (tf.max_delay, tf.crash_rate, tf.edges.to_dict()) == (
        jf.max_delay, jf.crash_rate, jf.edges.to_dict())


# ---------------------------------------------------------------- engine


def _port_faults(kw):
    """A stress mix's FaultConfig kwargs (JAX objects) for the port."""
    kw = dict(kw)
    if kw.get("schedule") is not None:
        kw["schedule"] = tflt.FaultSchedule.from_dict(kw["schedule"].to_dict())
    if kw.get("edges") is not None:
        kw["edges"] = tcfg.EdgeFaultConfig.from_dict(kw["edges"].to_dict())
    return kw


def _cfgs(faults, protocol=None, **kw):
    return (
        jcfg.SimConfig(faults=jcfg.FaultConfig(**faults),
                       protocol=jcfg.ProtocolConfig(**(protocol or {})), **kw),
        tcfg.SimConfig(faults=tcfg.FaultConfig(**_port_faults(faults)),
                       protocol=tcfg.ProtocolConfig(**(protocol or {})), **kw),
    )


def _sha(res, n):
    text = tlog(res.chosen_vid, res.chosen_ballot, max(n, 1024), n)
    return hashlib.sha256(text.encode()).hexdigest()


def _same_run(jc, jr, tr):
    for f in ("learned", "chosen_vid", "chosen_round", "chosen_ballot", "crashed", "msgs"):
        a, b = getattr(jr, f), getattr(tr, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (tr.rounds, tr.done) == (jr.rounds, jr.done)
    n = jc.n_instances
    assert _sha(tr, n) == hashlib.sha256(
        jlog(jr.chosen_vid, jr.chosen_ballot, max(n, 1024), n).encode()).hexdigest()


MIXES = {m[0]: m for m in stress.EPISODE_MIXES + stress.WAN_MIXES}
MIXES["all-kinds"] = ("all-kinds", dict(drop_rate=300, dup_rate=500, max_delay=3,
                                        schedule=ALL_KINDS(jflt)), 5, 2)


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_scheduled_run_equals_jax(mix, cut):
    _, faults, n, p = MIXES[mix]
    jc, tc = _cfgs(dict(faults, delivery_cut=cut), n_nodes=n, n_instances=64,
                   proposers=tuple(range(p)), seed=1, max_rounds=2000)
    jr, tr = jsim.run(jc), tsim.run(tc, device="cpu")
    _same_run(jc, jr, tr)
    assert tr.done and tr.rounds >= tc.faults.schedule.horizon


def test_delivery_cut_drops_inflight_copies_as_jax_does():
    """The seed of tests/test_geo.py's delivery-cut case: a copy is in
    flight across the cut, so the armed run diverges from the unarmed
    one, in the port as in JAX."""
    shas = {}
    for cut in (False, True):
        faults = dict(min_delay=2, max_delay=4, delivery_cut=cut,
                      schedule=jflt.FaultSchedule((jflt.partition(4, 24, (0, 1), (2, 3, 4)),)))
        jc, tc = _cfgs(faults, protocol=dict(prepare_delay_min=0, prepare_delay_max=1),
                       n_nodes=5, n_instances=32, proposers=(0, 1), seed=2, max_rounds=2000)
        jr, tr = jsim.run(jc), tsim.run(tc, device="cpu")
        _same_run(jc, jr, tr)
        shas[cut] = _sha(tr, 32)
    assert shas[True] != shas[False]


def test_uniform_edges_run_equals_scalar_run():
    """tests/test_geo.py's parity drive on the port: uniform per-edge
    tables give the scalar config's run bit for bit."""
    base = dict(n_nodes=3, n_instances=64, proposers=(0, 1), seed=4)
    scalar = tcfg.SimConfig(faults=tcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2), **base)
    edges = tcfg.SimConfig(faults=tcfg.FaultConfig(max_delay=2, edges=tcfg.EdgeFaultConfig.uniform(
        3, drop_rate=500, dup_rate=1000, max_delay=2)), **base)
    a, b = tsim.run(scalar, device="cpu"), tsim.run(edges, device="cpu")
    assert (a.rounds, a.done) == (b.rounds, b.done)
    for f in ("learned", "chosen_vid", "chosen_round", "chosen_ballot", "crashed", "msgs"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@functools.cache
def _trajectory():
    """The port's config and the JAX states 0..42 of one all-kinds run."""
    faults = dict(drop_rate=300, dup_rate=500, max_delay=3, schedule=ALL_KINDS(jflt))
    jc, tc = _cfgs(faults, n_nodes=5, n_instances=128, proposers=(0, 1), seed=3)
    states, c, _, _ = _jax_states(jc, 41)
    return tc, states, c


@pytest.mark.parametrize("k", [3, 12, 30, 41])
def test_one_port_round_under_a_schedule_from_jax_state(k):
    """A JAX mid-run state handed to the port inside (and between)
    episodes: the port's round equals the JAX round that follows."""
    tc, states, c = _trajectory()
    assert_same_state(_port_round(tc, c, 0, states[k]), states[k + 1])
