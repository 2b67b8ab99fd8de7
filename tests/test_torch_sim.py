"""The port's general engine (tpu_paxos_torch/core/sim.py) against
tpu_paxos/core/sim.py on the CPU: every SimResult array and the
decision-log sha256 must be equal, run for run; one port round from a
JAX mid-run state must equal the JAX round that follows it."""

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_simkern_cuda import assert_same_state
from tpu_paxos import config as jcfg
from tpu_paxos.core import faults as jfaults
from tpu_paxos.core import sim as jsim
from tpu_paxos.harness import reference_runner as jref
from tpu_paxos.harness import validate as jval
from tpu_paxos.replay.decision_log import decision_log as jlog
from tpu_paxos.utils import prng as jprng
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch import interop
from tpu_paxos_torch.core import faults as tfaults
from tpu_paxos_torch.core import sim as tsim
from tpu_paxos_torch.harness import reference_runner as tref
from tpu_paxos_torch.harness import validate as tval
from tpu_paxos_torch.replay.decision_log import decision_log as tlog
from tpu_paxos_torch.utils import prng as tprng

RESULT_FIELDS = (
    "learned", "chosen_vid", "chosen_round", "chosen_ballot", "crashed",
    "msgs", "expected_vids",
)
SWEEP_CASES = 8  # seeded random configs in the differential sweep
DEBUG_FAULTS = dict(drop_rate=500, dup_rate=1000, max_delay=2)
LADDERS = dict(
    prepare_delay_min=1, prepare_delay_max=7, prepare_retry_count=2,
    prepare_retry_timeout=3, accept_retry_count=1, accept_retry_timeout=4,
    commit_retry_timeout=3,
)


def _cfgs(protocol=None, faults=None, **kw):
    """The same SimConfig in both packages."""
    jfc = jcfg.FaultConfig(**(faults or {}))
    tfc = tcfg.FaultConfig(**(faults or {}))
    return (
        jcfg.SimConfig(protocol=jcfg.ProtocolConfig(**(protocol or {})), faults=jfc, **kw),
        tcfg.SimConfig(protocol=tcfg.ProtocolConfig(**(protocol or {})), faults=tfc, **kw),
    )


def _sha(res, stride, n_instances, render):
    return hashlib.sha256(
        render(res.chosen_vid, res.chosen_ballot, stride, n_instances).encode()
    ).hexdigest()


def _equivalent_workload():
    wl, gates, _ = jref.equivalent_workload(4, 4, 10)
    twl, tgates, _ = tref.equivalent_workload(4, 4, 10)
    for a, b in zip(wl + gates, twl + tgates):
        np.testing.assert_array_equal(a, b)
    return wl, gates


CASES = {
    "audit_canonical": lambda: (
        (jsim.audit_canonical_cfg(), tsim.audit_canonical_cfg()), None, None),
    "debug_conf_duel_4096": lambda: (
        _cfgs(n_nodes=5, n_instances=4096, proposers=(0, 1), faults=DEBUG_FAULTS),
        None, None),
    "gated_equivalent_4_4_10": lambda: (
        _cfgs(n_nodes=4, n_instances=80, proposers=(0, 1, 2, 3), faults=DEBUG_FAULTS),
        *_equivalent_workload()),
    "crash_rate": lambda: (
        _cfgs(n_nodes=5, n_instances=256, proposers=(0, 1, 2), seed=3,
              faults=dict(drop_rate=800, crash_rate=20_000, max_delay=1)),
        None, None),
    "protocol_ladders": lambda: (
        _cfgs(n_nodes=3, n_instances=512, proposers=(0, 1), seed=1,
              protocol=LADDERS, faults=DEBUG_FAULTS),
        None, None),
    "bench_shaped_wide_window": lambda: (
        _cfgs(n_nodes=5, n_instances=1 << 14, proposers=(0, 1), assign_window=2048,
              max_rounds=20_000, faults=DEBUG_FAULTS),
        None, None),
}


def _run_case(case):
    (jc, tc), wl, gates = CASES[case]()
    jr = jsim.run(jc, wl, gates)
    tr = tsim.run(tc, wl, gates, device="cpu")
    return jc, jr, tr


# Tests that only read a case's results share one run of it.
_run_both = functools.cache(_run_case)


def _assert_same_result(jc, jr, tr, stride):
    for f in RESULT_FIELDS:
        a, b = getattr(jr, f), getattr(tr, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (tr.rounds, tr.done) == (jr.rounds, jr.done)
    assert _sha(tr, stride, jc.n_instances, tlog) == _sha(jr, stride, jc.n_instances, jlog)


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_equals_jax(case):
    jc, jr, tr = _run_both(case)
    stride = 10 if case.startswith("gated") else max(jc.n_instances, 1024)
    _assert_same_result(jc, jr, tr, stride)
    assert tr.done
    # a crashed proposer's queued values are lost with it
    tval.check_all(tr.learned, None if tr.crashed.any() else tr.expected_vids)


def test_takeover_wedge_env_equals_jax(monkeypatch):
    monkeypatch.setenv("TPU_PAXOS_SEEDED_WEDGE", "takeover")
    jc, jr, tr = _run_case("crash_rate")
    _assert_same_result(jc, jr, tr, max(jc.n_instances, 1024))


def test_validate_verdicts_match_jax():
    jc, jr, tr = _run_both("audit_canonical")
    js = jval.check_all(jr.learned, jr.expected_vids)
    ts = tval.check_all(tr.learned, tr.expected_vids)
    assert [s.tolist() for s in js] == [s.tolist() for s in ts]
    bad = tr.learned.copy()
    bad[0, 0], bad[0, 1] = 5, 6
    with pytest.raises(tval.InvariantViolation):
        tval.check_agreement(bad)
    with pytest.raises(jval.InvariantViolation):
        jval.check_agreement(bad)


# ---------------------------------------------------------------- one round


def _jax_states(jc, k, wl=None, gates=None):
    """JAX states 0..k+1 (numpy trees) and the engine's queue cap."""
    wl = jsim.default_workload(jc) if wl is None else wl
    pend, gate, tail, c = jsim.prepare_queues(jc, wl, gates)
    root = jprng.root_key(jc.seed)
    st = jsim.init_state(jc, pend, gate, tail, root)
    rf = jax.jit(jsim.build_engine(jc, c, vid_cap=jsim.gates_vid_cap(wl, gates)))
    out = [jax.tree.map(np.asarray, st)]
    for _ in range(k + 1):
        st = rf(root, st)
        out.append(jax.tree.map(np.asarray, st))
    return out, c, rf, root


def _port_round(tc, c, vid_cap, np_state):
    rf = tsim.build_engine(tc, c, vid_cap=vid_cap, device="cpu")
    st = interop.sim_state_from_jax(np_state, device="cpu")
    return interop.sim_state_to_numpy(rf(tprng.root_key(tc.seed), st))


# JAX trajectories shared by the one-round tests: (case, last round).
TRAJECTORIES = {
    "crashy_duel_512": (lambda: (_cfgs(
        n_nodes=5, n_instances=512, proposers=(0, 1), seed=2,
        faults=dict(DEBUG_FAULTS, crash_rate=5000)), None, None), 19),
    "narrow_window_256": (lambda: (_cfgs(
        n_nodes=3, n_instances=256, proposers=(0, 1), assign_window=16,
        faults=DEBUG_FAULTS), None, None), 12),
    "gated_equivalent_4_4_10": (CASES["gated_equivalent_4_4_10"], 30),
}


@functools.cache
def _trajectory(name):
    """(jc, tc, states 0..k+1, queue cap, jitted JAX round, root)."""
    make, k = TRAJECTORIES[name]
    (jc, tc), wl, gates = make()
    return (jc, tc, *_jax_states(jc, k, wl, gates))


@pytest.mark.parametrize("k", [0, 5, 11, 19])
def test_one_port_round_from_jax_state_equals_next_jax_round(k):
    _, tc, states, c, _, _ = _trajectory("crashy_duel_512")
    assert_same_state(_port_round(tc, c, 0, states[k]), states[k + 1])


def test_one_gated_round_from_jax_state():
    _, tc, states, c, _, _ = _trajectory("gated_equivalent_4_4_10")
    _, wl, gates = CASES["gated_equivalent_4_4_10"]()
    vid_cap = jsim.gates_vid_cap(wl, gates)
    for k in (8, 30):
        assert_same_state(_port_round(tc, c, vid_cap, states[k]), states[k + 1])


def test_port_finishes_a_jax_run_handed_over_mid_flight():
    """A gated JAX run handed to the port at round 30 ends as the whole
    JAX run ends; ``run_state`` derives the gate bitmap from the state."""
    jc, tc, states, c, _, _ = _trajectory("gated_equivalent_4_4_10")
    _, jr, _ = _run_both("gated_equivalent_4_4_10")
    st = interop.sim_state_from_jax(states[30], device="cpu")
    tr = tsim.run_state(tc, st, tprng.root_key(tc.seed), jr.expected_vids, c)
    _assert_same_result(jc, jr, tr, 10)


# Conflicted own assignments planted into a mid-run state, to drive
# every requeue compaction path: a fully-conflicted contiguous run, a
# sparse spread inside the narrow sort window, a spread that needs the
# full-width sort, and more conflicts than one round may requeue.
PLANTS = {
    "contiguous": [60, 61, 62, 63],
    "narrow_sort": [200, 203, 210],
    "full_sort": [5, 100, 250],
    "capped": list(range(3, 250, 12)),
}


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_requeue_paths_from_planted_conflicts(plant):
    _, tc, states, c, rf, root = _trajectory("narrow_window_256")
    st = states[12]
    pos = np.asarray(PLANTS[plant])
    own = st.prop.own_assign.copy()
    learned = st.learned.copy()
    own[0, pos] = 10_000 + pos
    learned[0, pos] = 20_000 + pos  # node 0 is proposer 0's node
    st = st._replace(learned=learned, prop=st.prop._replace(own_assign=own))
    want = jax.tree.map(np.asarray, rf(root, jax.tree.map(jnp.asarray, st)))
    got = _port_round(tc, c, 0, st)
    assert_same_state(got, want)
    assert int(got.prop.tail[0]) > int(st.prop.tail[0])  # something requeued


def test_round_consumes_its_state_in_place():
    """The round updates the acceptor arrays and the ack cube of the
    state it is given, as the kernels do on a card: after each round
    the input's acceptor arrays are the output's, and its ack cube is
    either folded in place or untouched (a fresh batch starts a new
    cube).  tests/test_torch_simkern_cuda.py holds the card to the
    same contract."""
    _, tc, states, c, _, _ = _trajectory("crashy_duel_512")
    rf = tsim.build_engine(tc, c, device="cpu")
    root = tprng.root_key(tc.seed)
    stored = folded = 0
    for k in range(len(states) - 1):
        st = interop.sim_state_from_jax(states[k], device="cpu")
        out = interop.sim_state_to_numpy(rf(root, st))
        assert_same_state(out, states[k + 1])
        after = interop.sim_state_to_numpy(st)
        for f in ("acc_ballot", "acc_vid"):
            np.testing.assert_array_equal(getattr(after.acc, f), getattr(out.acc, f), err_msg=f)
        acks_in = states[k].prop.acks
        assert np.array_equal(after.prop.acks, out.prop.acks) or np.array_equal(
            after.prop.acks, acks_in)
        stored += not np.array_equal(after.acc.acc_ballot, states[k].acc.acc_ballot)
        folded += not np.array_equal(after.prop.acks, acks_in)
    assert stored and folded


def test_interop_round_trip():
    states = _trajectory("narrow_window_256")[2]
    back = interop.sim_state_to_numpy(interop.sim_state_from_jax(states[4], device="cpu"))
    assert_same_state(back, states[4])


# ---------------------------------------------------------------- sweep


def _draw_case(rng):
    """One random small config: 1-7 nodes, any proposer subset, i.i.d.
    drop/dup/delay and crash rates, a protocol ladder, a window and a
    seed, sometimes the reference's gated in-order workload."""
    a = int(rng.integers(1, 8))
    props = tuple(sorted(rng.choice(a, size=int(rng.integers(1, a + 1)), replace=False).tolist()))
    min_delay = int(rng.integers(0, 2))
    faults = dict(
        drop_rate=int(rng.choice([0, 300, 2000, 5000])),
        dup_rate=int(rng.choice([0, 1000, 4000])),
        min_delay=min_delay, max_delay=min_delay + int(rng.integers(0, 4)),
        crash_rate=int(rng.choice([0, 0, 5000, 40000])),
    )
    prot = dict(
        prepare_delay_min=int(rng.integers(0, 3)),
        prepare_retry_count=int(rng.integers(1, 4)),
        prepare_retry_timeout=int(rng.integers(1, 4)),
        accept_retry_count=int(rng.integers(1, 4)),
        accept_retry_timeout=int(rng.integers(1, 4)),
        commit_retry_timeout=int(rng.integers(1, 4)),
    )
    prot["prepare_delay_max"] = prot["prepare_delay_min"] + int(rng.integers(0, 6))
    kw = dict(n_nodes=a, proposers=props, n_instances=int(rng.choice([16, 33, 64, 100, 256, 300])),
              seed=int(rng.integers(0, 1000)), max_rounds=600)
    window = int(rng.choice([0, 1, 3, 8, 64]))
    if window:
        kw["assign_window"] = window
    wl = gates = None
    if rng.random() < 0.3:
        ids = kw["n_instances"] // 4
        wl, gates, _ = jref.equivalent_workload(a, 2, ids)
        kw.update(n_instances=max(kw["n_instances"], 4 * ids), proposers=tuple(range(a)))
    return _cfgs(protocol=prot, faults=faults, **kw), wl, gates


_SWEEP_RNG = np.random.default_rng(1234)
SWEEP = [_draw_case(_SWEEP_RNG) for _ in range(SWEEP_CASES)]


@pytest.mark.parametrize("k", range(SWEEP_CASES))
def test_random_config_equals_jax(k):
    (jc, tc), wl, gates = SWEEP[k]
    jr = jsim.run(jc, wl, gates)
    tr = tsim.run(tc, wl, gates, device="cpu")
    _assert_same_result(jc, jr, tr, 10 if gates is not None else max(jc.n_instances, 1024))


# ---------------------------------------------------------------- guards


def test_use_kernels_on_cpu_raises():
    _, tc = _cfgs(n_nodes=3, n_instances=16)
    with pytest.raises(ValueError, match="CUDA"):
        tsim.build_engine(tc, 32, use_kernels=True, device="cpu")


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    _, tc = _cfgs(n_nodes=3, n_instances=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsim.run(tc)


@pytest.mark.parametrize("field", ["schedule", "edges", "delivery_cut"])
def test_unported_faults_raise_by_name(field):
    """These three fault fields raised by name before the port ran
    them; now each runs and equals the JAX run."""
    faults = {
        "schedule": dict(DEBUG_FAULTS, schedule=jfaults.FaultSchedule((jfaults.pause(2, 5, 1),))),
        "edges": dict(max_delay=1, edges=jcfg.EdgeFaultConfig.uniform(3, drop_rate=5)),
        "delivery_cut": dict(DEBUG_FAULTS, delivery_cut=True, schedule=jfaults.FaultSchedule(
            (jfaults.partition(1, 6, (0,), (1, 2)),))),
    }[field]
    jc = jcfg.SimConfig(n_nodes=3, n_instances=16, faults=jcfg.FaultConfig(**faults))
    tfaults_kw = dict(faults)
    if "schedule" in faults:
        tfaults_kw["schedule"] = tfaults.FaultSchedule.from_dict(faults["schedule"].to_dict())
    if "edges" in faults:
        tfaults_kw["edges"] = tcfg.EdgeFaultConfig.from_dict(faults["edges"].to_dict())
    tc = tcfg.SimConfig(n_nodes=3, n_instances=16, faults=tcfg.FaultConfig(**tfaults_kw))
    _assert_same_result(jc, jsim.run(jc), tsim.run(tc, device="cpu"), 1024)


@pytest.mark.parametrize("flag", ["telemetry", "runtime_knobs", "runtime_schedule",
                                  "geometry", "runtime_protocol", "axis_name"])
def test_unported_build_flags_raise_by_name(flag):
    """Every build option is ported now (the test keeps its name).  The
    runtime-schedule, runtime-knob and runtime-protocol builds: their round
    raises by name the per-call input it is not given, as the JAX round
    does.  The telemetry build: with ``axis_name`` it raises JAX's
    ValueError.  The geometry build: a ``geometry`` that is no
    GeometryEnvelope raises JAX's TypeError.  The sharded build
    (``axis_name``, ``n_shards``; tests/test_torch_sharded_sim.py): an
    instance count the shards do not divide raises JAX's ValueError, and
    an ``axis_name`` that is no rank's mesh collectives raises by name."""
    jc, tc = _cfgs(n_nodes=3, n_instances=16)
    if flag == "telemetry":
        with pytest.raises(ValueError) as je:
            jsim.build_engine(jc, 32, axis_name="x", telemetry=True)
        with pytest.raises(ValueError) as te:
            tsim.build_engine(tc, 32, device="cpu", axis_name="x", telemetry=True)
        assert str(te.value) == str(je.value) and "sharded" in str(te.value)
        return
    if flag == "geometry":
        with pytest.raises(TypeError) as je:
            jsim.build_engine(jc, 32, geometry=True)
        with pytest.raises(TypeError) as te:
            tsim.build_engine(tc, 32, device="cpu", geometry=True)
        assert str(te.value) == str(je.value) and "GeometryEnvelope" in str(te.value)
        return
    if flag == "axis_name":
        with pytest.raises(ValueError) as je:
            jsim.build_engine(jc, 32, axis_name="i", n_shards=3)
        with pytest.raises(ValueError) as te:
            tsim.build_engine(tc, 32, device="cpu", axis_name="i", n_shards=3)
        assert str(te.value) == str(je.value) and "not divisible by 3" in str(te.value)
        with pytest.raises(TypeError, match="axis_name must be a rank's parallel.mesh.Collectives"):
            tsim.build_engine(tc, 32, device="cpu", **{flag: True})
        return
    rf = tsim.build_engine(tc, 32, device="cpu", **{flag: True})
    pend, gate, tail, c = tsim.prepare_queues(tc, tsim.default_workload(tc))
    assert c == 32
    root = tprng.root_key(0)
    st = tsim.init_state(tc, pend, gate, tail, root, device="cpu")
    want = {"runtime_schedule": "ScheduleTable", "runtime_knobs": "FaultKnobs",
            "runtime_protocol": "ProtocolKnobs"}[flag]
    with pytest.raises(TypeError, match=want):
        rf(root, st)


def test_admit_block_is_not_ported():
    """``admit_block`` once raised by name; it is ported now (serving,
    tests/test_torch_serve.py), and here two appends onto a fresh state's
    empty queues, the second wider than the first, give JAX's state
    leaf for leaf (the test keeps its name)."""
    jc, tc = _cfgs(n_nodes=3, n_instances=16, proposers=(0, 1))
    pend, gate, tail, _ = jsim.prepare_queues(jc, jsim.default_workload(jc))
    empty = np.full_like(pend, -1)
    jst = jsim.init_state(jc, empty, gate, np.zeros_like(tail), jprng.root_key(0))
    tst = tsim.init_state(tc, empty, gate, np.zeros_like(tail), tprng.root_key(0), device="cpu")
    for blk in ([[5, 6, -1], [9, -1, -1]], [[7, -1, -1, -1, -1], [10, 11, 12, 13, -1]]):
        blk = np.asarray(blk, np.int32)
        jst, tst = jsim.admit_block(jst, jnp.asarray(blk)), tsim.admit_block(tst, blk)
    assert_same_state(interop.sim_state_to_numpy(tst), jax.tree.map(np.asarray, jst))
    assert tst.prop.tail.tolist() == [3, 5]


def test_empty_schedule_runs_like_none():
    """An episode-free schedule is the same program in JAX (no tables,
    no horizon), so the port runs it."""
    jc, tc = _cfgs(n_nodes=3, n_instances=64, proposers=(0, 1), faults=DEBUG_FAULTS)
    tc = dataclasses.replace(tc, faults=dataclasses.replace(
        tc.faults, schedule=tfaults.FaultSchedule(())))
    jc = dataclasses.replace(jc, faults=dataclasses.replace(
        jc.faults, schedule=jfaults.FaultSchedule(())))
    _assert_same_result(jc, jsim.run(jc), tsim.run(tc, device="cpu"), 1024)


def test_decision_log_text_equals_jax():
    jc, jr, tr = _run_both("crash_rate")
    for payload in (None, lambda v: f"v{v}"):
        assert tlog(tr.chosen_vid, tr.chosen_ballot, 1024, 256, payload=payload) == jlog(
            jr.chosen_vid, jr.chosen_ballot, 1024, 256, payload=payload)
    assert tlog(np.full(4, -1, np.int32), np.zeros(4, np.int32), 7, 4) == ""
