"""The port's membership engine (``tpu_paxos_torch/membership/engine.py``:
``MemberSim`` on the lane-axis round) against the JAX package's, on the
CPU: every scenario of ``tests/test_membership.py`` but the literal-size
one (which the card runs, ``chip_smoke.py`` phase 14a) is driven through
both packages with the same seeds and injections, and the final
``MemberState`` must be equal field by field (all state is integer: no
tolerance), with byte-equal ``decision_log_of`` text and injection logs.
Also the host guards' messages, the change-vid helpers and
``check_prefix_consistency``."""

import numpy as np
import pytest
import torch

from tpu_paxos.harness import validate as jval
from tpu_paxos.membership import engine as jm
from tpu_paxos_torch.harness import validate as tval
from tpu_paxos_torch.membership import engine as tm


def _sims(**kw):
    return jm.MemberSim(**kw), tm.MemberSim(device="cpu", **kw)


def assert_same_state(js, ts):
    """Field by field: shape, dtype and every value."""
    for f in jm.MemberState._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).cpu().numpy()
        assert (a.shape, a.dtype) == (b.shape, b.dtype), f
        np.testing.assert_array_equal(b, a, err_msg=f)


def assert_same_run(j, t):
    assert_same_state(j.state, t.state)
    assert tm.decision_log_of(t.state) == jm.decision_log_of(j.state)
    assert t.injections == j.injections


def _put(ms, field, idx, value):
    """``ms.state`` with ``field[idx] = value``, in either package."""
    x = getattr(ms.state, field)
    if isinstance(x, torch.Tensor):
        x = x.clone()
        x[idx] = torch.from_numpy(value) if isinstance(value, np.ndarray) else value
    else:
        x = x.at[idx].set(value)
    ms.state = ms.state._replace(**{field: x})


def _same_error(fj, ft):
    """Both calls raise the same exception type with the same message."""
    with pytest.raises(Exception) as ej:
        fj()
    with pytest.raises(Exception) as et:
        ft()
    assert type(et.value) is type(ej.value)
    assert str(et.value) == str(ej.value)


# ---------------- the scenarios of tests/test_membership.py ----------------
# Each drives one MemberSim and returns what it observed along the way.

def _bootstrap(ms):
    ms.propose(0, 5)
    ok = ms.run_until(lambda: ms.chosen(5), max_rounds=2000)
    return [ok, ms.applied(5), ms.applied_log(0).tolist()]


def _add_acceptor(ms):
    vid = ms.add_acceptor(1)
    ok = ms.run_until(lambda: ms.applied(vid), max_rounds=400)
    return [ok, ms.acceptor_set(0), ms.acceptor_set(1)]


def _del_acceptor(ms):
    a = ms.add_acceptor(1)
    ok = ms.run_until(lambda: ms.applied(a), max_rounds=400)
    d = ms.del_acceptor(1, via=0)
    return [ok, ms.run_until(lambda: ms.applied(d), max_rounds=400),
            ms.acceptor_set(0), ms.learner_set(0)]


def _during_change(ms):
    ms.propose(0, 100)
    c = ms.add_acceptor(1)
    ms.propose(0, 101)
    ok = ms.run_until(lambda: ms.applied(c) and ms.chosen(100) and ms.chosen(101),
                      max_rounds=800)
    return [ok, [ms.applied_log(i).tolist() for i in range(2)]]


def _grow_shrink(ms):
    nxt = [0]
    seen = []

    def burst(k=2, via=0):
        out = []
        for _ in range(k):
            ms.propose(via, nxt[0])
            out.append(nxt[0])
            nxt[0] += 1
        return out

    proposed = []
    for tgt in range(1, 7):
        proposed += burst()
        c = ms.add_acceptor(tgt)
        seen.append(ms.run_until(lambda: ms.applied(c), max_rounds=2000))
    proposed += burst(via=3)
    seen.append(ms.run_until(lambda: all(ms.chosen(v) for v in proposed), max_rounds=2000))
    for tgt in range(1, 7):
        c = ms.del_acceptor(tgt)
        seen.append(ms.run_until(lambda: ms.applied(c), max_rounds=2000))
    final = burst()
    seen.append(ms.run_until(lambda: all(ms.chosen(v) for v in final), max_rounds=2000))
    return seen + [ms.acceptor_set(0)]


def _same_version(ms):
    c = ms.add_acceptor(1)
    ok = ms.run_until(lambda: ms.applied(c), max_rounds=400)
    ms.propose(1, 200)
    return [ok, ms.run_until(lambda: ms.chosen(200), max_rounds=800)]


def _stale_version(ms):
    """Node 1 rewound to its bootstrap view: the version gate holds its
    proposal until its learner frontier catches up."""
    a = ms.add_acceptor(1)
    seen = [ms.run_until(lambda: ms.applied(a), max_rounds=400)]
    fill = [100, 101, 102, 103]
    for v in fill:
        ms.propose(0, v)
    seen.append(ms.run_until(lambda: all(ms.chosen(v) for v in fill), max_rounds=2000))
    b = ms.add_acceptor(2)
    seen.append(ms.run_until(lambda: ms.applied(b), max_rounds=400))
    row = np.zeros((ms.n,), bool)
    row[0] = True
    for f in ("learners", "proposers", "acceptors"):
        _put(ms, f, 1, row)
    _put(ms, "version", 1, 0)
    _put(ms, "applied_upto", 1, 0)
    _put(ms, "learned", (slice(None), 1), -1)
    _put(ms, "prepared", 1, False)
    ms.propose(1, 300)
    stale = 0
    # paxlint: allow[JAX103] per-round observation IS this test's purpose
    while int(np.asarray(ms.state.version)[1]) < 2:
        # paxlint: allow[JAX103] per-round observation IS this test's purpose
        acc_has = bool(np.any(np.asarray(ms.state.acc_vid) == 300))
        # paxlint: allow[JAX103] per-round observation IS this test's purpose
        seen.append((acc_has, ms.chosen(300), bool(np.asarray(ms.state.prepared)[1])))
        ms.run_rounds(1)
        stale += 1
        assert stale < 200
    seen.append(stale)
    seen.append(ms.run_until(lambda: ms.chosen(300), max_rounds=800))
    return seen


def _in_order(ms):
    c = ms.add_acceptor(1)
    chain = [300, 301, 302, 303]
    ok = ms.propose_in_order(0, chain)
    return [ok, ms.run_until(lambda: ms.applied(c), max_rounds=800)]


def _orphan(ms):
    a = ms.add_acceptor(1)
    seen = [ms.run_until(lambda: ms.applied(a), max_rounds=400)]
    b = ms.add_acceptor(2)
    seen.append(ms.run_until(lambda: ms.applied(b), max_rounds=400))
    k = int(np.max(np.flatnonzero(np.asarray(ms.state.chosen_vid) != -1))) + 1
    _put(ms, "acc_ballot", (k, 1), (1 << 16) | 1)
    _put(ms, "acc_vid", (k, 1), 777)
    seen.append(ms.run_until(lambda: ms.chosen(777), max_rounds=400))
    seen.append(ms.run_until(
        lambda: all(777 in ms.applied_log(i).tolist() for i in range(3)), max_rounds=400))
    return seen


def _del_guard(ms):
    """Crafted crashes, then the guarded deletions (the refused calls'
    messages are held in test_guards_raise_the_jax_messages)."""
    seen = []
    for tgt in (1, 2, 3, 4):
        c = ms.add_acceptor(tgt)
        seen.append(ms.run_until(lambda: ms.applied(c), max_rounds=2000))
    _put(ms, "crashed", 1, True)
    _put(ms, "crashed", 2, True)
    d = ms.del_acceptor(1)
    seen.append(ms.run_until(lambda: ms.applied(d), max_rounds=2000))
    ms.del_acceptor(3)
    return seen + [ms.acceptor_set(0)]


def _crash_churn(ms):
    nv = [0]
    proposed, seen = [], []

    def burst(k=2):
        out = []
        for _ in range(k):
            ms.propose(0, nv[0])
            out.append(nv[0])
            nv[0] += 1
        return out

    for tgt in range(1, ms.n):
        if tgt in ms.crashed_set():
            continue
        proposed += burst()
        c = ms.add_acceptor(tgt)
        seen.append(ms.run_until(lambda: ms.applied(c), max_rounds=3000))
    for _ in range(2 * ms.n):
        tgt = ms.next_shrink_target()
        if tgt is None:
            break
        c = ms.del_acceptor(tgt)
        seen.append(ms.run_until(lambda: ms.applied(c), max_rounds=3000))
    proposed += burst()
    seen.append(ms.run_until(lambda: all(ms.chosen(v) for v in proposed), max_rounds=2000))
    return seen + [ms.crashed_set(), ms.acceptor_set(0)]


SCENARIOS = {
    "bootstrap": (_bootstrap, dict(n_nodes=3, n_instances=16, seed=0)),
    "add_acceptor": (_add_acceptor, dict(n_nodes=3, n_instances=16, seed=0)),
    "del_acceptor": (_del_acceptor, dict(n_nodes=3, n_instances=32, seed=0)),
    "during_change": (_during_change, dict(n_nodes=3, n_instances=32, seed=0)),
    "grow_shrink": (_grow_shrink, dict(n_nodes=7, n_instances=96, seed=0)),
    "same_version": (_same_version, dict(n_nodes=3, n_instances=32, seed=0)),
    "stale_version": (_stale_version, dict(n_nodes=3, n_instances=32, seed=1)),
    "in_order": (_in_order, dict(n_nodes=3, n_instances=32, seed=0)),
    "orphan_repair": (_orphan, dict(n_nodes=3, n_instances=16, seed=0)),
    "del_guard": (_del_guard, dict(n_nodes=5, n_instances=48, seed=0)),
    "crash_churn": (_crash_churn, dict(n_nodes=7, n_instances=96, seed=2, crash_rate=8000)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax(name):
    drive, kw = SCENARIOS[name]
    j, t = _sims(**kw)
    seen_j = drive(j)
    seen_t = drive(t)
    assert seen_t == seen_j
    assert_same_run(j, t)
    logs = [t.applied_log(i) for i in range(t.n)]
    tval.check_prefix_consistency(logs)
    if name == "crash_churn":
        assert len(t.crashed_set()) >= 1  # the run is about crashes
    if name == "stale_version":
        assert seen_t[-2] >= 3  # the gate had a real multi-round window


def test_guards_raise_the_jax_messages():
    for args in ((3, 16, 0), (5, 48, 0)):
        j, t = _sims(n_nodes=args[0], n_instances=args[1], seed=args[2])
        _same_error(lambda: j.crash(0), lambda: t.crash(0))
        for ms in (j, t):
            ms.crash(1)
        _same_error(lambda: j.propose(1, 7), lambda: t.propose(1, 7))
        _same_error(lambda: j.add_acceptor(1), lambda: t.add_acceptor(1))
        assert_same_run(j, t)
    # the projected-view deletion guard, on the del_guard scenario's state
    j, t = _sims(n_nodes=5, n_instances=48, seed=0)
    for ms in (j, t):
        _del_guard(ms)
    _same_error(lambda: j.del_acceptor(4), lambda: t.del_acceptor(4))
    # the crash admission guard: crashing 4 of view {0, 2, 3, 4} with 1, 2 down
    _same_error(lambda: j.crash(4), lambda: t.crash(4))
    # a full pending ring refuses by name
    j, t = _sims(n_nodes=3, n_instances=4, seed=0)
    for ms in (j, t):
        for v in range(ms.c - ms.i):
            ms.propose(0, v)
    _same_error(lambda: j.propose(0, 99), lambda: t.propose(0, 99))
    assert_same_run(j, t)


def test_change_vid_helpers_equal_jax():
    for node in range(8):
        for kind in range(8):
            v = tm.change_vid(node, kind)
            assert v == jm.change_vid(node, kind)
            assert tm.decode_change(v) == jm.decode_change(v) == (node, kind)
            assert tm.membership_suffix(v) == jm.membership_suffix(v)
    vids = np.asarray([0, 5, tm.CHANGE_BASE - 1, tm.CHANGE_BASE, tm.CHANGE_BASE + 57])
    np.testing.assert_array_equal(tm.is_change_vid(vids), jm.is_change_vid(vids))
    assert tm.membership_suffix(7) is None and jm.membership_suffix(7) is None
    consts = ("ADD_LEARNER", "LEARNER_TO_PROPOSER", "PROPOSER_TO_ACCEPTOR", "DEL_LEARNER",
              "PROPOSER_TO_LEARNER", "ACCEPTOR_TO_PROPOSER", "ADD_ACCEPTOR", "DEL_ACCEPTOR",
              "CHANGE_BASE", "ACCEPT_STALE_ROUNDS", "REPAIR_STALL_ROUNDS")
    for name in consts:
        assert getattr(tm, name) == int(getattr(jm, name)), name
    assert tm.COMMITTED_BALLOT == int(jm.COMMITTED_BALLOT) and tm._NEG == int(jm._NEG)


@pytest.mark.parametrize("logs", [
    [[1, 2, 3], [1, 2], [], [1, 2, 3]],
    [[1, 2, 3], [1, 3]],
    [[5], [6]],
    [[], []],
])
def test_check_prefix_consistency_equals_jax(logs):
    arrs = [np.asarray(x, np.int32) for x in logs]
    try:
        jval.check_prefix_consistency(arrs)
        want = None
    except jval.InvariantViolation as e:
        want = str(e)
    try:
        tval.check_prefix_consistency(arrs)
        got = None
    except tval.InvariantViolation as e:
        got = str(e)
    assert got == want


def test_member_state_is_the_jax_tree():
    """Same field names, order, shapes and dtypes; ``t`` a 0-d int32 leaf;
    the interop round trip is exact."""
    from tpu_paxos_torch import interop

    j, t = _sims(n_nodes=4, n_instances=8, seed=3)
    assert tm.MemberState._fields == jm.MemberState._fields
    assert tuple(t.state.t.shape) == () and t.state.t.dtype == torch.int32
    assert_same_state(j.state, t.state)
    for ms in (j, t):
        ms.propose(0, 9)
        ms.run_rounds(3)
    host = interop.member_state_to_numpy(t.state)
    back = interop.member_state_from_jax(j.state, device="cpu")
    assert_same_state(host, back)


def test_cuda_without_a_card_raises():
    from tpu_paxos_torch.fleet import envelope as tenv
    from tpu_paxos_torch.fleet import member_runner as tmr

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is the card's")
    for make in (lambda: tm.MemberSim(3, 8), lambda: tm.ChurnEngine(3, 8),
                 lambda: tmr.MemberFleetRunner(3, 8), lambda: tenv.member_runner_for(3, 8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


@pytest.mark.parametrize("stride,payload", [(16, False), (7, True)])
def test_membership_log_grammar_equals_jax(stride, payload):
    """The ``membership=`` branch of the decision-log renderer: change
    vids in the ``m+id=node:id`` / ``m-id`` grammar, plain values and
    no-ops in the normal one, byte for byte as JAX renders them."""
    from tpu_paxos.replay.decision_log import decision_log as jlog
    from tpu_paxos_torch.replay.decision_log import decision_log as tlog

    chosen = np.asarray([tm.change_vid(1, tm.ADD_ACCEPTOR), 7, -1, tm.change_vid(1, tm.DEL_ACCEPTOR),
                         -2 - 3, tm.change_vid(4, tm.ADD_LEARNER), 35,
                         tm.change_vid(2, tm.ACCEPTOR_TO_PROPOSER)], np.int32)
    ballots = np.arange(65536, 65536 + len(chosen), dtype=np.int32)
    kw = dict(payload=(lambda v: f"<{v}>") if payload else None)
    want = jlog(chosen, ballots, stride, len(chosen), membership=jm.membership_suffix, **kw)
    got = tlog(chosen, ballots, stride, len(chosen), membership=tm.membership_suffix, **kw)
    assert got == want
    assert got.splitlines()[0].endswith("m+1=node:1") and got.splitlines()[2].endswith("m-1")
    empty = np.full((4,), -1, np.int32)
    assert tlog(empty, empty, 4, 4, membership=tm.membership_suffix) == ""
