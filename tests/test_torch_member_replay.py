"""Injection record/replay, crash-rejoin and checkpoints of the port
(``membership/engine.MemberSim``, ``tpu_paxos_torch/checkpoint.py``)
against the JAX package's, on the CPU: the injection-log JSON is
byte-equal to JAX's for the same run (a rejoin's too, from the same
checkpoint file); a replay reproduces the run state for state; the
stale-epoch, pre-crash, live-node and swapped- or missing-file cases are
refused with JAX's messages; checkpoints cross both ways between the
packages for ``MemberState`` and ``SimState``; the format-version
messages equal JAX's."""

import json

import jax
import numpy as np
import pytest

from test_torch_membership import _same_error, assert_same_state
from tpu_paxos import checkpoint as jck
from tpu_paxos import config as jcfg
from tpu_paxos.core import faults as jflt
from tpu_paxos.core import sim as jsim
from tpu_paxos.membership import engine as jm
from tpu_paxos.utils import prng as jprng
from tpu_paxos_torch import checkpoint as tck
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch.core import faults as tflt
from tpu_paxos_torch.core import sim as tsim
from tpu_paxos_torch.harness import validate as tval
from tpu_paxos_torch.membership import engine as tm
from tpu_paxos_torch.utils import prng as tprng


def _grow(ms, targets):
    for tgt in targets:
        cv = ms.add_acceptor(tgt)
        assert ms.run_until(lambda: ms.applied(cv), max_rounds=2000), tgt


def _drive(ms):
    """A driver whose injections land on rounds it decides from the state."""
    ms.propose(0, 100)
    cv = ms.add_acceptor(1)
    assert ms.run_until(lambda: ms.applied(cv), max_rounds=400)
    ms.propose(1, 101)
    assert ms.run_until(lambda: ms.chosen(101), max_rounds=400)
    ms.run_rounds(3)


@pytest.mark.parametrize("sched", [False, True])
def test_injection_log_bytes_equal_jax_and_replay(tmp_path, sched):
    kw = dict(n_nodes=4, n_instances=32, seed=3, crash_rate=4000)
    j = jm.MemberSim(**kw, schedule=jflt.FaultSchedule((jflt.pause(2, 5, 3),)) if sched else None)
    t = tm.MemberSim(**kw, schedule=tflt.FaultSchedule((tflt.pause(2, 5, 3),)) if sched else None,
                     device="cpu")
    _drive(j)
    _drive(t)
    jp, tp = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    j.save_injections(jp)
    t.save_injections(tp)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert b.read() == a.read()
    again = tm.MemberSim.replay(jp, device="cpu")
    assert again.decision_log() == t.decision_log()
    assert_same_state(j.state, again.state)
    # the JAX package replays the port's log too
    assert jm.MemberSim.replay(tp).decision_log() == t.decision_log()


def test_replay_rejects_unknown_version_and_ops(tmp_path):
    for doc in ({"version": 99}, {"version": 1, "n_nodes": 3, "n_instances": 8, "seed": 0,
                                  "crash_rate": 0, "schedule": None,
                                  "ops": [[0, "teleport", []]], "final_t": 0},
                {"version": 1, "n_nodes": 3, "n_instances": 8, "seed": 0, "crash_rate": 0,
                 "schedule": None, "ops": [[4, "propose", [0, 1]], [2, "propose", [0, 2]]],
                 "final_t": 6}):
        p = str(tmp_path / "bad.json")
        with open(p, "w") as f:
            json.dump(doc, f)
        _same_error(lambda: jm.MemberSim.replay(p), lambda: tm.MemberSim.replay(p, device="cpu"))


def test_injections_record_through_membership_ops():
    ms = tm.MemberSim(n_nodes=3, n_instances=16, seed=0, device="cpu")
    ms.propose(0, 100)
    cv = ms.add_acceptor(1)
    assert [op for _, op, _ in ms.injections] == ["propose", "propose"]
    assert ms.injections[1][2] == [0, cv]


@pytest.fixture(scope="module")
def rejoined(tmp_path_factory):
    """One crash -> checkpoint -> rejoin run per package from ONE
    checkpoint file (the JAX-written one), with their injection logs."""
    d = tmp_path_factory.mktemp("rejoin")
    ck = str(d / "n2.npz")
    out = {}
    for name, m, ck_mod, kw in (("jax", jm, jck, {}), ("port", tm, tck, {"device": "cpu"})):
        ms = m.MemberSim(n_nodes=5, n_instances=48, seed=4, **kw)
        _grow(ms, (1, 2))
        ms.propose(0, 100)
        assert ms.run_until(lambda: ms.chosen(100))
        ms.crash(2)
        if name == "jax":
            ck_mod.save(ck, ms.state, meta={"crashed_node": 2})
        ms.propose(0, 101)
        assert ms.run_until(lambda: ms.chosen(101))
        ms.rejoin_from_checkpoint(2, ck)
        assert ms.run_until(lambda: {100, 101} <= set(ms.applied_log(2).tolist()))
        inj = str(d / f"{name}.json")
        ms.save_injections(inj)
        out[name] = (ms, inj)
    return out, ck


def test_rejoin_equals_jax_and_replays(rejoined):
    out, ck = rejoined
    (j, jp), (t, tp) = out["jax"], out["port"]
    assert_same_state(j.state, t.state)
    assert not bool(t.state.crashed[2])
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert b.read() == a.read()
    rejoin = [o for o in t.injections if o[1] == "rejoin"][0]
    assert rejoin[2][2]["n_nodes"] == 5 and rejoin[2][2]["sha256"]
    again = tm.MemberSim.replay(tp, device="cpu")
    assert again.decision_log() == t.decision_log()
    tval.check_prefix_consistency([t.applied_log(i) for i in range(5)])


def test_replay_verifies_rejoin_checkpoint_integrity(rejoined, tmp_path):
    out, ck = rejoined
    t, tp = out["port"]
    doc = json.load(open(tp))
    for o in doc["ops"]:
        if o[1] == "rejoin":
            o[2][1] = str(tmp_path / "moved.npz")
    moved = str(tmp_path / "inj.json")
    json.dump(doc, open(moved, "w"))
    # missing file names the path
    _same_error(lambda: jm.MemberSim.replay(moved), lambda: tm.MemberSim.replay(moved, device="cpu"))
    # a rewritten (valid) checkpoint names the hash
    tck.save(str(tmp_path / "moved.npz"), t.state, meta={"tampered": True})
    _same_error(lambda: jm.MemberSim.replay(moved), lambda: tm.MemberSim.replay(moved, device="cpu"))
    # a wrong recorded geometry names both
    for o in doc["ops"]:
        if o[1] == "rejoin":
            o[2][1] = ck
            o[2][2]["n_instances"] = 64
    json.dump(doc, open(moved, "w"))
    _same_error(lambda: jm.MemberSim.replay(moved), lambda: tm.MemberSim.replay(moved, device="cpu"))


def test_rejoin_refusals_equal_jax(tmp_path):
    """A pre-crash checkpoint, a live node, and a stale epoch."""
    def sims():
        j = jm.MemberSim(n_nodes=5, n_instances=48, seed=6)
        t = tm.MemberSim(n_nodes=5, n_instances=48, seed=6, device="cpu")
        for ms in (j, t):
            _grow(ms, (1, 2))
        return j, t

    j, t = sims()
    early = str(tmp_path / "early.npz")
    jck.save(early, j.state)
    for ms in (j, t):
        ms.crash(1)
    _same_error(lambda: j.rejoin_from_checkpoint(1, early),
                lambda: t.rejoin_from_checkpoint(1, early))
    j, t = sims()
    ck1 = str(tmp_path / "epoch1.npz")
    for ms in (j, t):
        ms.crash(2)
    tck.save(ck1, t.state)
    for ms in (j, t):
        ms.rejoin_from_checkpoint(2, ck1)
    _same_error(lambda: j.rejoin_from_checkpoint(2, ck1),
                lambda: t.rejoin_from_checkpoint(2, ck1))
    for ms in (j, t):
        ms.propose(0, 100)
        assert ms.run_until(lambda: ms.chosen(100))
        ms.crash(2)
    _same_error(lambda: j.rejoin_from_checkpoint(2, ck1),
                lambda: t.rejoin_from_checkpoint(2, ck1))
    assert_same_state(j.state, t.state)


# ---------------- checkpoints across the packages ----------------

def test_member_checkpoint_crosses_both_ways(tmp_path):
    j = jm.MemberSim(n_nodes=3, n_instances=32, seed=0)
    t = tm.MemberSim(n_nodes=3, n_instances=32, seed=0, device="cpu")
    for ms in (j, t):
        ms.add_acceptor(1)
        ms.run_rounds(2)  # change in flight
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save(jp, j.state, {"k": 1})
    tck.save(tp, t.state, {"k": 1})
    with np.load(jp) as a, np.load(tp) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            assert b[k].dtype == a[k].dtype
    fresh = tm.MemberSim(n_nodes=3, n_instances=32, seed=0, device="cpu")
    fresh.state, meta = tck.restore(jp, fresh.state)
    assert meta == {"format": tck.FORMAT, "k": 1}
    assert_same_state(j.state, fresh.state)
    assert fresh.run_until(lambda: fresh.applied(tm.change_vid(1, tm.ADD_ACCEPTOR)), 400)
    back, _ = jck.restore(tp, jm.MemberSim(n_nodes=3, n_instances=32, seed=0).state)
    assert_same_state(back, t.state)


def _sim_states(cfg_mod, sim_mod, prng_mod, **kw):
    cfg = cfg_mod.SimConfig(n_nodes=3, n_instances=32, proposers=(0, 1), seed=7,
                            faults=cfg_mod.FaultConfig(drop_rate=500, max_delay=2))
    pend, gate, tail, c = sim_mod.prepare_queues(cfg, sim_mod.default_workload(cfg))
    root = prng_mod.root_key(cfg.seed)
    return cfg, sim_mod.init_state(cfg, pend, gate, tail, root, **kw), c, root


def test_sim_checkpoint_crosses_both_ways(tmp_path):
    """A mid-run JAX SimState restores into the port's tree and resumes
    round for round; the port's checkpoint restores in JAX."""
    cfg, js, c, root = _sim_states(jcfg, jsim, jprng)
    step = jax.jit(lambda s, f=jsim.build_engine(cfg, c): f(root, s))
    for _ in range(6):
        js = step(js)
    jp = str(tmp_path / "sim.npz")
    jck.save(jp, js, {"round": 6})
    tcf, like, tc, troot = _sim_states(tcfg, tsim, tprng, device="cpu")
    ts, meta = tck.restore(jp, like)
    assert meta["round"] == 6
    for a, b in zip(jax.tree.leaves(js), tck._leaves(ts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    rf = tsim.build_engine(tcf, tc, device="cpu")
    for _ in range(3):
        js = step(js)
        ts = rf(troot, ts)
    for a, b in zip(jax.tree.leaves(js), tck._leaves(ts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    tp = str(tmp_path / "tsim.npz")
    tck.save(tp, ts)
    back, _ = jck.restore(tp, _sim_states(jcfg, jsim, jprng)[1])
    for a, b in zip(jax.tree.leaves(back), tck._leaves(ts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_checkpoint_refusals_and_format_messages_equal_jax(tmp_path):
    _, js, _, _ = _sim_states(jcfg, jsim, jprng)
    _, ts, _, _ = _sim_states(tcfg, tsim, tprng, device="cpu")
    path = str(tmp_path / "ck.npz")
    jck.save(path, js, meta={"k": 1})
    assert tck.restore(path, ts)[1] == {"format": jck.FORMAT, "k": 1} and tck.FORMAT == jck.FORMAT
    # wrong geometry
    big = tcfg.SimConfig(n_nodes=5, n_instances=32, proposers=(0,), seed=0)
    jbig = jcfg.SimConfig(n_nodes=5, n_instances=32, proposers=(0,), seed=0)

    def like(cfg_mod, sim_mod, prng_mod, cfg, **kw):
        pend, gate, tail, _ = sim_mod.prepare_queues(cfg, sim_mod.default_workload(cfg))
        return sim_mod.init_state(cfg, pend, gate, tail, prng_mod.root_key(0), **kw)

    _same_error(lambda: jck.restore(path, like(jcfg, jsim, jprng, jbig)),
                lambda: tck.restore(path, like(tcfg, tsim, tprng, big, device="cpu")))
    # a stale-format file with a different leaf set, and an unversioned one
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files if k.startswith("leaf_")}
    payload.pop("leaf_0")
    for meta in ({"format": "tpu-paxos-ckpt-v1"}, {}):
        payload["tpu_paxos_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        stale = str(tmp_path / "stale.npz")
        np.savez(stale, **payload)
        _same_error(lambda: jck.restore(stale, js), lambda: tck.restore(stale, ts))
    # a member checkpoint into a member state of the wrong geometry
    mp = str(tmp_path / "m.npz")
    tck.save(mp, tm.MemberSim(3, 16, device="cpu").state)
    _same_error(lambda: jck.restore(mp, jm.MemberSim(3, 32).state),
                lambda: tck.restore(mp, tm.MemberSim(3, 32, device="cpu").state))
