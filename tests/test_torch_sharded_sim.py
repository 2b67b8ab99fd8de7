"""The port's instance-sharded general engine (``tpu_paxos_torch/parallel/
sharded_sim.py``, ``core/sim.build_engine(axis_name=, n_shards=)``)
against the JAX package's, on the CPU under the conftest's 8 virtual JAX
devices, with exact equality (all protocol state is integer).

Mirrors ``tests/test_sharded_sim.py`` test for test: the port's run at a
mesh of ``D`` ranks (threads of this process) equals JAX's ``shard_map``
run at ``D`` devices in its rounds and every SimResult array (a sharded
log compares only with a sharded log at the same ``D``: placement
differs from the unsharded engine's by design).  Beyond the mirrors: the
parity matrix (fault-free, reference faults, crashes and gates across
shards, at D = 1, 2, 4, 8 and on the (2, 4) ``("dcn", "i")`` mesh)
against goldens of JAX's runs that a slow test recomputes live; the
workload split and queue layout against JAX's on seeded random gate
graphs; the replicated leaves equal on every rank; a raising rank failing
the run by name within the group's timeout; and the sharded stress
sweep (one mix and seed here, the whole summary slow)."""

import hashlib
import importlib.util
import json
import os
import time

import numpy as np
import pytest

from tpu_paxos.config import FaultConfig as JF
from tpu_paxos.config import SimConfig as JC
from tpu_paxos.core import values as jval
from tpu_paxos.harness import validate
from tpu_paxos.parallel import mesh as jmesh
from tpu_paxos.parallel import sharded_sim as jss
from tpu_paxos_torch import config as tc
from tpu_paxos_torch.core import sim as tsim
from tpu_paxos_torch.parallel import mesh as tmesh
from tpu_paxos_torch.parallel import partition_rules as tprules
from tpu_paxos_torch.parallel import sharded_sim as tss

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tpu_paxos_torch", "data")
DEV = {"device": "cpu"}
REF = {"drop_rate": 500, "dup_rate": 1000, "max_delay": 2}


def _golden_script():
    spec = importlib.util.spec_from_file_location(
        "torch_port_goldens", os.path.join(ROOT, "scripts", "torch_port_goldens.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_script = _golden_script()
PORT = _script.sharded_modules(port=True)
JAXM = _script.sharded_modules(port=False)


def _goldens():
    with open(os.path.join(DATA, "goldens.json")) as f:
        return json.load(f)


def _cfgs(**kw):
    faults = kw.pop("faults", {})
    return JC(**kw, faults=JF(**faults)), tc.SimConfig(**kw, faults=tc.FaultConfig(**faults))


def _pair(d: int = 8, workload=None, gates=None, **kw):
    """JAX's and the port's sharded runs of one config at ``d`` shards."""
    jc, tcfg = _cfgs(**kw)
    jr = jss.run_sharded(jc, jmesh.make_instance_mesh(d), workload, gates)
    tr = tss.run_sharded(tcfg, tmesh.make_instance_mesh(d, **DEV), workload, gates)
    return jr, tr


def _assert_same(jr, tr):
    assert (tr.rounds, tr.done) == (jr.rounds, jr.done)
    for f in _script.SHARDED_ARRAYS + ("expected_vids",):
        assert np.array_equal(np.asarray(getattr(tr, f)), np.asarray(getattr(jr, f))), f


def _real(chosen_vid) -> list[int]:
    return sorted(v for v in np.asarray(chosen_vid).tolist() if v >= 0)


def _check(r):
    assert r.done, f"not quiescent after {r.rounds} rounds"
    validate.check_agreement(r.learned)
    validate.check_exactly_once(r.learned, r.expected_vids)
    return validate.check_executed_identical(r.learned)


def test_sharded_sim_fault_free_matches_unsharded_set():
    jr, tr = _pair(n_nodes=5, n_instances=256, proposers=(0, 1), seed=0)
    _assert_same(jr, tr)
    _check(tr)
    cfg = tc.SimConfig(n_nodes=5, n_instances=256, proposers=(0, 1), seed=0)
    assert _real(tr.chosen_vid) == _real(tsim.run(cfg, device="cpu").chosen_vid)


@pytest.mark.slow
def test_sharded_sim_under_reference_faults():
    """debug.conf.sample fault rates, dueling proposers, 8 shards."""
    kw = dict(n_nodes=5, n_instances=256, proposers=(0, 1), seed=1, faults=REF)
    jr, tr = _pair(**kw)
    _assert_same(jr, tr)
    _check(tr)
    assert _real(tr.chosen_vid) == _real(tsim.run(_cfgs(**kw)[1], device="cpu").chosen_vid)


@pytest.mark.slow
def test_sharded_sim_same_seed_identical():
    """Same seed, same mesh: byte-equal decisions, and JAX's."""
    kw = dict(n_nodes=5, n_instances=128, proposers=(0, 1), seed=3, faults=REF)
    jr, a = _pair(**kw)
    b = tss.run_sharded(_cfgs(**kw)[1], tmesh.make_instance_mesh(8, **DEV))
    for f in ("chosen_vid", "chosen_round", "learned"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    _assert_same(jr, a)


def _inorder_case():
    inorder = np.asarray([10, 11, 12, 13], np.int32)
    gates = [np.asarray([int(jval.NONE), 10, 11, 12], np.int32), np.zeros((0,), np.int32)]
    return inorder, [inorder, np.arange(100, 140, dtype=np.int32)], gates


def test_sharded_sim_in_order_gates_across_shards():
    """An in-order chain stays shard-affine while a second proposer floods
    ungated values over every shard: proposal order = executed order."""
    inorder, wl, gates = _inorder_case()
    jr, tr = _pair(workload=wl, gates=gates, n_nodes=5, n_instances=128, proposers=(0, 1),
                   seed=2, faults=REF)
    _assert_same(jr, tr)
    executed = _check(tr)
    validate.check_in_order_clients(max(executed, key=len), [inorder])


def test_sharded_sim_with_crashes():
    """Minority-capped fail-stop crashes under faults, sharded."""
    jr, tr = _pair(n_nodes=5, n_instances=256, proposers=(0, 1), seed=5, max_rounds=4000,
                   faults=dict(REF, crash_rate=3000))
    _assert_same(jr, tr)
    assert int(tr.crashed.sum()) <= 2
    validate.check_agreement(tr.learned)
    if tr.done:
        validate.check_exactly_once(tr.learned, tr.expected_vids)


def test_sharded_sim_uneven_instances_rejected():
    jc, tcfg = _cfgs(n_nodes=3, n_instances=100, proposers=(0,))
    with pytest.raises(ValueError, match="divide") as je:
        jss.run_sharded(jc, jmesh.make_instance_mesh())
    with pytest.raises(ValueError, match="divide") as te:
        tss.run_sharded(tcfg, tmesh.make_instance_mesh(8, **DEV))
    assert str(te.value) == str(je.value)


def _same_split(wl, gates, n):
    jw, jg = jss.split_workload(wl, gates, n)
    tw, tg = tss.split_workload(wl, gates, n)
    assert [[x.tolist() for x in s] for s in tw] == [[x.tolist() for x in s] for s in jw]
    assert (tg is None) == (jg is None)
    if tg is not None:
        assert [[x.tolist() for x in s] for s in tg] == [[x.tolist() for x in s] for s in jg]
    return tw, tg


def test_split_workload_keeps_chains_whole():
    wl = [np.asarray([10, 11, 12, 20, 21], np.int32)]
    gates = [np.asarray([int(jval.NONE), 10, 11, int(jval.NONE), 20], np.int32)]
    wls, gts = _same_split(wl, gates, 2)
    assert wls[0][0].tolist() == [10, 11, 12]
    assert wls[1][0].tolist() == [20, 21]
    assert gts[0][0].tolist() == [int(jval.NONE), 10, 11]
    assert gts[1][0].tolist() == [int(jval.NONE), 20]


def test_split_workload_branching_and_cross_proposer_gates():
    wl = [np.asarray([10, 11, 12], np.int32), np.asarray([30], np.int32)]
    gates = [np.asarray([int(jval.NONE), 10, 10], np.int32), np.asarray([10], np.int32)]
    wls, _ = _same_split(wl, gates, 4)
    shard_of = {v: s for s in range(4) for pi in range(2) for v in wls[s][pi].tolist()}
    assert shard_of[11] == shard_of[10]
    assert shard_of[12] == shard_of[10]
    assert shard_of[30] == shard_of[10]


def test_split_workload_forward_and_cross_proposer_reference():
    """A gate on a value later in the scan (proposer 0's entry gated on
    proposer 1's value) co-locates them, and the whole run completes, as
    JAX's does."""
    wl = [np.asarray([20], np.int32), np.asarray([10], np.int32)]
    gates = [np.asarray([10], np.int32), np.asarray([int(jval.NONE)], np.int32)]
    wls, _ = _same_split(wl, gates, 2)
    shard_of = {v: s for s in range(2) for pi in range(2) for v in wls[s][pi].tolist()}
    assert shard_of[20] == shard_of[10]
    jr, tr = _pair(workload=wl, gates=gates, n_nodes=3, n_instances=64, proposers=(0, 1), seed=0)
    _assert_same(jr, tr)
    _check(tr)
    assert _real(tr.chosen_vid) == [10, 20]


@pytest.mark.slow
def test_sharded_sim_seed4_no_wedge():
    """The hole-fill frontier extends only when ALL queues on the shard
    are drained: seed 4 wedged the per-proposer rule; equal to JAX's."""
    kw = dict(n_nodes=5, n_instances=256, proposers=(0, 1), seed=4, faults=REF)
    jr, tr = _pair(**kw)
    _assert_same(jr, tr)
    _check(tr)
    assert _real(tr.chosen_vid) == _real(tsim.run(_cfgs(**kw)[1], device="cpu").chosen_vid)


# ---------------- beyond the mirrors ----------------

PARITY_KEYS = [f"{c}@{m}" for c in ("fault_free", "reference", "crashes", "gates")
               for m in _script.SHARDED_MESHES]


@pytest.mark.parametrize("key", PARITY_KEYS)
def test_sharded_parity_matches_jax_goldens(key):
    """The port at D = 1, 2, 4, 8 and on (2, 4): rounds, done, the
    decision-log sha256 and every SimResult array's sha256 equal JAX's
    (``sharded_parity`` in the goldens; recomputed live, slow)."""
    name, spec = key.split("@")
    cfg, wl, gates = _script.sharded_cases(PORT)[name]
    res = tss.run_sharded(cfg, _script.sharded_mesh(PORT, spec, **DEV), wl, gates)
    assert _script.sharded_record(PORT, cfg, wl, res) == _goldens()["sharded_parity"][key]


@pytest.mark.slow
def test_sharded_parity_goldens_recompute_from_jax():
    assert _script.sharded_parity(JAXM) == _goldens()["sharded_parity"]


def _gate_graph(rng, n_prop: int):
    """A seeded random workload with gates: chains, fan-outs, forward and
    cross-proposer references, and gates on vids outside the workload."""
    vids = rng.permutation(np.arange(1000, 1000 + 8 * n_prop))[: rng.integers(4, 8 * n_prop)]
    cut = np.sort(rng.choice(np.arange(1, len(vids)), size=n_prop - 1, replace=False))
    wl = [np.asarray(x, np.int32) for x in np.split(vids, cut)]
    pool = np.concatenate([vids, [5, 6]])  # two vids nobody proposes
    gates = [np.where(rng.random(len(w)) < 0.5, rng.choice(pool, len(w)), -1).astype(np.int32)
             for w in wl]
    return wl, gates


@pytest.mark.parametrize("seed", range(4))
def test_split_workload_and_queues_equal_jax_on_random_gate_graphs(seed):
    """``split_workload``, ``min_instances`` and ``prepare_queues_sharded``
    equal JAX's on seeded random gate graphs (numpy only)."""
    rng = np.random.default_rng(seed)
    for _ in range(8):
        n_prop = int(rng.integers(1, 4))
        wl, gates = _gate_graph(rng, n_prop)
        for n in (1, 2, 3, 4, 8):
            for g in (gates, None):
                _same_split(wl, g, n)
                need = tss.min_instances(wl, g, n)
                assert need == jss.min_instances(wl, g, n)
                jc, tcfg = _cfgs(n_nodes=3, n_instances=need, proposers=tuple(range(n_prop)))
                got = tss.prepare_queues_sharded(tcfg, wl, g, n)
                want = jss.prepare_queues_sharded(jc, wl, g, n)
                assert got[3] == want[3]
                for x, y in zip(got[:3], want[:3]):
                    assert np.array_equal(x, y)


def test_replicated_leaves_equal_on_every_rank():
    """Every rank draws the coins JAX's shard body draws (the round draws
    only [P], [A] and network-plan shapes from the replicated round), so
    the replicated leaves (calendars, proposer control plane, crashes,
    message counts, cached quiescence sums) end equal on every rank, and
    the gathered run equals JAX's."""
    cfg, wl, gates = _script.sharded_cases(PORT)["crashes"]
    mesh = tmesh.make_instance_mesh(4, **DEV)
    fn, root, states, expected = tss.build_runner(cfg, mesh, wl, gates)
    final = fn(root, states)
    host = [tss.gather_state([s]) for s in final]  # each rank's own leaves, as numpy

    def leaves(tree, path=()):
        if hasattr(tree, "_fields"):
            for f in tree._fields:
                yield from leaves(getattr(tree, f), path + (f,))
        else:
            yield "/".join(("sim",) + path), tree

    seen = 0
    for (path, x), *others in zip(*(list(leaves(h)) for h in host)):
        if tprules.dims_of(path, x, slice_of_global=True) != tprules.REP:
            continue
        seen += 1
        for _, y in others:
            assert np.array_equal(x, y), path
    assert seen > 20
    want = _script.sharded_record(PORT, cfg, wl, tss.to_result(final, expected))
    assert want == _goldens()["sharded_parity"]["crashes@4"]


def _tensors(x):
    """Every tensor of a nested draw (tuples, lists, dicts, None)."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield from _tensors(x[k])
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)
    elif x is not None:
        yield x


def _digest(out) -> str:
    h = hashlib.sha256()
    for x in _tensors(out):
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def test_shared_draws_unchanged_after_the_run(monkeypatch):
    """The ranks on one device read one draw a round (``sim._round_draws``):
    each draw's tensors hash the same after the whole run as when they
    were made, so no rank's round wrote into the coins the others read;
    and the round drew once per round, not once per rank."""
    made = []
    real = tsim._draws

    def recording(*a, **kw):
        out = real(*a, **kw)
        made.append((out, _digest(out)))
        return out

    monkeypatch.setattr(tsim, "_draws", recording)
    cfg, wl, gates = _script.sharded_cases(PORT)["crashes"]
    res = tss.run_sharded(cfg, tmesh.make_instance_mesh(4, **DEV), wl, gates)
    assert len(made) == res.rounds
    assert [_digest(out) for out, _ in made] == [d for _, d in made]
    assert _script.sharded_record(PORT, cfg, wl, res) == _goldens()["sharded_parity"]["crashes@4"]


@pytest.mark.parametrize("at", ["before", "between"])
def test_failing_rank_fails_the_run_by_name_within_the_timeout(at):
    """One rank raising (before its first collective, or between two)
    makes the run raise, naming that rank, well within the timeout: the
    others' waits fail on its abort mark.  A rank that never arrives
    fails the others at the timeout.  The mesh then runs again."""
    mesh = tmesh.make_instance_mesh(8, timeout_s=5.0, **DEV)

    def body(comm):
        if at == "between":
            comm.gsum(1)
        if comm.rank == 3:
            raise ValueError("boom on purpose")
        return int(comm.gmax(comm.rank))

    t0 = time.monotonic()
    with pytest.raises(tmesh.RankError, match="rank 3 of 8 raised ValueError: boom") as e:
        mesh.run(body)
    assert e.value.rank == 3 and isinstance(e.value.__cause__, ValueError)
    assert time.monotonic() - t0 < 5.0
    late = tmesh.make_instance_mesh(2, timeout_s=1.0, **DEV)

    def stalls(comm):
        if comm.rank == 1:
            time.sleep(3.0)
        return int(comm.gmax(comm.rank))

    t0 = time.monotonic()
    with pytest.raises(tmesh.RankError, match="rank 0 of 2 raised"):
        late.run(stalls)
    assert time.monotonic() - t0 < 1.0 + 10
    assert mesh.run(lambda comm: int(comm.gmax(comm.rank))) == [7] * 8


def test_stress_sharded_one_mix_equals_golden():
    """One (mix, seed) of the sharded stress sweep at 8 ranks: its run's
    record and the suite's verdict equal JAX's (``stress_sharded.one``)."""
    assert _script.stress_sharded_one(PORT, **DEV) == _goldens()["stress_sharded"]["one"]


@pytest.mark.slow
def test_stress_sweep_sharded_summary_equals_jax():
    """The whole sharded sweep (6 mixes x 2 seeds at 8 ranks): the summary
    less ``seconds`` and ``platform`` equals JAX's."""
    from tpu_paxos_torch.harness import stress

    s = stress.sweep_sharded(2, verbose=False, **DEV)
    assert {k: v for k, v in s.items() if k not in ("seconds", "platform")} == \
        _goldens()["stress_sharded"]["summary"]


def test_sharded_state_crosses_from_jax_and_back():
    """JAX's global sharded SimState (queue leaves with the leading shard
    axis) becomes the port's per-rank slices through the partition rules,
    equal to the port's own initial slices; the port's run from it ends in
    JAX's final global state, leaf for leaf."""
    import jax

    from tpu_paxos_torch import interop

    kw = dict(n_nodes=5, n_instances=128, proposers=(0, 1), seed=1, faults=REF)
    jc, tcfg = _cfgs(**kw)
    jfn, jroot, jstate, _ = jss.build_runner(jc, jmesh.make_instance_mesh(4))
    host0 = jax.tree.map(np.asarray, jstate)
    jfinal = jax.tree.map(np.asarray, jfn(jroot, jstate))
    mesh = tmesh.make_instance_mesh(4, **DEV)
    fn, root, own, _ = tss.build_runner(tcfg, mesh)
    states = interop.sharded_sim_state_from_jax(host0, mesh)

    def same(a, b, path="sim"):
        if hasattr(a, "_fields"):
            for f in a._fields:
                same(getattr(a, f), getattr(b, f), f"{path}/{f}")
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), path

    for mine, theirs in zip(own, states):
        same(interop.sim_state_to_numpy(mine), interop.sim_state_to_numpy(theirs))
    same(interop.sharded_sim_state_to_numpy(fn(root, states)), jfinal)
