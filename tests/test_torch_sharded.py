"""The port's instance-sharded fast path (``tpu_paxos_torch/parallel/
sharded.py``) and its mesh against the JAX package's, live on the CPU
under the conftest's 8 virtual JAX devices, with exact equality (all
protocol state is integer).  Mirrors ``tests/test_sharded.py`` case for
case: the port's ranks are threads of this process, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_paxos.core import ballot as jbal
from tpu_paxos.core import fast as jfast
from tpu_paxos.harness import validate
from tpu_paxos.parallel import mesh as jmesh
from tpu_paxos.parallel import sharded as jsharded
from tpu_paxos_torch import interop
from tpu_paxos_torch.core import fast as tfast
from tpu_paxos_torch.parallel import mesh as tmesh
from tpu_paxos_torch.parallel import sharded as tsharded

D = 8


def _port_mesh(n=D, **kw):
    return tmesh.make_instance_mesh(n, device="cpu", **kw)


def _same_fast(port_states, jax_state):
    got = interop.sharded_fast_state_to_numpy(port_states)
    for name in jfast.FastState._fields:
        want = np.asarray(getattr(jax_state, name))
        assert np.array_equal(np.asarray(getattr(got, name)), want), name
    return got


def test_eight_device_mesh_available():
    """Eight ranks on the CPU, JAX's axis and row-major order, and the
    four collectives reduce over every rank."""
    assert len(jax.devices()) == 8
    m = _port_mesh()
    assert (m.size, m.shape, m.axis_names) == (8, (8,), ("i",))
    assert tmesh.instance_axes(m) == jmesh.instance_axes(jmesh.make_instance_mesh())

    def body(comm):
        r = comm.rank
        return (comm.gmax([r, -r]).tolist(), int(comm.gsum(r + 1)),
                comm.gany(r == 5).item(), comm.gall(r < 8).item(), comm.gall(r < 7).item(),
                comm.exchange([r, 2 * r])[:, 1].tolist())

    out = m.run(body)
    assert out == [([7, 0], 36, True, True, False, [0, 2, 4, 6, 8, 10, 12, 14])] * 8
    assert m.calls == [6] * 8


def test_sharded_matches_single_chip():
    n_inst, n_nodes, quorum = 1024, 7, 4
    jm = jmesh.make_instance_mesh()
    vids = jnp.arange(n_inst, dtype=jnp.int32)
    jstate = jsharded.init_sharded_state(jm, n_inst, n_nodes)
    jstate, jn = jsharded.sharded_choose_all(jm, proposer=0, quorum=quorum)(
        jstate, jmesh.shard_instances(jm, vids))

    m = _port_mesh()
    states = tsharded.init_sharded_state(m, n_inst, n_nodes)
    step = tsharded.sharded_choose_all(m, proposer=0, quorum=quorum)
    states, n = step(states, tmesh.shard_instances(m, np.arange(n_inst, dtype=np.int32)))
    assert n == int(jn) == n_inst
    got = _same_fast(states, jstate)
    ref, ref_n = tfast.choose_all(tfast.init_state(n_inst, n_nodes, device="cpu"),
                                  torch.arange(n_inst, dtype=torch.int32),
                                  proposer=0, quorum=quorum)
    assert int(ref_n) == n_inst
    assert np.array_equal(ref.learned.numpy(), got.learned)
    validate.check_all(np.asarray(got.learned).T, np.arange(n_inst))
    # the replicated scalars are equal on every rank
    for s in states[1:]:
        assert np.array_equal(s.promised.numpy(), states[0].promised.numpy())
        assert np.array_equal(s.max_seen.numpy(), states[0].max_seen.numpy())


def test_sharded_respects_preaccepted_across_shards():
    """A pre-accepted value on a shard-local instance (40, on shard 5)
    survives a new proposer over the whole sharded log, as in JAX."""
    n_inst, n_nodes, quorum = 64, 3, 2
    jm = jmesh.make_instance_mesh()
    base = jax.tree.map(np.asarray, jfast.init_state(n_inst, n_nodes))
    acc_ballot, acc_vid = base.acc_ballot.copy(), base.acc_vid.copy()
    acc_ballot[1, 40] = int(jbal.make(3, 1))
    acc_vid[1, 40] = 999
    max_seen = np.full_like(base.max_seen, int(jbal.make(3, 1)))
    glob = jfast.FastState(promised=base.promised, max_seen=max_seen, acc_ballot=acc_ballot,
                           acc_vid=acc_vid, learned=base.learned)
    from jax.sharding import NamedSharding, PartitionSpec as P  # paxlint: allow[SH001] test pre-places a corrupted state by hand

    minor_i = NamedSharding(jm, P(None, jmesh.INSTANCE_AXIS))
    jstate = jfast.FastState(
        promised=jnp.asarray(glob.promised), max_seen=jnp.asarray(glob.max_seen),
        acc_ballot=jax.device_put(jnp.asarray(acc_ballot), minor_i),
        acc_vid=jax.device_put(jnp.asarray(acc_vid), minor_i),
        learned=jax.device_put(jnp.asarray(glob.learned), minor_i),
    )
    vids = np.arange(n_inst, dtype=np.int32)
    jstate, jn = jsharded.sharded_choose_all(jm, proposer=0, quorum=quorum)(
        jstate, jmesh.shard_instances(jm, jnp.asarray(vids)))

    m = _port_mesh()
    states = interop.sharded_fast_state_from_jax(glob, m)
    states, n = tsharded.sharded_choose_all(m, proposer=0, quorum=quorum)(
        states, tmesh.shard_instances(m, vids))
    assert n == int(jn) == n_inst
    got = _same_fast(states, jstate)
    learned = np.asarray(got.learned).T
    assert (learned[40] == 999).all()
    validate.check_agreement(learned)


def test_uneven_shard_rejected():
    with pytest.raises(ValueError, match="divide evenly"):
        tsharded.init_sharded_state(_port_mesh(), 100, 3)  # 100 % 8 != 0
