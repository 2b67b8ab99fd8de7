"""The port's 2-D ``("dcn", "i")`` mesh (hosts outer, a host's chips
inner) against the JAX package's, on the CPU under the conftest's 8
virtual JAX devices: the same axes, shapes and clamp, and both sharded
engines bit-identical to the 1-D mesh and to JAX's (every collective
reduces over the whole axis tuple, and a rank is the row-major linear
index).  Mirrors ``tests/test_multihost.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_paxos.config import FaultConfig as JF
from tpu_paxos.config import SimConfig as JC
from tpu_paxos.core import fast as jfast
from tpu_paxos.parallel import mesh as jmesh
from tpu_paxos.parallel import sharded as jsharded
from tpu_paxos.parallel import sharded_sim as jss
from tpu_paxos_torch import config as tc
from tpu_paxos_torch import interop
from tpu_paxos_torch.core import fast as tfast
from tpu_paxos_torch.parallel import mesh as tmesh
from tpu_paxos_torch.parallel import sharded as tsharded
from tpu_paxos_torch.parallel import sharded_sim as tss


def _mesh_2d(**kw):
    return tmesh.make_instance_mesh(8, dcn_hosts=2, device="cpu", **kw)


def test_mesh_axes_shapes():
    m2 = _mesh_2d()
    j2 = jmesh.make_instance_mesh(dcn_hosts=2)
    assert m2.axis_names == tuple(j2.axis_names) == ("dcn", "i")
    assert m2.shape == j2.devices.shape == (2, 4)
    assert tmesh.instance_axes(m2) == jmesh.instance_axes(j2) == ("dcn", "i")
    m1 = tmesh.make_instance_mesh(8, device="cpu")
    assert tmesh.instance_axes(m1) == jmesh.instance_axes(jmesh.make_instance_mesh()) == ("i",)
    # the host axis clamps to its gcd with the rank count, as JAX's does
    m3 = tmesh.make_instance_mesh(6, dcn_hosts=4, device="cpu")
    assert m3.shape == jmesh.make_instance_mesh(6, dcn_hosts=4).devices.shape == (2, 3)
    # the rank is the row-major linear index over (dcn, i)
    assert m2.run(lambda comm: comm.rank) == list(range(8))


def test_fast_path_2d_mesh_matches_unsharded():
    i, n = 1 << 12, 5
    st_ref, n_ref = jfast.choose_all_jit(jfast.init_state(i, n), jnp.arange(i, dtype=jnp.int32),
                                         proposer=0, quorum=3)
    j2 = jmesh.make_instance_mesh(dcn_hosts=2)
    jst, jn = jsharded.sharded_choose_all(j2, proposer=0, quorum=3)(
        jsharded.init_sharded_state(j2, i, n), jmesh.shard_instances(j2, jnp.arange(i, dtype=jnp.int32)))

    m2 = _mesh_2d()
    states, n2 = tsharded.sharded_choose_all(m2, proposer=0, quorum=3)(
        tsharded.init_sharded_state(m2, i, n), tmesh.shard_instances(m2, np.arange(i, dtype=np.int32)))
    got = interop.sharded_fast_state_to_numpy(states)
    one, n1 = tfast.choose_all(tfast.init_state(i, n, device="cpu"),
                               torch.arange(i, dtype=torch.int32), proposer=0, quorum=3)
    assert int(n_ref) == int(jn) == n2 == int(n1) == i
    for name in st_ref._fields:
        a = np.asarray(getattr(st_ref, name))
        assert np.array_equal(np.asarray(getattr(got, name)), a), f"{name} diverges on the dcn x ici mesh"
        assert np.array_equal(np.asarray(getattr(jst, name)), a), name
        assert np.array_equal(getattr(one, name).numpy(), a), name


@pytest.mark.slow
def test_sim_engine_2d_mesh_matches_1d():
    kw = dict(n_nodes=5, n_instances=64, proposers=(0, 1), seed=7, max_rounds=4000)
    faults = dict(drop_rate=500, dup_rate=1000, max_delay=2)
    tcfg = tc.SimConfig(**kw, faults=tc.FaultConfig(**faults))
    r1 = tss.run_sharded(tcfg, tmesh.make_instance_mesh(8, device="cpu"))
    r2 = tss.run_sharded(tcfg, _mesh_2d())
    jr = jss.run_sharded(JC(**kw, faults=JF(**faults)), jmesh.make_instance_mesh(dcn_hosts=2))
    assert r1.done and r2.done
    # same seed, same shard count (8 either way, row-major): bit-identical
    for r in (r2, jr):
        assert r.rounds == r1.rounds
        for f in ("chosen_vid", "chosen_round", "chosen_ballot", "learned", "crashed", "msgs"):
            assert (np.asarray(getattr(r, f)) == getattr(r1, f)).all(), f
