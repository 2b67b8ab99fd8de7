"""The port's network layer (tpu_paxos_torch/core/net.py) against
tpu_paxos/core/net.py: copy plans, calendar writes and knob encoding
must be equal exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_paxos import config as jcfg
from tpu_paxos.core import net as jnet
from tpu_paxos.utils import prng as jprng
from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch.core import net as tnet
from tpu_paxos_torch.utils import prng as tprng

FAULTS = [
    dict(),
    dict(drop_rate=500),
    dict(drop_rate=500, dup_rate=1000, max_delay=2),
    dict(dup_rate=3000, min_delay=1, max_delay=4),
    dict(drop_rate=10_000, dup_rate=10_000, max_delay=1),
]


def _faults(kw):
    return jcfg.FaultConfig(**kw), tcfg.FaultConfig(**kw)


@pytest.mark.parametrize("kw", FAULTS)
@pytest.mark.parametrize("shape", [(2, 5), (5, 2), (3, 3)])
@pytest.mark.parametrize("knobs", [False, True])
def test_copy_plan_matches_jax(kw, shape, knobs):
    jfc, tfc = _faults(kw)
    jk = jprng.stream(jprng.root_key(3), jprng.STREAM_NET_DROP, 7)
    tk = tprng.stream(tprng.root_key(3), tprng.STREAM_NET_DROP, 7)
    jkn = jnet.knobs_from_faults(jfc) if knobs else None
    tkn = tnet.knobs_from_faults(tfc) if knobs else None
    ja, jd = jnet.copy_plan(jk, shape, jfc, knobs=jkn)
    ta, td = tnet.copy_plan(tk, shape, tfc, knobs=tkn)
    assert ta.dtype == torch.bool and td.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("kw", FAULTS[1:3])
def test_knob_path_equals_static_path_at_zero(kw):
    """The masked knobs form samples bit-identically to the static one
    (exact at zero rates and a [0, 0] span)."""
    _, tfc = _faults(kw)
    tk = tprng.root_key(9)
    sa, sd = tnet.copy_plan(tk, (2, 5), tfc)
    ka, kd = tnet.copy_plan(tk, (2, 5), tfc, knobs=tnet.knobs_from_faults(tfc))
    assert torch.equal(sa, ka) and torch.equal(sd, kd)


def test_copy_plans_batch_equals_single_plans():
    _, tfc = _faults(FAULTS[2])
    keys = tprng.split(tprng.root_key(1), 4)
    sites = [(k, shape, None, None) for k, shape in zip(keys, [(2, 5), (5, 2), (5, 2), (2, 5)])]
    for (key, shape, _, _), (al, dl) in zip(sites, tnet.copy_plans(sites, tfc)):
        a1, d1 = tnet.copy_plan(key, shape, tfc)
        assert torch.equal(al, a1) and torch.equal(dl, d1)


@pytest.mark.parametrize("kw", FAULTS)
def test_knobs_from_faults_matches_jax(kw):
    jfc, tfc = _faults(kw)
    jk = jnet.knobs_from_faults(jfc)
    tk = tnet.knobs_from_faults(tfc)
    assert tuple(int(x) for x in jk) == tuple(tk)
    assert tk._fields == jk._fields


def test_knobs_from_faults_rejects_edges():
    """An edges-bearing config no longer raises: it encodes to the same
    matrix-form knobs as the JAX package's, and the static scalar plan
    path rejects it as JAX's does."""
    edges = dict(drop_rate=((0, 5), (7, 0)), dup_rate=((0, 0), (1, 0)),
                 min_delay=((0, 1), (0, 0)), max_delay=((0, 1), (1, 0)))
    jfc = jcfg.FaultConfig(max_delay=1, edges=jcfg.EdgeFaultConfig(**edges))
    tfc = tcfg.FaultConfig(max_delay=1, edges=tcfg.EdgeFaultConfig(**edges))
    jk, tk = jnet.knobs_from_faults(jfc), tnet.knobs_from_faults(tfc)
    for name in jk._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tk, name)), np.asarray(getattr(jk, name)))
    with pytest.raises(ValueError, match="needs knobs="):
        tnet.copy_plan(tprng.root_key(0), (2, 2), tfc)


def test_init_and_clear_slot_match_jax():
    jb = jnet.init_buffers(4, 2, 5)
    tb = tnet.init_buffers(4, 2, 5, device="cpu")
    rng = np.random.default_rng(2)
    jb = jb._replace(prep_req=jnp.asarray(rng.integers(-1, 9, (4, 2, 5)), jnp.int32),
                     com_rep=jnp.asarray(rng.random((4, 5, 2)) < 0.5))
    tb = tb._replace(prep_req=torch.from_numpy(np.array(jb.prep_req)),
                     com_rep=torch.from_numpy(np.array(jb.com_rep)))
    for slot in range(4):
        jc = jnet.clear_slot(jb, slot)
        tc = tnet.clear_slot(tb, slot)
        for name in jnet.NetBuffers._fields:
            np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("t", [0, 5])
def test_write_ballot_and_flag_match_jax(seed, t):
    rng = np.random.default_rng(seed)
    s, p, a = 4, 2, 5
    buf = rng.integers(-1, 1 << 18, (s, p, a)).astype(np.int32)
    flag = rng.random((s, p, a)) < 0.3
    alive = rng.random((4, p, a)) < 0.6
    delay = rng.integers(0, 3, (4, p, a)).astype(np.int32)
    value = rng.integers(1, 1 << 18, (p, 1)).astype(np.int32)
    send = rng.random((p, a)) < 0.7
    jw = jnet.write_ballot(jnp.asarray(buf), t, jnp.asarray(alive), jnp.asarray(delay),
                           jnp.asarray(value), jnp.asarray(send))
    tw = tnet.write_ballot(torch.from_numpy(buf), t, torch.from_numpy(alive),
                           torch.from_numpy(delay), torch.from_numpy(value), torch.from_numpy(send))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    jf = jnet.write_flag(jnp.asarray(flag), t, jnp.asarray(alive), jnp.asarray(delay),
                         jnp.asarray(send))
    tf = tnet.write_flag(torch.from_numpy(flag), t, torch.from_numpy(alive),
                         torch.from_numpy(delay), torch.from_numpy(send))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_port_fault_config_is_field_for_field_the_reference():
    for cls in ("FaultConfig", "ProtocolConfig", "SimConfig", "EdgeFaultConfig"):
        jf = [f.name for f in dataclasses.fields(getattr(jcfg, cls))]
        tf = [f.name for f in dataclasses.fields(getattr(tcfg, cls))]
        assert jf == tf
    assert tcfg.PROTOCOL_SPANS == jcfg.PROTOCOL_SPANS
    c = tcfg.SimConfig(n_nodes=5, proposers=(1, 0, 1))
    assert c.proposers == (0, 1) and c.quorum == 3 and c.round_budget == 10_000
