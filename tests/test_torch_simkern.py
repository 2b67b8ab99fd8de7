"""The port's simkern (tpu_paxos_torch/core/simkern.py): the plain
PyTorch versions equal the JAX package's Pallas kernels run in
interpret mode (one TILE, as tests/test_simkern.py runs them); the CUDA
wrappers refuse CPU tensors.  The kernels themselves are held against
the plain versions on a card by tests/test_torch_simkern_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_simkern_cuda import rand_state
from tpu_paxos.core import simkern as jsk
from tpu_paxos_torch.core import simkern as tsk
from tpu_paxos_torch.utils import kbuild

I = jsk.TILE  # one whole tile


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("a", [3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_store_accepts_plain_matches_pallas_interpret(a, seed):
    ab, av, lr, bat, abal, elig, _ = rand_state(seed, a, I)
    want_b, want_v = jsk.store_accepts(
        jnp.asarray(ab), jnp.asarray(av), jnp.asarray(lr), jnp.asarray(bat),
        jnp.asarray(abal), jnp.asarray(elig), interpret=True,
    )
    got_b, got_v = tsk.store_accepts_plain(*_t(ab, av, lr, bat, abal, elig))
    assert got_b.dtype == got_v.dtype == torch.int32
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("a", [3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_accum_acks_plain_matches_pallas_interpret(a, seed):
    ab, av, lr, bat, ballot, amatch, acks = rand_state(seed, a, I)
    want, want_n = jsk.accum_acks(
        jnp.asarray(acks), jnp.asarray(bat), jnp.asarray(ab), jnp.asarray(av),
        jnp.asarray(lr), jnp.asarray(ballot), jnp.asarray(amatch), interpret=True,
    )
    got, got_n = tsk.accum_acks_plain(*_t(acks, bat, ab, av, lr, ballot, amatch))
    assert got.dtype == torch.int8 and got_n.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def test_cuda_wrappers_refuse_cpu_tensors():
    ab, av, lr, bat, abal, pa, acks = _t(*rand_state(0, 3, 64))
    before = dict(tsk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.store_accepts_cuda(ab, av, lr, bat, abal, pa)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.accum_acks_cuda(acks, bat, ab, av, lr, abal, pa)
    assert tsk.LAUNCHES == before


def test_dispatch_takes_the_plain_version_on_cpu_tensors():
    """The dispatch runs the plain version on CPU tensors and, as the
    kernels do, updates the in-place operands and returns them."""
    ab, av, lr, bat, abal, pa, acks = _t(*rand_state(2, 5, 100))
    before = dict(tsk.LAUNCHES)
    want = tsk.store_accepts_plain(ab, av, lr, bat, abal, pa)
    assert not torch.equal(want[0], ab)  # the store changes something
    got = tsk.store_accepts(ab, av, lr, bat, abal, pa)
    assert got[0] is ab and got[1] is av
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    want = tsk.accum_acks_plain(acks, bat, ab, av, lr, abal, pa)
    assert not torch.equal(want[0], acks)  # the fold adds acks
    got = tsk.accum_acks(acks, bat, ab, av, lr, abal, pa)
    assert got[0] is acks
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tsk.LAUNCHES == before


@pytest.mark.parametrize("kernel,per_instance", [("store_accepts", 88), ("accum_acks", 96)])
def test_bytes_per_launch(kernel, per_instance):
    i = 1 << 23
    extra = tsk.bytes_per_launch(kernel, 5, 2, i) - per_instance * i
    assert 0 <= extra < 64  # the [P] and [P, A] scalars


def test_build_targets_hopper_from_the_package_source():
    """Both kernel sources build through utils/kbuild.py, each keyed by
    its own sha256."""
    for name in (tsk.NAME, "fastwin"):
        src = kbuild.source(name)
        cmd = kbuild.build_command("nvcc", name, "/out.so")
        assert "-arch=sm_90a" in cmd and cmd[-1] == src
        assert src.endswith(f"tpu_paxos_torch/csrc/{name}.cu")
        assert kbuild.library_path(name).startswith(kbuild.BUILD_DIR)
    assert kbuild.library_path("simkern") != kbuild.library_path("fastwin")
    assert kbuild.BUILD_DIR.endswith("build/tpu_paxos_torch")
