"""The port's simkern (tpu_paxos_torch/core/simkern.py): the plain
PyTorch versions equal the JAX package's Pallas kernels run in
interpret mode (one TILE, as tests/test_simkern.py runs them); the CUDA
wrappers refuse CPU tensors.  The kernels themselves are held against
the plain versions on a card by tests/test_torch_simkern_cuda.py."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_simkern_cuda import STORE_KINDS, ack_operands, rand_state, store_operands
from tpu_paxos.core import simkern as jsk
from tpu_paxos_torch.core import simkern as tsk
from tpu_paxos_torch.utils import kbuild

I = jsk.TILE  # one whole tile


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("kind", STORE_KINDS)
@pytest.mark.parametrize("a", [3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_store_accepts_plain_matches_pallas_interpret(a, seed, kind):
    """On every kind of operand set the card tests use (a real round's
    windows, random density, no batch, an ineligible proposer, ballot
    ties and a NONE ballot)."""
    ab, av, lr, bat, abal, elig = store_operands(seed, a, 2, I, kind)
    want_b, want_v = jsk.store_accepts(
        jnp.asarray(ab), jnp.asarray(av), jnp.asarray(lr), jnp.asarray(bat),
        jnp.asarray(abal), jnp.asarray(elig), interpret=True,
    )
    got_b, got_v = tsk.store_accepts_plain(*_t(ab, av, lr, bat, abal, elig))
    assert got_b.dtype == got_v.dtype == torch.int32
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert torch.equal(got_b, torch.from_numpy(ab)) == (kind == "none")  # only "none" stores nothing


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


@pytest.mark.parametrize("a", [3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_accum_acks_plain_matches_pallas_interpret_on_round_operands(a, seed):
    """Operands shaped like a real round: NONE outside one live window
    per proposer, acceptors holding or having learned some batches, some
    instances already at quorum."""
    ops = ack_operands(seed, a, 2, I, "window")
    acks, batch = ops[0], ops[1]
    assert (batch == -1).mean() > 0.5 and (acks.sum(axis=1) >= a // 2 + 1).any()
    want, want_n = jsk.accum_acks(*[jnp.asarray(x) for x in ops], interpret=True)
    got, got_n = tsk.accum_acks_plain(*_t(*ops))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert not np.array_equal(np.asarray(want), acks)  # the window folds acks


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


def _dense_ack_operands(a, p, i):
    """Every (p, a, i) newly acked: one batch per instance, learned by
    every acceptor, matched by every proposer; the cube starts empty."""
    cb = torch.arange(i, dtype=torch.int32).expand(p, i).contiguous()
    none = torch.full((a, i), -1, dtype=torch.int32)
    return (torch.zeros((p, a, i), dtype=torch.int8), cb, none, none.clone(),
            cb[:1].expand(a, i).contiguous(), torch.arange(p, dtype=torch.int32),
            torch.ones((p, a), dtype=torch.bool))


@pytest.mark.parametrize("a,p", [(5, 2), (4, 4), (3, 1)])
def test_bytes_needed_counts_sectors(a, p):
    """bytes_needed on hand-made operands with a known sector count."""
    i = 4096
    scal = 4 * p + p * a
    ops = list(_dense_ack_operands(a, p, i))
    # fully dense: every byte read and written, as bytes_per_launch counts
    assert tsk.bytes_needed("accum_acks", *ops) == tsk.bytes_per_launch("accum_acks", a, p, i)
    # no batch anywhere: cur_batch and the cube read, n_ack written
    ops[1] = torch.full((p, i), -1, dtype=torch.int32)
    floor = i * (4 * p + p * a + 4 * p) + scal
    assert tsk.bytes_needed("accum_acks", *ops) == floor
    # one live instance (proposer 0, instance 9): one 32-byte sector of
    # each acceptor row, and one of each of its acked cube rows
    ops[1][0, 9] = 9
    assert tsk.bytes_needed("accum_acks", *ops) == floor + 3 * a * 32 + a * 32
    # already acked at two acceptors: only the others' state is read
    ops[0][0, :2, 9] = 1
    assert tsk.bytes_needed("accum_acks", *ops) == floor + 3 * (a - 2) * 32 + (a - 2) * 32
    # acked at every acceptor: no acceptor state can change it
    ops[0][0, :, 9] = 1
    assert tsk.bytes_needed("accum_acks", *ops) == floor
    ops[0][0, :, 9] = 0
    # matched by no acceptor: nothing more than no batch at all
    ops[6] = torch.zeros((p, a), dtype=torch.bool)
    assert tsk.bytes_needed("accum_acks", *ops) == floor


def test_ab_script_counts_acceptor_sectors_by_both_rules():
    """scripts/torch_simkern_ab.py.  accum_acks: the ``unacked`` rule
    (bytes_needed's) never needs more acceptor sectors than the ``live``
    rule, equals it on an empty cube and needs none on a full one.
    store_accepts: the ``unlearned`` rule (bytes_needed's) never needs
    more than the ``needed`` rule, equals it where nothing is learned and
    needs only ``learned``'s sectors where everything is.  The script
    tells the older packed-scalar store interface from the tree's, and
    without CUDA it exits 1."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "torch_simkern_ab.py")
    spec = importlib.util.spec_from_file_location("torch_simkern_ab", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    ops = _t(*ack_operands(0, 5, 2, 4096, "window"))
    live, unacked = ab.acceptor_sectors("accum_acks", ops)
    assert 0 < unacked <= live
    ops[0].zero_()
    assert ab.acceptor_sectors("accum_acks", ops) == (live, live)
    ops[0].fill_(1)
    assert ab.acceptor_sectors("accum_acks", ops) == (live, 0)

    ops = _t(*store_operands(0, 5, 2, 4096, "window"))
    needed, unlearned = ab.acceptor_sectors("store_accepts", ops)
    assert 0 < unlearned < needed
    learned = ops[2]
    learned.fill_(-1)
    assert ab.acceptor_sectors("store_accepts", ops) == (needed, needed)
    learned.fill_(7)
    assert ab.acceptor_sectors("store_accepts", ops) == (needed, needed // 2)
    ops[5].zero_()  # no eligible proposer: no acceptor row
    assert ab.acceptor_sectors("store_accepts", ops) == (0, 0)

    with open(tsk.kbuild.source(tsk.NAME)) as f:
        tree = f.read()
    assert not ab.packed_store_scalars(tree) and ab.lane_interface(tree)
    older = ("int simkern_store_accepts(void* acc_ballot, void* acc_vid, const void* learned,\n"
             "    const void* abat, const void* scal, int A, int P, long long I, void* stream) {")
    assert ab.packed_store_scalars(older) and not ab.lane_interface(older)
    assert ab.main([]) == 1
    assert ab.main(["--kernel", "store_accepts"]) == 1


def test_bytes_needed_store_accepts():
    a, p, i = 5, 2, 4096
    none = torch.full((a, i), -1, dtype=torch.int32)
    abat = torch.full((p, i), -1, dtype=torch.int32)
    abal = torch.tensor([65536, 131073], dtype=torch.int32)
    elig = torch.ones((p, a), dtype=torch.bool)
    ops = [none, none.clone(), none.clone(), abat, abal, elig]
    floor = 4 * p * i + 4 * p + p * a  # abat read, nothing stored
    assert tsk.bytes_needed("store_accepts", *ops) == floor
    abat[1, 100] = 7  # one store per acceptor: learned, acc_ballot in, both out
    assert tsk.bytes_needed("store_accepts", *ops) == floor + 4 * a * 32
    abat[1] = torch.arange(i, dtype=torch.int32)  # dense
    assert tsk.bytes_needed("store_accepts", *ops) == tsk.bytes_per_launch("store_accepts", a, p, i)
    # only proposer 0 eligible, its batch at one instance: only its abat
    # row is read, and one sector of each acceptor array
    abat[0, :] = -1
    abat[0, 100] = 8
    elig[1] = False
    one_row = 4 * i + 4 * p + p * a
    assert tsk.bytes_needed("store_accepts", *ops) == one_row + 4 * a * 32
    elig[0, 1:] = False  # and only at acceptor 0
    assert tsk.bytes_needed("store_accepts", *ops) == one_row + 4 * 32
    elig[:] = False  # nobody eligible: not even abat is needed
    assert tsk.bytes_needed("store_accepts", *ops) == 4 * p + p * a


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
