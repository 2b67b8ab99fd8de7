"""The port's CUDA kernels on a card: each equals its plain PyTorch
version, the wrappers refuse what the kernels do not take, and the
general engine on the card equals the same run on the CPU, round for
round, including what each round does to the state it is given.

These tests need a CUDA card and skip without one.  The file imports
neither ``jax`` nor ``tpu_paxos`` (the card's machine has neither), so
run it there without the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_simkern_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu_paxos_torch import config as tcfg
from tpu_paxos_torch import interop
from tpu_paxos_torch.core import sim as tsim
from tpu_paxos_torch.core import simkern as tsk
from tpu_paxos_torch.harness import reference_runner as tref
from tpu_paxos_torch.utils import prng as tprng

P = 2


def rand_state(seed, a, i):
    """Seeded simkern operands (numpy) with realistic NONE density,
    ballot ties against the proposers' ballots, and batches that match
    the accepted or learned values."""
    r = np.random.default_rng(seed)
    ballots = np.asarray([65536, 65537, 131072, 131073], np.int32)
    acc_ballot = np.where(r.random((a, i)) < 0.3, ballots[r.integers(0, 4, (a, i))], -1).astype(np.int32)
    acc_vid = np.where(acc_ballot != -1, r.integers(0, 1 << 20, (a, i)), -1).astype(np.int32)
    learned = np.where(r.random((a, i)) < 0.2, r.integers(0, 1 << 20, (a, i)), -1).astype(np.int32)
    batch = np.where(r.random((P, i)) < 0.7, r.integers(0, 1 << 20, (P, i)), -1).astype(np.int32)
    batch = np.where(r.random((P, i)) < 0.2, acc_vid[:P], batch).astype(np.int32)
    batch = np.where(r.random((P, i)) < 0.1, learned[:P], batch).astype(np.int32)
    abal = ballots[[1, 2]].copy()
    pa = r.random((P, a)) < 0.6
    acks = (r.random((P, a, i)) < 0.2).astype(np.int8)
    return acc_ballot, acc_vid, learned, batch, abal, pa, acks


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the simkern kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, *xs):
    return [torch.from_numpy(np.array(x)).to(dev) for x in xs]


@pytest.mark.cuda
@pytest.mark.parametrize("i", [80, 4099, 1 << 20])
def test_cuda_kernels_equal_plain_on_card(card, i):
    ab, av, lr, bat, abal, pa, acks = _on(card, *rand_state(i, 5, i))
    want = tsk.store_accepts_plain(ab, av, lr, bat, abal, pa)
    got = tsk.store_accepts_cuda(ab.clone(), av.clone(), lr, bat, abal, pa)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    want = tsk.accum_acks_plain(acks, bat, ab, av, lr, abal, pa)
    got = tsk.accum_acks_cuda(acks.clone(), bat, ab, av, lr, abal, pa)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_operands(card):
    ab, av, lr, bat, abal, pa, acks = _on(card, *rand_state(1, 3, 256))
    before = dict(tsk.LAUNCHES)
    with pytest.raises(ValueError, match="int32"):
        tsk.store_accepts_cuda(ab, av, lr.to(torch.int64), bat, abal, pa)
    with pytest.raises(ValueError, match="shape"):
        tsk.store_accepts_cuda(ab, av, lr, bat[:, :128], abal, pa)
    with pytest.raises(ValueError, match="contiguous"):
        tsk.accum_acks_cuda(acks, bat.T.contiguous().T, ab, av, lr, abal, pa)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.accum_acks_cuda(acks, bat.cpu(), ab, av, lr, abal, pa)
    assert tsk.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [False, True])
def test_sim_run_on_card_equals_cpu(card, gated):
    faults = tcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2)
    if gated:
        wl, gates, _ = tref.equivalent_workload(4, 4, 10)
        cfg = tcfg.SimConfig(n_nodes=4, n_instances=80, proposers=(0, 1, 2, 3), faults=faults)
    else:
        wl = gates = None
        cfg = tcfg.SimConfig(n_nodes=5, n_instances=4099, proposers=(0, 1), faults=faults)
    want = tsim.run(cfg, wl, gates, device="cpu")
    tsk.reset_counts()
    got = tsim.run(cfg, wl, gates, device=card)
    assert min(tsk.LAUNCHES.values()) >= 1
    assert (got.rounds, got.done) == (want.rounds, want.done)
    for f in ("learned", "chosen_vid", "chosen_round", "chosen_ballot", "crashed", "msgs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def assert_same_state(got, want, path="state"):
    """Two state trees of numpy leaves are equal, leaf by leaf."""
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    for name in want._fields:
        assert_same_state(getattr(got, name), getattr(want, name), f"{path}.{name}")


@pytest.mark.cuda
def test_round_consumes_its_state_alike_on_card_and_cpu(card):
    """Each round starts on both devices from one numpy copy of the
    state; the outputs must be equal, and so must the states the rounds
    were given (the kernels update theirs in place, and the CPU's plain
    versions must do the same to theirs)."""
    cfg = tcfg.SimConfig(
        n_nodes=5, n_instances=4099, proposers=(0, 1), seed=1,
        faults=tcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2, crash_rate=2000),
    )
    pend, gate, tail, c = tsim.prepare_queues(cfg, tsim.default_workload(cfg), None)
    root = tprng.root_key(cfg.seed)
    state = interop.sim_state_to_numpy(tsim.init_state(cfg, pend, gate, tail, root, device="cpu"))
    rf_cpu = tsim.build_engine(cfg, c, device="cpu")
    rf_card = tsim.build_engine(cfg, c, device=card)
    tsk.reset_counts()
    stored = 0
    while not bool(state.done) and int(state.t) < cfg.round_budget:
        st_cpu = interop.sim_state_from_jax(state, device="cpu")
        st_card = interop.sim_state_from_jax(state, device=card)
        out = interop.sim_state_to_numpy(rf_cpu(root, st_cpu))
        assert_same_state(interop.sim_state_to_numpy(rf_card(root, st_card)), out,
                            f"round {int(state.t)} out")
        given = interop.sim_state_to_numpy(st_cpu)
        assert_same_state(interop.sim_state_to_numpy(st_card), given,
                            f"round {int(state.t)} given")
        stored += not np.array_equal(given.acc.acc_ballot, state.acc.acc_ballot)
        state = out
    assert state.done and stored
    assert min(tsk.LAUNCHES.values()) >= 1
