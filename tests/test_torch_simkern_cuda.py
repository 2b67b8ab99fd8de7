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


ACK_KINDS = ("random", "window", "none", "no_match")


def ack_operands(seed, a, p, i, kind="window"):
    """Seeded accum_acks operands (numpy, in the kernel's argument order)
    at any (A, P).  ``"window"`` is shaped like a real round: each
    proposer's batches live on one contiguous window with NONE elsewhere,
    acceptors hold or have learned some of them, and some instances are
    already at quorum.  ``"random"`` has rand_state's density, ``"none"``
    no batch anywhere, ``"no_match"`` no acceptor echo (amatch all
    false)."""
    r = np.random.default_rng(seed)
    ballot = ((np.arange(p) + 1) * 65536 + np.arange(p)).astype(np.int32)
    acc_ballot = np.where(r.random((a, i)) < 0.3, ballot[r.integers(0, p, (a, i))], -1)
    acc_vid = np.where(acc_ballot != -1, r.integers(0, 1 << 20, (a, i)), -1)
    learned = np.where(r.random((a, i)) < 0.2, r.integers(0, 1 << 20, (a, i)), -1)
    batch = np.where(r.random((p, i)) < 0.7, r.integers(0, 1 << 20, (p, i)), -1)
    batch = np.where(r.random((p, i)) < 0.2, acc_vid[r.integers(0, a, p)], batch)
    batch = np.where(r.random((p, i)) < 0.1, learned[r.integers(0, a, p)], batch)
    acks = r.random((p, a, i)) < 0.2
    if kind == "window":
        batch = np.full((p, i), -1)
        for pi in range(p):
            w = int(r.integers(1, max(2, i // 4)))
            w0 = int(r.integers(0, i - w + 1))
            batch[pi, w0:w0 + w] = r.integers(0, 1 << 20, w)
        cols = np.arange(i)
        for ai in range(a):
            src = r.integers(0, p, i)
            cb = batch[src, cols]
            pick = (cb != -1) & (r.random(i) < 0.6)
            hold = pick & (r.random(i) < 0.7)
            acc_vid[ai, hold] = cb[hold]
            acc_ballot[ai, hold] = ballot[src[hold]]
            learned[ai, pick & ~hold] = cb[pick & ~hold]
        acks[:, : a // 2 + 1, r.random(i) < 0.3] = True  # already at quorum
    elif kind == "none":
        batch[:] = -1
    amatch = r.random((p, a)) < 0.6
    amatch[:, 0] = True
    if kind == "no_match":
        amatch[:] = False
    return (acks.astype(np.int8), batch.astype(np.int32), acc_ballot.astype(np.int32),
            acc_vid.astype(np.int32), learned.astype(np.int32), ballot, amatch)


STORE_KINDS = ("window", "random", "none", "one_ineligible", "ties")


def store_operands(seed, a, p, i, kind="window"):
    """Seeded store_accepts operands (numpy, in the kernel's argument
    order) at any (A, P).  ``"window"`` is shaped like a real round: each
    proposer's batches live on one contiguous window with NONE elsewhere,
    and some acceptors already hold them (at the proposer's ballot or a
    higher one) or have learned them.  ``"random"`` has rand_state's
    density, ``"none"`` no batch anywhere, ``"one_ineligible"`` is a
    window round with one proposer's ``elig`` row all false.  ``"ties"``
    gives every proposer the same ballot, held by the acceptors at many
    instances, and every proposer ``elig`` everywhere; with an odd seed
    the first proposer's ballot is NONE."""
    r = np.random.default_rng(seed)
    ballot = ((np.arange(p) + 1) * 65536 + np.arange(p)).astype(np.int32)
    ladder = np.concatenate([ballot, ballot + 65536])  # some above every abal
    acc_ballot = np.where(r.random((a, i)) < 0.3, ladder[r.integers(0, 2 * p, (a, i))], -1)
    acc_vid = np.where(acc_ballot != -1, r.integers(0, 1 << 20, (a, i)), -1)
    learned = np.where(r.random((a, i)) < 0.2, r.integers(0, 1 << 20, (a, i)), -1)
    batch = np.where(r.random((p, i)) < 0.7, r.integers(0, 1 << 20, (p, i)), -1)
    elig = r.random((p, a)) < 0.6
    elig[:, 0] = True
    if kind in ("window", "one_ineligible"):
        batch = np.full((p, i), -1)
        for pi in range(p):
            w = int(r.integers(1, max(2, i // 4)))
            w0 = int(r.integers(0, i - w + 1))
            batch[pi, w0:w0 + w] = r.integers(0, 1 << 20, w)
        cols = np.arange(i)
        for ai in range(a):
            src = r.integers(0, p, i)
            cb = batch[src, cols]
            pick = (cb != -1) & (r.random(i) < 0.5)
            hold = pick & (r.random(i) < 0.7)
            acc_vid[ai, hold] = cb[hold]
            acc_ballot[ai, hold] = ladder[src[hold] + p * (r.random(hold.sum()) < 0.3)]
            learned[ai, pick & ~hold] = cb[pick & ~hold]
        if kind == "one_ineligible":
            elig[r.integers(0, p)] = False
    elif kind == "none":
        batch[:] = -1
    elif kind == "ties":
        ballot[:] = ballot[0]
        acc_ballot = np.where(r.random((a, i)) < 0.5, ballot[0], acc_ballot)
        elig[:] = True
        if seed % 2:
            ballot[0] = -1
    return (acc_ballot.astype(np.int32), acc_vid.astype(np.int32), learned.astype(np.int32),
            batch.astype(np.int32), ballot, elig)


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


def _unaligned(t):
    """A contiguous copy of ``t`` whose base is one element past an
    allocation's start (4 bytes off a 16-byte boundary for int32)."""
    big = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = big[1:1 + t.numel()].view(t.shape)
    return view.copy_(t)


# (5, 2) is the kernel's compiled shape; the others run its run-time loop
ACK_SHAPES = [(1, 1), (3, 2), (4, 4), (5, 2), (7, 3), (9, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ACK_KINDS)
@pytest.mark.parametrize("i", [80, 4099, (1 << 20) + 3])
@pytest.mark.parametrize("a,p", ACK_SHAPES)
def test_accum_acks_kernel_equals_plain_in_place(card, a, p, i, kind):
    """Equal to the plain version bit for bit, in the storage it was
    given, changing exactly the ack bytes the plain version changes."""
    ops = _on(card, *ack_operands(i + 17 * a + p, a, p, i, kind))
    want, want_n = tsk.accum_acks_plain(*ops)
    acks = ops[0].clone()
    ptr = acks.data_ptr()
    got, got_n = tsk.accum_acks_cuda(acks, *ops[1:])
    torch.cuda.synchronize()
    assert got is acks and got.data_ptr() == ptr
    assert torch.equal(got, want) and torch.equal(got_n, want_n)
    assert torch.equal(got != ops[0], want != ops[0])


@pytest.mark.cuda
@pytest.mark.parametrize("i", [80, 4099])
@pytest.mark.parametrize("a,p", ACK_SHAPES)
def test_accum_acks_kernel_on_unaligned_rows(card, a, p, i):
    """Operands whose base is off a 16-byte boundary take the scalar
    path and give the same result."""
    ops = _on(card, *ack_operands(i + a, a, p, i, "window"))
    want, want_n = tsk.accum_acks_plain(*ops)
    moved = [_unaligned(x) for x in ops[:5]] + ops[5:]
    assert all(x.data_ptr() % 16 for x in moved[:5])
    got, got_n = tsk.accum_acks_cuda(*moved)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_n, want_n)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", STORE_KINDS)
@pytest.mark.parametrize("i", [80, 4099, (1 << 20) + 3])
@pytest.mark.parametrize("a,p", ACK_SHAPES)
def test_store_accepts_kernel_equals_plain_in_place(card, a, p, i, kind):
    """Equal to the plain version bit for bit, in the storage it was
    given, changing exactly the elements the plain version changes."""
    ops = _on(card, *store_operands(i + 17 * a + p, a, p, i, kind))
    want_b, want_v = tsk.store_accepts_plain(*ops)
    ab, av = ops[0].clone(), ops[1].clone()
    ptrs = (ab.data_ptr(), av.data_ptr())
    got_b, got_v = tsk.store_accepts_cuda(ab, av, *ops[2:])
    torch.cuda.synchronize()
    assert got_b is ab and got_v is av and (ab.data_ptr(), av.data_ptr()) == ptrs
    assert torch.equal(got_b, want_b) and torch.equal(got_v, want_v)
    assert torch.equal(got_b != ops[0], want_b != ops[0])
    assert torch.equal(got_v != ops[1], want_v != ops[1])


@pytest.mark.cuda
@pytest.mark.parametrize("i", [80, 4099])
@pytest.mark.parametrize("a,p", ACK_SHAPES)
def test_store_accepts_kernel_on_unaligned_rows(card, a, p, i):
    """Operands whose base is off a 16-byte boundary take the scalar
    path and give the same result."""
    ops = _on(card, *store_operands(i + a, a, p, i, "window"))
    want = tsk.store_accepts_plain(*ops)
    moved = [_unaligned(x) for x in ops[:4]] + ops[4:]
    assert all(x.data_ptr() % 16 for x in moved[:4])
    got = tsk.store_accepts_cuda(*moved)
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
    with pytest.raises(ValueError, match="bool"):
        tsk.store_accepts_cuda(ab, av, lr, bat, abal, pa.to(torch.int32))
    with pytest.raises(ValueError, match="shape"):
        tsk.store_accepts_cuda(ab, av, lr, bat, abal[:1], pa)
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


LANE_COUNTS = [1, 2, 3, 128]
LANE_SIZES = [56, 64, 80, 4096, 4099]


def lane_operands(make, lanes, a, p, i, frozen=True):
    """Lane-stacked operands (numpy): lane ``l`` is ``make``'s operand set
    of seed ``l`` (kinds cycling through the real-round window, random
    density and no batch), and with ``frozen`` the last lane of several
    has its ``elig``/``amatch`` all false, as a finished lane's are."""
    kinds = ("window", "random", "none")
    per = [list(make(1000 * i + 7 * lane + a, a, p, i, kinds[lane % 3])) for lane in range(lanes)]
    if frozen and lanes > 1:
        per[-1][-1][:] = False
    return [np.stack([ops[k] for ops in per]) for k in range(len(per[0]))]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", LANE_COUNTS)
@pytest.mark.parametrize("i", LANE_SIZES)
@pytest.mark.parametrize("a,p", [(5, 2), (3, 2)])
def test_lane_kernels_equal_plain_in_place(card, lanes, i, a, p):
    """One launch over every lane equals the plain version on the stack,
    bit for bit and in place; a frozen lane (all-false elig / amatch)
    keeps its acceptor arrays and ack cube."""
    ops = _on(card, *lane_operands(store_operands, lanes, a, p, i))
    want = tsk.store_accepts_plain(*ops)
    ab, av = ops[0].clone(), ops[1].clone()
    before = tsk.LAUNCHES["store_accepts"]
    got = tsk.store_accepts_cuda(ab, av, *ops[2:])
    torch.cuda.synchronize()
    assert tsk.LAUNCHES["store_accepts"] == before + 1
    assert got[0] is ab and got[1] is av
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if lanes > 1:
        assert torch.equal(ab[-1], ops[0][-1]) and torch.equal(av[-1], ops[1][-1])

    ops = _on(card, *lane_operands(ack_operands, lanes, a, p, i))
    want, want_n = tsk.accum_acks_plain(*ops)
    acks = ops[0].clone()
    got, got_n = tsk.accum_acks_cuda(acks, *ops[1:])
    torch.cuda.synchronize()
    assert got is acks and got_n.shape == (lanes, p, i)
    assert torch.equal(got, want) and torch.equal(got_n, want_n)
    if lanes > 1:
        assert torch.equal(acks[-1], ops[0][-1])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 3])
@pytest.mark.parametrize("i", [56, 64])
def test_lane_kernels_on_unaligned_rows(card, lanes, i):
    """Lane-stacked operands whose base is off a 16-byte boundary take
    the scalar path for every lane and give the same result."""
    ops = _on(card, *lane_operands(store_operands, lanes, 5, 2, i))
    want = tsk.store_accepts_plain(*ops)
    moved = [_unaligned(x) for x in ops[:4]] + ops[4:]
    got = tsk.store_accepts_cuda(*moved)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ops = _on(card, *lane_operands(ack_operands, lanes, 5, 2, i))
    want = tsk.accum_acks_plain(*ops)
    moved = [_unaligned(x) for x in ops[:5]] + ops[5:]
    got = tsk.accum_acks_cuda(*moved)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_lane_wrappers_refuse_mismatched_lanes(card):
    ops = _on(card, *lane_operands(store_operands, 3, 5, 2, 64))
    with pytest.raises(ValueError, match="shape"):
        tsk.store_accepts_cuda(*ops[:4], ops[4][:2], ops[5])
    ops = _on(card, *lane_operands(ack_operands, 3, 5, 2, 64))
    with pytest.raises(ValueError, match="shape"):
        tsk.accum_acks_cuda(*ops[:6], ops[6][0])


@pytest.mark.cuda
def test_fleet_on_card_equals_cpu(card):
    """A fleet whose lanes finish at different rounds: on the card, with
    the lane-batched kernels, every lane's final state equals the CPU
    dispatch's, and both kernels launched."""
    from tpu_paxos_torch.core import faults as tflt
    from tpu_paxos_torch.fleet import runner as trun
    from tpu_paxos_torch.harness import stress as tstress

    wl, gates, _ = tstress._workload(2, np.random.default_rng(0))
    cfg = tcfg.SimConfig(n_nodes=5, n_instances=56, proposers=(0, 1), max_rounds=2000,
                         faults=tcfg.FaultConfig(max_delay=8))
    scheds = [tstress.SCHED_PARTITION_FLAP, None, tstress.SCHED_WAN_GRAY,
              tflt.FaultSchedule((tflt.partition(28, 63, (1, 2, 4, 0), (3,)), tflt.crash(63, 0, 1)))]
    knobs = [tcfg.FaultConfig(drop_rate=300, dup_rate=500, max_delay=2),
             tcfg.FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2, crash_rate=20_000),
             tcfg.FaultConfig(max_delay=8, edges=tstress.WAN_MIXES[0][1]["edges"]),
             tcfg.FaultConfig()]
    want = trun.FleetRunner(cfg, wl, gates, device="cpu").run(range(4), scheds, knobs=knobs)
    tsk.reset_counts()
    got = trun.FleetRunner(cfg, wl, gates, device=card).run(range(4), scheds, knobs=knobs)
    assert min(tsk.LAUNCHES.values()) >= 1
    assert len(set(want.verdict.rounds.tolist())) == 4
    for f in want.verdict._fields:
        np.testing.assert_array_equal(getattr(got.verdict, f), getattr(want.verdict, f), err_msg=f)
    assert_same_state(interop.sim_state_to_numpy(got.final), interop.sim_state_to_numpy(want.final))
