"""The port's fast path (tpu_paxos_torch/core/fast.py) against
tpu_paxos/core/fast.py on the CPU: every phase function and the whole
pipeline, from the same seeded states, must give equal arrays and
scalars exactly (all protocol state is int32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_paxos.core import fast as jfast
from tpu_paxos_torch import interop
from tpu_paxos_torch.core import fast as tfast

NODES = [1, 3, 5, 7]
I = 97  # odd on purpose: nothing in the fast path tiles


def _state(a, seed, preaccepted=True, promised=None):
    """A seeded numpy FastState: some instances pre-accepted at a few
    ballots (ties across acceptors carry the same vid), the rest empty."""
    r = np.random.default_rng(seed)
    ballots = np.asarray([(1 << 16) | 0, (2 << 16) | 1, (3 << 16) | 2], np.int32)
    vid_of = r.integers(0, 1 << 20, (len(ballots), I)).astype(np.int32)
    pick = r.integers(0, len(ballots), (a, I))
    has = (r.random((a, I)) < 0.4) & preaccepted
    acc_ballot = np.where(has, ballots[pick], -1).astype(np.int32)
    acc_vid = np.where(has, vid_of[pick, np.arange(I)[None, :]], -1).astype(np.int32)
    learned = np.full((a, I), -1, np.int32)
    prom = np.zeros(a, np.int32) if promised is None else np.asarray(promised, np.int32)
    # max_seen leaves the promises out: those acceptors promised a
    # ballot this proposer has never seen (as in tests/test_fastwin.py)
    max_seen = np.maximum(0, acc_ballot.max(axis=1)).astype(np.int32)
    return jfast.FastState(prom, max_seen, acc_ballot, acc_vid, learned)


def _pair(np_state):
    return (
        jfast.FastState(*[jnp.asarray(x) for x in np_state]),
        interop.fast_state_from_jax(np_state, device="cpu"),
    )


def _eq(got, want, what):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_state(ts, js):
    for name in jfast.FastState._fields:
        _eq(getattr(ts, name), getattr(js, name), name)


def _no_quorum(a):
    """A majority already promised a ballot above any this proposer
    will try."""
    high = 10 << 16
    maj = a // 2 + 1
    return [high] * maj + [0] * (a - maj)


@pytest.mark.parametrize("a", NODES)
@pytest.mark.parametrize("blocked", [False, True])
def test_phase1_prepare_equals_jax(a, blocked):
    np_state = _state(a, seed=a, promised=_no_quorum(a) if blocked else None)
    js, ts = _pair(np_state)
    ballot = (4 << 16) | 1
    jout = jfast.phase1_prepare(js, jnp.int32(ballot), a // 2 + 1)
    tout = tfast.phase1_prepare(ts, ballot, a // 2 + 1)
    _same_state(tout[0], jout[0])
    for k, what in ((1, "prepared"), (2, "adopted_ballot"), (3, "adopted_vid")):
        _eq(tout[k], jout[k], what)
    assert bool(tout[1]) != blocked
    if not blocked:
        assert (tout[3].numpy() != -1).any()  # something was adopted


@pytest.mark.parametrize("a", NODES)
@pytest.mark.parametrize("ballot", [(4 << 16) | 1, 0])
def test_phase2_and_phase3_equal_jax(a, ballot):
    np_state = _state(a, seed=10 + a, promised=[(2 << 16)] * a)
    js, ts = _pair(np_state)
    r = np.random.default_rng(a)
    vids = np.where(r.random(I) < 0.8, r.integers(0, 1 << 20, I), -1).astype(np.int32)
    q = a // 2 + 1
    jst, jch = jfast.phase2_accept(js, jnp.int32(ballot), jnp.asarray(vids), q)
    tst, tch = tfast.phase2_accept(ts, ballot, torch.from_numpy(vids), q)
    _same_state(tst, jst)
    _eq(tch, jch, "chosen")
    assert bool(tch) == (ballot != 0)  # ballot 0 is below every promise
    _same_state(tfast.phase3_learn(tst, torch.from_numpy(vids), tch),
                jfast.phase3_learn(jst, jnp.asarray(vids), jch))


@pytest.mark.parametrize("a", NODES)
@pytest.mark.parametrize("case", ["fresh", "preaccepted", "no_quorum"])
def test_choose_all_equals_jax(a, case):
    np_state = _state(
        a, seed=20 + a, preaccepted=case == "preaccepted",
        promised=_no_quorum(a) if case == "no_quorum" else None,
    )
    js, ts = _pair(np_state)
    vids = np.arange(I, dtype=np.int32) + 5000
    jst, jn = jfast.choose_all(js, jnp.asarray(vids), proposer=a - 1, quorum=a // 2 + 1)
    tst, tn = tfast.choose_all(ts, torch.from_numpy(vids), proposer=a - 1, quorum=a // 2 + 1)
    _same_state(tst, jst)
    _eq(tn, jn, "n_chosen")
    _eq(tfast.learned_ia(tst), jfast.learned_ia(jst), "learned_ia")
    if case == "fresh":
        assert int(tn) == I
    if case == "no_quorum":
        assert int(tn) == 0


def test_init_state_equals_jax():
    _same_state(tfast.init_state(33, 5, device="cpu"), jfast.init_state(33, 5))


def test_init_state_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfast.init_state(8, 3)


def test_fast_state_interop_round_trip():
    np_state = _state(5, seed=3)
    back = interop.fast_state_to_numpy(interop.fast_state_from_jax(np_state, device="cpu"))
    assert type(back).__name__ == "FastState"
    for name in jfast.FastState._fields:
        _eq(getattr(back, name), getattr(np_state, name), name)
