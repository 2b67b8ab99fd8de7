"""The steady-state window kernel on a card: it equals its plain PyTorch
version at small and odd sizes, for sequential and explicit vids, with
and without a quorum; its wrapper refuses what the kernel does not take;
and the public entry point consumes its state alike on the card and the
CPU.

These tests need a CUDA card and skip without one.  The file imports
neither ``jax`` nor ``tpu_paxos`` (the card's machine has neither), so
run it there without the suite's conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_fastwin_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu_paxos_torch import interop
from tpu_paxos_torch.core import fast
from tpu_paxos_torch.core import fastwin as tfw

A = 5
HIGH = 10 << 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fastwin kernel has no CPU mode")
    return torch.device("cuda")


def np_state(a, i, seed, blocked=False):
    """A seeded numpy FastState with stale acceptor contents (the
    windows overwrite every cell) and, if ``blocked``, a majority that
    promised a ballot above the proposer's."""
    r = np.random.default_rng(seed)
    promised = np.zeros(a, np.int32)
    if blocked:
        promised[: a // 2 + 1] = HIGH
    return fast.FastState(
        promised=promised,
        max_seen=r.integers(0, 3 << 16, a).astype(np.int32),
        acc_ballot=r.integers(-1, 1 << 20, (a, i)).astype(np.int32),
        acc_vid=r.integers(-1, 1 << 20, (a, i)).astype(np.int32),
        learned=r.integers(-1, 1 << 20, (a, i)).astype(np.int32),
    )


def _kernel_and_plain(card, i, iota, blocked, reps=3, span=None, base=0):
    st = np_state(A, i, seed=i + blocked, blocked=blocked)
    vids = torch.arange(i, dtype=torch.int32) + base
    span = span or i
    cpu = interop.fast_state_from_jax(st, device="cpu")
    want, want_cnt = tfw.steady_state_windows_plain(cpu, vids, reps, 3, span)
    dev = interop.fast_state_from_jax(st, device=card)
    scal = tfw.window_scalars(dev, 3, span)
    got_cnt = tfw.steady_state_windows_cuda(
        dev.acc_ballot, dev.acc_vid, dev.learned, None if iota else vids.to(card), scal, reps)
    torch.cuda.synchronize()
    return interop.fast_state_to_numpy(dev), got_cnt.cpu(), interop.fast_state_to_numpy(want), want_cnt


@pytest.mark.cuda
@pytest.mark.parametrize("i", [80, 4099, (1 << 20) + 7, 1 << 20])
@pytest.mark.parametrize("iota", [False, True])
@pytest.mark.parametrize("blocked", [False, True])
def test_kernel_equals_plain_on_card(card, i, iota, blocked):
    got, got_cnt, want, want_cnt = _kernel_and_plain(card, i, iota, blocked)
    for name in fast.FastState._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert torch.equal(got_cnt, want_cnt)
    assert int(got_cnt.sum()) == (0 if blocked else 3 * i)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["span_gt_I", "int32_wrap"])
def test_kernel_equals_plain_on_card_at_the_edges(card, case):
    i = 4099
    kw = dict(span=8 * i) if case == "span_gt_I" else dict(base=(1 << 31) - i - 7)
    got, got_cnt, want, want_cnt = _kernel_and_plain(card, i, False, False, **kw)
    for name in fast.FastState._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert torch.equal(got_cnt, want_cnt)


@pytest.mark.cuda
def test_wrapper_refuses_bad_operands(card):
    st = interop.fast_state_from_jax(np_state(3, 256, seed=1), device=card)
    scal = tfw.window_scalars(st, 2, 256)
    vids = torch.arange(256, dtype=torch.int32, device=card)
    before = dict(tfw.LAUNCHES)
    with pytest.raises(ValueError, match="int32"):
        tfw.steady_state_windows_cuda(st.acc_ballot, st.acc_vid, st.learned, vids.long(), scal, 1)
    with pytest.raises(ValueError, match="shape"):
        tfw.steady_state_windows_cuda(st.acc_ballot, st.acc_vid, st.learned, vids[:128], scal, 1)
    with pytest.raises(ValueError, match="shape"):
        tfw.steady_state_windows_cuda(st.acc_ballot, st.acc_vid, st.learned, None, scal[:4], 1)
    with pytest.raises(ValueError, match="contiguous"):
        tfw.steady_state_windows_cuda(
            st.acc_ballot, st.acc_vid.T.contiguous().T, st.learned, None, scal, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tfw.steady_state_windows_cuda(st.acc_ballot, st.acc_vid, st.learned, vids.cpu(), scal, 1)
    assert tfw.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("iota", [False, True])
def test_fused_consumes_its_state_alike_on_card_and_cpu(card, iota):
    i = 2 * tfw.TILE
    st = np_state(A, i, seed=7)
    outs = {}
    for dev in ("cpu", card):
        given = interop.fast_state_from_jax(st, device=dev)
        vids = None if iota else torch.arange(i, dtype=torch.int32, device=dev)
        tfw.reset_counts()
        out, cnt = tfw.steady_state_windows_fused(given, vids, reps=4, quorum=3, iota_vids=iota)
        assert all(o is g for o, g in zip(out, given))
        outs[str(dev)] = (interop.fast_state_to_numpy(given), cnt.cpu())
        assert tfw.LAUNCHES["steady_state_windows"] == (0 if dev == "cpu" else 4)
    (cpu_st, cpu_cnt), (card_st, card_cnt) = outs.values()
    for name in fast.FastState._fields:
        np.testing.assert_array_equal(getattr(card_st, name), getattr(cpu_st, name), err_msg=name)
    assert torch.equal(card_cnt, cpu_cnt) and int(card_cnt.sum()) == 4 * i
    np.testing.assert_array_equal(card_st.learned[A - 1], np.arange(i) + 3 * i)
