"""The port's steady-state windows (tpu_paxos_torch/core/fastwin.py) on
the CPU against the JAX package: the plain version and the public
``steady_state_windows_fused`` must equal ``bench._steady_state_windows``
(the XLA scan) and ``fastwin.steady_state_windows_fused`` run in
interpret mode (as tests/test_fastwin.py runs it), array for array, and
raise the same ``ValueError``s on the same inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from tpu_paxos.core import fast as jfast
from tpu_paxos.core import fastwin as jfw
from tpu_paxos_torch import interop
from tpu_paxos_torch.core import fast as tfast
from tpu_paxos_torch.core import fastwin as tfw

A = 5
I = 2 * jfw.TILE
HIGH = 10 << 16


def _np_state(a, i, promised=None):
    st = jax.tree.map(np.asarray, jfast.init_state(i, a))
    if promised is not None:
        st = st._replace(promised=np.asarray(promised, np.int32))
    return st


@functools.cache
def _jax_windows(a, i, reps, quorum, span, iota, blocked, vid_base):
    """(scan state, scan counts, interpret-mode Pallas state, counts) as
    numpy, for one case; vids are ``vid_base + arange(i)``."""
    st = _np_state(a, i, [HIGH] * 3 + [0] * (a - 3) if blocked else None)
    vids0 = jnp.arange(i, dtype=jnp.int32) + jnp.int32(vid_base)
    step = jax.jit(functools.partial(
        bench._steady_state_windows, reps=reps, quorum=quorum, span=span))
    ref, ref_cnt = step(jax.tree.map(jnp.asarray, st), vids0)
    out = cnt = None
    if vid_base == 0:  # the kernel's own vids are arange (iota) or any
        fused, cnt = jfw.steady_state_windows_fused(
            jax.tree.map(jnp.asarray, st), None if iota else vids0,
            reps=reps, quorum=quorum, span=span, interpret=True, iota_vids=iota,
        )
        out, cnt = jax.tree.map(np.asarray, fused), np.asarray(cnt)
    return st, jax.tree.map(np.asarray, ref), np.asarray(ref_cnt), out, cnt


def _same(got, want):
    for name in jfast.FastState._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


CASES = {
    # (reps, quorum, span, iota, blocked, vid_base)
    "reps1_explicit": (1, 3, None, False, False, 0),
    "reps3_explicit": (3, 3, None, False, False, 0),
    "reps1_iota": (1, 3, None, True, False, 0),
    "reps3_iota": (3, 3, None, True, False, 0),
    "span_gt_I": (2, 3, 8 * jfw.TILE, False, False, 0),
    "no_quorum": (2, 3, None, False, True, 0),
    # vids near the top of int32: vids0 + k*span wraps as JAX's add does
    "int32_wrap": (3, 3, None, False, False, (1 << 31) - I - 7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_and_fused_equal_jax(case):
    reps, quorum, span, iota, blocked, base = CASES[case]
    st, ref, ref_cnt, pallas, pallas_cnt = _jax_windows(A, I, reps, quorum, span, iota, blocked, base)
    vids0 = torch.arange(I, dtype=torch.int32) + base
    tst = interop.fast_state_from_jax(st, device="cpu")
    plain, plain_cnt = tfw.steady_state_windows_plain(tst, vids0, reps, quorum, span)
    _same(interop.fast_state_to_numpy(plain), ref)
    np.testing.assert_array_equal(plain_cnt.numpy(), ref_cnt)
    assert plain_cnt.dtype == torch.int32 and plain_cnt.shape == (reps,)
    if pallas is None:
        return
    _same(interop.fast_state_to_numpy(plain), pallas)
    np.testing.assert_array_equal(plain_cnt.numpy(), pallas_cnt)
    tst = interop.fast_state_from_jax(st, device="cpu")
    fused, cnt = tfw.steady_state_windows_fused(
        tst, None if iota else vids0, reps=reps, quorum=quorum, span=span, iota_vids=iota)
    _same(interop.fast_state_to_numpy(fused), pallas)
    np.testing.assert_array_equal(cnt.numpy(), pallas_cnt)
    assert bench._total(cnt.numpy()) == bench._total(pallas_cnt)
    if blocked:
        assert bench._total(cnt.numpy()) == 0 and (fused.learned.numpy() == -1).all()


def test_fused_updates_the_given_state_in_place_on_cpu():
    st = _np_state(A, I)
    tst = interop.fast_state_from_jax(st, device="cpu")
    ptrs = [t.data_ptr() for t in tst]
    out, cnt = tfw.steady_state_windows_fused(tst, None, reps=2, quorum=3, iota_vids=True)
    assert [t.data_ptr() for t in out] == ptrs
    for name in jfast.FastState._fields:
        assert getattr(out, name) is getattr(tst, name)
    assert bench._total(cnt.numpy()) == 2 * I
    np.testing.assert_array_equal(tst.learned.numpy()[0], np.arange(I) + I)


def _raises_alike(jcall, tcall, match):
    with pytest.raises(ValueError, match=match) as je:
        jcall()
    with pytest.raises(ValueError, match=match) as te:
        tcall()
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("case", ["ragged", "iota_and_vids", "missing_vids", "vid_space"])
def test_same_value_errors_as_jax(case):
    i = jfw.TILE + 128 if case == "ragged" else jfw.TILE
    reps = (1 << 31) // i + 1 if case == "vid_space" else 1
    with_vids = case != "missing_vids"
    iota = case == "iota_and_vids"
    jv = jnp.arange(i, dtype=jnp.int32) if with_vids else None
    tv = torch.arange(i, dtype=torch.int32) if with_vids else None
    match = {"ragged": "multiple", "iota_and_vids": "iota_vids",
             "missing_vids": "required", "vid_space": "vid space"}[case]
    _raises_alike(
        lambda: jfw.steady_state_windows_fused(
            jfast.init_state(i, 3), jv, reps=reps, quorum=2, interpret=True, iota_vids=iota),
        lambda: tfw.steady_state_windows_fused(
            tfast.init_state(i, 3, device="cpu"), tv, reps=reps, quorum=2, iota_vids=iota),
        match,
    )


def test_cuda_wrapper_refuses_cpu_tensors():
    st = tfast.init_state(64, 3, device="cpu")
    before = dict(tfw.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tfw.steady_state_windows_cuda(
            st.acc_ballot, st.acc_vid, st.learned, None,
            torch.zeros(7, dtype=torch.int32), 1)
    assert tfw.LAUNCHES == before


def test_window_scalars_are_the_jax_kernels_scalars():
    """[ballot, span, prepared, chosen, ok[A]]: the JAX function's
    ``scals`` and ``ok`` operands, from phase 1 written in place."""
    st = _np_state(A, 64, [HIGH, 0, 0, HIGH, 0])
    tst = interop.fast_state_from_jax(st, device="cpu")
    scal = tfw.window_scalars(tst, 3, 64).tolist()
    js, prepared, _, _ = jfast.phase1_prepare(
        jax.tree.map(jnp.asarray, st), jnp.int32((1 << 16) | 0), 3)
    ok = np.asarray((1 << 16) >= js.promised)
    assert scal == [(1 << 16), 64, int(prepared), int(ok.sum() >= 3), *ok.astype(int).tolist()]
    np.testing.assert_array_equal(tst.promised.numpy(), np.asarray(js.promised))
    np.testing.assert_array_equal(tst.max_seen.numpy(), np.asarray(js.max_seen))


@pytest.mark.parametrize("iota", [False, True])
def test_bytes_per_launch(iota):
    assert tfw.bytes_per_launch(5, 1 << 27, iota) - 60 * (1 << 27) - (0 if iota else 4 << 27) == 40
