"""Faults planted under the timed path, for the control and the tests: each
breaks what the program produces where it is produced, and the reference's
comparison has to call the run not correct.

- ``state_unchanged``: the step returns its state as it was given (the
  general engine's round; the fast path's step, with counts that claim
  every instance);
- ``half_batch``: half of the instances left out of the step (the
  general engine's accept store; the fast path's whole step);
- ``answer_altered``: an answer altered where it is produced (one node's
  learned value at one instance of each general-engine run; every vid a
  fast step accepts and learns shifted by one);
- ``stale_window_vids`` (fast-path windows only): every window of a step
  given the last window's vids, its count left right, so that the final
  state and the counts read as a sound step's would.

The cells run on one chip and exchange nothing between chips, so the
fault of a missing exchange has no place here.  :func:`plant` installs a
fault for the life of a ``with`` block and takes it out after.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from paxbench.spans import resolve

NAMES = ("state_unchanged", "half_batch", "answer_altered")

#: Faults that only a traffic kind's own step can have.
KIND_FAULTS = {"fast_steps": ("stale_window_vids",)}

NONE = -1


#: The half of the instances a ``half_batch`` fault leaves out: every
#: other one, so that it meets the instances a workload uses wherever
#: they lie.
HALF = slice(1, None, 2)


def _sim_faults(name: str):
    if name == "state_unchanged":
        return "tpu_paxos_torch.core.sim:_lane_round", lambda fn: (
            lambda b, roots, st, *a, **kw: st)
    if name == "half_batch":
        def store(fn):
            def wrapped(acc_ballot, acc_vid, *rest):
                kept = acc_ballot[..., HALF].clone(), acc_vid[..., HALF].clone()
                out = fn(acc_ballot, acc_vid, *rest)
                acc_ballot[..., HALF] = kept[0]
                acc_vid[..., HALF] = kept[1]
                return out
            return wrapped
        return "tpu_paxos_torch.core.simkern:store_accepts", store
    if name == "answer_altered":
        def result(fn):
            def wrapped(final, expected):
                res = fn(final, expected)
                decided = np.flatnonzero(res.chosen_vid != NONE)
                if decided.size >= 2:
                    i, j = decided[len(decided) // 3], decided[2 * len(decided) // 3]
                    res.learned[i, res.learned.shape[1] - 1] = res.chosen_vid[j]
                return res
            return wrapped
        return "tpu_paxos_torch.core.sim:to_result", result
    raise ValueError(name)


def _fast_faults(name: str):
    def on_step(alter):
        def wrap(fn):
            def wrapped(state, *a, **kw):
                kept = None
                if name == "half_batch":
                    kept = [x[:, HALF].clone() for x in (state.acc_ballot, state.acc_vid,
                                                         state.learned)]
                out = alter(fn, state, a, kw)
                if kept is not None:
                    for x, k in zip((out[0].acc_ballot, out[0].acc_vid, out[0].learned), kept):
                        x[:, HALF] = k
                return out
            return wrapped
        return wrap

    def run(fn, state, a, kw):
        return fn(state, *a, **kw)

    def unchanged(fn, state, a, kw):
        i = state.acc_ballot.shape[1]
        if fn.__name__ == "choose_all":
            return state, torch.tensor(i, dtype=torch.int32)
        return state, torch.full((kw["reps"],), i, dtype=torch.int32)

    def shifted(fn, state, a, kw):
        out = fn(state, *a, **kw)
        st = out[0]
        for x in (st.acc_vid, st.learned):
            x.add_((x != NONE).to(x.dtype))
        return out

    alter = {"state_unchanged": unchanged, "half_batch": run, "answer_altered": shifted}[name]
    return [("tpu_paxos_torch.core.fast:choose_all", on_step(alter)),
            ("tpu_paxos_torch.core.fastwin:steady_state_windows_fused", on_step(alter))]


def _stale_windows():
    """On a card each launch is told it is the last window; the plain
    path shifts every window's vids by the last window's offset."""
    def cuda(fn):
        from tpu_paxos_torch.core import fastwin

        def wrapped(acc_ballot, acc_vid, learned, vids0, scal, reps):
            load = fastwin.load

            class Last:
                def __init__(self, lib):
                    self._lib = lib

                def __getattr__(self, attr):
                    return getattr(self._lib, attr)

                def fastwin_window(self, *a):
                    return self._lib.fastwin_window(*a[:8], reps - 1, *a[9:])

            fastwin.load = lambda: Last(load())
            try:
                return fn(acc_ballot, acc_vid, learned, vids0, scal, reps)
            finally:
                fastwin.load = load
        return wrapped

    def plain(fn):
        from tpu_paxos_torch.core import fastwin

        def wrapped(state, vids0, reps, quorum, span=None):
            shift = fastwin._shift
            last = (reps - 1) * (span or vids0.shape[0])
            fastwin._shift = lambda v, off: shift(v, last)
            try:
                return fn(state, vids0, reps, quorum, span)
            finally:
                fastwin._shift = shift
        return wrapped

    return [("tpu_paxos_torch.core.fastwin:steady_state_windows_cuda", cuda),
            ("tpu_paxos_torch.core.fastwin:steady_state_windows_plain", plain)]


def names(kind: str) -> tuple:
    """The faults a traffic kind can have."""
    return NAMES + KIND_FAULTS.get(kind, ())


@contextlib.contextmanager
def plant(kind: str, name: str):
    """Plant fault ``name`` under a traffic kind's timed path
    (``sim_runs`` or ``fast_steps``)."""
    if name not in names(kind):
        raise ValueError(f"unknown fault {name!r} for {kind}; one of {names(kind)}")
    if name == "stale_window_vids":
        pairs = _stale_windows()
    elif kind == "sim_runs":
        pairs = [_sim_faults(name)]
    else:
        pairs = _fast_faults(name)
    saved = []
    try:
        for target, make in pairs:
            owner, attr, fn = resolve(target)
            saved.append((owner, attr, fn))
            setattr(owner, attr, make(fn))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
