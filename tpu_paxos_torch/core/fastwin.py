"""The fast path's steady-state accept+learn windows, with the window as
a CUDA kernel for Hopper (port of ``tpu_paxos/core/fastwin.py`` and of
its XLA twin ``bench._steady_state_windows``).

The headline workload drives windows of I fresh instances through one
prepared proposer's batched accept + commit: one prepare, then batched
accepts forever (ref multi/paxos.cpp:1256-1326, commit 1446-1479).  Per
window k (the JAX module's formulas):

    vid[i]           = prepared ? vids0[i] + k*span : NONE
    store[a, i]      = ok[a] & (vid[i] != NONE)     (ok = ballot >= promised)
    acc_ballot[a, i] = store ? ballot : NONE        (recycle-fill + accept)
    acc_vid[a, i]    = store ? vid[i] : NONE
    learned[a, i]    = chosen & vid != NONE ? vid : NONE
    counts[k]        = #{i : learned[0, i] != NONE}

``steady_state_windows_fused`` replaces the Pallas kernel
``tpu_paxos/core/fastwin.py::steady_state_windows_fused``; its kernel,
``tpu_paxos_torch/csrc/fastwin.cu``, is bound by device-memory bytes
(the source says what its design does about that) and is built by
``utils/kbuild.py`` at first use.

Three window functions:

- ``steady_state_windows_plain``: the plain PyTorch version, the port's
  own copy of the scan path (phase 1 once, then per window a
  recycle-fill, ``phase2_accept``, ``phase3_learn`` and the row-0
  count), functional, any device;
- ``steady_state_windows_cuda``: the kernel wrapper — checks device,
  dtype, shape and contiguity, launches one kernel per window on the
  current stream (the stream orders the windows), checks each launch,
  counts them in :data:`LAUNCHES`; raises on CPU tensors;
- ``steady_state_windows_fused``: the public counterpart of the JAX
  function, with its contract: the same ``ValueError``s on the same
  inputs, ``(state, counts [reps] int32)`` out.  It updates the state it
  is given in place on every device (JAX donates it): the kernel writes
  the acceptor arrays on a card, and on the CPU the plain version's
  result is written back.  Callers sum ``counts`` as host integers
  (reps * I can exceed int32).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_paxos_torch.core import ballot as bal
from tpu_paxos_torch.core import fast
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.utils import counters
from tpu_paxos_torch.utils import kbuild

NAME = "fastwin"

# The JAX kernel's instance tile; the public entry point keeps its
# alignment contract (the CUDA kernel itself takes any I).
TILE = 65536

_I32 = torch.int32

#: Kernel launches (one per window) since the last :func:`reset_counts`.
LAUNCHES = {"steady_state_windows": 0}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load():
    """Build the kernel if needed and load it (once per process)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return kbuild.load(NAME, {
        "fastwin_window": ([vp] * 6 + [i32, i64, i32, vp], i32),
    })


def _check_vid_space(reps: int, span: int) -> None:
    # Window k proposes vids0 + k*span: the top of the int32 vid space
    # is the capacity bound (vid 2^31 would wrap to the NONE sentinel).
    if reps * span > 1 << 31:
        raise ValueError(
            f"reps * span = {reps * span} exceeds the int32 vid space"
        )


def _shift(vids0: torch.Tensor, off: int) -> torch.Tensor:
    """``vids0 + off`` wrapping as JAX's int32 add does."""
    x = (vids0.to(torch.int64) + off + (1 << 31)) % (1 << 32) - (1 << 31)
    return x.to(_I32)


def _first_ballot(state: fast.FastState) -> torch.Tensor:
    """Proposer 0's ballot bumped past every ballot seen, on the device."""
    zero = torch.zeros((), dtype=_I32, device=state.max_seen.device)
    return bal.bump_past(zero, zero, state.max_seen.amax())[1]


# ---------------------------------------------------------------- plain


def steady_state_windows_plain(
    state: fast.FastState, vids0: torch.Tensor, reps: int, quorum: int,
    span: int | None = None,
):
    """Phase 1 once, then ``reps`` accept+learn windows over fresh
    instance windows (the state arrays recycled as the sliding window).
    Returns (state, per-window chosen counts [reps] int32)."""
    span = span or vids0.shape[0]
    _check_vid_space(reps, span)
    ballot = _first_ballot(state)
    state, prepared, _, _ = fast.phase1_prepare(state, ballot, quorum, adopt=False)
    counts = []
    for k in range(reps):
        # A fresh window of instances: clear per-instance state, new vids.
        st = state._replace(
            acc_ballot=torch.full_like(state.acc_ballot, bal.NONE),
            acc_vid=torch.full_like(state.acc_vid, val.NONE),
            learned=torch.full_like(state.learned, val.NONE),
        )
        vids = torch.where(prepared, _shift(vids0, k * span), val.NONE)
        st, chosen = fast.phase2_accept(st, ballot, vids, quorum)
        state = fast.phase3_learn(st, vids, chosen)
        counts.append((state.learned[0] != val.NONE).sum(dtype=_I32))
    if not counts:
        return state, torch.zeros((0,), dtype=_I32, device=vids0.device)
    return state, torch.stack(counts)


# ---------------------------------------------------------------- kernel


def steady_state_windows_cuda(acc_ballot, acc_vid, learned, vids0, scal, reps):
    """Launch one window kernel per window (in order on the current
    stream) over the [A, I] state arrays, in place.  ``vids0`` is the
    [I] int32 vid array or None for sequential vids; ``scal`` is the
    [4 + A] int32 device array ``[ballot, span, prepared, chosen,
    ok[A]]``.  Returns ``counts [reps]`` int32."""
    dev = acc_ballot.device
    if dev.type != "cuda":
        raise ValueError("fastwin.steady_state_windows_cuda needs CUDA tensors")
    a, i = acc_ballot.shape
    kbuild.require(acc_ballot, "acc_ballot", _I32, (a, i), dev)
    kbuild.require(acc_vid, "acc_vid", _I32, (a, i), dev)
    kbuild.require(learned, "learned", _I32, (a, i), dev)
    if vids0 is not None:
        kbuild.require(vids0, "vids0", _I32, (i,), dev)
    kbuild.require(scal, "scal", _I32, (4 + a,), dev)
    counts = torch.zeros((reps,), dtype=_I32, device=dev)
    lib = load()
    vptr = None if vids0 is None else vids0.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k in range(reps):
            code = lib.fastwin_window(
                acc_ballot.data_ptr(), acc_vid.data_ptr(), learned.data_ptr(),
                vptr, scal.data_ptr(), counts.data_ptr() + 4 * k, a, i, k, stream,
            )
            kbuild.check_launch(lib, NAME, code, "fastwin.steady_state_windows")
            LAUNCHES["steady_state_windows"] += 1
    return counts


# ---------------------------------------------------------------- public


def window_scalars(state: fast.FastState, quorum: int, span: int) -> torch.Tensor:
    """Phase 1 on the device, written into ``state.promised`` /
    ``state.max_seen`` in place, and the kernel's scalar operand
    ``[ballot, span, prepared, chosen, ok[A]]`` (int32, same device, no
    host sync).  The decisions hold for every window: only accepts flow
    after phase 1, and it has already folded the ballot into
    ``max_seen``."""
    ballot = _first_ballot(state)
    new, prepared, _, _ = fast.phase1_prepare(state, ballot, quorum, adopt=False)
    state.promised.copy_(new.promised)
    state.max_seen.copy_(new.max_seen)
    ok = ballot >= state.promised  # [A], ref multi/paxos.cpp:1366
    chosen = ok.sum(dtype=_I32) >= quorum
    head = torch.stack([
        ballot, torch.full_like(ballot, span), prepared.to(_I32), chosen.to(_I32),
    ])
    return torch.cat([head, ok.to(_I32)])


def steady_state_windows_fused(
    state: fast.FastState,
    vids0: torch.Tensor | None,
    reps: int,
    quorum: int,
    span: int | None = None,
    iota_vids: bool = False,
):
    """``reps`` steady-state windows in one call: the kernel on CUDA
    tensors, the plain version on CPU tensors.  Returns ``(state,
    counts [reps] int32)``; ``state`` is the one given, updated in
    place.  ``iota_vids=True`` says the workload is sequential ids
    (vids0 == arange(I)); they are then made inside the kernel and
    ``vids0`` must be None."""
    a, i = state.acc_ballot.shape
    if i % TILE:
        raise ValueError(f"n_instances ({i}) must be a multiple of {TILE}")
    if iota_vids and vids0 is not None:
        raise ValueError(
            "iota_vids=True synthesizes arange vids; passing vids0 too is "
            "almost certainly a mistake (it would be silently ignored)"
        )
    if not iota_vids and vids0 is None:
        raise ValueError("vids0 is required unless iota_vids=True")
    span = span or i
    _check_vid_space(reps, span)
    # one count a window, on every device: a card launches once a window
    counters.add("steady_state_windows", reps)
    if state.acc_ballot.device.type == "cpu":
        if iota_vids:
            vids0 = torch.arange(i, dtype=_I32)
        out, counts = steady_state_windows_plain(state, vids0, reps, quorum, span)
        for name in fast.FastState._fields:
            getattr(state, name).copy_(getattr(out, name))
        return state, counts
    scal = window_scalars(state, quorum, span)
    counts = steady_state_windows_cuda(
        state.acc_ballot, state.acc_vid, state.learned, vids0, scal, reps
    )
    return state, counts


def bytes_per_launch(a: int, i: int, iota_vids: bool) -> int:
    """Bytes one window launch must move: the three [A, I] int32 state
    arrays written once, the [I] vids read once unless made in the
    kernel, the scalars read and the count written."""
    return 3 * 4 * a * i + (0 if iota_vids else 4 * i) + 4 * (4 + a) + 4


#: The library build is covered by the dispatcher's entry.
AUDIT_EXEMPT = {
    "load": "builds and loads the kernel's library; every launch goes "
            "through steady_state_windows_fused, which the entry covers",
}


def audit_entries():
    """The fused steady-state windows' registered entry point
    (``analysis/registry.py``), JAX's canonical call: two windows over one
    65536-instance tile of 3 acceptors, sequential vids, quorum 2 (one
    launch a window on a card)."""
    from tpu_paxos_torch.analysis.registry import AuditEntry

    reps, quorum = 2, 2

    def build(device):
        state = fast.init_state(TILE, 3, device=device)

        def fn(state):
            return steady_state_windows_fused(state, None, reps=reps, quorum=quorum,
                                              iota_vids=True)

        return fn, (state,)

    return [AuditEntry("fastwin.steady_windows", build,
                       covers=("steady_state_windows_fused",))]
