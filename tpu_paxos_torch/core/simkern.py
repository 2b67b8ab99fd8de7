"""The general engine's two hottest event blocks as CUDA kernels for
Hopper, with their plain PyTorch versions (port of
``tpu_paxos/core/simkern.py``).

- ``store_accepts`` replaces ``tpu_paxos/core/simkern.py::store_accepts``
  (Pallas ``_store_kernel``): per (a, i) the max-ballot eligible
  incoming accept across proposers is stored in place (ref
  multi/paxos.cpp:1359-1397 OnAccept, with the safe-acceptor deviation
  documented in core/sim.py).
- ``accum_acks`` replaces ``tpu_paxos/core/simkern.py::accum_acks``
  (Pallas ``_ack_kernel``): per (p, a, i) an accept reply is certified
  by store-or-match against the acceptor's state and folded into the
  int8 ack cube in place, with the per-instance ack count written in
  the same pass (ref multi/paxos.cpp:1407-1444 OnAcceptReply).

Both are bound by device-memory bytes; the source,
``tpu_paxos_torch/csrc/simkern.cu``, says what its design does about
that.  ``utils/kbuild.py`` compiles it at first use into a shared
library with a plain C interface and loads it with ``ctypes``.

Three functions per kernel:

- ``*_plain``: the plain PyTorch version (the JAX package's jnp
  formulation), functional, any device;
- ``*_cuda``: the kernel wrapper — checks device, dtype, shape and
  contiguity loudly, launches on the current stream, checks the launch
  error, counts the launch in :data:`LAUNCHES`; raises on CPU tensors;
- ``store_accepts`` / ``accum_acks``: pick the plain version for CPU
  tensors and the kernel for CUDA tensors.  A failed build or launch
  raises; nothing falls back to the plain version.

The last two have one contract on every device: they update
``acc_ballot``/``acc_vid`` (store) and ``acks`` (ack fold) in place and
return those same tensors, as the kernels do.  On the CPU the plain
version's result is written back into the inputs, so a caller that
reuses a state after a round sees the same thing on both devices.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_paxos_torch.core import ballot as bal
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.utils import kbuild

NAME = "simkern"

#: Kernel launches since the last :func:`reset_counts`, by kernel name.
LAUNCHES = {"store_accepts": 0, "accum_acks": 0}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def load():
    """Build the kernels if needed and load them (once per process)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return kbuild.load(NAME, {
        "simkern_store_accepts": ([vp] * 5 + [i32, i32, i64, vp], i32),
        "simkern_accum_acks": ([vp] * 7 + [i32, i32, i64, vp], i32),
    })


def _scalars(first: torch.Tensor, pa: torch.Tensor, device) -> torch.Tensor:
    """The [P] and [P, A] operands as one small int32 device array."""
    return torch.cat([
        first.to(device=device, dtype=torch.int32).reshape(-1),
        pa.to(device=device, dtype=torch.int32).reshape(-1),
    ]).contiguous()


# ---------------------------------------------------------------- plain


def store_accepts_plain(acc_ballot, acc_vid, learned, abat, abal, elig):
    """The jnp block of ``tpu_paxos/core/sim.py``'s ``_store_accepts``
    in PyTorch: proposers unrolled into a running masked max over
    [A, I] (ballots are unique per proposer, so the max never ties)."""
    is_comm = learned != val.NONE
    best_b = torch.full_like(acc_ballot, bal.NONE)
    best_v = torch.full_like(acc_vid, val.NONE)
    for pi in range(abat.shape[0]):
        batp = abat[pi][None, :]
        abal_p = abal[pi]
        store_ok = torch.where(is_comm, batp == learned, abal_p >= acc_ballot)
        ackp = elig[pi][:, None] & (batp != val.NONE) & store_ok
        candp = torch.where(ackp & ~is_comm, abal_p, torch.full_like(best_b, bal.NONE))
        take = candp > best_b
        best_b = torch.where(take, candp, best_b)
        best_v = torch.where(take, batp.expand_as(best_v), best_v)
    do_store = best_b != bal.NONE
    return (
        torch.where(do_store, best_b, acc_ballot),
        torch.where(do_store, best_v, acc_vid),
    )


def accum_acks_plain(acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa):
    """The ack-accumulation head of ``tpu_paxos/core/sim.py``'s
    ``_accum_acks`` in PyTorch: returns (acks', n_ack [P, I] int32)."""
    hold = (acc_vid[None] == cur_batch[:, None, :]) & (
        acc_ballot[None] == ballot[:, None, None]
    )
    comm = (learned[None] == cur_batch[:, None, :]) & (learned[None] != val.NONE)
    new = (
        amatch_pa[:, :, None]
        & (cur_batch != val.NONE)[:, None, :]
        & (hold | comm)
    ).to(torch.int8)
    acks = acks | new
    n_ack = acks.sum(dim=1, dtype=torch.int32)
    return acks, n_ack


# ---------------------------------------------------------------- kernels


def store_accepts_cuda(acc_ballot, acc_vid, learned, abat, abal, elig):
    """Launch the store kernel: updates ``acc_ballot``/``acc_vid`` in
    place and returns them."""
    dev = acc_ballot.device
    if dev.type != "cuda":
        raise ValueError("simkern.store_accepts_cuda needs CUDA tensors")
    a, i = acc_ballot.shape
    p = abat.shape[0]
    kbuild.require(acc_ballot, "acc_ballot", torch.int32, (a, i), dev)
    kbuild.require(acc_vid, "acc_vid", torch.int32, (a, i), dev)
    kbuild.require(learned, "learned", torch.int32, (a, i), dev)
    kbuild.require(abat, "abat", torch.int32, (p, i), dev)
    kbuild.require(abal, "abal", torch.int32, (p,), dev)
    kbuild.require(elig, "elig", torch.bool, (p, a), dev)
    scal = _scalars(abal, elig, dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.simkern_store_accepts(
            acc_ballot.data_ptr(), acc_vid.data_ptr(), learned.data_ptr(),
            abat.data_ptr(), scal.data_ptr(), a, p, i, stream,
        )
    kbuild.check_launch(lib, NAME, code, "simkern.store_accepts")
    LAUNCHES["store_accepts"] += 1
    return acc_ballot, acc_vid


def accum_acks_cuda(acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa):
    """Launch the ack kernel: updates ``acks`` in place; returns
    ``(acks, n_ack)``."""
    dev = acks.device
    if dev.type != "cuda":
        raise ValueError("simkern.accum_acks_cuda needs CUDA tensors")
    p, a, i = acks.shape
    kbuild.require(acks, "acks", torch.int8, (p, a, i), dev)
    kbuild.require(cur_batch, "cur_batch", torch.int32, (p, i), dev)
    kbuild.require(acc_ballot, "acc_ballot", torch.int32, (a, i), dev)
    kbuild.require(acc_vid, "acc_vid", torch.int32, (a, i), dev)
    kbuild.require(learned, "learned", torch.int32, (a, i), dev)
    kbuild.require(ballot, "ballot", torch.int32, (p,), dev)
    kbuild.require(amatch_pa, "amatch_pa", torch.bool, (p, a), dev)
    scal = _scalars(ballot, amatch_pa, dev)
    n_ack = torch.empty((p, i), dtype=torch.int32, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.simkern_accum_acks(
            acks.data_ptr(), n_ack.data_ptr(), cur_batch.data_ptr(),
            acc_ballot.data_ptr(), acc_vid.data_ptr(), learned.data_ptr(),
            scal.data_ptr(), a, p, i, stream,
        )
    kbuild.check_launch(lib, NAME, code, "simkern.accum_acks")
    LAUNCHES["accum_acks"] += 1
    return acks, n_ack


# ---------------------------------------------------------------- dispatch


def store_accepts(acc_ballot, acc_vid, learned, abat, abal, elig):
    """Updates ``acc_ballot``/``acc_vid`` in place and returns them: the
    kernel on CUDA tensors, the plain version written back on CPU
    tensors."""
    if acc_ballot.device.type == "cpu":
        new_b, new_v = store_accepts_plain(acc_ballot, acc_vid, learned, abat, abal, elig)
        return acc_ballot.copy_(new_b), acc_vid.copy_(new_v)
    return store_accepts_cuda(acc_ballot, acc_vid, learned, abat, abal, elig)


def accum_acks(acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa):
    """Updates ``acks`` in place; returns ``(acks, n_ack)``: the kernel
    on CUDA tensors, the plain version written back on CPU tensors."""
    if acks.device.type == "cpu":
        new, n_ack = accum_acks_plain(
            acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa
        )
        return acks.copy_(new), n_ack
    return accum_acks_cuda(
        acks, cur_batch, acc_ballot, acc_vid, learned, ballot, amatch_pa
    )


def bytes_per_launch(kernel: str, a: int, p: int, i: int) -> int:
    """Bytes one launch must move: each input read once, each output
    written once (the roofline count)."""
    if kernel == "store_accepts":
        # acc_ballot, learned, abat in; acc_ballot, acc_vid out (the
        # in-place store never reads acc_vid)
        return i * (2 * 4 * a + 4 * p + 2 * 4 * a) + 4 * p + p * a
    if kernel == "accum_acks":
        # acks, cur_batch, acc_* and learned in; acks, n_ack out
        return i * (p * a + 4 * p + 3 * 4 * a + p * a + 4 * p) + 4 * p + p * a
    raise ValueError(kernel)
