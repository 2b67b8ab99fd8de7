"""The plain reference for the fast path's cells: the same Paxos steps on
the same inputs, written out in plain PyTorch (or on the CPU, NumPy-like
torch), from the reference's own reading of the protocol.

A step of either cell starts with one proposer's prepare.  The per-acceptor
part of a step is scalar (one promised ballot per acceptor covers every
instance), so the reference follows it in Python integers; the
per-instance part it computes on columns of the ``[A, I]`` arrays.

- promise iff ballot > promised (``multi/paxos.cpp:865``), quorum
  ``n // 2 + 1`` (``:1047``);
- a prepared proposer adopts, per instance, the value accepted at the
  highest ballot among the promising acceptors (``:1201-1223``), else
  proposes its own;
- accept iff ballot >= promised (``:1366``); a batch is chosen when a
  quorum accepts it; a chosen value is learned by every node
  (``:1446-1479``).

``steady_*``: each step is ``reps`` windows of I fresh instances with
sequential vids (window ``k`` proposes ``k * I + i``); every window
overwrites the three ``[A, I]`` arrays, so the last window of the last
step fixes them, and an earlier window is read as it ends.  ``takeover_*``: each step is a whole-log takeover by
the next proposer of the cycle; the arrays carry from step to step.

Nothing here imports the program: the benchmark hands the same inputs to
both sides and the reference works everything else out again.
"""

from __future__ import annotations

import torch

from paxbench.yardstick import NONE, bump_past

_I32 = torch.int32


class Scalars:
    """The per-acceptor state of a fast-path run, in Python integers."""

    def __init__(self, promised, max_seen, quorum: int):
        self.promised = [int(x) for x in promised]
        self.max_seen = [int(x) for x in max_seen]
        self.quorum = quorum

    def prepare(self, node: int):
        """Phase 1 of ``node``'s new ballot: ``(ballot, promise mask,
        prepared)``."""
        ballot = bump_past(0, node, max(self.max_seen))
        promise = [ballot > p for p in self.promised]
        self.promised = [ballot if ok else p for ok, p in zip(promise, self.promised)]
        self.max_seen = [max(m, ballot) for m in self.max_seen]
        return ballot, promise, sum(promise) >= self.quorum

    def accept(self, ballot: int):
        """Phase 2's per-acceptor verdict: ``(ok mask, chosen)``."""
        ok = [ballot >= p for p in self.promised]
        self.max_seen = [max(m, ballot) for m in self.max_seen]
        return ok, sum(ok) >= self.quorum


# ---------------------------------------------------------------- steady


def steady_expected(max_seen0, n_steps: int, reps: int, quorum: int):
    """The scalars after ``n_steps`` steps of ``reps`` windows, and each
    window's ``(ballot, ok, prepared, chosen)`` verdicts in order.
    Proposer 0 prepares once a step; every window of a step accepts at
    that step's ballot."""
    sc = Scalars(max_seen0, max_seen0, quorum)
    verdicts = []
    for _ in range(n_steps):
        ballot, _, prepared = sc.prepare(0)
        ok, chosen = sc.accept(ballot)
        verdicts.extend([(ballot, ok, prepared, chosen)] * reps)
    return sc, verdicts


def steady_counts(verdicts, n_instances: int) -> list:
    """Each window's chosen count: the vids of a prepared proposer are
    never NONE, so a chosen window decides every instance."""
    return [n_instances if (prepared and chosen) else 0
            for _, _, prepared, chosen in verdicts]


def steady_window(verdict, k: int, n_instances: int, cols):
    """Columns ``cols`` (int64 instance indices) of ``(acc_ballot,
    acc_vid, learned)`` after window ``k`` of a step with ``verdict``:
    the accept and learn of vids ``k * I + i`` over a recycled window."""
    ballot, ok, prepared, chosen = verdict
    device = cols.device
    none = torch.tensor(NONE, dtype=_I32, device=device)
    if prepared:
        vid = (cols + k * n_instances).to(_I32)
    else:
        vid = torch.full(cols.shape, NONE, dtype=_I32, device=device)
    store = torch.tensor(ok, device=device)[:, None] & (vid != NONE)[None, :]
    acc_ballot = torch.where(store, torch.tensor(ballot, dtype=_I32, device=device), none)
    acc_vid = torch.where(store, vid[None, :], none)
    learned = torch.where((vid != NONE) & chosen, vid, none)
    return acc_ballot, acc_vid, learned[None, :].expand(len(ok), -1)


# ---------------------------------------------------------------- takeover


def takeover_step(sc: Scalars, node: int, acc_ballot, acc_vid, learned, vids):
    """One whole-log takeover by ``node`` on columns of the arrays:
    returns the new ``(acc_ballot, acc_vid, learned)`` and whether a
    batch was decided (prepared, then chosen by a quorum)."""
    ballot, promise, prepared = sc.prepare(node)
    prom = torch.tensor(promise, device=acc_ballot.device)[:, None]
    reported = torch.where(prom, acc_ballot, NONE)
    best = reported.amax(dim=0)
    at_best = reported == best[None, :]
    # ties at one ballot carry one value; the largest vid stands for them
    best_vid = torch.where(at_best, acc_vid, torch.iinfo(torch.int32).min).amax(dim=0)
    adopted = best > 0
    batch = torch.where(adopted, best_vid, vids)
    if not prepared:
        batch = torch.full_like(batch, NONE)
    ok, chosen = sc.accept(ballot)
    store = torch.tensor(ok, device=acc_ballot.device)[:, None] & (batch != NONE)[None, :]
    acc_ballot = torch.where(store, torch.tensor(ballot, dtype=_I32, device=acc_ballot.device),
                             acc_ballot)
    acc_vid = torch.where(store, batch[None, :], acc_vid)
    learn = (batch != NONE) & chosen
    learned = torch.where(learn[None, :], batch[None, :], learned)
    return acc_ballot, acc_vid, learned, prepared and chosen
