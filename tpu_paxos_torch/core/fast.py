"""Fast path: fault-free batched multi-Paxos as fused tensor ops (port
of ``tpu_paxos/core/fast.py``).

One prepared proposer drives every instance through one batched
prepare (ref multi/paxos.cpp:809-828), one batched accept (ref
multi/paxos.cpp:1299-1326) and one batched commit (ref
multi/paxos.cpp:1446-1479): with a reliable network each phase is one
tensor op over the ``[nodes, instances]`` state.

Layout: arrays are [A, I], nodes major and instances minor, as in the
JAX package, so a state crosses between the two packages unchanged
(``interop.fast_state_from_jax``).  Host-side consumers (the
validators) take [I, A]: :func:`learned_ia` transposes once.

Protocol semantics (the JAX module documents each anchor):

- promise iff ballot strictly greater than ``promised`` (one scalar per
  acceptor covering all instances), ref multi/paxos.cpp:865;
- prepare replies carry pre-accepted values, adopted by max accepted
  ballot as two masked-max passes (ties across acceptors carry the same
  value), ref multi/paxos.cpp:1201-1223;
- accept iff ballot >= promised, ref multi/paxos.cpp:1366;
- quorum is n//2 + 1, ref multi/paxos.cpp:1047;
- chosen values are broadcast to every node's learner state.

Every count is an int32 sum (torch sums bools and ints to int64; JAX
to int32).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_paxos_torch.core import ballot as bal
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.utils import device as devm

_NEG = -(2**31)  # int32 min: the masked-max identity
_I32 = torch.int32


class FastState(NamedTuple):
    """SoA consensus state, shapes [A] / [A, I] (instances minor)."""

    promised: torch.Tensor  # [A] int32 per-acceptor promised ballot
    max_seen: torch.Tensor  # [A] int32 max ballot ever seen
    acc_ballot: torch.Tensor  # [A, I] int32 accepted ballot (-1 none)
    acc_vid: torch.Tensor  # [A, I] int32 accepted value id (-1 none)
    learned: torch.Tensor  # [A, I] int32 chosen vid known to node a (-1)


def init_state(n_instances: int, n_nodes: int, device="cuda") -> FastState:
    dev = devm.resolve(device)
    i, a = n_instances, n_nodes
    return FastState(
        promised=torch.zeros((a,), dtype=_I32, device=dev),
        max_seen=torch.zeros((a,), dtype=_I32, device=dev),
        acc_ballot=torch.full((a, i), bal.NONE, dtype=_I32, device=dev),
        acc_vid=torch.full((a, i), val.NONE, dtype=_I32, device=dev),
        learned=torch.full((a, i), val.NONE, dtype=_I32, device=dev),
    )


def learned_ia(state: FastState) -> np.ndarray:
    """Host-boundary view in the validators' [I, A] convention."""
    return state.learned.cpu().numpy().T


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_I32, device=like.device)


def phase1_prepare(state: FastState, ballot, quorum: int, adopt: bool = True):
    """Broadcast prepare; collect promises and pre-accepted values.

    Returns (state, prepared, adopted_ballot [I], adopted_vid [I]):
    ``prepared`` is the quorum bool (a 0-d tensor); adopted_* is the
    max-ballot pre-accepted value per instance over promising acceptors
    (NONE where no acceptor reported one).  ``adopt=False`` skips the
    two [A, I] adoption passes and returns None for both, for callers
    that drop them (the steady-state windows, where XLA's dead-code
    elimination does the same to the JAX twin).
    """
    ballot = _scalar(ballot, state.promised)
    promise = ballot > state.promised  # strict >, ref multi/paxos.cpp:865
    promised = torch.where(promise, ballot, state.promised)
    max_seen = torch.maximum(state.max_seen, ballot)
    prepared = promise.sum(dtype=_I32) >= quorum
    state = state._replace(promised=promised, max_seen=max_seen)
    if not adopt:
        return state, prepared, None, None

    # Adoption: among promising acceptors, the value with the largest
    # accepted ballot — two masked-max passes over the node axis.
    rep_ballot = torch.where(promise[:, None], state.acc_ballot, bal.NONE)
    best = rep_ballot.amax(dim=0)  # [I]
    has = best > 0
    adopted_vid_raw = torch.where(
        rep_ballot == best[None, :], state.acc_vid, _NEG
    ).amax(dim=0)
    adopted_ballot = torch.where(has, best, bal.NONE)
    adopted_vid = torch.where(has, adopted_vid_raw, val.NONE)
    return state, prepared, adopted_ballot, adopted_vid


def phase2_accept(state: FastState, ballot, vids: torch.Tensor, quorum: int):
    """Broadcast one batched accept of ``vids`` [I]; count acks.

    Returns (state, chosen): the whole batch is accepted or rejected per
    acceptor (ref multi/paxos.cpp:1359-1397), so the quorum decision is
    per batch (a 0-d bool tensor)."""
    ballot = _scalar(ballot, state.promised)
    ok = ballot >= state.promised  # >=, ref multi/paxos.cpp:1366
    max_seen = torch.maximum(state.max_seen, ballot)
    store = ok[:, None] & (vids != val.NONE)[None, :]
    acc_ballot = torch.where(store, ballot, state.acc_ballot)
    acc_vid = torch.where(store, vids[None, :], state.acc_vid)
    chosen = ok.sum(dtype=_I32) >= quorum
    return state._replace(
        max_seen=max_seen, acc_ballot=acc_ballot, acc_vid=acc_vid
    ), chosen


def phase3_learn(state: FastState, vids: torch.Tensor, chosen) -> FastState:
    """Broadcast commit of chosen ``vids`` to every node's learner
    (ref multi/paxos.cpp:1446-1518)."""
    learn = torch.as_tensor(chosen, device=vids.device) & (vids != val.NONE)
    learned = torch.where(learn[None, :], vids[None, :], state.learned)
    return state._replace(learned=learned)


def choose_all(
    state: FastState, vids: torch.Tensor, proposer: int, quorum: int
) -> tuple[FastState, torch.Tensor]:
    """Drive every instance with a value to chosen: the prepare ->
    accept -> commit pipeline of one prepared proposer.

    Returns (state, n_chosen) with ``n_chosen`` an int32 0-d tensor."""
    zero = _scalar(0, state.max_seen)
    _, ballot = bal.bump_past(zero, _scalar(proposer, zero), state.max_seen.amax())
    state, prepared, adopted_ballot, adopted_vid = phase1_prepare(
        state, ballot, quorum
    )
    # Pre-accepted values win over our own proposals for their
    # instances (ref multi/paxos.cpp:1078-1101).
    use_adopted = adopted_ballot != bal.NONE
    batch = torch.where(use_adopted, adopted_vid, vids)
    batch = torch.where(prepared, batch, val.NONE)
    state, chosen = phase2_accept(state, ballot, batch, quorum)
    state = phase3_learn(state, batch, chosen)
    n_chosen = (state.learned[0] != val.NONE).sum(dtype=_I32)
    return state, n_chosen


def audit_entries():
    """The fast path's registered entry point (``analysis/registry.py``),
    JAX's canonical call: 16 instances, 3 acceptors, proposer 0, quorum
    2.  The fast path is plain PyTorch: it launches no hand kernel and
    reads nothing to the host, which the audit pins."""
    from tpu_paxos_torch.analysis.registry import AuditEntry

    def build(device):
        n, a = 16, 3
        state = init_state(n, a, device=device)
        vids = torch.arange(n, dtype=_I32, device=state.learned.device)

        def fn(state, vids):
            return choose_all(state, vids, proposer=0, quorum=2)

        return fn, (state, vids)

    return [AuditEntry("fast.choose_all", build)]
