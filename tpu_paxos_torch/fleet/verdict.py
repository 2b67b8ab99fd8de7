"""On-device per-lane verdicts: the invariant subset that decides which
lanes pay a host transfer (port of ``tpu_paxos/fleet/verdict.py``).

The full invariant suite (``harness/validate``) is host numpy over the
whole learned matrix.  A fleet instead reduces a subset of the
invariants to one boolean per lane on the device, so only the ``[L]``
verdict vectors move to the host:

- **agreement**: no two nodes learned different values for one
  instance;
- **chosen-coverage**: every workload value whose proposer survived was
  chosen (a crashed proposer's undrained queue is legitimately lost);
- **quiescence-by-budget**: the engine's ``done`` held within the round
  budget, excused only when every proposer crashed.

``max_round`` is the latest decision round of each lane (-1: none).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_paxos_torch.config import SimConfig
from tpu_paxos_torch.core import sim as simm
from tpu_paxos_torch.core import values as val


class LaneVerdict(NamedTuple):
    """Per-lane verdict vectors, ``[L]`` each."""

    ok: object  # every subset invariant green
    agreement: object
    coverage: object
    quiescent: object
    rounds: object  # int32 rounds simulated
    max_round: object  # int32 latest decision round (-1: none)


def expected_owners(
    cfg: SimConfig, workload: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """``(expected [V] int32, owner_node [V] int32)``: the distinct
    workload vids and, per vid, the NODE of the proposer that queues it
    (the crash-excusal key); a vid queued twice is owned by the first
    proposer that queues it."""
    vids = [np.asarray(w, np.int32).reshape(-1) for w in workload]
    owners = [np.full(len(v), cfg.proposers[pi], np.int32) for pi, v in enumerate(vids)]
    vids = np.concatenate(vids) if vids else np.zeros((0,), np.int32)
    owners = np.concatenate(owners) if owners else np.zeros((0,), np.int32)
    order = np.argsort(vids, kind="stable")
    vids, owners = vids[order], owners[order]
    uniq, first = np.unique(vids, return_index=True)
    return uniq.astype(np.int32), owners[first].astype(np.int32)


def lane_verdict(
    cfg: SimConfig,
    final: simm.SimState,
    expected: torch.Tensor,
    owner_node: torch.Tensor,
    vid_cap: int,
    geom=None,
) -> LaneVerdict:
    """Judge lane-stacked final states on their device: ``final``'s
    leaves are ``[L, ...]``, ``expected``/``owner_node`` ``[L, V]`` int32
    tables (slots padded with -1 expected are vacuously covered), and
    ``vid_cap`` the bitmap bound of the vid space.  ``geom`` (a
    ``core.geom.Geometry``) is a padded dispatch's true geometry: only
    its true proposers can excuse a lane that is not quiescent.  Returns
    ``[L]`` tensors on the device."""
    learned = final.learned  # [L, A, I]
    lanes = learned.shape[0]
    known = learned != val.NONE
    # agreement: every knowing node matches the max over knowing nodes
    best = torch.where(known, learned, torch.iinfo(torch.int32).min).amax(dim=1)
    agreement = ~(known & (learned != best[:, None])).reshape(lanes, -1).any(dim=1)

    # coverage through a chosen-membership bitmap per lane; chosen vids
    # outside [0, vid_cap) land in a spill slot that is cut off
    chosen = final.met.chosen_vid  # [L, I]
    slot = torch.where((chosen >= 0) & (chosen < vid_cap), chosen, vid_cap).long()
    bitmap = torch.zeros((lanes, vid_cap + 1), dtype=torch.bool, device=chosen.device)
    bitmap.scatter_(1, slot, torch.ones_like(slot, dtype=torch.bool))
    exp = expected.to(torch.int64)
    valid = exp >= 0  # False = table padding, vacuously covered
    owner_crashed = final.crashed.gather(1, owner_node.to(torch.int64).clamp(0, cfg.n_nodes - 1))
    covered = bitmap.gather(1, exp.clamp(0, vid_cap - 1))
    coverage = (~valid | covered | owner_crashed).all(dim=1)

    if geom is None:
        pn = torch.tensor(cfg.proposers, dtype=torch.int64, device=chosen.device)
        all_props_crashed = final.crashed[:, pn].all(dim=1)
    else:
        # pad proposer slots read node 0 through pn's padding: they count
        # as crashed, so only true proposers can excuse the lane
        pn = torch.as_tensor(np.asarray(geom.pn, np.int64), device=chosen.device)
        pad = torch.as_tensor(~np.asarray(geom.prop_mask, bool), device=chosen.device)
        all_props_crashed = (final.crashed[:, pn] | pad).all(dim=1)
    quiescent = final.done | all_props_crashed

    max_round = torch.where(
        chosen != val.NONE, final.met.chosen_round, -1
    ).amax(dim=1)
    ok = agreement & coverage & quiescent
    return LaneVerdict(
        ok=ok,
        agreement=agreement,
        coverage=coverage,
        quiescent=quiescent,
        rounds=final.t,
        max_round=max_round,
    )
