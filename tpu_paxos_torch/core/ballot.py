"""Ballot (proposal id) encoding and bumping (port of
``tpu_paxos/core/ballot.py``).

A ballot is ``(count << 16) | node_index`` (ref multi/paxos.cpp:792-799
``UpdateProposalID``): the node index in the low bits makes ballots
globally unique and totally ordered.  Pure int32 tensor arithmetic.
"""

from __future__ import annotations

import torch

NODE_BITS = 16
NONE = -1  # "no ballot" sentinel (valid ballots are > 0)


def make(count: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """Ballot from (count, node): ``(count << 16) | node``."""
    return (count.to(torch.int32) << NODE_BITS) | node.to(torch.int32)


def count_of(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32) >> NODE_BITS


def node_of(b) -> torch.Tensor:
    return torch.as_tensor(b).to(torch.int32) & ((1 << NODE_BITS) - 1)


def bump_past(count: torch.Tensor, node: torch.Tensor, max_seen: torch.Tensor):
    """Smallest (new_count, ballot) with new_count > count and
    ballot > max_seen — the closed form of the reference's
    ``while (proposal_id_ < max_proposal_id_) ++proposal_count_``."""
    floor_count = torch.maximum(count + 1, count_of(max_seen))
    cand = make(floor_count, node)
    new_count = torch.where(cand > max_seen, floor_count, floor_count + 1)
    return new_count, make(new_count, node)
