"""Learner execution frontier (port of ``tpu_paxos/core/apply.py``).

An instance is applicable when every instance at or below it is
learned, so a node's frontier is the length of its leading all-learned
prefix (ref multi/paxos.cpp:1584-1620 walks ``next_id_to_apply_``).
``frontier``/``frontiers`` compute it on the device as the sum of a
``cumprod`` (int32, as JAX's); the host side gives the executed
sequences that ``harness/validate`` checks.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_paxos_torch.core import values as val


def frontier(learned_col) -> torch.Tensor:
    """Index of the first unlearned instance for one node's learner state
    ``learned_col`` [I] (vid or NONE): everything below it is applicable."""
    known = (torch.as_tensor(learned_col) != val.NONE).to(torch.int32)
    return torch.cumprod(known, 0).sum(dtype=torch.int32)


def frontiers(learned) -> torch.Tensor:
    """Per-node frontiers for learned [I, A]."""
    known = (torch.as_tensor(learned) != val.NONE).to(torch.int32)
    return torch.cumprod(known, 0).sum(0, dtype=torch.int32)


def executed_sequence(learned_col: np.ndarray) -> np.ndarray:
    """The non-no-op vids a node's state machine executes, in instance
    order up to its frontier (no-ops skipped, ref
    multi/paxos.cpp:1598-1599)."""
    learned_col = np.asarray(learned_col)
    unknown = np.flatnonzero(learned_col == val.NONE)
    f = int(unknown[0]) if unknown.size else learned_col.shape[0]
    prefix = learned_col[:f]
    return prefix[prefix >= 0]


def executed_sequences(learned: np.ndarray) -> list[np.ndarray]:
    return [executed_sequence(learned[:, a]) for a in range(learned.shape[1])]
