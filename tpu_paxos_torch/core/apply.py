"""Learner execution frontier (port of ``tpu_paxos/core/apply.py``).

An instance is applicable when every instance at or below it is
learned, so a node's frontier is the length of its leading all-learned
prefix (ref multi/paxos.cpp:1584-1620 walks ``next_id_to_apply_``).
The port needs only the host side: the executed sequences that
``harness/validate`` checks.
"""

from __future__ import annotations

import numpy as np

from tpu_paxos_torch.core import values as val


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
