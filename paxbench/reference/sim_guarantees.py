"""The plain reference for the general engine's cells: each run's decision
log held to the guarantees the configuration states.

A general-engine run is a randomized simulation, so no second engine can
give the same decisions; what every correct run owes is its guarantees
(the reference's own correctness baseline, ``multi/main.cpp:567-573``:
every replica executes the same sequence, and the executed ids are
exactly the workload).  This module checks one run's output against the
workload the benchmark made, in NumPy, and returns how many cells break
each guarantee:

- ``agreement``: a node learned a value other than the one chosen for
  that instance;
- ``unlearned``: at quiescence a node has not learned a chosen instance,
  or learned one where nothing was chosen (every replica's log equals the
  decision log);
- ``holes``: an undecided instance below the highest decided one (the
  decision log is a contiguous prefix at quiescence);
- ``validity``: a chosen value that is neither a workload value nor a
  no-op filled by one of the proposers for that very instance;
- ``duplicates``: a workload value chosen at more than one instance;
- ``missing``: a workload value never chosen;
- ``not_done``: the run did not quiesce within its round budget.

Every count is exact, so every limit is 0.  Imports NumPy only.
"""

from __future__ import annotations

import numpy as np

NONE = -1
NOOP_BASE = -2

GUARANTEES = ("agreement", "unlearned", "holes", "validity", "duplicates",
              "missing", "not_done")


def check_run(learned: np.ndarray, chosen: np.ndarray, done: bool,
              workload: list, proposers, n_instances: int) -> dict:
    """Violations of each guarantee in one run.  ``learned`` is the
    run's ``[I, A]`` learner state (any layout), ``chosen`` its ``[I]``
    decision log, ``workload[p]`` the values proposer ``p`` was given,
    ``proposers`` the proposing nodes in the order of ``workload``."""
    learned = np.asarray(learned)
    chosen = np.asarray(chosen)
    n, a = learned.shape
    if n != n_instances or chosen.shape != (n_instances,):
        raise ValueError(f"result shapes {learned.shape} / {chosen.shape} "
                         f"do not hold {n_instances} instances")
    out = dict.fromkeys(GUARANTEES, 0)
    decided = chosen != NONE
    for node in range(a):  # a node at a time: one [I] temporary
        row = learned[:, node]
        out["agreement"] += int(np.count_nonzero((row != NONE) & (row != chosen)))
        out["unlearned"] += int(np.count_nonzero((row == NONE) == decided))
    top = int(np.flatnonzero(decided)[-1]) if decided.any() else -1
    out["holes"] = int(np.count_nonzero(~decided[:top + 1]))

    expected = np.concatenate([np.asarray(w, np.int64).reshape(-1) for w in workload])
    real = chosen >= 0
    span = int(max(expected.max(initial=0), chosen.max(initial=0))) + 1
    in_workload = np.zeros(span, bool)
    in_workload[expected] = True
    real_vids = chosen[real].astype(np.int64)
    out["validity"] = int(np.count_nonzero(~in_workload[real_vids]))
    noop = chosen <= NOOP_BASE
    k = NOOP_BASE - chosen[noop].astype(np.int64)
    where = np.flatnonzero(noop)
    own = np.isin(k // n_instances, np.asarray(proposers, np.int64)) & (k % n_instances == where)
    out["validity"] += int(np.count_nonzero(~own))
    times = np.bincount(real_vids, minlength=span)
    out["duplicates"] = int(np.count_nonzero(times > 1))
    out["missing"] = int(np.count_nonzero(times[expected] == 0))
    out["not_done"] = 0 if done else 1
    return out
