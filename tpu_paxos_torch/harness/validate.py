"""Whole-run invariants (port of ``tpu_paxos/harness/validate.py``).

The reference harness asserts at end of run that every replica executed
the identical sequence and that the multiset of executed ids is exactly
the proposed set — agreement + exactly-once (ref
multi/main.cpp:567-573); its state machine checks that in-order
clients' ids execute in order (ref multi/main.cpp:202-212).

Arrays of ``>= 1 << 16`` cells go through ``tpu_paxos_torch.native``'s
single-pass C++ scans, as the JAX package routes them; a failed native
build raises.  The numpy versions below are the plain versions the tests
hold the native scans against.
"""

from __future__ import annotations

import numpy as np

from tpu_paxos_torch.core import apply as apl
from tpu_paxos_torch.core import values as val


class InvariantViolation(AssertionError):
    pass


def _fail(msg: str) -> None:
    raise InvariantViolation(msg)


#: Arrays of at least this many cells go through ``native`` (below it
#: the numpy and ctypes overheads wash out).
_NATIVE_MIN_CELLS = 1 << 16


def _use_native(learned: np.ndarray) -> bool:
    return learned.size >= _NATIVE_MIN_CELLS


def _chosen_per_instance(learned: np.ndarray) -> np.ndarray:
    """Per instance: the vid learned by any knowing node, or NONE where
    no node knows a value: the max over knowing nodes in numpy, the first
    knowing node's on the native path (equal wherever the nodes agree)."""
    learned = np.asarray(learned)
    if _use_native(learned):
        from tpu_paxos_torch import native

        return native.chosen_per_instance(learned)
    known = learned != val.NONE
    best = np.where(known, learned, np.iinfo(np.int32).min).max(axis=1)
    return np.where(known.any(axis=1), best, val.NONE)


def check_agreement(learned: np.ndarray) -> None:
    """No two nodes learned different values for the same instance."""
    learned = np.asarray(learned)
    if _use_native(learned):
        from tpu_paxos_torch import native

        bad_i = native.check_agreement(learned)
        if bad_i is not None:
            _fail(f"agreement violated at instance {bad_i}: nodes learned "
                  f"{learned[bad_i].tolist()}")
        return
    known = learned != val.NONE
    ref_col = _chosen_per_instance(learned)
    bad = (known & (learned != ref_col[:, None])).any(axis=1)
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        _fail(f"agreement violated at instance {i}: nodes learned {learned[i].tolist()}")


def check_exactly_once(learned: np.ndarray, expected_vids: np.ndarray | None = None) -> None:
    """Every real value is chosen at most once, and — when the expected
    proposal set is given — each expected value exactly once.

    Run :func:`check_agreement` first: on an array whose nodes disagree,
    the per-instance value differs between the numpy path (max over
    knowing nodes) and the native path (first knowing node), which arrays
    of ``_NATIVE_MIN_CELLS`` cells or more take, so the verdict of this
    check alone can then depend on the array's size."""
    chosen = _chosen_per_instance(learned)
    if _use_native(np.asarray(learned)):
        from tpu_paxos_torch import native

        dup = native.check_unique(chosen)
        if dup is not None:
            _fail(f"value {dup} chosen for more than one instance")
        if expected_vids is None:
            return
        uniq = np.unique(chosen[chosen >= 0])
    else:
        real = chosen[chosen >= 0]
        uniq, counts = np.unique(real, return_counts=True)
        if (counts > 1).any():
            v = int(uniq[np.flatnonzero(counts > 1)[0]])
            _fail(f"value {v} chosen for more than one instance")
    if expected_vids is not None:
        expected = np.unique(np.asarray(expected_vids))
        missing = np.setdiff1d(expected, uniq)
        extra = np.setdiff1d(uniq, expected)
        if missing.size:
            _fail(f"values never chosen: {missing[:10].tolist()}...")
        if extra.size:
            _fail(f"unexpected values chosen: {extra[:10].tolist()}...")


def check_executed_identical(learned: np.ndarray) -> list[np.ndarray]:
    """All replicas execute the same sequence over their applied
    prefixes (shorter prefixes must be prefixes of longer ones)."""
    seqs = apl.executed_sequences(np.asarray(learned))
    longest = max(seqs, key=len)
    for a, s in enumerate(seqs):
        if not np.array_equal(s, longest[: len(s)]):
            _fail(f"node {a} executed sequence diverges from longest prefix")
    return seqs


def check_in_order_clients(executed: np.ndarray, in_order_vids: list[np.ndarray]) -> None:
    """Per in-order client: its values appear in the executed sequence
    in proposal order."""
    executed = np.asarray(executed)
    pos = {int(v): i for i, v in enumerate(executed)}
    for c, vids in enumerate(in_order_vids):
        last = -1
        for v in vids:
            p = pos.get(int(v))
            if p is None:
                _fail(f"in-order client {c}: value {int(v)} never executed")
            if p < last:
                _fail(f"in-order client {c}: value {int(v)} executed out of order")
            last = p


def check_prefix_consistency(logs: list[np.ndarray]) -> None:
    """member/ validation: every node's applied log is a prefix of the
    longest one (ref member/main.cpp:260-265 checks against node 0; the
    longest is the same invariant without privileging a node)."""
    longest = max(logs, key=len)
    for a, s in enumerate(logs):
        if not np.array_equal(np.asarray(s), np.asarray(longest)[: len(s)]):
            _fail(f"node {a} applied log is not a prefix of the longest log")


def check_all(learned: np.ndarray, expected_vids: np.ndarray | None = None) -> list[np.ndarray]:
    check_agreement(learned)
    check_exactly_once(learned, expected_vids)
    return check_executed_identical(learned)
