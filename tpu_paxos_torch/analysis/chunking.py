"""The port's own copy of ``tpu_paxos/analysis/chunking.py``:
fixed-width lane chunking.

The greedy shrinker's batched candidate evaluator
(``harness/shrink._runtime_batch_eval``) dispatches its work-list as
fleet lanes, every dispatch with IDENTICAL lane shapes.  This module
holds the padding rule; it is pure stdlib and imports nothing.
"""

from __future__ import annotations


def chunk_pad(items: list, lanes: int) -> list[tuple[list, int]]:
    """Split ``items`` into fixed-width chunks, padding the last by
    repeating its final item, so EVERY dispatch has identical lane
    shapes (one executable).  Returns ``[(padded_chunk, n_real),
    ...]``; padding lanes' results must be ignored."""
    if lanes < 1:
        raise ValueError("lanes must be >= 1")
    out = []
    for i in range(0, len(items), lanes):
        chunk = list(items[i:i + lanes])
        n_real = len(chunk)
        chunk.extend(chunk[-1:] * (lanes - n_real))
        out.append((chunk, n_real))
    return out
