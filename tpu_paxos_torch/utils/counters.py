"""Per-round work counters: what a round of the port's engines costs in
kernel calls, rounds and designed host reads, counted alike on every
device (``analysis/audit.py`` reads them).  Kernel launches are not
counted here: the wrappers count them in ``core/simkern.LAUNCHES`` (a
mesh rank's in its own dict, ``simkern.counting``) and
``core/fastwin.LAUNCHES``.

- ``rounds``: calls of a round function over its lanes (``core/sim`` and
  ``membership/engine``'s ``round_fn.lanes``; a mesh rank's call counts
  once for the rank);
- ``store_accepts`` / ``accum_acks``: calls of the ``core/simkern``
  dispatchers, on the CPU (plain version) as on a card (one kernel
  launch each);
- ``steady_state_windows``: windows asked of
  ``core/fastwin.steady_state_windows_fused`` (one kernel launch a
  window on a card);
- ``host_reads``: the engines' designed device-to-host reads (a round's
  packed predicate reads, a loop's done/round read, a dispatch's
  harvest), which the port makes on purpose and the same on both
  devices;
- ``collectives``: a mesh rank's collectives
  (``parallel/mesh.Collectives.exchange``), summed over ranks.

The counts are process-global (a mesh's rank threads add to them under
one lock); :func:`reset` zeroes them and :func:`snapshot` copies them.
Pure stdlib: the counting costs one locked add a site.
"""

from __future__ import annotations

import threading

#: The hand kernels, by the name their dispatcher counts calls under.
KERNELS = ("store_accepts", "accum_acks", "steady_state_windows")

NAMES = ("rounds", *KERNELS, "host_reads", "collectives")

COUNTS: dict[str, int] = {name: 0 for name in NAMES}

_LOCK = threading.Lock()


def add(name: str, n: int = 1) -> None:
    with _LOCK:
        COUNTS[name] += n


def reset() -> None:
    with _LOCK:
        for name in NAMES:
            COUNTS[name] = 0


def snapshot() -> dict[str, int]:
    with _LOCK:
        return dict(COUNTS)
