"""The stress sweep's workload and fault mixes (port of the data of
``tpu_paxos/harness/stress.py``): the per-proposer gated workload the
fleet runs, and the episode and WAN mixes of 5-node clusters.  The sweep
itself (``sweep_fleet``) waits for the flight recorder."""

from __future__ import annotations

import numpy as np

from tpu_paxos_torch.core import faults as flt
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.core import wan as wanm

# Correlated-fault schedules for the episode mixes (5-node clusters).
SCHED_PARTITION_FLAP = flt.FaultSchedule((
    flt.partition(6, 26, (0, 1), (2, 3, 4)),
    flt.partition(40, 62, (0, 2, 4), (1, 3)),
    flt.partition(76, 96, (1, 4), (0, 2, 3)),
))
SCHED_ONE_WAY = flt.FaultSchedule((
    flt.one_way(5, 30, (0,), (2, 3)),
    flt.one_way(22, 48, (3, 4), (0,)),
    flt.one_way(60, 80, (1,), (2, 3, 4)),
))
SCHED_PAUSE_HEAVY = flt.FaultSchedule((
    flt.pause(4, 26, 1),
    flt.pause(18, 44, 3),
    flt.pause(34, 58, 4),
    flt.burst(10, 30, 2500),
))
SCHED_PAUSE_CRASH = flt.FaultSchedule((
    flt.pause(6, 30, 1),
    flt.pause(36, 60, 2),
))

# Fault mixes: (label, FaultConfig kwargs, n_nodes, n_proposers).
MIXES = [
    ("clean", dict(), 3, 1),
    ("debug.conf", dict(drop_rate=500, dup_rate=1000, max_delay=2), 5, 2),
    ("lossy", dict(drop_rate=2000, dup_rate=500, max_delay=4), 5, 2),
    ("duel-heavy", dict(drop_rate=1000, dup_rate=2000, max_delay=3), 5, 3),
    (
        "crashy",
        dict(drop_rate=500, dup_rate=1000, max_delay=2, crash_rate=4000),
        5,
        2,
    ),
    (
        "delay-heavy",
        dict(drop_rate=200, dup_rate=200, min_delay=1, max_delay=6),
        7,
        2,
    ),
    (
        "partition-flap",
        dict(drop_rate=300, dup_rate=500, max_delay=2, schedule=SCHED_PARTITION_FLAP),
        5,
        2,
    ),
    (
        "one-way",
        dict(drop_rate=300, dup_rate=500, max_delay=2, schedule=SCHED_ONE_WAY),
        5,
        2,
    ),
    (
        "pause-heavy",
        dict(drop_rate=200, dup_rate=500, max_delay=2, schedule=SCHED_PAUSE_HEAVY),
        5,
        2,
    ),
    (
        "pause-crash",
        dict(
            drop_rate=500, dup_rate=1000, max_delay=2, crash_rate=3000,
            schedule=SCHED_PAUSE_CRASH,
        ),
        5,
        2,
    ),
]
EPISODE_MIXES = [m for m in MIXES if "schedule" in m[1]]

SCHED_WAN_GRAY = flt.FaultSchedule((
    flt.gray(8, 40, 2, delay=3),
    flt.one_way(20, 48, (2,), (0, 1)),
))
SCHED_WAN5_GRAY = flt.FaultSchedule((
    flt.gray(6, 36, 3, 4, delay=2),
    flt.partition(24, 44, (0, 1, 2), (3, 4)),
))
WAN_MIXES = [
    (
        "wan-3region",
        dict(
            max_delay=wanm.PRESET_DELAY_BOUND,
            edges=wanm.edge_faults(wanm.WAN3, 5),
            schedule=SCHED_WAN_GRAY,
        ),
        5,
        2,
    ),
    (
        "wan-5region",
        dict(
            max_delay=wanm.PRESET_DELAY_BOUND,
            edges=wanm.edge_faults(wanm.WAN5, 5),
            schedule=SCHED_WAN5_GRAY,
        ),
        5,
        2,
    ),
]

N_IDS = 6  # ids per client chain (gated, in-order)
N_FREE = 8  # ungated values per proposer


def _workload(
    n_prop: int,
    rng: np.random.Generator,
    n_ids: int = N_IDS,
    n_free: int = N_FREE,
):
    """Per-proposer workload: one in-order gate chain + free values,
    with globally unique vids.  Returns (workload, gates, chains)."""
    workload, gates, chains = [], [], []
    nxt = 100
    for _ in range(n_prop):
        chain = np.arange(nxt, nxt + n_ids, dtype=np.int32)
        nxt += n_ids
        free = np.arange(nxt, nxt + n_free, dtype=np.int32)
        nxt += n_free
        rng.shuffle(free)
        w = np.concatenate([chain, free])
        g = np.concatenate(
            [
                np.asarray([int(val.NONE)] + chain[:-1].tolist(), np.int32),
                np.full(n_free, int(val.NONE), np.int32),
            ]
        )
        workload.append(w)
        gates.append(g)
        chains.append(chain)
    return workload, gates, chains
