"""Runtime fault-schedule encoding: episodes as dense arrays (port of
``tpu_paxos/fleet/schedule_table.py``).

``core/faults.compile_schedule`` lowers one schedule to per-round
tables for a single run.  A fleet runs a different schedule in every
lane, so here a schedule becomes a :class:`ScheduleTable` of
per-EPISODE arrays (interval bounds ``t0``/``t1`` and the episode's
static masks from ``faults.episode_tables``), padded to a fixed episode
capacity and stacked along a leading lane axis (:func:`encode_batch`).
The per-round masks are computed from it (:func:`masks_at`,
:func:`crashes_at`):

    active[e] = t0[e] <= t < t1[e]
    reach     = ~any_e(active[e] & cut[e])        (diagonal never cut)
    paused    =  any_e(active[e] & paused[e])
    extra     =  min(sum_e(active[e] * drop[e]), 10000)
    gray      =  sum_e(active[e] * gray[e])       (per-node delay add)
    crash     =  any_e((t0[e] <= t) & crash[e])   (crash points never heal)

which composes episodes exactly as the compiled lowering does, row for
row.  The engine knows ``t`` on the host, so it computes the rows in
numpy for every lane at once and sends them in the round's one
host-to-device copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from tpu_paxos_torch.core import faults as fltm


class ScheduleTable(NamedTuple):
    """One lane's schedule as dense arrays, or a batch of them with a
    leading lane axis.  Padding slots hold ``t0 == t1 == 0``: never
    active, so any schedule with at most ``E`` episodes fits."""

    t0: np.ndarray  # [E] int32 episode starts
    t1: np.ndarray  # [E] int32 episode ends (t1 <= t0 = never active)
    cut: np.ndarray  # [E, N, N] bool edges severed while active
    paused: np.ndarray  # [E, N] bool nodes paused while active
    extra_drop: np.ndarray  # [E] int32 per-1e4 burst addition
    crash: np.ndarray  # [E, N] bool crash points (permanent from t0)
    gray: np.ndarray  # [E, N] int32 per-node extra delay while active
    horizon: np.ndarray  # [] int32 first round with every episode over


def encode_schedule(
    sched: fltm.FaultSchedule | None,
    n_nodes: int,
    max_episodes: int | None = None,
) -> ScheduleTable:
    """Encode one schedule (None or empty: the all-clear table, whose
    masks read healed at every round, with horizon 0)."""
    eps = () if sched is None else sched.episodes
    e_cap = len(eps) if max_episodes is None else max_episodes
    e_cap = max(e_cap, 1)  # a zero-length episode axis would not stack
    if len(eps) > e_cap:
        raise ValueError(
            f"schedule has {len(eps)} episodes; table capacity is {e_cap}"
        )
    t0 = np.zeros((e_cap,), np.int32)
    t1 = np.zeros((e_cap,), np.int32)
    cut = np.zeros((e_cap, n_nodes, n_nodes), bool)
    paused = np.zeros((e_cap, n_nodes), bool)
    extra = np.zeros((e_cap,), np.int32)
    crash = np.zeros((e_cap, n_nodes), bool)
    gray = np.zeros((e_cap, n_nodes), np.int32)
    for i, e in enumerate(eps):
        c, p, x, cm, gv = fltm.episode_tables(e, n_nodes)
        t0[i], t1[i] = e.t0, e.t1
        cut[i], paused[i], extra[i], crash[i], gray[i] = c, p, x, cm, gv
    return ScheduleTable(
        t0=t0,
        t1=t1,
        cut=cut,
        paused=paused,
        extra_drop=extra,
        crash=crash,
        gray=gray,
        horizon=np.int32(sched.horizon if sched is not None else 0),
    )


def encode_batch(
    schedules,
    n_nodes: int,
    max_episodes: int | None = None,
) -> ScheduleTable:
    """One table per lane, stacked along a leading lane axis; every lane
    shares one episode capacity (the most over lanes unless given)."""
    schedules = list(schedules)
    if not schedules:
        raise ValueError("encode_batch needs at least one lane")
    if max_episodes is None:
        max_episodes = max(
            len(s.episodes) if s is not None else 0 for s in schedules
        )
    tabs = [encode_schedule(s, n_nodes, max_episodes) for s in schedules]
    return ScheduleTable(
        *(np.stack([getattr(t, f) for t in tabs]) for f in ScheduleTable._fields)
    )


def masks_at(tab: ScheduleTable, t: int):
    """Round ``t``'s masks: ``(reach [.., N, N] bool, paused [.., N]
    bool, extra_drop [..] int32, gray [.., N] int32)``, with the table's
    lane axis leading where it has one.  Equal to
    ``faults.compile_schedule``'s row ``min(t, horizon)``."""
    active = (tab.t0 <= t) & (t < tab.t1)  # [.., E]
    reach = ~np.any(active[..., None, None] & tab.cut, axis=-3)
    paused = np.any(active[..., None] & tab.paused, axis=-2)
    extra = np.minimum(
        np.sum(np.where(active, tab.extra_drop, 0), axis=-1), 10_000
    ).astype(np.int32)
    gray = np.sum(
        np.where(active[..., None], tab.gray, 0), axis=-2
    ).astype(np.int32)  # the engine clamps the inflated delay
    return reach, paused, extra, gray


def crashes_at(tab: ScheduleTable, t: int) -> np.ndarray:
    """Scheduled crashes in force at round ``t``: ``[.., N] bool``, true
    from a crash point's ``t0`` on (padding slots have no crash row)."""
    started = tab.t0 <= t  # [.., E]
    return np.any(started[..., None] & tab.crash, axis=-2)
