"""Runtime churn-schedule encoding: membership change events as data
(the port's own numpy copy of ``tpu_paxos/membership/churn_table.py``).

A :class:`ChurnSchedule` is an ordered tuple of :class:`ChurnEvent`\\ s;
each event injects one value id (a plain value or a membership-change
vid, ``engine.change_vid``) into one node's pending queue at the first
round ``t >= t0`` where its WAIT GATE holds:

- ``WAIT_NONE``    — ready as soon as the previous event is injected;
- ``WAIT_CHOSEN``  — the previous event's vid has been chosen;
- ``WAIT_APPLIED`` — the previous event's vid is *Applied*: a majority
  of node 0's current acceptor view has learned it (ref
  member/main.cpp:138-140, ``MemberSim.applied``).

Events inject strictly in order, at most one per round: a cursor walks
the table, so the churn loop is a pure function of (table, engine state)
and runs identically decided from host reads
(``engine.ChurnEngine.run_host``) and from the engine's tensors
(``engine.ChurnEngine.run``).

Deterministic ``crash(t0, nodes)`` points are fault-schedule episodes
(``core/faults.py``), not churn events.

A :class:`ChurnTable` is plain numpy data, padded to a fixed event
capacity (padding slots hold ``vid == NONE`` and never inject) and
stacked along a leading lane axis by :func:`encode_churn_batch`, so one
member fleet runner covers every churn scenario of a ``(max_events,
n_nodes)`` envelope (``fleet/member_runner.py``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from tpu_paxos_torch.core import values as val

#: Wait-gate kinds (see module doc).
WAIT_NONE = 0
WAIT_CHOSEN = 1
WAIT_APPLIED = 2
WAIT_KINDS = (WAIT_NONE, WAIT_CHOSEN, WAIT_APPLIED)

#: Default event capacity of a churn envelope (the config-5 grow/shrink
#: scenario is 14 events at one value per step, 20 at two).
MAX_EVENTS = 24


@dataclasses.dataclass(frozen=True)
class ChurnEvent:
    """One driver decision: inject ``vid`` via node ``via`` at the first
    round ``t >= t0`` where the wait gate on the PREVIOUS event holds."""

    vid: int
    via: int = 0
    t0: int = 0
    wait: int = WAIT_NONE

    def __post_init__(self) -> None:
        if self.vid < 0:
            raise ValueError(f"event vid must be >= 0, got {self.vid}")
        if self.via < 0:
            raise ValueError(f"event via must be a node index, got {self.via}")
        if self.t0 < 0:
            raise ValueError(f"event t0 must be >= 0, got {self.t0}")
        if self.wait not in WAIT_KINDS:
            raise ValueError(
                f"event wait must be one of {WAIT_KINDS}, got {self.wait}"
            )


@dataclasses.dataclass(frozen=True)
class ChurnSchedule:
    """An immutable ordered sequence of churn events."""

    events: tuple[ChurnEvent, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "events", tuple(self.events))
        for e in self.events:
            if not isinstance(e, ChurnEvent):
                raise TypeError(f"events must be ChurnEvent, got {type(e)}")
        if self.events and self.events[0].wait != WAIT_NONE:
            # event 0 has no predecessor to wait on
            raise ValueError("the first event's wait gate must be WAIT_NONE")
        vids = [e.vid for e in self.events]
        if len(vids) != len(set(vids)):
            raise ValueError(
                "event vids must be distinct (the wait gates and the "
                "run-complete predicate identify events by vid)"
            )

    def to_dict(self) -> dict:
        return {
            "events": [
                {"vid": e.vid, "via": e.via, "t0": e.t0, "wait": e.wait}
                for e in self.events
            ]
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ChurnSchedule":
        return cls(tuple(
            ChurnEvent(
                vid=e["vid"], via=e.get("via", 0), t0=e.get("t0", 0),
                wait=e.get("wait", WAIT_NONE),
            )
            for e in d.get("events", [])
        ))


class ChurnTable(NamedTuple):
    """One scenario's churn schedule as dense numpy arrays (with an
    optional leading lane axis).  Padding slots hold ``vid == NONE`` and
    sit past ``n_events``."""

    t0: np.ndarray  # [E] int32 earliest injection rounds
    via: np.ndarray  # [E] int32 injecting node per event
    vid: np.ndarray  # [E] int32 value ids (padding: NONE)
    wait: np.ndarray  # [E] int32 wait-gate kind per event
    is_change: np.ndarray  # [E] bool vid >= CHANGE_BASE
    n_events: np.ndarray  # [] int32 real (un-padded) event count


def encode_churn(
    sched: ChurnSchedule | None,
    n_nodes: int,
    max_events: int | None = None,
) -> ChurnTable:
    """Encode one schedule (None/empty = the no-churn table: the cursor
    starts satisfied and the loop just runs the engine)."""
    from tpu_paxos_torch.membership import engine as meng

    eps = () if sched is None else sched.events
    e_cap = len(eps) if max_events is None else max_events
    e_cap = max(e_cap, 1)  # a zero-length event axis would not stack
    if len(eps) > e_cap:
        raise ValueError(
            f"churn schedule has {len(eps)} events; table capacity is "
            f"{e_cap}"
        )
    t0 = np.zeros((e_cap,), np.int32)
    via = np.zeros((e_cap,), np.int32)
    vid = np.full((e_cap,), int(val.NONE), np.int32)
    wait = np.zeros((e_cap,), np.int32)
    for i, e in enumerate(eps):
        if e.via >= n_nodes:
            raise ValueError(
                f"event {i} injects via node {e.via} but the cluster "
                f"has {n_nodes} nodes"
            )
        if e.vid >= meng.CHANGE_BASE:
            tgt, _kind = meng.decode_change(e.vid)
            if tgt >= n_nodes:
                raise ValueError(
                    f"event {i} changes node {tgt} but the cluster "
                    f"has {n_nodes} nodes"
                )
        t0[i], via[i], vid[i], wait[i] = e.t0, e.via, e.vid, e.wait
    return ChurnTable(
        t0=t0,
        via=via,
        vid=vid,
        wait=wait,
        is_change=vid >= np.int32(meng.CHANGE_BASE),
        n_events=np.int32(len(eps)),
    )


def encode_churn_batch(
    schedules,
    n_nodes: int,
    max_events: int | None = None,
) -> ChurnTable:
    """One table per lane, stacked along a leading lane axis; every lane
    shares one event capacity (the most over lanes unless given)."""
    schedules = list(schedules)
    if not schedules:
        raise ValueError("encode_churn_batch needs at least one lane")
    if max_events is None:
        max_events = max(
            len(s.events) if s is not None else 0 for s in schedules
        )
    tabs = [encode_churn(s, n_nodes, max_events) for s in schedules]
    return ChurnTable(
        *(np.stack([getattr(t, f) for t in tabs]) for f in ChurnTable._fields)
    )


def grow_shrink_schedule(
    grow_to: int,
    shrink_to: int,
    values_per_step: int = 1,
    first_vid: int = 100,
) -> ChurnSchedule:
    """The BASELINE config-5 churn scenario as a table: grow the acceptor
    set ``{0} -> {0..grow_to-1}`` one AddAcceptor at a time with
    ``values_per_step`` plain values proposed before each change, then
    shrink back to ``{0..shrink_to-1}``; each step waits for the previous
    change's Applied."""
    from tpu_paxos_torch.membership import engine as meng

    if not 1 <= shrink_to <= grow_to:
        raise ValueError("need 1 <= shrink_to <= grow_to")
    events: list[ChurnEvent] = []
    vid = first_vid
    for tgt in range(1, grow_to):
        # the gate sits on whichever event opens the step, so the
        # sequencing holds even with values_per_step=0
        step_wait = WAIT_APPLIED if events else WAIT_NONE
        for _ in range(values_per_step):
            events.append(ChurnEvent(vid=vid, via=0, wait=step_wait))
            step_wait = WAIT_NONE
            vid += 1
        events.append(ChurnEvent(
            vid=meng.change_vid(tgt, meng.ADD_ACCEPTOR), via=0,
            wait=step_wait,
        ))
    for tgt in range(grow_to - 1, shrink_to - 1, -1):
        events.append(ChurnEvent(
            vid=meng.change_vid(tgt, meng.DEL_ACCEPTOR), via=0,
            wait=WAIT_APPLIED,
        ))
    return ChurnSchedule(tuple(events))
