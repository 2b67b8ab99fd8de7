"""The flight recorder: accumulators the general engine carries through
its round loop, per lane, and their reductions (port of
``tpu_paxos/telemetry/recorder.py``).

A telemetry-armed engine (``core/sim.build_engine(..., telemetry=True)``)
carries a :class:`Telemetry` beside its state, every field updated from
values the round already computed, and reduces it to a fixed-shape
:class:`TelemetrySummary` on the device once the run ends; only those
small summaries cross to the host.  Three field families: protocol
counters per message type (copies offered to, dropped, duplicated and
delayed by the fault layer, and event counts), a per-instance latency
ledger (admission, learn and commit-ladder stamps, reduced against
``chosen_round`` into fixed-bucket histograms) and near-miss margins
(heal-to-quiesce gap, stall depth, duel depth, first takeover round).
With ``window_rounds`` the engine also carries :class:`TelemetryWindows`,
the fault-layer counters, stall depth, backlog and events bucketed by
virtual round into ``NUM_WINDOWS`` buckets (the last one overflow);
:func:`summarize_windows` derives per-bucket decisions and latency and
phase histograms at the end.

Every device-side tensor here has a leading lane axis ``[L, ...]``: a
fleet's lanes share one round, and a single run is one lane of it.  The
recorder is read-only: it draws no random numbers and writes nothing
back into the state, so an armed run decides exactly what a plain run
decides.  Its reductions are integer sums, counts and maxima, exact in
any order.

The host-side renderers below the device part are numpy only and equal
the JAX package's, dict for dict.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.utils import device as devm

#: Message-type order of every [7] counter (``Metrics.msgs``'s order).
MSG_NAMES = (
    "prepare",
    "prepare_reply",
    "reject",
    "accept",
    "accept_reply",
    "commit",
    "commit_reply",
)

#: Commit-latency histogram bucket upper edges, in rounds; the last
#: bucket is the overflow (> LAT_EDGES[-1]).
LAT_EDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
NUM_LAT_BUCKETS = len(LAT_EDGES) + 1

#: Windowed plane: NUM_WINDOWS buckets over the virtual clock, each
#: ``window_rounds`` rounds wide (a build parameter); the last bucket
#: holds every round at and past ``(NUM_WINDOWS - 1) * window_rounds``.
NUM_WINDOWS = 16
WINDOW_ROUNDS = 16

#: The phase ledger's phase order: queue-wait (ingest to first accept
#: batch, zero on the closed loop), consensus (first batch to chosen),
#: commit-ladder (chosen to fully commit-acked by every live node) and
#: learn-propagation (chosen to learned by a majority).
PHASE_NAMES = ("queue", "consensus", "commit", "learn")
NUM_PHASES = len(PHASE_NAMES)
PHASE_QUEUE, PHASE_CONSENSUS, PHASE_COMMIT, PHASE_LEARN = range(NUM_PHASES)

#: Region capacity of the per-region-pair fault counters: a run's
#: node->region map (``[A]`` int32) is clamped into it.  Runs without a
#: map put every node in region 0.
NUM_REGIONS = 8

_I32 = torch.int32


class Telemetry(NamedTuple):
    """Per-round accumulators, ``[L, ...]`` per field."""

    offered: torch.Tensor  # [L, 7] int32 copies offered to the fault layer
    #     (post-cut: a message lost at a severed edge never reaches the
    #     drop sampler)
    dropped: torch.Tensor  # [L, 7] int32 copies dropped on offered edges
    duped: torch.Tensor  # [L, 7] int32 duplicate copies spawned
    delayed: torch.Tensor  # [L, 7] int32 surviving copies with delay > 0
    learns: torch.Tensor  # [L] int32 newly learned (node, instance) cells
    commit_acks: torch.Tensor  # [L] int32 commit-ack replies delivered
    takeovers: torch.Tensor  # [L] int32 instances adopted by commit takeover
    requeues: torch.Tensor  # [L] int32 conflict requeues appended
    restarts: torch.Tensor  # [L] int32 proposer ballot restarts
    admit_round: torch.Tensor  # [L, I] int32 first round in an accept batch
    learned_round: torch.Tensor  # [L, I] int32 first round a majority of
    #     nodes had learned the instance (NONE: never)
    committed_round: torch.Tensor  # [L, I] int32 first round some
    #     proposer's commitment was acked by every non-crashed node
    takeover_round: torch.Tensor  # [L, P] int32 first takeover round (NONE)
    stall_max: torch.Tensor  # [L] int32 max stall counter ever observed
    edge_offered: torch.Tensor  # [L, A, A] int32 offered copies per edge
    edge_dropped: torch.Tensor  # [L, A, A] int32 dropped copies per edge
    edge_cut: torch.Tensor  # [L, A, A] int32 copies lost at a severed
    #     edge (pre-cut send mask minus post-cut): where partitions show


class TelemetryWindows(NamedTuple):
    """Per-round windowed accumulators, ``[L, W, ...]`` per field: what
    the final state cannot give back, bucketed by the virtual round."""

    offered: torch.Tensor  # [L, W] int32 copies offered (all types)
    dropped: torch.Tensor  # [L, W] int32
    duped: torch.Tensor  # [L, W] int32
    delayed: torch.Tensor  # [L, W] int32
    stall_max: torch.Tensor  # [L, W] int32 max stall depth in the bucket
    takeovers: torch.Tensor  # [L, W] int32 commit-takeover adoptions
    restarts: torch.Tensor  # [L, W] int32 proposer ballot restarts
    cut: torch.Tensor  # [L, W] int32 copies lost at severed edges
    backlog_max: torch.Tensor  # [L, W] int32 max total queue backlog
    #     (sum over proposers of tail - head) in the bucket
    node_offered: torch.Tensor  # [L, W, A] int32 offered copies touching
    #     each node (charged to both endpoints)
    node_delay: torch.Tensor  # [L, W, A] int32 summed delays of surviving
    #     copies touching each node


class WindowSummary(NamedTuple):
    """The windowed series that crosses to the host: the rings plus the
    decision-time series :func:`summarize_windows` derives."""

    offered: np.ndarray  # [W] int32
    dropped: np.ndarray  # [W] int32
    duped: np.ndarray  # [W] int32
    delayed: np.ndarray  # [W] int32
    stall_max: np.ndarray  # [W] int32
    takeovers: np.ndarray  # [W] int32
    restarts: np.ndarray  # [W] int32
    cut: np.ndarray  # [W] int32
    backlog_max: np.ndarray  # [W] int32
    node_offered: np.ndarray  # [W, A] int32
    node_delay: np.ndarray  # [W, A] int32
    decided: np.ndarray  # [W] int32 decisions per bucket
    lat_hist: np.ndarray  # [W, NUM_LAT_BUCKETS] int32 latency deltas
    phase_hist: np.ndarray  # [W, NUM_PHASES, NUM_LAT_BUCKETS] int32


class TelemetrySummary(NamedTuple):
    """The reduced, fixed-shape summary that crosses to the host."""

    msgs: np.ndarray  # [7] int32 logical sends (pre-fault, = met.msgs)
    offered: np.ndarray  # [7] int32
    dropped: np.ndarray  # [7] int32
    duped: np.ndarray  # [7] int32
    delayed: np.ndarray  # [7] int32
    learns: np.ndarray  # int32
    commit_acks: np.ndarray  # int32
    takeovers: np.ndarray  # int32
    requeues: np.ndarray  # int32
    restarts: np.ndarray  # int32
    decided: np.ndarray  # int32 instances decided
    lat_hist: np.ndarray  # [NUM_LAT_BUCKETS] int32 commit-latency
    lat_max: np.ndarray  # int32 max commit latency (-1: none decided)
    heal_gap: np.ndarray  # int32 quiesce round - last heal (-1: never)
    stall_max: np.ndarray  # int32 max commit-ladder stall depth
    duel_max: np.ndarray  # int32 max ballot count (duel depth)
    takeover_round: np.ndarray  # [P] int32 first takeover round (NONE)
    rounds: np.ndarray  # int32 rounds simulated
    quiescent: np.ndarray  # bool the engine's done predicate held
    region_offered: np.ndarray  # [R, R] int32 offered per region pair
    region_dropped: np.ndarray  # [R, R] int32 dropped per region pair
    region_cut: np.ndarray  # [R, R] int32 lost at severed edges


def init_telemetry(
    n_instances: int, n_proposers: int, n_nodes: int, lanes: int = 1,
    device="cuda",
) -> Telemetry:
    """Zeroed accumulators for ``lanes`` lanes on ``device``."""
    dev = devm.resolve(device)

    def zeros(*shape):
        return torch.zeros((lanes, *shape), dtype=_I32, device=dev)

    def none(*shape):
        return torch.full((lanes, *shape), val.NONE, dtype=_I32, device=dev)

    return Telemetry(
        offered=zeros(7), dropped=zeros(7), duped=zeros(7), delayed=zeros(7),
        learns=zeros(), commit_acks=zeros(), takeovers=zeros(), requeues=zeros(),
        restarts=zeros(),
        admit_round=none(n_instances), learned_round=none(n_instances),
        committed_round=none(n_instances), takeover_round=none(n_proposers),
        stall_max=zeros(),
        edge_offered=zeros(n_nodes, n_nodes), edge_dropped=zeros(n_nodes, n_nodes),
        edge_cut=zeros(n_nodes, n_nodes),
    )


def init_windows(n_nodes: int, lanes: int = 1, device="cuda") -> TelemetryWindows:
    """Zeroed windowed accumulators for ``lanes`` lanes on ``device``."""
    dev = devm.resolve(device)

    def z(*shape):
        return torch.zeros((lanes, NUM_WINDOWS, *shape), dtype=_I32, device=dev)

    return TelemetryWindows(
        offered=z(), dropped=z(), duped=z(), delayed=z(), stall_max=z(),
        takeovers=z(), restarts=z(), cut=z(), backlog_max=z(),
        node_offered=z(n_nodes), node_delay=z(n_nodes),
    )


def window_bucket(t, window_rounds: int):
    """Bucket index of virtual round ``t`` (an int or an int tensor):
    ``t // window_rounds``, clamped into the overflow bucket.  Round
    ``window_rounds`` is the first round of bucket 1."""
    if isinstance(t, torch.Tensor):
        return torch.clamp(t // int(window_rounds), max=NUM_WINDOWS - 1)
    return min(int(t) // int(window_rounds), NUM_WINDOWS - 1)


def _edges(device) -> torch.Tensor:
    # through pinned memory: a pageable copy to a card waits for it
    return devm.to_device(torch.tensor(LAT_EDGES, dtype=_I32), device)


def _lane_counts(index: torch.Tensor, weight: torch.Tensor, n: int) -> torch.Tensor:
    """``[L, n]`` int32: per lane, the sum of ``weight`` (bool or int)
    over the entries whose ``index`` (in ``[0, n)``) names each slot."""
    lanes = index.shape[0]
    out = torch.zeros((lanes, n), dtype=_I32, device=index.device)
    return out.scatter_add_(1, index.reshape(lanes, -1).long(),
                            weight.reshape(lanes, -1).to(_I32))


def summarize_windows(
    wins: TelemetryWindows,
    admit_round,
    chosen_vid,
    chosen_round,
    window_rounds: int,
    batch_round=None,
    learned_round=None,
    committed_round=None,
) -> TelemetryWindows:
    """Close every lane's windowed series on the device: the rings pass
    through; per-bucket decisions and latency and phase histograms are
    derived from the decision metrics (``[L, I]``; each decided instance
    lands in the bucket of its decision round).  No-op fills count as
    decisions but never enter a latency series (their admission stamp is
    NONE).  The phase ledger's stamps bin in the same population as
    ``lat_hist``; a ``None`` stamp leaves its rows empty
    (``batch_round=None`` takes admission as the batch stamp).  Returns
    a :class:`WindowSummary` of ``[L, W, ...]`` tensors."""
    none = val.NONE
    b, w = NUM_LAT_BUCKETS, NUM_WINDOWS
    edges = _edges(chosen_vid.device)
    decided_mask = chosen_vid != none  # [L, I]
    lat_ok = decided_mask & (admit_round != none)
    lat = torch.where(lat_ok, torch.clamp(chosen_round - admit_round, min=0), 0)
    wb = window_bucket(torch.where(decided_mask, chosen_round, 0), window_rounds).long()
    lanes = chosen_vid.shape[0]
    decided = _lane_counts(wb, decided_mask, w)
    lb = torch.bucketize(lat, edges)  # [L, I]: the edges strictly below
    lat_hist = _lane_counts(wb * b + lb, lat_ok, w * b).reshape(lanes, w, b)
    if batch_round is None:
        batch_round = admit_round
    zero = torch.zeros_like(lat)
    q_ok = lat_ok & (batch_round != none)
    q_dur = torch.where(q_ok, torch.clamp(batch_round - admit_round, min=0), 0)
    c_dur = torch.where(q_ok, torch.clamp(chosen_round - batch_round, min=0), 0)
    if committed_round is None:
        com_ok, com_dur = torch.zeros_like(lat_ok), zero
    else:
        com_ok = lat_ok & (committed_round != none)
        com_dur = torch.where(com_ok, torch.clamp(committed_round - chosen_round, min=0), 0)
    if learned_round is None:
        lrn_ok, lrn_dur = torch.zeros_like(lat_ok), zero
    else:
        lrn_ok = lat_ok & (learned_round != none)
        lrn_dur = torch.where(lrn_ok, torch.clamp(learned_round - chosen_round, min=0), 0)
    durs = torch.stack([q_dur, c_dur, com_dur, lrn_dur], dim=2)  # [L, I, 4]
    oks = torch.stack([q_ok, q_ok, com_ok, lrn_ok], dim=2)
    phase = torch.arange(NUM_PHASES, device=wb.device)
    cell = (wb[..., None] * NUM_PHASES + phase) * b + torch.bucketize(durs, edges)
    phase_hist = _lane_counts(cell, oks, w * NUM_PHASES * b).reshape(lanes, w, NUM_PHASES, b)
    return WindowSummary(
        *wins, decided=decided, lat_hist=lat_hist, phase_hist=phase_hist,
    )


def count_copies(al, dl, mask):
    """One message type's fault-layer counters for every lane, from the
    sampled copy plan (``al``/``dl`` ``[L, 4, *edge]``) and the post-cut
    send mask (``[L, *edge]``): ``(offered, dropped, duped, delayed)``,
    ``[L]`` int32 each.  Copy 0 is the original; copies 1..3 are the
    duplicate chain (never dropped)."""
    dims = tuple(range(1, mask.ndim))
    cdims = tuple(range(1, al.ndim))
    offered = mask.sum(dim=dims).to(_I32)
    dropped = (mask & ~al[:, 0]).sum(dim=dims).to(_I32)
    duped = (mask[:, None] & al[:, 1:]).sum(dim=cdims).to(_I32)
    delayed = (mask[:, None] & al & (dl > 0)).sum(dim=cdims).to(_I32)
    return offered, dropped, duped, delayed


def _lane_maps(region_map, lanes: int, n_nodes: int, device) -> torch.Tensor:
    """``[L, A]`` int64 node->region maps clamped into the region bound:
    None (every node in region 0), one ``[A]`` map for every lane, or
    ``[L, A]``."""
    if region_map is None:
        return torch.zeros((lanes, n_nodes), dtype=torch.int64, device=device)
    if not isinstance(region_map, torch.Tensor):
        region_map = devm.to_device(
            torch.from_numpy(np.ascontiguousarray(region_map, np.int64)), device)
    r = region_map.to(torch.int64).reshape(-1, n_nodes).expand(lanes, n_nodes)
    return torch.clamp(r, 0, NUM_REGIONS - 1)


def region_reduce(edge_counts, region_map):
    """Reduce ``[L, A, A]`` per-edge counters to ``[L, R, R]``
    per-region-pair totals through each lane's node->region map
    (see :func:`_lane_maps` for the forms ``region_map`` takes)."""
    lanes, a = edge_counts.shape[:2]
    r = _lane_maps(region_map, lanes, a, edge_counts.device)
    cell = r[:, :, None] * NUM_REGIONS + r[:, None, :]
    return _lane_counts(cell, edge_counts, NUM_REGIONS * NUM_REGIONS).reshape(
        lanes, NUM_REGIONS, NUM_REGIONS)


def summarize(tele: Telemetry, final, horizon, region_map=None) -> TelemetrySummary:
    """Reduce every lane's accumulators and final state to the
    fixed-shape summary, on the device (``[L, ...]`` tensors).
    ``final`` is the lane-stacked final ``SimState``; ``horizon`` the
    schedule's last-heal round (an int, or ``[L]`` per lane);
    ``region_map`` the node->region map(s) of :func:`_lane_maps`."""
    met = final.met
    dev = met.chosen_vid.device
    lanes = met.chosen_vid.shape[0]
    decided_mask = met.chosen_vid != val.NONE  # [L, I]
    lat_ok = decided_mask & (tele.admit_round != val.NONE)
    lat = torch.where(lat_ok, torch.clamp(met.chosen_round - tele.admit_round, min=0), 0)
    bucket = torch.bucketize(lat, _edges(dev))
    hz = np.array(np.broadcast_to(np.asarray(horizon, np.int32), (lanes,)))
    hz = devm.to_device(torch.from_numpy(hz), dev)
    rmap = _lane_maps(region_map, lanes, tele.edge_offered.shape[1], dev)
    return TelemetrySummary(
        msgs=met.msgs,
        offered=tele.offered,
        dropped=tele.dropped,
        duped=tele.duped,
        delayed=tele.delayed,
        learns=tele.learns,
        commit_acks=tele.commit_acks,
        takeovers=tele.takeovers,
        requeues=tele.requeues,
        restarts=tele.restarts,
        decided=decided_mask.sum(dim=1).to(_I32),
        lat_hist=_lane_counts(bucket, lat_ok, NUM_LAT_BUCKETS),
        lat_max=torch.where(lat_ok, lat, -1).amax(dim=1),
        heal_gap=torch.where(final.done, final.t - hz, -1).to(_I32),
        stall_max=tele.stall_max,
        duel_max=final.prop.count.amax(dim=1),
        takeover_round=tele.takeover_round,
        rounds=final.t,
        quiescent=final.done,
        region_offered=region_reduce(tele.edge_offered, rmap),
        region_dropped=region_reduce(tele.edge_dropped, rmap),
        region_cut=region_reduce(tele.edge_cut, rmap),
    )


def close(tele, final, horizon, region_map=None, window_rounds: int = 0) -> list:
    """The end of an armed run, on the device: ``[summary]``, or
    ``[summary, windows]`` when ``window_rounds`` (then ``tele`` is the
    ``(Telemetry, TelemetryWindows)`` pair), each ``[L, ...]``; the
    phase ledger's stamps close the windowed series."""
    base = tele[0] if window_rounds else tele
    out = [summarize(base, final, horizon, region_map)]
    if window_rounds:
        out.append(summarize_windows(
            tele[1], base.admit_round, final.met.chosen_vid, final.met.chosen_round,
            window_rounds, batch_round=base.admit_round, learned_round=base.learned_round,
            committed_round=base.committed_round,
        ))
    return out


def lane(tree, i: int):
    """Lane ``i`` of a lane-stacked host tree."""
    return type(tree)(*[np.asarray(x)[i] for x in tree])


def serve_admit_rounds(ingest, chosen_vid):
    """Ingest-time admission of the open-loop serving harness."""
    raise NotImplementedError("recorder.serve_admit_rounds is not ported yet (serving)")


def region_window_hist(admit_round, chosen_vid, chosen_round, vid_region, window_rounds: int):
    """Per-region windowed commit-latency histograms of a serve stream."""
    raise NotImplementedError("recorder.region_window_hist is not ported yet (serving)")


def region_window_hist_host(ingest, chosen_vid, chosen_round, vid_region, window_rounds: int):
    """Host twin of :func:`region_window_hist` for the serve harness."""
    raise NotImplementedError("recorder.region_window_hist_host is not ported yet (serving)")


# ---------------- host-side rendering ----------------


def region_pairs_dict(
    region_offered, region_dropped, region_cut=None, region_names=(),
) -> dict:
    """The per-region-pair offered/dropped block, TRIMMED to the used
    region prefix (the [R, R] device shape is a fixed envelope; a
    3-region run renders 3x3).  Always at least 1x1 — region 0 holds
    everything for unassigned runs.  ``region_cut`` adds the
    severed-edge loss rows (partitions are invisible in the post-cut
    drop counters); ``region_names`` adds preset region NAMES
    (``core/wan.py`` — ``us``/``eu``/``ap``) so operators read pairs
    by name, not index (short names fill in for regions past the
    given prefix)."""
    off = np.asarray(region_offered)
    drp = np.asarray(region_dropped)
    cut = None if region_cut is None else np.asarray(region_cut)
    used = np.flatnonzero(
        off.any(axis=0) | off.any(axis=1) | drp.any(axis=0) | drp.any(axis=1)
        | (cut.any(axis=0) | cut.any(axis=1) if cut is not None else False)
    )
    r = int(used.max()) + 1 if used.size else 1
    out = {
        "n_regions": r,
        "offered": off[:r, :r].tolist(),
        "dropped": drp[:r, :r].tolist(),
        "drop_rate_observed": [
            [
                round(1e4 * float(d) / float(o), 1) if int(o) else 0.0
                for d, o in zip(drow, orow)
            ]
            for drow, orow in zip(drp[:r, :r], off[:r, :r])
        ],
    }
    if cut is not None:
        out["cut"] = cut[:r, :r].tolist()
    if region_names:
        out["names"] = region_prefix_names(region_names, r)
    return out


def region_prefix_names(region_names, r: int) -> list:
    """The first ``r`` region names, padded with ``r<i>`` index names
    past the declared prefix (a 5-node run on a 3-region preset never
    pads; an undeclared region that somehow carried traffic still gets
    a stable name)."""
    names = [str(n) for n in region_names[:r]]
    names += [f"r{i}" for i in range(len(names), r)]
    return names


def region_pair_name(region_names, s: int, d: int) -> str:
    """One directed region pair as a name (``us->ap``), falling back
    to index names without a preset in scope."""
    names = region_prefix_names(region_names, max(s, d) + 1)
    return f"{names[s]}->{names[d]}"


def latency_quantile(hist: np.ndarray, q: float, lat_max: int) -> int:
    """Bucket-resolution quantile estimate: upper edge of the bucket
    the q-th decided instance falls in, clamped to the observed max
    (so p50 <= p99 <= latency_max always holds; the overflow bucket
    reports the exact observed max).  -1 when nothing was decided."""
    hist = np.asarray(hist)
    total = int(hist.sum())
    if total == 0:
        return -1
    target = q * total
    cum = 0
    for b, n in enumerate(hist.tolist()):
        cum += n
        if cum >= target and n:
            if b < len(LAT_EDGES):
                return min(int(LAT_EDGES[b]), int(lat_max))
            return int(lat_max)
    return int(lat_max)


#: Phase-quantile clamp: phase durations are not bounded by the run's
#: commit-latency max (the commit ladder and learn propagation finish
#: AFTER the decision), so their bucket-edge quantiles clamp at twice
#: the histogram grid instead of ``lat_max``.
PHASE_LAT_CAP = 2 * LAT_EDGES[-1]


def windows_to_dict(
    w: WindowSummary, window_rounds: int, lat_max: int
) -> dict:
    """One lane's windowed series as a JSON-ready dict of [W] lists
    (the time-resolved twin of :func:`summary_to_dict`).  Per-bucket
    latency quantiles are bucket-edge estimates clamped to the RUN's
    observed max (``lat_max``); empty buckets report -1."""
    hist = np.asarray(w.lat_hist)  # [W, B]
    phist = np.asarray(w.phase_hist)  # [W, NUM_PHASES, B]
    return {
        "cut": np.asarray(w.cut).tolist(),
        "backlog_max": np.asarray(w.backlog_max).tolist(),
        "node_offered": np.asarray(w.node_offered).tolist(),
        "node_delay": np.asarray(w.node_delay).tolist(),
        "phases": list(PHASE_NAMES),
        "phase_hist": phist.tolist(),  # [W][NUM_PHASES][B]
        "phase_p50": {
            name: [
                latency_quantile(phist[wi, pi], 0.50, PHASE_LAT_CAP)
                for wi in range(phist.shape[0])
            ]
            for pi, name in enumerate(PHASE_NAMES)
        },
        "window_rounds": int(window_rounds),
        "n_windows": int(hist.shape[0]),
        "decided": np.asarray(w.decided).tolist(),
        "offered": np.asarray(w.offered).tolist(),
        "dropped": np.asarray(w.dropped).tolist(),
        "duped": np.asarray(w.duped).tolist(),
        "delayed": np.asarray(w.delayed).tolist(),
        "drop_rate_observed": [
            round(1e4 * float(d) / float(o), 1) if int(o) else 0.0
            for d, o in zip(np.asarray(w.dropped), np.asarray(w.offered))
        ],
        "stall_max": np.asarray(w.stall_max).tolist(),
        "takeovers": np.asarray(w.takeovers).tolist(),
        "restarts": np.asarray(w.restarts).tolist(),
        "latency_p50": [
            latency_quantile(row, 0.50, lat_max) for row in hist
        ],
        "latency_p99": [
            latency_quantile(row, 0.99, lat_max) for row in hist
        ],
        "lat_hist": hist.tolist(),  # [W, B] — the SLO monitor's input
        "latency_edges": list(LAT_EDGES),
    }


def summary_to_dict(
    s: TelemetrySummary,
    windows: WindowSummary | None = None,
    window_rounds: int = WINDOW_ROUNDS,
    region_names: tuple = (),
) -> dict:
    """One lane's summary as a JSON-ready dict (plain ints/lists),
    with derived p50/p99 latency estimates; ``windows`` (one lane's
    :class:`WindowSummary`) adds the time-resolved ``"windows"``
    block; ``region_names`` (a WAN preset's region tuple) names the
    ``region_pairs`` block's rows.  Under the fleet vmap index the
    summary first (:func:`lane`)."""
    hist = np.asarray(s.lat_hist)
    lat_max = int(s.lat_max)
    offered = np.asarray(s.offered)
    dropped = np.asarray(s.dropped)
    return {
        "msgs": {n: int(v) for n, v in zip(MSG_NAMES, np.asarray(s.msgs))},
        "offered": {n: int(v) for n, v in zip(MSG_NAMES, offered)},
        "dropped": {n: int(v) for n, v in zip(MSG_NAMES, dropped)},
        "duped": {n: int(v) for n, v in zip(MSG_NAMES, np.asarray(s.duped))},
        "delayed": {
            n: int(v) for n, v in zip(MSG_NAMES, np.asarray(s.delayed))
        },
        "offered_total": int(offered.sum()),
        "dropped_total": int(dropped.sum()),
        "drop_rate_observed": (
            round(1e4 * float(dropped.sum()) / float(offered.sum()), 1)
            if int(offered.sum()) else 0.0
        ),
        "learns": int(s.learns),
        "commit_acks": int(s.commit_acks),
        "takeovers": int(s.takeovers),
        "requeues": int(s.requeues),
        "restarts": int(s.restarts),
        "decided": int(s.decided),
        "latency_hist": hist.tolist(),
        "latency_edges": list(LAT_EDGES),
        "latency_p50": latency_quantile(hist, 0.50, lat_max),
        "latency_p99": latency_quantile(hist, 0.99, lat_max),
        "latency_max": lat_max,
        "heal_gap": int(s.heal_gap),
        "stall_max": int(s.stall_max),
        "duel_max": int(s.duel_max),
        "takeover_round": np.asarray(s.takeover_round).tolist(),
        "rounds": int(s.rounds),
        "quiescent": bool(s.quiescent),
        "region_pairs": region_pairs_dict(
            s.region_offered, s.region_dropped, s.region_cut,
            region_names,
        ),
        **(
            {"windows": windows_to_dict(windows, window_rounds, lat_max)}
            if windows is not None else {}
        ),
    }


def margins_vector(s: TelemetrySummary) -> dict:
    """The near-miss margin subset (the search's fitness vector): how
    close the lane came to a liveness wedge."""
    return {
        "heal_gap": int(s.heal_gap),
        "stall_max": int(s.stall_max),
        "duel_max": int(s.duel_max),
        "rounds": int(s.rounds),
        "latency_max": int(s.lat_max),
    }


def reduce_lanes_windows(
    w: WindowSummary, window_rounds: int, lat_max: int
) -> dict:
    """Across-lane aggregate of a ``[lanes, W]``-leading window stack:
    per-bucket sums for the count series, per-bucket across-lane MAX
    for stall depth (the deepest any lane stalled in that bucket),
    and per-bucket latency quantiles over the lane-summed histogram
    deltas.  The stress sweep's per-mix windowed column and the
    search's windowed margin series both derive from this dict."""
    summed = WindowSummary(
        offered=np.asarray(w.offered).sum(axis=0),
        dropped=np.asarray(w.dropped).sum(axis=0),
        duped=np.asarray(w.duped).sum(axis=0),
        delayed=np.asarray(w.delayed).sum(axis=0),
        stall_max=np.asarray(w.stall_max).max(axis=0),
        takeovers=np.asarray(w.takeovers).sum(axis=0),
        restarts=np.asarray(w.restarts).sum(axis=0),
        cut=np.asarray(w.cut).sum(axis=0),
        # backlog is a depth, not a rate: the deepest any lane queued
        # in that bucket (summing would read lane count as pressure)
        backlog_max=np.asarray(w.backlog_max).max(axis=0),
        node_offered=np.asarray(w.node_offered).sum(axis=0),
        node_delay=np.asarray(w.node_delay).sum(axis=0),
        decided=np.asarray(w.decided).sum(axis=0),
        lat_hist=np.asarray(w.lat_hist).sum(axis=0),
        phase_hist=np.asarray(w.phase_hist).sum(axis=0),
    )
    return windows_to_dict(summed, window_rounds, lat_max)


def stall_margin_series(w: WindowSummary, patience: int) -> list:
    """The windowed near-miss margin series (the search's trajectory
    fitness signal): per bucket, the MINIMUM over lanes of
    ``patience - stall_max`` — how many idle rounds of headroom the
    closest lane had left before its commit-ladder stall tripped the
    takeover/restart threshold in that bucket.  ``patience`` is the
    engine's stall threshold (``core/sim.IDLE_RESTART_ROUNDS``); a
    margin <= 0 means some lane actually hit it there.  Works on a
    ``[lanes, W]`` stack or a single ``[W]`` lane."""
    stall = np.asarray(w.stall_max)
    if stall.ndim > 1:
        stall = stall.max(axis=0)
    return (int(patience) - stall).astype(np.int64).tolist()


def lane_stall_margins(w: WindowSummary, patience: int) -> list:
    """Per-LANE fitness vector for the selection loop (evolve): for
    each lane of a ``[lanes, W]`` window stack, the minimum over
    buckets of ``patience - stall_max`` — the tightest liveness
    headroom that genome reached anywhere in its run.  Lower is
    fitter for wedge hunting; <= 0 means the lane actually tripped
    the stall threshold.  Unlike :func:`stall_margin_series` (which
    reduces ACROSS lanes first and so cannot credit a margin to the
    genome that produced it), this keeps the lane axis so selection
    can rank individuals.  A single ``[W]`` lane yields a length-1
    vector."""
    stall = np.asarray(w.stall_max)
    if stall.ndim == 1:
        stall = stall[None, :]
    return (int(patience) - stall.max(axis=1)).astype(np.int64).tolist()


def lane_burn_rates(
    lat_hist, latency_rounds: int, budget_milli: int
) -> list:
    """Per-LANE windowed SLO burn fitness for the serve axis of the
    selection loop: for each lane of a ``[lanes, W, B]`` windowed
    latency-histogram stack, the MAXIMUM over windows of the burn
    rate at ``latency_rounds`` — same bucket-edge and budget
    semantics as the serve judge (``harness._judge_series``): bad =
    decided past the bucket edge covering ``latency_rounds``, burn =
    bad/decided/budget, empty windows burn 0.  Higher is fitter for
    breach hunting; >= the SLO's ``burn_breach`` means that genome's
    lane breached.  A single ``[W, B]`` lane yields a length-1
    vector."""
    import bisect

    hist = np.asarray(lat_hist, np.int64)
    if hist.ndim == 2:
        hist = hist[None, :, :]
    k = bisect.bisect_right(LAT_EDGES, int(latency_rounds))
    tot = hist.sum(axis=2)
    bad = hist[:, :, k:].sum(axis=2)
    budget = max(int(budget_milli), 1) / 1000.0
    out = []
    for li in range(hist.shape[0]):
        burns = [
            round(float(b) / float(t) / budget, 3) if t else 0.0
            for b, t in zip(bad[li], tot[li])
        ]
        out.append(max(burns) if burns else 0.0)
    return out


def reduce_lanes(
    s: TelemetrySummary,
    windows: WindowSummary | None = None,
    window_rounds: int = WINDOW_ROUNDS,
    region_names: tuple = (),
) -> dict:
    """Across-lane aggregate of a ``[lanes]``-leading summary stack —
    the ONE owner of the stack-reduction semantics (never-quiesced
    ``-1`` heal gaps excluded from the min; latency quantiles over
    the summed histogram).  ``windows`` (a ``[lanes, W]`` stack) adds
    the time-resolved ``"windows"`` block.  The stress sweep's
    per-mix block and the search's per-generation margins both derive
    from this dict."""
    gaps = np.asarray(s.heal_gap)
    quiesced = gaps[gaps >= 0]
    hist = np.asarray(s.lat_hist).sum(axis=0)
    lat_max = int(np.asarray(s.lat_max).max())
    win_blk = (
        {"windows": reduce_lanes_windows(windows, window_rounds, lat_max)}
        if windows is not None else {}
    )
    return {
        **win_blk,
        "region_pairs": region_pairs_dict(
            np.asarray(s.region_offered).sum(axis=0),
            np.asarray(s.region_dropped).sum(axis=0),
            np.asarray(s.region_cut).sum(axis=0),
            region_names,
        ),
        "offered": int(np.asarray(s.offered).sum()),
        "dropped": int(np.asarray(s.dropped).sum()),
        "duped": int(np.asarray(s.duped).sum()),
        "delayed": int(np.asarray(s.delayed).sum()),
        "decided": int(np.asarray(s.decided).sum()),
        "takeovers": int(np.asarray(s.takeovers).sum()),
        "requeues": int(np.asarray(s.requeues).sum()),
        "restarts": int(np.asarray(s.restarts).sum()),
        "heal_gap_min": int(quiesced.min()) if quiesced.size else -1,
        "stall_depth_max": int(np.asarray(s.stall_max).max()),
        "duel_depth_max": int(np.asarray(s.duel_max).max()),
        "rounds_max": int(np.asarray(s.rounds).max()),
        "latency_p50": latency_quantile(hist, 0.50, lat_max),
        "latency_p99": latency_quantile(hist, 0.99, lat_max),
        "latency_max": lat_max,
    }
