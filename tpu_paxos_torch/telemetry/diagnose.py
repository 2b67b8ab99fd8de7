"""Breach attribution: a deterministic gray-vs-saturation diagnosis
plane over the windowed flight-recorder series (port of
``tpu_paxos/telemetry/diagnose.py``, numpy only, byte for byte the same
verdicts).

A pure, deterministic classifier that consumes only the harvested
windowed series — the ``windows_to_dict`` block (latency/drop/stall/
takeover series, the queue-backlog and per-node delay rings, and the
phase-latency decomposition), plus the run-total ``region_pairs`` block
and, when a serve path reduced them, the per-region latency series —
and labels each breach window with a ranked list of NAMED causes:

- ``saturation`` — the queue backlog grows across buckets while the
  phase decomposition is queue-wait-dominated: the engine is being
  offered more than its service rate.  Drops staying nominal is the
  confirming signal (an overloaded healthy cluster loses nothing).
- ``gray-region`` — some node's (region's, under a preset map)
  per-copy mean delay inflates past its OWN earlier-bucket baseline
  while its drop ratio stays nominal and the backlog stays flat: the
  slow-but-alive outage no liveness verdict catches.  Judged against
  the node's own baseline because WAN presets are asymmetric at rest
  — "ap is slower than us" is the topology, not an outage.
- ``partition`` — copies lost at SEVERED edges (``cut`` series: the
  pre-cut/post-cut delta the post-cut drop counters cannot show)
  with the severed region pair named from ``region_pairs["cut"]``.
- ``duel-churn`` — a takeover/restart burst with the consensus phase
  dominating the decomposition: proposers fighting over ballots, not
  a sick network.

Every signal is integer/median arithmetic on the harvested series —
no PRNG, no wall clock, no dict-order dependence — so the verdict is
byte-identical across replays of the same artifact (the determinism
contract ``python -m tpu_paxos_torch repro`` rides; pinned by
tests/test_torch_diagnose.py).  An ambiguous window (e.g. a gray region
*while* saturating) reports EVERY qualifying cause ranked by score —
never silently picking one — which is exactly the contract an
admission controller needs: shed load on ``saturation``,
never on ``gray-region``.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

from tpu_paxos_torch.telemetry import recorder as telem

#: Cause names, in canonical (tie-break) order.
CAUSES = ("duel-churn", "gray-region", "partition", "saturation")

#: Stable integer cause codes, next to the string labels: the
#: admission controller's policy table (serve/control.py) and serve
#: verdicts key on CODES, so renaming or reordering a label can never
#: silently rewire a shed/hold policy.  0 is reserved for "unknown";
#: 1..N follow :data:`CAUSES` canonical order.  The mapping is part of
#: the pinned determinism surface (tests/test_control.py) — appending
#: a new cause gets the next free code; existing codes never move.
CAUSE_IDS = {"unknown": 0, **{c: i + 1 for i, c in enumerate(CAUSES)}}

#: Code -> name, for rendering decisions back into reports.
CAUSE_NAMES = {v: k for k, v in CAUSE_IDS.items()}


def cause_code(name: str) -> int:
    """The stable integer code for a cause label (0 for any label the
    table does not know — unknown causes must never match a policy
    row by accident)."""
    return CAUSE_IDS.get(name, 0)

# ---- signal thresholds (integer/fixed-point; part of the pinned
# ---- determinism surface — change them only with the fixtures) ----

#: saturation: bucket backlog must be >= FACTOR x the baseline median
#: (and >= MIN absolutely) to count as growth.
SAT_BACKLOG_FACTOR_MILLI = 2000
SAT_BACKLOG_MIN = 4

#: "drops nominal": observed window drop rate (per 1e4) stays under
#: FACTOR x baseline + FLOOR.
DROP_NOMINAL_FACTOR_MILLI = 2000
DROP_NOMINAL_FLOOR = 100.0

#: gray: a node's per-copy mean delay (milli-rounds) must reach
#: FACTOR x its own baseline AND the absolute floor (one full round).
GRAY_DELAY_FACTOR_MILLI = 1500
GRAY_DELAY_MIN_MILLI = 1000
#: gray attribution: delays charge BOTH edge endpoints, so a gray
#: node's neighbors co-inflate by their traffic share with it (~1/2
#: at 3 nodes, less on bigger clusters); only nodes within 2/3 of
#: the LARGEST inflation delta are named as gray.
GRAY_ATTRIB_NUM, GRAY_ATTRIB_DEN = 2, 3

#: duel-churn: takeover+restart events in the bucket.
CHURN_MIN_EVENTS = 2
CHURN_FACTOR_MILLI = 2000

#: partition: any copy lost at a severed edge is a live cut.
PART_CUT_MIN = 1

#: Representative per-bucket duration for phase-dominance weighting:
#: the bucket's upper edge (overflow = twice the grid).
PHASE_REP = tuple(telem.LAT_EDGES) + (2 * telem.LAT_EDGES[-1],)


def _median(xs) -> int:
    """Deterministic integer median (upper middle) — 0 when empty."""
    xs = sorted(int(x) for x in xs)
    return xs[len(xs) // 2] if xs else 0


def _fmedian(xs) -> float:
    xs = sorted(float(x) for x in xs)
    return xs[len(xs) // 2] if xs else 0.0


def _phase_weights(d: dict, w: int) -> dict:
    """Per-phase latency mass at window ``w``: histogram counts
    weighted by the bucket's representative duration (ints)."""
    ph = d["phase_hist"][w]  # [NUM_PHASES][B]
    return {
        name: sum(
            int(n) * PHASE_REP[b] for b, n in enumerate(ph[pi])
        )
        for pi, name in enumerate(telem.PHASE_NAMES)
    }


def _dominant_phase(weights: dict) -> str | None:
    """The phase carrying the most latency mass (ties break in
    PHASE_NAMES order); None when nothing decided."""
    best, best_w = None, 0
    for name in telem.PHASE_NAMES:
        if weights[name] > best_w:
            best, best_w = name, weights[name]
    return best


def _node_delay_milli(d: dict, w: int) -> list:
    """Per-node mean delay at window ``w`` in milli-rounds per
    involved copy (0 where the node saw no traffic)."""
    nd, no = d["node_delay"][w], d["node_offered"][w]
    return [
        (1000 * int(s)) // int(o) if int(o) else 0
        for s, o in zip(nd, no)
    ]


class SeriesBaseline:
    """Per-run reference levels: medians over the ACTIVE windows not
    under diagnosis (the run's own 'normal'), so every threshold is
    relative to this run's weather, not a global constant."""

    def __init__(self, d: dict, exclude=()):
        decided = d["decided"]
        offered = d["offered"]
        n = len(decided)
        active = [
            w for w in range(n) if int(decided[w]) or int(offered[w])
        ]
        # Load-dependent baselines (backlog, churn events, latency)
        # read the healthy windows ONLY: when every active window is
        # under diagnosis (a run that breached start to finish),
        # 'normal' is idle — the empty medians are 0, and any
        # backlog/burst reads as growth.  The DROP baseline is
        # weather, not load (drops are i.i.d. fault-layer samples;
        # offered load does not move the rate), so it reads ALL
        # active windows — an over-knee burst whose whole run is one
        # breach bucket still compares its drops against the run's
        # own weather instead of an idle 0 that would fake a spike.
        # The per-node DELAY baseline is the MINIMUM over all active
        # windows with traffic, not a median: baseline delay is a
        # topology property (a WAN preset is slow at rest, load does
        # not inflate it), and the healthiest observed bucket is the
        # at-rest floor even when a gray episode covers most of the
        # run — a median would absorb the episode and hide it.
        ref = [w for w in active if w not in set(exclude)]
        self.active = active
        self.ref = ref
        self.drop = _fmedian(d["drop_rate_observed"][w] for w in active)
        self.backlog = _median(d["backlog_max"][w] for w in ref)
        self.events = _median(
            int(d["takeovers"][w]) + int(d["restarts"][w]) for w in ref
        )
        a = len(d["node_offered"][0]) if d["node_offered"] else 0
        # cut windows distort the per-node traffic MIX (a severed
        # node's surviving edges are not its normal edges), so they
        # are excluded from the at-rest delay floor
        cut_free = [w for w in active if not int(d["cut"][w])]
        self.node_delay = [
            min(
                (
                    _node_delay_milli(d, w)[ai]
                    for w in (cut_free or active)
                    if int(d["node_offered"][w][ai])
                ),
                default=0,
            )
            for ai in range(a)
        ]


def _drops_nominal(d: dict, w: int, base: SeriesBaseline) -> bool:
    return float(d["drop_rate_observed"][w]) <= (
        base.drop * DROP_NOMINAL_FACTOR_MILLI / 1000.0
        + DROP_NOMINAL_FLOOR
    )


def _gray_nodes(d: dict, w: int, base: SeriesBaseline) -> list:
    """Nodes whose per-copy mean delay at ``w`` inflated past their
    own at-rest baseline (and the absolute floor), ATTRIBUTED to the
    node(s) carrying the largest inflation delta (delays charge both
    edge endpoints, so a gray node's neighbors co-inflate by their
    traffic share with it): ``[(node, milli, baseline_milli),
    ...]``."""
    cands = []
    for ai, milli in enumerate(_node_delay_milli(d, w)):
        floor = max(
            base.node_delay[ai] * GRAY_DELAY_FACTOR_MILLI // 1000,
            GRAY_DELAY_MIN_MILLI,
        )
        if milli >= floor:
            cands.append((ai, milli, base.node_delay[ai],
                          milli - base.node_delay[ai]))
    if not cands:
        return []
    max_delta = max(c[3] for c in cands)
    return [
        (ai, milli, b) for ai, milli, b, delta in cands
        if delta * GRAY_ATTRIB_DEN >= GRAY_ATTRIB_NUM * max_delta
    ]


def _cut_pair(region_pairs: dict | None):
    """The busiest severed region pair from the run-total
    ``region_pairs["cut"]`` matrix: ``(s, d, count)`` or None."""
    if not region_pairs or "cut" not in region_pairs:
        return None
    cut = region_pairs["cut"]
    best = None
    for s, row in enumerate(cut):
        for dd, c in enumerate(row):
            if int(c) and (best is None or int(c) > best[2]):
                best = (s, dd, int(c))
    return best


def diagnose_window(
    d: dict,
    w: int,
    *,
    base: SeriesBaseline | None = None,
    region_map=None,
    region_names: tuple = (),
    region_pairs: dict | None = None,
    region_series=None,
) -> dict:
    """Label ONE window of a ``windows_to_dict`` block with its
    ranked cause candidates.  ``base`` carries the run's reference
    levels (built once per run; defaults to excluding only ``w``);
    ``region_map``/``region_names`` translate gray nodes to preset
    region names; ``region_pairs`` (the summary block) names severed
    pairs; ``region_series`` (``[R, W, B]``) adds the per-region
    latency confirmation when a serve path reduced one.

    Returns ``{"window", "span", "cause", "candidates", "ambiguous"}``
    — ``candidates`` ranked by score then canonical cause order, and
    ``cause`` is the top candidate's name (``"unknown"`` when no
    recipe fires).  Deterministic: byte-identical JSON for identical
    inputs."""
    if base is None:
        base = SeriesBaseline(d, exclude=(w,))
    wr = int(d["window_rounds"])
    weights = _phase_weights(d, w)
    dom = _dominant_phase(weights)
    drops_ok = _drops_nominal(d, w, base)
    candidates = []

    # -- saturation: backlog growth + queue-wait-dominated latency
    backlog = int(d["backlog_max"][w])
    backlog_grew = (
        backlog >= SAT_BACKLOG_MIN
        and 1000 * backlog
        >= SAT_BACKLOG_FACTOR_MILLI * max(base.backlog, 1)
    )
    if backlog_grew and dom == "queue":
        score = 4 + (1 if drops_ok else 0)
        candidates.append(("saturation", score, {
            "backlog": backlog,
            "backlog_baseline": base.backlog,
            "dominant_phase": dom,
            "drops_nominal": drops_ok,
        }))

    # -- gray-region: per-node delay inflation, drops nominal,
    # -- backlog flat.  A gray node slows — it never severs — so a
    # -- window with severed-edge losses is never gray (and the mix
    # -- shift a cut causes would fake inflation anyway).
    gray = _gray_nodes(d, w, base) if not int(d["cut"][w]) else []
    if gray and drops_ok:
        nodes = [g[0] for g in gray]
        if region_map is not None:
            regions = sorted({int(region_map[a]) for a in nodes})
        else:
            regions = []
        names = [
            telem.region_prefix_names(region_names, r + 1)[r]
            for r in regions
        ]
        score = 4 + (0 if backlog_grew else 1)
        ev = {
            "nodes": nodes,
            "delay_milli": [g[1] for g in gray],
            "delay_baseline_milli": [g[2] for g in gray],
            "drops_nominal": drops_ok,
            "backlog_flat": not backlog_grew,
        }
        if regions:
            ev["regions"] = names
        if region_series is not None and regions:
            # per-region latency confirmation: the named region's own
            # p50 at w above the other regions' — supporting, not
            # required (a gray ACCEPTOR inflates commit/learn phases
            # without moving its own region's proposals)
            rs = np.asarray(region_series)
            cap = telem.PHASE_LAT_CAP
            p50s = [
                telem.latency_quantile(rs[r, w], 0.50, cap)
                for r in range(rs.shape[0])
            ]
            others = [
                p for r, p in enumerate(p50s)
                if r not in regions and p >= 0
            ]
            inflated = any(
                p50s[r] >= 0 and others and p50s[r] >= 2 * max(others)
                for r in regions
            )
            ev["region_latency_inflated"] = bool(inflated)
            score += 1 if inflated else 0
        candidates.append(("gray-region", score, ev))

    # -- partition: copies lost at severed edges
    cut = int(d["cut"][w])
    if cut >= PART_CUT_MIN:
        ev = {"cut_copies": cut}
        pair = _cut_pair(region_pairs)
        if pair is not None:
            ev["pair"] = telem.region_pair_name(
                region_names, pair[0], pair[1]
            )
            ev["pair_cut_total"] = pair[2]
        score = 4 + (1 if int(d["stall_max"][w]) > 0 else 0)
        candidates.append(("partition", score, ev))

    # -- duel-churn: takeover/restart burst + consensus-dominated
    events = int(d["takeovers"][w]) + int(d["restarts"][w])
    if (
        events >= CHURN_MIN_EVENTS
        and 1000 * events >= CHURN_FACTOR_MILLI * max(base.events, 1)
    ):
        score = 4 + (1 if dom == "consensus" else 0)
        candidates.append(("duel-churn", score, {
            "takeovers": int(d["takeovers"][w]),
            "restarts": int(d["restarts"][w]),
            "events_baseline": base.events,
            "dominant_phase": dom,
        }))

    candidates.sort(key=lambda c: (-c[1], CAUSES.index(c[0])))
    return {
        "window": int(w),
        "span": [w * wr, (w + 1) * wr],
        "cause": candidates[0][0] if candidates else "unknown",
        "candidates": [
            {"cause": c, "score": s, "evidence": ev}
            for c, s, ev in candidates
        ],
        "ambiguous": (
            len(candidates) >= 2 and candidates[0][1] == candidates[1][1]
        ),
    }


def diagnose_breaches(
    d: dict,
    breach_windows,
    *,
    region_map=None,
    region_names: tuple = (),
    region_pairs: dict | None = None,
    region_series=None,
) -> dict:
    """Label every named breach window of one run: the diagnosis
    block the SLO verdicts carry (``serve/harness.slo_windows`` via
    ``attach_diagnosis``; fleet serve attaches it per flagged lane).
    The baseline excludes ALL breach windows — the run's healthy
    buckets define 'normal'."""
    breach_windows = [int(w) for w in breach_windows]
    base = SeriesBaseline(d, exclude=breach_windows)
    windows = [
        diagnose_window(
            d, w, base=base,
            region_map=region_map, region_names=region_names,
            region_pairs=region_pairs, region_series=region_series,
        )
        for w in breach_windows
    ]
    causes = sorted({v["cause"] for v in windows})
    # codes alongside the strings: verdict consumers (the admission
    # controller, the serve bench) key on these; strings stay for
    # human-facing reports
    return {
        "windows": windows,
        "causes": causes,
        "cause_ids": sorted(cause_code(c) for c in causes),
    }


def label_windows(
    d: dict,
    *,
    region_map=None,
    region_names: tuple = (),
    region_pairs: dict | None = None,
    region_series=None,
) -> list:
    """Top-cause label per window over the WHOLE series (``None`` for
    quiet/unremarkable buckets) — the generation-telemetry and
    Perfetto-annotation form, where no SLO names breach windows.
    Each window is judged against a baseline that excludes only
    itself, so a mid-run episode stands out against the healthy
    remainder."""
    n = len(d["decided"])
    out = []
    for w in range(n):
        if not (int(d["decided"][w]) or int(d["offered"][w])):
            out.append(None)
            continue
        v = diagnose_window(
            d, w, base=SeriesBaseline(d, exclude=(w,)),
            region_map=region_map, region_names=region_names,
            region_pairs=region_pairs, region_series=region_series,
        )
        out.append(None if v["cause"] == "unknown" else v["cause"])
    return out


def diagnose_series(
    d: dict,
    *,
    region_map=None,
    region_names: tuple = (),
    region_pairs: dict | None = None,
    region_series=None,
) -> dict:
    """Full diagnosis entries (the :func:`diagnose_window` dicts) for
    every active window whose top cause is not ``unknown`` — the
    SLO-free form (``python -m tpu_paxos_torch trace`` renders these as
    annotation instants when no SLO named breach windows)."""
    n = len(d["decided"])
    windows = []
    for w in range(n):
        if not (int(d["decided"][w]) or int(d["offered"][w])):
            continue
        v = diagnose_window(
            d, w, base=SeriesBaseline(d, exclude=(w,)),
            region_map=region_map, region_names=region_names,
            region_pairs=region_pairs, region_series=region_series,
        )
        if v["cause"] != "unknown":
            windows.append(v)
    return {
        "windows": windows,
        "causes": sorted({v["cause"] for v in windows}),
    }


def attach_diagnosis(
    slo_verdict: dict,
    windows_dict: dict,
    *,
    region_map=None,
    region_names: tuple = (),
    region_pairs: dict | None = None,
    region_series=None,
) -> dict:
    """Thread the diagnosis into one ``slo_windows`` verdict: the
    union of the global breach windows and every region's is labeled
    and stored under ``"diagnosis"`` (returns the verdict, mutated).
    No breach windows -> no block (schema stays additive)."""
    ws = set(int(w) for w in slo_verdict.get("breach_windows", ()))
    for v in slo_verdict.get("regions", {}).values():
        ws.update(int(w) for w in v.get("breach_windows", ()))
    if not ws:
        return slo_verdict
    slo_verdict["diagnosis"] = diagnose_breaches(
        windows_dict, sorted(ws),
        region_map=region_map, region_names=region_names,
        region_pairs=region_pairs, region_series=region_series,
    )
    return slo_verdict


def fingerprint(report: dict) -> str:
    """sha256 of the canonical JSON rendering — the replay-parity pin
    (two replays of one artifact must produce byte-identical
    diagnosis)."""
    return hashlib.sha256(
        json.dumps(report, sort_keys=True).encode()
    ).hexdigest()
