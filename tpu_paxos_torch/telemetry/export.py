"""Chrome-trace/Perfetto export: render a run as a browsable timeline
(port of ``tpu_paxos/telemetry/export.py``; the same JSON for the same
run).

A Chrome-trace JSON (the ``chrome://tracing`` / https://ui.perfetto.dev
format, a ``traceEvents`` array) with:

- **fault episodes as duration events** on per-node tracks, burst-loss
  windows on a synthetic "network" track;
- **decisions and commit takeovers as instant events** (decisions on a
  dedicated track with instance/vid/ballot args, takeovers on the
  proposer node's track at the recorder's first-takeover round);
- **counter tracks** (cumulative decided instances), with the full
  flight-recorder summary as the ``telemetry`` block of ``otherData``;
- **windowed counter tracks** from the summary's ``"windows"`` block:
  per-bucket latency p50/p99, observed drop rate, decisions, stall
  depth, backlog, cut copies and phase p50s on the same timeline as the
  episode spans;
- **per-instance phase flows** (a bounded sample of decided instances'
  queue/consensus/commit/learn spans linked by flow arrows) and the
  diagnosis plane's breach annotations.

One simulated round maps to one trace millisecond (``ROUND_US``).

``python -m tpu_paxos_torch trace <repro-artifact>`` renders a repro
artifact: the telemetry is recomputed at replay on ``--device`` (the
artifact schema is closed; no recorder field is stored), and the
artifact is never modified.  ``trace --serve`` runs an open-loop
serving stream (or one lane of a serve fleet) and renders its timeline
(:func:`trace_serve`).  A controlled-serve artifact (engine ``"serve"``)
renders as JAX renders it: its config and workload replayed closed-loop,
recorder-free.  An ``mc-control`` artifact carries no engine run to
render: it fails the repro schema, as it does for JAX's ``trace`` (the
schema error line, exit 2).  A sharded artifact (engine ``"sharded"``)
replays on a mesh of its recorded devices, recorder-free, as in JAX (the
sharded build takes no recorder): episodes and decisions render.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

#: Trace microseconds per simulated round (1 round = 1 ms: round
#: numbers read directly off the Perfetto grid in milliseconds).
ROUND_US = 1000

#: Default cap on per-instance decision instants (a million-instance
#: run must not emit a million events; the counter track still shows
#: the totals).  Dropped events are counted in otherData AND called
#: out by a visible annotation instant on the decision track at the
#: cap point; ``python -m tpu_paxos_torch trace --max-decision-events N``
#: overrides per render.
MAX_DECISION_EVENTS = 1024

#: Default cap on per-instance PHASE FLOW samples: each sampled
#: instance renders its queue/consensus/commit/learn spans on its own
#: row of the ``phases`` process, linked by a flow arrow, so one
#: value's whole life is one connected path through the timeline.
#: The first N decided instances by decision round are sampled
#: (deterministic); ``--max-flow-instances`` overrides.
MAX_FLOW_INSTANCES = 64

_NET_TRACK = "network"
_DECISION_TRACK = "decisions"
_TELEMETRY_TRACK = "telemetry"
_PHASES_TRACK = "phases"


def _ev(ph, name, pid, tid=0, ts=0, **kw):
    e = {"ph": ph, "name": name, "pid": pid, "tid": tid, "ts": ts}
    e.update(kw)
    return e


def _meta(events, pid, name):
    events.append(
        _ev("M", "process_name", pid, args={"name": name})
    )


def _episode_events(schedule, n_nodes: int, net_pid: int) -> list:
    """Fault episodes as ``X`` (complete) duration events: one per
    affected node per episode, plus burst windows on the network
    track."""
    events = []
    if schedule is None:
        return events
    for e in schedule.episodes:
        ts, dur = e.t0 * ROUND_US, (e.t1 - e.t0) * ROUND_US
        if e.kind == "partition":
            # unlisted nodes form one implicit extra group
            # (core/faults.partition) — they are equally cut off and
            # must show a bar, or the timeline reads as fault-free
            # on exactly the nodes a wedge's quorum math hinges on
            listed = {int(n) for g in e.groups for n in g}
            implicit = tuple(sorted(set(range(n_nodes)) - listed))
            groups = tuple(e.groups) + ((implicit,) if implicit else ())
            for gi, group in enumerate(groups):
                for node in group:
                    events.append(_ev(
                        "X", f"partition side {gi}", int(node), ts=ts,
                        dur=dur, args={"t0": e.t0, "t1": e.t1},
                    ))
        elif e.kind == "one_way":
            for node in e.src:
                events.append(_ev(
                    "X", f"one_way send-dark to {sorted(e.dst)}",
                    int(node), ts=ts, dur=dur,
                    args={"t0": e.t0, "t1": e.t1},
                ))
        elif e.kind == "pause":
            for node in e.nodes:
                events.append(_ev(
                    "X", "pause", int(node), ts=ts, dur=dur,
                    args={"t0": e.t0, "t1": e.t1},
                ))
        elif e.kind == "burst":
            events.append(_ev(
                "X", f"burst drop +{e.drop_rate}/1e4", net_pid,
                ts=ts, dur=dur,
                args={"t0": e.t0, "t1": e.t1, "drop_rate": e.drop_rate},
            ))
        elif e.kind == "gray":
            for node in e.nodes:
                events.append(_ev(
                    "X", f"gray +{e.delay} rounds", int(node), ts=ts,
                    dur=dur,
                    args={"t0": e.t0, "t1": e.t1, "delay": e.delay},
                ))
        elif e.kind == "crash":
            for node in e.nodes:
                events.append(_ev(
                    "i", "crash point", int(node), ts=ts, s="p",
                    args={"t0": e.t0},
                ))
    return events


def _window_counter_events(windows: dict, tele_pid: int) -> list:
    """The windowed series as Perfetto counter tracks: one ``C``
    event per (series, bucket) at the bucket's START round, so the
    curves step exactly on the window grid the recorder accumulated
    on and line up with the episode duration bars.  Empty-bucket
    latency quantiles (-1) are skipped rather than rendered (a -1
    dip would read as a latency collapse)."""
    events = []
    wr = int(windows["window_rounds"])
    n = int(windows["n_windows"])

    def counter(name, series, skip_neg=False):
        for w in range(n):
            v = series[w]
            if skip_neg and v < 0:
                continue
            events.append(_ev(
                "C", name, tele_pid, ts=w * wr * ROUND_US,
                args={name: v},
            ))

    counter("latency p50 (rounds)", windows["latency_p50"],
            skip_neg=True)
    counter("latency p99 (rounds)", windows["latency_p99"],
            skip_neg=True)
    counter("drop rate (/1e4)", windows["drop_rate_observed"])
    counter("decided / window", windows["decided"])
    counter("stall depth", windows["stall_max"])
    counter("takeovers / window", windows["takeovers"])
    # the diagnosis plane's inputs as visible curves —
    # queue depth (saturation), severed-edge losses (partition), and
    # the per-phase latency decomposition (queue-dominated vs
    # consensus-dominated reads directly off the stacked curves)
    if "backlog_max" in windows:
        counter("queue backlog", windows["backlog_max"])
        counter("cut copies / window", windows["cut"])
        for name, series in windows.get("phase_p50", {}).items():
            counter(f"phase {name} p50 (rounds)", series,
                    skip_neg=True)
    return events


def _diagnosis_events(diagnosis: dict, tele_pid: int) -> list:
    """Breach-attribution annotations (telemetry/diagnose.py): one
    instant per diagnosed window at the window's start, named by its
    top cause, with the full ranked candidate list in args — an
    ambiguous window announces every qualifying cause."""
    events = []
    for v in (diagnosis or {}).get("windows", ()):
        ranked = "+".join(c["cause"] for c in v["candidates"]) or "unknown"
        events.append(_ev(
            "i", f"breach w{v['window']}: {ranked}", tele_pid,
            ts=int(v["span"][0]) * ROUND_US, s="p",
            args={
                "window": v["window"],
                "cause": v["cause"],
                "ambiguous": v["ambiguous"],
                "candidates": v["candidates"],
            },
        ))
    return events


def _phase_flow_events(
    phase_ledger: dict,
    chosen_vid,
    chosen_round,
    phases_pid: int,
    max_instances: int = MAX_FLOW_INSTANCES,
) -> tuple[list, int, int]:
    """Causal per-instance phase spans: for a bounded sample of
    decided instances (first N by decision round — deterministic),
    one row of ``X`` slices per instance (queue / consensus / commit /
    learn, where each stamp exists) linked by a flow arrow
    (``s``/``t``/``f`` with the vid as flow id), so one value's whole
    life reads as a connected path.  Returns ``(events, rendered,
    dropped)``."""
    from tpu_paxos_torch.core import values as val

    admit = np.asarray(phase_ledger["admit_round"])
    batch = np.asarray(phase_ledger["batch_round"])
    learned = np.asarray(phase_ledger["learned_round"])
    committed = np.asarray(phase_ledger["committed_round"])
    chosen_vid = np.asarray(chosen_vid)
    chosen_round = np.asarray(chosen_round)
    none = int(val.NONE)
    decided = np.flatnonzero(
        (chosen_vid != none) & (admit != none) & (batch != none)
    )
    order = decided[np.argsort(chosen_round[decided], kind="stable")]
    cap = max(0, int(max_instances))
    events = []
    for slot, i in enumerate(order[:cap].tolist()):
        spans = [
            # queue-wait renders only where it exists (ingest-stamped
            # serve runs); the closed loop admits AT the first batch
            ("queue", int(admit[i]), int(batch[i]), True),
            ("consensus", int(batch[i]), int(chosen_round[i]), False),
            ("commit", int(chosen_round[i]), int(committed[i]), False),
            ("learn", int(chosen_round[i]), int(learned[i]), False),
        ]
        fid = int(chosen_vid[i])
        flow = []
        for name, t0, t1, skip_empty in spans:
            if t0 < 0 or t1 < 0 or t1 < t0 or (skip_empty and t1 == t0):
                continue
            ts = t0 * ROUND_US
            events.append(_ev(
                "X", f"{name} [{i}]", phases_pid, tid=slot, ts=ts,
                dur=max((t1 - t0) * ROUND_US, 1),
                args={"instance": i, "vid": fid, "t0": t0, "t1": t1,
                      "rounds": t1 - t0},
            ))
            flow.append(_ev(
                "t", f"value {fid}", phases_pid, tid=slot, ts=ts,
                id=fid, cat="phase",
            ))
        if flow:
            flow[0]["ph"] = "s"
            if len(flow) > 1:
                flow[-1]["ph"] = "f"
                flow[-1]["bp"] = "e"
            events.extend(flow)
    rendered = min(len(order), cap)
    return events, rendered, max(0, len(order) - cap)


def _region_counter_events(
    region_pairs: dict, tele_pid: int, t_end_us: int
) -> list:
    """The per-REGION-pair fault breakdown as counter tracks: one
    ``drop rate r<s>-><d>`` counter per pair with traffic (run-total
    observed rate, rendered flat across the run so a gray/lossy WAN
    link stands out next to the time-resolved tracks).  Rendered only
    for multi-region runs — the 1x1 unassigned collapse says
    nothing the global drop-rate track doesn't."""
    events = []
    n = int(region_pairs.get("n_regions", 1))
    if n <= 1:
        return events
    from tpu_paxos_torch.telemetry import recorder as telem

    names = telem.region_prefix_names(
        region_pairs.get("names", ()), n
    )
    rates = region_pairs["drop_rate_observed"]
    offered = region_pairs["offered"]
    cut = region_pairs.get("cut")
    for s in range(n):
        for d in range(n):
            if not offered[s][d] and not (cut and cut[s][d]):
                continue
            pair = f"{names[s]}->{names[d]}"
            name = f"region drop {pair} (/1e4)"
            for ts in (0, t_end_us):
                events.append(_ev(
                    "C", name, tele_pid, ts=ts,
                    args={name: rates[s][d]},
                ))
            if cut and cut[s][d]:
                cname = f"region cut {pair} (copies)"
                for ts in (0, t_end_us):
                    events.append(_ev(
                        "C", cname, tele_pid, ts=ts,
                        args={cname: cut[s][d]},
                    ))
    return events


def chrome_trace(
    cfg, result, summary_dict=None, label="tpu-paxos",
    max_decision_events: int = MAX_DECISION_EVENTS,
    phase_ledger: dict | None = None,
    diagnosis: dict | None = None,
    max_flow_instances: int = MAX_FLOW_INSTANCES,
) -> dict:
    """Build the Chrome-trace dict for one run.

    ``result`` is a ``core/sim.SimResult``; ``summary_dict`` is the
    flight recorder's ``summary_to_dict`` output (or None for
    recorder-free replays, e.g. sharded artifacts) — when it carries
    the windowed ``"windows"`` block, the series render as counter
    tracks on a dedicated telemetry process.  ``max_decision_events``
    caps the per-instance decision instants; hitting the cap emits a
    visible "N decision instants dropped" annotation at the cap
    point instead of truncating silently.

    ``phase_ledger`` (the per-instance admit/batch/learned/committed
    stamps, ``sim.run_with_telemetry(return_ledger=True)``) adds the
    CAUSAL plane: a bounded sample of instances rendered as
    flow-linked queue/consensus/commit/learn spans on a ``phases``
    process.  ``diagnosis`` (telemetry/diagnose.py output) adds
    breach-attribution annotation instants on the telemetry track."""
    from tpu_paxos_torch.core import values as val

    a = cfg.n_nodes
    net_pid, dec_pid, tele_pid, phase_pid = a, a + 1, a + 2, a + 3
    windows = (summary_dict or {}).get("windows")
    events = []
    for node in range(a):
        role = " (proposer)" if node in cfg.proposers else ""
        _meta(events, node, f"node {node}{role}")
    _meta(events, net_pid, _NET_TRACK)
    _meta(events, dec_pid, _DECISION_TRACK)
    if windows is not None:
        _meta(events, tele_pid, _TELEMETRY_TRACK)
        events += _window_counter_events(windows, tele_pid)
        events += _diagnosis_events(diagnosis, tele_pid)
    region_pairs = (summary_dict or {}).get("region_pairs")
    if region_pairs is not None and windows is not None:
        events += _region_counter_events(
            region_pairs, tele_pid, int(result.rounds) * ROUND_US
        )
    flows_rendered = flows_dropped = 0
    if phase_ledger is not None:
        _meta(events, phase_pid, _PHASES_TRACK)
        flow_ev, flows_rendered, flows_dropped = _phase_flow_events(
            phase_ledger, result.chosen_vid, result.chosen_round,
            phase_pid, max_flow_instances,
        )
        events += flow_ev
    events += _episode_events(cfg.faults.schedule, a, net_pid)

    # decisions: instants on the decision track + a cumulative counter
    chosen_vid = np.asarray(result.chosen_vid)
    chosen_round = np.asarray(result.chosen_round)
    chosen_ballot = np.asarray(result.chosen_ballot)
    decided = np.flatnonzero(chosen_vid != int(val.NONE))
    order = decided[np.argsort(chosen_round[decided], kind="stable")]
    # a negative cap would slice from the tail AND over-count the
    # dropped events; clamp — 0 legitimately means "counters only"
    cap = max(0, int(max_decision_events))
    for k, i in enumerate(order[:cap]):
        events.append(_ev(
            "i", f"decide [{int(i)}]", dec_pid,
            ts=int(chosen_round[i]) * ROUND_US, s="g",
            args={
                "instance": int(i),
                "vid": int(chosen_vid[i]),
                "ballot": int(chosen_ballot[i]),
                "round": int(chosen_round[i]),
            },
        ))
    n_dropped = max(0, int(len(decided)) - cap)
    if n_dropped:
        # the cap must be VISIBLE in the trace itself, not only in
        # otherData: an instant at the last rendered decision's round
        # says exactly how much of the tail is missing
        last_ts = int(chosen_round[order[cap - 1]]) if cap else 0
        events.append(_ev(
            "i", f"{n_dropped} decision instants dropped (cap {cap})",
            dec_pid, ts=last_ts * ROUND_US, s="g",
            args={"dropped": n_dropped, "cap": cap},
        ))
    rounds, counts = np.unique(chosen_round[decided], return_counts=True)
    cum = 0
    for r, n in zip(rounds.tolist(), counts.tolist()):
        cum += n
        events.append(_ev(
            "C", "decided", dec_pid, ts=int(r) * ROUND_US,
            args={"instances": cum},
        ))

    # commit takeovers: instants on the adopting proposer's node track
    if summary_dict is not None:
        for pi, tr in enumerate(summary_dict.get("takeover_round", [])):
            if tr is not None and int(tr) >= 0:
                events.append(_ev(
                    "i", "commit takeover", int(cfg.proposers[pi]),
                    ts=int(tr) * ROUND_US, s="p",
                    args={"proposer": pi, "round": int(tr)},
                ))

    other = {
        "label": label,
        "rounds": int(result.rounds),
        "done": bool(result.done),
        "n_nodes": a,
        "decided": int(len(decided)),
        "decision_events_dropped": n_dropped,
        "decision_events_cap": cap,
        "round_us": ROUND_US,
    }
    if phase_ledger is not None:
        other["flow_instances"] = flows_rendered
        other["flow_instances_dropped"] = flows_dropped
    if diagnosis is not None:
        other["diagnosis"] = diagnosis
    if summary_dict is not None:
        other["telemetry"] = summary_dict
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def trace_artifact(
    path: str, max_decision_events: int = MAX_DECISION_EVENTS,
    max_flow_instances: int = MAX_FLOW_INSTANCES, device="cuda",
) -> dict:
    """Re-execute a repro artifact on ``device`` with the flight recorder
    armed (the windowed plane included) and render the Chrome trace:
    counter tracks, the per-instance phase flow spans, and the diagnosis
    plane's cause annotations.  Telemetry is recomputed at replay, never
    read from (or written to) the artifact.  Artifacts of other engines
    (``"serve"``, ``"sharded"``) replay their config and workload through
    ``shrink.run_case`` recorder-free: episodes and decisions still
    render, as in JAX."""
    from tpu_paxos_torch.core import sim as simm
    from tpu_paxos_torch.harness import shrink as shr
    from tpu_paxos_torch.telemetry import diagnose as diag
    from tpu_paxos_torch.telemetry import recorder as telem

    case, art = shr.load_artifact(path)
    ledger = diagnosis = summary_dict = None
    if case.engine == "sim":
        result, summ, wsum, ledger = simm.run_with_telemetry(
            case.cfg, case.workload, case.gates, return_ledger=True, device=device,
        )
        summary_dict = telem.summary_to_dict(summ, wsum, telem.WINDOW_ROUNDS)
        diagnosis = diag.diagnose_series(
            summary_dict["windows"], region_pairs=summary_dict["region_pairs"],
        )
    else:
        result, _ = shr.run_case(case, device=device)
    trace = chrome_trace(
        case.cfg, result, summary_dict, label=path,
        max_decision_events=max_decision_events,
        phase_ledger=ledger,
        diagnosis=diagnosis,
        max_flow_instances=max_flow_instances,
    )
    trace["otherData"]["artifact"] = path
    trace["otherData"]["recorded_violation"] = art["violation"]
    trace["otherData"]["engine"] = case.engine
    return trace


def _serve_ledger(tele_pair, ingest, chosen_vid) -> dict:
    """The phase-ledger dict for one serve stream (host numpy, in JAX's
    key order): admission from the INGEST table (the serving queue's
    real wait; ``recorder.serve_admit_rounds`` owns the hole-fill and
    out-of-table rules), batch/learned/committed from the recorder's
    in-loop stamps.  ``tele_pair`` is one stream's (Telemetry,
    TelemetryWindows) pair of tensors without a lane axis."""
    from tpu_paxos_torch.telemetry import recorder as telem

    base = tele_pair[0]
    return {
        "admit_round": telem.serve_admit_rounds(ingest, chosen_vid).cpu().numpy(),
        "batch_round": base.admit_round.cpu().numpy(),
        "learned_round": base.learned_round.cpu().numpy(),
        "committed_round": base.committed_round.cpu().numpy(),
    }


def trace_serve(args) -> dict:
    """``python -m tpu_paxos_torch trace --serve``: run an open-loop
    serve (or serve-fleet) stream on ``args.device`` and render its
    windowed series, phase flow spans and breach-attribution
    annotations as a Perfetto timeline."""
    import types

    from tpu_paxos_torch.config import FaultConfig, SimConfig
    from tpu_paxos_torch.core import sim as simm
    from tpu_paxos_torch.core import wan as wanm
    from tpu_paxos_torch.serve import arrivals as arrv
    from tpu_paxos_torch.serve import harness as sh
    from tpu_paxos_torch.telemetry import diagnose as diag

    preset = wanm.PRESETS[args.preset] if args.preset else None
    if preset is not None:
        faults = wanm.wan_fault_config(preset, args.nodes)
        region_map = wanm.node_regions(preset, args.nodes)
        region_names = preset.regions
    else:
        faults = FaultConfig(
            drop_rate=args.drop_rate, dup_rate=args.dup_rate,
            max_delay=args.max_delay, crash_rate=args.crash_rate,
        )
        region_map, region_names = None, ()
    n_values = int(args.values)
    cfg = SimConfig(
        n_nodes=args.nodes,
        n_instances=max(64, 2 * n_values),
        proposers=tuple(range(args.proposers)),
        seed=args.seed,
        max_rounds=args.max_rounds,
        faults=faults,
    )
    slo = (
        sh.ServeSLO(latency_rounds=args.slo_latency,
                    budget_milli=args.slo_budget_milli)
        if args.slo_latency else None
    )
    rate = int(args.rate_milli)
    if args.lanes > 1:
        from tpu_paxos_torch.serve import fleet as sfleet

        lanes = sfleet.fleet_lanes(
            cfg, args.lanes, n_values, rate, args.seed, args.arrivals
        )
        frep = sfleet.serve_fleet_run(
            cfg, lanes,
            rounds_per_window=args.rounds_per_window,
            windows_per_dispatch=args.windows_per_dispatch,
            slo=slo,
            region_map=region_map, region_names=region_names,
            device=args.device,
        )
        li = int(args.lane)
        if not 0 <= li < frep.n_lanes:
            raise SystemExit(
                f"--lane {li} out of range for --lanes {frep.n_lanes}"
            )
        sd = frep.lane_summary(li)
        tele_pair = simm.lane_of(frep.final.tele, li)
        ingest = frep.final.ingest[li]
        met = frep.final.sim.met
        chosen_vid = met.chosen_vid[li]
        result = types.SimpleNamespace(
            chosen_vid=chosen_vid.cpu().numpy(),
            chosen_round=met.chosen_round[li].cpu().numpy(),
            chosen_ballot=met.chosen_ballot[li].cpu().numpy(),
            rounds=frep.rounds, done=frep.done,
        )
        verdict = (frep.slo or {}).get(li)
        diagnosis = (verdict or {}).get("diagnosis")
        region_series = frep.lane_region_windows(li)
        label = f"serve fleet lane {li}/{frep.n_lanes} @ {rate}/1000"
        extra = {
            "engine": "serve_fleet", "lane": li,
            "lanes": frep.n_lanes,
            "breach_lanes": [
                int(i) for i in np.flatnonzero(frep.breach)
            ],
        }
    else:
        vids = np.arange(n_values, dtype=np.int32)
        if rate <= 0:
            rounds = arrv.immediate_rounds(n_values)
        else:
            rounds = arrv.ARRIVAL_BUILDERS[args.arrivals](
                n_values, rate, args.seed
            )
        streams, arrs = arrv.split_round_robin(
            vids, rounds, args.proposers
        )
        rep = sh.serve_run(
            cfg, streams, arrs,
            rounds_per_window=args.rounds_per_window,
            windows_per_dispatch=args.windows_per_dispatch,
            slo=slo,
            region_map=region_map, region_names=region_names,
            keep_state=True,
            device=args.device,
        )
        ss = rep.final_state
        sd = rep.summary
        tele_pair = ss.tele
        ingest = ss.ingest
        chosen_vid = ss.sim.met.chosen_vid
        result = types.SimpleNamespace(
            chosen_vid=rep.chosen_vid,
            chosen_round=ss.sim.met.chosen_round.cpu().numpy(),
            chosen_ballot=rep.chosen_ballot,
            rounds=rep.rounds, done=rep.done,
        )
        diagnosis = (rep.slo or {}).get("diagnosis")
        region_series = rep.region_windows
        label = f"serve @ {rate}/1000 ({args.arrivals})"
        extra = {"engine": "serve", "slo_ok": (
            rep.slo["ok"] if rep.slo is not None else None
        )}
    if diagnosis is None and sd.get("windows") is not None:
        # no SLO (or no breach): annotate notable windows anyway
        diagnosis = diag.diagnose_series(
            sd["windows"],
            region_map=region_map, region_names=tuple(region_names),
            region_pairs=sd.get("region_pairs"),
            region_series=region_series,
        )
    ledger = _serve_ledger(tele_pair, ingest, chosen_vid)
    trace = chrome_trace(
        cfg, result, sd, label=label,
        max_decision_events=args.max_decision_events,
        phase_ledger=ledger,
        diagnosis=diagnosis,
        max_flow_instances=args.max_flow_instances,
    )
    trace["otherData"].update(extra)
    trace["otherData"]["rate_milli"] = rate
    trace["otherData"]["arrivals"] = args.arrivals
    if args.preset:
        trace["otherData"]["preset"] = args.preset
    return trace


def main(argv=None) -> int:
    """``python -m tpu_paxos_torch trace <artifact>`` — render a repro
    artifact as a Chrome-trace JSON timeline (open in
    https://ui.perfetto.dev or chrome://tracing).  ``--serve`` runs an
    open-loop serving stream instead (``--lanes N --lane i`` a serve
    fleet's lane) and renders its windowed series, phase spans and
    diagnosis annotations.  Exit 0 on a rendered trace; 2 for a
    malformed artifact (a summary naming the field) and for artifacts of
    engines the port does not replay yet."""
    ap = argparse.ArgumentParser(
        prog="python -m tpu_paxos_torch trace",
        description="render a stress-triage repro artifact — or, with "
        "--serve, a fresh open-loop serving run — as a "
        "Chrome-trace/Perfetto timeline (telemetry recomputed at "
        "replay; artifacts are never modified)",
    )
    ap.add_argument("artifact", nargs="?", default="",
                    help="path to a repro .json (written by the "
                    "stress sweep's --triage-dir); omit with --serve")
    ap.add_argument("--serve", action="store_true",
                    help="serve mode: run an open-loop stream "
                    "(serve/harness.py; --lanes N for a fleet "
                    "lane) and export ITS timeline instead of "
                    "replaying an artifact")
    ap.add_argument("--values", type=int, default=128,
                    help="[serve] values in the arriving stream")
    ap.add_argument("--rate-milli", type=int, default=2000,
                    help="[serve] offered load (values/1000 rounds; "
                    "0 = everything at round 0)")
    ap.add_argument("--arrivals", type=str, default="poisson",
                    help="[serve] arrival process (serve/arrivals.py)")
    ap.add_argument("--nodes", type=int, default=5)
    ap.add_argument("--proposers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-rounds", type=int, default=20_000)
    ap.add_argument("--rounds-per-window", type=int, default=8)
    ap.add_argument("--windows-per-dispatch", type=int, default=8)
    ap.add_argument("--slo-latency", type=int, default=0,
                    help="[serve] latency SLO in rounds (arms the "
                    "burn-rate monitor + breach attribution)")
    ap.add_argument("--slo-budget-milli", type=int, default=100)
    ap.add_argument("--preset", type=str, default="",
                    help="[serve] WAN topology preset (core/wan.py: "
                    "wan-3region / wan-5region) — arms the per-edge "
                    "fault matrices, the region map, and region-named "
                    "breach attribution")
    ap.add_argument("--lanes", type=int, default=1,
                    help="[serve] >1: run a serve FLEET of this many "
                    "tenant lanes and export --lane's timeline")
    ap.add_argument("--lane", type=int, default=0,
                    help="[serve] which fleet lane to export")
    ap.add_argument("--drop-rate", type=int, default=0)
    ap.add_argument("--dup-rate", type=int, default=0)
    ap.add_argument("--max-delay", type=int, default=0)
    ap.add_argument("--crash-rate", type=int, default=0)
    ap.add_argument("--max-flow-instances", type=int,
                    default=MAX_FLOW_INSTANCES,
                    help="cap on flow-linked per-instance phase-span "
                    "samples on the phases track")
    ap.add_argument("--out", type=str, default="",
                    help="write the trace JSON here (default: "
                    "<artifact>.trace.json)")
    ap.add_argument("--stdout", action="store_true",
                    help="print the trace JSON to stdout instead of "
                    "writing a file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--max-decision-events", type=int,
                    default=MAX_DECISION_EVENTS,
                    help="cap on per-instance decision instants; a "
                    "hit cap renders a visible 'N dropped' "
                    "annotation in the trace")
    ap.add_argument("--json", action="store_true",
                    help="emit a JSON status line instead of the "
                    "verdict line")
    ap.add_argument("--log-level", type=str, default="INFO")
    args = ap.parse_args(argv)
    import os

    if bool(args.serve) == bool(args.artifact):
        ap.error("exactly one of <artifact> or --serve required")
    if args.serve:
        # fail at the argparse boundary, not as an engine traceback
        for flag, v, floor in (
            ("--values", args.values, 1),
            ("--rounds-per-window", args.rounds_per_window, 1),
            ("--windows-per-dispatch", args.windows_per_dispatch, 1),
            ("--lanes", args.lanes, 1),
            ("--rate-milli", args.rate_milli, 0),
            ("--slo-latency", args.slo_latency, 0),
        ):
            if v < floor:
                ap.error(f"{flag} must be >= {floor} (got {v})")
        if not 0 <= args.lane < args.lanes:
            ap.error(
                f"--lane {args.lane} out of range for "
                f"--lanes {args.lanes}"
            )
    if args.preset:
        from tpu_paxos_torch.core import wan as wanm

        if args.preset not in wanm.PRESETS:
            ap.error(
                f"unknown --preset {args.preset!r} "
                f"(have: {', '.join(sorted(wanm.PRESETS))})"
            )
    # same determinism surface as `repro`: replay output must not
    # capture wall clock
    os.environ.setdefault("TPU_PAXOS_DETERMINISTIC", "1")
    from tpu_paxos_torch.__main__ import _emit
    from tpu_paxos_torch.analysis.artifact_schema import ArtifactSchemaError
    from tpu_paxos_torch.utils import log as logm

    logger = logm.get_logger("trace", logm.parse_level(args.log_level))
    try:
        if args.serve:
            trace = trace_serve(args)
        else:
            trace = trace_artifact(
                args.artifact,
                max_decision_events=args.max_decision_events,
                max_flow_instances=args.max_flow_instances,
                device=args.device,
            )
    except ArtifactSchemaError as e:
        logger.error("%s", e)
        _emit(args, {
            "engine": "trace", "ok": False,
            "schema_error": {"field": e.field, "problem": e.problem},
        })
        return 2
    text = json.dumps(trace, indent=1, sort_keys=True)
    if args.stdout:
        sys.stdout.write(text + "\n")
        return 0
    out = args.out or (
        (args.artifact + ".trace.json") if args.artifact
        else "serve.trace.json"
    )
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        f.write(text + "\n")
    os.replace(tmp, out)
    logger.info("trace written to %s", out)
    _emit(args, {
        "engine": "trace",
        "ok": True,
        "out": out,
        "events": len(trace["traceEvents"]),
        "rounds": trace["otherData"]["rounds"],
        "decided": trace["otherData"]["decided"],
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
