"""The serve driver: dispatch windows over the general engine's round
(port of ``tpu_paxos/serve/driver.py``).

One :func:`build_serve_window` call is ONE DISPATCH carrying ``S``
admission windows (``admits``/``arrs`` are ``[S, P, K]``): for each
sub-window it stamps the uploaded values' arrival rounds into the
per-vid ingest table, appends them to the proposer queues
(``core/sim.admit_block``) and runs ``rounds_per_window`` engine rounds
with the flight recorder armed; the dispatch epilogue reduces the
run-so-far commit-latency histogram on the device
(``telemetry/recorder.summarize`` with ``admit_round`` replaced by the
ingest-time stamps, ``recorder.serve_admit_rounds``).

Where JAX runs the ``S x R`` rounds in one ``fori_loop``, the port calls
the round function ``S x R`` times (``round_fn.lanes``, every lane
running): a dispatch is a FIXED span with no early exit, so rounds run
past quiescence, before arrivals come and through a lull, exactly as
JAX's; decisions are write-once and idle rounds event-gated, so those
rounds are decision-neutral.  It does not go through
``core/sim.run_lanes``, which freezes finished lanes and parks fixed
points.  The virtual clock after dispatch ``d`` is ``(d+1) * S * R``.

The round reads its block predicates on the host (about 14 syncs a
round, PERF.md), so the JAX driver's "one host sync per dispatch" does
not carry over; a dispatch adds one read of the clock.  The loop state
(engine state, recorder, ingest table) is consumed by the dispatch, as
JAX's donated argument is: the kernels update the acceptor arrays and
the ack cube in place.

Every function works on a leading lane axis internally; a single run is
one lane of it, and its :class:`ServeLoopState` carries no lane axis
(JAX's shapes, so ``interop.serve_state_from_jax`` crosses field by
field).  The fleet (``serve/fleet.py``) runs the same dispatch over
``[L, ...]`` states.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from tpu_paxos_torch.config import FaultConfig, SimConfig
from tpu_paxos_torch.core import sim as simm
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.telemetry import recorder as telem
from tpu_paxos_torch.utils import device as devm
from tpu_paxos_torch.utils import prng

_I32 = torch.int32


class ServeLoopState(NamedTuple):
    """The whole-run loop state chained across dispatches (JAX's donated
    argument)."""

    sim: object  # simm.SimState, the engine state incl. the queue ring
    tele: object  # telem.Telemetry; on a windowed build (window_rounds
    #     > 0) the (Telemetry, TelemetryWindows) pair
    ingest: object  # [V] int32 arrival round per vid (NONE: never)


def empty_queues(cfg: SimConfig, workload):
    """Queue arrays sized by the FULL planned value stream (the capacity
    proof ``admit_block`` relies on) but EMPTY: open-loop runs start
    with nothing queued and admit at window boundaries.  Returns
    ``(pend, gate, tail, queue_cap)`` (numpy)."""
    pend, gate, tail, c = simm.prepare_queues(cfg, workload, None)
    return (
        np.full_like(pend, int(val.NONE)),
        gate,  # all NONE already: serve traffic is ungated
        np.zeros_like(tail),
        c,
    )


def vid_bound_of(workload) -> int:
    """Ingest-table size: one slot per vid up to the stream's max."""
    hi = max((int(np.max(w)) for w in workload if len(w)), default=-1)
    if hi < 0:
        raise ValueError("serve workload must carry at least one value")
    return hi + 1


def init_serve_state(
    cfg: SimConfig, workload, vid_bound: int, root,
    window_rounds: int = 0,
    geometry=None, geom=None, pknobs=None,
    device="cuda",
) -> tuple[ServeLoopState, int]:
    """Fresh loop state for one serve run on ``device``: empty queues,
    zeroed recorder (plus zeroed window rings when ``window_rounds`` is
    nonzero; it must match the builder's), all-NONE ingest table.
    Geometry-padded serving passes the builder's GeometryEnvelope plus
    the tenant's ``geom``/``pknobs`` (``core/geom``), so the initial
    backoff draw matches the true geometry.  Returns ``(state,
    queue_cap)``."""
    dev = devm.resolve(device)
    pend, gate, tail, c = empty_queues(cfg, workload)
    st = simm.init_state(cfg, pend, gate, tail, root, device=dev,
                         geometry=geometry, geom=geom, pknobs=pknobs)
    tele = simm.lane_of(
        telem.init_telemetry(cfg.n_instances, len(cfg.proposers), cfg.n_nodes, device=dev), 0)
    if window_rounds:
        tele = (tele, simm.lane_of(telem.init_windows(cfg.n_nodes, device=dev), 0))
    ingest = torch.full((int(vid_bound),), val.NONE, dtype=_I32, device=dev)
    return ServeLoopState(sim=st, tele=tele, ingest=ingest), c


def upload_blocks(admits, arrs, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A dispatch's admission blocks (numpy, any equal shapes) on
    ``device`` in ONE copy through pinned memory; tensors pass as given."""
    if isinstance(admits, torch.Tensor):
        return admits, arrs
    both = np.stack([np.asarray(admits, np.int32), np.asarray(arrs, np.int32)])
    both = devm.to_device(torch.from_numpy(both), device)
    return both[0], both[1]


def _stamp(ingest: torch.Tensor, admit: torch.Tensor, arr: torch.Tensor, v_bound: int):
    """Ingest-time stamping of every lane: each uploaded vid's ARRIVAL
    round enters ``ingest [L, V]``; NONE padding and out-of-table vids
    route to a spill slot ``V`` that is cut off (JAX's ``mode="drop"``
    scatter), never onto a real vid."""
    lanes = ingest.shape[0]
    flat_v = admit.reshape(lanes, -1)
    idx = torch.where((flat_v >= 0) & (flat_v < v_bound), flat_v, v_bound).long()
    buf = torch.cat([ingest, ingest.new_zeros((lanes, 1))], dim=1)
    buf.scatter_(1, idx, arr.reshape(lanes, -1).to(_I32))
    return buf[:, :v_bound].contiguous()


def run_window_lanes(round_fn, roots, st, tl, ingest, admits, arrs, rounds_per_window: int,
                     v_bound: int, geom=None, pknobs=None, keeps=None):
    """One dispatch's rounds over a leading lane axis: ``st``/``tl``/
    ``ingest`` lane-stacked, ``admits``/``arrs`` ``[L, S, P, K]`` on the
    state's device, ``roots`` ``[L, 2]``.  Every lane runs every round of
    the span (one round counter, read once).  ``keeps`` (``[L, S, P, K]``
    bool, the admission controller's shed mask) admits only the kept
    values, and only they stamp ingest: a shed value never enters the
    engine, so it must not enter the latency ledger.  Returns ``(st, tl,
    ingest)``."""
    t = int(st.t.reshape(-1)[0])
    for i in range(admits.shape[1]):
        if keeps is None:
            ingest = _stamp(ingest, admits[:, i], arrs[:, i], v_bound)
            st = simm.admit_block(st, admits[:, i])
        else:
            kept = torch.where(keeps[:, i], admits[:, i], val.NONE)
            ingest = _stamp(ingest, kept, arrs[:, i], v_bound)
            st = simm.admit_block(st, admits[:, i], keep=keeps[:, i])
        for _ in range(int(rounds_per_window)):
            st, tl = round_fn.lanes(roots, st, t, tele=tl, geom=geom, pknobs=pknobs)
            t += 1
    return st, tl, ingest


def epilogue(st, tl, ingest, window_rounds: int, region_map=None):
    """The dispatch epilogue over a lane axis: the run-so-far summary with
    admission stamped at ingest, and with a windowed plane the windowed
    series, whose queue-wait phase runs from INGEST to the recorder's
    own first-accept stamp.  Returns ``(summary, windows | None, adm)``,
    ``[L, ...]`` tensors, ``adm`` the ingest-stamped admission rounds."""
    adm = telem.serve_admit_rounds(ingest, st.met.chosen_vid)
    if not window_rounds:
        return telem.summarize(tl._replace(admit_round=adm), st, 0, region_map), None, adm
    base, wins = tl
    summ = telem.summarize(base._replace(admit_round=adm), st, 0, region_map)
    wsum = telem.summarize_windows(
        wins, adm, st.met.chosen_vid, st.met.chosen_round, window_rounds,
        batch_round=base.admit_round,
        learned_round=base.learned_round,
        committed_round=base.committed_round,
    )
    return summ, wsum, adm


def build_serve_window(
    cfg: SimConfig,
    queue_cap: int,
    vid_bound: int,
    rounds_per_window: int,
    window_rounds: int = 0,
    geometry=None,
    device="cuda",
):
    """One serving envelope's dispatch: ``serve_window(ss, root, admits,
    arrs) -> (ss, done, t, summary)`` with ``ss`` a single-run
    :class:`ServeLoopState` (consumed), ``root`` its key and
    ``admits``/``arrs`` ``[S, P, K]`` stacks of the per-window upload
    blocks from ``arrivals.ArrivalPlan.block`` (numpy, uploaded in one
    copy, or tensors on the device).  ``S`` (windows per dispatch) and
    ``K`` (admit width) are call shapes; the ``S = 1`` sequential
    baseline is the same dispatch at a different shape.  Use
    :func:`window_for` for the cached builder.

    A nonzero ``window_rounds`` arms the recorder's windowed plane: the
    state's telemetry leg is the ``(Telemetry, TelemetryWindows)`` pair
    and the call returns ``(ss, done, t, summary, window_summary)``.
    The trajectory is identical either way (the recorder is read-only).
    The summaries are device tensors without a lane axis.

    ``geometry`` (``core/geom.GeometryEnvelope``) builds the
    geometry-PADDED window: ``cfg`` must be the envelope's bound cfg and
    the call takes the tenant's true geometry and protocol knobs,
    ``serve_window(ss, root, admits, arrs, gm, pkn)`` (pad proposer rows
    of ``admits`` carry NONE and admit nothing)."""
    if cfg.faults.schedule is not None:
        raise ValueError(
            "serve engines take no fault schedule (correlated-fault "
            "serving rides the fleet envelope, not this driver)"
        )
    ww = int(window_rounds)
    dev = devm.resolve(device)
    round_fn = simm.build_engine(
        cfg, queue_cap, vid_cap=0, telemetry=True, window_rounds=ww,
        geometry=geometry, runtime_protocol=geometry is not None, device=dev,
    )
    r = int(rounds_per_window)
    v_bound = int(vid_bound)

    def serve_window(ss, root, admits, arrs, *gp):
        gm, pkn = gp if gp else (None, None)
        a, b = upload_blocks(admits, arrs, dev)
        roots = np.asarray([root], np.uint64)
        st, tl, ingest = run_window_lanes(
            round_fn, roots, simm.lanes_view(ss.sim), simm.lanes_view(ss.tele),
            ss.ingest[None], a[None], b[None], r, v_bound, geom=gm, pknobs=pkn,
        )
        summ, wsum, _ = epilogue(st, tl, ingest, ww)
        out = ServeLoopState(simm.lane_of(st, 0), simm.lane_of(tl, 0), ingest[0])
        ret = (out, out.sim.done, out.sim.t, simm.lane_of(summ, 0))
        return ret if not ww else ret + (simm.lane_of(wsum, 0),)

    return serve_window


_CACHE: dict = {}


def clear_cache() -> None:
    """Drop every cached window."""
    _CACHE.clear()


def engine_static_key(cfg: SimConfig, geometry=None) -> tuple:
    """THE build-time facts of a serve engine, as one hashable tuple: the
    one list shared by :func:`window_for`'s cache key and the fleet serve
    envelope key (``fleet/envelope.serve_envelope_key``).  A fact added
    to the engine build must land here, or a changed config could hit a
    warm cache and run the wrong engine.  A ``geometry`` envelope
    collapses the key: the menu replaces the per-geometry facts and the
    protocol drops out (it arrives per dispatch)."""
    return (
        simm.seeded_wedge(),
        (
            (cfg.n_nodes, cfg.proposers)
            if geometry is None else ("geom", geometry.menu)
        ),
        cfg.n_instances,
        cfg.assign_window,
        cfg.max_rounds,
        (
            dataclasses.astuple(cfg.protocol)
            if geometry is None else "runtime-protocol"
        ),
        (
            cfg.faults.drop_rate, cfg.faults.dup_rate,
            cfg.faults.min_delay, cfg.faults.max_delay,
            cfg.faults.crash_rate,
            cfg.faults.edges, bool(cfg.faults.delivery_cut),
        ),
    )


def window_for(
    cfg: SimConfig, queue_cap: int, vid_bound: int, rounds_per_window: int,
    window_rounds: int = 0,
    geometry=None,
    device="cuda",
):
    """Envelope-keyed cache over :func:`build_serve_window`: a knee
    sweep's rate points and the dispatch-granularity twins reuse ONE
    builder per (engine facts, queue shape, vid space, window span,
    bucket width, device)."""
    if cfg.faults.schedule is not None:
        # checked here too: the key ignores the schedule, so a
        # schedule-bearing cfg would otherwise hit a warm cache and
        # silently drop its correlated faults
        raise ValueError(
            "serve engines take no fault schedule (correlated-fault "
            "serving rides the fleet envelope, not this driver)"
        )
    dev = devm.resolve(device)
    key = (
        engine_static_key(cfg, geometry=geometry),
        int(queue_cap),
        int(vid_bound),
        int(rounds_per_window),
        int(window_rounds),
        str(dev),
    )
    fn = _CACHE.get(key)
    if fn is None:
        fn = build_serve_window(
            cfg, queue_cap, vid_bound, rounds_per_window,
            window_rounds=window_rounds, geometry=geometry, device=dev,
        )
        _CACHE[key] = fn
    return fn


#: The serve entries' canonical dispatch shape (JAX's): rounds a window,
#: windows a dispatch, admit width, and the windowed plane's bucket width.
AUDIT_R_WINDOW, AUDIT_S_WINDOWS, AUDIT_K_ADMIT = 8, 2, 4
AUDIT_W_ROUNDS = AUDIT_R_WINDOW * 4


def audit_cfg() -> SimConfig:
    """The serve entries' config: the engine's canonical small config with
    drop 500, crash 1000 and a delay bound of 2 (JAX's)."""
    return dataclasses.replace(
        simm.audit_canonical_cfg(),
        faults=FaultConfig(drop_rate=500, crash_rate=1000, max_delay=2),
    )


def audit_blocks(workload, p: int):
    """JAX's canonical admission blocks ``[S, P, K]``: each proposer's
    stream cut into ``K``-wide blocks, block ``s`` arriving at round
    ``s * R``, NONE-padded to ``p`` proposer rows."""
    s_w, k, r = AUDIT_S_WINDOWS, AUDIT_K_ADMIT, AUDIT_R_WINDOW
    admits = np.full((s_w, p, k), val.NONE, np.int32)
    arrs = np.zeros((s_w, p, k), np.int32)
    for pi, w in enumerate(workload):
        w = np.asarray(w, np.int32)
        for si in range(s_w):
            blk = w[si * k:(si + 1) * k]
            admits[si, pi, :len(blk)] = blk
            arrs[si, pi, :len(blk)] = si * r
    return admits, arrs


def audit_entries():
    """The serve window's registered entry points (``analysis/registry.py``),
    JAX's canonical dispatches: the audit config with i.i.d. faults on, a
    2-window dispatch of real admission blocks through stamping, the
    recorder-armed round spans and the ingest-stamped summary; and the
    same through the geometry-padded (5, 3) window."""
    from tpu_paxos_torch.analysis.registry import AuditEntry
    from tpu_paxos_torch.core import geom as geo

    def build(device):
        dev = devm.resolve(device)
        cfg = audit_cfg()
        workload = simm.default_workload(cfg)
        v_bound = vid_bound_of(workload)
        root = prng.root_key(cfg.seed)
        ss, c = init_serve_state(cfg, workload, v_bound, root,
                                 window_rounds=AUDIT_W_ROUNDS, device=dev)
        fn = build_serve_window(cfg, c, v_bound, AUDIT_R_WINDOW,
                                window_rounds=AUDIT_W_ROUNDS, device=dev)
        admits, arrs = audit_blocks(workload, len(cfg.proposers))
        return fn, (ss, root, admits, arrs)

    def build_envelope(device):
        dev = devm.resolve(device)
        genv = geo.GeometryEnvelope(menu=((3, (0, 1)), (5, (0, 1, 2))))
        cfg = audit_cfg()
        bcfg = genv.bound_cfg(cfg)
        workload = simm.default_workload(cfg)
        v_bound = vid_bound_of(workload)
        root = prng.root_key(cfg.seed)
        gm = geo.geometry_for(genv, cfg.n_nodes, cfg.proposers)
        pkn = geo.protocol_knobs(cfg.protocol, stall_patience=simm.IDLE_RESTART_ROUNDS)
        ss, c = init_serve_state(bcfg, workload + [np.zeros((0,), np.int32)], v_bound, root,
                                 window_rounds=AUDIT_W_ROUNDS, geometry=genv, geom=gm,
                                 pknobs=pkn, device=dev)
        fn = build_serve_window(bcfg, c, v_bound, AUDIT_R_WINDOW,
                                window_rounds=AUDIT_W_ROUNDS, geometry=genv, device=dev)
        admits, arrs = audit_blocks(workload, len(bcfg.proposers))
        return fn, (ss, root, admits, arrs, gm, pkn)

    return [
        AuditEntry("serve.window", build),
        AuditEntry("serve.window_envelope", build_envelope),
    ]
