"""Envelope-keyed runner cache: one fleet runner per envelope, shared by
every caller of that envelope (port of ``tpu_paxos/fleet/envelope.py``,
its fleet part).

An *envelope* is everything a runner fixes when it is built: the cluster
geometry (nodes / proposers / instances), the protocol knobs, the round
budget, the queue/table shapes of the workload template, the
schedule-table episode capacity, the verdict's vid space, and the DELAY
RING BOUND (the arrival calendars hold ``max_delay + 2`` slots).
Everything else (the seed, the episode schedule, the i.i.d. fault knobs,
and the workload vids) is a per-dispatch input of the cached runner.

``runner_for`` normalizes a caller's config onto its envelope (schedule
stripped, i.i.d. knobs zeroed, ``max_delay`` raised to the ring bound)
and memoizes one :class:`~tpu_paxos_torch.fleet.runner.FleetRunner` per
distinct key.  The key pins the template's expected-vid/owner TABLES and
shapes, not its queue ORDER, so callers pass explicit per-lane
``workloads=`` (and ``knobs=``) to ``run()``; cached runners refuse
implicit ones.

Under a geometry envelope (``core/geom.GeometryEnvelope``) the key
collapses over the menu and the protocol knobs: every true geometry
under the bound, with any protocol mix, shares one padded runner.

The serve fleet (``serve_fleet_for``), the controlled serve fleet
(``serve_control_for``) and the membership fleet (``member_runner_for``)
memoize their runners in the same cache.  Every key carries the lane
tile's mesh (:func:`_mesh_key`, as JAX's): a tiled and an untiled runner
never share an entry.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_paxos_torch.config import FaultConfig, SimConfig
from tpu_paxos_torch.core import sim as simm
from tpu_paxos_torch.fleet import runner as frun
from tpu_paxos_torch.fleet import verdict as vdt
from tpu_paxos_torch.utils import device as devm

#: Default envelope delay-ring bound: covers every stress mix's
#: ``max_delay`` (the sweep peaks at 6) with headroom, so all mixes of a
#: geometry share one ring size (ring size is decision-log-neutral).
MAX_DELAY_BOUND = 8

_CACHE: dict = {}
_MISSES = 0  # runners built by the *_for builders since import
_BY_LABEL: dict[str, int] = {}  # the same, by builder label


def clear_cache() -> None:
    """Drop every cached runner."""
    _CACHE.clear()


def cache_misses() -> int:
    """The runners ``runner_for``, ``serve_fleet_for``,
    ``serve_control_for`` and ``member_runner_for`` (and the controlled
    serve windows of ``serve/control.control_window_for``) have built
    since import (cache misses): the port's count of what JAX's compile
    census counts."""
    return _MISSES


def cache_misses_by_label() -> dict[str, int]:
    """:func:`cache_misses` split by the builder that missed
    (``runner_for``, ``serve_fleet_for``, ``serve_control_for``,
    ``member_runner_for``, ``control_window_for``): what
    ``analysis/buildcount.py`` pins."""
    return dict(sorted(_BY_LABEL.items()))


def memo(key, build, cache: dict | None = None, *, label: str):
    """``cache[key]``, built by ``build()`` and counted in
    :func:`cache_misses` (under ``label`` in
    :func:`cache_misses_by_label`) on a miss; ``cache`` defaults to this
    module's shared runner cache."""
    global _MISSES
    cache = _CACHE if cache is None else cache
    obj = cache.get(key)
    if obj is None:
        obj = build()
        cache[key] = obj
        _MISSES += 1
        _BY_LABEL[label] = _BY_LABEL.get(label, 0) + 1
    return obj


def _mesh_key(mesh):
    """The mesh part of a cache key: its shape, axis names and rank
    devices (None untiled).  Two meshes of one layout share a runner,
    which dispatches on its latest caller's mesh (:func:`_on_mesh`)."""
    if mesh is None:
        return None
    return (mesh.shape, tuple(mesh.axis_names), tuple(str(d) for d in mesh.devices))


def _on_mesh(runner, mesh):
    """``runner`` set to dispatch on the caller's ``mesh`` (of the layout
    its key names), so that each run's per-rank launch counts land on
    the mesh its caller passed and reads."""
    if mesh is not None:
        runner.mesh = mesh
    return runner


def envelope_key(
    cfg: SimConfig,
    workload,
    gates,
    max_episodes: int,
    delay_bound: int,
    device=None,
    telemetry: bool = False,
    geometry=None,
    mesh=None,
) -> tuple:
    """The hashable envelope of a (cfg, workload-template) pair: exactly
    the facts a runner fixes when it is built, including whether the
    flight recorder is armed, the seeded-wedge flag
    (``core/sim.seeded_wedge``: an armed build leaves the takeover out),
    the lane tile's mesh and the device the runner's states live on.

    Under a ``geometry`` envelope ``cfg`` must already be the bound cfg:
    the menu stands for the per-geometry facts and the protocol knobs
    drop out (they are per-dispatch data of the padded runner)."""
    wl = [np.asarray(w, np.int32).reshape(-1) for w in workload]
    expected, owner = vdt.expected_owners(cfg, wl)
    gate_sig = (
        None if gates is None
        else tuple(len(np.asarray(g).reshape(-1)) for g in gates)
    )
    return (
        bool(telemetry),
        bool(cfg.faults.delivery_cut),  # a build-time engine flag
        simm.seeded_wedge(),
        cfg.n_nodes,
        cfg.proposers,
        cfg.n_instances,
        cfg.assign_window,
        cfg.max_rounds,
        (
            dataclasses.astuple(cfg.protocol)
            if geometry is None else "runtime-protocol"
        ),
        None if geometry is None else ("geom", geometry.menu),
        int(delay_bound),
        int(max_episodes),
        tuple(len(w) for w in wl),
        gate_sig,
        tuple(int(v) for v in expected),
        tuple(int(o) for o in owner),
        simm.gates_vid_cap(wl, gates),
        _mesh_key(mesh),
        None if device is None else str(device),
    )


def runner_for(
    cfg: SimConfig,
    workload,
    gates=None,
    *,
    max_episodes: int = frun.MAX_EPISODES,
    delay_bound: int | None = None,
    mesh=None,
    telemetry: bool = False,
    geometry=None,
    device="cuda",
) -> frun.FleetRunner:
    """The shared runner for ``cfg``'s envelope on ``device``.

    ``cfg.faults`` is normalized away (the i.i.d. knobs and the schedule
    are per-lane inputs of the returned runner, passed to ``run()``);
    only ``cfg.faults.max_delay`` survives, as a floor on the ring bound.
    Callers MUST pass explicit per-lane ``workloads=`` and ``knobs=`` to
    ``run()`` (enforced: the returned runner rejects implicit inputs).

    ``telemetry=True`` hands back the flight-recorder-armed twin of the
    envelope, in a cache slot of its own.

    ``geometry`` (a ``core.geom.GeometryEnvelope``) hands back the
    geometry-PADDED runner of the envelope's bound: ``cfg`` may name any
    true geometry under the bound (it normalizes to
    ``geometry.bound_cfg``), the workload template pads to the proposer
    bound, and every such geometry and protocol mix shares the one
    runner.  Dispatch with ``run(geometry=(n_nodes, proposers),
    protocol=...)``.

    ``mesh`` hands back the runner that tiles the lane axis over its
    ranks (``FleetRunner(mesh=)``), keyed apart from the untiled one."""
    if delay_bound is None:
        delay_bound = max(cfg.faults.max_delay, MAX_DELAY_BOUND)
    if cfg.faults.max_delay > delay_bound:
        raise ValueError(
            f"cfg max_delay {cfg.faults.max_delay} exceeds the "
            f"requested envelope delay bound {delay_bound}"
        )
    if geometry is not None:
        # normalize ONTO the envelope bound before keying: every true
        # geometry under the bound lands on the same cache slot
        if (
            cfg.n_nodes > geometry.bound_nodes
            or len(cfg.proposers) > geometry.bound_proposers
        ):
            raise ValueError(
                f"geometry ({cfg.n_nodes}, {cfg.proposers}) exceeds "
                f"the envelope geometry bound ({geometry.bound_nodes} "
                f"nodes, {geometry.bound_proposers} proposers)"
            )
        cfg = geometry.bound_cfg(cfg)
        workload, gates = frun._pad_geometry_workload(
            workload, gates, geometry.bound_proposers
        )
    dev = devm.resolve(device) if mesh is None else mesh.devices[0]
    key = envelope_key(cfg, workload, gates, max_episodes, delay_bound, dev,
                       telemetry=telemetry, geometry=geometry, mesh=mesh)

    def build():
        base = dataclasses.replace(
            cfg, seed=0, faults=FaultConfig(
                max_delay=delay_bound,
                delivery_cut=cfg.faults.delivery_cut,
            )
        )
        runner = frun.FleetRunner(
            base, workload, gates, max_episodes=max_episodes, device=dev,
            telemetry=telemetry, geometry=geometry, mesh=mesh,
        )
        runner.explicit_inputs_only = True
        return runner

    return _on_mesh(memo(key, build, label="runner_for"), mesh)


def serve_envelope_key(
    cfg: SimConfig,
    queue_cap: int,
    vid_bound: int,
    rounds_per_window: int,
    window_rounds: int,
    mesh=None,
    device=None,
) -> tuple:
    """The hashable envelope of a serve FLEET: the engine's build-time
    facts (from the serve driver's one list,
    ``serve/driver.engine_static_key``, shared with its ``window_for``),
    the queue capacity and ingest-table vid bound, the admission-window
    span, the windowed-plane bucket width, the lane tile's mesh and the
    device.  Lane count, windows per dispatch
    and admit width are call shapes, not key parts; seeds, arrivals and
    SLOs are per-dispatch data."""
    import importlib

    # imported late: the serve stack stays out of the import closure of
    # the triage modules that use this cache
    sdrv = importlib.import_module("tpu_paxos_torch.serve.driver")
    return (
        "serve",
        sdrv.engine_static_key(cfg),
        int(queue_cap),
        int(vid_bound),
        int(rounds_per_window),
        int(window_rounds),
        _mesh_key(mesh),
        None if device is None else str(device),
    )


def serve_fleet_for(
    cfg: SimConfig,
    queue_cap: int,
    vid_bound: int,
    rounds_per_window: int,
    *,
    window_rounds: int,
    mesh=None,
    device="cuda",
):
    """The shared fleet-serving runner for this envelope on ``device``
    (``serve/fleet.ServeFleetRunner``), memoized in the cache the sim and
    membership envelopes share and counted in :func:`cache_misses`:
    every tenant mix, offered rate and SLO of a geometry then costs
    dispatches, not builds."""
    import importlib

    sflt = importlib.import_module("tpu_paxos_torch.serve.fleet")
    if cfg.faults.schedule is not None:
        # checked here: the key ignores the schedule, so a
        # schedule-bearing cfg would otherwise hit a warm cache and
        # silently drop its correlated faults
        raise ValueError(
            "serve engines take no fault schedule (correlated-fault "
            "serving rides the stress fleet envelope, not this driver)"
        )
    dev = devm.resolve(device) if mesh is None else mesh.devices[0]
    key = serve_envelope_key(
        cfg, queue_cap, vid_bound, rounds_per_window, window_rounds, mesh=mesh, device=dev,
    )
    return _on_mesh(memo(key, lambda: sflt.ServeFleetRunner(
        cfg, queue_cap, vid_bound, rounds_per_window, window_rounds, mesh=mesh, device=dev,
    ), label="serve_fleet_for"), mesh)


def serve_control_for(
    cfg: SimConfig,
    queue_cap: int,
    vid_bound: int,
    rounds_per_window: int,
    *,
    window_rounds: int,
    mesh=None,
    device="cuda",
):
    """The shared CONTROLLED fleet-serving runner for this envelope on
    ``device`` (``serve/control.ControlFleetRunner``), the adaptive-
    admission twin of :func:`serve_fleet_for` in the same cache under its
    own tag.  Policies, priority tiers and SLO thresholds are per-dispatch
    data, so a controlled (lanes x rates) sweep builds one runner."""
    import importlib

    sctl = importlib.import_module("tpu_paxos_torch.serve.control")
    if cfg.faults.schedule is not None:
        # checked here like serve_fleet_for: the key ignores the schedule
        raise ValueError(
            "serve engines take no fault schedule (correlated-fault "
            "serving rides the stress fleet envelope, not this driver)"
        )
    dev = devm.resolve(device) if mesh is None else mesh.devices[0]
    key = (
        "serve_control",
        *serve_envelope_key(
            cfg, queue_cap, vid_bound, rounds_per_window, window_rounds, mesh=mesh, device=dev,
        )[1:],
    )
    return _on_mesh(memo(key, lambda: sctl.ControlFleetRunner(
        cfg, queue_cap, vid_bound, rounds_per_window, window_rounds, mesh=mesh, device=dev,
    ), label="serve_control_for"), mesh)


def member_envelope_key(
    n_nodes: int,
    n_instances: int,
    max_events: int,
    max_episodes: int,
    crash_rate: int,
    max_rounds: int,
    geometry=None,
    device=None,
    mesh=None,
) -> tuple:
    """The hashable envelope of a membership fleet: the static facts a
    member runner fixes (cluster geometry, churn-table event capacity,
    fault-schedule episode capacity, the i.i.d. crash rate, the round
    budget), the lane tile's mesh and the device its states live on.  Seeds, churn scenarios
    and episode mixes are per-dispatch inputs.  Under a ``geometry``
    envelope the node count collapses to the menu."""
    return (
        "member",
        int(n_nodes) if geometry is None else ("geom", geometry.menu),
        int(n_instances),
        int(max_events),
        int(max_episodes),
        int(crash_rate),
        int(max_rounds),
        _mesh_key(mesh),
        None if device is None else str(device),
    )


def member_runner_for(
    n_nodes: int,
    n_instances: int,
    *,
    max_events: int | None = None,
    max_episodes: int = frun.MAX_EPISODES,
    crash_rate: int = 0,
    max_rounds: int = 2000,
    geometry=None,
    mesh=None,
    device="cuda",
):
    """The shared membership-fleet runner for this envelope on ``device``
    (on ``mesh``'s ranks, its lane axis tiled, when given)
    (``fleet/member_runner.MemberFleetRunner``), memoized in the cache the
    sim envelopes share.  With a ``geometry`` envelope ``n_nodes`` may be
    any menu node count (it normalizes to the bound and is declared per
    dispatch: ``run(n_nodes=...)``), and every geometry on the menu shares
    one runner."""
    from tpu_paxos_torch.fleet import member_runner as mrun
    from tpu_paxos_torch.membership import churn_table as ctm

    if max_events is None:
        max_events = ctm.MAX_EVENTS
    if geometry is not None:
        geometry.index_of_nodes(n_nodes)  # named menu/bound rejection
        n_nodes = geometry.bound_nodes
    dev = devm.resolve(device) if mesh is None else mesh.devices[0]
    key = member_envelope_key(
        n_nodes, n_instances, max_events, max_episodes, crash_rate,
        max_rounds, geometry=geometry, device=dev, mesh=mesh,
    )
    return _on_mesh(memo(key, lambda: mrun.MemberFleetRunner(
        n_nodes, n_instances, max_events=max_events,
        max_episodes=max_episodes, crash_rate=crash_rate,
        max_rounds=max_rounds, geometry=geometry, mesh=mesh, device=dev,
    ), label="member_runner_for"), mesh)
