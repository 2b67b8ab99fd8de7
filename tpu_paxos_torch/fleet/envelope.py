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
_MISSES = 0  # runners built by runner_for since import


def clear_cache() -> None:
    """Drop every cached runner."""
    _CACHE.clear()


def cache_misses() -> int:
    """The runners ``runner_for`` has built since import (cache misses):
    the port's count of what JAX's compile census counts for a fleet."""
    return _MISSES


def envelope_key(
    cfg: SimConfig,
    workload,
    gates,
    max_episodes: int,
    delay_bound: int,
    device=None,
    telemetry: bool = False,
    geometry=None,
) -> tuple:
    """The hashable envelope of a (cfg, workload-template) pair: exactly
    the facts a runner fixes when it is built, including whether the
    flight recorder is armed, the seeded-wedge flag
    (``core/sim.seeded_wedge``: an armed build leaves the takeover out)
    and the device the runner's states live on.

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
    protocol=...)``."""
    global _MISSES
    if mesh is not None:
        raise NotImplementedError("runner_for mesh= is not ported yet")
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
    dev = devm.resolve(device)
    key = envelope_key(cfg, workload, gates, max_episodes, delay_bound, dev,
                       telemetry=telemetry, geometry=geometry)
    runner = _CACHE.get(key)
    if runner is None:
        base = dataclasses.replace(
            cfg, seed=0, faults=FaultConfig(
                max_delay=delay_bound,
                delivery_cut=cfg.faults.delivery_cut,
            )
        )
        runner = frun.FleetRunner(
            base, workload, gates, max_episodes=max_episodes, device=dev,
            telemetry=telemetry, geometry=geometry,
        )
        runner.explicit_inputs_only = True
        _CACHE[key] = runner
        _MISSES += 1
    return runner


def serve_envelope_key(*args, **kwargs):
    raise NotImplementedError("serve_envelope_key is not ported yet")


def serve_fleet_for(*args, **kwargs):
    raise NotImplementedError("serve_fleet_for is not ported yet")


def serve_control_for(*args, **kwargs):
    raise NotImplementedError("serve_control_for is not ported yet")


def member_envelope_key(*args, **kwargs):
    raise NotImplementedError("member_envelope_key is not ported yet")


def member_runner_for(*args, **kwargs):
    raise NotImplementedError("member_runner_for is not ported yet")
