"""Carry engine state between the JAX package and the port.

This system has no weights; its state is what crosses: the JAX
package's ``SimState`` (the general engine), ``FastState`` (the fast
path), ``MemberState`` (the membership engine), ``ServeLoopState``
(a serve run's loop state: engine, recorder and ingest table) and
``ControlLoopState`` (a controlled serve run's: that plus the shed and
admit counters), converted to numpy arrays (e.g. with ``jax.tree.map(np.asarray,
state)``), become the port's trees on a device and back.  Both packages'
trees have the same field names, nesting, shapes and dtypes, so a run
can be handed over mid-flight and resumed in either package round for
round.  A fleet's lane-stacked states (JAX's ``vmap`` output, the port's
lane axis) convert the same way: every leaf keeps its leading lane axis,
and ``core/sim.lane_of`` takes one lane.  The port reads fields by name
and imports nothing of the JAX package.

A lane-tiled fleet's report (JAX's ``shard_map`` over the lane axis, the
port's ``mesh=`` runners) gathers its lanes in lane order, so it
compares with an untiled one leaf for leaf: :func:`lanes_to_numpy` takes
every leaf whole (``np.asarray`` of a lane-sharded JAX array) and
:func:`first_lane_difference` names the first lane and leaf that differ.

A sharded run's state crosses as JAX holds it, one global tree whose
queue leaves carry a leading shard axis, and becomes the port's list of
per-rank slices on the mesh's devices and back, through the committed
partition rules (``parallel/partition_rules.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_paxos_torch.core import fast
from tpu_paxos_torch.core import net as netm
from tpu_paxos_torch.core import sim
from tpu_paxos_torch.membership import engine as meng
from tpu_paxos_torch.serve import driver as sdrv
from tpu_paxos_torch.telemetry import recorder as telem
from tpu_paxos_torch.utils import device as devm

_SUBTREES = {
    "acc": sim.AcceptorState,
    "prop": sim.ProposerState,
    "net": netm.NetBuffers,
    "met": sim.Metrics,
}


def _tensor(x, dev) -> torch.Tensor:
    # a C-ordered, writable copy (keeps 0-d leaves 0-d)
    return torch.from_numpy(np.array(x, order="C", copy=True)).to(dev)


def sim_state_from_jax(np_tree, device="cuda") -> sim.SimState:
    """The port's SimState on ``device`` from a JAX ``SimState`` whose
    leaves are numpy arrays (any object with the same attribute names)."""
    dev = devm.resolve(device)
    fields = {}
    for name in sim.SimState._fields:
        node = getattr(np_tree, name)
        cls = _SUBTREES.get(name)
        if cls is None:
            fields[name] = _tensor(node, dev)
        else:
            fields[name] = cls(**{f: _tensor(getattr(node, f), dev) for f in cls._fields})
    return sim.SimState(**fields)


def _to_numpy(node):
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().numpy()
    return sim._rebuild(node, [_to_numpy(x) for x in node])


def sim_state_to_numpy(state: sim.SimState) -> sim.SimState:
    """The same tree with every leaf as a host numpy array."""
    return _to_numpy(state)


def fast_state_from_jax(np_tree, device="cuda") -> fast.FastState:
    """The port's FastState on ``device`` from a JAX ``FastState`` whose
    leaves are numpy arrays (any object with the same attribute names)."""
    dev = devm.resolve(device)
    return fast.FastState(**{
        f: _tensor(getattr(np_tree, f), dev) for f in fast.FastState._fields
    })


def fast_state_to_numpy(state: fast.FastState) -> fast.FastState:
    """The same FastState with every leaf as a host numpy array."""
    return _to_numpy(state)


def member_state_from_jax(np_tree, device="cuda") -> meng.MemberState:
    """The port's MemberState on ``device`` from a JAX ``MemberState``
    whose leaves are numpy arrays (any object with the same attribute
    names); a lane-stacked state keeps its lane axis."""
    dev = devm.resolve(device)
    return meng.MemberState(**{
        f: _tensor(getattr(np_tree, f), dev) for f in meng.MemberState._fields
    })


def member_state_to_numpy(state: meng.MemberState) -> meng.MemberState:
    """The same MemberState with every leaf as a host numpy array."""
    return _to_numpy(state)


def serve_state_from_jax(np_tree, device="cuda") -> sdrv.ServeLoopState:
    """The port's ServeLoopState on ``device`` from a JAX
    ``ServeLoopState`` whose leaves are numpy arrays: the engine state,
    the recorder (a ``Telemetry``, or the windowed ``(Telemetry,
    TelemetryWindows)`` pair) and the ingest table.  A fleet's
    lane-stacked state keeps its lane axis."""
    dev = devm.resolve(device)
    tele = np_tree.tele
    windowed = isinstance(tele, tuple) and not hasattr(tele, "_fields")

    def rec(node, cls):
        return cls(**{f: _tensor(getattr(node, f), dev) for f in cls._fields})

    return sdrv.ServeLoopState(
        sim=sim_state_from_jax(np_tree.sim, device=dev),
        tele=(
            (rec(tele[0], telem.Telemetry), rec(tele[1], telem.TelemetryWindows))
            if windowed else rec(tele, telem.Telemetry)
        ),
        ingest=_tensor(np_tree.ingest, dev),
    )


def serve_state_to_numpy(state: sdrv.ServeLoopState) -> sdrv.ServeLoopState:
    """The same ServeLoopState with every leaf as a host numpy array."""
    return _to_numpy(state)


def control_state_from_jax(np_tree, device="cuda"):
    """The port's ``serve/control.ControlLoopState`` on ``device`` from a
    JAX ``ControlLoopState`` whose leaves are numpy arrays: the serve loop
    state (:func:`serve_state_from_jax`) and the ``ctl`` counter leaf
    (``[2]``, or ``[L, 2]`` on fleet lanes)."""
    from tpu_paxos_torch.serve import control as sctl

    dev = devm.resolve(device)
    return sctl.ControlLoopState(
        serve=serve_state_from_jax(np_tree.serve, device=dev),
        ctl=_tensor(np_tree.ctl, dev),
    )


def control_state_to_numpy(state):
    """The same ControlLoopState with every leaf as a host numpy array."""
    return _to_numpy(state)


def sharded_sim_state_from_jax(np_tree, mesh) -> list:
    """The ranks' SimState slices on ``mesh``'s devices from JAX's global
    sharded ``SimState`` (numpy leaves; queue leaves ``[D, P, C]`` and
    ``[D, P]``), split by the partition rules."""
    from tpu_paxos_torch.parallel import sharded_sim

    host = sim_state_from_jax(np_tree, device="cpu")
    return sharded_sim.scatter_state(mesh, host)


def sharded_sim_state_to_numpy(states) -> sim.SimState:
    """JAX's global sharded ``SimState`` layout (host numpy) from the
    ranks' slices, gathered by the partition rules."""
    from tpu_paxos_torch.parallel import sharded_sim

    return sharded_sim.gather_state(states)


def sharded_fast_state_from_jax(np_tree, mesh) -> list:
    """The ranks' FastState slices on ``mesh``'s devices from JAX's global
    sharded ``FastState`` (numpy leaves)."""
    from tpu_paxos_torch.parallel import sharded

    return sharded.scatter_state(mesh, fast.FastState(
        **{f: np.asarray(getattr(np_tree, f)) for f in fast.FastState._fields}))


def sharded_fast_state_to_numpy(states) -> fast.FastState:
    """JAX's global sharded ``FastState`` layout (host numpy) from the
    ranks' slices."""
    from tpu_paxos_torch.parallel import sharded

    return sharded.gather_state(states)


def lanes_to_numpy(tree):
    """A lane-stacked tree (NamedTuples and tuples of tensors, or of any
    array ``np.asarray`` takes whole, as a JAX tiled report's
    lane-sharded leaves) with every leaf a host numpy array."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return sim._rebuild(tree, [lanes_to_numpy(x) for x in tree])
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def first_lane_difference(ours, theirs, path: str = ""):
    """The first ``(lane, leaf path)`` where two lane-stacked trees differ
    (the port's and JAX's, fields read by name; numpy leaves from
    :func:`lanes_to_numpy`), or None where every lane of every leaf is
    equal.  A leaf whose shapes or dtypes differ counts at lane 0."""
    if hasattr(ours, "_fields"):
        hits = [first_lane_difference(getattr(ours, f), getattr(theirs, f), f"{path}/{f}")
                for f in ours._fields]
    elif isinstance(ours, tuple):
        hits = [first_lane_difference(a, b, f"{path}/{k}")
                for k, (a, b) in enumerate(zip(ours, theirs))]
    else:
        a, b = np.asarray(ours), np.asarray(theirs)
        if a.shape != b.shape or a.dtype != b.dtype:
            return 0, path
        if a.ndim == 0:
            return None if a == b else (0, path)
        bad = np.flatnonzero((a != b).reshape(a.shape[0], -1).any(axis=1))
        return (int(bad[0]), path) if bad.size else None
    hits = [h for h in hits if h is not None]
    return min(hits) if hits else None
