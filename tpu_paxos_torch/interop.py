"""Carry engine state between the JAX package and the port.

This system has no weights; its state is what crosses: the JAX
package's ``SimState`` (the general engine) and ``FastState`` (the fast
path), converted to numpy arrays (e.g. with ``jax.tree.map(np.asarray,
state)``), become the port's trees on a device and back.  Both packages'
trees have the same field names, nesting, shapes and dtypes, so a run
can be handed over mid-flight and resumed in either package round for
round.  A fleet's lane-stacked states (JAX's ``vmap`` output, the port's
lane axis) convert the same way: every leaf keeps its leading lane axis,
and ``core/sim.lane_of`` takes one lane.  The port reads fields by name
and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_paxos_torch.core import fast
from tpu_paxos_torch.core import net as netm
from tpu_paxos_torch.core import sim
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
    return type(node)(*[_to_numpy(x) for x in node])


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
