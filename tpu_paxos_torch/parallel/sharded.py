"""Instance-axis sharded fast path (port of
``tpu_paxos/parallel/sharded.py``).

The ``[nodes, instances]`` SoA state (instances minor, see
``core/fast.py``) is split along the instance axis over the mesh's ranks;
the per-acceptor scalars (``promised``, ``max_seen``) are replicated.  The
only cross-shard communication the protocol needs is the ``gmax`` of the
max ballot seen when the proposer picks its ballot (the global analog of
ref multi/paxos.cpp:792-799's ``max_proposal_id_``) and the ``gsum`` of
the chosen counts (the reference's "total executed" counter, ref
multi/main.cpp:329).  Every other step (promise compares, adoption,
accept stores, learning) is local to a shard and runs the port's
``core/fast`` phases; no kernel runs here, as none runs in JAX's
``choose_all``.

A sharded FastState is the list of the ranks' slices, each on its rank's
device (``parallel/mesh.Mesh.devices``).
"""

from __future__ import annotations

import torch

from tpu_paxos_torch.core import ballot as bal
from tpu_paxos_torch.core import fast
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.parallel import partition_rules as prules
from tpu_paxos_torch.utils import counters

_I32 = torch.int32


def _choose_all_local(comm, state: fast.FastState, vids: torch.Tensor, proposer: int,
                      quorum: int):
    """One rank's body of the choose-all: the single-chip fast path, with
    the ballot derived from the *global* max ballot seen."""
    counters.add("host_reads", 2)  # the max ballot seen, the chosen count
    global_max = int(comm.gmax(int(state.max_seen.amax())))
    zero = torch.zeros((), dtype=_I32, device=state.max_seen.device)
    _, ballot = bal.bump_past(zero, zero + proposer, zero + global_max)
    state, prepared, adopted_ballot, adopted_vid = fast.phase1_prepare(state, ballot, quorum)
    use_adopted = adopted_ballot != bal.NONE
    batch = torch.where(use_adopted, adopted_vid, vids)
    batch = torch.where(prepared, batch, val.NONE)
    state, chosen = fast.phase2_accept(state, ballot, batch, quorum)
    state = fast.phase3_learn(state, batch, chosen)
    local_chosen = int((state.learned[0] != val.NONE).sum())
    return state, int(comm.gsum(local_chosen))


def sharded_choose_all(mesh, proposer: int, quorum: int):
    """The choose-all over ``mesh``: returns ``fn(states, vids) -> (states,
    n_chosen)`` with ``states`` the ranks' FastState slices and ``vids``
    their ``[I / D]`` blocks (``mesh.shard_instances``); ``n_chosen`` is
    the global count (an int, the same on every rank)."""
    def step(states, vids):
        out = mesh.run(lambda comm: _choose_all_local(
            comm, states[comm.rank], vids[comm.rank], proposer, quorum))
        return [s for s, _ in out], out[0][1]

    return step


def init_sharded_state(mesh, n_instances: int, n_nodes: int) -> list:
    """The ranks' FastState slices (``[A, I / D]`` arrays, ``[A]``
    scalars replicated), each on its rank's device."""
    if n_instances % mesh.size != 0:
        raise ValueError(
            f"n_instances ({n_instances}) must divide evenly over "
            f"{mesh.size} devices"
        )
    i_loc = n_instances // mesh.size
    return [fast.init_state(i_loc, n_nodes, device=dev) for dev in mesh.devices]


def gather_state(states) -> fast.FastState:
    """The global FastState (host numpy) from the ranks' slices, through
    the partition rules."""
    host = [fast.FastState(*[x.detach().cpu().numpy() for x in s]) for s in states]
    return prules.gather_tree("fast", host)


def scatter_state(mesh, global_state) -> list:
    """The ranks' slices of a global FastState (numpy or torch leaves),
    each on its rank's device, through the partition rules."""
    out = []
    for r, dev in enumerate(mesh.devices):
        part = prules.split_tree("fast", global_state, mesh.size, r)
        out.append(fast.FastState(*[
            (x if isinstance(x, torch.Tensor) else torch.from_numpy(x.copy())).to(
                dev, copy=True).contiguous()
            for x in part
        ]))
    return out


def audit_entries():
    """The sharded fast path's registered entry point
    (``analysis/registry.py``), JAX's canonical call: 16 instances over 3
    acceptors, proposer 0, quorum 2, on a 1-rank mesh (the same program
    at any mesh size; its two collectives a call are the ``gmax`` of the
    ballot and the ``gsum`` of the chosen counts).  ``shard_build`` lays
    the same call over the shard tier's grid; ``shard_state`` is the
    global ``[A, I]`` state the partition table must cover."""
    from tpu_paxos_torch.analysis.registry import AuditEntry
    from tpu_paxos_torch.parallel import mesh as pmesh

    n = 16

    def _setup(mesh):
        states = init_sharded_state(mesh, n, n_nodes=3)
        vids = pmesh.shard_instances(mesh, torch.arange(n, dtype=_I32))
        return sharded_choose_all(mesh, proposer=0, quorum=2), (states, vids)

    def build(device):
        return _setup(pmesh.make_instance_mesh(1, device=device))

    def shard_state(n_shards: int = 1):
        return "fast", fast.init_state(n, 3, device="cpu")

    return [AuditEntry("sharded.choose_all", build, covers=("sharded_choose_all",),
                       shard_build=_setup, shard_state=shard_state)]
