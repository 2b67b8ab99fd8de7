"""Instance-axis sharded general engine (port of
``tpu_paxos/parallel/sharded_sim.py``).

The full protocol ladder (retries, faults, crashes, hole-filling,
conflict re-proposal, in-order gates) runs sharded: ``core/sim``'s round
is built per rank with the rank's collectives (``build_engine(axis_name=,
n_shards=)``) and each of the mesh's ``D`` ranks runs it on its
contiguous block of ``n_instances / D`` instances
(``parallel/mesh.Mesh.run``), reducing JAX's global predicates over the
mesh every round.

Layout (``parallel/partition_rules.py``, the JAX table): ``[A, I]`` /
``[P, I]`` / ``[P, A, I]`` protocol arrays split over the instance axis;
``[P]`` / ``[A]`` scalars and the network calendars replicated (their
updates are functions of replicated arrivals and the global reductions);
the queues (``pend``/``gate``/``head``/``tail``) private to each shard,
carried with a leading shard axis in the global state.  Each proposer's
workload is split over the shards whole gate component by gate
component, and each shard first-fits its own queue onto its own free
instances, so placement differs from the unsharded engine's (safety and
the chosen multiset do not): a sharded decision log compares only with a
sharded log at the same ``D``.

Every rank draws the coins JAX's shard body draws (the round draws only
``[P]``, ``[A]`` and network-plan shapes, from the replicated round
counter), so the port at ``D`` ranks makes JAX's decisions at ``D``
devices, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_paxos_torch.config import SimConfig
from tpu_paxos_torch.core import sim as simm
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.parallel import partition_rules as prules
from tpu_paxos_torch.utils import counters
from tpu_paxos_torch.utils import prng

_I32 = torch.int32


def _unwrap(st: simm.SimState) -> simm.SimState:
    """Strip the leading shard axis from the per-shard queue leaves
    (local block ``[1, P, C]`` -> ``[P, C]``) so the round sees its usual
    shapes."""
    pr = st.prop
    return st._replace(
        prop=pr._replace(pend=pr.pend[0], gate=pr.gate[0], head=pr.head[0], tail=pr.tail[0])
    )


def _wrap(st: simm.SimState) -> simm.SimState:
    pr = st.prop
    return st._replace(
        prop=pr._replace(
            pend=pr.pend[None], gate=pr.gate[None], head=pr.head[None], tail=pr.tail[None]
        )
    )


def split_workload(workload, gates, n_shards: int):
    """Chain-aware round-robin split of each proposer's (vid, gate)
    sequence over shards; returns per-shard workload/gates lists.

    A gated entry must land on the shard where its gate's value lands:
    entries are grouped into connected components of the gate graph
    (union-find) and whole components round-robin over shards.  Gates on
    vids outside the workload leave their entry in its own component
    (such gates never satisfy, exactly as unsharded)."""
    nonev = int(val.NONE)
    entries = []  # (pi, vid, gate) in scan order
    vid_pos: dict[int, int] = {}
    for pi, w in enumerate(workload):
        w = np.asarray(w, np.int32)
        g = (
            np.full(len(w), nonev, np.int32)
            if gates is None or not len(gates[pi])
            else np.asarray(gates[pi], np.int32)
        )
        for k in range(len(w)):
            vid_pos.setdefault(int(w[k]), len(entries))
            entries.append((pi, int(w[k]), int(g[k])))

    parent = list(range(len(entries)))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e, (_, _, gv) in enumerate(entries):
        if gv != nonev and gv in vid_pos:
            ra, rb = find(e), find(vid_pos[gv])
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

    shard_of_root: dict[int, int] = {}
    wls = [[[] for _ in workload] for _ in range(n_shards)]
    gts = [[[] for _ in workload] for _ in range(n_shards)]
    nxt = 0
    for e, (pi, v, gv) in enumerate(entries):
        r = find(e)
        if r not in shard_of_root:
            shard_of_root[r] = nxt % n_shards
            nxt += 1
        shard = shard_of_root[r]
        wls[shard][pi].append(v)
        gts[shard][pi].append(gv)

    def to_np(seqs):
        return [np.asarray(s, np.int32) for s in seqs]

    return (
        [to_np(wl) for wl in wls],
        None if gates is None else [to_np(gt) for gt in gts],
    )


def min_instances(workload, gates, n_shards: int) -> int:
    """Smallest mesh-aligned ``n_instances`` that gives every shard 2x its
    largest workload (the chain-aware split keeps whole gate chains on
    one shard, so per-shard demand is set by the biggest component
    cluster)."""
    wls, _ = split_workload(workload, gates, n_shards)
    max_load = max(sum(len(w) for w in wl) for wl in wls)
    return n_shards * max(2 * max_load, 1)


def prepare_queues_sharded(cfg: SimConfig, workload, gates, n_shards: int):
    """Per-shard queue arrays: returns (pend ``[D, P, C+W]``, gate ``[D, P,
    C+W]``, tail ``[D, P]``, c) with one capacity C, the largest
    shard-local workload plus ``i_local`` requeue headroom."""
    p = len(cfg.proposers)
    i_loc = cfg.n_instances // n_shards
    wls, gts = split_workload(workload, gates, n_shards)
    c = max(max((len(w) for w in wl), default=0) for wl in wls) + i_loc + 8
    width = c + cfg.assign_window  # rows pre-padded by the window width
    pend = np.full((n_shards, p, width), int(val.NONE), np.int32)
    gate = np.full((n_shards, p, width), int(val.NONE), np.int32)
    tail = np.zeros((n_shards, p), np.int32)
    for s in range(n_shards):
        for pi, wl in enumerate(wls[s]):
            pend[s, pi, : len(wl)] = wl
            tail[s, pi] = len(wl)
            if gts is not None and len(gts[s][pi]):
                g = gts[s][pi]
                gate[s, pi, : len(g)] = g
    return pend, gate, tail, c


def global_state(cfg: SimConfig, pend, gate, tail, root) -> simm.SimState:
    """JAX's global sharded ``SimState`` on the host (torch CPU leaves):
    the queue leaves carry the leading shard axis."""
    p = len(cfg.proposers)
    dummy = np.full((p, pend.shape[2]), int(val.NONE), np.int32)
    st = simm.init_state(cfg, dummy, dummy, np.zeros((p,), np.int32), root, device="cpu")
    return st._replace(prop=st.prop._replace(
        pend=torch.from_numpy(np.ascontiguousarray(pend, np.int32)),
        gate=torch.from_numpy(np.ascontiguousarray(gate, np.int32)),
        head=torch.zeros(tail.shape, dtype=_I32),
        tail=torch.from_numpy(np.ascontiguousarray(tail, np.int32)),
    ))


def _placed(tree, dev):
    """A tree's leaves as contiguous copies of their own on ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, copy=True).contiguous()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(dev, copy=True)
    return simm._rebuild(tree, [_placed(x, dev) for x in tree])


def scatter_state(mesh, global_st) -> list:
    """The ranks' slices of a global sharded SimState (torch or numpy
    leaves), each on its rank's device, through the partition rules."""
    return [_placed(prules.split_tree("sim", global_st, mesh.size, r), mesh.devices[r])
            for r in range(mesh.size)]


def gather_state(states) -> simm.SimState:
    """The global sharded SimState (host numpy) from the ranks' slices."""
    def host(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu().numpy()
        return simm._rebuild(tree, [host(x) for x in tree])

    return prules.gather_tree("sim", [host(s) for s in states])


def init_sharded_state(cfg: SimConfig, mesh, pend, gate, tail, root) -> list:
    """The ranks' slices of the global SimState (queue leaves with the
    leading shard axis), each on its rank's device."""
    return scatter_state(mesh, global_state(cfg, pend, gate, tail, root))


def _check_mesh(cfg: SimConfig, mesh) -> int:
    d = mesh.size
    if cfg.n_instances % d:
        raise ValueError(f"n_instances ({cfg.n_instances}) must divide over {d} devices")
    return d


def build_runner(cfg: SimConfig, mesh, workload=None, gates=None):
    """Returns ``(fn, root, states, expected)``: ``fn(root, states)`` runs
    the whole-run loop on every rank (``~done & t < round_budget``, both
    replicated, so every rank stops at the same round) and returns the
    ranks' final states; ``states`` are the ranks' initial slices (each
    on its rank's device, consumed by ``fn``).  Each rank builds its own
    round function."""
    d = _check_mesh(cfg, mesh)
    if workload is None:
        workload = simm.default_workload(cfg)
    pend, gate, tail, c = prepare_queues_sharded(cfg, workload, gates, d)
    # Liveness precondition: a shard cannot place more values than it
    # has instances (instances are never reused).
    max_load = int(tail.sum(axis=1).max())
    if cfg.n_instances // d < max_load:
        raise ValueError(
            f"shard workload of {max_load} values exceeds "
            f"{cfg.n_instances // d} instances per shard; need "
            f"n_instances >= {min_instances(workload, gates, d)} "
            f"(see min_instances)"
        )
    root = prng.root_key(cfg.seed)
    states = init_sharded_state(cfg, mesh, pend, gate, tail, root)
    vid_cap = simm.gates_vid_cap(workload, gates)

    def fn(root, states):
        roots = np.asarray([root], np.uint64)

        def rank(comm):
            round_fn = simm.build_engine(cfg, c, axis_name=comm, n_shards=d, vid_cap=vid_cap,
                                         device=mesh.devices[comm.rank])
            st = simm.lanes_view(_unwrap(states[comm.rank]))
            while True:
                counters.add("host_reads")
                # paxlint: allow[JAX103] the sharded loop's one designed read a round; analysis/audit.py pins it
                done, t = (int(x) for x in torch.stack([st.done[0].to(_I32), st.t[0]]).cpu())
                if done or t >= cfg.round_budget:
                    break
                st = round_fn.lanes(roots, st, t)
            return _wrap(simm.lane_of(st, 0))

        return mesh.run(rank)

    expected = np.unique(np.concatenate([np.asarray(w, np.int32).reshape(-1) for w in workload]))
    return fn, root, states, expected


def to_result(final, expected: np.ndarray) -> simm.SimResult:
    """The host-convention result, gathered from the ranks' final states
    through the partition rules."""
    g = gather_state(final)
    return simm.SimResult(
        learned=np.asarray(g.learned).T,  # host convention [I, A]
        chosen_vid=np.asarray(g.met.chosen_vid),
        chosen_round=np.asarray(g.met.chosen_round),
        chosen_ballot=np.asarray(g.met.chosen_ballot),
        rounds=int(g.t),
        done=bool(g.done),
        crashed=np.asarray(g.crashed),
        msgs=np.asarray(g.met.msgs),
        expected_vids=expected,
    )


def run_sharded(cfg: SimConfig, mesh, workload=None, gates=None) -> simm.SimResult:
    """Drive the general engine to quiescence with the instance axis
    sharded over ``mesh``: the sharded twin of ``core.sim.run``, on the
    mesh's devices."""
    fn, root, states, expected = build_runner(cfg, mesh, workload, gates)
    return to_result(fn(root, states), expected)


def padded_config(cfg: SimConfig, workload, gates, n_shards: int) -> SimConfig:
    """``cfg`` with ``n_instances`` raised to :func:`min_instances` and
    padded to a multiple of the mesh (what the CLI and the stress sweep
    size a sharded run to)."""
    n_inst = max(cfg.n_instances, min_instances(workload, gates, n_shards))
    n_inst += (-n_inst) % n_shards
    return cfg if n_inst == cfg.n_instances else dataclasses.replace(cfg, n_instances=n_inst)


def audit_entries():
    """The sharded general engine's registered entry point
    (``analysis/registry.py``), JAX's canonical run: the whole-run loop of
    ``core/sim.audit_canonical_cfg`` on a 1-rank mesh (the same program at
    any mesh size; its 16 instances divide the shard tier's whole grid).
    ``shard_build`` runs it over a grid mesh; ``shard_state`` is the global
    sharded ``SimState`` (queue leaves with the leading shard axis) the
    partition table must cover leaf for leaf."""
    from tpu_paxos_torch.analysis.registry import AuditEntry
    from tpu_paxos_torch.parallel import mesh as pmesh

    def _setup(mesh):
        fn, root, states, _expected = build_runner(simm.audit_canonical_cfg(), mesh)
        return fn, (root, states)

    def build(device):
        return _setup(pmesh.make_instance_mesh(1, device=device))

    def shard_state(n_shards: int = 1):
        cfg = simm.audit_canonical_cfg()
        pend, gate, tail, _c = prepare_queues_sharded(cfg, simm.default_workload(cfg), None,
                                                      n_shards)
        return "sim", global_state(cfg, pend, gate, tail, prng.root_key(cfg.seed))

    return [AuditEntry("sharded_sim.run_rounds", build, covers=("build_runner",),
                       shard_build=_setup, shard_state=shard_state)]
