"""The instance mesh and its collectives (port of
``tpu_paxos/parallel/mesh.py``).

JAX shards consensus state over the *instance* axis of a device mesh and
runs one program per device under ``shard_map``; the only cross-shard
traffic is small ``pmax``/``psum`` reductions of per-acceptor and
per-proposer values.  The port runs a mesh's ``D`` ranks as ``D``
threads of one process (:meth:`Mesh.run`), the single-controller shape
of JAX's ``shard_map`` over virtual devices.  Each rank holds its block
of instances on its own device:

- rank ``r`` runs on ``devices[r]``: with one card every rank's tensors
  live on ``cuda:0``, with ``D`` cards or more on ``cuda:r``, and on the
  CPU on the CPU;
- a round reads its predicates to the host anyway (``core/sim._any``),
  so the collectives reduce host values: :meth:`Collectives.exchange`
  is an all-gather through a ``torch.distributed`` ``HashStore`` the
  run's ranks share (each rank sets its vector under its key and reads
  every rank's), and ``gmax``/``gany``/``gall``/``gsum`` reduce it over
  every mesh axis.  A round packs the values JAX reduces in one place
  into one vector.  (A gloo all-reduce between thread ranks would cross
  TCP loopback in several steps a call; PERF.md has the two measured.)
- NCCL will not put two ranks on one GPU, and the machine has one card:
  no NCCL path is written.

Mesh axes are JAX's: ``("i",)``, or ``("dcn", "i")`` when
``dcn_hosts > 1`` (hosts outer, a host's chips inner; the rank is the
row-major linear index, as ``jax.lax.axis_index(("dcn", "i"))``).
Every collective reduces over all axes, so a ``(2, 4)`` mesh computes
what an 8-rank ``("i",)`` mesh computes, bit for bit.

No hang: a rank that raises writes an abort mark under the key the
others wait on, so they fail at once, and the store's timeout fails a
rank left waiting by one that hangs; :meth:`Mesh.run` re-raises the first
rank's exception as :class:`RankError` naming the rank.  Ranks share no mutable state: the
kernel launch counts go to each rank's own dict
(``core/simkern.counting``), the kernel build is under its lock
(``utils/kbuild.load``), and each rank builds its own round function.
The one thing ranks share is read-only: a round's coins, which every
rank draws alike, are drawn by the first rank on a device to reach the
round and read by the others (``Collectives.shared``).

The lane tile (:func:`lane_blocks`, :func:`split_lanes`,
:func:`gather_lanes`) lays a fleet's lane axis over the same ranks:
rank ``r`` runs lanes ``[r L / D, (r + 1) L / D)`` on ``devices[r]``.
Lanes are independent, so a tiled dispatch makes no collective; its
inputs are split and its outputs gathered through the rule table's
``fleet/``, ``member/`` and ``serve/`` rows, as JAX's ``shard_map`` over
``instance_spec(mesh)`` lays them.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import threading
import time

import numpy as np
import torch

from tpu_paxos_torch.core import simkern
from tpu_paxos_torch.utils import counters
from tpu_paxos_torch.utils import device as devm

INSTANCE_AXIS = "i"
DCN_AXIS = "dcn"

#: Seconds a rank waits in a collective before it gives up.
DEFAULT_TIMEOUT_S = 300.0

#: What a failed rank leaves under the key of its next exchange.
_ABORT = b"abort"

_LOCAL = threading.local()


def current_rank() -> int | None:
    """The rank the calling thread runs (None outside :meth:`Mesh.run`)."""
    return getattr(_LOCAL, "rank", None)


class RankError(RuntimeError):
    """A rank of :meth:`Mesh.run` raised; ``rank`` names it and the
    original exception is the ``__cause__``."""

    def __init__(self, rank: int, size: int, exc: BaseException):
        super().__init__(f"rank {rank} of {size} raised {type(exc).__name__}: {exc}")
        self.rank = rank


class Collectives:
    """One rank's view of the mesh: its rank, the mesh's axes and the
    four reductions the round needs, each over every mesh axis.  Values
    are host numpy (or anything ``np.asarray`` takes); ``calls`` counts
    the collectives this rank has made."""

    def __init__(self, mesh: "Mesh", rank: int, store, turn, shared: dict):
        self.mesh = mesh
        self.rank = rank
        self.size = mesh.size
        self.axes = mesh.axis_names
        self.device = mesh.devices[rank]
        self._store = store
        self._turn = turn
        #: Replicated values one rank computes and the others read, never
        #: write (``core/sim``'s round draws); one dict per run.
        self.shared = shared
        self.calls = 0

    def exchange(self, x) -> np.ndarray:
        """Every rank's ``x`` (same shape on every rank), stacked in rank
        order as int64 ``[size, *x.shape]``.  Exchange ``n`` of a run
        keys rank ``r``'s vector ``n/r``; a rank drops its key of exchange
        ``n - 2`` once it has read exchange ``n - 1`` (every rank has read
        ``n - 2`` by then)."""
        x = np.asarray(x, np.int64)
        seq = self.calls
        self._store.set(f"{seq}/{self.rank}", np.ascontiguousarray(x).tobytes())
        # the other ranks run their Python while this one waits
        self._turn.release()
        try:
            rows = [self._store.get(f"{seq}/{r}") for r in range(self.size)]
        finally:
            self._turn.acquire()
        for r, row in enumerate(rows):
            if row == _ABORT:
                raise RuntimeError(f"rank {r} raised during collective {seq}")
        if seq >= 2:
            self._store.delete_key(f"{seq - 2}/{self.rank}")
        self.calls += 1
        counters.add("collectives")
        return np.stack([np.frombuffer(row, np.int64) for row in rows]).reshape(
            (self.size, *x.shape))

    def abort(self) -> None:
        """Mark this rank's next exchange failed, so every rank waiting
        on it raises at once."""
        self._store.set(f"{self.calls}/{self.rank}", _ABORT)

    def gmax(self, x) -> np.ndarray:
        return self.exchange(x).max(axis=0)

    def gsum(self, x) -> np.ndarray:
        return self.exchange(x).sum(axis=0)

    def gany(self, b) -> np.ndarray:
        return self.exchange(np.asarray(b, bool)).any(axis=0)

    def gall(self, b) -> np.ndarray:
        return ~self.gany(~np.asarray(b, bool))


@contextlib.contextmanager
def _on_device(dev: torch.device):
    """A rank thread's device context.  The ranks on one card share its
    default stream: they run one at a time anyway, and a replicated
    value one rank computes is then ordered before another rank's use of
    it."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    yield


class Mesh:
    """``shape`` ranks with ``axis_names``, rank ``r`` on ``devices[r]``
    (row-major over the axes).  :meth:`run` drives one function on every
    rank; the per-rank kernel launch counts and collective calls of the
    last run are kept as ``launches`` and ``calls``."""

    def __init__(self, shape, axis_names, devices, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.shape = tuple(int(d) for d in shape)
        self.axis_names = tuple(axis_names)
        self.devices = [torch.device(d) for d in devices]
        self.size = math.prod(self.shape)
        if len(self.devices) != self.size:
            raise ValueError(f"a {self.shape} mesh needs {self.size} devices, got {len(self.devices)}")
        self.timeout_s = float(timeout_s)
        self.launches: list[dict] = []
        self.calls: list[int] = []
        #: per-rank launch counts summed over every run since
        #: :meth:`reset_totals` (a tiled serve fleet runs once a dispatch)
        self.launch_totals: list[dict] = []
        self.reset_totals()

    def reset_totals(self) -> None:
        self.launch_totals = [{k: 0 for k in simkern.LAUNCHES} for _ in range(self.size)]

    def run(self, fn) -> list:
        """``fn(Collectives)`` on every rank, one thread each, over a fresh
        store; returns the ranks' results in rank order.  If a rank
        raises, the others fail in their next collective, and the first
        rank's exception is re-raised as :class:`RankError` naming it."""
        import torch.distributed as dist

        store = dist.HashStore()
        store.set_timeout(datetime.timedelta(seconds=self.timeout_s))
        # One rank runs Python at a time, from one collective to the next
        # (a rank hands the turn on while it waits in a collective): the
        # ranks would be serialized by the interpreter lock anyway, and
        # threads trading it around every small tensor op lose most of
        # their time waiting for it.
        turn = threading.Lock()
        shared = {}
        colls = [Collectives(self, r, store, turn, shared) for r in range(self.size)]
        launches = [{k: 0 for k in simkern.LAUNCHES} for _ in range(self.size)]
        outer = simkern.held_counts()  # the caller's counting block, if any
        results = [None] * self.size
        errors = []

        def body(r):
            _LOCAL.rank = r
            turn.acquire()
            try:
                with simkern.counting(launches[r]), _on_device(self.devices[r]):
                    results[r] = fn(colls[r])
            except BaseException as e:  # noqa: BLE001 - re-raised by the caller
                # paxlint: allow[DET001] a rank's failure time orders the errors and bounds the wait; never reaches results
                errors.append((time.monotonic(), r, e))
                colls[r].abort()
            finally:
                _LOCAL.rank = None
                turn.release()

        threads = [threading.Thread(target=body, args=(r,), daemon=True, name=f"mesh-rank-{r}")
                   for r in range(self.size)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            # paxlint: allow[DET001] a rank's failure time orders the errors and bounds the wait; never reaches results
            if errors and time.monotonic() - min(e[0] for e in errors) > self.timeout_s + 30:
                break  # a rank stuck outside any collective: give up on it
            for t in threads:
                t.join(0.05)
        self.launches = launches
        self.calls = [c.calls for c in colls]
        for total, counts in zip(self.launch_totals, launches):
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
                if outer is not None:
                    outer[k] = outer.get(k, 0) + n
        if errors:
            _, rank, exc = min(errors, key=lambda e: e[0])
            raise RankError(rank, self.size, exc) from exc
        return results


def rank_devices(n: int, device="cuda") -> list[torch.device]:
    """The devices of ``n`` ranks: all on the CPU for ``"cpu"``; on cards,
    rank ``r`` on ``cuda:r`` modulo the card count (all on ``cuda:0`` with
    one card), or all on ``device`` when it names a card."""
    dev = devm.resolve(device)
    if dev.type == "cpu":
        return [dev] * n
    if dev.index is not None:
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(n)]


def make_instance_mesh(n_devices: int | None = None, devices=None, dcn_hosts: int = 1,
                       device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Mesh over the instance axis: ``n_devices`` ranks (default: one per
    visible card, or one on the CPU) placed by :func:`rank_devices`, or
    the first ``n_devices`` of an explicit ``devices`` list.  With
    ``dcn_hosts > 1`` the mesh is 2-D ``(dcn_hosts, ranks // dcn_hosts)``
    with axes ``("dcn", "i")``, ``dcn_hosts`` clamped to its gcd with the
    rank count as JAX clamps it."""
    if devices is None:
        dev = devm.resolve(device)
        if n_devices is None:
            n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
        devices = rank_devices(n_devices, dev)
    else:
        devices = list(devices)
        if n_devices is not None:
            devices = devices[:n_devices]
    if dcn_hosts > 1:
        dcn_hosts = math.gcd(dcn_hosts, len(devices))
        return Mesh((dcn_hosts, len(devices) // dcn_hosts), (DCN_AXIS, INSTANCE_AXIS),
                    devices, timeout_s)
    return Mesh((len(devices),), (INSTANCE_AXIS,), devices, timeout_s)


def instance_axes(mesh: Mesh) -> tuple[str, ...]:
    """Every mesh axis shards the instance dimension; collectives reduce
    over this whole tuple."""
    return tuple(mesh.axis_names)


def instance_spec(mesh: Mesh | None = None) -> tuple:
    """The layout of ``[instances, ...]`` arrays: dim 0 split over the
    mesh's axes (JAX's ``PartitionSpec(axes)``, as a tuple)."""
    return (instance_axes(mesh) if mesh is not None else INSTANCE_AXIS,)


def shard_instances(mesh: Mesh, arr) -> list[torch.Tensor]:
    """An ``[I, ...]`` array (numpy or tensor) as the ranks' blocks of
    ``I / size`` rows, each on its rank's device."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    n = int(t.shape[0])
    if n % mesh.size:
        raise ValueError(f"{n} instances do not divide over {mesh.size} devices")
    step = n // mesh.size
    return [t[r * step:(r + 1) * step].to(mesh.devices[r]).contiguous() for r in range(mesh.size)]


def per_device(devices, build) -> dict:
    """``build(dev)`` once for each distinct device of ``devices``, keyed
    by ``str(dev)``: a tiled runner's round functions, which the ranks on
    one card share (a round function holds constants only, and one rank
    runs at a time)."""
    out = {}
    for dev in devices:
        if str(dev) not in out:
            out[str(dev)] = build(dev)
    return out


def check_lanes(mesh: Mesh | None, n_lanes: int) -> None:
    """The tile's rejection, JAX's by name: a lane count that does not
    divide over the mesh's ranks."""
    if mesh is not None and n_lanes % mesh.size:
        raise ValueError(f"{n_lanes} lanes do not tile over {mesh.size} devices")


def lane_blocks(mesh: Mesh, n_lanes: int) -> list[slice]:
    """Rank ``r``'s lanes ``[r L / D, (r + 1) L / D)`` of an ``L``-lane
    dispatch; raises :func:`check_lanes`' ``ValueError``."""
    check_lanes(mesh, n_lanes)
    step = n_lanes // mesh.size
    return [slice(r * step, (r + 1) * step) for r in range(mesh.size)]


def split_lanes(mesh: Mesh, family: str, tree, rank: int):
    """Rank ``rank``'s block of a lane-leading tree (numpy or tensor
    leaves; tuples and None welcome) through the rule table's ``family``
    rows, tensor leaves on the rank's device (views where they already
    are)."""
    from tpu_paxos_torch.parallel import partition_rules as prules

    part = prules.split_tree(family, tree, mesh.size, rank)
    dev = mesh.devices[rank]
    return prules.map_leaves(
        lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, part)


def gather_lanes(mesh: Mesh | None, family: str, trees):
    """The lane-leading tree of every rank's block (in rank order):
    tensor leaves concatenated on the mesh's first device, numpy leaves
    on the host.  Untiled (``mesh`` None) the one block is the tree."""
    from tpu_paxos_torch.parallel import partition_rules as prules

    if mesh is None:
        return trees[0]
    return prules.gather_tree(family, trees, device=mesh.devices[0])


def on_lanes(mesh: Mesh | None, family: str, fn, device, lane_in) -> list:
    """A lane-axis dispatch, tiled or not: ``[fn(0, device, lane_in)]``
    untiled (``mesh`` None), else ``fn(rank, rank's device, rank's block of
    lane_in)`` on every rank of ``mesh`` (``Mesh.run``; a raising rank
    raises :class:`RankError`), the outputs in rank order."""
    if mesh is None:
        return [fn(0, device, lane_in)]
    return mesh.run(lambda comm: fn(
        comm.rank, comm.device, split_lanes(mesh, family, lane_in, comm.rank)))
