"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Report the card (``nvidia-smi`` name and power limit, the torch
   device name) and build the CUDA kernels from ``tpu_paxos_torch/csrc``
   (one ``nvcc`` per source, started together).
2. Hold the general engine's kernels (``simkern``) against their plain
   PyTorch versions on the card, at the main path's shape (A=5, P=2,
   I=2**23) and at odd sizes, with exact equality (all protocol state is
   integer), ``store_accepts`` also on a full-size set shaped like a real
   round (batches on one 2**20 window per proposer, one proposer
   eligible nowhere), and time kernel and plain version with CUDA events (median
   of 25 launches; before each, the in-place operands are restored and
   the L2 is flushed, so every launch does a first launch's work),
   against the bytes these operands need (``simkern.bytes_needed``; the
   dense count, ``bytes_per_launch``, is printed beside it).
3. Drive the general engine's main path — ``tpu_paxos_torch.core.sim.run``
   at the ``"engine": "sim"`` bench configuration (5 nodes, 2**23
   instances, proposers (0, 1), assign_window 2**20, drop 500 / dup
   1000 / delay 0-2, seed 0) — with the launch counts zeroed just before
   and read just after; it must launch both kernels, pass the invariant
   checks and reproduce the committed JAX golden (rounds, chosen count,
   decision-log sha256, ``tpu_paxos_torch/data/goldens.json``).
   Then run it again, recording the operands of every simkern launch
   (about 12 GB on the card, freed before phase 5), and on each of those
   snapshots hold the kernel against its plain version exactly, time it
   (median of 9 launches, restored operands, cold L2) and count the
   32-byte sectors its operands need (``simkern.bytes_needed``): the
   sums over the run are each simkern record's ``main_path_ms`` and
   ``main_path_bound_ms``.  Each ``store_accepts`` line also gives the
   launch's live-batch share and the batch rows it reads.
4. Run the CLI-sized workload (``4 4 10`` with the debug.conf faults,
   gates on) through ``python -m tpu_paxos_torch``'s entry point; its
   decision log must match the second golden.
5. Hold the fast path's window kernel (``fastwin``) against its plain
   version, exactly (all five state fields and the counts), at the
   headline shape (A=5, I=2**27, 16 windows) for sequential and explicit
   vids, a span > I case and a no-quorum case, and the raw wrapper at
   I=2**20+7 and 80; time kernel and plain version (median of 10 calls)
   beside the bytes bound.
6. Drive the fast path's main path, the headline run
   ``steady_state_windows_fused(fast.init_state(2**27, 5), None,
   reps=16, quorum=3, iota_vids=True)``, three times, with the counts
   zeroed just before the first and read just after it: each host total
   must be exactly 2**31 and the last window's learned rows
   ``arange(I) + 15 * 2**27``.
7. Run ``python -m tpu_paxos_torch 5 8192 1024 --engine=fast --json``
   (2**23 instances); its stdout must equal the JAX CLI's golden.
8. Drive the general engine under correlated faults at bench_sim's size:
   the ``partition-flap`` and ``wan-3region`` mixes of
   ``tpu_paxos/harness/stress.py``, each with the counts zeroed before
   and read after; each must launch both simkern kernels, pass the
   invariant checks and reproduce its JAX golden (rounds, done, chosen
   count, decision-log and chosen-round sha256).
9. Drive the fleet runner (``fleet.runner.FleetRunner.run``) at
   ``bench.py``'s fleet configuration: 5 nodes, proposers (0, 1), the
   gated stress workload on 56 instances, ``max_rounds`` 20000, ring bound
   8, 128 lanes with sampled schedules, first under the headline knob
   cycle (seeds 0-127), then the delay-spread cycle (seeds 50000+) on the
   113 of its lanes that decide within ``DELAY_ROUNDS_MAX`` (1000) rounds
   or park (the 15 that duel for 1011-7988 rounds are left out: they
   cost 7000 round calls), each
   with the counts zeroed before and read after: both simkern kernels
   must launch on lane-stacked operands (all the dispatch's lanes a
   launch), every lane
   be ``ok``, and the six verdict fields and every lane's decision-log
   sha256 equal the JAX goldens.  Prints lanes/sec to verdict, rounds,
   ms and host syncs a round.  Then the headline again with every kernel
   launch held against its plain version on its own lane-stacked
   operands, timed and its needed bytes counted, and a 2048-lane
   dispatch (timing only) of which 8 lanes are re-run as single
   ``sim.run(lane_cfg(i))`` on the card and must match exactly.
10. The runtime build at full width: one ``FleetRunner`` per mix at
   bench_sim's shape (2**23 instances), ``partition-flap`` as a runtime
   table with its knobs and ``wan-3region`` as its runtime edge matrices
   plus table, 2 lanes each.  Lane 0 runs the golden's seed and must
   reproduce phase 8's constant-path golden; lane 1 another seed and
   must equal the single ``sim.run(lane_cfg(1))`` on the card.  Every
   kernel launch is held against its plain version on its lane-stacked
   operands, timed and its needed bytes counted.
11. Failure triage on the card, each step against the JAX goldens
   (``stress_quick``, ``triage_wedge``, ``triage_full``):
   a. ``python -m tpu_paxos_torch.harness.stress --seeds 1 --triage-dir
      DIR`` (``make stress-quick``'s host-loop sweep over the 10 mixes,
      at the golden's one seed a mix) as a subprocess; its summary, less
      ``seconds``, must equal JAX's.
   b. Under ``TPU_PAXOS_SEEDED_WEDGE=takeover`` the pause-crash sweep
      (2 seeds) must find what JAX's finds (nothing); then the two small
      triage cases (``culprit``, the three-episode ``decision_round_max``
      case, and ``takeover``, a real seeded wedge, armed) are shrunk on
      the card with the batched evaluator (8-lane dispatches), with the
      counts zeroed before and read after: the final case, violation,
      moves and eval count must equal JAX's, both kernels must launch on
      8-lane operands, the written artifact must equal JAX's byte for
      byte (file sha256), and ``python -m tpu_paxos_torch repro <a>
      --json`` must exit 0 with stdout equal to JAX's (sha256).  Prints
      the shrink's wall, evals, dispatches and ms a round.  The culprit
      shrink is then run again with every 8-lane kernel launch held
      against its plain version on its own operands, timed and its
      needed bytes counted.
   c. Full width: ``bench_sim_partition_flap`` (2**23 instances) with
      ``decision_round_max`` one below its last decision, shrunk with
      ``shrink_case(max_evals=3, batch=False)`` (one-lane runtime runs at
      2**23), then ``save_artifact`` and a CLI ``repro``: the final case,
      violation, moves, evals, the artifact's decision-log sha256 and
      rounds, the file's and the CLI stdout's sha256 and ``match`` must
      equal JAX's.  Prints the peak device memory.
12. The flight recorder on the card, against the JAX goldens
   (``telemetry``), with phase 12's own seconds:
   a. ``sim.run_with_telemetry`` (``window_rounds`` 16) at full width on
      ``bench_sim``, ``bench_sim_partition_flap`` and ``bench_sim_wan3``
      (the last with the WAN3 region map and names), each with the
      counts zeroed before and read after: the decision-log sha256 must
      equal the plain golden and ``summary_to_dict(summary, windows)``
      JAX's, key for key, and both simkern kernels must launch; on
      ``bench_sim`` every launch is held against its plain version on its
      own operands.
   b. ``bench_sim``'s round loop alone, plain and armed in turns (plain,
      armed, armed, plain): ms and host syncs a round; the syncs a round
      must be equal.
   c. The fleet's headline cycle at 128 lanes (phase 9's configuration),
      plain and armed (``FleetRunner(telemetry=True)``, ``run(regions=)``
      cycling the WAN3 map, the WAN5 map and None) in turns: every armed
      lane's ``lane_telemetry(i)`` (sha256 of its sorted compact JSON)
      and decision-log sha256 must equal the goldens, both kernels
      launch on 128-lane operands, and the syncs a round must be equal;
      prints lanes/s, ms and syncs a round of each.
   d. ``python -m tpu_paxos_torch trace <basename> --stdout`` in three
      subprocesses at once, in each artifact's directory, on the two committed
      artifacts (``tpu_paxos_torch/data/repro_{culprit,takeover}.json``,
      the latter with the seeded wedge armed) and on 11c's 2**23
      artifact: each stdout's sha256 must equal JAX's and the artifact's
      bytes stay unchanged.
13. The schedule search, the fleet stress sweep and the geometry-padded
   envelope on the card, against the JAX goldens (``search``,
   ``stress_fleet``, ``envelope``), with phase 13's own seconds:
   a. ``python -m tpu_paxos_torch fleet --lanes 8 --generations 1 --seed 2
      --decision-round-max 35 --max-wedges 1 --triage-dir DIR --quiet``
      (``make fleet-quick``'s arguments) as a subprocess, started beside
      13c's: its summary,
      less ``seconds``, ``lanes_per_sec`` and ``shrink_seconds``, must
      equal JAX's, the wedge artifact must equal JAX's byte for byte
      (file sha256) and ``python -m tpu_paxos_torch repro`` on it must
      exit 0 with JAX's stdout (sha256).
   b. ``fleet.search.main`` at the card's default 128 lanes with
      ``--generations 2 --seed 0 --gray --wan`` (no triage directory),
      with the counts zeroed before and read after: the summary less the
      timing keys (every generation's margins, causes and per-lane causes
      included) must equal JAX's and both kernels must launch on 128-lane
      operands.  Prints lanes/s, ms and host syncs a round.
   c. ``python -m tpu_paxos_torch.harness.stress --fleet --seeds 8
      --triage-dir DIR`` as a subprocess: both summary lines, less
      ``seconds``, ``lanes_per_sec`` and ``compiles_per_mix``, must equal
      JAX's (the per-mix ``telemetry`` blocks key for key).  Prints each
      mix's lanes/s.
   d. ``bench.py``'s geometry-padded envelope configuration (menu 3/(0,),
      5/(0,1), 7/(0,1,2); three 8-value rows on 48 instances,
      ``max_rounds`` 4000; 64 lanes; both protocol configs and both
      rates): one ``runner_for(..., geometry=)`` serves all 12 cells (one
      runner built), with the counts zeroed before and read after; each
      lane's rounds, verdict and decision-log sha256 must equal JAX's and
      its bound-free twin's on the card, and both kernels launch on
      64-lane (A, P) = (7, 3) operands (the run-time-loop build).  Then
      the padding toll: lanes/s at each true geometry, padded and
      unpadded in turns; and one padded dispatch at 7 nodes with every
      kernel launch held against its plain version, timed and its needed
      bytes counted.

The line before the last is a JSON object with one record per kernel;
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
A, P, I_FULL = 5, 2, 1 << 23
REPS = 25
SNAP_REPS = 9  # launches timed on each main-path snapshot
FLEET_WIDE = 2048  # lanes of the timing-only fleet dispatch
DELAY_ROUNDS_MAX = 1000  # the delay cycle's lanes run: those deciding within this many rounds
FLEET_SINGLES = 8  # lanes of it re-run as single runs
FULL_REPS = 3  # launches timed on each full-width runtime-lane snapshot
TRIAGE_REPS = 3  # launches timed on each 8-lane shrink-dispatch snapshot
L2_FLUSH_BYTES = 1 << 30
I_FW, WINDOWS, FW_REPS = 1 << 27, 16, 10  # the fast path's headline shape
DEV = "cuda"


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _rand_inputs(i: int, seed: int):
    """Seeded acceptor/proposer arrays with realistic NONE density and
    ballot ties between the accepted ballots and the proposers' ballots."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    dev = DEV

    def rint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    def coin(prob, shape):
        return torch.rand(shape, generator=g, device=dev) < prob

    ballots = torch.tensor([65536, 65537, 131072, 131073, 196608], dtype=torch.int32, device=dev)
    acc_ballot = torch.where(coin(0.3, (A, i)), ballots[rint(0, 5, (A, i)).long()], -1)
    acc_vid = torch.where(acc_ballot != -1, rint(0, 1 << 23, (A, i)), -1)
    learned = torch.where(coin(0.2, (A, i)), rint(0, 1 << 23, (A, i)), -1)
    # some batches agree with the accepted / learned values (store-or-match)
    batch = torch.where(coin(0.7, (P, i)), rint(0, 1 << 23, (P, i)), -1)
    batch = torch.where(coin(0.2, (P, i)), acc_vid[:P], batch)
    batch = torch.where(coin(0.1, (P, i)), learned[:P], batch)
    abal = ballots[torch.tensor([1, 2], device=dev)]
    elig = coin(0.6, (P, A))
    elig[:, 0] = True
    acks = coin(0.2, (P, A, i)).to(torch.int8)
    return acc_ballot, acc_vid, learned, batch.contiguous(), abal, elig, acks


def _round_store_inputs(i: int, seed: int):
    """store_accepts operands shaped like a real round at full size: each
    proposer's batches on one assignment window of 2**20 instances with
    NONE elsewhere, acceptors holding (at the proposer's ballot or a
    higher one) or having learned some of proposer 0's, and proposer 1
    eligible at no acceptor, so one batch row is read."""
    acc_ballot, acc_vid, learned, _, abal, elig, _ = _rand_inputs(i, seed)
    g = torch.Generator(device=DEV).manual_seed(seed)
    win = 1 << 20
    batch = torch.full((P, i), -1, dtype=torch.int32, device=DEV)
    for p in range(P):
        w0 = int(torch.randint(0, i // win, (1,), generator=g, device=DEV)) * win
        batch[p, w0:w0 + win] = torch.randint(
            0, 1 << 23, (win,), generator=g, device=DEV, dtype=torch.int32)
    for a in range(A):
        pick = (batch[0] != -1) & (torch.rand(i, generator=g, device=DEV) < 0.5)
        hold = pick & (torch.rand(i, generator=g, device=DEV) < 0.7)
        higher = torch.rand(i, generator=g, device=DEV) < 0.3
        acc_vid[a] = torch.where(hold, batch[0], acc_vid[a])
        acc_ballot[a] = torch.where(hold, torch.where(higher, abal[1], abal[0]), acc_ballot[a])
        learned[a] = torch.where(pick & ~hold, batch[0], learned[a])
    elig[1] = False
    return acc_ballot, acc_vid, learned, batch, abal, elig


def _store_shape(ops) -> tuple[float, int]:
    """A store_accepts operand set's live-batch share (instances where a
    batch row the kernel reads holds a batch) and the batch rows it reads
    (the proposers eligible at some acceptor)."""
    abat, elig = ops[3], ops[5]
    rows = elig.any(dim=1)
    live = (abat[rows] != -1).any(dim=0)
    return float(live.float().mean()), int(rows.sum())


def _flusher():
    """A setup step that reads a buffer twenty times the 50 MB L2, so the
    next launch finds its operands in device memory, as the main path
    does at 2**23.  It keeps the card busy for about 0.3 ms, longer than
    the wrapper's host work, so the events time the kernel alone."""
    buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
    return buf.sum


def _median_ms(fn, reps: int = REPS, setup=None) -> float:
    """Median CUDA-event time of ``fn``; ``setup`` runs before each timed
    launch, outside the events."""
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def time_in_place(fn, ops, in_place, reps: int = REPS) -> float:
    """Median time of ``fn(*work)`` where ``work`` is a copy of ``ops``
    whose in-place operands (indices ``in_place``) are restored from
    ``ops`` before every launch, and the L2 flushed: each launch does a
    first launch's work on cold operands, and nothing compounds."""
    work = [t.clone() if k in in_place else t for k, t in enumerate(ops)]
    flush = _flusher()

    def setup():
        for k in in_place:
            work[k].copy_(ops[k])
        flush()

    return _median_ms(lambda: fn(*work), reps, setup)


def _max_abs_err(pairs) -> int:
    err = 0
    for got, want in pairs:
        if not torch.equal(got, want):
            err = max(err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
            if err == 0:
                err = 1  # shape or dtype mismatch
    return err


def check_kernels(sk) -> dict:
    """Phase 2: kernel == plain version, exactly, at full and odd sizes;
    times at the main path's shape."""
    rec = {}
    for i in (I_FULL, I_FULL + 7, 80):
        ab, av, lr, bat, abal, elig, acks = _rand_inputs(i, seed=i)
        want = sk.store_accepts_plain(ab, av, lr, bat, abal, elig)
        got = sk.store_accepts_cuda(ab.clone(), av.clone(), lr, bat, abal, elig)
        torch.cuda.synchronize()
        err_s = _max_abs_err(zip(got, want))
        want = sk.accum_acks_plain(acks, bat, ab, av, lr, abal, elig)
        got = sk.accum_acks_cuda(acks.clone(), bat, ab, av, lr, abal, elig)
        torch.cuda.synchronize()
        err_a = _max_abs_err(zip(got, want))
        print(f"kernels vs plain at A={A} P={P} I={i}: store_accepts max_abs_err={err_s} "
              f"accum_acks max_abs_err={err_a}")
        if err_s or err_a:
            raise SystemExit(f"kernel disagrees with its plain version at I={i}")
        if i != I_FULL:
            continue
        store_ops = (ab, av, lr, bat, abal, elig)
        ack_ops = (acks, bat, ab, av, lr, abal, elig)
        rec["simkern.store_accepts"] = {
            "max_abs_err": err_s,
            "ms": time_in_place(sk.store_accepts_cuda, store_ops, (0, 1)),
            "plain_ms": _median_ms(lambda: sk.store_accepts_plain(*store_ops), setup=_flusher()),
            "dense_bytes": sk.bytes_per_launch("store_accepts", A, P, i),
            "bytes": sk.bytes_needed("store_accepts", *store_ops),
            "ops": 8 * A * P * i,
        }
        rec["simkern.accum_acks"] = {
            "max_abs_err": err_a,
            "ms": time_in_place(sk.accum_acks_cuda, ack_ops, (0,)),
            "plain_ms": _median_ms(lambda: sk.accum_acks_plain(*ack_ops), setup=_flusher()),
            "dense_bytes": sk.bytes_per_launch("accum_acks", A, P, i),
            "bytes": sk.bytes_needed("accum_acks", *ack_ops),
            "ops": 9 * A * P * i,
        }
        del store_ops, ack_ops
    ops = _round_store_inputs(I_FULL, seed=1)
    want = sk.store_accepts_plain(*ops)
    got = sk.store_accepts_cuda(ops[0].clone(), ops[1].clone(), *ops[2:])
    torch.cuda.synchronize()
    err = _max_abs_err(zip(got, want))
    share, rows = _store_shape(ops)
    b = sk.bytes_needed("store_accepts", *ops)
    print(f"store_accepts vs plain on a round-shaped set at A={A} P={P} I={I_FULL} "
          f"(live share {share:.4f}, {rows} batch row read): max_abs_err={err}, kernel "
          f"{time_in_place(sk.store_accepts_cuda, ops, (0, 1)):.4f} ms, needs {b} bytes "
          f"(bound {b / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    if err:
        raise SystemExit("store_accepts disagrees with its plain version on the round-shaped set")
    rec["simkern.store_accepts"]["max_abs_err"] = max(rec["simkern.store_accepts"]["max_abs_err"], err)
    del ops, want, got
    for name, r in rec.items():
        r["bytes_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r["ops_ms"] = r["ops"] / SCALAR_OPS_PER_S * 1e3
        print(f"{name}: needs {r['bytes']} bytes/launch of {r['dense_bytes']} dense "
              f"({r['dense_bytes'] / I_FULL:.1f} B/instance), kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bytes bound {r['bytes_ms']:.4f} ms "
              f"({r['bytes_ms'] / r['ms']:.1%} of bound; dense "
              f"{r['dense_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    torch.cuda.empty_cache()
    return rec


def _bench_cfg(gold):
    from tpu_paxos_torch import config as cfgm

    bc = gold["config"]
    return cfgm.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
        proposers=tuple(bc["proposers"]), seed=bc["seed"],
        assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=cfgm.FaultConfig(**bc["faults"]),
    )


def _check_bench_sim(res, cfg, gold) -> str:
    from tpu_paxos_torch.replay.decision_log import decision_log, sha256

    sha = sha256(decision_log(res.chosen_vid, res.chosen_ballot, gold["stride"], cfg.n_instances))
    chosen = int((res.chosen_vid != -1).sum())
    if (res.rounds, bool(res.done), chosen, sha) != (
        gold["rounds"], gold["done"], gold["chosen"], gold["decision_log_sha256"]
    ):
        raise SystemExit(f"main path disagrees with the JAX golden: {gold}")
    return sha


def run_main_path(sk, goldens) -> dict:
    """Phase 3: the full-size general-engine run on the card."""
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.harness import validate

    gold = goldens["bench_sim"]
    cfg = _bench_cfg(gold)
    torch.cuda.reset_peak_memory_stats()
    sk.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(cfg, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    chosen = int((res.chosen_vid != -1).sum())
    print(f"main path (sim.run, I={cfg.n_instances}): rounds={res.rounds} done={res.done} "
          f"chosen={chosen} wall_s={wall:.3f} peak_mem_gb={peak_gb:.2f} "
          f"launches={json.dumps(launches, sort_keys=True)}")
    validate.check_all(res.learned, res.expected_vids)
    print("main path invariants: agreement, exactly_once, executed_identical")
    sha = _check_bench_sim(res, cfg, gold)
    print(f"main path decision_log_sha256={sha} (matches the JAX golden)")
    for name, n in launches.items():
        if n < 1:
            raise SystemExit(f"kernel simkern.{name} was never launched on the main path")
    return launches


@contextlib.contextmanager
def _wrapping(sk, wrap):
    """Within the block both simkern kernel wrappers are replaced by
    ``wrap(name, kernel)``; the originals come back after it."""
    kernels = {"store_accepts": sk.store_accepts_cuda, "accum_acks": sk.accum_acks_cuda}
    sk.store_accepts_cuda = wrap("store_accepts", kernels["store_accepts"])
    sk.accum_acks_cuda = wrap("accum_acks", kernels["accum_acks"])
    try:
        yield
    finally:
        sk.store_accepts_cuda = kernels["store_accepts"]
        sk.accum_acks_cuda = kernels["accum_acks"]


@contextlib.contextmanager
def capture_operands(sk):
    """Record a clone of every simkern launch's operands, as the kernel
    is given them (before its in-place update), by kernel name; a
    one-lane launch's without its lane axis."""
    snaps = {"store_accepts": [], "accum_acks": []}

    def recording(name, kernel):
        lane_ndim = 3 if name == "store_accepts" else 4

        def launch(*ops):
            # a single run launches on one lane: keep its operands as
            # one run's, the shapes an older one-run build takes
            one = ops[0].ndim == lane_ndim and ops[0].shape[0] == 1
            snaps[name].append([t[0].clone() if one else t.clone() for t in ops])
            return kernel(*ops)
        return launch

    with _wrapping(sk, recording):
        yield snaps


def snapshot_main_path(sk, goldens, launches) -> dict:
    """Phase 3b: a second bench_sim run that records every kernel
    launch's operands (the timed run above stays a plain run)."""
    from tpu_paxos_torch.core import sim

    gold = goldens["bench_sim"]
    cfg = _bench_cfg(gold)
    with capture_operands(sk) as snaps:
        res = sim.run(cfg, device=DEV)
    torch.cuda.synchronize()
    _check_bench_sim(res, cfg, gold)
    counts = {k: len(v) for k, v in snaps.items()}
    gb = sum(t.numel() * t.element_size() for v in snaps.values() for ops in v for t in ops) / 1e9
    print(f"main path snapshots: {json.dumps(counts, sort_keys=True)} launches, {gb:.2f} GB on the card")
    if counts != launches:
        raise SystemExit(f"snapshot run launched {counts}, the main path {launches}")
    return snaps


def time_main_path_operands(sk, snaps) -> dict:
    """Phase 3c: each kernel on each main-path snapshot: equal to its
    plain version, timed (median of SNAP_REPS launches from restored
    operands and a cold L2), and the bytes those operands need."""
    out = {}
    kernels = {  # kernel, plain version, in-place operand indices
        "store_accepts": (sk.store_accepts_cuda, sk.store_accepts_plain, (0, 1)),
        "accum_acks": (sk.accum_acks_cuda, sk.accum_acks_plain, (0,)),
    }
    for key, (kern, plain, in_place) in kernels.items():
        ms = needed = 0
        for n, ops in enumerate(snaps[key]):
            want = plain(*ops)
            got = kern(*[t.clone() if k in in_place else t for k, t in enumerate(ops)])
            torch.cuda.synchronize()
            if _max_abs_err(zip(got, want)):
                raise SystemExit(f"simkern.{key} disagrees with its plain version on main-path launch {n}")
            t = time_in_place(kern, ops, in_place, SNAP_REPS)
            b = sk.bytes_needed(key, *ops)
            ms += t
            needed += b
            shape = ""
            if key == "store_accepts":
                share, rows = _store_shape(ops)
                shape = f", live share {share:.4f}, {rows} batch rows read"
            print(f"main path simkern.{key} launch {n}: {t:.4f} ms, needs {b} bytes "
                  f"(bound {b / HBM_BYTES_PER_S * 1e3:.4f} ms){shape}")
            del want, got
        bound = needed / HBM_BYTES_PER_S * 1e3
        out[f"simkern.{key}"] = {"main_path_ms": ms, "main_path_bound_ms": bound}
        print(f"main path simkern.{key}: {len(snaps[key])} launches, {ms:.4f} ms in all, "
              f"needed bytes {needed} -> bound {bound:.4f} ms ({bound / ms:.1%} of bound)")
    return out


def run_cli(sk, goldens) -> None:
    """Phase 4: the CLI-sized run through the port's CLI entry point."""
    from tpu_paxos_torch import __main__ as cli
    from tpu_paxos_torch.replay.decision_log import sha256

    gold = goldens["cli_4_4_10"]
    f = gold["faults"]
    argv = [str(x) for x in gold["args"]] + [
        "--seed=0", f"--net-drop-rate={f['drop_rate']}",
        f"--net-dup-rate={f['dup_rate']}", f"--net-max-delay={f['max_delay']}",
        "--device=cuda",
    ]
    sk.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().splitlines(keepends=True)
    sha = sha256("".join(lines[:-1]))
    print(f"cli {' '.join(argv)}: rc={rc} launches={json.dumps(dict(sk.LAUNCHES), sort_keys=True)} "
          f"decision_log_sha256={sha}")
    print(f"cli verdict: {lines[-1].strip()}")
    if rc != 0 or sha != gold["decision_log_sha256"]:
        raise SystemExit("CLI-sized run disagrees with its JAX golden")


def _fw_state(fast, i: int, blocked: bool = False):
    """A headline-shape FastState on the card with stale acceptor
    contents (every cell is overwritten by the windows); ``blocked``
    makes 3 of 5 acceptors promise a ballot above the proposer's."""
    st = fast.init_state(i, A, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(i)
    for t in (st.acc_ballot, st.acc_vid, st.learned):
        t.random_(0, 1 << 20, generator=g)
    if blocked:
        st.promised[:3] = 10 << 16
    return st


def _fw_compare(fw, fast, i, iota, blocked=False, span=None, reps=WINDOWS):
    """Kernel (raw wrapper) vs plain version from one state: returns the
    max abs error over the five fields and the counts, the kernel's
    state and its scalars."""
    base = _fw_state(fast, i, blocked)
    vids = torch.arange(i, dtype=torch.int32, device=DEV)
    span = span or i
    copy = fast.FastState(*[t.clone() for t in base])
    want, want_cnt = fw.steady_state_windows_plain(copy, vids, reps, 3, span)
    got = base
    scal = fw.window_scalars(got, 3, span)
    cnt = fw.steady_state_windows_cuda(
        got.acc_ballot, got.acc_vid, got.learned, None if iota else vids, scal, reps)
    torch.cuda.synchronize()
    err = _max_abs_err(list(zip(got, want)) + [(cnt, want_cnt)])
    total = int(cnt.to(torch.int64).sum())
    del want, want_cnt
    return err, total, got, scal


def check_fastwin(fw, fast) -> dict:
    """Phase 5: the window kernel == its plain version, exactly, at the
    headline shape and at odd sizes; times at the headline shape."""
    rec = {"max_abs_err": 0}
    cases = [
        ("iota", I_FW, dict(iota=True)),
        ("explicit", I_FW, dict(iota=False)),
        ("span_gt_I", I_FW, dict(iota=False, span=4 * I_FW, reps=4)),
        ("no_quorum", I_FW, dict(iota=True, blocked=True)),
        ("odd_2p20+7", (1 << 20) + 7, dict(iota=False)),
        ("odd_2p20+7_iota", (1 << 20) + 7, dict(iota=True)),
        ("odd_80", 80, dict(iota=False)),
    ]
    for label, i, kw in cases:
        err, total, st, scal = _fw_compare(fw, fast, i, **kw)
        reps = kw.get("reps", WINDOWS)
        print(f"fastwin vs plain [{label}] A={A} I={i} reps={reps}: max_abs_err={err} "
              f"chosen_total={total} scal={scal.tolist()[:4]}")
        expect = 0 if kw.get("blocked") else reps * i
        if err or total != expect:
            raise SystemExit(f"fastwin kernel disagrees with its plain version [{label}]")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if i == I_FW and label in ("iota", "explicit"):
            vids = None if kw["iota"] else torch.arange(i, dtype=torch.int32, device=DEV)
            ms = _median_ms(lambda: fw.steady_state_windows_cuda(
                st.acc_ballot, st.acc_vid, st.learned, vids, scal, WINDOWS), FW_REPS)
            plain_vids = torch.arange(i, dtype=torch.int32, device=DEV)
            plain_ms = _median_ms(lambda: fw.steady_state_windows_plain(
                st, plain_vids, WINDOWS, 3), FW_REPS)
            # each window's launch writes the state once; vids are read
            # once per call (the roofline count), not once per window
            byts = WINDOWS * fw.bytes_per_launch(A, i, True) + (0 if kw["iota"] else 4 * i)
            rec[label] = {
                "ms": ms, "plain_ms": plain_ms, "bytes": byts,
                "bytes_ms": byts / HBM_BYTES_PER_S * 1e3,
                "ops_ms": WINDOWS * 4 * A * i / SCALAR_OPS_PER_S * 1e3,
            }
            print(f"fastwin [{label}] {WINDOWS} windows: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bytes {byts} -> bytes bound "
                  f"{rec[label]['bytes_ms']:.4f} ms ({byts / ms / 1e9:.3f} TB/s)")
            if ms < rec[label]["bytes_ms"]:
                raise SystemExit("fastwin kernel ran under its bytes bound: stores were dropped")
            del plain_vids, vids
        del st, scal
        torch.cuda.empty_cache()
    return rec


def run_fast_headline(fw, fast, card) -> int:
    """Phase 6: the fast path's main path, the headline window run,
    three times (the counts are zeroed before the first and read after
    it; the others show the spread)."""
    launches = 0
    for k in range(3):
        st = fast.init_state(I_FW, A, device=DEV)
        torch.cuda.synchronize()
        if k == 0:
            fw.reset_counts()
        t0 = time.perf_counter()
        st, counts = fw.steady_state_windows_fused(st, None, reps=WINDOWS, quorum=3, iota_vids=True)
        total = int(counts.cpu().to(torch.int64).sum())
        wall = time.perf_counter() - t0
        if k == 0:
            launches = fw.LAUNCHES["steady_state_windows"]
        last = torch.arange(I_FW, dtype=torch.int32, device=DEV) + (WINDOWS - 1) * I_FW
        rows_ok = all(torch.equal(st.learned[a], last) for a in range(A))
        print(f"fast headline {k + 1}/3 (steady_state_windows_fused, A={A}, I={I_FW}, "
              f"reps={WINDOWS}, iota): total={total} launches={launches} wall_s={wall:.4f} "
              f"instances_per_s={total / wall:.4e} last_window_rows_ok={rows_ok} | {card}")
        # 16 windows of 2**27 sequential vids fill the int32 vid space: 2**31
        if total != WINDOWS * I_FW or not rows_ok:
            raise SystemExit(f"fast headline run disagrees: total must be {WINDOWS * I_FW}")
        del st, last, counts
    if launches < 1:
        raise SystemExit("kernel fastwin.steady_state_windows was never launched on its path")
    torch.cuda.empty_cache()
    return launches


def run_fast_cli(goldens) -> None:
    """Phase 7: the fast CLI at 2**23 instances."""
    from tpu_paxos_torch import __main__ as cli

    gold = goldens["fast_cli_2p23"]
    argv = list(gold["args"]) + [f"--device={DEV}"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    print(f"fast cli {' '.join(argv)}: rc={rc} wall_s={wall:.3f} stdout={buf.getvalue().strip()}")
    if rc != 0 or buf.getvalue() != gold["stdout"]:
        raise SystemExit("fast CLI disagrees with its JAX golden")


def _rebuild_faults(cfgm, flt, d: dict):
    d = dict(d)
    if "schedule" in d:
        d["schedule"] = flt.FaultSchedule.from_dict(d["schedule"])
    if "edges" in d:
        d["edges"] = cfgm.EdgeFaultConfig.from_dict(d["edges"])
    return cfgm.FaultConfig(**d)


def _golden_cfg(bc: dict):
    """A golden's bench-shaped config, its faults (schedule and edge
    tables included) rebuilt from plain JSON."""
    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import faults as flt

    return cfgm.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
        proposers=tuple(bc["proposers"]), seed=bc["seed"],
        assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=_rebuild_faults(cfgm, flt, bc["faults"]),
    )


def run_scheduled(sk, goldens, key: str) -> dict:
    """Phase 8: one bench-size general-engine run under a stress mix."""
    import hashlib

    import numpy as np

    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.replay.decision_log import decision_log, sha256

    gold = goldens[key]
    bc = gold["config"]
    cfg = _golden_cfg(bc)
    torch.cuda.synchronize()
    sk.reset_counts()
    t0 = time.perf_counter()
    res = sim.run(cfg, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    sha = sha256(decision_log(res.chosen_vid, res.chosen_ballot, gold["stride"], cfg.n_instances))
    rsha = hashlib.sha256(np.asarray(res.chosen_round, "<i4").tobytes()).hexdigest()
    chosen = int((res.chosen_vid != -1).sum())
    print(f"{key} ({bc['mix']}, I={cfg.n_instances}): rounds={res.rounds} done={res.done} "
          f"chosen={chosen} wall_s={wall:.3f} launches={json.dumps(launches, sort_keys=True)} "
          f"decision_log_sha256={sha} chosen_round_sha256={rsha}")
    validate.check_all(res.learned, res.expected_vids)
    if (res.rounds, bool(res.done), chosen, sha, rsha) != (
        gold["rounds"], gold["done"], gold["chosen"], gold["decision_log_sha256"],
        gold["chosen_round_sha256"],
    ):
        raise SystemExit(f"{key} disagrees with its JAX golden")
    for name, n in launches.items():
        if n < 1:
            raise SystemExit(f"kernel simkern.{name} was never launched on {key}")
    return launches


@contextlib.contextmanager
def check_launches(sk, reps: int, stats: dict, lanes: int | None = None):
    """Every simkern launch in the block (of ``lanes`` lanes, when given)
    is first held against its plain version on a snapshot of its
    operands, timed on it (``reps`` launches from restored operands and a
    cold L2) and its needed bytes counted; then the real launch goes
    ahead.  ``stats[name]`` gathers the launches, their lane counts,
    times, needed bytes and the largest error."""
    plains = {
        "store_accepts": (sk.store_accepts_plain, (0, 1)),
        "accum_acks": (sk.accum_acks_plain, (0,)),
    }

    def checking(name, kern):
        plain, in_place = plains[name]

        def launch(*ops):
            if lanes is not None and int(ops[0].shape[0]) != lanes:
                return kern(*ops)
            snap = [t.clone() for t in ops]
            want = plain(*snap)
            got = kern(*[t.clone() if k in in_place else t for k, t in enumerate(snap)])
            torch.cuda.synchronize()
            st = stats.setdefault(name, {"launches": 0, "lanes": set(), "ms": [], "bytes": 0,
                                         "max_abs_err": 0})
            st["max_abs_err"] = max(st["max_abs_err"], _max_abs_err(zip(got, want)))
            st["ms"].append(time_in_place(kern, snap, in_place, reps))
            st["bytes"] += sk.bytes_needed(name, *snap)
            st["launches"] += 1
            st["lanes"].add(int(ops[0].shape[0]))
            del snap, want, got
            return kern(*ops)
        return launch

    with _wrapping(sk, checking):
        yield stats


def _summarize_checked(label: str, stats: dict) -> dict:
    out = {}
    for name, st in sorted(stats.items()):
        if st["max_abs_err"]:
            raise SystemExit(f"simkern.{name} disagrees with its plain version on {label}")
        ms = sorted(st["ms"])
        rec = {
            "launches": st["launches"], "lanes": sorted(st["lanes"]),
            "ms": sum(ms), "median_ms": ms[len(ms) // 2],
            "bound_ms": st["bytes"] / HBM_BYTES_PER_S * 1e3, "max_abs_err": st["max_abs_err"],
        }
        out[f"simkern.{name}"] = rec
        print(f"{label} simkern.{name}: {rec['launches']} launches of {rec['lanes']} lanes, "
              f"{rec['ms']:.4f} ms in all (median {rec['median_ms']:.4f} ms a launch), needed "
              f"bytes {st['bytes']} -> bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_ms'] / rec['ms']:.1%} of bound), max_abs_err={rec['max_abs_err']}")
    return out


@contextlib.contextmanager
def lane_counts(sk):
    """The lane count of every simkern launch in the block, by kernel."""
    seen = {"store_accepts": [], "accum_acks": []}

    def recording(name, kernel):
        lane_ndim = 3 if name == "store_accepts" else 4

        def launch(*ops):
            seen[name].append(int(ops[0].shape[0]) if ops[0].ndim == lane_ndim else 0)
            return kernel(*ops)
        return launch

    with _wrapping(sk, recording):
        yield seen


def count_syncs(fn) -> int:
    """Synchronizing CUDA calls made by ``fn()`` (each warns once in
    'warn' mode)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def _lane_sha(rep, i: int, stride: int) -> str:
    from tpu_paxos_torch.replay.decision_log import decision_log, sha256

    r = rep.lane_result(i)
    return sha256(decision_log(r.chosen_vid, r.chosen_ballot, stride, rep.cfg.n_instances))


def _same_result(a, b) -> bool:
    fields = ("learned", "chosen_vid", "chosen_round", "chosen_ballot", "crashed", "msgs")
    return (a.rounds, a.done) == (b.rounds, b.done) and all(
        (getattr(a, f) == getattr(b, f)).all() for f in fields
    )


def run_fleet(sk, goldens, card) -> dict:
    """Phase 9: the fleet runner at bench.py's fleet configuration."""
    import numpy as np

    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.fleet import search
    from tpu_paxos_torch.harness import stress

    gold = goldens["fleet"]
    c = gold["config"]
    wl, gates, _ = stress._workload(2, np.random.default_rng(0))
    cfg = cfgm.SimConfig(
        n_nodes=c["n_nodes"], n_instances=c["n_instances"], proposers=tuple(c["proposers"]),
        seed=c["seed"], max_rounds=c["max_rounds"], faults=cfgm.FaultConfig(**c["faults"]),
    )
    n = c["lanes"]
    rng = np.random.default_rng(1)
    scheds = [search.sample_schedule(rng, 5, 4, 96) for _ in range(FLEET_WIDE)]
    runner = frun.FleetRunner(cfg, wl, gates, device=DEV)

    def cycle(name, lanes):
        gc = gold[name]
        mixes = gc["knob_mixes"]
        knobs = [cfgm.FaultConfig(**mixes[i % len(mixes)]) for i in range(lanes)]
        return [gc["first_seed"] + i for i in range(lanes)], scheds[:lanes], knobs

    out = {}
    for name in ("headline", "delay"):
        gc = gold[name]
        seeds, sch, knobs = cycle(name, n)
        # the delay cycle runs its lanes that decide within DELAY_ROUNDS_MAX
        # rounds and those that park (a fixed subset, chosen by the golden)
        sub = list(range(n)) if name == "headline" else [
            i for i, r in enumerate(gc["rounds"])
            if r <= DELAY_ROUNDS_MAX or r > cfg.max_rounds]
        seeds, sch, knobs = ([x[i] for i in sub] for x in (seeds, sch, knobs))
        m = len(sub)
        torch.cuda.synchronize()
        sk.reset_counts()
        with lane_counts(sk) as shapes:
            rep = runner.run(seeds, sch, knobs=knobs)
        launches = dict(sk.LAUNCHES)
        v = rep.verdict
        bad = [f for f in v._fields
               if np.asarray(getattr(v, f)).tolist() != [gc[f][i] for i in sub]]
        shas = [_lane_sha(rep, k, gold["stride"]) for k in range(m)]
        off = [i for k, i in enumerate(sub) if shas[k] != gc["decision_log_sha256"][i]]
        lanes_ok = all(s == [m] * len(s) for s in shapes.values())
        print(f"fleet [{name}] {m} of {n} lanes (I={cfg.n_instances}): lanes_per_sec={rep.lanes_per_sec:.2f} "
              f"seconds={rep.seconds:.3f} rounds_max={int(v.rounds.max())} iterations={rep.iterations} "
              f"ms_per_round={rep.seconds / rep.iterations * 1e3:.3f} ok={int(v.ok.sum())}/{n} "
              f"launches={json.dumps(launches, sort_keys=True)} lanes_per_launch_ok={lanes_ok} "
              f"verdict_fields_off={bad} decision_log_off={off} | {card}")
        if bad or off or not v.ok.all():
            raise SystemExit(f"fleet [{name}] disagrees with its JAX golden")
        if min(launches.values()) < 1 or not lanes_ok:
            raise SystemExit(f"fleet [{name}]: a simkern kernel did not launch on {m}-lane operands")
        out[name] = {"launches": launches, "iterations": rep.iterations, "seconds": rep.seconds,
                     "lanes_per_sec": rep.lanes_per_sec}

    seeds, sch, knobs = cycle("headline", n)
    it = {}
    syncs = count_syncs(lambda: it.setdefault("rep", runner.run(seeds, sch, knobs=knobs)))
    out["headline"]["syncs_per_round"] = syncs / it["rep"].iterations
    print(f"fleet [headline] host syncs: {syncs} in {it['rep'].iterations} rounds "
          f"({out['headline']['syncs_per_round']:.2f} a round)")

    stats = {}
    with check_launches(sk, SNAP_REPS, stats):
        rep = runner.run(seeds, sch, knobs=knobs)
    if [_lane_sha(rep, i, gold["stride"]) for i in range(n)] != gold["headline"]["decision_log_sha256"]:
        raise SystemExit("fleet [headline] rerun disagrees with its JAX golden")
    out["checked"] = _summarize_checked(f"fleet [headline] {n}-lane operands", stats)

    seeds, sch, knobs = cycle("headline", FLEET_WIDE)
    torch.cuda.synchronize()
    it = {}
    # the syncs are counted in the timed run itself: the warnings cost
    # about 10 us each, under 0.5% of its wall
    syncs = count_syncs(lambda: it.setdefault("rep", runner.run(seeds, sch, knobs=knobs)))
    rep = it.pop("rep")
    v = rep.verdict
    print(f"fleet [headline] {FLEET_WIDE} lanes: lanes_per_sec={rep.lanes_per_sec:.2f} "
          f"seconds={rep.seconds:.3f} rounds_max={int(v.rounds.max())} iterations={rep.iterations} "
          f"ms_per_round={rep.seconds / rep.iterations * 1e3:.3f} "
          f"syncs_per_round={syncs / rep.iterations:.2f} ok={int(v.ok.sum())}/{FLEET_WIDE} | {card}")
    done = rep.final.done.cpu().numpy()
    cand = [i for i in range(FLEET_WIDE) if done[i] and v.rounds[i] <= 400]
    picks = [cand[k * len(cand) // FLEET_SINGLES] for k in range(FLEET_SINGLES)]
    for i in picks:
        single = sim.run(rep.lane_cfg(i), wl, gates, device=DEV)
        same = _same_result(rep.lane_result(i), single)
        print(f"fleet lane {i} of {FLEET_WIDE} vs single sim.run(lane_cfg({i})): rounds={single.rounds} "
              f"equal={same}")
        if not same:
            raise SystemExit(f"fleet lane {i} disagrees with its single run")
    out["wide"] = {"lanes": FLEET_WIDE, "iterations": rep.iterations, "seconds": rep.seconds,
                   "lanes_per_sec": rep.lanes_per_sec, "syncs_per_round": syncs / rep.iterations}
    del rep
    torch.cuda.empty_cache()
    return out


def run_runtime_full(sk, goldens) -> dict:
    """Phase 10: the runtime-schedule, runtime-knob build at bench_sim's
    width, two lanes per mix."""
    import dataclasses
    import hashlib

    import numpy as np

    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import faults as flt
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.fleet import envelope
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.replay.decision_log import decision_log, sha256

    stats = {}
    for key in ("bench_sim_partition_flap", "bench_sim_wan3"):
        gold = goldens[key]
        bc = gold["config"]
        fc = _rebuild_faults(cfgm, flt, bc["faults"])
        knob = dataclasses.replace(fc, schedule=None)
        cfg = cfgm.SimConfig(
            n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
            proposers=tuple(bc["proposers"]), seed=bc["seed"],
            assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
            faults=cfgm.FaultConfig(max_delay=max(fc.max_delay, envelope.MAX_DELAY_BOUND)),
        )
        runner = frun.FleetRunner(cfg, sim.default_workload(cfg), device=DEV)
        seeds = [bc["seed"], bc["seed"] + 1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with check_launches(sk, FULL_REPS, stats):
            rep = runner.run(seeds, [fc.schedule] * 2, knobs=[knob] * 2)
        wall = time.perf_counter() - t0
        r0 = rep.lane_result(0)
        sha = sha256(decision_log(r0.chosen_vid, r0.chosen_ballot, gold["stride"], cfg.n_instances))
        rsha = hashlib.sha256(np.asarray(r0.chosen_round, "<i4").tobytes()).hexdigest()
        chosen = int((r0.chosen_vid != -1).sum())
        validate.check_all(r0.learned, r0.expected_vids)
        print(f"{key} runtime lanes (I={cfg.n_instances}, ring bound {cfg.faults.max_delay}): "
              f"lane 0 rounds={r0.rounds} done={r0.done} chosen={chosen} decision_log_sha256={sha} "
              f"chosen_round_sha256={rsha}; verdict ok={rep.verdict.ok.tolist()} "
              f"rounds={rep.verdict.rounds.tolist()} wall_s={wall:.3f} (kernel checks included)")
        if (r0.rounds, bool(r0.done), chosen, sha, rsha) != (
            gold["rounds"], gold["done"], gold["chosen"], gold["decision_log_sha256"],
            gold["chosen_round_sha256"],
        ):
            raise SystemExit(f"{key} runtime lane 0 disagrees with the constant-path golden")
        r1, lane_cfg = rep.lane_result(1), rep.lane_cfg(1)
        del rep
        single = sim.run(lane_cfg, device=DEV)
        same = _same_result(r1, single)
        print(f"{key} runtime lane 1 (seed {seeds[1]}) vs single sim.run: rounds={single.rounds} "
              f"equal={same}")
        if not same:
            raise SystemExit(f"{key} runtime lane 1 disagrees with its single run")
        del single, r1
        torch.cuda.empty_cache()
    return _summarize_checked("runtime lanes at full width (2 mixes)", stats)


def _port_env(here: str, extra: dict | None = None) -> dict:
    env = dict(os.environ, **(extra or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _file_sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@contextlib.contextmanager
def _armed(env: dict):
    """``env`` set within the block, the envelope cache cleared on the
    way in and out (the seeded-wedge flag is part of its key)."""
    from tpu_paxos_torch.fleet import envelope

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    envelope.clear_cache()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        envelope.clear_cache()


@contextlib.contextmanager
def dispatch_log():
    """(lanes, round calls, seconds) of every fleet dispatch in the block."""
    from tpu_paxos_torch.fleet import runner as frun

    seen = []
    real = frun.FleetRunner.run

    def run(self, *a, **kw):
        rep = real(self, *a, **kw)
        seen.append((rep.n_lanes, rep.iterations, rep.seconds))
        return rep

    frun.FleetRunner.run = run
    try:
        yield seen
    finally:
        frun.FleetRunner.run = real


class _Moves:
    """A logger keeping the shrinker's accepted moves."""

    def __init__(self):
        self.moves = []

    def info(self, fmt, *args):
        self.moves.append(fmt % args)


def _repro_cli(here: str, path: str, env: dict):
    """``python -m tpu_paxos_torch repro <basename> --json`` in the
    artifact's directory, as the JAX golden's replay was run."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_paxos_torch", "repro", os.path.basename(path), "--json",
         "--device", DEV],
        cwd=os.path.dirname(path), env=_port_env(here, env), capture_output=True,
        text=True, timeout=600,
    )
    return proc, time.perf_counter() - t0


def run_stress_quick(goldens, here: str, card: str) -> dict:
    """Phase 11a: ``make stress-quick``'s sweep on the card, as a
    subprocess, at the golden's seed count."""
    gold = goldens["stress_quick"]["summary"]
    seeds = gold["seeds_per_mix"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_paxos_torch.harness.stress", "--seeds",
             str(seeds), "--triage-dir", tmp, "--device", DEV],
            cwd=here, env=_port_env(here), capture_output=True, text=True, timeout=900,
        )
        wall = time.perf_counter() - t0
        left = sorted(os.listdir(tmp))
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    less = {k: v for k, v in summary.items() if k != "seconds"}
    print(f"stress-quick (python -m tpu_paxos_torch.harness.stress --seeds {seeds}): "
          f"rc={proc.returncode} wall_s={wall:.3f} sweep_seconds={summary.get('seconds')} "
          f"summary={json.dumps(less, sort_keys=True)} artifacts={left} | {card}")
    if proc.returncode != 0 or less != gold:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit("stress-quick disagrees with its JAX golden")
    return {"wall_s": wall, "sweep_s": summary.get("seconds")}


def _case_from_spec(shr, spec):
    import numpy as np

    return shr.ReproCase(
        cfg=shr._cfg_from_dict(spec["cfg"]),
        workload=[np.asarray(w, np.int32) for w in spec["workload"]],
        gates=None if spec["gates"] is None else [np.asarray(g, np.int32) for g in spec["gates"]],
        chains=[np.asarray(c, np.int32) for c in spec["chains"]],
        extra_checks=dict(spec["extra_checks"]),
    )


def _shrink_on_card(sk, shr, case, max_evals: int, batch: bool):
    """One timed ``shrink_case`` on the card, with the counts zeroed just
    before and read just after, every launch's lane count and every fleet
    dispatch recorded."""
    moves, stats = _Moves(), {}
    torch.cuda.synchronize()
    sk.reset_counts()
    with lane_counts(sk) as shapes, dispatch_log() as disp:
        t0 = time.perf_counter()
        small, viol = shr.shrink_case(case, max_evals=max_evals, logger=moves, batch=batch,
                                      stats=stats, device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {
        "small": small, "violation": viol, "moves": moves.moves, "evals": stats["evals"],
        "wall_s": wall, "dispatches": disp, "lanes": {k: sorted(set(v)) for k, v in shapes.items()},
        "launches": dict(sk.LAUNCHES),
    }


def _hold_shrink(shr, got: dict, gold: dict, label: str) -> None:
    want = (gold["final_cfg"], gold["violation"], gold["moves"], gold["evals"])
    if (shr._cfg_to_dict(got["small"].cfg), got["violation"], got["moves"], got["evals"]) != want:
        raise SystemExit(f"{label}: the shrink disagrees with its JAX golden "
                         f"({got['violation']!r}, {got['moves']}, {got['evals']} evals)")


def _print_shrink(label: str, got: dict, card: str) -> None:
    disp = got["dispatches"]
    rounds = sum(d[1] for d in disp)
    secs = sum(d[2] for d in disp)
    by_lanes = {}
    for n, _, _ in disp:
        by_lanes[n] = by_lanes.get(n, 0) + 1
    print(f"{label} shrink on the card: wall_s={got['wall_s']:.3f} evals={got['evals']} "
          f"dispatches={json.dumps(by_lanes, sort_keys=True)} (lanes: count) round_calls={rounds} "
          f"dispatch_s={secs:.3f} ms_per_round={secs / max(rounds, 1) * 1e3:.3f} "
          f"launches={json.dumps(got['launches'], sort_keys=True)} "
          f"launch_lanes={json.dumps(got['lanes'], sort_keys=True)} moves={got['moves']} "
          f"violation={got['violation']!r} | {card}")


def _replay(here: str, shr, got: dict, gold: dict, tmp: str, env: dict, label: str,
            keep: bool = False) -> dict:
    """Phases 11b-c: save the shrunk case, compare the file with JAX's and
    replay it through the CLI; ``keep`` leaves the file for phase 12."""
    path = os.path.join(tmp, gold["artifact"])
    t0 = time.perf_counter()
    art = shr.save_artifact(path, got["small"], got["violation"], device=DEV)
    save_s = time.perf_counter() - t0
    sha = _file_sha256(path)
    proc, cli_s = _repro_cli(here, path, env)
    out_sha = hashlib.sha256(proc.stdout.encode()).hexdigest()
    verdict = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.stdout.strip() else {}
    print(f"{label} artifact {gold['artifact']}: save_s={save_s:.3f} file_sha256={sha} "
          f"decision_log_sha256={art['decision_log_sha256']} rounds={art['rounds']}; "
          f"repro rc={proc.returncode} match={verdict.get('match')} cli_s={cli_s:.3f} "
          f"stdout_sha256={out_sha}")
    if (sha, art["decision_log_sha256"], art["rounds"]) != (
        gold["artifact_sha256"], gold["decision_log_sha256"], gold["rounds"]
    ):
        raise SystemExit(f"{label}: the artifact differs from JAX's")
    if proc.returncode != 0 or not verdict.get("match") or out_sha != gold["repro_stdout_sha256"]:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"{label}: the CLI replay disagrees with JAX's")
    if not keep:
        os.remove(path)
    return {"save_s": save_s, "cli_s": cli_s, "path": path}


def run_triage_wedge(sk, goldens, here: str, card: str) -> dict:
    """Phase 11b: the sweep under the seeded wedge, then both small cases
    found, shrunk with 8-lane dispatches, saved and replayed."""
    from tpu_paxos_torch.harness import shrink as shr
    from tpu_paxos_torch.harness import stress

    gold = goldens["triage_wedge"]
    sw = gold["sweep"]
    mix = [m for m in stress.MIXES if m[0] == sw["mix"]]
    with _armed({"TPU_PAXOS_SEEDED_WEDGE": sw["wedge"]}), tempfile.TemporaryDirectory() as tmp:
        s = stress.sweep(n_seeds=sw["n_seeds"], mixes=mix, verbose=False, triage_dir=tmp,
                         device=DEV)
    less = {k: v for k, v in s.items() if k != "seconds"}
    print(f"triage sweep ({sw['mix']} x {sw['n_seeds']} seeds, TPU_PAXOS_SEEDED_WEDGE="
          f"{sw['wedge']}): seconds={s['seconds']} summary={json.dumps(less, sort_keys=True)}")
    if less != sw["summary"]:
        raise SystemExit("the seeded-wedge sweep disagrees with its JAX golden")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, spec in sorted(gold["cases"].items()):
            label = f"triage [{name}]"
            case = _case_from_spec(shr, spec)
            with _armed(spec["env"]):
                got = _shrink_on_card(sk, shr, case, spec["max_evals"], True)
                _print_shrink(label, got, card)
                _hold_shrink(shr, got, spec, label)
                if min(got["launches"].values()) < 1 or any(
                    shr.SHRINK_BATCH_LANES not in v for v in got["lanes"].values()
                ):
                    raise SystemExit(f"{label}: a simkern kernel did not launch on "
                                     f"{shr.SHRINK_BATCH_LANES}-lane operands")
                out[name] = dict(_replay(here, shr, got, spec, tmp, spec["env"], label),
                                 wall_s=got["wall_s"], launches=got["launches"],
                                 dispatches=got["dispatches"], evals=got["evals"])
                if name != "culprit":
                    continue
                stats = {}
                with check_launches(sk, TRIAGE_REPS, stats, lanes=shr.SHRINK_BATCH_LANES):
                    again = shr.shrink_case(case, max_evals=spec["max_evals"], device=DEV)
                if shr._cfg_to_dict(again[0].cfg) != spec["final_cfg"]:
                    raise SystemExit(f"{label}: the checked shrink disagrees with its golden")
                out["checked"] = _summarize_checked(
                    f"{label} {shr.SHRINK_BATCH_LANES}-lane shrink operands", stats)
    return out


def run_triage_full(sk, goldens, here: str, card: str, keep_dir: str) -> dict:
    """Phase 11c: the shrink, artifact and replay at bench_sim's width;
    the artifact stays in ``keep_dir`` for phase 12's trace."""
    import numpy as np

    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.harness import shrink as shr

    gold = goldens["triage_full"]
    cfg = _golden_cfg(gold["config"])
    wl = sim.default_workload(cfg)
    case = shr.ReproCase(cfg=cfg, workload=wl, gates=None,
                         chains=[np.zeros(0, np.int32)] * len(wl),
                         extra_checks=dict(gold["extra_checks"]))
    label = f"triage [full, I={cfg.n_instances}]"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _armed({}):
        got = _shrink_on_card(sk, shr, case, gold["max_evals"], gold["batch"])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        _print_shrink(label, got, card)
        print(f"{label} peak device memory {peak_gb:.2f} GB (one-lane runtime runs)")
        _hold_shrink(shr, got, gold, label)
        if min(got["launches"].values()) < 1:
            raise SystemExit(f"{label}: a simkern kernel was never launched")
        rec = _replay(here, shr, got, gold, keep_dir, {}, label, keep=True)
    torch.cuda.empty_cache()
    return dict(rec, wall_s=got["wall_s"], launches=got["launches"], peak_gb=peak_gb)


def _dict_diff(got: dict, want: dict) -> str:
    """The keys where two summary dicts differ, with both values."""
    keys = sorted(set(got) | set(want))
    return "; ".join(f"{k}: port {got.get(k)!r} JAX {want.get(k)!r}"
                     for k in keys if got.get(k) != want.get(k))[:4000]


def _telemetry_sha(d: dict) -> str:
    return hashlib.sha256(json.dumps(d, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def _same_syncs(turns, what: str) -> None:
    """The fewest syncs a round of the armed turns must equal the plain
    turns': a first use of the pinned-memory pool in a turn can add one
    sync to its count, which is no host read of a round."""
    least = {armed: min(r["syncs_per_round"] for r in turns if r["armed"] == armed)
             for armed in (False, True)}
    if least[True] != least[False]:
        raise SystemExit(f"{what} makes other host syncs a round than the plain one: {least}")


def _loop_run(cfg, armed: bool, window_rounds: int) -> dict:
    """One full-width run's round loop alone, plain or armed: wall
    seconds, round calls and host syncs (set-up and results excluded)."""
    import numpy as np

    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.telemetry import recorder as telem

    wl = sim.default_workload(cfg)
    pend, gate, tail, c = sim.prepare_queues(cfg, wl)
    root = sim.prng.root_key(cfg.seed)
    state = sim.lanes_view(sim.init_state(cfg, pend, gate, tail, root, device=DEV))
    rf = sim.build_engine(cfg, c, device=DEV, telemetry=armed,
                          window_rounds=window_rounds if armed else 0)
    kw = {}
    if armed:
        kw["tele"] = (
            telem.init_telemetry(cfg.n_instances, len(cfg.proposers), cfg.n_nodes, device=DEV),
            telem.init_windows(cfg.n_nodes, device=DEV),
        )
    roots = np.asarray([root], np.uint64)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    syncs = count_syncs(lambda: out.setdefault(
        "r", sim.run_lanes(rf, roots, state, [cfg.round_budget], **kw)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = out.pop("r")[-1]
    return {"wall_s": wall, "calls": calls, "syncs": syncs, "ms_per_round": wall / calls * 1e3,
            "syncs_per_round": syncs / calls}


def run_telemetry_single(sk, goldens, card: str) -> dict:
    """Phases 12a-b: the armed engine at full width."""
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.replay.decision_log import decision_log, sha256
    from tpu_paxos_torch.telemetry import recorder as telem

    tg = goldens["telemetry"]
    ww = tg["window_rounds"]
    out = {"launches": {}}
    # bench_sim runs twice: counted, then with every launch held against
    # its plain version (whose comparison launches must not count)
    jobs = [(key, False) for key in sorted(tg["runs"])] + [("bench_sim", True)]
    for key, checked in jobs:
        run = tg["runs"][key]
        gold = goldens[key]
        cfg = _golden_cfg(gold["config"])
        stats = {}
        check = check_launches(sk, FULL_REPS, stats) if checked else contextlib.nullcontext()
        torch.cuda.synchronize()
        sk.reset_counts()
        t0 = time.perf_counter()
        with check:
            res, summ, wsum = sim.run_with_telemetry(
                cfg, window_rounds=ww, region_map=run["region_map"], device=DEV)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(sk.LAUNCHES)
        d = telem.summary_to_dict(summ, wsum, ww, tuple(run["region_names"]))
        sha = sha256(decision_log(res.chosen_vid, res.chosen_ballot, gold["stride"], cfg.n_instances))
        same = d == run["summary"]
        what = "kernel checks included" if checked else \
            f"launches={json.dumps(launches, sort_keys=True)}"
        print(f"armed {key} (run_with_telemetry, I={cfg.n_instances}, window_rounds {ww}): "
              f"rounds={res.rounds} wall_s={wall:.3f} {what} decision_log_sha256={sha} "
              f"summary_equal={same} decided={d['decided']} offered_total={d['offered_total']} "
              f"latency_p99={d['latency_p99']} region_pairs={d['region_pairs']['n_regions']} | {card}")
        if sha != gold["decision_log_sha256"] or sha != run["decision_log_sha256"]:
            raise SystemExit(f"armed {key}: the decision log differs from the plain golden")
        if not same:
            raise SystemExit(f"armed {key}: the summary differs from JAX's: "
                             f"{_dict_diff(d, run['summary'])}")
        if checked:
            out["checked"] = _summarize_checked(f"armed {key} operands", stats)
        elif min(launches.values()) < 1:
            raise SystemExit(f"armed {key}: a simkern kernel was never launched")
        else:
            out["launches"][key] = launches
        del res, summ, wsum
        torch.cuda.empty_cache()
    cfg = _golden_cfg(goldens["bench_sim"]["config"])
    turns = []
    for armed in (False, True, True, False):
        r = dict(_loop_run(cfg, armed, ww), armed=armed)
        turns.append(r)
        print(f"bench_sim round loop {'armed' if armed else 'plain'}: {r['calls']} round calls, "
              f"wall_s={r['wall_s']:.3f} ms_per_round={r['ms_per_round']:.3f} "
              f"syncs={r['syncs']} syncs_per_round={r['syncs_per_round']:.2f} | {card}")
        torch.cuda.empty_cache()
    _same_syncs(turns, "the armed round")
    out["loop"] = turns
    return out


def run_telemetry_fleet(sk, goldens, card: str) -> dict:
    """Phase 12c: the fleet's headline cycle, plain and armed in turns."""
    import numpy as np

    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import wan
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.fleet import search
    from tpu_paxos_torch.harness import stress

    gold = goldens["fleet"]
    tg = goldens["telemetry"]["fleet"]
    c = gold["config"]
    n = c["lanes"]
    wl, gates, _ = stress._workload(2, np.random.default_rng(0))
    cfg = cfgm.SimConfig(
        n_nodes=c["n_nodes"], n_instances=c["n_instances"], proposers=tuple(c["proposers"]),
        seed=c["seed"], max_rounds=c["max_rounds"], faults=cfgm.FaultConfig(**c["faults"]),
    )
    rng = np.random.default_rng(1)
    scheds = [search.sample_schedule(rng, 5, 4, 96) for _ in range(n)]
    gc = gold[tg["cycle"]]
    mixes = gc["knob_mixes"]
    knobs = [cfgm.FaultConfig(**mixes[i % len(mixes)]) for i in range(n)]
    seeds = [gc["first_seed"] + i for i in range(n)]
    maps = [wan.node_regions(wan.WAN3, 5).tolist(), wan.node_regions(wan.WAN5, 5).tolist(), None]
    regions = [maps[i % len(maps)] for i in range(n)]
    runners = {False: frun.FleetRunner(cfg, wl, gates, device=DEV),
               True: frun.FleetRunner(cfg, wl, gates, device=DEV, telemetry=True)}
    turns = []
    for armed in (False, True, True, False):
        kw = {"regions": regions} if armed else {}
        it = {}
        torch.cuda.synchronize()
        sk.reset_counts()
        with lane_counts(sk) as shapes:
            syncs = count_syncs(lambda: it.setdefault(
                "rep", runners[armed].run(seeds, scheds, knobs=knobs, **kw)))
        rep = it.pop("rep")
        launches = dict(sk.LAUNCHES)
        r = {"armed": armed, "lanes_per_sec": rep.lanes_per_sec, "seconds": rep.seconds,
             "iterations": rep.iterations, "ms_per_round": rep.seconds / rep.iterations * 1e3,
             "syncs_per_round": syncs / rep.iterations, "launches": launches}
        shas = [_lane_sha(rep, i, gold["stride"]) for i in range(n)]
        off = [i for i in range(n) if shas[i] != gc["decision_log_sha256"][i]]
        tele_off = []
        if armed:
            tele_off = [i for i in range(n)
                        if _telemetry_sha(rep.lane_telemetry(i)) != tg["lane_telemetry_sha256"][i]]
            for key, want in tg["lane_telemetry"].items():
                if rep.lane_telemetry(int(key)) != want:
                    print(f"armed fleet lane {key}: {_dict_diff(rep.lane_telemetry(int(key)), want)}",
                          file=sys.stderr)
        lanes_ok = all(x == [n] * len(x) for x in shapes.values())
        print(f"fleet [{tg['cycle']}] {n} lanes {'armed' if armed else 'plain'}: "
              f"lanes_per_sec={r['lanes_per_sec']:.2f} seconds={r['seconds']:.3f} "
              f"iterations={r['iterations']} ms_per_round={r['ms_per_round']:.3f} "
              f"syncs_per_round={r['syncs_per_round']:.2f} launches={json.dumps(launches, sort_keys=True)} "
              f"lanes_per_launch_ok={lanes_ok} decision_log_off={off} lane_telemetry_off={tele_off} "
              f"| {card}")
        if off or tele_off or not rep.verdict.ok.all():
            raise SystemExit(f"fleet [{tg['cycle']}] {'armed' if armed else 'plain'} disagrees "
                             "with its JAX goldens")
        if min(launches.values()) < 1 or not lanes_ok:
            raise SystemExit(f"fleet: a simkern kernel did not launch on {n}-lane operands")
        turns.append(r)
        del rep
    _same_syncs(turns, "the armed fleet")
    return {"turns": turns, "launches": turns[1]["launches"]}


def run_trace_cli(goldens, here: str, full_path: str, card: str) -> dict:
    """Phase 12d: ``python -m tpu_paxos_torch trace`` on three artifacts,
    the three processes at once."""
    tg = goldens["telemetry"]["trace"]
    data = os.path.join(here, "tpu_paxos_torch", "data")
    paths = {name: os.path.join(data, name) for name in ("repro_culprit.json", "repro_takeover.json")}
    paths[goldens["triage_full"]["artifact"]] = full_path
    before = {name: _file_sha256(path) for name, path in paths.items()}
    t0 = time.perf_counter()
    procs = {
        name: subprocess.Popen(
            [sys.executable, "-m", "tpu_paxos_torch", "trace", os.path.basename(path), "--stdout",
             "--device", DEV],
            cwd=os.path.dirname(path), env=_port_env(here, tg[name]["env"]),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for name, path in sorted(paths.items())
    }
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        wall = time.perf_counter() - t0
        g = tg[name]
        sha = hashlib.sha256(stdout.encode()).hexdigest()
        after = _file_sha256(paths[name])
        print(f"trace {name} (python -m tpu_paxos_torch trace --stdout): rc={proc.returncode} "
              f"done_after_s={wall:.3f} stdout_bytes={len(stdout.encode())} stdout_sha256={sha} "
              f"artifact_unchanged={before[name] == after} | {card}")
        if proc.returncode != 0 or sha != g["stdout_sha256"] or before[name] != after \
                or after != g["artifact_sha256"]:
            print(stderr[-3000:], file=sys.stderr)
            for p in procs.values():
                p.kill()
            raise SystemExit(f"trace {name} disagrees with JAX's")
        out[name] = wall
    return out

SEARCH_TIMING = ("seconds", "lanes_per_sec")
STRESS_TIMING = ("seconds", "lanes_per_sec", "compiles_per_mix")
ENVELOPE_REPS = 3  # launches timed on each snapshot of the checked padded dispatch


def _less_timing(summary: dict, keys) -> dict:
    """A search or sweep summary less its wall-clock keys, each wedge's or
    failure's ``shrink_seconds`` dropped and artifact paths cut to their
    basename, as the goldens hold them."""
    out = {k: v for k, v in summary.items() if k not in keys}
    for key in ("wedges", "failures"):
        if key in out:
            out[key] = [{k: (os.path.basename(v) if k == "artifact" else v)
                         for k, v in item.items() if k != "shrink_seconds"} for item in out[key]]
    return out


def start_fleet_quick(goldens, here: str, tmp: str):
    """Phase 13a's search, started as a subprocess writing into ``tmp``;
    returns the process and its start time."""
    gold = goldens["search"]["fleet_quick"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_paxos_torch", "fleet", *gold["args"], "--triage-dir", tmp,
         "--quiet", "--device", DEV],
        cwd=here, env=_port_env(here), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, time.perf_counter()


def run_fleet_quick(goldens, here: str, card: str, started, tmp: str) -> dict:
    """Phase 13a: ``make fleet-quick``'s search (``started`` by
    :func:`start_fleet_quick`), its wedge artifact and its CLI replay."""
    gold = goldens["search"]["fleet_quick"]
    proc, t0 = started
    stdout, stderr = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not stdout.strip():
        print(stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"fleet-quick exited {proc.returncode}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    path = os.path.join(tmp, gold["artifact"])
    sha = _file_sha256(path)
    rproc, cli_s = _repro_cli(here, path, {})
    out_sha = hashlib.sha256(rproc.stdout.encode()).hexdigest()
    less = _less_timing(summary, SEARCH_TIMING)
    w = summary["wedges"][0] if summary["wedges"] else {}
    print(f"fleet-quick (python -m tpu_paxos_torch fleet {' '.join(gold['args'])}): "
          f"rc={proc.returncode} done_after_s={wall:.3f} search_seconds={summary['seconds']} "
          f"lanes_per_sec={summary['lanes_per_sec']} shrink_seconds={w.get('shrink_seconds')} "
          f"wedges={summary['wedges_found']} summary_equal={less == gold['summary']} "
          f"artifact_sha256={sha}; repro rc={rproc.returncode} cli_s={cli_s:.3f} "
          f"stdout_sha256={out_sha} | {card}")
    if less != gold["summary"]:
        raise SystemExit(f"fleet-quick disagrees with its JAX golden: "
                         f"{_dict_diff(less, gold['summary'])}")
    if sha != gold["artifact_sha256"]:
        raise SystemExit("fleet-quick's wedge artifact differs from JAX's")
    if rproc.returncode != 0 or out_sha != gold["repro_stdout_sha256"]:
        print(rproc.stderr[-3000:], file=sys.stderr)
        raise SystemExit("fleet-quick's artifact replay disagrees with JAX's")
    return {"done_after_s": wall, "seconds": summary["seconds"],
            "lanes_per_sec": summary["lanes_per_sec"], "shrink_seconds": w.get("shrink_seconds")}


def run_search_wide(sk, goldens, card: str) -> dict:
    """Phase 13b: the gray/WAN search at the card's default lane count,
    through the CLI's entry point in this process."""
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.fleet import search

    gold = goldens["search"]["search_wide"]
    n = frun.default_lane_count(DEV)
    if n != gold["lanes"]:
        raise SystemExit(f"the card's default lane count is {n}, the golden's {gold['lanes']}")
    buf = io.StringIO()
    torch.cuda.synchronize()
    sk.reset_counts()
    with lane_counts(sk) as shapes, dispatch_log() as disp, contextlib.redirect_stdout(buf):
        syncs = count_syncs(lambda: search.main([*gold["args"], "--quiet", "--device", DEV]))
    launches = dict(sk.LAUNCHES)
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    rounds = sum(d[1] for d in disp)
    secs = sum(d[2] for d in disp)
    less = _less_timing(summary, SEARCH_TIMING)
    lanes_ok = all(x == [n] * len(x) for x in shapes.values())
    print(f"search --lanes {n} {' '.join(gold['args'])}: lanes_per_sec={summary['lanes_per_sec']} "
          f"seconds={summary['seconds']} dispatches={len(disp)} round_calls={rounds} "
          f"dispatch_s={secs:.3f} ms_per_round={secs / max(rounds, 1) * 1e3:.3f} "
          f"syncs_per_round={syncs / max(rounds, 1):.2f} "
          f"launches={json.dumps(launches, sort_keys=True)} lanes_per_launch_ok={lanes_ok} "
          f"summary_equal={less == gold['summary']} | {card}")
    if less != gold["summary"]:
        raise SystemExit(f"the wide search disagrees with its JAX golden: "
                         f"{_dict_diff(less, gold['summary'])}")
    if min(launches.values()) < 1 or not lanes_ok:
        raise SystemExit(f"the wide search: a simkern kernel did not launch on {n}-lane operands")
    return {"launches": launches, "lanes_per_sec": summary["lanes_per_sec"],
            "ms_per_round": secs / max(rounds, 1) * 1e3, "syncs_per_round": syncs / max(rounds, 1),
            "round_calls": rounds}


def run_stress_fleet(goldens, here: str, card: str) -> dict:
    """Phase 13c: ``stress --fleet --seeds 8`` as a subprocess."""
    gold = goldens["stress_fleet"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_paxos_torch.harness.stress", "--fleet", "--seeds",
             str(gold["seeds"]), "--triage-dir", tmp, "--device", DEV],
            cwd=here, env=_port_env(here), capture_output=True, text=True, timeout=900,
        )
        wall = time.perf_counter() - t0
        left = sorted(os.listdir(tmp))
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) < 2:
        print(proc.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"stress --fleet exited {proc.returncode}")
    host, fleet = (json.loads(x) for x in lines[-2:])
    mixes = [ln[ln.index("fleet mix"):] for ln in proc.stderr.splitlines() if "fleet mix" in ln]
    hl, fl = _less_timing(host, STRESS_TIMING), _less_timing(fleet, STRESS_TIMING)
    print(f"stress --fleet --seeds {gold['seeds']}: rc={proc.returncode} wall_s={wall:.3f} "
          f"host_seconds={host['seconds']} fleet_seconds={fleet['seconds']} "
          f"fleet_lanes_per_sec={fleet['lanes_per_sec']} "
          f"runners_built={json.dumps(fleet['compiles_per_mix'], sort_keys=True)} "
          f"host_equal={hl == gold['host']} fleet_equal={fl == gold['fleet']} artifacts={left} "
          f"| {card}")
    for ln in mixes:
        print(f"stress --fleet {ln}")
    if hl != gold["host"]:
        raise SystemExit(f"stress --fleet's host sweep disagrees with JAX's: "
                         f"{_dict_diff(hl, gold['host'])}")
    if fl != gold["fleet"]:
        for mix, want in gold["fleet"]["telemetry"].items():
            got = fl["telemetry"].get(mix, {})
            if got != want:
                print(f"stress --fleet telemetry [{mix}]: {_dict_diff(got, want)}", file=sys.stderr)
        raise SystemExit(f"stress --fleet's fleet sweep disagrees with JAX's: "
                         f"{_dict_diff(fl, gold['fleet'])}")
    return {"wall_s": wall, "host_seconds": host["seconds"], "fleet_seconds": fleet["seconds"],
            "lanes_per_sec": fleet["lanes_per_sec"]}


def run_envelope(sk, goldens, card: str) -> dict:
    """Phase 13d: the geometry-padded envelope at bench.py's configuration."""
    import numpy as np

    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import geom
    from tpu_paxos_torch.fleet import envelope

    gold = goldens["envelope"]
    e = gold["config"]
    genv = geom.GeometryEnvelope(tuple((n, tuple(p)) for n, p in e["menu"]))
    tmpl = [np.arange(lo, hi, dtype=np.int32) for lo, hi in e["template"]]
    lanes = e["lanes"]
    seeds = [e["first_seed"] + i for i in range(lanes)]
    bound = (genv.bound_nodes, genv.bound_proposers)

    def cell_args(c):
        n, props = c["n_nodes"], tuple(c["proposers"])
        pc = cfgm.ProtocolConfig(**e["protocols"][c["protocol"]])
        cfg = cfgm.SimConfig(n_nodes=n, n_instances=e["n_instances"], proposers=props, seed=0,
                             max_rounds=e["max_rounds"], faults=cfgm.FaultConfig(max_delay=2),
                             protocol=pc)
        wl = tmpl[: len(props)]
        kw = dict(workloads=[(wl, None)] * lanes,
                  knobs=[cfgm.FaultConfig(**e["rates"][c["rate"]])] * lanes)
        return cfg, wl, kw, dict(geometry=(n, props), protocol=pc)

    def shas(rep):
        return [_lane_sha(rep, i, e["stride"]) for i in range(lanes)]

    envelope.clear_cache()
    before = envelope.cache_misses()
    runners, padded, off = set(), {}, []
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    sk.reset_counts()
    with lane_counts(sk) as shapes:
        for k, c in enumerate(gold["cells"]):
            cfg, wl, kw, gp = cell_args(c)
            runner = envelope.runner_for(cfg, tmpl, geometry=genv, device=DEV)
            runners.add(id(runner))
            rep = runner.run(seeds, [None] * lanes, **kw, **gp)
            padded[k] = shas(rep)
            if (padded[k] != c["decision_log_sha256"] or rep.verdict.rounds.tolist() != c["rounds"]
                    or rep.verdict.ok.tolist() != c["ok"]):
                off.append(k)
    grid_s = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    builds = envelope.cache_misses() - before
    lanes_ok = all(x == [lanes] * len(x) for x in shapes.values())
    print(f"envelope grid ({len(gold['cells'])} cells x {lanes} lanes, bound {bound}): "
          f"grid_s={grid_s:.3f} runners={len(runners)} runners_built={builds} "
          f"launches={json.dumps(launches, sort_keys=True)} lanes_per_launch_ok={lanes_ok} "
          f"cells_off_golden={off} | {card}")
    if off:
        raise SystemExit(f"the padded envelope disagrees with its JAX goldens in cells {off}")
    if builds != 1 or len(runners) != 1:
        raise SystemExit(f"the envelope grid built {builds} runners; one must serve it")
    if min(launches.values()) < 1 or not lanes_ok:
        raise SystemExit(f"the envelope: a simkern kernel did not launch on {lanes}-lane operands")
    twins_off = []
    for k, c in enumerate(gold["cells"]):
        cfg, wl, kw, _ = cell_args(c)
        rep = envelope.runner_for(cfg, wl, device=DEV).run(seeds, [None] * lanes, **kw)
        if shas(rep) != padded[k]:
            twins_off.append(k)
    print(f"envelope bound-free twins on the card: cells_off={twins_off}")
    if twins_off:
        raise SystemExit(f"padded lanes differ from their bound-free twins in cells {twins_off}")
    # the padding toll: bench.py's timed cell (first protocol, second rate)
    toll = {}
    for c in gold["cells"]:
        if c["protocol"] != 0 or c["rate"] != 1:
            continue
        cfg, wl, kw, gp = cell_args(c)
        runs = {True: lambda: envelope.runner_for(cfg, tmpl, geometry=genv, device=DEV).run(
                    seeds, [None] * lanes, **kw, **gp),
                False: lambda: envelope.runner_for(cfg, wl, device=DEV).run(
                    seeds, [None] * lanes, **kw)}
        got = {True: [], False: []}
        for pad in (True, False, False, True):
            got[pad].append(runs[pad]().lanes_per_sec)
        n = c["n_nodes"]
        toll[n] = {"padded": got[True], "unpadded": got[False]}
        print(f"envelope padding toll at {n} nodes (turns padded, unpadded, unpadded, padded): "
              f"padded lanes_per_sec={[round(x, 2) for x in got[True]]} unpadded "
              f"{[round(x, 2) for x in got[False]]} ratio="
              f"{sum(got[True]) / sum(got[False]):.3f} | {card}")
    stats = {}
    c = [c for c in gold["cells"] if c["n_nodes"] == bound[0]][0]
    cfg, wl, kw, gp = cell_args(c)
    with check_launches(sk, ENVELOPE_REPS, stats, lanes=lanes):
        rep = envelope.runner_for(cfg, tmpl, geometry=genv, device=DEV).run(
            seeds, [None] * lanes, **kw, **gp)
    if shas(rep) != c["decision_log_sha256"]:
        raise SystemExit("the checked padded dispatch disagrees with its JAX golden")
    checked = _summarize_checked(
        f"envelope (A, P) = {bound} {lanes}-lane operands (7 nodes)", stats)
    envelope.clear_cache()
    torch.cuda.empty_cache()
    return {"launches": launches, "grid_s": grid_s, "toll": toll, "checked": checked}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from tpu_paxos_torch.core import fast
    from tpu_paxos_torch.core import fastwin as fw
    from tpu_paxos_torch.core import simkern as sk
    from tpu_paxos_torch.utils import kbuild

    with open(os.path.join(here, "tpu_paxos_torch", "data", "goldens.json")) as fh:
        goldens = json.load(fh)
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    t0 = time.perf_counter()
    libs = kbuild.build_all([sk.NAME, fw.NAME])
    sk.load()
    fw.load()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
          f"{sorted(os.path.relpath(p, here) for p in libs.values())}")

    rec = check_kernels(sk)
    print(f"kernels: {json.dumps(list(rec))}")
    launches = run_main_path(sk, goldens)
    snaps = snapshot_main_path(sk, goldens, launches)
    main_rec = time_main_path_operands(sk, snaps)
    del snaps
    torch.cuda.empty_cache()
    run_cli(sk, goldens)
    fw_rec = check_fastwin(fw, fast)
    fw_launches = run_fast_headline(fw, fast, card)
    run_fast_cli(goldens)
    for key in ("bench_sim_partition_flap", "bench_sim_wan3"):
        run_scheduled(sk, goldens, key)
    fleet = run_fleet(sk, goldens, card)
    full = run_runtime_full(sk, goldens)
    t11 = time.perf_counter()
    run_stress_quick(goldens, here, card)
    wedge = run_triage_wedge(sk, goldens, here, card)
    with tempfile.TemporaryDirectory() as keep:
        full_art = run_triage_full(sk, goldens, here, card, keep)["path"]
        print(f"phase 11 (triage) took {time.perf_counter() - t11:.1f} s")
        t12 = time.perf_counter()
        tele = run_telemetry_single(sk, goldens, card)
        tele_fleet = run_telemetry_fleet(sk, goldens, card)
        run_trace_cli(goldens, here, full_art, card)
        print(f"phase 12 (flight recorder) took {time.perf_counter() - t12:.1f} s")
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # 13a's subprocess runs beside 13c's
        quick = start_fleet_quick(goldens, here, tmp)
        run_stress_fleet(goldens, here, card)
        run_fleet_quick(goldens, here, card, quick, tmp)
    wide = run_search_wide(sk, goldens, card)
    env13 = run_envelope(sk, goldens, card)
    print(f"phase 13 (search, fleet sweep, padded envelope) took {time.perf_counter() - t13:.1f} s")

    replaces = {
        "simkern.store_accepts": ("store_accepts", "tpu_paxos/core/simkern.py:99"),
        "simkern.accum_acks": ("accum_acks", "tpu_paxos/core/simkern.py:160"),
    }
    kernels = []
    for name, r in rec.items():
        key, where = replaces[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_paxos_torch/csrc/simkern.cu",
            "replaces": where,
            "launches": launches[key],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            "library_ms": None,
            "main_path_ms": main_rec[name]["main_path_ms"],
            "main_path_bound_ms": main_rec[name]["main_path_bound_ms"],
            "fleet_lanes": fleet["checked"][name]["lanes"][0],
            "fleet_launches": fleet["headline"]["launches"][key],
            "fleet_ms": fleet["checked"][name]["ms"],
            "fleet_bound_ms": fleet["checked"][name]["bound_ms"],
            "fleet_full_launches": full[name]["launches"],
            "fleet_full_ms": full[name]["ms"],
            "fleet_full_bound_ms": full[name]["bound_ms"],
            "triage_lanes": wedge["checked"][name]["lanes"][0],
            "triage_launches": wedge["culprit"]["launches"][key],
            "triage_ms": wedge["checked"][name]["ms"],
            "triage_bound_ms": wedge["checked"][name]["bound_ms"],
            "armed_launches": tele["launches"]["bench_sim"][key],
            "armed_ms": tele["checked"][name]["ms"],
            "armed_bound_ms": tele["checked"][name]["bound_ms"],
            "armed_fleet_launches": tele_fleet["launches"][key],
            "search_launches": wide["launches"][key],
            "envelope_launches": env13["launches"][key],
            "envelope_lanes": env13["checked"][name]["lanes"][0],
            "envelope_ms": env13["checked"][name]["ms"],
            "envelope_bound_ms": env13["checked"][name]["bound_ms"],
        })
    r = fw_rec["iota"]  # the headline run's variant
    kernels.append({
        "name": "fastwin.steady_state_windows",
        "route": "cuda",
        "source": "tpu_paxos_torch/csrc/fastwin.cu",
        "replaces": "tpu_paxos/core/fastwin.py:131",
        "launches": fw_launches,
        "max_abs_err": fw_rec["max_abs_err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
        "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
        "library_ms": None,
    })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
