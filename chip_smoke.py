"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. Report the card (``nvidia-smi`` name and power limit, the torch
   device name) and build the CUDA kernels from ``tpu_paxos_torch/csrc``
   (one ``nvcc`` per source, started together).
2. Hold the general engine's kernels (``simkern``) against their plain
   PyTorch versions on the card, at the main path's shape (A=5, P=2,
   I=2**23) and at odd sizes, with exact equality (all protocol state is
   integer), and time kernel and plain version with CUDA events (median
   of 25 launches).
3. Drive the general engine's main path — ``tpu_paxos_torch.core.sim.run``
   at the ``"engine": "sim"`` bench configuration (5 nodes, 2**23
   instances, proposers (0, 1), assign_window 2**20, drop 500 / dup
   1000 / delay 0-2, seed 0) — with the launch counts zeroed just before
   and read just after; it must launch both kernels, pass the invariant
   checks and reproduce the committed JAX golden (rounds, chosen count,
   decision-log sha256, ``tpu_paxos_torch/data/goldens.json``).
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

The line before the last is a JSON object with one record per kernel;
the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
A, P, I_FULL = 5, 2, 1 << 23
REPS = 25
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
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

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


def _median_ms(fn, reps: int = REPS) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


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
        wb, wv, wa = ab.clone(), av.clone(), acks.clone()
        rec["simkern.store_accepts"] = {
            "max_abs_err": err_s,
            "ms": _median_ms(lambda: sk.store_accepts_cuda(wb, wv, lr, bat, abal, elig)),
            "plain_ms": _median_ms(lambda: sk.store_accepts_plain(ab, av, lr, bat, abal, elig)),
            "bytes": sk.bytes_per_launch("store_accepts", A, P, i),
            "ops": 8 * A * P * i,
        }
        rec["simkern.accum_acks"] = {
            "max_abs_err": err_a,
            "ms": _median_ms(lambda: sk.accum_acks_cuda(wa, bat, ab, av, lr, abal, elig)),
            "plain_ms": _median_ms(lambda: sk.accum_acks_plain(acks, bat, ab, av, lr, abal, elig)),
            "bytes": sk.bytes_per_launch("accum_acks", A, P, i),
            "ops": 9 * A * P * i,
        }
        del wb, wv, wa
    for name, r in rec.items():
        r["bytes_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        r["ops_ms"] = r["ops"] / SCALAR_OPS_PER_S * 1e3
        print(f"{name}: {r['bytes']} bytes/launch ({r['bytes'] / I_FULL:.1f} B/instance), "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bytes bound {r['bytes_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return rec


def run_main_path(sk, goldens) -> dict:
    """Phase 3: the full-size general-engine run on the card."""
    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.replay.decision_log import decision_log, sha256

    gold = goldens["bench_sim"]
    bc = gold["config"]
    cfg = cfgm.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
        proposers=tuple(bc["proposers"]), seed=bc["seed"],
        assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=cfgm.FaultConfig(**bc["faults"]),
    )
    torch.cuda.reset_peak_memory_stats()
    sk.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    text = decision_log(res.chosen_vid, res.chosen_ballot, gold["stride"], cfg.n_instances)
    sha = sha256(text)
    chosen = int((res.chosen_vid != -1).sum())
    print(f"main path (sim.run, I={cfg.n_instances}): rounds={res.rounds} done={res.done} "
          f"chosen={chosen} wall_s={wall:.3f} peak_mem_gb={peak_gb:.2f} "
          f"launches={json.dumps(launches, sort_keys=True)} decision_log_sha256={sha}")
    validate.check_all(res.learned, res.expected_vids)
    print("main path invariants: agreement, exactly_once, executed_identical")
    if (res.rounds, bool(res.done), chosen, sha) != (
        gold["rounds"], gold["done"], gold["chosen"], gold["decision_log_sha256"]
    ):
        raise SystemExit(f"main path disagrees with the JAX golden: {gold}")
    for name, n in launches.items():
        if n < 1:
            raise SystemExit(f"kernel simkern.{name} was never launched on the main path")
    return launches


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


def run_scheduled(sk, goldens, key: str) -> dict:
    """Phase 8: one bench-size general-engine run under a stress mix."""
    import hashlib

    import numpy as np

    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import faults as flt
    from tpu_paxos_torch.core import sim
    from tpu_paxos_torch.harness import validate
    from tpu_paxos_torch.replay.decision_log import decision_log, sha256

    gold = goldens[key]
    bc = gold["config"]
    cfg = cfgm.SimConfig(
        n_nodes=bc["n_nodes"], n_instances=bc["n_instances"],
        proposers=tuple(bc["proposers"]), seed=bc["seed"],
        assign_window=bc["assign_window"], max_rounds=bc["max_rounds"],
        faults=_rebuild_faults(cfgm, flt, bc["faults"]),
    )
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
    run_cli(sk, goldens)
    fw_rec = check_fastwin(fw, fast)
    fw_launches = run_fast_headline(fw, fast, card)
    run_fast_cli(goldens)
    for key in ("bench_sim_partition_flap", "bench_sim_wan3"):
        run_scheduled(sk, goldens, key)

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
