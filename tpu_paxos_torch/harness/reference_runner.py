"""C++ reference runner, the decision-parity anchor (port of
``tpu_paxos/harness/reference_runner.py``).

It compiles the reference ``multi/`` binary with its own flags (ref
multi/Makefile:1-2), runs it on the canonical debug.conf workload (ref
multi/debug.conf.sample:1, multi/run.sh:5), parses each server's final
committed-value dump in the documented grammar (ref multi/paxos.cpp:18-22,
printed at multi/paxos.cpp:1694-1703), and checks the reference's own
end-of-run invariants (ref multi/main.cpp:566-573) independently on the
parsed logs, with the same checks ``harness/validate`` applies to the
port's runs.  Parity is invariant parity per config (the C++ run is
wall-clock nondeterministic), not byte-equal logs.

The sources are read from the directory ``TPU_PAXOS_REFERENCE`` names
(default: ``reference/multi`` in the checkout) and compiled in place into
a build directory under the repo; when they are absent,
:func:`build_reference` raises naming the directory, and nothing stands
in for the binary.  The workload helpers (:func:`equivalent_workload`,
:func:`in_order_chains`) also feed the CLI.
"""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
from typing import Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REFERENCE_DIR = os.environ.get("TPU_PAXOS_REFERENCE", os.path.join(_REPO, "reference", "multi"))
DEFAULT_BUILD_DIR = os.path.join(_REPO, "build", "ref_multi_torch")

# One committed entry in the debug grammar (ref multi/paxos.cpp:18-22):
#   <proposal-id>(proposer:value-id)+value   normal
#   <proposal-id>(proposer:value-id)-        no-op
#   <proposal-id>(proposer:value-id)m+id=..  add member (disabled in multi/)
#   <proposal-id>(proposer:value-id)m-id     del member (disabled in multi/)
_ENTRY = re.compile(
    r"<(?P<ballot>\d+)>\((?P<proposer>\d+):(?P<vid>\d+)\)"
    r"(?P<kind>m\+|m-|\+|-)(?P<value>[^,(]*)"
)
_FINAL = re.compile(
    r"\[srv-(?P<server>\d+)-paxos:\d+\].*final committed values: "
    r"(?P<body>.*) \((?P<count>\d+) in total\)"
)


@dataclasses.dataclass(frozen=True)
class CommittedEntry:
    """One decided instance as the reference dumps it (instance ids are
    implicit: the dump iterates the committed map in instance order)."""

    ballot: int
    proposer: int
    value_id: int
    noop: bool
    value: str  # payload text for normal values ("" for no-ops)


@dataclasses.dataclass(frozen=True)
class ReferenceRun:
    returncode: int
    all_done: bool  # the reference's own asserts all passed
    logs: dict[int, list[CommittedEntry]]  # server index -> committed seq
    raw_log: str


def build_reference(build_dir: str = DEFAULT_BUILD_DIR) -> str:
    """Compile the reference binary (its own one-line Makefile recipe, ref
    multi/Makefile:1-2) into ``build_dir``; returns the binary's path.
    Recompiles only when a source is newer than the binary; raises
    ``FileNotFoundError`` naming the directory when the sources are
    absent."""
    # paxos.h is a staleness dependency but not a compilation unit: the
    # reference Makefile compiles only the two .cpp files
    srcs = [os.path.join(REFERENCE_DIR, "main.cpp"), os.path.join(REFERENCE_DIR, "paxos.cpp")]
    deps = srcs + [os.path.join(REFERENCE_DIR, "paxos.h")]
    missing = [d for d in deps if not os.path.isfile(d)]
    if missing:
        raise FileNotFoundError(
            f"the C++ reference sources are not in {REFERENCE_DIR} (missing "
            f"{', '.join(os.path.basename(m) for m in missing)}); set "
            "TPU_PAXOS_REFERENCE to the reference's multi/ directory"
        )
    os.makedirs(build_dir, exist_ok=True)
    binary = os.path.join(build_dir, "main")
    if os.path.exists(binary) and all(
        os.path.getmtime(binary) >= os.path.getmtime(s) for s in deps
    ):
        return binary
    subprocess.run(
        ["g++", "-g", "-Wall", "-o", binary, "-lrt", "-pthread", *srcs],
        check=True, capture_output=True, text=True,
    )
    return binary


def reference_args(
    srvcnt: int = 4,
    cltcnt: int = 4,
    idcnt: int = 10,
    propose_interval: int = 100,
    seed: int = 0,
    prepare_delay_min: int = 1000,
    prepare_delay_max: int = 3000,
    prepare_retry_count: int = 3,
    prepare_retry_timeout: int = 500,
    accept_retry_count: int = 2,
    accept_retry_timeout: int = 300,
    commit_retry_timeout: int = 1000,
    drop_rate: int = 500,
    dup_rate: int = 1000,
    min_delay: int = 0,
    max_delay: int = 500,
    log_level: int = 1,
) -> list[str]:
    """The reference CLI line (ref multi/main.cpp:456-496); defaults are
    the canonical debug.conf.sample values (ref multi/debug.conf.sample:1).
    ``log_level=1`` (DEBUG) is required so the final committed dump is
    emitted (ref multi/paxos.cpp:1703 logs at DEBUG)."""
    return [
        str(srvcnt),
        str(cltcnt),
        str(idcnt),
        str(propose_interval),
        f"--seed={seed}",
        f"--paxos-prepare-delay-min={prepare_delay_min}",
        f"--paxos-prepare-delay-max={prepare_delay_max}",
        f"--paxos-prepare-retry-count={prepare_retry_count}",
        f"--paxos-prepare-retry-timeout={prepare_retry_timeout}",
        f"--paxos-accept-retry-count={accept_retry_count}",
        f"--paxos-accept-retry-timeout={accept_retry_timeout}",
        f"--paxos-commit-retry-timeout={commit_retry_timeout}",
        f"--log-level={log_level}",
        f"--net-drop-rate={drop_rate}",
        f"--net-dup-rate={dup_rate}",
        f"--net-min-delay={min_delay}",
        f"--net-max-delay={max_delay}",
    ]


def fast_reference_args(seed: int = 0, **overrides) -> list[str]:
    """The debug.conf workload with every wall-clock knob scaled down
    10-20x (fault rates untouched), so a parity check runs in seconds
    instead of ~50 s.  Timeouts scale together, so the retry ladder's
    geometry, and with it the reachable interleavings, is preserved."""
    kw = dict(
        propose_interval=10,
        seed=seed,
        prepare_delay_min=100,
        prepare_delay_max=300,
        prepare_retry_timeout=50,
        accept_retry_timeout=30,
        commit_retry_timeout=100,
        max_delay=50,
    )
    kw.update(overrides)
    return reference_args(**kw)


def parse_committed_logs(log_text: str) -> dict[int, list[CommittedEntry]]:
    """Every server's final committed sequence from a run log.

    The dump line (ref multi/paxos.cpp:1694-1703) renders the committed
    map in instance order; entry k of the list is the k-th committed
    instance of that server.  Raises ``ValueError`` when a dump's entry
    count disagrees with the count it claims."""
    logs: dict[int, list[CommittedEntry]] = {}
    for m in _FINAL.finditer(log_text):
        server = int(m.group("server"))
        entries = [
            CommittedEntry(
                ballot=int(e.group("ballot")),
                proposer=int(e.group("proposer")),
                value_id=int(e.group("vid")),
                noop=e.group("kind") == "-",
                value=e.group("value").strip(),
            )
            for e in _ENTRY.finditer(m.group("body"))
        ]
        if len(entries) != int(m.group("count")):
            raise ValueError(
                f"server {server}: parsed {len(entries)} entries, "
                f"dump claims {m.group('count')}"
            )
        logs[server] = entries
    return logs


def run_reference(args: Sequence[str], binary: str | None = None,
                  timeout: float = 600.0) -> ReferenceRun:
    """Run the reference binary and parse its committed logs."""
    if binary is None:
        binary = build_reference()
    try:
        proc = subprocess.run(
            [binary, *args], capture_output=True, text=True, timeout=timeout,
            cwd=os.path.dirname(binary),
        )
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(
            f"reference binary timed out after {timeout}s; partial "
            f"output:\n{(e.output or '')[-2000:]}"
        ) from e
    log = (proc.stdout or "") + (proc.stderr or "")
    return ReferenceRun(
        returncode=proc.returncode,
        all_done="All done" in log,
        logs=parse_committed_logs(log),
        raw_log=log,
    )


# ------------------------------------------------------------ invariants


def in_order_chains(cltcnt: int, idcnt: int) -> list[np.ndarray]:
    """Per in-order client, the id chain that must execute in order:
    clients 0..cltcnt/2-1, ids k=0..idcnt/2 (ref multi/main.cpp:398-411,
    202-212)."""
    return [
        np.asarray([c * idcnt + k for k in range(idcnt // 2 + 1)], np.int64)
        for c in range(cltcnt // 2)
    ]


def check_reference_invariants(run: ReferenceRun, srvcnt: int, cltcnt: int, idcnt: int) -> None:
    """Re-assert the reference's end-of-run invariants on the parsed logs
    (ref multi/main.cpp:566-573 and the state machine's online in-order
    check at :202-212).  The binary asserts these itself (rc 0 and "All
    done"); re-deriving them from the dump is what judges both systems
    by the same external checker."""
    from tpu_paxos_torch.harness import validate

    if run.returncode != 0 or not run.all_done:
        raise validate.InvariantViolation(
            f"reference run failed (rc={run.returncode}, all_done={run.all_done})"
        )
    if set(run.logs.keys()) != set(range(srvcnt)):
        raise validate.InvariantViolation(
            f"expected committed dumps from servers 0..{srvcnt - 1}, "
            f"got {sorted(run.logs)}"
        )
    seqs = [
        np.asarray([int(e.value) for e in run.logs[s] if not e.noop], np.int64)
        for s in range(srvcnt)
    ]
    # agreement: identical executed sequences (ref multi/main.cpp:568-570)
    for s in range(1, srvcnt):
        if not np.array_equal(seqs[s], seqs[0]):
            raise validate.InvariantViolation(
                f"server {s} executed sequence differs from server 0"
            )
    # exactly-once: the sorted ids are exactly 0..N-1 (ref :571-573)
    want = np.arange(cltcnt * idcnt, dtype=np.int64)
    if not np.array_equal(np.sort(seqs[0]), want):
        raise validate.InvariantViolation(
            f"executed ids are not exactly 0..{cltcnt * idcnt - 1}"
        )
    # in-order clients (ref multi/main.cpp:398-411, SM check :202-212)
    validate.check_in_order_clients(seqs[0], in_order_chains(cltcnt, idcnt))


# ------------------------------------------------ the equivalent port run


def equivalent_workload(srvcnt: int, cltcnt: int, idcnt: int):
    """Client c proposes ids [c*idcnt, (c+1)*idcnt); its k-th id goes to
    server ``srvcnt - 1 - k % srvcnt`` (ref multi/main.cpp:414).
    Clients c < cltcnt/2 propose their first idcnt/2+1 ids strictly in
    order, expressed as gate chains.  vids are the reference's global
    ids.  Returns (workload, gates, in_order_vids)."""
    per_server: list[list[int]] = [[] for _ in range(srvcnt)]
    per_server_gate: list[list[int]] = [[] for _ in range(srvcnt)]
    for k in range(idcnt):
        for c in range(cltcnt):
            vid = c * idcnt + k
            sidx = srvcnt - 1 - (k % srvcnt)
            gate = vid - 1 if c < cltcnt // 2 and 1 <= k <= idcnt // 2 else -1
            per_server[sidx].append(vid)
            per_server_gate[sidx].append(gate)
    workload = [np.asarray(w, np.int32) for w in per_server]
    gates = [np.asarray(g, np.int32) for g in per_server_gate]
    return workload, gates, in_order_chains(cltcnt, idcnt)


def run_equivalent_sim(
    srvcnt: int = 4,
    cltcnt: int = 4,
    idcnt: int = 10,
    seed: int = 0,
    drop_rate: int = 500,
    dup_rate: int = 1000,
    max_delay_rounds: int = 2,
    n_instances: int | None = None,
    max_rounds: int = 4000,
    device="cuda",
):
    """Run the port's general engine on the workload equivalent of a
    reference config; returns (SimResult, in_order_vids).  The canonical
    0-500 ms delays at ~100 ms round trips are 0-2 rounds."""
    from tpu_paxos_torch import config as cfgm
    from tpu_paxos_torch.core import sim

    workload, gates, in_order = equivalent_workload(srvcnt, cltcnt, idcnt)
    if n_instances is None:
        n_instances = cltcnt * idcnt * 2  # headroom for no-op holes
    cfg = cfgm.SimConfig(
        n_nodes=srvcnt,
        n_instances=n_instances,
        proposers=tuple(range(srvcnt)),
        seed=seed,
        max_rounds=max_rounds,
        faults=cfgm.FaultConfig(drop_rate=drop_rate, dup_rate=dup_rate, min_delay=0,
                                max_delay=max_delay_rounds),
    )
    return sim.run(cfg, workload, gates, device=device), in_order


def check_parity(
    srvcnt: int = 4,
    cltcnt: int = 4,
    idcnt: int = 10,
    seed: int = 0,
    reference_args_list: Sequence[str] | None = None,
    timeout: float = 600.0,
    device="cuda",
) -> dict:
    """The parity anchor (BASELINE config 1): run the C++ binary and the
    port on the equivalent config and assert the same invariants on both.
    Returns a summary with each side's counts."""
    from tpu_paxos_torch.harness import validate

    ref = run_reference(
        reference_args_list if reference_args_list is not None
        else fast_reference_args(seed=seed),
        timeout=timeout,
    )
    check_reference_invariants(ref, srvcnt, cltcnt, idcnt)
    res, in_order = run_equivalent_sim(srvcnt, cltcnt, idcnt, seed=seed, device=device)
    if not res.done:
        raise validate.InvariantViolation(
            f"tpu_paxos_torch run did not quiesce in {res.rounds} rounds"
        )
    seqs = validate.check_all(res.learned, res.expected_vids)
    validate.check_in_order_clients(seqs[0], in_order)
    return {
        "reference": {
            "rc": ref.returncode,
            "executed": len([e for e in ref.logs[0] if not e.noop]),
            "instances": len(ref.logs[0]),
        },
        "tpu_paxos_torch": {
            "rounds": res.rounds,
            "executed": int((res.chosen_vid >= 0).sum()),
            "instances": int((res.chosen_vid != -1).sum()),
        },
        "invariants": ["agreement", "exactly_once", "in_order_clients"],
        "parity": True,
    }
