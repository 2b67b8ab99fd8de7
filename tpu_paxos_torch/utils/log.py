"""The port's own copy of ``tpu_paxos/utils/log.py``.

Leveled host-side logger with the reference Logger's surface: 7-level
lines with a ms timestamp, file:line and function (ref
multi/paxos.cpp:74-103, levels at multi/paxos.h:90-110: TRACE, DEBUG,
INFO, NOTICE, WARNING, ERROR, CRITICAL), written to stderr so the CLI's
stdout carries only the decision log and the verdict.

Line format (reference shape, ref multi/paxos.cpp:95-101):

    [2026-07-29 12:00:00.123]\t[INFO]\t[name]\t[file.py:42]\t[fn]\tmsg
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time

TRACE, DEBUG, INFO, NOTICE, WARNING, ERROR, CRITICAL = range(7)
LEVEL_NAMES = ("TRACE", "DEBUG", "INFO", "NOTICE", "WARNING", "ERROR", "CRITICAL")

_lock = threading.Lock()  # stdout serialization (ref Logger's SpinLock)

#: Fixed stamp emitted in deterministic mode: same width/format as a
#: real one, so line-oriented consumers (and byte-compares) see a
#: stable prefix instead of wall clock.
ZERO_STAMP = "0000-00-00 00:00:00.000"


def deterministic_mode() -> bool:
    """True when log output must be byte-stable across runs
    (``TPU_PAXOS_DETERMINISTIC=1``).  Replay surfaces — ``python -m
    tpu_paxos repro`` and ``--replay-injections`` — switch this on so
    nothing a byte-compare might capture carries wall-clock time; the
    env var is read per call so tests can toggle it."""
    return os.environ.get("TPU_PAXOS_DETERMINISTIC", "") not in ("", "0")


def _stamp() -> str:
    """Wall-clock line stamp, zeroed under deterministic_mode().  The
    one sanctioned wall-clock read in the replay-critical import
    closure: it exists only for humans tailing stderr and is
    suppressed whenever bytes must replay."""
    if deterministic_mode():
        return ZERO_STAMP
    now = time.time()  # paxlint: allow[DET001] zeroed in deterministic mode
    # paxlint: allow[DET001] zeroed in deterministic mode
    base = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(now))
    return f"{base}.{int((now % 1) * 1000):03d}"


def parse_level(raw: str, default: int = INFO) -> int:
    """Numeric level from a name or digit; clamps digits to the valid
    range, accepts the common WARN/ERR aliases, and falls back to
    ``default`` on anything unrecognized."""
    if not raw:
        return default
    if raw.isdigit():
        return max(0, min(int(raw), CRITICAL))
    name = {"WARN": "WARNING", "ERR": "ERROR", "CRIT": "CRITICAL"}.get(
        raw.upper(), raw.upper()
    )
    try:
        return LEVEL_NAMES.index(name)
    except ValueError:
        return default


def level_from_env(default: int = INFO) -> int:
    """Numeric level from TPU_PAXOS_LOG_LEVEL, mirroring the
    reference's ``--log-level=N`` flag (ref multi/main.cpp:469)."""
    return parse_level(os.environ.get("TPU_PAXOS_LOG_LEVEL", ""), default)


class Logger:
    """Leveled logger; messages below ``level`` are dropped."""

    def __init__(self, name: str = "tpu_paxos", level: int | None = None,
                 stream=None):
        self.name = name
        self.level = level_from_env() if level is None else level
        self.stream = stream if stream is not None else sys.stderr

    def log(self, level: int, msg: str, *args) -> None:
        self._log(level, msg, args, depth=1)

    def _log(self, level: int, msg: str, args, depth: int) -> None:
        if level < self.level:
            return
        try:
            frame = sys._getframe(depth + 1)
        except ValueError:
            frame = sys._getframe()
        where = f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"
        fn = frame.f_code.co_name
        text = msg % args if args else msg
        line = (
            f"[{_stamp()}]\t[{LEVEL_NAMES[level]}]\t[{self.name}]\t"
            f"[{where}]\t[{fn}]\t{text}\n"
        )
        with _lock:
            self.stream.write(line)

    def trace(self, msg, *a):
        self._log(TRACE, msg, a, depth=1)

    def debug(self, msg, *a):
        self._log(DEBUG, msg, a, depth=1)

    def info(self, msg, *a):
        self._log(INFO, msg, a, depth=1)

    def notice(self, msg, *a):
        self._log(NOTICE, msg, a, depth=1)

    def warning(self, msg, *a):
        self._log(WARNING, msg, a, depth=1)

    def error(self, msg, *a):
        self._log(ERROR, msg, a, depth=1)

    def critical(self, msg, *a):
        self._log(CRITICAL, msg, a, depth=1)


_default = Logger()


def get_logger(name: str | None = None, level: int | None = None) -> Logger:
    if name is None and level is None:
        return _default
    return Logger(name or "tpu_paxos", level)


def trace_dump(logger: Logger, label: str, arr, limit: int = 64) -> None:
    """TRACE-level dump of (a small prefix of) a decision tensor, the
    array analog of the reference's DumpHex wire dumps
    (ref multi/paxos.cpp:32-44)."""
    if TRACE < logger.level:
        return
    import numpy as np

    a = np.asarray(arr.cpu() if hasattr(arr, "cpu") else arr)
    flat = a.reshape(-1)
    head = np.array2string(flat[:limit], max_line_width=120)
    suffix = f" …(+{flat.size - limit})" if flat.size > limit else ""
    logger.log(TRACE, "%s shape=%s %s%s", label, a.shape, head, suffix)


#: The Chrome trace :func:`profile_trace` writes into its directory.
TRACE_FILE = "trace.json"


def trace_kernel_counts(path: str, kernels=None) -> dict[str, int]:
    """Device kernel events of a Chrome trace, counted by kernel name; with
    ``kernels``, counted for each of those names found in an event's name
    (a ``__global__`` function's instantiations summed)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    if kernels is None:
        return counts
    return {k: sum(n for name, n in counts.items() if k in name) for k in kernels}


@contextlib.contextmanager
def profile_trace(out_dir: str | None, device="cuda"):
    """A ``torch.profiler`` window (the bench harness's profiling hook):
    CPU activity, plus CUDA activity when ``device`` is a CUDA device,
    exported as a Chrome trace to ``out_dir/trace.json`` (the directory
    is made).  A no-op when ``out_dir`` is falsy.  On a CUDA device a
    trace that holds no kernel event (no CUPTI, say) raises: the hook
    never writes a trace of the host alone in its place."""
    if not out_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(out_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if cuda and not trace_kernel_counts(path):
        raise RuntimeError(
            f"{path}: the profiler recorded no CUDA kernel event "
            "(is CUPTI available?); refusing a host-only trace"
        )
