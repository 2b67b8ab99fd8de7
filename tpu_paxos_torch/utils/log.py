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

