"""Trace-level dump helpers — the DumpHex / debug-format analog.

The reference hex-dumps wire bytes at TRACE level
(ref multi/paxos.cpp:32-44 ``DumpHex``, used by the harness at
multi/main.cpp:137-146).  This framework's wire format is typed
arrays, so the analog is a compact array dump: shape/dtype header plus
a bounded, greppable element listing, built for the leveled logger's
TRACE sink (utils/log.py)."""

from __future__ import annotations

import numpy as np


def dump_hex(buf: bytes, limit: int = 256) -> str:
    """Byte-for-byte port of the reference's hex format: uppercase hex
    pairs separated by spaces (ref multi/paxos.cpp:32-44), truncated
    at ``limit`` bytes with an ellipsis marker."""
    shown = buf[:limit]
    body = " ".join(f"{b:02X}" for b in shown)
    if len(buf) > limit:
        body += f" .. (+{len(buf) - limit} bytes)"
    return body


def dump_array(name: str, arr, limit: int = 32) -> str:
    """One-line array dump for TRACE logs: name, shape, dtype, and the
    first ``limit`` elements (row-major), with NONE sentinels shown as
    '.' to keep decision tensors readable."""
    a = np.asarray(arr)
    flat = a.reshape(-1)[:limit]
    body = " ".join("." if int(v) == -1 else str(int(v)) for v in flat)
    more = a.size - min(a.size, limit)
    tail = f" .. (+{more})" if more else ""
    return f"{name}{list(a.shape)}:{a.dtype}= {body}{tail}"
