"""Decision-log emitter in the reference's debug value grammar (port of
``tpu_paxos/replay/decision_log.py``).

The grammar (ref multi/paxos.cpp:18-22):

    no-op:   [instance-id] = <proposal-id>(proposer:value-id)-
    normal:  [instance-id] = <proposal-id>(proposer:value-id)+value

One line per decided instance, in instance order; the log is a pure
function of the engine result.  The text is assembled with vectorized
numpy (a fixed-width byte matrix whose padding is squeezed out), so a
multi-million-line log renders in seconds without a per-line Python
loop.
"""

from __future__ import annotations

import hashlib
from typing import Callable

import numpy as np

from tpu_paxos_torch.core import values as val


def _int_columns(ints: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """[n, W] uint8: each kept int right-aligned in decimal (with a
    leading '-' when negative), every other cell 0 (padding)."""
    neg = ints < 0
    mag = np.abs(ints)
    width = len(str(int(mag.max()))) + 1 if mag.size else 1
    cols = np.zeros((ints.shape[0], width), np.uint8)
    alive = keep.copy()
    for j in range(width - 1, -1, -1):
        digit = (ord("0") + mag % 10).astype(np.uint8)
        sign = np.where(neg & ~alive & keep, ord("-"), 0).astype(np.uint8)
        cols[:, j] = np.where(alive, digit, sign)
        neg = neg & alive  # the sign goes once, right before the digits
        mag = mag // 10
        alive = alive & (mag > 0)
    return cols


def _assemble(segments, n: int) -> bytes:
    """Render ``n`` lines, each the concatenation of ``segments`` plus a
    newline.  A segment is ``bytes`` (the same on every line), a
    ``uint8`` array of one character per line, or ``(ints, keep)``: a
    decimal int64 array written only where ``keep`` is true.  Lines are
    laid out as one fixed-width byte matrix with zero padding, which is
    squeezed out at the end."""
    cols = []
    for seg in segments:
        if isinstance(seg, bytes):
            cols.append(np.broadcast_to(np.frombuffer(seg, np.uint8), (n, len(seg))))
        elif isinstance(seg, np.ndarray):
            cols.append(seg.astype(np.uint8)[:, None])
        else:
            cols.append(_int_columns(*seg))
    cols.append(np.full((n, 1), ord("\n"), np.uint8))
    flat = np.concatenate(cols, axis=1).reshape(-1)
    return flat[flat != 0].tobytes()


def decision_log(
    chosen_vid: np.ndarray,
    chosen_ballot: np.ndarray,
    stride: int,
    n_instances: int,
    payload: Callable[[int], str] | None = None,
    membership: Callable[[int], str] | None = None,
) -> str:
    """Render the decided log.  ``stride`` is the workload's vid stride
    (``vid = proposer * stride + seq``); ``payload`` optionally maps a
    real vid to its payload string (default: the value-id);
    ``membership`` maps a membership-change vid to its ``m+id=ip:port`` /
    ``m-id`` suffix (``membership.membership_suffix``), and vids it
    returns None for fall through to the normal grammar."""
    if membership is not None:
        return _membership_log(chosen_vid, chosen_ballot, stride, n_instances, payload,
                               membership)
    chosen_vid = np.asarray(chosen_vid).astype(np.int64)
    chosen_ballot = np.asarray(chosen_ballot).astype(np.int64)
    inst = np.flatnonzero(chosen_vid != val.NONE)
    if not inst.size:
        return ""
    v = chosen_vid[inst]
    b = chosen_ballot[inst]
    noop = v <= val.NOOP_BASE
    proposer, seq, _ = val.decode_host_array(v, stride, n_instances)
    real = ~noop
    everywhere = np.ones(inst.shape, bool)
    if payload is None:
        tail = [(seq, real)]
    else:
        # custom payloads: render the per-line body in Python
        bodies = [payload(int(x)) if r else "" for x, r in zip(v, real)]
        head = _assemble(
            [b"[", (inst.astype(np.int64), everywhere), b"] = <", (b, everywhere),
             b">(", (proposer, everywhere), b":", (seq, everywhere), b")",
             np.where(noop, ord("-"), ord("+")).astype(np.uint8)],
            inst.size,
        ).decode().split("\n")[:-1]
        return "".join(h + body + "\n" for h, body in zip(head, bodies))
    text = _assemble(
        [b"[", (inst.astype(np.int64), everywhere), b"] = <", (b, everywhere),
         b">(", (proposer, everywhere), b":", (seq, everywhere), b")",
         np.where(noop, ord("-"), ord("+")).astype(np.uint8)] + tail,
        inst.size,
    )
    return text.decode("ascii")


def _membership_log(chosen_vid, chosen_ballot, stride, n_instances, payload, membership) -> str:
    """The log with membership-change lines, one Python line at a time.
    A change vid encodes (target node, kind), not (proposer, seq), so its
    line renders the change's own identity before the suffix."""
    from tpu_paxos_torch.membership import engine as mem

    lines = []
    for i, v in enumerate(np.asarray(chosen_vid).tolist()):
        if v == val.NONE:
            continue
        b = int(chosen_ballot[i])
        if v <= val.NOOP_BASE:
            proposer, inst, _ = val.decode_host(v, stride, n_instances)
            lines.append(f"[{i}] = <{b}>({proposer}:{inst})-")
            continue
        m = membership(v)
        if m is not None:
            node, kind = mem.decode_change(v)
            lines.append(f"[{i}] = <{b}>({node}:{kind}){m}")
            continue
        proposer, seq, _ = val.decode_host(v, stride, n_instances)
        body = payload(v) if payload is not None else str(seq)
        lines.append(f"[{i}] = <{b}>({proposer}:{seq})+{body}")
    return "\n".join(lines) + ("\n" if lines else "")


def sha256(text: str) -> str:
    """The decision-log digest the repo compares runs by."""
    return hashlib.sha256(text.encode()).hexdigest()
