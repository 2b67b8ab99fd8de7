"""The profiler's arithmetic, kept in memory: only its summary leaves.

The sums follow ``scripts/torch_sim_profile.py``: the device is busy while
a device-side event (a kernel, a copy, a memset) runs; a CPU op's "self
device time" repeats the time of the kernels it launched, so only device
events count.  Busy time is the union of the device events' intervals
(one stream, so they rarely overlap, and a union never counts twice);
the device-side copies of ``record_function`` ranges are no device work
and are left out.

Each idle gap between device events is charged to what the host was doing
while the device waited: the innermost ``record_function`` range of a
wrapped block (``spans.BlockTimer(profile_ranges=True)``) or of the
harness's own step, split by the time each held the host in the gap.
"""

from __future__ import annotations

import contextlib
import time

import torch

OUTSIDE = "outside any wrapped block"


@contextlib.contextmanager
def profiled(device: str = "cuda"):
    """Profile the block on the CPU and the card; yields a dict that holds
    ``prof`` and the block's synchronized wall ``window_s`` once it ends.
    On ``device="cpu"`` (the tests) only the host is profiled."""
    from torch.profiler import ProfilerActivity, profile

    card = device != "cpu"
    box = {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    if card:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield box
        if card:
            torch.cuda.synchronize()
        box["window_s"] = time.perf_counter() - t0
    box["prof"] = prof


def _union_s(intervals) -> float:
    total, end = 0.0, None
    for s, e in intervals:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-6


def summarize(prof, window_s: float, blocks) -> dict:
    """:func:`summarize_events` of a profile; ``blocks`` are the range
    names that may be charged with an idle gap."""
    from torch.autograd import DeviceType

    dev, ranges = [], []
    names = set(blocks)
    for ev in prof.events():
        tr = ev.time_range
        if ev.name in names or ev.is_user_annotation:
            # a range's host side is what the host did; its device-side
            # copy (a "gpu_user_annotation") is no device work
            if ev.device_type == DeviceType.CPU and ev.name in names:
                ranges.append((tr.start, tr.end, ev.name))
        elif ev.device_type != DeviceType.CPU:
            dev.append((tr.start, tr.end, ev.name))
    return summarize_events(dev, ranges, window_s)


def _innermost(ranges) -> list:
    """The host's timeline as ``(start, end, name)`` segments, each named
    after the innermost range open over it (ranges of one thread nest);
    time outside every range is :data:`OUTSIDE`."""
    marks = sorted([(s, 1, -e, name) for s, e, name in ranges]
                   + [(e, 0, -e, name) for s, e, name in ranges])
    out, stack, t = [], [], None
    for at, opening, neg_end, name in marks:
        if t is not None and at > t:
            out.append((t, at, stack[-1][1] if stack else OUTSIDE))
        t = at
        if opening:
            stack.append((-neg_end, name))
        else:
            while stack and stack[-1][0] <= at:
                stack.pop()
    return out


def summarize_events(dev, ranges, window_s: float) -> dict:
    """``{busy_s, window_s, ops: {name: [count, seconds]}, gaps: {block:
    seconds}}`` from device events and host ranges, each ``(start_us,
    end_us, name)``.  Each idle gap is split over the host blocks that ran
    in it, each charged the part of the gap it held the host."""
    dev = sorted(dev)
    ops: dict[str, list] = {}
    for s, e, name in dev:
        rec = ops.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) * 1e-6
    idle, end = [], None
    for s, e, _ in dev:
        if end is not None and s > end:
            idle.append((end, s))
        end = e if end is None else max(end, e)
    gaps: dict[str, float] = {}
    segs = _innermost(ranges)
    k = 0
    for g0, g1 in idle:
        covered = 0.0
        while k < len(segs) and segs[k][1] <= g0:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < g1:
            part = min(g1, segs[j][1]) - max(g0, segs[j][0])
            if part > 0:
                gaps[segs[j][2]] = gaps.get(segs[j][2], 0.0) + part * 1e-6
                covered += part
            j += 1
        if g1 - g0 > covered:
            gaps[OUTSIDE] = gaps.get(OUTSIDE, 0.0) + (g1 - g0 - covered) * 1e-6
    return {
        "busy_s": _union_s((s, e) for s, e, _ in dev),
        "window_s": window_s,
        "ops": ops,
        "gaps": gaps,
    }


def top(table: dict, n: int = 10) -> list:
    """The ``n`` largest entries of ``{name: seconds}`` as ``[[name, s]]``."""
    rows = sorted(table.items(), key=lambda kv: -kv[1])[:n]
    return [[name, s] for name, s in rows]
