"""Spans and counts taken from the benchmark's side, around the calls into
the program's layers.

:class:`BlockTimer` is a copy of ``scripts/torch_sim_profile.py``'s: it
wraps module attributes by name and keeps each block's exclusive host
time (a wrapped function's time less that of the wrapped functions it
calls) and its calls.  Each wrapped call is also a
``torch.profiler.record_function`` range named after its block, so a
trace can tell what the host was doing while the device idled.  A name
that the program no longer has is skipped and listed in ``missing``:
the metrics that read it then read nothing.

:func:`counting_syncs` counts the synchronizing CUDA calls of a block with
torch's sync debug mode, as ``utils/device.counting_syncs`` does.
"""

from __future__ import annotations

import contextlib
import importlib
import time
import warnings

import torch


def resolve(target: str):
    """``(owner module, attribute name, function)`` of a target named
    ``"package.module:attr"``; raises ImportError or AttributeError."""
    mod_name, _, attr = target.partition(":")
    owner = importlib.import_module(mod_name)
    return owner, attr, getattr(owner, attr)


class BlockTimer:
    def __init__(self, profile_ranges: bool = False):
        self.ms: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.missing: list[str] = []
        self._ranges = profile_ranges
        self._stack: list[float] = []
        self._saved: list = []

    def wrap(self, target: str, block: str) -> None:
        """Wrap the function ``"package.module:attr"``."""
        try:
            owner, attr, fn = resolve(target)
        except (ImportError, AttributeError):
            self.missing.append(target)
            return
        self.ms.setdefault(block, 0.0)
        self.calls.setdefault(block, 0)
        ranges = self._ranges

        def timed(*a, **kw):
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                if ranges:
                    with torch.profiler.record_function(block):
                        return fn(*a, **kw)
                return fn(*a, **kw)
            finally:
                total = time.perf_counter() - t0
                inner = self._stack.pop()
                self.ms[block] += (total - inner) * 1e3
                self.calls[block] += 1
                if self._stack:
                    self._stack[-1] += total

        self._saved.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


@contextlib.contextmanager
def wrapped(spans: dict, profile_ranges: bool = False):
    """A :class:`BlockTimer` over ``{block: [target, ...]}`` for the block."""
    timer = BlockTimer(profile_ranges)
    try:
        for block, targets in spans.items():
            for target in targets:
                timer.wrap(target, block)
        yield timer
    finally:
        timer.restore()


class SyncCount:
    def __init__(self):
        self.n = 0


@contextlib.contextmanager
def counting_syncs(enabled: bool = True):
    """Count the synchronizing CUDA calls made within the block (each
    warns once under sync debug mode ``"warn"``)."""
    box = SyncCount()
    if not enabled:
        yield box
        return
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode("default")
    box.n = sum("synchroniz" in str(w.message) for w in seen)
