"""One run of one cell: set-up, the measured window, the traced segment,
the reference's comparison and the result line.

Everything that belongs to one cell is found by name, so a later cell,
mix, configuration or metric comes as new files and entries only:

- ``BENCHMARK.json``'s ``workloads`` entry names the ``config`` and the
  ``traffic`` mix;
- ``configs/<config>.json`` holds the sizes (``file`` in ``configs``);
- ``traffic/<mix>.json`` holds the mix, whose ``kind`` names the driver
  ``traffic/<kind>.py`` (``build(ctx)`` returns it; its ``SPANS`` name
  the host blocks a trace charges idle time to);
- ``metrics/<metric>.py`` reads one metric (``read(r)`` returns a number
  or None; an optional ``SPANS`` adds host blocks to time).

A driver offers ``warm()``, ``step(k)`` (one unit of the closed loop:
the harness times it), ``values(k)``, ``release()`` and ``check()``
(the reference's numbers, each with its limit, the answers that failed
and the answers compared); a driver that can repeat window step 0
exactly offers ``replay()``, and the traced run then counts the bytes of
each kernel launch of one repeat before it profiles another.
"""

from __future__ import annotations

import _thread
import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

#: Top-level module names that may not be loaded when the window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_paxos")

#: Steps of a fast cell that the traced segment profiles at the least.
TRACE_MIN_STEPS = 20

#: Seconds past the window's close that the step in progress may take
#: before its answer counts as never come.
GRACE_S = 60.0


class NoResult(Exception):
    """The run cannot give a result line (exit code 2, nothing printed)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    if not os.path.exists(path):
        raise NoResult(f"{os.path.relpath(path, ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(manifest: dict, section: str, cell: str) -> list:
    """The entries of ``section`` that the cell reports."""
    return [m for m in manifest[section] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({n.partition(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def cell_kind(cell_name: str, manifest_path: str = MANIFEST) -> str:
    """The traffic kind of a cell (``traffic/<mix>.json``'s ``kind``)."""
    cell = {w["name"]: w for w in load_json(manifest_path)["workloads"]}[cell_name]
    return load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))["kind"]


@dataclasses.dataclass
class Context:
    """What a traffic driver is given: the cell, its configuration and
    mix as loaded, the run's seed and the device."""

    cell: str
    config: dict
    mix: dict
    seed: int
    device: str

    def derive(self, *tags) -> int:
        """A sub-seed in ``[0, 2^31)`` of the run's seed, per tag."""
        key = "/".join(str(t) for t in (self.cell, self.seed, *tags))
        return int.from_bytes(hashlib.sha256(key.encode()).digest()[:4], "little") >> 1


@dataclasses.dataclass
class Readings:
    """What a metric reader reads."""

    ctx: Context
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: list = dataclasses.field(default_factory=list)  # per step: latency_s, values
    counters: dict = dataclasses.field(default_factory=dict)  # the port's counters, window delta
    blocks_ms: dict = dataclasses.field(default_factory=dict)  # exclusive host ms by block
    block_calls: dict = dataclasses.field(default_factory=dict)
    syncs: int | None = None
    trace: dict | None = None  # trace.summarize of the traced segment
    trace_counters: dict = dataclasses.field(default_factory=dict)
    launch_bytes: dict = dataclasses.field(default_factory=dict)  # kernel -> [bytes]


def _counters_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


class Watchdog:
    """Interrupts the main thread once ``deadline`` (perf_counter) passes;
    ``fired`` tells its interrupt from a user's."""

    def __init__(self):
        self._timer = None
        self.fired = False

    def _fire(self) -> None:
        self.fired = True
        _thread.interrupt_main()

    def arm(self, deadline: float) -> None:
        self.disarm()
        self._timer = threading.Timer(max(0.0, deadline - time.perf_counter()), self._fire)
        self._timer.daemon = True
        self._timer.start()

    def disarm(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             manifest_path: str = MANIFEST, grace_s: float = GRACE_S,
             fault=None) -> dict:
    """Run one cell and return its result dict (the last line's object,
    with the compared numbers under ``checks``).  Raises :class:`NoResult`
    where no result may be printed.  ``fault`` (the control and the
    tests only) makes a context manager that is entered around the
    window: a fault planted under the timed path."""
    import torch

    from paxbench import spans as spm
    from paxbench import trace as trm

    t_start = time.perf_counter() if t_start is None else t_start
    manifest = load_json(manifest_path)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell_name not in cells:
        raise NoResult(f"no cell {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    mix = load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json"))
    kind = load_module(os.path.join(HERE, "traffic", f"{mix['kind']}.py"),
                       f"paxbench_kind_{mix['kind']}")
    section = "per_layer" if trace else "end_to_end"
    readers = {m["name"]: load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                                      "paxbench_metric_" + m["name"].replace(".", "_"))
               for m in metrics_for(manifest, section, cell_name)}
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoResult(f"cell {cell_name} needs {cell['chips']} CUDA device(s)")
    if not os.path.isdir(os.path.join(ROOT, "tpu_paxos_torch")):
        raise NoResult("the program (tpu_paxos_torch/) is not in this checkout")

    from tpu_paxos_torch.utils import counters

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    ctx = Context(cell_name, config, mix, seed, device)
    r = Readings(ctx)
    failed_steps = []
    t_build = time.perf_counter()
    driver = kind.build(ctx)
    t_warm = time.perf_counter()
    try:
        driver.warm()
    except Exception as exc:  # the program failed in set-up: no window
        failed_steps.append(f"set-up: {type(exc).__name__}: {exc}")
    sync()
    r.setup_s = time.perf_counter() - t_start
    print(f"set-up {r.setup_s:.3f} s: start and imports {t_build - t_start:.3f}, "
          f"program and inputs {t_warm - t_build:.3f}, warm-up {t_start + r.setup_s - t_warm:.3f}",
          file=sys.stderr)

    spans = {}
    if trace:
        for mod in (kind, *readers.values()):
            for block, targets in getattr(mod, "SPANS", {}).items():
                spans.setdefault(block, targets)
    # a planted fault stays in until the comparison is made: a broken
    # program is broken in every step the comparison reads
    planted = contextlib.ExitStack()
    if fault is not None:
        planted.enter_context(fault())
    with planted:
        dog = Watchdog()
        before = counters.snapshot()
        with spm.wrapped(spans) as timer, \
                spm.counting_syncs(trace and device != "cpu") as syncs:
            t0 = time.perf_counter()
            close = t0 + seconds
            k = 0
            try:
                while not failed_steps:
                    dog.arm(max(close, time.perf_counter()) + grace_s)
                    ts = time.perf_counter()
                    try:
                        rec = driver.step(k)
                    finally:
                        dog.disarm()
                    rec["latency_s"] = time.perf_counter() - ts
                    r.steps.append(rec)
                    k += 1
                    if time.perf_counter() >= close:
                        break
            except KeyboardInterrupt:
                if not dog.fired:
                    raise
                failed_steps.append(f"step {k}: no answer {grace_s:.0f} s past the window")
            except Exception as exc:  # a step that raises is an answer that never came
                failed_steps.append(f"step {k}: {type(exc).__name__}: {exc}")
            r.window_s = time.perf_counter() - t0
        r.counters = _counters_delta(before, counters.snapshot())
        r.blocks_ms, r.block_calls = dict(timer.ms), dict(timer.calls)
        for target in timer.missing:
            print(f"span target not found in the program: {target}", file=sys.stderr)
        r.syncs = syncs.n if trace and device != "cpu" else None

        found = forbidden_modules()
        if found:
            raise NoResult(f"loaded when the window closed: {', '.join(found)}")
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0

        for k, rec in enumerate(r.steps):
            rec["values"] = driver.values(k)
        breakdown = None
        if trace and not failed_steps:
            _launch_bytes(driver, readers, r)
            before = counters.snapshot()
            try:
                with spm.wrapped(spans, profile_ranges=True), trm.profiled(device) as box:
                    n = 0
                    t_first = time.perf_counter()
                    while True:
                        with torch.profiler.record_function("harness step"):
                            if hasattr(driver, "replay"):
                                driver.replay()
                                break
                            driver.step(len(r.steps) + n)
                        n += 1
                        if n >= TRACE_MIN_STEPS and time.perf_counter() - t_first >= 1.0:
                            break
            except Exception as exc:  # the traced run is a run: its answer never came
                failed_steps.append(f"traced run: {type(exc).__name__}: {exc}")
            else:
                r.trace_counters = _counters_delta(before, counters.snapshot())
                r.trace = trm.summarize(box["prof"], box["window_s"],
                                        list(spans) + ["harness step"])
                del box
                breakdown = {
                    "device_ops": trm.top({k: v[1] for k, v in r.trace["ops"].items()}),
                    "idle_gaps": trm.top(r.trace["gaps"]),
                }
        driver.release()
        numbers, failed, attempted = driver.check()
    failed += len(failed_steps)
    attempted += len(failed_steps)
    correct = failed == 0 and all(v <= lim for _, v, lim in numbers)

    metrics = {}
    for m in metrics_for(manifest, section, cell_name) if r.steps else ():
        value = readers[m["name"]].read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    lat = sorted(s["latency_s"] for s in r.steps)
    if lat:
        print(f"window {r.window_s:.3f} s: {len(lat)} steps, wall a step min "
              f"{lat[0]:.4f} median {lat[len(lat) // 2]:.4f} max {lat[-1]:.4f} s",
              file=sys.stderr)
        if len(lat) <= 16:
            print("wall of each step, in order: "
                  + " ".join(f"{s['latency_s']:.4f}" for s in r.steps), file=sys.stderr)
    for block, ms in sorted(r.blocks_ms.items(), key=lambda kv: -kv[1]):
        print(f"host {block}: {ms:.1f} ms in {r.block_calls[block]} calls over the window",
              file=sys.stderr)
    if trace and r.trace is not None:
        dev["busy_s"] = r.trace["busy_s"]
        dev["window_s"] = r.trace["window_s"]
    out = {"correct": correct, "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if failed_steps:
        out["errors"] = failed_steps
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in numbers}
    return out


def _launch_bytes(driver, readers, r: Readings) -> None:
    """Run the driver's replay with every reader's ``LAUNCH_HOOKS``
    installed: each hook sees a launch's operands before the program's
    function runs and returns the bytes that launch needs."""
    hooks = {}
    for mod in readers.values():
        hooks.update(getattr(mod, "LAUNCH_HOOKS", {}))
    if not hooks or not hasattr(driver, "replay"):
        return
    from paxbench.spans import resolve

    saved = []
    for target, count in hooks.items():
        try:
            owner, attr, fn = resolve(target)
        except (ImportError, AttributeError):
            continue
        seen = r.launch_bytes.setdefault(target, [])

        def hooked(*a, _fn=fn, _count=count, _seen=seen, **kw):
            _seen.append(_count(*a, **kw))
            return _fn(*a, **kw)

        saved.append((owner, attr, fn))
        setattr(owner, attr, hooked)
    try:
        driver.replay()
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def print_result(out: dict) -> None:
    """The compared numbers last on stderr, then the one JSON line."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
