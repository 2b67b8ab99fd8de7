"""The port's audit: per-round contracts of every registered entry point,
pinned budgets, and the unregistered-surface sweep.

It replaces the JAX package's IR tiers (``jaxpr_audit.py``,
``ir_rules.py``, ``hlo_audit.py``, ``hlo_norm.py``).  Those read XLA's
IR; the port has none, and the contract they enforced (an engine's
per-round work does not grow unnoticed) is measured here on the run
itself.  ``python -m tpu_paxos_torch audit`` runs every registered entry
(``analysis/registry.py``: the 28 entry names of JAX's
``op_budget.json``) once, as its ``build(device)`` gives it, and counts
(``utils/counters``):

- (a) the calls a round of each hand kernel, at the dispatchers
  (``core/simkern.store_accepts`` / ``accum_acks`` and the windows of
  ``core/fastwin.steady_state_windows_fused``), so the CPU's plain
  versions and the card's kernels give the same count (a round with no
  eligible accept skips the store on both);
- (b) the port's designed host reads a round (the round's packed
  predicate reads, ``core/sim._any`` / ``_global_max``, the loop's
  done/round read, the member round's ``_host``, ...), the same on both
  devices;
- (c) the collectives a round of the mesh entries
  (``parallel/mesh.Collectives.exchange``, summed over ranks);
- (d) on a card only: the host syncs of the whole call, counted by
  torch's sync debug mode (global to the process, so a mesh entry's
  thread ranks count together, over the whole ``Mesh.run``), and the
  kernel launches (the wrappers' own counts: ``core/simkern.LAUNCHES``
  through a ``simkern.counting`` block, into which a mesh run adds its
  ranks' launches, and ``core/fastwin.LAUNCHES``), which must equal (a).

(b) counts the read sites the port placed on purpose, not reads: a new
``.item()`` in a round moves no count on the CPU.  The card's syncs count
every synchronizing call, so (d) is what catches it.

A round is one call of a round function over its lanes (a rank's call
counts once for the rank); an entry that runs no round (one kernel call,
the fast path) counts per call.  The run's rounds are data, the same on
every device, and are pinned with the counts.

**Budget** (``analysis/launch_budget.json``): (a)-(c) and the rounds are
pinned EXACTLY from a CPU run (both directions fail: a kernel call or a
read that disappears is as much a change of the program as one that
appears), with the entry and the delta named; the ``cuda`` section pins
(d)'s syncs from a card run with a cap a round: syncs may exceed the
pinned count by at most ``SYNC_SLACK`` a round, rounded down (nothing
for an entry of one round or one call), so one extra sync a round fails
every entry.  ``--pin`` re-pins from the run: on the CPU the exact
section, on a card the ``cuda`` section (the exact section is still
checked).  A full-registry run calls pins of names no
longer registered stale.  A breach dumps the entry's measured counts to
``--triage-dir`` (``analysis/triage.py``'s ``audit_`` namespace).

**Sweep** (static, torch-free): every function of a provider file that
launches a hand kernel (calls a ``*_cuda`` wrapper or ``kbuild.load``)
or enters a mesh run (``<mesh>.run``, ``on_lanes``) must be named by
some entry's ``covers`` or by the module's ``AUDIT_EXEMPT``: a new
launching surface must opt in.

The default device is the card (``--device cuda``); the tests run
``--device cpu``.  ``--shard`` / ``--shard-only`` add the shard tier
(``analysis/shard_audit.py``).
"""

from __future__ import annotations

import ast
import json
import os

from tpu_paxos_torch.analysis import lint
from tpu_paxos_torch.analysis import registry as regm
from tpu_paxos_torch.utils.counters import KERNELS

DEFAULT_BUDGET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "launch_budget.json")

#: Default triage dir — shared with the stress sweep's repro artifacts.
DEFAULT_TRIAGE_DIR = "stress-triage"

#: The counts pinned exactly, from a CPU run.
EXACT = ("rounds", *KERNELS, "host_reads", "collectives")

#: The ``cuda`` section's slack: host syncs a round over the pinned count
#: (three card runs of every entry gave the same counts).
SYNC_SLACK = 0.5

#: Rule ids -> one-line contracts (``--rules``).
RULES = {
    "AU401": "kernel calls a round of every entry equal the pinned "
             "count exactly (a call that appears or vanishes fails)",
    "AU402": "designed host reads a round of every entry equal the "
             "pinned count exactly",
    "AU403": "collectives a round of every entry equal the pinned "
             "count exactly (non-mesh entries pin 0)",
    "AU404": "on a card, host syncs of every entry stay within the "
             "cuda section's cap (the pinned count + 0.5 a round)",
    "AU405": "on a card, kernel launches of every entry equal its "
             "kernel calls, kernel by kernel",
    "AU406": "every launching surface of a provider file (a *_cuda "
             "call, kbuild.load, <mesh>.run, on_lanes) is named by an "
             "entry's covers or the module's AUDIT_EXEMPT",
}


# ---------------- unregistered-surface sweep (static) ----------------

def _is_launching_call(node: ast.Call) -> bool:
    """A call that launches a hand kernel or enters a mesh run."""
    name = lint.call_name(node)
    last = name.rsplit(".", 1)[-1]
    if last.endswith("_cuda") or last == "on_lanes":
        return True
    if name == "kbuild.load" or name.endswith(".kbuild.load"):
        return True
    if isinstance(node.func, ast.Attribute) and node.func.attr == "run":
        base = lint.call_name(node.func.value).rsplit(".", 1)[-1].lower()
        return "mesh" in base
    return False


def _surface_name(node: ast.AST) -> str:
    """Qualname of the function containing ``node`` (``Class.method``,
    ``outer.inner``), or ``<module>``."""
    parts: list[str] = []
    cur = getattr(node, "paxlint_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            parts.append(cur.name)
        cur = getattr(cur, "paxlint_parent", None)
    return ".".join(reversed(parts)) if parts else "<module>"


def sweep_module(path: str) -> set[str]:
    """Launching-surface names in one provider file."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    lint.attach_parents(tree)
    return {
        _surface_name(node) for node in ast.walk(tree)
        if isinstance(node, ast.Call) and _is_launching_call(node)
    }


def run_sweep(providers=regm.AUDIT_PROVIDERS, root: str | None = None) -> list[dict]:
    """Cross-check each provider's launching surfaces against its own
    entries' ``covers`` and its ``AUDIT_EXEMPT`` (coverage is per module:
    a name covered in one module never covers a same-named surface of
    another).  Returns problem dicts (empty = clean)."""
    problems: list[dict] = []

    def is_covered(surface: str, names) -> bool:
        # covering "build_runner" also covers its nested "build_runner.fn"
        return any(surface == n or surface.startswith(n + ".") for n in names)

    root = root or os.getcwd()
    for modname in providers:
        mod = regm.provider_module(modname)
        path = getattr(mod, "__file__", None)
        if not path or not os.path.exists(path):
            problems.append({
                "kind": "missing_provider_file", "module": modname,
                "detail": f"no source file for provider {modname}",
            })
            continue
        relpath = os.path.relpath(path, root).replace(os.sep, "/")
        exempt = set(regm.exemptions(mod))
        prov = getattr(mod, "audit_entries", None)
        covered: set[str] = set()
        if prov is not None:
            for e in prov():
                covered.update(e.covers)
        surfaces = sweep_module(path)
        for s in sorted(x for x in surfaces
                        if not is_covered(x, covered) and not is_covered(x, exempt)):
            problems.append({
                "kind": "unregistered_surface", "module": modname, "surface": s,
                "detail": (
                    f"launching surface `{s}` in {relpath} is not named by "
                    "this module's AuditEntry.covers nor AUDIT_EXEMPT — "
                    "register an entry for it (analysis/registry.py)"
                ),
            })
        for s in sorted(covered & exempt):
            problems.append({
                "kind": "double_booked_surface", "module": modname, "surface": s,
                "detail": f"`{s}` is both covered and exempt — drop one",
            })
    return problems


# ---------------- measuring ----------------

def measure(entry, device: str = "cuda") -> dict:
    """Run ``entry`` once on ``device`` and count what the call did:
    ``{"rounds", <kernel calls>, "host_reads", "collectives"}`` and, on a
    card, ``"syncs"`` and ``"launches"`` (per kernel)."""
    import time

    import torch

    from tpu_paxos_torch.core import fastwin, simkern
    from tpu_paxos_torch.utils import counters
    from tpu_paxos_torch.utils import device as devm

    dev = devm.resolve(device)
    fn, args = entry.build(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    counters.reset()
    t0 = time.perf_counter()
    if cuda:
        launches = {k: 0 for k in simkern.LAUNCHES}
        windows = fastwin.LAUNCHES["steady_state_windows"]
        with devm.counting_syncs() as syncs, simkern.counting(launches):
            fn(*args)
        torch.cuda.synchronize()
        launches["steady_state_windows"] = fastwin.LAUNCHES["steady_state_windows"] - windows
    else:
        fn(*args)
    seconds = time.perf_counter() - t0
    snap = counters.snapshot()
    out = {k: int(snap[k]) for k in EXACT}
    if cuda:
        out["syncs"] = int(syncs.n)
        out["launches"] = {k: int(launches[k]) for k in KERNELS}
    out["seconds"] = round(seconds, 4)
    return out


def per_round(m: dict) -> dict:
    """The counts a round (a call, for an entry that runs no round)."""
    unit = max(int(m["rounds"]), 1)
    out = {k: round(m[k] / unit, 4) for k in (*KERNELS, "host_reads", "collectives")}
    if "syncs" in m:
        out["syncs"] = round(m["syncs"] / unit, 4)
        out["launches"] = {k: round(v / unit, 4) for k, v in m["launches"].items()}
    return out


# ---------------- budget ----------------

def load_budget(path: str = DEFAULT_BUDGET) -> dict:
    if not path or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _cap(m: dict) -> int:
    """The sync cap of a measured entry: its syncs + ``SYNC_SLACK`` a
    round, rounded down."""
    return int(m["syncs"]) + int(SYNC_SLACK * max(int(m["rounds"]), 1))


def save_budget(measured: dict, path: str, device: str, card: str = "",
                keep: dict | None = None) -> dict:
    """Pin ``measured``: on the CPU the exact section (``keep`` carries
    entries a scoped run did not measure), on a card the ``cuda``
    section's sync caps; the other section is kept as it is."""
    data = load_budget(path) or {"version": 1, "entries": {}}
    data["version"] = 1
    data["_workflow"] = (
        "entries: rounds, kernel calls, host reads and collectives of each "
        "entry's canonical run, pinned exactly from `python -m "
        "tpu_paxos_torch audit --device cpu --pin`; cuda: the syncs' caps "
        "(the measured syncs + int(slack_per_round * max(rounds, 1))), pinned "
        "on the card with `audit --device cuda --pin`."
    )
    if device == "cpu":
        entries = dict(keep or {})
        entries.update({name: {k: int(m[k]) for k in EXACT} for name, m in sorted(measured.items())})
        data["entries"] = dict(sorted(entries.items()))
    else:
        sec = data.get("cuda") or {}
        caps = dict(sec.get("entries", {}) if keep is not None else {})
        caps.update({name: {"syncs": _cap(m), "syncs_measured": int(m["syncs"])}
                     for name, m in sorted(measured.items())})
        data["cuda"] = {"card": card, "slack_per_round": SYNC_SLACK,
                        "entries": dict(sorted(caps.items()))}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return data


def check_budget(measured: dict, budget: dict, cuda: bool,
                 check_syncs: bool = True) -> tuple[list[dict], list[str]]:
    """-> (violations, stale).  Every measured entry must be pinned, its
    exact counts equal (AU401-AU403; the rounds too), and on a card its
    launches equal its calls (AU405) and its syncs under the cap (AU404).
    Pinned names no measured entry has are stale (the caller judges only
    full-registry runs)."""
    entries = budget.get("entries", {})
    cuda_caps = (budget.get("cuda") or {}).get("entries", {})
    rule = {"host_reads": "AU402", "collectives": "AU403"}
    violations: list[dict] = []
    for name in sorted(measured):
        m = measured[name]
        pinned = entries.get(name)
        if pinned is None:
            violations.append({
                "entry": name, "key": "budget", "rule": "AU401", "measured": None, "cap": None,
                "detail": f"entry {name} has no pinned launch budget — re-pin "
                          "launch_budget.json (audit --device cpu --pin)",
            })
        else:
            for k in EXACT:
                got, want = int(m[k]), int(pinned.get(k, 0))
                if got != want:
                    unit = max(int(m["rounds"]), 1)
                    violations.append({
                        "entry": name, "key": k, "rule": rule.get(k, "AU401"),
                        "measured": got, "cap": want,
                        "detail": (
                            f"entry {name}: {got} {k} ({got / unit:.4g} a round) != pinned "
                            f"{want} ({got - want:+d}) — the run's per-round work "
                            "changed; if intentional, re-pin launch_budget.json "
                            "(audit --device cpu --pin)"
                        ),
                    })
        if not cuda:
            continue
        for k in KERNELS:
            calls, launches = int(m[k]), int(m["launches"][k])
            if calls != launches:
                violations.append({
                    "entry": name, "key": f"{k}_launches", "rule": "AU405",
                    "measured": launches, "cap": calls,
                    "detail": (
                        f"entry {name}: {launches} {k} launches != {calls} calls "
                        f"({launches - calls:+d}) — a call ran its plain version, or "
                        "a launch bypassed the dispatcher"
                    ),
                })
        if not check_syncs:
            continue
        cap = cuda_caps.get(name)
        if cap is None:
            violations.append({
                "entry": name, "key": "syncs", "rule": "AU404", "measured": m["syncs"],
                "cap": None,
                "detail": f"entry {name} has no pinned cuda sync cap — pin it on the "
                          "card (audit --device cuda --pin)",
            })
        elif int(m["syncs"]) > int(cap["syncs"]):
            unit = max(int(m["rounds"]), 1)
            over = int(m["syncs"]) - int(cap["syncs_measured"])
            violations.append({
                "entry": name, "key": "syncs", "rule": "AU404",
                "measured": int(m["syncs"]), "cap": int(cap["syncs"]),
                "detail": (
                    f"entry {name}: {m['syncs']} host syncs > cap {cap['syncs']}; "
                    f"pinned {cap['syncs_measured']} ({over:+d}, {over / unit:+.4g} a "
                    "round) — the run waits for the card more often; if "
                    "intentional, re-pin on the card"
                ),
            })
    stale = [n for n in sorted(entries) if n not in measured]
    if cuda:
        stale += [f"cuda:{n}" for n in sorted(cuda_caps) if n not in measured]
    return violations, stale


def _card() -> str:
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=30)
        return p.stdout.strip().splitlines()[0] if p.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


# ---------------- the audit ----------------

def run_audit(
    providers=regm.AUDIT_PROVIDERS,
    device: str = "cuda",
    budget_path: str | None = DEFAULT_BUDGET,
    pin: bool = False,
    triage_dir: str = DEFAULT_TRIAGE_DIR,
    root: str | None = None,
) -> dict:
    """The audit as a JSON-ready report dict.  ``ok`` iff the sweep is
    clean and every entry meets its budget (or ``budget_path=None`` /
    ``pin=True``)."""
    from tpu_paxos_torch.utils import device as devm

    dev = devm.resolve(device)
    cuda = dev.type == "cuda"
    if cuda:
        # the kernels build before any entry is measured: a build is not
        # a round's work
        from tpu_paxos_torch.core import fastwin, simkern

        simkern.load()
        fastwin.load()
    measured = {e.name: measure(e, str(dev)) for e in regm.collect(providers)}
    sweep = run_sweep(providers, root=root)
    full = tuple(providers) == tuple(regm.AUDIT_PROVIDERS)
    violations: list[dict] = []
    stale: list[str] = []
    dumped: list[str] = []
    if pin:
        path = budget_path or DEFAULT_BUDGET
        keep = None
        if not full:
            existing = load_budget(path)
            keep = {} if cuda else {
                n: v for n, v in sorted(existing.get("entries", {}).items()) if n not in measured}
        save_budget(measured, path, "cuda" if cuda else "cpu",
                    card=_card() if cuda else "", keep=keep)
        if cuda:
            # the exact section still holds on the card
            violations, _ = check_budget(measured, load_budget(path), cuda=True,
                                         check_syncs=False)
    elif budget_path:
        violations, stale = check_budget(measured, load_budget(budget_path), cuda=cuda)
        if not full:
            stale = []
    if violations:
        from tpu_paxos_torch.analysis import triage

        for name in sorted({v["entry"] for v in violations}):
            try:
                dumped.append(triage.write_dump(
                    triage_dir, "audit", name,
                    json.dumps(measured[name], indent=1, sort_keys=True), ext="json"))
            except OSError:
                pass  # a read-only checkout must not mask the breach
    return {
        "version": 1,
        "device": dev.type,
        "entries": {
            name: dict(m, per_round=per_round(m)) for name, m in sorted(measured.items())
        },
        "sweep": sweep,
        "budget": {
            "path": budget_path or "",
            "pinned": bool(pin),
            "violations": violations,
            "stale": stale,
            "dumped": sorted(set(dumped)),
        },
        "ok": not sweep and not violations and not stale,
    }


# ---------------- CLI ----------------

def _load_provider_arg(spec: str) -> tuple[str, ...]:
    """--providers: comma-separated module names, or a path to a .py file
    (loaded as a one-off module: the fixture path)."""
    import importlib.util
    import sys

    names = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if item.endswith(".py") or os.sep in item:
            modname = "_audit_fixture_" + os.path.basename(item)[:-3]
            s = importlib.util.spec_from_file_location(modname, item)
            if s is None or s.loader is None:
                raise FileNotFoundError(f"audit provider not found: {item}")
            mod = importlib.util.module_from_spec(s)
            sys.modules[modname] = mod
            s.loader.exec_module(mod)
            names.append(modname)
        else:
            names.append(item)
    return tuple(names)


def _print_report(report: dict, pinned: bool, budget: str) -> None:
    for name, m in sorted(report["entries"].items()):
        pr = m["per_round"]
        line = (
            f"{name}: {m['rounds']} rounds; a round: calls store_accepts={pr['store_accepts']:g} "
            f"accum_acks={pr['accum_acks']:g} windows={pr['steady_state_windows']:g}, "
            f"host reads {pr['host_reads']:g}, collectives {pr['collectives']:g}"
        )
        if "syncs" in pr:
            la = pr["launches"]
            line += (f", syncs {pr['syncs']:g}, launches store_accepts={la['store_accepts']:g} "
                     f"accum_acks={la['accum_acks']:g} windows={la['steady_state_windows']:g}")
        print(line + f" ({m['seconds']:.3f} s)")
    for p in report["sweep"]:
        print(f"sweep: {p['detail']}")
    for v in report["budget"]["violations"]:
        print(f"budget {v['rule']}: {v['detail']}")
    for d in report["budget"]["dumped"]:
        print(f"    counts dumped: {d}")
    for s in report["budget"]["stale"]:
        print(f"budget: stale entry {s} — no longer registered; re-pin launch_budget.json")
    if pinned:
        print(f"launch budget pinned to {budget} ({len(report['entries'])} entries, "
              f"device {report['device']})")
    print(
        f"audit: {len(report['entries'])} entry points on {report['device']}, "
        f"{len(report['sweep'])} sweep problems, "
        f"{len(report['budget']['violations'])} budget violations"
    )


def main(argv=None) -> int:
    """``python -m tpu_paxos_torch audit`` — exits 0 iff the sweep is clean
    and every entry meets its pinned per-round budget."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m tpu_paxos_torch audit",
        description="the port's audit: kernel calls, host reads, collectives "
                    "(and on a card syncs and launches) a round of every "
                    "registered entry point, against the pinned budget",
    )
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", action="store_true", help="JSON report on stdout")
    ap.add_argument("--list", action="store_true",
                    help="list the registered entry points and exit")
    ap.add_argument("--rules", action="store_true", help="list the rule ids and exit")
    ap.add_argument("--budget", default=DEFAULT_BUDGET, help="launch budget file")
    ap.add_argument("--no-budget", action="store_true",
                    help="skip budget enforcement (sweep only)")
    ap.add_argument("--pin", action="store_true",
                    help="re-pin the budget from this run (the exact section on the "
                         "CPU, the cuda section on a card); commit the diff")
    ap.add_argument("--providers", default="",
                    help="comma-separated provider modules or a .py path "
                         "(default: the registry)")
    ap.add_argument("--triage-dir", default=DEFAULT_TRIAGE_DIR,
                    help="where a breaching entry's counts are dumped")
    ap.add_argument("--shard", action="store_true",
                    help="also run the shard tier (analysis/shard_audit.py)")
    ap.add_argument("--shard-only", action="store_true", help="run ONLY the shard tier")
    ap.add_argument("--shard-budget", default=None,
                    help="shard budget file (default: analysis/shard_budget.json)")
    ap.add_argument("--pin-shard", action="store_true",
                    help="re-pin the shard budget from this run")
    args = ap.parse_args(argv)

    if args.rules:
        from tpu_paxos_torch.analysis import shard_rules as shr

        for rid, doc in sorted({**RULES, **shr.RULES}.items()):
            print(f"{rid}  {doc}")
        return 0
    try:
        providers = (_load_provider_arg(args.providers) if args.providers
                     else regm.AUDIT_PROVIDERS)
    except FileNotFoundError as e:
        print(f"audit: {e}")
        return 2
    if args.list:
        for e in regm.collect(providers):
            extra = " shard" if e.shard_build is not None or e.shard_state is not None else ""
            print(f"{e.name:<28s} covers={','.join(e.covers) or '-'}{extra}")
        return 0
    report = sreport = None
    try:
        if not args.shard_only:
            report = run_audit(
                providers=providers, device=args.device,
                budget_path=None if args.no_budget else args.budget,
                pin=args.pin and not args.no_budget, triage_dir=args.triage_dir,
            )
        if args.shard or args.shard_only:
            from tpu_paxos_torch.analysis import shard_audit
            from tpu_paxos_torch.analysis import shard_rules as shr

            sreport = shard_audit.run_shard_audit(
                providers=providers, device=args.device,
                budget_path=None if args.no_budget else (args.shard_budget
                                                         or shr.DEFAULT_BUDGET),
                pin_budget=args.pin_shard, triage_dir=args.triage_dir,
            )
    except regm.RegistryError as e:
        print(f"audit: {e}")
        return 2
    if report is None:
        report = {"ok": True}
    out = dict(report)
    if sreport is not None:
        out["shard"] = sreport
        out["ok"] = report["ok"] and sreport["ok"]
    if args.json:
        print(json.dumps(out, indent=1, sort_keys=True))
    else:
        if "entries" in report:
            _print_report(report, args.pin, args.budget)
        if sreport is not None:
            from tpu_paxos_torch.analysis import shard_audit

            shard_audit.print_report(sreport, args.pin_shard)
    return 0 if out["ok"] else 1
