"""The shard tier on the port: partition-rule coverage (SH301), per-rank
state bytes (SH302), the collective census (SH303) and the shard
certificate's lane drivers (SH304), over the mesh grid (port of
``tpu_paxos/analysis/shard_audit.py``; rules and budget machinery in
``shard_rules.py``).

- **SH301** — every leaf of each registered entry's ``shard_state()``
  (the sharded engines' global states and the tiled runners' lane-stacked
  states) must match a row of ``parallel/partition_rules.RULES`` whose
  rank fits it, checked statically over the whole tree (not only when
  ``split_tree`` first raises); a finding names the leaf's path.  On a
  full run, a rule no leaf matches is stale.
- **SH302** — per mesh shape, each rank's summed leaf bytes of the
  entry's state split through the table stay under the pinned ceiling.
  JAX pins each device's compiled peak bytes; every rank of the port's
  one-card mesh shares ``cuda:0``, so a per-device peak cannot be
  measured, and the state's split is pinned instead.
- **SH303** — per mesh shape (D = 1, 2, 4, 8 and (2, 4)), each
  ``shard_build`` entry runs once on a mesh of that shape and its rounds
  and collectives (``utils/counters``) equal the pinned counts exactly.
- **SH304** — ``shard_certificate.json`` beside this module is a byte
  copy of the JAX package's, pinned from JAX's one-device runs and
  certified over the mesh grid D in {1, 2, 4, 8}.  Each entry is one
  8-lane fleet dispatch: per lane a hex verdict nibble and the decision
  log's sha256.  The port runs the same four drivers on its lane tile
  (``FleetRunner``, the padded ``FleetRunner``, ``MemberFleetRunner`` and
  ``serve_fleet_run`` with ``mesh=``) and :func:`check_certificate` holds
  every mesh shape's result against the pinned entry, naming the first
  ``(entry, mesh, lane)`` that differs, as JAX's audit reports it.

``python -m tpu_paxos_torch audit --shard`` (or ``--shard-only``) runs
SH301-SH303 (:func:`run_shard_audit`); the certificate's drivers run
through :func:`check_certificate` (the shard tests and the card's phase
20).
"""

from __future__ import annotations

import json
import os

#: The committed certificate (a byte copy of JAX's).
DEFAULT_CERT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "shard_certificate.json")

#: The mesh shapes the port holds: ``(ranks, dcn_hosts)``, JAX's grid and
#: the 2-D ``(2, 4)`` layout.
SHAPES = ((1, 1), (2, 1), (4, 1), (8, 1), (8, 2))


def drivers() -> dict:
    """The certificate's entries by name: ``fn(n_devices, dcn_hosts=,
    device=) -> {"verdicts", "lane_logs"}``."""
    from tpu_paxos_torch.fleet import member_runner as mrun
    from tpu_paxos_torch.fleet import runner as frun
    from tpu_paxos_torch.serve import fleet as sflt

    return {
        "fleet.run_lanes": frun.shard_parity,
        "fleet.run_lanes_envelope": frun.shard_parity_envelope,
        "member.fleet_lanes": mrun.shard_parity,
        "serve.fleet_window": sflt.shard_parity,
    }


def load_certificate(path: str = DEFAULT_CERT) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def shape_name(shape) -> str:
    """``"8"`` for an 8-rank ``("i",)`` mesh, ``"2x4"`` for ``(2, 4)``."""
    n, hosts = shape
    return str(n) if hosts <= 1 else f"{hosts}x{n // hosts}"


def first_divergence(ref: dict, got: dict):
    """First lane where two parity results disagree, ``(lane, detail)``,
    or None (JAX's ``shard_rules.first_divergence``)."""
    rv, gv = ref["verdicts"], got["verdicts"]
    rl, gl = list(ref["lane_logs"]), list(got["lane_logs"])
    for i in range(max(len(rv), len(gv), len(rl), len(gl))):
        a = rv[i] if i < len(rv) else "?"
        b = gv[i] if i < len(gv) else "?"
        if a != b:
            return i, f"verdict nibble {a!r} != {b!r}"
        la = rl[i] if i < len(rl) else "?"
        lb = gl[i] if i < len(gl) else "?"
        if la != lb:
            return i, f"decision-log sha256 {la[:12]}... != {lb[:12]}..."
    return None


def check_certificate(shapes=SHAPES, device="cuda", entries=None, path: str = DEFAULT_CERT,
                      results: dict | None = None) -> list[dict]:
    """Run each driver (``entries``: names, default all four) at every
    mesh shape of ``shapes`` on ``device`` and hold it against the pinned
    certificate; returns the failures, one a diverging (entry, mesh)
    naming its first lane (empty: every lane of every shape equals the
    pin).  ``results``, when given, collects ``{entry: {shape: record}}``."""
    pinned = load_certificate(path)["entries"]
    fns = drivers()
    failures = []
    for name in entries or sorted(fns):
        if name not in pinned:
            failures.append({"entry": name, "mesh": None, "lane": None,
                             "detail": f"entry {name} has no pinned parity certificate"})
            continue
        for shape in shapes:
            got = fns[name](shape[0], dcn_hosts=shape[1], device=device)
            if results is not None:
                results.setdefault(name, {})[shape_name(shape)] = got
            div = first_divergence(pinned[name], got)
            if div is not None:
                lane, detail = div
                failures.append({
                    "entry": name, "mesh": shape_name(shape), "lane": lane,
                    "detail": f"entry {name}: mesh {shape_name(shape)} diverges from the "
                              f"certificate at lane {lane} ({detail})",
                })
    return failures


# ---------------- SH301-SH303 ----------------

def run_shard_audit(providers=None, device="cuda", budget_path: str | None = None,
                    pin_budget: bool = False, triage_dir: str = "stress-triage",
                    shapes=SHAPES, extra_states: dict | None = None) -> dict:
    """SH301-SH303 over the registered entries on ``device``: a JSON-ready
    report, ``ok`` iff coverage is clean and the budget holds (or is being
    pinned).  ``extra_states`` adds ``{name: (family, tree)}`` to the
    coverage check (a seeded breach)."""
    from tpu_paxos_torch.analysis import registry as regm
    from tpu_paxos_torch.analysis import shard_rules as shr
    from tpu_paxos_torch.analysis import triage
    from tpu_paxos_torch.parallel import mesh as pmesh
    from tpu_paxos_torch.parallel import partition_rules as prules
    from tpu_paxos_torch.utils import counters

    providers = tuple(providers or regm.AUDIT_PROVIDERS)
    full = providers == tuple(regm.AUDIT_PROVIDERS) and tuple(shapes) == tuple(SHAPES)
    entries = regm.collect(providers)
    trees = {e.name: e.shard_state() for e in entries if e.shard_state is not None}
    trees.update(extra_states or {})
    cov = prules.coverage(trees)
    if not full:
        cov["stale_rules"] = []  # a scoped run never sees every family
    measured: dict = {}
    for e in entries:
        if e.shard_state is None and e.shard_build is None:
            continue
        per_mesh = measured.setdefault(e.name, {})
        for shape in shapes:
            n, hosts = shape
            cell = per_mesh.setdefault(shape_name(shape), {})
            if e.shard_state is not None and e.name not in (extra_states or {}):
                family, tree = e.shard_state(n)
                cell["bytes_per_rank"] = max(prules.rank_bytes(family, tree, n))
            if e.shard_build is not None:
                fn, args = e.shard_build(pmesh.make_instance_mesh(n, dcn_hosts=hosts,
                                                                  device=device))
                counters.reset()
                fn(*args)
                snap = counters.snapshot()
                cell["rounds"], cell["collectives"] = snap["rounds"], snap["collectives"]
    violations: list[dict] = []
    stale: list[str] = []
    if pin_budget:
        shr.save_budget(measured, budget_path or shr.DEFAULT_BUDGET)
    elif budget_path:
        violations, stale = shr.check_budget(measured, shr.load_budget(budget_path), full)
    dumped = []
    for name in sorted({v["entry"] for v in violations}):
        try:
            dumped.append(triage.write_dump(triage_dir, "shard", name,
                                            json.dumps(measured[name], indent=1,
                                                       sort_keys=True), ext="json"))
        except OSError:
            pass  # a read-only checkout must not mask the breach
    coverage_bad = bool(cov["unmatched"] or cov["rank"] or cov["stale_rules"])
    return {
        "version": 1,
        "grid": [shape_name(x) for x in shapes],
        "coverage": cov,
        "measured": measured,
        "budget": {"path": budget_path or "", "pinned": bool(pin_budget),
                   "violations": violations, "stale": stale},
        "dumped": sorted(dumped),
        "ok": not coverage_bad and not violations and not stale,
    }


def print_report(sreport: dict, pinned: bool) -> None:
    """Human-readable epilogue of :func:`run_shard_audit`."""
    cov = sreport["coverage"]
    for u in cov["unmatched"]:
        print(f"shard SH301: no committed partition rule matches leaf {u['path']} "
              f"(entry {u['entry']}, shape {u['shape']}) — an unruled leaf would "
              "silently replicate; add a rule to parallel/partition_rules.py")
    for r in cov["rank"]:
        print(f"shard SH301: rule {r['rule']!r} matched {r['path']} but {r['detail']} "
              f"(entry {r['entry']})")
    for s in cov["stale_rules"]:
        print(f"shard SH301: stale rule {s['rule']!r} (row {s['index']}) matches no "
              "registered state leaf")
    for name, per_mesh in sorted(sreport["measured"].items()):
        cells = []
        for mesh, m in sorted(per_mesh.items()):
            part = [f"mesh {mesh}:"]
            if "bytes_per_rank" in m:
                part.append(f"{m['bytes_per_rank']} B/rank")
            if "rounds" in m:
                part.append(f"{m['collectives']} collectives/{m['rounds']} rounds")
            cells.append(" ".join(part))
        print(f"shard {name}: " + "; ".join(cells))
    for v in sreport["budget"]["violations"]:
        print(f"shard budget {v['rule']}: {v['detail']}")
    for s in sreport["budget"]["stale"]:
        print(f"shard budget: stale cell {s} — no longer measured; re-pin shard_budget.json")
    if pinned:
        print(f"shard budget pinned over grid {sreport['grid']}")
    n_cov = len(cov["unmatched"]) + len(cov["rank"]) + len(cov["stale_rules"])
    print(
        f"shard-audit: grid {sreport['grid']}, {cov['leaves']} state leaves / "
        f"{cov['rules']} rules, {n_cov} coverage problems, "
        f"{len(sreport['budget']['violations'])} budget violations"
    )
