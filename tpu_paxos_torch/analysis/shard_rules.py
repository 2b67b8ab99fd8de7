"""The shard tier's contracts and budget machinery on the port (the
counterpart of ``tpu_paxos/analysis/shard_rules.py``; pure stdlib).

The running half lives in ``shard_audit.py``; the committed partition
table is ``parallel/partition_rules.py``.  Budget semantics follow
JAX's:

- **Collective counts are pinned EXACT, per mesh shape** (SH303): the
  port's SPMD story is "lanes are independent; the only collectives are
  the sharded engines' reductions", so a count that moves in either
  direction fails, naming (entry, mesh, count).  A lane tile pins 0.
- **Per-rank bytes get headroom** (SH302), per mesh shape: the tile's
  point is that a rank's bytes FALL as the mesh grows, and a flat curve
  (replication creep) breaches the larger shapes' ceilings.  JAX pins
  each device's compiled peak bytes; on one card every rank shares
  ``cuda:0``, so no per-device peak is measurable, and the port pins
  each rank's summed state-leaf bytes (the partition table's split of
  the entry's ``shard_state``) instead.  That sees replication of the
  state and nothing of transient buffers.
"""

from __future__ import annotations

import json
import os

#: Rule ids -> one-line contracts (``--rules``).
RULES = {
    "SH301": "every leaf of every registered shard_state tree matches a "
             "committed partition rule (parallel/partition_rules.py), "
             "named by its path, and every rule matches some leaf",
    "SH302": "each rank's summed state-leaf bytes of every shard_state "
             "entry stay under the per-mesh-shape ceilings pinned in "
             "analysis/shard_budget.json",
    "SH303": "the collectives a round of every shard_build entry equal "
             "the per-mesh-shape counts pinned in analysis/shard_budget.json "
             "— exact, both directions",
    "SH304": "per-lane verdict nibbles + decision-log sha256 of the fleet "
             "drivers match analysis/shard_certificate.json at every mesh "
             "shape (shard_audit.check_certificate)",
}

DEFAULT_BUDGET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "shard_budget.json")

#: Per-rank bytes caps (JAX's memory pair).
MEM_HEADROOM, MEM_SLACK = 0.3, 4096


def load_budget(path: str = DEFAULT_BUDGET) -> dict:
    if not path or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def save_budget(measured: dict, path: str) -> dict:
    """Pin ``measured`` = ``{entry: {mesh: {"bytes_per_rank"?, "rounds"?,
    "collectives"?}}}``: bytes with headroom, rounds and collectives
    exact."""
    entries = {}
    for name, per_mesh in sorted(measured.items()):
        entries[name] = {}
        for mesh, m in sorted(per_mesh.items()):
            cell = {}
            if "bytes_per_rank" in m:
                cell["bytes_per_rank"] = int(m["bytes_per_rank"] * (1 + MEM_HEADROOM)) + MEM_SLACK
            for k in ("rounds", "collectives"):
                if k in m:
                    cell[k] = int(m[k])
            entries[name][mesh] = cell
    data = {
        "version": 1,
        "_workflow": "per entry and mesh shape: a rank's summed state-leaf bytes "
                     "(capped with headroom), and the rounds and collectives of the "
                     "shard_build run (exact); re-pin with `python -m tpu_paxos_torch "
                     "audit --shard-only --device cpu --pin-shard`.",
        "mem_headroom": MEM_HEADROOM,
        "mem_slack": MEM_SLACK,
        "entries": entries,
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return data


def check_budget(measured: dict, budget: dict, full: bool) -> tuple[list[dict], list[str]]:
    """-> (violations, stale).  Unpinned cells are violations; on a full
    run, pinned cells no longer measured are stale."""
    entries = budget.get("entries", {})
    violations: list[dict] = []
    for name in sorted(measured):
        for mesh in sorted(measured[name]):
            m = measured[name][mesh]
            caps = entries.get(name, {}).get(mesh)
            if caps is None:
                violations.append({
                    "entry": name, "mesh": mesh, "key": "budget", "rule": "SH302",
                    "measured": None, "cap": None,
                    "detail": f"entry {name} mesh {mesh} has no pinned shard budget — "
                              "re-pin shard_budget.json (audit --shard-only --pin-shard)",
                })
                continue
            if "bytes_per_rank" in m:
                got, cap = int(m["bytes_per_rank"]), int(caps.get("bytes_per_rank", 0))
                if got > cap:
                    violations.append({
                        "entry": name, "mesh": mesh, "key": "bytes_per_rank", "rule": "SH302",
                        "measured": got, "cap": cap,
                        "detail": (
                            f"entry {name} mesh {mesh}: {got} bytes a rank > ceiling {cap} "
                            f"(+{got - cap}) — replication creep: state that should split "
                            "over the mesh is copied to every rank"
                        ),
                    })
            for k in ("rounds", "collectives"):
                if k not in m:
                    continue
                got, want = int(m[k]), int(caps.get(k, 0))
                if got != want:
                    violations.append({
                        "entry": name, "mesh": mesh, "key": k, "rule": "SH303",
                        "measured": got, "cap": want,
                        "detail": (
                            f"entry {name} mesh {mesh}: {got} {k}, budget declares exactly "
                            f"{want} ({got - want:+d}) — an undeclared collective (or a "
                            "vanished one: the tile may have stopped spanning the mesh)"
                        ),
                    })
    stale: list[str] = []
    if full:
        for name in sorted(entries):
            for mesh in sorted(entries[name]):
                if mesh not in measured.get(name, {}):
                    stale.append(f"{name}@mesh{mesh}")
    return violations, stale
