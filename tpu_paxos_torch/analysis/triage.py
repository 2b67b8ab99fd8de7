"""The port's own copy of ``tpu_paxos/analysis/triage.py`` (stdlib only):
bounded, deterministic breach-artifact dumps (stress-triage/).

Both analysis tiers dump diffable artifacts on a breach — jaxpr text
(IR205 / op-budget breaches, ``jaxpr_audit.dump_jaxpr``) and now HLO
golden diffs (``hlo_audit``).  Two contracts, pinned by test:

- **Stable deterministic filenames**: the name is a pure function of
  the entry name and artifact kind (no timestamps, no counters), so a
  repeated ``make audit`` *overwrites* its own dumps instead of
  accumulating, and a test can assert the exact path.
- **Retention cap**: the analysis-dump namespace (``jaxpr_*`` /
  ``hlo_*`` / ``mc_*`` files) is pruned oldest-first past :data:`RETENTION_CAP`
  files after every write, so a long-lived checkout's triage dir stays
  bounded even as entries come and go across PRs.  Repro artifacts
  from the stress sweep share the directory but NOT the namespace —
  pruning never touches them.

Pure stdlib; the tiers call :func:`write_dump`.
"""

from __future__ import annotations

import os
import re

#: Max analysis-dump files kept per triage dir (oldest pruned first).
RETENTION_CAP = 32

#: Filename prefixes owned by the analysis tiers — the pruning
#: namespace: the audit's breach dumps (``audit_``; ``jaxpr_``/``hlo_``
#: name the JAX package's) plus the model checker's
#: ``mc_scenario_<index>`` counterexample artifacts
#: (analysis/modelcheck.py), whose deterministic scenario-index names
#: make repeat runs overwrite.  Stress-sweep repro artifacts
#: (``repro_*``) never match.
DUMP_PREFIXES = ("jaxpr_", "hlo_", "mc_", "shard_", "audit_")

_SAFE = re.compile(r"[^A-Za-z0-9_]")


def dump_name(kind: str, entry: str, ext: str = "txt") -> str:
    """Deterministic artifact filename: ``<kind>_<entry>.<ext>`` with
    the entry name flattened to ``[A-Za-z0-9_]`` (dots/slashes become
    underscores — ``hlo_sim_run_rounds.diff``)."""
    kind = kind.rstrip("_")
    return f"{kind}_{_SAFE.sub('_', entry)}.{ext}"


def prune(triage_dir: str, cap: int = RETENTION_CAP) -> list[str]:
    """Delete analysis dumps past ``cap``, oldest mtime first (name as
    the deterministic tiebreaker).  Returns the pruned paths."""
    try:
        names = os.listdir(triage_dir)
    except OSError:
        return []
    dumps = sorted(
        n for n in names
        if n.startswith(DUMP_PREFIXES)
        and os.path.isfile(os.path.join(triage_dir, n))
    )
    if len(dumps) <= cap:
        return []
    keyed = sorted(
        dumps,
        key=lambda n: (os.path.getmtime(os.path.join(triage_dir, n)), n),
    )
    pruned = []
    for n in keyed[: len(dumps) - cap]:
        path = os.path.join(triage_dir, n)
        try:
            os.remove(path)
            pruned.append(path)
        except OSError:
            pass  # a racing cleanup is not a failure
    return pruned


def write_dump(triage_dir: str, kind: str, entry: str, text: str,
               ext: str = "txt", cap: int = RETENTION_CAP) -> str:
    """Write one breach artifact under its deterministic name, then
    prune the namespace to ``cap`` files.  Returns the path."""
    os.makedirs(triage_dir, exist_ok=True)
    path = os.path.join(triage_dir, dump_name(kind, entry, ext))
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
    os.replace(tmp, path)
    prune(triage_dir, cap=cap)
    return path
