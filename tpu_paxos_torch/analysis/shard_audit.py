"""The shard certificate's lane drivers held on the port (the SH304 part
of ``tpu_paxos/analysis/shard_audit.py``).

``shard_certificate.json`` beside this module is a byte copy of the JAX
package's, pinned from JAX's one-device runs and certified over the mesh
grid D in {1, 2, 4, 8}.  Each entry is one 8-lane fleet dispatch: per lane
a hex verdict nibble and the decision log's sha256.  The port runs the
same four drivers on its lane tile (``FleetRunner``, the padded
``FleetRunner``, ``MemberFleetRunner`` and ``serve_fleet_run`` with
``mesh=``) and :func:`check_certificate` holds every mesh shape's result
against the pinned entry, naming the first ``(entry, mesh, lane)`` that
differs, as JAX's audit reports it.  The rest of JAX's shard tier (the
HLO collective budget, the rule coverage of the traced programs) has no
port yet.
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
