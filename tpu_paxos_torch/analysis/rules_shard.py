"""SHARD rule family on the port: the lane and instance axes are split
and gathered only inside ``parallel/`` (the counterpart of
``tpu_paxos/analysis/rules_shard.py``).

The port's shard tier (``analysis/shard_audit.py``) certifies the mesh
layout against ONE committed source of truth: the partition-rule table
(``parallel/partition_rules.py``) and the routes that apply it
(``parallel/mesh.split_lanes`` / ``gather_lanes`` / ``shard_instances``
/ ``on_lanes`` and ``partition_rules.split_tree`` / ``gather_tree``).
That certification is sound only if no other module cuts a lane or
instance axis into rank blocks itself: a hand-written
``x[rank * step:(rank + 1) * step]`` bakes in a layout the table never
sees, works at one mesh size and silently mislays (or drops) lanes at
another.

Rules (scope: every linted module OUTSIDE ``tpu_paxos_torch/parallel/``,
which owns the layout):

- SH001  a hand-made rank split or gather:
         a slice whose bound mentions a rank (a name ``rank``, or an
         attribute ``.rank``: ``x[comm.rank * n:...]``);
         ``torch.chunk`` / ``torch.split`` / ``torch.tensor_split`` /
         ``np.split`` / ``np.array_split`` (or the ``.chunk`` /
         ``.tensor_split`` methods) into ``.size`` blocks of a mesh
         (``mesh.size``, ``comm.size``);
         ``torch.cat`` / ``torch.stack`` / ``np.concatenate`` /
         ``np.stack`` of a mesh run's outputs (an argument that calls
         ``<mesh>.run(...)`` or ``on_lanes(...)``).
"""

from __future__ import annotations

import ast

from tpu_paxos_torch.analysis import lint

lint.RULES.update({
    "SH001": "lane/instance axis split or gathered by hand outside "
             "tpu_paxos_torch/parallel/",
})

#: The package that owns the mesh layout and the partition table.
_OWNER_PREFIX = "tpu_paxos_torch/parallel/"

_SPLIT_CALLS = {
    "torch.chunk", "torch.split", "torch.tensor_split", "np.split",
    "np.array_split", "numpy.split", "numpy.array_split",
}
_SPLIT_METHODS = {"chunk", "tensor_split"}
_GATHER_CALLS = {
    "torch.cat", "torch.concat", "torch.stack", "np.concatenate",
    "np.stack", "numpy.concatenate", "numpy.stack",
}

_HINT = (
    "split and gather through the committed table "
    "(parallel/mesh.split_lanes / gather_lanes / shard_instances / "
    "on_lanes, parallel/partition_rules.split_tree / gather_tree); "
    "or mark intentional: `# paxlint: allow[SH001] <reason>`"
)


def _mentions_rank(expr) -> bool:
    if expr is None:
        return False
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and n.id == "rank":
            return True
        if isinstance(n, ast.Attribute) and n.attr == "rank":
            return True
    return False


def _is_mesh_size(expr: ast.AST) -> bool:
    """``mesh.size`` / ``comm.size`` / ``self.mesh.size``."""
    if not (isinstance(expr, ast.Attribute) and expr.attr == "size"):
        return False
    base = lint.call_name(expr.value).rsplit(".", 1)[-1].lower()
    return "mesh" in base or base == "comm"


def _runs_mesh(expr: ast.AST) -> bool:
    """Does ``expr`` call ``<mesh>.run(...)`` or ``on_lanes(...)``?"""
    for n in ast.walk(expr):
        if not isinstance(n, ast.Call):
            continue
        name = lint.call_name(n)
        if name.rsplit(".", 1)[-1] == "on_lanes":
            return True
        if isinstance(n.func, ast.Attribute) and n.func.attr == "run":
            base = lint.call_name(n.func.value).rsplit(".", 1)[-1].lower()
            if "mesh" in base:
                return True
    return False


def check_module(ctx: lint.ModuleContext) -> list[lint.Finding]:
    if ctx.path.replace("\\", "/").startswith(_OWNER_PREFIX):
        return []
    findings: list[lint.Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Slice):
            if _mentions_rank(node.lower) or _mentions_rank(node.upper):
                findings.append(ctx.finding(
                    "SH001", node,
                    "a slice bounded by a rank outside parallel/ — a "
                    "hand-made rank block bypasses the committed "
                    "partition table",
                    _HINT,
                ))
        elif isinstance(node, ast.Call):
            name = lint.call_name(node)
            method = node.func.attr if isinstance(node.func, ast.Attribute) else ""
            if name in _SPLIT_CALLS or (method in _SPLIT_METHODS and name not in _GATHER_CALLS):
                args = list(node.args) + [kw.value for kw in node.keywords]
                if any(_is_mesh_size(a) for a in args):
                    findings.append(ctx.finding(
                        "SH001", node,
                        f"`{name or method}` into a mesh's rank blocks "
                        "outside parallel/ — the lane tile splits "
                        "through the committed partition table",
                        _HINT,
                    ))
            elif name in _GATHER_CALLS and node.args and _runs_mesh(node.args[0]):
                findings.append(ctx.finding(
                    "SH001", node,
                    f"`{name}` of a mesh run's outputs outside parallel/ "
                    "— gather through parallel/mesh.gather_lanes",
                    _HINT,
                ))
    return findings
