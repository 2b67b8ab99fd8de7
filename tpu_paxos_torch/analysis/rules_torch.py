"""The port's counterpart of the JAX rule family
(``tpu_paxos/analysis/rules_jax.py``): host syncs in host loops,
statically.

JAX's family policed jit hygiene.  Three of its four rules concern
tracing and have no torch counterpart, because the port traces nothing:

- JAX101 (a Python ``if``/``while`` on a traced value) — torch runs
  eagerly; a branch on a tensor is a host read, which JAX103 below and
  the audit's host-read count (``analysis/audit.py``) see.
- JAX102 (a mutable capture baked in at trace time) — nothing is baked:
  every call reads the current value.
- JAX104 (a jit without ``static_argnames`` on a shape parameter) — no
  compile step, so no retrace storm and no static-argument declaration.

JAX103 keeps its id and meaning:

- JAX103  host-device sync inside a host-side loop: ``.item()``,
          ``.cpu()``, ``torch.cuda.synchronize()``, and ``.tolist()`` /
          ``np.asarray`` / ``np.array`` of an attribute-rooted value
          (device state hangs off objects: ``st.chosen_vid``,
          ``self.state.crashed``; plain local names are usually host
          data), called once per iteration, serialize the card's stream
          every round.  The engines' designed per-round reads carry a
          pragma with their reason; the audit pins how many a round makes.
"""

from __future__ import annotations

import ast

from tpu_paxos_torch.analysis import lint

lint.RULES.update({
    "JAX103": "host-device sync inside a per-round host loop",
})

#: Method calls that always wait for the device.
_SYNC_ATTRS = {"item", "cpu"}
#: Method calls that wait for the device when their receiver is device
#: state (attribute-rooted).
_SYNC_ROOTED_ATTRS = {"tolist"}
#: Calls that wait for the device when their argument is device state.
_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
#: Calls that always wait for the device.
_SYNC_ALWAYS = {"torch.cuda.synchronize"}


def _attr_rooted(expr: ast.AST) -> bool:
    """Does ``expr`` peel (through subscripts/slices) to an attribute
    chain?"""
    while isinstance(expr, ast.Subscript):
        expr = expr.value
    return isinstance(expr, ast.Attribute)


def _is_sync(call: ast.Call) -> bool:
    name = lint.call_name(call)
    if name in _SYNC_ALWAYS:
        return True
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in _SYNC_ATTRS:
            return True
        if attr in _SYNC_ROOTED_ATTRS and _attr_rooted(call.func.value):
            return True
    return name in _SYNC_CALLS and bool(call.args) and _attr_rooted(call.args[0])


def check_module(ctx: lint.ModuleContext) -> list[lint.Finding]:
    findings: list[lint.Finding] = []
    flagged: set[ast.AST] = set()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        # only code that runs once PER ITERATION: the body (+ the while
        # test); a For's iterable evaluates once on entry and an else:
        # block runs once after exit
        per_iter = node.body + ([node.test] if isinstance(node, ast.While) else [])
        loop_fn = lint.enclosing_function(node)
        for sub in (s for stmt in per_iter for s in ast.walk(stmt)):
            if not isinstance(sub, ast.Call) or sub in flagged:
                continue
            # nested defs execute elsewhere
            if lint.enclosing_function(sub) is not loop_fn:
                continue
            if _is_sync(sub):
                flagged.add(sub)
                name = lint.call_name(sub) or f".{sub.func.attr}"
                findings.append(ctx.finding(
                    "JAX103", sub,
                    f"host-device sync `{name}()` inside a host-side "
                    "loop — serializes the device pipeline every "
                    "iteration",
                    "hoist the transfer out of the loop, pack the "
                    "iteration's reads into one copy, or `# paxlint: "
                    "allow[JAX103] <reason>` for a designed per-round read",
                ))
    return findings
