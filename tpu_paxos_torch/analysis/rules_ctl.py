"""CTL rule family on the port: the cause-code naming contract,
statically (port of ``tpu_paxos/analysis/rules_ctl.py``).

The contract (telemetry/diagnose.py): every breach cause has exactly
one integer wire code, assigned in ``CAUSE_IDS`` canonical order —
codes never move, but they are an *encoding*, not an API.  Host code
that compares against a raw integer (``dc["cause_id"] == 2``) keeps
working right up until someone reads the table, wonders what 2 means,
and "fixes" it — or until a new cause is appended and a reviewer has
to re-derive which literals are load-bearing.  The one sanctioned
spelling is the named lookup: ``diag.CAUSE_IDS["gray-region"]`` /
``diag.cause_code(name)``.

Rules (scope: every linted module; the single path exemption is
``telemetry/diagnose.py``, which OWNS the table and necessarily
relates names to integers):

- CTL001  an integer literal compared (``==``/``!=``/``in``/``not
          in``/ordering) against a cause-code expression — any side
          of the comparison whose source mentions ``cause``
          (``cause_id``, ``cause_ids``, ``cause_code(...)``,
          ``CAUSE_IDS[...]``...).  Spell the code by name.
"""

from __future__ import annotations

import ast

from tpu_paxos_torch.analysis import lint

lint.RULES.update({
    "CTL001": "integer cause-code literal compared against a cause "
              "expression outside telemetry/diagnose.py",
})

#: The module that owns the name<->code table: relating literals to
#: names is its whole job.
_TABLE_OWNER = "tpu_paxos_torch/telemetry/diagnose.py"


def _pragma_hint(rule: str) -> str:
    return f"or mark intentional: `# paxlint: allow[{rule}] <reason>`"


def _is_int_literal(expr: ast.AST) -> bool:
    # bool is an int subclass; True/False are not wire codes
    return (
        isinstance(expr, ast.Constant)
        and type(expr.value) is int
    )


def _mentions_cause(expr: ast.AST) -> bool:
    """Does the expression's source spell ``cause`` anywhere — a
    ``cause_id`` key, a ``cause_code()`` call, a ``CAUSE_IDS`` row?
    Source-level on purpose: the cause vocabulary is a naming
    convention, and the rule polices exactly that convention."""
    try:
        return "cause" in ast.unparse(expr).lower()
    except Exception:  # pragma: no cover - unparse is total on exprs
        return False


def check_module(ctx: lint.ModuleContext) -> list[lint.Finding]:
    if ctx.path.replace("\\", "/").endswith(_TABLE_OWNER):
        return []
    findings: list[lint.Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left, *node.comparators]
        lits = [s for s in sides if _is_int_literal(s)]
        if not lits:
            continue
        if not any(
            _mentions_cause(s) for s in sides if not _is_int_literal(s)
        ):
            continue
        code = lits[0].value
        findings.append(ctx.finding(
            "CTL001", node,
            f"raw cause-code literal {code} in a comparison — wire "
            "codes are an encoding, not an API",
            "spell it by name: diag.CAUSE_IDS[\"<cause>\"] or "
            "diag.cause_code(\"<cause>\"); "
            + _pragma_hint("CTL001"),
        ))
    return findings
