"""paxlint ``--fix`` on the port: mechanical rewrite scaffolding (port
of ``tpu_paxos/analysis/fix.py``; pure stdlib).

``python -m tpu_paxos_torch lint --fix`` turns the lint report's findings
into *mechanical* edits and prints them as a unified diff (dry-run);
``--fix --write`` applies them.  Two rewrite families:

- **DET003 sorted() wrap** — the finding pins the iterated
  set/dict-view expression; the fix wraps exactly that expression in
  ``sorted(...)``, which is the rule's own suggested remediation and
  is behavior-preserving up to iteration order (which is the point:
  order becomes deterministic).
- **Pragma scaffold** (every other rule) — a standalone
  ``# paxlint: allow[RULE] TODO: <reason>`` comment line is inserted
  directly above the finding, at its indentation.  This is
  deliberately NOT a silent suppression: the TODO text is a review
  speed bump — the author must replace it with a real justification
  (or a real fix) before review, but CI stops bleeding while they do.

Only findings that block CI are fixed (post-baseline, post-pragma:
what ``run_lint`` reports).  The rewriter is position-based: it
re-parses each file, locates the AST node at the finding's exact
(line, col), and splices source text using the node's end position —
no reformatting, no AST unparse round-trip, so untouched lines are
byte-identical.

Dry-run output is a standard unified diff (``patch``-appliable);
``--write`` rewrites files in place, bottom-up so earlier edits never
shift later spans.
"""

from __future__ import annotations

import ast
import difflib
import os

#: Rules fixed by wrapping the pinned expression in sorted(...).
SORT_WRAP_RULES = ("DET003",)

TODO_REASON = "TODO: justify this suppression or fix the finding"


def _node_at(tree: ast.Module, line: int, col: int) -> ast.expr | None:
    """The expression node whose position matches a finding's pin
    (findings are emitted via ``ctx.finding(rule, node, ...)``, so
    (lineno, col_offset) identifies the node; prefer the OUTERMOST
    match so ``d.items()`` wraps the whole call, not ``d``)."""
    best: ast.expr | None = None
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.expr)
            and getattr(node, "lineno", None) == line
            and getattr(node, "col_offset", None) == col
        ):
            if best is None:
                best = node
            else:
                b_end = (best.end_lineno, best.end_col_offset)
                n_end = (node.end_lineno, node.end_col_offset)
                if n_end > b_end:
                    best = node
    return best


def _splice_sorted(src_lines: list[str], node: ast.expr) -> list[str]:
    """Wrap the node's exact source span in ``sorted(...)``."""
    l0, c0 = node.lineno - 1, node.col_offset
    l1, c1 = node.end_lineno - 1, node.end_col_offset
    out = list(src_lines)
    # end first, so the start splice does not shift the end offsets
    out[l1] = out[l1][:c1] + ")" + out[l1][c1:]
    out[l0] = out[l0][:c0] + "sorted(" + out[l0][c0:]
    return out


def _insert_pragma(src_lines: list[str], line: int, rule: str
                   ) -> list[str]:
    """Standalone pragma comment directly above ``line`` (1-based), at
    the finding line's indentation (lint honors a pragma on the
    immediately preceding comment line)."""
    idx = line - 1
    target = src_lines[idx] if idx < len(src_lines) else ""
    indent = target[: len(target) - len(target.lstrip())]
    pragma = f"{indent}# paxlint: allow[{rule}] {TODO_REASON}"
    return src_lines[:idx] + [pragma] + src_lines[idx:]


def plan_file_fixes(root: str, rel: str, findings: list[dict]
                    ) -> tuple[str, str] | None:
    """-> (original_text, fixed_text) for one file, or None if nothing
    is mechanically fixable.  Edits are applied bottom-up (by line,
    then column) so earlier splices never shift later spans; two
    DET003 wraps on the SAME expression span are deduplicated."""
    path = os.path.join(root, rel)
    with open(path, encoding="utf-8") as fh:
        original = fh.read()
    try:
        tree = ast.parse(original, filename=rel)
    except SyntaxError:
        return None  # a PARSE finding: nothing mechanical to do
    lines = original.splitlines()
    trailing_nl = original.endswith("\n")

    # Phase 1: sorted() wraps.  A wrap splices WITHIN its start/end
    # lines and never changes the line count, so every node's
    # coordinates stay valid across wraps; rightmost-first ordering
    # keeps same-line spans from shifting each other.
    wraps = [f for f in findings if f["rule"] in SORT_WRAP_RULES]
    pragmas = [
        f for f in findings
        if f["rule"] not in SORT_WRAP_RULES and f["rule"] != "PARSE"
    ]
    seen_spans: set[tuple] = set()
    changed = False
    for f in sorted(wraps, key=lambda f: (f["line"], f["col"]),
                    reverse=True):
        node = _node_at(tree, f["line"], f["col"])
        if node is None:
            continue  # position drifted (edited file) — skip, not guess
        span = (node.lineno, node.col_offset,
                node.end_lineno, node.end_col_offset)
        if span in seen_spans:
            continue
        seen_spans.add(span)
        lines = _splice_sorted(lines, node)
        changed = True
    # Phase 2: pragma scaffolds, AFTER every wrap (an insert shifts
    # all following line indices, which would corrupt wrap
    # coordinates), bottom-up by line so earlier insert points are
    # unaffected by later ones; one pragma per (line, rule).
    seen_pragmas: set[tuple] = set()
    for f in sorted(pragmas, key=lambda f: (f["line"], f["rule"]),
                    reverse=True):
        if (f["line"], f["rule"]) in seen_pragmas:
            continue
        seen_pragmas.add((f["line"], f["rule"]))
        lines = _insert_pragma(lines, f["line"], f["rule"])
        changed = True
    if not changed:
        return None
    fixed = "\n".join(lines) + ("\n" if trailing_nl else "")
    # never plan a corrupting rewrite: a pragma spliced into a
    # backslash continuation (or any other splice landing badly) must
    # drop the file, not ship unimportable code under --write
    try:
        ast.parse(fixed, filename=rel)
    except SyntaxError:
        return None
    return original, fixed


def plan_fixes(report: dict, root: str) -> dict[str, tuple[str, str]]:
    """Group the lint report's findings per file and plan edits.
    -> {relpath: (original, fixed)}."""
    by_file: dict[str, list[dict]] = {}
    for f in report["findings"]:
        by_file.setdefault(f["file"], []).append(f)
    plans: dict[str, tuple[str, str]] = {}
    for rel in sorted(by_file):
        plan = plan_file_fixes(root, rel, by_file[rel])
        if plan is not None:
            plans[rel] = plan
    return plans


def render_diff(plans: dict[str, tuple[str, str]]) -> str:
    """One unified diff over all planned edits (dry-run output)."""
    chunks: list[str] = []
    for rel, (original, fixed) in sorted(plans.items()):
        chunks.extend(difflib.unified_diff(
            original.splitlines(keepends=True),
            fixed.splitlines(keepends=True),
            fromfile=f"a/{rel}", tofile=f"b/{rel}",
        ))
    return "".join(chunks)


def apply_fixes(plans: dict[str, tuple[str, str]], root: str
                ) -> list[str]:
    """Write the fixed text in place (--fix --write).  Refuses a file
    whose on-disk content no longer matches the plan's original (the
    lint ran against different bytes) — validated for EVERY file
    before the first write, so a stale plan never leaves the tree
    half-rewritten."""
    for rel, (original, _fixed) in sorted(plans.items()):
        with open(os.path.join(root, rel), encoding="utf-8") as fh:
            if fh.read() != original:
                raise RuntimeError(
                    f"{rel} changed since the lint pass — re-run "
                    "`lint --fix`"
                )
    written: list[str] = []
    for rel, (original, fixed) in sorted(plans.items()):
        path = os.path.join(root, rel)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(fixed)
        os.replace(tmp, path)
        written.append(rel)
    return written
