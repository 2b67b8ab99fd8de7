"""paxlint engine on the port: AST walking, reachability, pragmas,
baseline, CLI (port of ``tpu_paxos/analysis/lint.py``).

The engine is pure ``ast`` + stdlib: it imports no torch and runs on
the CPU in seconds.  Rule logic lives in the family modules
(``rules_det``, ``rules_torch``, ``rules_ctl``, ``rules_shard``); this
module owns everything shared:

- **File walk & module naming** — lints the port by default
  (``DEFAULT_SCOPE``: the ``tpu_paxos_torch`` package, ``chip_smoke.py``,
  ``tests/test_torch_*.py`` and ``scripts/torch_*.py``; never the JAX
  package, which keeps its own baseline), mapping paths to dotted
  module names.
- **Replay-critical reachability** — the DET rules apply to the
  import closure of the replay-critical roots (``core/``,
  ``membership/``, ``replay/``, ``harness/shrink.py``,
  ``fleet/evolve.py``): any module
  those roots import, directly or transitively (function-level lazy
  imports count — they execute at runtime), can feed bytes into a
  decision log or repro artifact.
- **Sink functions** — a function that itself serializes or writes
  (``json.dump``, ``hashlib``, ``.write(...)``, ``np.savez``,
  ``pickle.dump``, ``print``) is order/time-escaping wherever it
  lives; DET rules also apply inside such functions outside the
  closure (this is what catches a wall-clock stamp formatted into a
  log line).
- **Pragmas** — ``# paxlint: allow[RULE]`` (comma-separated ids or
  ``*``) on the offending line, or on a standalone comment line
  immediately above it, suppresses a finding.  Put the reason in the
  rest of the comment.
- **Baseline** — ``baseline.json`` (committed) maps ``(rule, file)``
  to an allowed count, so pre-existing findings can be burned down
  without blocking CI.  Stale entries (count higher than reality) are
  themselves an error: the baseline may only shrink.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re

RULES: dict[str, str] = {}  # rule id -> one-line doc (filled by families)

#: Modules whose transitive import closure is replay-critical: bytes
#: they produce are hashed/byte-compared by repro artifacts, injection
#: logs, and decision-log replay.
REPLAY_ROOTS = (
    "tpu_paxos_torch.core",
    "tpu_paxos_torch.membership",
    "tpu_paxos_torch.replay",
    "tpu_paxos_torch.harness.shrink",
    "tpu_paxos_torch.fleet.evolve",
)

_PRAGMA_RE = re.compile(r"#\s*paxlint:\s*allow\[([A-Za-z0-9_*,\s]+)\]")

#: Call suffixes that make the enclosing function a serialization /
#: output sink (order and time escape the process there).
_SINK_CALLS = (
    "json.dump", "json.dumps", "pickle.dump", "pickle.dumps",
    "np.savez", "numpy.savez", "np.save", "numpy.save", "print",
)
_SINK_ATTRS = ("write", "hexdigest", "digest")
_SINK_PREFIXES = ("hashlib.",)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding, pinned to a source location."""

    rule: str
    file: str  # posix path, relative to the lint root
    line: int
    col: int
    message: str
    hint: str

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "file": self.file,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "hint": self.hint,
        }


@dataclasses.dataclass
class ModuleContext:
    """Everything a rule checker needs about one source file."""

    path: str  # posix, relative to lint root
    module: str  # dotted name ("" when outside a package)
    tree: ast.Module
    lines: list[str]
    replay_critical: bool

    def finding(self, rule: str, node: ast.AST, message: str,
                hint: str) -> Finding:
        return Finding(
            rule=rule,
            file=self.path,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
            hint=hint,
        )


# ---------------- shared AST helpers ----------------

def call_name(node: ast.AST) -> str:
    """Dotted name of a call target / attribute chain: ``time.time``,
    ``torch.cuda.synchronize``, ``self.stream.write``.  '' when the chain
    bottoms out in anything but a Name (subscripts, calls, ...)."""
    if isinstance(node, ast.Call):
        node = node.func
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def attach_parents(tree: ast.Module) -> None:
    """Give every node a ``.paxlint_parent`` pointer (the engine's one
    tree mutation; rule modules rely on it for scope questions)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.paxlint_parent = node  # type: ignore[attr-defined]


def enclosing_function(node: ast.AST):
    """Nearest enclosing FunctionDef/AsyncFunctionDef/Lambda, or None."""
    cur = getattr(node, "paxlint_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return cur
        cur = getattr(cur, "paxlint_parent", None)
    return None


def is_sink_function(func: ast.AST) -> bool:
    """Does this function body itself serialize/write/print?  (Nested
    function defs are separate scopes and do not count.)"""
    for node in _walk_scope(func):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if not name:
            continue
        if name in _SINK_CALLS or name.startswith(_SINK_PREFIXES):
            return True
        if name.rsplit(".", 1)[-1] in _SINK_ATTRS and "." in name:
            return True
    return False


def _walk_scope(func: ast.AST):
    """Walk a function body without descending into nested defs."""
    stack = list(ast.iter_child_nodes(func))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# ---------------- pragmas ----------------

def pragma_map(lines: list[str]) -> dict[int, set[str]]:
    """1-based line -> set of allowed rule ids ('*' allows all).  A
    pragma on a standalone comment line also covers the next line."""
    allowed: dict[int, set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        allowed.setdefault(i, set()).update(rules)
        if text.lstrip().startswith("#"):  # standalone comment line
            allowed.setdefault(i + 1, set()).update(rules)
    return allowed


def _suppressed(f: Finding, allowed: dict[int, set[str]]) -> bool:
    rules = allowed.get(f.line, ())
    return f.rule in rules or "*" in rules


# ---------------- file walk & import closure ----------------

#: Default lint scope: the port's package, its chip script, its tests
#: and its scripts (tests assert on serialized engine output; a
#: nondeterministic pattern in any of them propagates).  Entries are a
#: directory, a file or a glob relative to the root.  The JAX package,
#: its tests and its scripts are out of scope: they keep JAX's own
#: paxlint and baseline.
DEFAULT_SCOPE = (
    "tpu_paxos_torch", "chip_smoke.py", "tests/test_torch_*.py", "scripts/torch_*.py",
)


def _scope_files(root: str) -> list[str]:
    """Absolute paths of the ``DEFAULT_SCOPE`` files that exist."""
    import glob

    out: list[str] = []
    for top in DEFAULT_SCOPE:
        full = os.path.join(root, top)
        if os.path.isdir(full):
            for dirpath, _dirs, files in sorted(os.walk(full)):
                out.extend(
                    os.path.join(dirpath, f) for f in sorted(files)
                    if f.endswith(".py")
                )
        elif any(ch in top for ch in "*?["):
            out.extend(sorted(glob.glob(full)))
        elif os.path.isfile(full):
            out.append(full)
    return out


def walk_files(root: str, paths: list[str] | None = None) -> list[str]:
    """Python files to lint, as posix paths relative to ``root``.
    Default target: every ``DEFAULT_SCOPE`` entry that exists under
    ``root`` (a bare package checkout still lints)."""
    if paths:
        out: list[str] = []
        for p in paths:
            full = p if os.path.isabs(p) else os.path.join(root, p)
            if os.path.isdir(full):
                for dirpath, _dirs, files in sorted(os.walk(full)):
                    out.extend(
                        os.path.join(dirpath, f)
                        for f in sorted(files) if f.endswith(".py")
                    )
            elif os.path.exists(full):
                out.append(full)
            else:
                # a typo'd CI path must fail loudly, not lint nothing
                # and report clean
                raise FileNotFoundError(f"lint path does not exist: {p}")
        # dedupe: overlapping arguments (a dir plus a file inside it)
        # must not lint a file twice — duplicates double-count
        # findings past the baseline
        return sorted({
            os.path.relpath(f, root).replace(os.sep, "/") for f in out
        })
    return sorted({
        os.path.relpath(f, root).replace(os.sep, "/")
        for f in _scope_files(root)
    })


def module_name(relpath: str) -> str:
    """Dotted module name for a repo-relative path ('' if the path is
    not inside a package directory we recognize)."""
    if not relpath.endswith(".py"):
        return ""
    mod = relpath[:-3].replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


def _module_imports(
    tree: ast.Module, module: str, is_pkg: bool = False
) -> set[str]:
    """Dotted names this module imports (absolute + resolved relative),
    including function-level lazy imports — those still execute."""
    out: set[str] = set()
    # anchor for relative imports: level 1 means the containing
    # package — the module itself when this is a package __init__,
    # its parent otherwise
    anchor = module.split(".") if is_pkg else module.split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative
                base = anchor[: len(anchor) - (node.level - 1)]
                prefix = ".".join(base + ([node.module] if node.module else []))
            else:
                prefix = node.module or ""
            if prefix:
                out.add(prefix)
                out.update(f"{prefix}.{a.name}" for a in node.names)
    return out


@dataclasses.dataclass
class ParsedFile:
    """One source file, read and parsed exactly once per lint run
    (shared by the closure builder and the rule walk)."""

    source: str | None  # None: unreadable
    tree: ast.Module | None  # None: unreadable or syntax error
    error: SyntaxError | None = None


def parse_all(files: list[str], root: str) -> dict[str, ParsedFile]:
    out: dict[str, ParsedFile] = {}
    for rel in files:
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as fh:
                source = fh.read()
        except OSError:
            out[rel] = ParsedFile(None, None)
            continue
        try:
            out[rel] = ParsedFile(source, ast.parse(source, filename=rel))
        except SyntaxError as e:
            out[rel] = ParsedFile(source, None, e)
    return out


def replay_closure(
    files: list[str], root: str,
    parsed: dict[str, ParsedFile] | None = None,
) -> set[str]:
    """Modules reachable (by import) from the replay-critical roots."""
    if parsed is None:
        parsed = parse_all(files, root)
    graph: dict[str, set[str]] = {}
    names: set[str] = set()
    for rel in files:
        mod = module_name(rel)
        if not mod:
            continue
        names.add(mod)
        tree = parsed[rel].tree if rel in parsed else None
        if tree is None:
            continue
        graph[mod] = _module_imports(
            tree, mod, is_pkg=rel.endswith("/__init__.py")
        )
    def expand(mod: str) -> set[str]:
        """Direct imports plus ancestor packages: importing a
        submodule executes every package ``__init__`` above it."""
        out = set(graph.get(mod, ()))
        for dep in list(out) + [mod]:
            while "." in dep:
                dep = dep.rsplit(".", 1)[0]
                out.add(dep)
        return {d for d in out if d in names}

    closure = {
        m for m in names
        if any(m == r or m.startswith(r + ".") for r in REPLAY_ROOTS)
    }
    frontier = list(closure)
    while frontier:
        for dep in expand(frontier.pop()):
            if dep not in closure:
                closure.add(dep)
                frontier.append(dep)
    return closure


# ---------------- baseline ----------------

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: str | None) -> dict[tuple[str, str], int]:
    if not path or not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return {
        (e["rule"], e["file"]): int(e["count"])
        for e in data.get("entries", [])
    }


def apply_baseline(
    findings: list[Finding], baseline: dict[tuple[str, str], int]
) -> tuple[list[Finding], list[dict]]:
    """Subtract baselined findings.  Returns (remaining, stale) where
    ``stale`` lists baseline entries whose count exceeds what the code
    still produces — those must be removed from baseline.json."""
    budget = dict(baseline)
    remaining: list[Finding] = []
    for f in findings:
        key = (f.rule, f.file)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
        else:
            remaining.append(f)
    stale = [
        {"rule": rule, "file": file, "unused": left}
        for (rule, file), left in sorted(budget.items()) if left > 0
    ]
    return remaining, stale


# ---------------- engine ----------------

def lint_files(
    root: str,
    paths: list[str] | None = None,
    replay_critical_override: bool | None = None,
    files: list[str] | None = None,
) -> list[Finding]:
    """Lint files under ``root`` and return pragma-filtered findings
    (baseline NOT applied — that is the caller's policy decision).
    ``files`` lets a caller that already walked the tree skip the
    second walk."""
    from tpu_paxos_torch.analysis import (
        rules_ctl, rules_det, rules_shard, rules_torch,
    )

    if files is None:
        files = walk_files(root, paths)
    parsed = parse_all(files, root)
    closure = replay_closure(files, root, parsed)
    findings: list[Finding] = []
    for rel in files:
        pf = parsed[rel]
        if pf.source is None:
            continue
        if pf.tree is None:
            e = pf.error
            findings.append(Finding(
                rule="PARSE", file=rel, line=(e.lineno if e else 1) or 1,
                col=(e.offset if e else 0) or 0,
                message=f"syntax error: {e.msg if e else 'unparseable'}",
                hint="fix the syntax error; paxlint needs a parseable file",
            ))
            continue
        source, tree = pf.source, pf.tree
        mod = module_name(rel)
        critical = (
            replay_critical_override
            if replay_critical_override is not None
            else mod in closure
        )
        ctx = ModuleContext(
            path=rel, module=mod, tree=tree,
            lines=source.splitlines(), replay_critical=critical,
        )
        attach_parents(tree)
        raw = (rules_det.check_module(ctx) + rules_torch.check_module(ctx)
               + rules_ctl.check_module(ctx)
               + rules_shard.check_module(ctx))
        allowed = pragma_map(ctx.lines)
        findings.extend(f for f in raw if not _suppressed(f, allowed))
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return findings


def lint_source(
    source: str, path: str = "fixture.py", replay_critical: bool = True
) -> list[Finding]:
    """Lint a source string (the fixture-test entry point)."""
    from tpu_paxos_torch.analysis import (
        rules_ctl, rules_det, rules_shard, rules_torch,
    )

    tree = ast.parse(source, filename=path)
    ctx = ModuleContext(
        path=path, module=module_name(path), tree=tree,
        lines=source.splitlines(), replay_critical=replay_critical,
    )
    attach_parents(tree)
    raw = (rules_det.check_module(ctx) + rules_torch.check_module(ctx)
               + rules_ctl.check_module(ctx)
               + rules_shard.check_module(ctx))
    allowed = pragma_map(ctx.lines)
    out = [f for f in raw if not _suppressed(f, allowed)]
    out.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    return out


def run_lint(
    root: str | None = None,
    paths: list[str] | None = None,
    baseline_path: str | None = DEFAULT_BASELINE,
) -> dict:
    """Full lint run as a JSON-ready report dict (the CLI's payload).
    ``ok`` is True iff zero unsuppressed findings AND zero stale
    baseline entries."""
    root = root or os.getcwd()
    files = walk_files(root, paths)
    raw = lint_files(root, paths, files=files)
    remaining, stale = apply_baseline(raw, load_baseline(baseline_path))
    if paths:
        # path-scoped run: baseline entries for files outside the
        # selection were never given a chance to match — only judge
        # staleness for files actually linted
        selected = set(files)
        stale = [s for s in stale if s["file"] in selected]
    counts: dict[str, int] = {}
    for f in remaining:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "version": 1,
        # zero files is a misconfiguration (wrong --root), not a clean
        # tree — never report ok for a lint that looked at nothing
        "ok": bool(files) and not remaining and not stale,
        "files": len(files),
        "findings": [f.to_json() for f in remaining],
        "baselined": len(raw) - len(remaining),
        "stale_baseline": stale,
        "counts": dict(sorted(counts.items())),
    }


def main(argv=None) -> int:
    """``python -m tpu_paxos_torch lint`` — exits 0 iff the tree is clean."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m tpu_paxos_torch lint",
        description="paxlint on the port: determinism, host-sync, "
                    "cause-code and lane-tile static analysis",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the port's "
                    "scope under --root)")
    ap.add_argument("--root", default=os.getcwd(),
                    help="repo root paths are reported relative to")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON report on stdout")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file (committed known findings)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report everything)")
    ap.add_argument("--rules", action="store_true",
                    help="list rule ids and exit")
    ap.add_argument("--fix", action="store_true",
                    help="emit mechanical rewrites for the findings "
                    "(sorted() wraps for DET003, pragma scaffolds "
                    "with TODO reasons elsewhere) as a unified diff")
    ap.add_argument("--write", action="store_true",
                    help="with --fix: apply the rewrites in place "
                    "instead of printing the diff")
    args = ap.parse_args(argv)
    if args.write and not args.fix:
        ap.error("--write requires --fix")
    if args.fix and args.json:
        ap.error("--fix does not support --json (the diff IS the "
                 "output; run a plain --json pass for the report)")
    if args.rules:
        from tpu_paxos_torch.analysis import (  # noqa: F401
            rules_ctl, rules_det, rules_shard, rules_torch,
        )

        for rid, doc in sorted(RULES.items()):
            print(f"{rid}  {doc}")
        return 0
    try:
        report = run_lint(
            root=args.root,
            paths=args.paths or None,
            baseline_path=None if args.no_baseline else args.baseline,
        )
    except FileNotFoundError as e:
        print(f"paxlint: {e}")
        return 2
    if args.fix:
        from tpu_paxos_torch.analysis import fix as fixm

        plans = fixm.plan_fixes(report, args.root)
        if args.write:
            try:
                written = fixm.apply_fixes(plans, args.root)
            except RuntimeError as e:
                print(f"paxlint --fix: {e}")
                return 2
            for rel in written:
                print(f"fixed: {rel}")
            print(
                f"paxlint --fix: {len(written)} file"
                f"{'s' if len(written) != 1 else ''} rewritten — "
                "re-run `python -m tpu_paxos_torch lint`; replace every scaffolded TODO "
                "reason before review"
            )
        else:
            diff = fixm.render_diff(plans)
            if diff:
                print(diff, end="")
            print(
                f"paxlint --fix (dry run): {len(plans)} file"
                f"{'s' if len(plans) != 1 else ''} would change — "
                "apply with `lint --fix --write`"
            )
        # fix mode reports what it would do; the exit code still
        # reflects the tree as it stands
        return 0 if report["ok"] else 1
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        for f in report["findings"]:
            print(
                f"{f['file']}:{f['line']}:{f['col']}: {f['rule']} "
                f"{f['message']}\n    hint: {f['hint']}"
            )
        for s in report["stale_baseline"]:
            print(
                f"baseline.json: stale entry {s['rule']} for "
                f"{s['file']} ({s['unused']} unused) — remove it"
            )
        if not report["files"]:
            print(
                f"paxlint: no python files found under {args.root!r} "
                "(wrong --root?)"
            )
        n = len(report["findings"])
        print(
            f"paxlint: {report['files']} files, "
            f"{n} finding{'s' if n != 1 else ''}, "
            f"{report['baselined']} baselined, "
            f"{len(report['stale_baseline'])} stale baseline entries"
        )
    return 0 if report["ok"] else 1
