"""DET rule family on the port: the determinism/replay contract,
statically (port of ``tpu_paxos/analysis/rules_det.py``).

The contract (README "Determinism"): an engine run is a pure function
of (seed, config, schedule); decision logs, repro artifacts, and
injection logs byte-compare equal across record and replay.  Anything
that lets wall-clock time, hash-seed-dependent iteration order, or
unseeded randomness reach those bytes breaks replay in ways no fixed-
seed unit test can see.

Rules (scope: the replay-critical import closure, plus — for DET001/
DET002/DET003 — any *sink function* that itself serializes/writes,
wherever it lives; see lint.py for both definitions):

- DET001  wall-clock reads (``time.time``/``strftime``/
          ``perf_counter``/``datetime.now``...).
- DET002  unseeded randomness (``random.*`` module functions, legacy
          ``np.random.*`` globals, argless ``default_rng()``,
          ``os.urandom``, ``uuid.uuid*``, ``secrets.*``, and torch's
          global generator: ``torch.rand*``/``randn*``/``randint*``/
          ``randperm``/``bernoulli``/``multinomial``/``normal`` without
          a ``generator=``, ``torch.manual_seed``/``torch.seed``, and a
          ``torch.Generator()`` not seeded where it is made).
- DET003  unordered iteration where order escapes: iterating a
          set-typed expression unsorted (``for``/comprehension/
          ``join``/``list``/``tuple``/``*``-unpack), or iterating
          ``.items()``/``.keys()``/``.values()`` inside a sink
          function.  ``sorted(...)`` at the iteration site clears it.
          Dataflow-aware through locals: ``s = set(...); for x in s``
          is caught too — a name every assignment of which (in its
          function scope) is a set expression / dict view carries
          that kind to its iteration sites; any other rebinding
          (non-set assignment, loop target, unpacking) clears it.
- DET004  a global torch setting anywhere outside
          ``utils/device.py``: an assignment to ``torch.backends.*``,
          or a call of ``torch.set_default_*``,
          ``torch.use_deterministic_algorithms``,
          ``torch.set_float32_matmul_precision`` or
          ``torch.cuda.set_sync_debug_mode``.  Such a setting changes
          how every later op of the process runs (TF32 matmuls, the
          default dtype, syncs that raise), so its one sanctioned home
          is the device module; JAX's rule held ``jax.config.update``
          to ``utils/prng.py`` for the same reason.
"""

from __future__ import annotations

import ast

from tpu_paxos_torch.analysis import lint

lint.RULES.update({
    "DET001": "wall-clock read in replay-critical code or a "
              "serialization sink",
    "DET002": "unseeded randomness in replay-critical code or a "
              "serialization sink",
    "DET003": "unordered set/dict iteration where order escapes the "
              "process",
    "DET004": "global torch setting outside utils/device.py",
})

_WALL_CLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.localtime",
    "time.gmtime", "time.strftime", "time.ctime", "time.asctime",
    "datetime.datetime.now", "datetime.now", "datetime.datetime.utcnow",
    "datetime.utcnow", "datetime.date.today", "date.today",
    "datetime.today",
}

_RANDOM_EXACT = {"os.urandom", "uuid.uuid1", "uuid.uuid4"}
_RANDOM_PREFIXES = ("random.", "np.random.", "numpy.random.", "secrets.")

#: torch's samplers on the process-global generator: unseeded unless the
#: call passes its own ``generator=``.
_TORCH_SAMPLERS = {
    f"torch.{f}" for f in (
        "rand", "rand_like", "randn", "randn_like", "randint",
        "randint_like", "randperm", "bernoulli", "multinomial", "normal",
        "poisson",
    )
}
#: Calls that reseed or read torch's global generator state.
_TORCH_GLOBAL_SEED = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all",
}

#: Order-insensitive consumers: a set expression inside these is fine.
_ORDER_SAFE_CALLS = {
    "sorted", "len", "min", "max", "sum", "any", "all", "set",
    "frozenset", "bool",
}

#: Iteration-forcing calls whose argument order escapes into the
#: result (and typically onward into output).
_ITER_CALLS = {"list", "tuple", "enumerate", "iter", "next", "str",
               "repr", "format"}

_DICT_VIEW_METHODS = {"keys", "values", "items"}

#: The namespace the seeded counter-based PRNG lives in
#: (``utils/prng``) — never flagged by DET002.
_SEEDED_PREFIXES = ("prng.",)

#: DET004: global torch settings, by call name or name prefix.
_TORCH_SETTING_CALLS = {
    "torch.use_deterministic_algorithms", "torch.set_float32_matmul_precision",
    "torch.cuda.set_sync_debug_mode",
}
_TORCH_SETTING_PREFIXES = ("torch.set_default_",)
_SETTINGS_OWNER = "tpu_paxos_torch/utils/device.py"


def _pragma_hint(rule: str) -> str:
    return f"or mark intentional: `# paxlint: allow[{rule}] <reason>`"


def check_module(ctx: lint.ModuleContext) -> list[lint.Finding]:
    findings: list[lint.Finding] = []
    sink_cache: dict[ast.AST, bool] = {}
    kinds_cache: dict[ast.AST, dict[str, str]] = {}

    def in_scope(node: ast.AST) -> bool:
        """DET001-003 scope: replay closure, or inside a sink fn."""
        if ctx.replay_critical:
            return True
        fn = lint.enclosing_function(node)
        if fn is None:
            return False
        if fn not in sink_cache:
            sink_cache[fn] = lint.is_sink_function(fn)
        return sink_cache[fn]

    def local_kinds(node: ast.AST) -> dict[str, str]:
        """Set/dict-view locals of the scope containing ``node`` (the
        dataflow side of DET003), computed once per scope."""
        scope = lint.enclosing_function(node) or ctx.tree
        if scope not in kinds_cache:
            kinds_cache[scope] = _scope_kinds(scope)
        return kinds_cache[scope]

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call):
            name = lint.call_name(node)
            if not name:
                continue
            _check_wall_clock(ctx, node, name, in_scope, findings)
            _check_randomness(ctx, node, name, in_scope, findings)
            _check_torch_setting(ctx, node, name, findings)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            _check_backends_assign(ctx, node, findings)
        itered = _iterated_exprs(node)
        for expr in itered:
            _check_unordered(
                ctx, node, expr, in_scope, findings, local_kinds
            )
    return findings


# ---------------- DET001 / DET002 / DET004 ----------------

def _check_wall_clock(ctx, node, name, in_scope, findings) -> None:
    if name in _WALL_CLOCK and in_scope(node):
        findings.append(ctx.finding(
            "DET001", node,
            f"wall-clock read `{name}()` can reach replayed/serialized "
            "bytes",
            "gate it behind utils/log.deterministic_mode() (zeroed "
            "stamps) or move timing out of the serialization path; "
            + _pragma_hint("DET001"),
        ))


def _seeded_generator(node: ast.Call) -> bool:
    """``torch.Generator(...).manual_seed(seed)``: the generator is
    seeded where it is made."""
    parent = getattr(node, "paxlint_parent", None)
    grand = getattr(parent, "paxlint_parent", None)
    return (
        isinstance(parent, ast.Attribute) and parent.attr == "manual_seed"
        and isinstance(grand, ast.Call) and grand.func is parent
        and bool(grand.args)
    )


def _check_randomness(ctx, node, name, in_scope, findings) -> None:
    if name.startswith(_SEEDED_PREFIXES):
        return
    unseeded = (
        name in _RANDOM_EXACT
        or (name.startswith(_RANDOM_PREFIXES)
            # seeded constructions are the sanctioned pattern
            and not (name.endswith(".default_rng") and node.args))
        or name in _TORCH_GLOBAL_SEED
        or (name in _TORCH_SAMPLERS
            and not any(kw.arg == "generator" for kw in node.keywords))
        or (name == "torch.Generator" and not _seeded_generator(node))
    )
    if unseeded and in_scope(node):
        findings.append(ctx.finding(
            "DET002", node,
            f"unseeded randomness `{name}()` in replay-critical code",
            "derive randomness from utils/prng streams (pure function "
            "of seed/tag/round) or seed an explicit Generator; "
            + _pragma_hint("DET002"),
        ))


def _settings_owner(ctx) -> bool:
    return ctx.path.replace("\\", "/").endswith(_SETTINGS_OWNER)


def _setting_finding(ctx, node, what: str, findings) -> None:
    findings.append(ctx.finding(
        "DET004", node,
        f"{what} outside utils/device.py — a global torch setting "
        "changes how every later op of the process runs",
        "move the setting into utils/device.py (and restore it where it "
        "is scoped); for a value-neutral setting, "
        + _pragma_hint("DET004"),
    ))


def _check_torch_setting(ctx, node, name, findings) -> None:
    if not (name in _TORCH_SETTING_CALLS or name.startswith(_TORCH_SETTING_PREFIXES)):
        return
    if _settings_owner(ctx):
        return
    _setting_finding(ctx, node, f"`{name}()`", findings)


def _check_backends_assign(ctx, node, findings) -> None:
    if _settings_owner(ctx):
        return
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in targets:
        dotted = lint.call_name(t) if isinstance(t, ast.Attribute) else ""
        if dotted.startswith("torch.backends."):
            _setting_finding(ctx, t, f"assignment to `{dotted}`", findings)


# ---------------- DET003 ----------------

def _iterated_exprs(node: ast.AST) -> list[ast.AST]:
    """Expressions whose iteration order this node consumes."""
    out: list[ast.AST] = []
    if isinstance(node, ast.For):
        out.append(node.iter)
    elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                           ast.DictComp)):
        out.extend(gen.iter for gen in node.generators)
    elif isinstance(node, ast.Starred):
        out.append(node.value)
    elif isinstance(node, ast.Call):
        name = lint.call_name(node)
        if name in _ITER_CALLS and node.args:
            out.append(node.args[0])
        elif name.endswith(".join") and node.args:
            out.append(node.args[0])
    return out


_EMPTY_KINDS: dict[str, str] = {}


def _is_set_expr(expr: ast.AST, kinds: dict[str, str] = _EMPTY_KINDS) -> bool:
    """Syntactic evidence that ``expr`` is a set (hash-ordered).
    ``kinds`` resolves local names the dataflow pass proved set-typed
    (``s = set(...)`` ... ``s``)."""
    if isinstance(expr, ast.Set):
        return True
    if isinstance(expr, ast.SetComp):
        return True
    if isinstance(expr, ast.Name):
        return kinds.get(expr.id) == "set"
    if isinstance(expr, ast.Call):
        name = lint.call_name(expr)
        if name in ("set", "frozenset"):
            return True
        # repo idiom: accessors named *_set() return sets
        # (MemberSim.crashed_set / acceptor_set / learner_set)
        if name.rsplit(".", 1)[-1].endswith("_set"):
            return True
        if name.rsplit(".", 1)[-1] in (
            "union", "intersection", "difference", "symmetric_difference"
        ):
            return True
    if isinstance(expr, ast.BinOp) and isinstance(
        expr.op, (ast.Sub, ast.BitAnd, ast.BitOr, ast.BitXor)
    ):
        return (
            _is_set_expr(expr.left, kinds)
            or _is_set_expr(expr.right, kinds)
        )
    return False


def _is_dict_view(expr: ast.AST, kinds: dict[str, str] = _EMPTY_KINDS) -> bool:
    if isinstance(expr, ast.Name):
        return kinds.get(expr.id) == "dictview"
    return (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr in _DICT_VIEW_METHODS
        and not expr.args
    )


def _expr_kind(expr: ast.AST, kinds: dict[str, str]) -> str | None:
    if _is_set_expr(expr, kinds):
        return "set"
    if _is_dict_view(expr, kinds):
        return "dictview"
    return None


def _scope_kinds(scope: ast.AST) -> dict[str, str]:
    """Dataflow pass for DET003: names in ``scope`` (a function or the
    module; nested defs are separate scopes) whose EVERY binding is a
    set expression or dict view.  Conservative by construction — any
    other binding (non-set assignment, for-target, unpacking, walrus)
    poisons the name, so a reassigned local never false-positives.
    Name-to-name chains (``t = s``) resolve via a short fixpoint."""
    walk = list(lint._walk_scope(scope))
    # parameters are caller-controlled: a param conditionally shadowed
    # by a set assignment (`if s is None: s = set(...)`) must never be
    # tracked — the caller may pass a sorted list
    always_bad: set[str] = set()
    args = getattr(scope, "args", None)
    if args is not None:
        always_bad.update(
            a.arg for a in args.posonlyargs + args.args + args.kwonlyargs
        )
        for va in (args.vararg, args.kwarg):
            if va is not None:
                always_bad.add(va.arg)
    for node in walk:
        if isinstance(node, ast.ExceptHandler) and node.name:
            always_bad.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            always_bad.update(
                (a.asname or a.name).split(".")[0] for a in node.names
            )
    kinds: dict[str, str] = {}
    for _ in range(4):  # fixpoint for short assignment chains
        bad: set[str] = set(always_bad)
        new: dict[str, str] = {}

        def bind(name: str, kind: str | None) -> None:
            if kind is None or (name in new and new[name] != kind):
                bad.add(name)
            else:
                new[name] = kind

        for node in walk:
            if isinstance(node, ast.Assign):
                if len(node.targets) == 1 and isinstance(
                    node.targets[0], ast.Name
                ):
                    bind(node.targets[0].id, _expr_kind(node.value, kinds))
                else:  # unpacking / chained / attribute targets
                    for t in node.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                bad.add(n.id)
            elif isinstance(node, ast.AnnAssign):
                if isinstance(node.target, ast.Name):
                    if node.value is not None:
                        bind(node.target.id,
                             _expr_kind(node.value, kinds))
            elif isinstance(node, ast.AugAssign):
                # |=/-=/&= preserve set-ness; any other aug on a
                # tracked name poisons it
                if isinstance(node.target, ast.Name) and not isinstance(
                    node.op, (ast.BitOr, ast.BitAnd, ast.BitXor, ast.Sub)
                ):
                    bad.add(node.target.id)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        bad.add(n.id)
            elif isinstance(node, ast.NamedExpr):
                if isinstance(node.target, ast.Name):
                    bind(node.target.id, _expr_kind(node.value, kinds))
            elif isinstance(node, (ast.comprehension,)):
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        bad.add(n.id)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        for n in ast.walk(item.optional_vars):
                            if isinstance(n, ast.Name):
                                bad.add(n.id)
        resolved = {n: k for n, k in new.items() if n not in bad}
        if resolved == kinds:
            break
        kinds = resolved
    return kinds


def _order_consumed_safely(node: ast.AST) -> bool:
    """Is the *iteration context itself* wrapped in an order-
    insensitive consumer (``sorted(list(S))``, ``len([... for ...])``,
    membership tests)?"""
    parent = getattr(node, "paxlint_parent", None)
    if isinstance(parent, ast.Call):
        if lint.call_name(parent) in _ORDER_SAFE_CALLS:
            return True
    if isinstance(parent, ast.Compare):
        return True  # subset/equality tests are order-insensitive
    return False


def _check_unordered(ctx, node, expr, in_scope, findings,
                     local_kinds=lambda node: _EMPTY_KINDS) -> None:
    if not in_scope(node):
        return
    if _order_consumed_safely(node):
        return
    kinds = local_kinds(node)
    via = (
        f" (local `{expr.id}` is set-typed by assignment)"
        if isinstance(expr, ast.Name) else ""
    )
    if _is_set_expr(expr, kinds):
        findings.append(ctx.finding(
            "DET003", expr,
            "iteration over a set — hash order can escape into "
            f"logs/serialized bytes{via}",
            "wrap in sorted(...) where the order leaves the process; "
            + _pragma_hint("DET003"),
        ))
    elif _is_dict_view(expr, kinds):
        fn = lint.enclosing_function(node)
        if fn is not None and lint.is_sink_function(fn):
            findings.append(ctx.finding(
                "DET003", expr,
                "dict-view iteration feeding a serialization sink — "
                "insertion order escapes the process",
                "sort the items (sorted(d.items())) or use "
                "json.dumps(..., sort_keys=True); "
                + _pragma_hint("DET003"),
            ))
