"""The port's own copy of ``tpu_paxos/analysis/artifact_schema.py``
(stdlib only there too): the port imports nothing of the JAX package,
and accepts and rejects exactly the artifacts the JAX package does, with
the same field path and message.

JSON-schema validation for shrink/repro artifacts.

A repro artifact is the contract between a failing stress run and a
future ``python -m tpu_paxos_torch repro`` (or ``python -m tpu_paxos
repro``) — often on another machine, weeks later, against a newer
checkout.  This module front-loads the check at load time with an error
that names the offending field
(``cfg.faults.drop_rate: expected int >= 0, got -3``).

The validator is a small declarative walker, not the ``jsonschema``
package.  ``ARTIFACT_FORMAT`` lives here (not in ``harness/shrink.py``)
so that schema-checking an artifact never drags in the engine stack;
shrink re-exports it.
"""

from __future__ import annotations

ARTIFACT_FORMAT = "tpu-paxos-repro-1"

_SHA256_HEX = frozenset("0123456789abcdef")

EPISODE_KINDS = ("partition", "one_way", "pause", "burst", "crash", "gray")


class ArtifactSchemaError(ValueError):
    """Artifact failed validation; ``field`` names the offender."""

    def __init__(self, field: str, problem: str):
        self.field = field
        self.problem = problem
        where = f" field {field!r}" if field else ""
        super().__init__(f"repro artifact{where}: {problem}")


# -- schema vocabulary -------------------------------------------------
# A spec is one of:
#   Int(min=..)            — int (bool excluded)
#   Str()                  — str
#   Const(v)               — exactly v
#   Nullable(spec)         — None or spec
#   ListOf(spec)           — list with every element matching spec
#   Obj({k: spec}, required=(...), extra_ok=True)
#   Any()                  — anything (extension point)

class Int:
    def __init__(self, min: int | None = None):  # noqa: A002
        self.min = min

    def check(self, v, at):
        if isinstance(v, bool) or not isinstance(v, int):
            raise ArtifactSchemaError(at, f"expected int, got {_tn(v)}")
        if self.min is not None and v < self.min:
            raise ArtifactSchemaError(
                at, f"expected int >= {self.min}, got {v}"
            )


class Str:
    def check(self, v, at):
        if not isinstance(v, str):
            raise ArtifactSchemaError(at, f"expected str, got {_tn(v)}")


class Const:
    def __init__(self, value):
        self.value = value

    def check(self, v, at):
        if v != self.value:
            raise ArtifactSchemaError(
                at, f"expected {self.value!r}, got {v!r}"
            )


class Nullable:
    def __init__(self, spec):
        self.spec = spec

    def check(self, v, at):
        if v is not None:
            self.spec.check(v, at)


class ListOf:
    def __init__(self, spec):
        self.spec = spec

    def check(self, v, at):
        if not isinstance(v, list):
            raise ArtifactSchemaError(at, f"expected list, got {_tn(v)}")
        for i, el in enumerate(v):
            self.spec.check(el, f"{at}[{i}]")


class Obj:
    def __init__(self, props: dict, required=None, extra_ok=True):
        self.props = props
        self.required = tuple(
            props.keys() if required is None else required
        )
        self.extra_ok = extra_ok

    def check(self, v, at):
        if not isinstance(v, dict):
            raise ArtifactSchemaError(at, f"expected object, got {_tn(v)}")
        for key in self.required:
            if key not in v:
                raise ArtifactSchemaError(
                    f"{at}.{key}" if at else key, "missing required field"
                )
        if not self.extra_ok:
            unknown = sorted(set(v) - set(self.props))
            if unknown:
                raise ArtifactSchemaError(
                    f"{at}.{unknown[0]}" if at else unknown[0],
                    "unknown field",
                )
        for key, spec in self.props.items():
            if key in v:
                spec.check(v[key], f"{at}.{key}" if at else key)


class Any:
    def check(self, v, at):
        pass


class Bool:
    def check(self, v, at):
        if not isinstance(v, bool):
            raise ArtifactSchemaError(at, f"expected bool, got {_tn(v)}")


class Sha256Hex:
    def check(self, v, at):
        Str().check(v, at)
        if len(v) != 64 or not set(v) <= _SHA256_HEX:
            raise ArtifactSchemaError(
                at, "expected 64 lowercase hex chars (sha256)"
            )


class OneOf:
    def __init__(self, *values):
        self.values = values

    def check(self, v, at):
        if v not in self.values:
            raise ArtifactSchemaError(
                at, f"expected one of {list(self.values)}, got {v!r}"
            )


def _tn(v) -> str:
    return "null" if v is None else type(v).__name__


# -- the artifact grammar (mirrors harness/shrink._cfg_to_dict and
# core/faults.FaultSchedule.to_dict; Episode.__post_init__ revalidates
# the semantic constraints on load) --------------------------------

# The engine-config structs are CLOSED (extra_ok=False): these dicts
# are splatted into dataclass constructors / Episode fields on load,
# where an unknown or misspelled key dies as a bare TypeError — the
# schema must name it first.  Only ``extra_checks`` (an open
# extension dict by design) and the artifact top level under a future
# format bump stay tolerant.
_EPISODE = Obj({
    "kind": OneOf(*EPISODE_KINDS),
    "t0": Int(min=0),
    "t1": Int(min=1),
    "groups": ListOf(ListOf(Int())),
    "src": ListOf(Int()),
    "dst": ListOf(Int()),
    "nodes": ListOf(Int()),
    "drop_rate": Int(min=0),
    "delay": Int(min=0),  # gray: per-message delay inflation rounds
}, required=("kind", "t0", "t1"), extra_ok=False)

_SCHEDULE = Obj(
    {"episodes": ListOf(_EPISODE)}, required=("episodes",), extra_ok=False
)

_PROTOCOL = Obj({
    "prepare_delay_min": Int(min=0),
    "prepare_delay_max": Int(min=0),
    "prepare_retry_count": Int(min=0),
    "prepare_retry_timeout": Int(min=0),
    "accept_retry_count": Int(min=0),
    "accept_retry_timeout": Int(min=0),
    "commit_retry_timeout": Int(min=0),
}, extra_ok=False)

# Per-edge [A, A] fault tables (config.EdgeFaultConfig): four square
# int matrices; squareness/range/min<=max are revalidated semantically
# by the config constructors on load — the schema names the field.
_EDGES = Obj({
    "drop_rate": ListOf(ListOf(Int(min=0))),
    "dup_rate": ListOf(ListOf(Int(min=0))),
    "min_delay": ListOf(ListOf(Int(min=0))),
    "max_delay": ListOf(ListOf(Int(min=0))),
}, extra_ok=False)

_FAULTS = Obj({
    "drop_rate": Int(min=0),
    "dup_rate": Int(min=0),
    "min_delay": Int(min=0),
    "max_delay": Int(min=0),
    "crash_rate": Int(min=0),
    "schedule": Nullable(_SCHEDULE),
    # WAN fields (written only when non-default — hence OPTIONAL, so
    # classic artifacts validate unchanged)
    "edges": Nullable(_EDGES),
    "delivery_cut": Bool(),
}, required=(
    "drop_rate", "dup_rate", "min_delay", "max_delay", "crash_rate",
    "schedule",
), extra_ok=False)

_CFG = Obj({
    "n_nodes": Int(min=1),
    "n_instances": Int(min=1),
    "proposers": ListOf(Int(min=0)),
    "seed": Int(min=0),
    "max_rounds": Int(min=1),
    "assign_window": Int(min=1),
    "protocol": _PROTOCOL,
    "faults": _FAULTS,
}, extra_ok=False)

# Controlled-serve replay block (serve/control.save_artifact).  CLOSED
# like the engine-config structs: these dicts are splatted into
# ControlPolicy / ServeSLO constructors on load.  The whole block is
# OPTIONAL and absent from every classic sim/sharded artifact, so
# existing artifacts stay byte-identical.
_CONTROL_POLICY = Obj({
    "n_tiers": Int(min=1),
    "defer_tier": Int(min=1),
    "shed_tier": Int(min=1),
    "burn_low_milli": Int(min=0),
    "patience": Int(min=1),
    "ladder": ListOf(Int(min=1)),
    "table": ListOf(Obj({
        "cause_id": Int(min=0),
        "action": OneOf("shed", "hold", "never"),
    }, extra_ok=False)),
}, extra_ok=False)

_CONTROL_DECISION = Obj({
    "dispatch": Int(min=1),
    "action": OneOf("degrade", "hold", "restore"),
    "level": Int(min=0),
    "degraded": Bool(),
    "cause_ids": ListOf(Int(min=0)),
    "windows": ListOf(Int(min=0)),
}, extra_ok=False)

_SERVE_SLO = Obj({
    "latency_rounds": Int(min=1),
    "budget_milli": Int(min=1),
    "burn_breach_milli": Int(min=0),
}, extra_ok=False)

_SERVE = Obj({
    "arrivals": ListOf(ListOf(Int(min=0))),
    "priorities": Nullable(ListOf(ListOf(Int(min=0)))),
    "rounds_per_window": Int(min=1),
    "windows_per_dispatch": Int(min=1),
    "admit_width": Int(min=1),
    "window_rounds": Int(min=1),
    "slo": Nullable(_SERVE_SLO),
    "control": Nullable(_CONTROL_POLICY),
    "decisions": ListOf(_CONTROL_DECISION),
}, extra_ok=False)

ARTIFACT_SCHEMA = Obj({
    "format": Const(ARTIFACT_FORMAT),
    # replay engine selector (optional; absent = "sim").  "sharded"
    # artifacts also record the device count their decision log was
    # produced at — placement, hence the log, depends on it.  "serve"
    # artifacts replay through serve/control.reproduce and carry the
    # "serve" block (arrivals/priorities/policy/decision trail).
    "engine": OneOf("sim", "sharded", "serve"),
    "devices": Int(min=1),
    "cfg": _CFG,
    "workload": ListOf(ListOf(Int())),
    "gates": Nullable(ListOf(ListOf(Int()))),
    "chains": ListOf(ListOf(Int())),
    "extra_checks": Obj({}, required=()),
    "violation": Str(),
    "decision_log_sha256": Sha256Hex(),
    "rounds": Int(min=0),
    "serve": _SERVE,
}, required=(
    "format", "cfg", "workload", "gates", "chains", "violation",
    "decision_log_sha256",
))


def validate_artifact(art) -> None:
    """Raise ArtifactSchemaError naming the offending field if ``art``
    is not a well-formed repro artifact."""
    if not isinstance(art, dict):
        raise ArtifactSchemaError("", f"expected object, got {_tn(art)}")
    # judge the format stamp before anything else: an artifact from a
    # different format version should be rejected AS that, not as
    # missing whichever field this version happens to require first
    Const(ARTIFACT_FORMAT).check(art.get("format"), "format")
    ARTIFACT_SCHEMA.check(art, "")
    # cross-field: a proposer index must address a real node, and the
    # workload must carry one queue per proposer — both produce
    # baffling downstream shape errors if left to the engine
    cfg = art["cfg"]
    if "proposers" in cfg and "n_nodes" in cfg:
        for i, p in enumerate(cfg["proposers"]):
            if p >= cfg["n_nodes"]:
                raise ArtifactSchemaError(
                    f"cfg.proposers[{i}]",
                    f"proposer {p} out of range for n_nodes="
                    f"{cfg['n_nodes']}",
                )
        if len(art["workload"]) != len(cfg["proposers"]):
            raise ArtifactSchemaError(
                "workload",
                f"{len(art['workload'])} queues for "
                f"{len(cfg['proposers'])} proposers",
            )
    if art["gates"] is not None and len(art["gates"]) != len(
        art["workload"]
    ):
        raise ArtifactSchemaError(
            "gates",
            f"{len(art['gates'])} gate rows for "
            f"{len(art['workload'])} workload queues",
        )
    # a serve artifact and its serve block imply each other, and the
    # plan arrays must stay row-parallel with the workload streams
    if (art.get("engine") == "serve") != ("serve" in art):
        raise ArtifactSchemaError(
            "serve",
            "engine \"serve\" and the serve block imply each other",
        )
    if "serve" in art:
        sv = art["serve"]
        for key in ("arrivals", "priorities"):
            rows = sv.get(key)
            if rows is not None and len(rows) != len(art["workload"]):
                raise ArtifactSchemaError(
                    f"serve.{key}",
                    f"{len(rows)} rows for "
                    f"{len(art['workload'])} workload streams",
                )
