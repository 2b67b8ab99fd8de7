"""The port's analysis tier: artifact schema validation, lane chunking,
the bounded triage-dump namespace, the model checker (``modelcheck``
with its churn and controller siblings ``mc_member`` and ``mc_control``),
paxlint (``lint`` with its rule families ``rules_det``, ``rules_torch``,
``rules_ctl``, ``rules_shard`` and ``fix``), the entry registry
(``registry``), the per-round audit (``audit``), the shard tier
(``shard_audit``, ``shard_rules``) and the runner-build census
(``buildcount``).

Submodules load lazily, as the JAX package's ``analysis`` does: the
schema, chunking, triage, paxlint, the registry and the checker's codec
half import no torch.
"""

_SUBMODULES = (
    "artifact_schema", "audit", "buildcount", "chunking", "fix", "lint",
    "mc_control", "mc_member", "modelcheck", "registry", "rules_ctl",
    "rules_det", "rules_shard", "rules_torch", "shard_audit", "shard_rules",
    "triage",
)


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"tpu_paxos_torch.analysis.{name}")
    raise AttributeError(
        f"module 'tpu_paxos_torch.analysis' has no attribute {name!r}"
    )
