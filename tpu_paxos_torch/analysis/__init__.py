"""The port's analysis tier: artifact schema validation, lane chunking,
the bounded triage-dump namespace, the model checker (``modelcheck``
with its churn and controller siblings ``mc_member`` and ``mc_control``)
and the shard certificate's lane drivers (``shard_audit``).

Submodules load lazily, as the JAX package's ``analysis`` does: the
schema, chunking, triage and the checker's codec half import no torch.
"""

_SUBMODULES = (
    "artifact_schema", "chunking", "mc_control", "mc_member",
    "modelcheck", "shard_audit", "triage",
)


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"tpu_paxos_torch.analysis.{name}")
    raise AttributeError(
        f"module 'tpu_paxos_torch.analysis' has no attribute {name!r}"
    )
