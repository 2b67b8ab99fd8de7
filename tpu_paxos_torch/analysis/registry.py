"""Auditable-entry-point registry of the port (port of
``tpu_paxos/analysis/registry.py``).

The audit (``analysis/audit.py``) measures what a canonical small run of
each entry point costs a round, so every surface of the engines that
launches a hand kernel or enters a mesh run must be *registered*: each
provider module (``AUDIT_PROVIDERS``, the port's counterparts of JAX's
fourteen) defines an ``audit_entries()`` function returning
:class:`AuditEntry` objects under the JAX package's 28 entry names.  The
registry lives WITH the engines: a launching surface added to a provider
without registering it fails the audit's unregistered-surface sweep
(``audit.sweep_module``), which statically finds every call of a
``*_cuda`` kernel wrapper, ``kbuild.load``, ``<mesh>.run`` or
``on_lanes`` in a provider file and requires the enclosing function's
name to appear in some entry's ``covers`` or in the module's
``AUDIT_EXEMPT`` dict (name -> reason).

JAX's entries trace IR; the port has none, so the IR-only fields of
JAX's ``AuditEntry`` (``x64``, ``const_budget``, ``hlo_build``,
``hlo_golden``, ``donate_argnums``, ``cost``, ``mesh_axes``, ``allow``)
have no meaning here and are left out.  What an entry pins instead is
its run's rounds, kernel calls, host reads and collectives (and on a
card its syncs and launches), in ``analysis/launch_budget.json``.

Import discipline: this module is pure stdlib.  ``collect()`` imports
the providers (which import torch); ``AuditEntry.build`` runs only when
the audit calls it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

#: Modules whose launching surfaces are subject to the audit (the port's
#: counterparts of JAX's ``AUDIT_PROVIDERS``, in its order).
AUDIT_PROVIDERS = (
    "tpu_paxos_torch.core.sim",
    "tpu_paxos_torch.core.simkern",
    "tpu_paxos_torch.core.fastwin",
    "tpu_paxos_torch.core.fast",
    "tpu_paxos_torch.membership.engine",
    "tpu_paxos_torch.parallel.sharded",
    "tpu_paxos_torch.parallel.sharded_sim",
    "tpu_paxos_torch.fleet.runner",
    "tpu_paxos_torch.fleet.member_runner",
    "tpu_paxos_torch.analysis.modelcheck",
    "tpu_paxos_torch.analysis.mc_member",
    "tpu_paxos_torch.serve.driver",
    "tpu_paxos_torch.serve.fleet",
    "tpu_paxos_torch.serve.control",
)


@dataclasses.dataclass(frozen=True)
class AuditEntry:
    """One auditable entry point: a canonical small run.

    ``build(device)`` returns ``(fn, args)`` on ``device``; the audit
    calls ``fn(*args)`` once and counts what the call did.  Building must
    be deterministic (fixed shapes, fixed seed): the budget pins exactly
    this run, whose rounds are data and so the same on every device.
    """

    #: Report/budget key: one of the JAX package's 28 entry names.
    name: str
    #: (device) -> (fn, args): the canonical run.
    build: Callable[..., tuple]
    #: Launching-surface names in the provider file this entry
    #: exercises (function qualnames; a name covers its nested defs).
    covers: tuple = ()
    #: --- shard tier (analysis/shard_audit.py) ---
    #: (mesh) -> (fn, args): the canonical run laid out over THAT mesh
    #: (a ``parallel/mesh.Mesh``); opts the entry into the SH303
    #: collective census over the mesh grid.
    shard_build: Callable | None = None
    #: (n_shards=1) -> (family, global_state_tree) on the host for
    #: SH301/SH302: every leaf must match a committed partition rule
    #: (``parallel/partition_rules.py``) under the family prefix, and the
    #: per-rank slices' bytes are pinned per mesh shape (``n_shards``:
    #: the mesh size a sharded state's per-shard queues are laid for;
    #: lane-stacked states ignore it).
    shard_state: Callable | None = None


class RegistryError(Exception):
    """A provider is malformed: missing audit_entries(), duplicate
    entry names, or a non-AuditEntry in the returned list."""


def provider_module(name: str):
    import importlib

    return importlib.import_module(name)


def exemptions(mod) -> dict[str, str]:
    """The module's declared sweep exemptions: surface name -> reason."""
    ex = getattr(mod, "AUDIT_EXEMPT", {})
    if not isinstance(ex, dict):
        raise RegistryError(
            f"{mod.__name__}.AUDIT_EXEMPT must be a dict of "
            "surface-name -> reason"
        )
    return ex


def collect(providers=AUDIT_PROVIDERS) -> list[AuditEntry]:
    """Import every provider and gather its registered entries.  Raises
    RegistryError on a provider without ``audit_entries()`` or on
    duplicate entry names (budgets key on the name)."""
    out: list[AuditEntry] = []
    seen: dict[str, str] = {}
    for name in providers:
        mod = provider_module(name)
        prov = getattr(mod, "audit_entries", None)
        if prov is None:
            raise RegistryError(
                f"audit provider {name} defines no audit_entries() — "
                "every engine module with launching surfaces must "
                "register its entry points (see analysis/registry.py)"
            )
        for e in prov():
            if not isinstance(e, AuditEntry):
                raise RegistryError(
                    f"{name}.audit_entries() returned a non-AuditEntry: {e!r}"
                )
            if e.name in seen:
                raise RegistryError(
                    f"duplicate audit entry name {e.name!r} "
                    f"({seen[e.name]} and {name})"
                )
            seen[e.name] = name
            out.append(e)
    return out
