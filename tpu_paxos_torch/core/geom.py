"""Protocol constants of the engine (the part of
``tpu_paxos/core/geom.py`` that the unpadded engine reads).

The JAX package threads the protocol liveness constants either as
compile-time ints (``static_protocol``) or as traced scalars for its
padded envelopes.  The port runs eagerly, so one field set of plain
ints serves; geometry envelopes wait for the runtime-data slice.
"""

from __future__ import annotations

from typing import NamedTuple

from tpu_paxos_torch.config import ProtocolConfig


class ProtocolKnobs(NamedTuple):
    prepare_delay_min: int
    prepare_delay_max: int
    prepare_retry_count: int
    prepare_retry_timeout: int
    accept_retry_count: int
    accept_retry_timeout: int
    commit_retry_timeout: int
    stall_patience: int


def static_protocol(pc: ProtocolConfig, stall_patience: int = 8) -> ProtocolKnobs:
    """The protocol constants of ``pc`` plus the idle-liveness restart
    patience (``sim.IDLE_RESTART_ROUNDS``)."""
    return ProtocolKnobs(
        prepare_delay_min=pc.prepare_delay_min,
        prepare_delay_max=pc.prepare_delay_max,
        prepare_retry_count=pc.prepare_retry_count,
        prepare_retry_timeout=pc.prepare_retry_timeout,
        accept_retry_count=pc.accept_retry_count,
        accept_retry_timeout=pc.accept_retry_timeout,
        commit_retry_timeout=pc.commit_retry_timeout,
        stall_patience=int(stall_patience),
    )
