"""Membership engine — member/ parity (live reconfiguration), in PyTorch
(port of ``tpu_paxos/membership``).

Roles form a ladder Learner <-> Proposer <-> Acceptor with six
transition types (ref member/paxos.cpp:61-69); composite operations like
AddAcceptor ride the log as a single value (ref member/paxos.cpp:650-657);
every node applies changes when its own learner frontier reaches them;
acceptor-set changes bump a Version that gates prepare/accept processing
(ref member/paxos.cpp:1702, 1747); and a change is "Applied" once a
majority of the current acceptors have learned it (ref
member/paxos.cpp:1716-1733), the sequencing point the churn harness waits
on (ref member/main.cpp:138-140).
"""

from tpu_paxos_torch.membership.churn_table import (
    WAIT_APPLIED,
    WAIT_CHOSEN,
    WAIT_NONE,
    ChurnEvent,
    ChurnSchedule,
    ChurnTable,
    encode_churn,
    encode_churn_batch,
    grow_shrink_schedule,
)
from tpu_paxos_torch.membership.engine import (
    ADD_ACCEPTOR,
    DEL_ACCEPTOR,
    ChurnEngine,
    ChurnResult,
    MemberSim,
    change_vid,
    decision_log_of,
    decode_change,
    is_change_vid,
    membership_suffix,
)

__all__ = [
    "ADD_ACCEPTOR",
    "DEL_ACCEPTOR",
    "WAIT_APPLIED",
    "WAIT_CHOSEN",
    "WAIT_NONE",
    "ChurnEngine",
    "ChurnEvent",
    "ChurnResult",
    "ChurnSchedule",
    "ChurnTable",
    "MemberSim",
    "change_vid",
    "decision_log_of",
    "decode_change",
    "encode_churn",
    "encode_churn_batch",
    "grow_shrink_schedule",
    "is_change_vid",
    "membership_suffix",
]
