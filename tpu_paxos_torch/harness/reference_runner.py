"""The reference client workload as per-proposer queues (the part of
``tpu_paxos/harness/reference_runner.py`` the CLI needs)."""

from __future__ import annotations

import numpy as np


def in_order_chains(cltcnt: int, idcnt: int) -> list[np.ndarray]:
    """Per in-order client, the id chain that must execute in order:
    clients 0..cltcnt/2-1, ids k=0..idcnt/2 (ref multi/main.cpp:398-411,
    202-212)."""
    return [
        np.asarray([c * idcnt + k for k in range(idcnt // 2 + 1)], np.int64)
        for c in range(cltcnt // 2)
    ]


def equivalent_workload(srvcnt: int, cltcnt: int, idcnt: int):
    """Client c proposes ids [c*idcnt, (c+1)*idcnt); its k-th id goes to
    server ``srvcnt - 1 - k % srvcnt`` (ref multi/main.cpp:414).
    Clients c < cltcnt/2 propose their first idcnt/2+1 ids strictly in
    order, expressed as gate chains.  Returns (workload, gates,
    in_order_vids)."""
    per_server: list[list[int]] = [[] for _ in range(srvcnt)]
    per_server_gate: list[list[int]] = [[] for _ in range(srvcnt)]
    for k in range(idcnt):
        for c in range(cltcnt):
            vid = c * idcnt + k
            sidx = srvcnt - 1 - (k % srvcnt)
            gate = vid - 1 if c < cltcnt // 2 and 1 <= k <= idcnt // 2 else -1
            per_server[sidx].append(vid)
            per_server_gate[sidx].append(gate)
    workload = [np.asarray(w, np.int32) for w in per_server]
    gates = [np.asarray(g, np.int32) for g in per_server_gate]
    return workload, gates, in_order_chains(cltcnt, idcnt)
