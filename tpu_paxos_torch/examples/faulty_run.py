"""The general engine as a library: dueling proposers, an in-order client
chain, and the reference's debug.conf fault rates (the twin of
``examples/02_faulty_run.py``).

    python -m tpu_paxos_torch.examples.faulty_run [--device cpu]
"""

import numpy as np

from tpu_paxos_torch.config import FaultConfig, SimConfig
from tpu_paxos_torch.core import sim
from tpu_paxos_torch.core import values as val
from tpu_paxos_torch.examples import device_arg
from tpu_paxos_torch.harness import validate


def main(argv=None) -> None:
    device = device_arg(argv, __doc__)
    cfg = SimConfig(
        n_nodes=5,
        n_instances=64,
        proposers=(0, 1),  # two dueling proposers
        seed=7,
        faults=FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2),
    )
    # proposer 0: an in-order chain (each value gated on the previous one
    # being chosen); proposer 1: independent values
    chain = np.arange(100, 108, dtype=np.int32)
    chain_gates = np.asarray([val.NONE] + chain[:-1].tolist(), np.int32)
    free = np.arange(200, 212, dtype=np.int32)
    workload = [chain, free]
    gates = [chain_gates, np.full(len(free), val.NONE, np.int32)]

    r = sim.run(cfg, workload, gates, device=device)
    assert r.done, f"no quiescence in {r.rounds} rounds"

    seqs = validate.check_all(r.learned, np.concatenate(workload))
    validate.check_in_order_clients(max(seqs, key=len), [chain])
    print(
        f"quiesced in {r.rounds} rounds; "
        f"{int((r.chosen_vid >= 0).sum())} real values chosen; "
        f"chain executed in order; invariants green"
    )
    print("value 104 lifecycle:", r.value_status(104))


if __name__ == "__main__":
    main()
