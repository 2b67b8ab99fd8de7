"""Crash-rejoin durability and host-injection replay as a library: a node
fail-stops, the cluster keeps going, the node restores from its
checkpoint and catches up through anti-entropy, and the whole
wall-clock-paced scenario replays bit-identically from its recorded
injection log (the twin of ``examples/05_crash_rejoin_replay.py``).

    python -m tpu_paxos_torch.examples.crash_rejoin_replay [--device cpu]
"""

import os
import tempfile

from tpu_paxos_torch import checkpoint
from tpu_paxos_torch.examples import device_arg
from tpu_paxos_torch.harness import validate
from tpu_paxos_torch.membership import MemberSim


def main(argv=None) -> None:
    device = device_arg(argv, __doc__)
    ms = MemberSim(n_nodes=5, n_instances=64, seed=9, device=device)

    # grow to three acceptors, commit a value
    for target in (1, 2):
        change = ms.add_acceptor(target)
        assert ms.run_until(lambda: ms.applied(change), max_rounds=3000)
    ms.propose(0, 100)
    assert ms.run_until(lambda: ms.chosen(100))

    with tempfile.TemporaryDirectory() as d:
        # node 2 fail-stops; snapshot its (frozen) durable state, the
        # restart artifact a real deployment keeps on disk
        ms.crash(2)
        ck = os.path.join(d, "node2.npz")
        checkpoint.save(ck, ms.state, meta={"crashed_node": 2})

        # progress continues on the surviving majority
        for v in (101, 102):
            ms.propose(0, v)
            assert ms.run_until(lambda: ms.chosen(v))

        # restart: restore from the checkpoint, rejoin, catch up
        ms.rejoin_from_checkpoint(2, ck)
        assert ms.run_until(
            lambda: {100, 101, 102} <= set(ms.applied_log(2).tolist()), max_rounds=3000
        )
        validate.check_prefix_consistency([ms.applied_log(i) for i in range(5)])
        print(
            f"node 2 rejoined from its checkpoint and caught up "
            f"({len(ms.applied_log(2))} values applied); prefix consistency green"
        )

        # the recorded injection schedule replays the entire scenario,
        # crash and rejoin included, bit-identically
        inj = os.path.join(d, "injections.json")
        ms.save_injections(inj)
        replayed = MemberSim.replay(inj, device=device)
        assert replayed.decision_log() == ms.decision_log()
        print("recorded run and replay decision logs are byte-identical")


if __name__ == "__main__":
    main()
