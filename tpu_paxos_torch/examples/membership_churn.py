"""Live membership change as a library: grow a 1-node cluster to 5
acceptors through the log while client values flow, then verify prefix
consistency, the member/ variant's core property (the twin of
``examples/03_membership_churn.py``).

    python -m tpu_paxos_torch.examples.membership_churn [--device cpu]
"""

from tpu_paxos_torch.examples import device_arg
from tpu_paxos_torch.harness import validate
from tpu_paxos_torch.membership import MemberSim


def main(argv=None) -> None:
    device = device_arg(argv, __doc__)
    ms = MemberSim(n_nodes=5, n_instances=64, seed=3, device=device)

    vid = 100
    for target in range(1, 5):
        # a client value and a membership change race through the log
        ms.propose(0, vid)
        change = ms.add_acceptor(target)
        assert ms.run_until(lambda: ms.applied(change), max_rounds=3000)
        vid += 1

    assert ms.run_until(lambda: all(ms.chosen(v) for v in range(100, vid)), max_rounds=3000)
    validate.check_prefix_consistency([ms.applied_log(i) for i in range(5)])
    print(
        f"grew to {len(ms.acceptor_set(0))} acceptors with values in flight; "
        f"prefix consistency green"
    )


if __name__ == "__main__":
    main()
