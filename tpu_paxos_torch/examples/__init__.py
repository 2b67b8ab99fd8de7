"""The library's usage, on the port: five runnable examples, each the twin
of the JAX package's ``examples/0N_*.py`` at the twin's own size and
printing the twin's lines.

    python -m tpu_paxos_torch.examples.fast_path [--device cpu]
    python -m tpu_paxos_torch.examples.faulty_run [--device cpu]
    python -m tpu_paxos_torch.examples.membership_churn [--device cpu]
    python -m tpu_paxos_torch.examples.sharded_and_checkpoint [--device cpu]
    python -m tpu_paxos_torch.examples.crash_rejoin_replay [--device cpu]

Each runs on the card unless told ``--device cpu``.
"""

import argparse

#: each example's JAX twin, ``examples/<twin>.py``
TWINS = {"fast_path": "01_fast_path", "faulty_run": "02_faulty_run",
         "membership_churn": "03_membership_churn",
         "sharded_and_checkpoint": "04_sharded_and_checkpoint",
         "crash_rejoin_replay": "05_crash_rejoin_replay"}


def device_arg(argv, doc: str) -> str:
    """The ``--device`` an example was given (``cuda`` by default)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv).device
