"""Fast path as a library: drive a batch of instances to chosen and
validate the result (the twin of ``examples/01_fast_path.py``).

    python -m tpu_paxos_torch.examples.fast_path [--device cpu]
"""

import numpy as np
import torch

from tpu_paxos_torch.core import fast
from tpu_paxos_torch.examples import device_arg
from tpu_paxos_torch.harness import validate

N_NODES = 5
N_INSTANCES = 1 << 16


def main(argv=None) -> None:
    device = device_arg(argv, __doc__)
    state = fast.init_state(N_INSTANCES, N_NODES, device=device)
    # one value per instance
    vids = torch.arange(N_INSTANCES, dtype=torch.int32, device=state.learned.device)
    state, n_chosen = fast.choose_all(state, vids, proposer=0, quorum=N_NODES // 2 + 1)
    assert int(n_chosen) == N_INSTANCES

    # every node agrees, every value chosen exactly once
    validate.check_all(fast.learned_ia(state), np.arange(N_INSTANCES))
    print(f"{int(n_chosen)} instances chosen, invariants green")


if __name__ == "__main__":
    main()
