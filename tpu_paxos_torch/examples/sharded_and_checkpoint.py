"""Scale-out and checkpoint as a library: run the general engine sharded
over one rank per visible device (the thread-rank mesh of
``parallel/mesh.py``), checkpoint mid-run, and resume bit-identically
(the twin of ``examples/04_sharded_and_checkpoint.py``).

    python -m tpu_paxos_torch.examples.sharded_and_checkpoint [--device cpu]
"""

import os
import tempfile

import numpy as np

from tpu_paxos_torch import checkpoint
from tpu_paxos_torch.config import FaultConfig, SimConfig
from tpu_paxos_torch.core import sim
from tpu_paxos_torch.examples import device_arg
from tpu_paxos_torch.harness import validate
from tpu_paxos_torch.parallel import mesh as pmesh
from tpu_paxos_torch.parallel import sharded_sim
from tpu_paxos_torch.utils import prng


def main(argv=None) -> None:
    device = device_arg(argv, __doc__)
    mesh = pmesh.make_instance_mesh(device=device)
    cfg = SimConfig(
        n_nodes=5,
        n_instances=256 - 256 % mesh.size,
        proposers=(0, 1),
        seed=1,
        faults=FaultConfig(drop_rate=500, dup_rate=1000, max_delay=2),
    )
    r = sharded_sim.run_sharded(cfg, mesh)
    assert r.done
    validate.check_all(r.learned, r.expected_vids)
    print(f"sharded over {mesh.size} device(s): {r.rounds} rounds, green")

    # checkpoint/resume (unsharded engine; any state tree works)
    workload = sim.default_workload(cfg)
    pend, gate, tail, c = sim.prepare_queues(cfg, workload)
    root = prng.root_key(cfg.seed)
    state = sim.init_state(cfg, pend, gate, tail, root, device=device)
    round_fn = sim.build_engine(cfg, c, device=device)
    for _ in range(4):  # a few rounds, then snapshot
        state = round_fn(root, state)
    expected = np.unique(np.concatenate(workload))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "mid_run")
        checkpoint.save(path, state)
        restored, _meta = checkpoint.restore(path, state)
        # run_state consumes its state, so the restored copy runs first
        b = sim.run_state(cfg, restored, root, expected, c)
        a = sim.run_state(cfg, state, root, expected, c)
        assert (a.chosen_vid == b.chosen_vid).all() and a.rounds == b.rounds
    print("checkpoint at round 4 resumed bit-identically")


if __name__ == "__main__":
    main()
