"""Traffic kind ``sim_runs``: whole general-engine runs back to back, a
closed loop of verdicts (``tpu_paxos_torch.core.sim.run``).

The configuration gives the cluster and the log: ``n_nodes``,
``n_instances``, ``assign_window`` and ``max_rounds``; the workload is
:func:`paxbench.yardstick.default_workload` over the mix's proposers.  The
mix gives the proposers and the i.i.d. network faults (``drop_rate`` and
``dup_rate`` per 10,000, ``min_delay``..``max_delay`` rounds).  Run ``k``
of a window takes the engine seed ``derive(seed, k)``; the workload is the
same in every run, so the seed changes only the faults' draws.

A step is one run; its answer is the run's decision log and learner
state, which ``reference/sim_guarantees.py`` holds to the guarantees once
the window has closed.  A run's values are the workload values it chose
(no-op fills do not count).
"""

from __future__ import annotations

import numpy as np
import torch

from paxbench import yardstick
from paxbench.reference import sim_guarantees

#: Rounds of the warm-up run: both mixes launch both kernels by round 12.
WARM_ROUNDS = 16

# Host blocks of a round, for the trace's idle gaps and the layer metrics.
SPANS = {
    "run entry (own code)": ["tpu_paxos_torch.core.sim:run"],
    "run state (own code)": ["tpu_paxos_torch.core.sim:run_state"],
    "run loop": ["tpu_paxos_torch.core.sim:run_lanes"],
    "round: acceptor side": ["tpu_paxos_torch.core.sim:_lane_round"],
    "round: proposer side": ["tpu_paxos_torch.core.sim:_proposer_round"],
    "draws and schedule rows": ["tpu_paxos_torch.utils.prng:randint_lanes",
                                "tpu_paxos_torch.core.net:lane_copy_plans"],
    "predicate reads": ["tpu_paxos_torch.core.sim:_any",
                        "tpu_paxos_torch.core.sim:_global_max",
                        "tpu_paxos_torch.core.sim:_global_counts"],
    "kernel dispatch": ["tpu_paxos_torch.core.simkern:store_accepts",
                        "tpu_paxos_torch.core.simkern:accum_acks"],
    "engine build": ["tpu_paxos_torch.core.sim:build_engine"],
    "queues and upload": ["tpu_paxos_torch.core.sim:prepare_queues",
                          "tpu_paxos_torch.core.sim:init_state"],
    "result": ["tpu_paxos_torch.core.sim:to_result"],
}


class Driver:
    def __init__(self, ctx):
        from tpu_paxos_torch.config import FaultConfig, SimConfig
        from tpu_paxos_torch.core import sim

        self.ctx = ctx
        self._sim = sim
        c, m = ctx.config, ctx.mix
        self.proposers = tuple(m["proposers"])
        self.n_instances = c["n_instances"]
        self.workload = yardstick.default_workload(self.n_instances, len(self.proposers))
        faults = FaultConfig(drop_rate=m["drop_rate"], dup_rate=m["dup_rate"],
                             min_delay=m["min_delay"], max_delay=m["max_delay"])

        def cfg(seed: int, max_rounds: int = c["max_rounds"]):
            return SimConfig(n_nodes=c["n_nodes"], n_instances=self.n_instances,
                             proposers=self.proposers, seed=seed,
                             assign_window=c["assign_window"], max_rounds=max_rounds,
                             faults=faults)

        self.cfg = cfg
        self.results = []  # (engine seed, SimResult) of every run made

    def engine_seed(self, k: int) -> int:
        return self.ctx.derive("run", k)

    def warm(self) -> None:
        """A run cut to :data:`WARM_ROUNDS` rounds at the cell's own
        shapes, on a seed no window run takes: the queues, the upload,
        the round's draws and both kernels, and the result."""
        self._run(self.ctx.derive("warm"), keep=False, max_rounds=WARM_ROUNDS)

    def _run(self, seed: int, keep: bool = True, **cut):
        res = self._sim.run(self.cfg(seed, **cut), self.workload, device=self.ctx.device)
        if keep:
            self.results.append((seed, res))
        return res

    def step(self, k: int) -> dict:
        res = self._run(self.engine_seed(k))
        return {"rounds": int(res.rounds)}

    def replay(self) -> dict:
        """Window run 0 again, with the same engine seed (a run is a pure
        function of its config and workload)."""
        res = self._run(self.engine_seed(0))
        return {"rounds": int(res.rounds)}

    def values(self, k: int) -> int:
        return int(np.count_nonzero(self.results[k][1].chosen_vid >= 0))

    def release(self) -> None:
        if self.ctx.device != "cpu":
            torch.cuda.empty_cache()

    def check(self):
        """``(numbers, failed, attempted)``: each guarantee's worst run,
        with its limit, the runs that broke any, and the runs compared
        (every run the window, the launch count and the trace made)."""
        worst = dict.fromkeys(sim_guarantees.GUARANTEES, 0)
        failed = 0
        for _, res in self.results:
            got = sim_guarantees.check_run(res.learned, res.chosen_vid, res.done,
                                           self.workload, self.proposers, self.n_instances)
            failed += any(got.values())
            for name, v in got.items():
                worst[name] = max(worst[name], v)
        return [(name, v, 0) for name, v in worst.items()], failed, len(self.results)


def build(ctx) -> Driver:
    return Driver(ctx)
