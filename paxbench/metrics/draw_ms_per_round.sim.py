"""``draw_ms_per_round.sim`` (draws and schedule rows): host ms inside the
threefry draws and the copy plans over the window's rounds."""

SPANS = {"draws and schedule rows": ["tpu_paxos_torch.utils.prng:randint_lanes",
                                     "tpu_paxos_torch.core.net:lane_copy_plans"]}


def read(r):
    rounds = r.counters.get("rounds", 0)
    if not rounds or not r.block_calls.get("draws and schedule rows"):
        return None
    return r.blocks_ms["draws and schedule rows"] / rounds
