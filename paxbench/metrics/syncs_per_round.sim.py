"""``syncs_per_round.sim`` (run loop): synchronizing CUDA calls of the
window (torch's sync debug mode) over its rounds."""


def read(r):
    rounds = r.counters.get("rounds", 0)
    return r.syncs / rounds if rounds and r.syncs is not None else None
