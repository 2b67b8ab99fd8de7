"""``htod_copies_per_round.sim`` (draws and schedule rows): host-to-device
copies in the traced run (the profiler's ``Memcpy HtoD`` events) over its
rounds."""


def read(r):
    rounds = r.trace_counters.get("rounds", 0) if r.trace else 0
    if not rounds:
        return None
    return sum(n for name, (n, _) in r.trace["ops"].items()
               if name.startswith("Memcpy HtoD")) / rounds
