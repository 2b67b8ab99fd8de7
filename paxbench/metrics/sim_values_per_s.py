"""``sim_values_per_s``: workload values chosen in the window's runs over
the window's whole wall time (runs back to back; the run in progress at
``--seconds`` is finished and counted).  No-op fills do not count."""


def read(r):
    return sum(s["values"] for s in r.steps) / r.window_s
