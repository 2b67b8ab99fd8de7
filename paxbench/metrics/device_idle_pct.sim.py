"""``device_idle_pct.sim`` (device): the share of the traced run's wall in
which no device-side event ran."""


def read(r):
    if not r.trace or r.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
