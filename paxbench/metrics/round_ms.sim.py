"""``round_ms.sim`` (run loop): the window's wall over the rounds the
port's round functions ran in it (``utils/counters`` ``rounds``)."""


def read(r):
    rounds = r.counters.get("rounds", 0)
    return r.window_s * 1e3 / rounds if rounds else None
