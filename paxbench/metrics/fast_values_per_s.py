"""``fast_values_per_s``: instances chosen in the window's steps (the
counts each step returned, summed on the host) over the window's whole
wall time."""


def read(r):
    return sum(s["values"] for s in r.steps) / r.window_s
