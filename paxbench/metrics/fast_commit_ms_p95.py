"""``fast_commit_ms_p95``: the 95th percentile (nearest rank) over every
step of the window of the wall time from the step's call to its counts
on the host: the commit latency a client of the batched log waits."""

import math
import sys


def read(r):
    lat = sorted(s["latency_s"] for s in r.steps)
    print(f"fast_commit_ms_p95 over {len(lat)} steps", file=sys.stderr)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
