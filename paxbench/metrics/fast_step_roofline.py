"""``fast_step_roofline`` (fast step): the bytes a step needs, from
shapes alone, whatever implements it (each input read once, each output
written once: ``reps`` times ``yardstick.fastwin_bytes_per_launch`` with
sequential vids for a ``windows`` step, ``yardstick.takeover_bytes`` for
a ``takeover``), at 3.35 TB/s, over the window's steps' synchronized wall
(call to counts on the host)."""

from paxbench import yardstick


def read(r):
    a, i = r.ctx.config["n_nodes"], r.ctx.config["n_instances"]
    mix = r.ctx.mix
    if mix["step"] == "windows":
        need = mix["reps"] * yardstick.fastwin_bytes_per_launch(a, i, True)
    else:
        need = yardstick.takeover_bytes(a, i)
    wall = sum(s["latency_s"] for s in r.steps)
    return 100.0 * need * len(r.steps) / yardstick.HBM_BYTES_PER_S / wall
