"""``fastwin_roofline`` (kernels): the bytes the traced steps'
window launches need (``yardstick.fastwin_bytes_per_launch`` with
sequential vids, times the launches), at 3.35 TB/s, over the kernel's
device time in the trace."""

from paxbench import yardstick

KERNEL = "window_kernel"


def read(r):
    if not r.trace:
        return None
    n = sum(c for name, (c, _) in r.trace["ops"].items() if KERNEL in name)
    seconds = sum(s for name, (_, s) in r.trace["ops"].items() if KERNEL in name)
    if not n or seconds <= 0:
        return None
    a, i = r.ctx.config["n_nodes"], r.ctx.config["n_instances"]
    need = n * yardstick.fastwin_bytes_per_launch(a, i, True)
    return 100.0 * need / yardstick.HBM_BYTES_PER_S / seconds
