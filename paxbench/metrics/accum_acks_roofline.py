"""``accum_acks_roofline`` (kernels): the bytes the ``simkern`` accum_acks
kernel needs on its operands, at 3.35 TB/s, over its device time in the
traced run.

The traced run repeats window run 0 with its engine seed; the repeat
before it counts each launch's bytes at the dispatcher
(``yardstick.simkern_bytes_needed`` on the operands as given, before the
kernel updates them).  A launch count that differs between the two reads
nothing."""

from paxbench import yardstick

TARGET = "tpu_paxos_torch.core.simkern:accum_acks"
KERNEL = "accum_acks_kernel"

LAUNCH_HOOKS = {TARGET: lambda *ops: yardstick.simkern_bytes_needed("accum_acks", *ops)}


def read(r):
    if not r.trace or TARGET not in r.launch_bytes:
        return None
    launches = r.launch_bytes[TARGET]
    events = [v for name, v in r.trace["ops"].items() if KERNEL in name]
    n = sum(c for c, _ in events)
    seconds = sum(s for _, s in events)
    if not n or n != len(launches) or seconds <= 0:
        return None
    return 100.0 * sum(launches) / yardstick.HBM_BYTES_PER_S / seconds
