"""L0 primitives: PRNG streams (utils/prng.py), leveled host logging
(utils/log.py — the reference Logger analog, ref multi/paxos.cpp:74-103),
TRACE dump helpers (utils/dump.py — the DumpHex analog), device
selection and the global torch settings (utils/device.py), the kernel
builder (utils/kbuild.py) and the per-round work counters
(utils/counters.py)."""

from tpu_paxos_torch.utils.dump import dump_array, dump_hex  # noqa: F401
from tpu_paxos_torch.utils.log import Logger, get_logger  # noqa: F401
