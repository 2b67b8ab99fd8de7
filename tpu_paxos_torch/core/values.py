"""Value model: interned int32 value ids (port of ``tpu_paxos/core/values.py``).

vid space, as in the JAX package:

- ``vid == -1``  : NONE (no value)
- ``vid >= 0``   : real values; the canonical harness assignment is
  ``vid = proposer * stride + seq``
- ``vid <= -2``  : no-op hole fillers made on the device, encoded
  ``-(2 + proposer * n_instances + instance)``

Device functions take and return int32 tensors; the host decoders work
on Python or numpy ints.
"""

from __future__ import annotations

import numpy as np
import torch

NONE = -1
NOOP_BASE = -2


def noop_vid(instance: torch.Tensor, proposer: torch.Tensor, n_instances: int) -> torch.Tensor:
    """Device-side no-op id for hole filling; distinct per (proposer, instance)."""
    k = proposer.to(torch.int32) * n_instances + instance.to(torch.int32)
    return NOOP_BASE - k


def decode_host_array(vids: np.ndarray, stride: int, n_instances: int):
    """Vectorized host decode: returns (proposer, value_id, noop) arrays."""
    vids = np.asarray(vids, np.int64)
    if (vids == NONE).any():
        raise ValueError("NONE has no decoding")
    noop = vids <= NOOP_BASE
    k = NOOP_BASE - vids
    proposer = np.where(noop, k // n_instances, vids // stride)
    value_id = np.where(noop, k % n_instances, vids % stride)
    return proposer.astype(np.int64), value_id.astype(np.int64), noop
