"""Value model: interned int32 value ids (port of ``tpu_paxos/core/values.py``).

vid space, as in the JAX package:

- ``vid == -1``  : NONE (no value)
- ``vid >= 0``   : real values; the canonical harness assignment is
  ``vid = proposer * stride + seq``
- ``vid <= -2``  : no-op hole fillers made on the device, encoded
  ``-(2 + proposer * n_instances + instance)``

Device functions take int32 tensors (or Python ints) and return int32
tensors; the host decoders and the payload intern table work on Python
or numpy ints.
"""

from __future__ import annotations

import numpy as np
import torch

NONE = -1
NOOP_BASE = -2


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def real_vid(proposer, seq, stride: int) -> torch.Tensor:
    """Canonical real-value id: globally unique, decodable without a table."""
    return _i32(proposer) * stride + _i32(seq)


def real_proposer_of(vid, stride: int) -> torch.Tensor:
    return torch.div(_i32(vid), stride, rounding_mode="floor")


def real_seq_of(vid, stride: int) -> torch.Tensor:
    return torch.remainder(_i32(vid), stride)


def noop_vid(instance: torch.Tensor, proposer: torch.Tensor, n_instances: int) -> torch.Tensor:
    """Device-side no-op id for hole filling; distinct per (proposer, instance)."""
    k = proposer.to(torch.int32) * n_instances + instance.to(torch.int32)
    return NOOP_BASE - k


def is_noop(vid) -> torch.Tensor:
    return _i32(vid) <= NOOP_BASE


def is_none(vid) -> torch.Tensor:
    return _i32(vid) == NONE


def noop_decode(vid, n_instances: int):
    """(proposer, instance) of a no-op vid, as int32 tensors."""
    k = NOOP_BASE - _i32(vid)
    return (torch.div(k, n_instances, rounding_mode="floor"),
            torch.remainder(k, n_instances))


# ---------------------------------------------------------------- host side


class InternTable:
    """Host-side payload intern table: bytes/str <-> vid.

    The harness seam the reference exposes as ``StateMachine::Debug``
    (ref multi/paxos.h:214-222): a way to render a value.  Real payloads
    are interned on propose; no-ops never enter the table.
    """

    def __init__(self) -> None:
        self._by_payload: dict[bytes, int] = {}
        self._payloads: list[bytes] = []

    def intern(self, payload: bytes | str) -> int:
        if isinstance(payload, str):
            payload = payload.encode()
        vid = self._by_payload.get(payload)
        if vid is None:
            vid = len(self._payloads)
            self._by_payload[payload] = vid
            self._payloads.append(payload)
        return vid

    def payload(self, vid: int) -> bytes:
        if not 0 <= vid < len(self._payloads):
            raise KeyError(f"vid {vid} is not an interned real value")
        return self._payloads[vid]

    def __len__(self) -> int:
        return len(self._payloads)


def decode_host(vid: int, stride: int, n_instances: int):
    """Decode a vid to (proposer, value_id, noop) on the host (numpy ints ok)."""
    vid = int(vid)
    if vid <= NOOP_BASE:
        k = NOOP_BASE - vid
        return k // n_instances, k % n_instances, True
    if vid < 0:
        raise ValueError("NONE has no decoding")
    return vid // stride, vid % stride, False


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
