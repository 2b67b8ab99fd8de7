"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` (default ``"cuda"``) and
never falls back quietly: asking for CUDA where there is none raises.
The CPU runs only when the caller names it, as the tests do.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``.  To a card it goes through pinned
    memory without waiting: a copy from pageable memory would wait for
    the stream, and a round makes many small ones."""
    device = torch.device(device)
    if device.type != "cuda" or x.device.type != "cpu":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def to_host(*trees):
    """NamedTuples of ``[L, ...]`` tensors (bool or integer) moved to host
    numpy in ONE copy, so a run's results cost one wait: every leaf
    travels as int32 and bool leaves come back bool.  Returns the trees
    in the given order."""
    leaves = [x for tree in trees for x in tree]
    lanes = leaves[0].shape[0]
    flat = torch.cat([x.reshape(lanes, -1).to(torch.int32) for x in leaves], dim=1)
    host = flat.cpu().numpy()
    out, k = [], 0
    for tree in trees:
        fields = []
        for x in tree:
            n = x[0].numel()
            part = host[:, k:k + n].reshape(x.shape)
            fields.append(part.astype(np.bool_) if x.dtype == torch.bool else part)
            k += n
        out.append(type(tree)(*fields))
    return out
