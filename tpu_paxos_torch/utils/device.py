"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` (default ``"cuda"``) and
never falls back quietly: asking for CUDA where there is none raises.
The CPU runs only when the caller names it, as the tests do.
"""

from __future__ import annotations

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
