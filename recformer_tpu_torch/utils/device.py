"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``. Asking for
``cuda`` on a machine without a usable GPU raises: nothing moves to the CPU
behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
