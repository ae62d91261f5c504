"""Device rule of the port: entry points run on the card unless told otherwise.

``device=None`` means ``"cuda"``.  Without CUDA that raises, unless the
caller asked for the CPU explicitly (the tests do); no path moves to the
CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on (see module docstring)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mlamg_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
