"""Working precision and device selection.

There is no process-level switch: every constructor in this package
takes an explicit ``device`` and ``dtype``.  ``WORK_DTYPE`` (float32) is
the card's working type; ``VALIDATION_DTYPE`` (float64) is for parity
runs against the JAX package's float64 CPU path.
"""

from __future__ import annotations

import torch

WORK_DTYPE = torch.float32
VALIDATION_DTYPE = torch.float64


def device() -> torch.device:
    """The device to build scenes on: the first CUDA card.  It raises
    when there is none, so a run meant for the card never drops to the
    CPU silently; validation runs pass ``torch.device("cpu")`` to the
    scene builders themselves."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; build the scene on "
                           "torch.device('cpu') explicitly for a CPU run")
    return torch.device("cuda", 0)


def check_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported working dtype {dtype}")
    return dtype
