"""The IEEE square root (and a thread-safe exponential) on every device.

On CPU tensors ``torch.sqrt`` (torch 2.13.0+cpu) runs MKL VML's
``vmsSqrt`` / ``vmdSqrt`` on each OpenMP worker thread's share of the
tensor, and the first call on a fresh worker thread can return a ~12-bit
approximation for that share (seen on float32: sqrt(2^-10) read
0.03124237 for 0.03125, relative errors 8e-5 to 2.8e-4).  So a plain
version gave other bits on its first call in some processes than on
every later call.  numpy's square root is correctly rounded and runs on
the calling thread; CUDA's is the IEEE one.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of ``t`` (NaN below zero)."""
    if t.device.type != "cpu":
        return torch.sqrt(t)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.sqrt(t.detach().numpy()))


def exp(t: torch.Tensor) -> torch.Tensor:
    """e**t; numpy's on the CPU (the same VML path as ``torch.sqrt``)."""
    if t.device.type != "cpu":
        return torch.exp(t)
    return torch.from_numpy(np.exp(t.detach().numpy()))
