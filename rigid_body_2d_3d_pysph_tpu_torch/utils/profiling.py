"""Wall-clock phase timers, a steps/sec meter and a device trace.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/utils/profiling.py``:
``PhaseTimer`` and ``Throughput`` as there; ``device_trace`` records a
``torch.profiler`` trace (host and, on a CUDA card, device activity) and
writes it as a Chrome trace under ``logdir`` in place of a
``jax.profiler`` trace.  The host timers measure host time: time work on
the card inside a phase only where it ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


class PhaseTimer:
    """Accumulating wall-clock timer keyed by phase name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for k in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"{k:30s} {self.totals[k]:10.3f}s "
                         f"x{self.counts[k]}")
        return "\n".join(lines)


class Throughput:
    """steps/sec + particle-steps/sec meter."""

    def __init__(self, n_particles: int):
        self.n = n_particles
        self.t0 = time.perf_counter()
        self.steps = 0

    def add(self, steps: int):
        self.steps += steps

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(time.perf_counter() - self.t0, 1e-9)

    @property
    def particle_steps_per_sec(self) -> float:
        return self.steps_per_sec * self.n


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block (CUDA activity too
    when a card is present) and write it to
    ``<logdir>/trace.json`` (open it in chrome://tracing or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
