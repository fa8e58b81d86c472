"""The application layer: the CLI, the solver loop, output and hooks.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/app/application.py``.  The
``Solver`` runs the scheme's step in chunks of ``pfreq`` steps (a Python
loop of eager steps) and does its host work at chunk boundaries only:
one read of the overflow flag a chunk, snapshots, checkpoints and
scheduled events, i.e. (time, callback) pairs applied at the step
boundary nearest their time (the reference's ``post_step`` pattern).
``Application`` is the base class of a case: ``initialize``,
``create_particles``, ``create_scheme``, ``configure_scheme``,
``add_user_options``, ``consume_user_options`` and ``post_process``,
with the reference's CLI flags, ``--device`` (the card by default) and
``--engine`` (the scheme's pair engine: ``cell``, the default, or
``nklist``; the counterpart of the reference's ``RB_TPU_ENGINE``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .. import config
from ..models.base import ENGINES
from ..models.rigid_body import make_multi_step
from ..state.scene import Scene
from . import checkpoint as ckpt_mod
from . import output as out_mod


class Solver:
    """Owns the time loop; ``scheme.make_step(scene)`` supplies the step.

    The overflow rule (the reference's): the overflow flag is read once
    a chunk; on overflow the chunk is re-run from its start state after
    the configs are rebuilt from that state (every slack factor 1.5x
    wider from the second rebuild of the same chunk on) and the
    capacity-shaped scene state is adapted to them; more than 8 rebuilds
    of one chunk raise."""

    MAX_REBUILDS = 8

    def __init__(self, scheme, scene: Scene, dt: float, tf: float,
                 pfreq: int = 100, output_dir: str = "output",
                 output_fields: Optional[Sequence[str]] = None,
                 events: Sequence[Tuple[float, Callable]] = (),
                 checkpoint_every: int = 10):
        self.scheme = scheme
        self.scene = scene
        self.dt = float(dt)
        self.tf = float(tf)
        self.pfreq = int(pfreq)
        self.output_dir = output_dir
        self.output_fields = output_fields
        self.events = sorted(events, key=lambda e: e[0])
        self.t = 0.0
        self.count = 0
        self.output_files: List[str] = []
        self.callbacks_post_chunk: List[Callable] = []
        self.steps_per_sec = 0.0
        self.steps_run = 0        # every step taken, re-run chunks too
        self.rebuilds_total = 0
        self._writer = None
        # a checkpoint moves the whole state to the host: one every
        # ``checkpoint_every`` output chunks, and at the end
        self.checkpoint_every = max(1, int(checkpoint_every))

    def _dump(self):
        os.makedirs(self.output_dir, exist_ok=True)
        path = os.path.join(self.output_dir,
                            f"snapshot_{self.count:06d}.npz")
        if self._writer is None:
            self._writer = out_mod.AsyncSnapshotWriter()
        self._writer.submit(path, self.scheme.export_scene(self.scene),
                            self.t, self.dt, self.count, self.output_fields)
        self.output_files.append(path)

    def _overflowed(self) -> bool:
        return "nbr_overflow" in self.scene and bool(self.scene.nbr_overflow)

    def solve(self, quiet: bool = False, resume: bool = False) -> Scene:
        n_steps = int(round(self.tf / self.dt))
        done = 0
        if resume:
            cp = ckpt_mod.latest_checkpoint(self.output_dir)
            if cp:
                self.scene, self.t, done = ckpt_mod.load_checkpoint(
                    cp, self.scene, self.scheme)
                self.scene = self.scheme.adapt_scene(self.scene)
                self.count = done
                if not quiet:
                    print(f"resumed from {cp} at step {done}", flush=True)
        step = self.scheme.make_step(self.scene)
        multi = make_multi_step(step, self.pfreq)
        if done == 0:
            self._dump()
        ev = [e for e in self.events if int(round(e[0] / self.dt)) > done]
        done0 = done
        t_wall0 = time.perf_counter()
        rebuilds = 0
        try:
            while done < n_steps:
                # steps to the next boundary: the next multiple of pfreq,
                # an event or the end
                n_next = min(self.pfreq - done % self.pfreq, n_steps - done)
                if ev:
                    steps_to_ev = int(round(ev[0][0] / self.dt)) - done
                    if steps_to_ev <= 0:
                        _, fn = ev.pop(0)
                        self.scene = fn(self.scene)
                        continue
                    n_next = min(n_next, steps_to_ev)

                chunk_start = self.scene
                self.steps_run += n_next
                if n_next == self.pfreq:
                    self.scene = multi(self.scene, self.dt)
                else:
                    for _ in range(n_next):
                        self.scene = step(self.scene, self.dt)
                if self._overflowed():
                    # pairs were dropped: the chunk is invalid.  Re-size
                    # from its start state and run it again.
                    rebuilds += 1
                    self.rebuilds_total += 1
                    if rebuilds > self.MAX_REBUILDS:
                        raise RuntimeError(
                            "neighbour capacity overflow persists after "
                            f"{self.MAX_REBUILDS} grid rebuilds; the scene "
                            "is likely diverging")
                    self.scheme.refresh_configs(chunk_start,
                                                grow=rebuilds > 1)
                    chunk_start = self.scheme.adapt_scene(chunk_start)
                    step = self.scheme.make_step(chunk_start)
                    multi = make_multi_step(step, self.pfreq)
                    self.scene = chunk_start
                    if not quiet:
                        print(f"step {done}: capacity overflow, grid rebuilt "
                              f"(x{rebuilds}, boost "
                              f"{self.scheme.capacity_boost:.2f}); re-running "
                              "the chunk", flush=True)
                    continue
                done += n_next
                self.count = done
                self.t = done * self.dt
                if done % self.pfreq == 0 or done == n_steps:
                    rebuilds = 0
                    self._dump()
                    chunk_no = done // self.pfreq
                    if chunk_no % self.checkpoint_every == 0 \
                            or done == n_steps:
                        ckpt_mod.save_checkpoint(
                            os.path.join(self.output_dir, "checkpoint.npz"),
                            self.scene, self.t, done, self.scheme)
                    for cb in self.callbacks_post_chunk:
                        cb(self)
                    el = time.perf_counter() - t_wall0
                    self.steps_per_sec = (done - done0) / max(el, 1e-9)
                    if not quiet:
                        print(f"step {done}/{n_steps}  t={self.t:.6g}  "
                              f"{self.steps_per_sec:.1f} steps/s",
                              flush=True)
        finally:
            # every file in output_files exists once solve() returns
            if self._writer is not None:
                writer, self._writer = self._writer, None
                writer.close()
        if self.scene.device.type == "cuda":
            torch.cuda.synchronize(self.scene.device)
        return self.scene


class Application:
    """The base class of a case, with the reference's hooks:
    ``initialize / create_particles / create_scheme / configure_scheme /
    add_user_options / consume_user_options / post_process``.  Scenes
    are built on ``self.device`` in ``self.dtype`` (float32 unless the
    caller sets it before ``run``)."""

    def __init__(self, fname: Optional[str] = None):
        self.fname = fname or type(self).__name__.lower()
        self.solver: Optional[Solver] = None
        self.scene: Optional[Scene] = None
        self.scheme = None
        self.options: Optional[argparse.Namespace] = None
        self.output_dir = f"{self.fname}_output"
        self.events: List[Tuple[float, Callable]] = []
        self.device: Optional[torch.device] = None
        self.dtype = config.WORK_DTYPE
        self.initialize()

    # -- hooks ------------------------------------------------------------
    def initialize(self):
        pass

    def create_particles(self) -> Scene:
        raise NotImplementedError

    def create_scheme(self):
        raise NotImplementedError

    def configure_scheme(self):
        pass

    def add_user_options(self, group):
        pass

    def consume_user_options(self):
        pass

    def post_process(self, info_fname: Optional[str] = None):
        pass

    def customize_output(self):
        """Hook for the output's customisation (a no-op, as the
        reference's)."""
        pass

    # -- plumbing ---------------------------------------------------------
    @property
    def info_filename(self) -> str:
        return os.path.join(self.output_dir, f"{self.fname}.info.json")

    @property
    def output_files(self) -> List[str]:
        if self.solver is not None and self.solver.output_files:
            return self.solver.output_files
        return out_mod.get_files(self.output_dir)

    def _parse(self, argv):
        p = argparse.ArgumentParser(prog=self.fname)
        p.add_argument("-d", "--output-dir", default=self.output_dir)
        p.add_argument("--tf", type=float, default=None)
        p.add_argument("--timestep", type=float, default=None, dest="dt")
        p.add_argument("--pfreq", type=int, default=None)
        p.add_argument("--max-steps", type=int, default=None)
        p.add_argument("--resume", action="store_true",
                       help="continue from the last checkpoint in the "
                            "output dir")
        p.add_argument("--quiet", action="store_true")
        p.add_argument("--openmp", action="store_true",
                       help="accepted for the reference CLI's sake (the "
                            "run is on the device)")
        p.add_argument("--device", default=None,
                       help="torch device of the run (default: the first "
                            "CUDA card; there is no fallback to the CPU)")
        p.add_argument("--engine", choices=ENGINES, default="cell",
                       help="pair engine: the cell grid and its kernels "
                            "(default) or the [N, K] neighbour lists")
        g = p.add_argument_group("scheme options")
        self.add_user_options(g)
        self.scheme = self.create_scheme()
        self.scheme.add_user_options(g)
        self.options = p.parse_args(argv)
        self.output_dir = self.options.output_dir
        self.device = (torch.device(self.options.device)
                       if self.options.device else config.device())
        self.consume_user_options()
        self.scheme.consume_user_options(self.options)
        self.scheme.engine = self.options.engine

    def add_event(self, t: float, fn: Callable):
        """Schedule a host-side scene edit at simulated time t."""
        self.events.append((t, fn))

    def run(self, argv: Optional[Sequence[str]] = None):
        self._parse(list(argv) if argv is not None else sys.argv[1:])
        self.scene = self.create_particles()
        self.configure_scheme()
        if self.options.dt:
            self.scheme.dt = self.options.dt
        if self.options.tf is not None:
            self.scheme.tf = self.options.tf
        if self.options.pfreq:
            self.scheme.pfreq = self.options.pfreq
        dt, tf = self.scheme.dt, self.scheme.tf
        if self.options.max_steps:
            tf = min(tf, self.options.max_steps * dt)
        self.solver = Solver(self.scheme, self.scene, dt=dt, tf=tf,
                             pfreq=self.scheme.pfreq,
                             output_dir=self.output_dir, events=self.events)
        t0 = time.perf_counter()
        self.scene = self.solver.solve(quiet=self.options.quiet,
                                       resume=self.options.resume)
        elapsed = time.perf_counter() - t0
        os.makedirs(self.output_dir, exist_ok=True)
        out_mod.write_info(
            self.info_filename,
            fname=self.fname, completed=True, cpu_time=elapsed,
            dt=self.solver.dt, tf=self.solver.tf, n_particles=self.scene.n,
            steps_per_sec=self.solver.steps_per_sec,
            rebuilds=self.solver.rebuilds_total, device=str(self.device),
            device_name=(torch.cuda.get_device_name(self.device)
                         if self.device.type == "cuda" else "cpu"),
            output_dir=self.output_dir, args=vars(self.options),
        )
        return self.scene
