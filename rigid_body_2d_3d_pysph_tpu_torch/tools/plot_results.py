"""Post-processing figures from a port run's case outputs.

The counterpart of the repository's ``plot_results.py``, which reads
``<repository>/<case>_output/results.npz`` only and reads benchmark 4's
snapshots through the JAX package.  This one reads the outputs under
any root (``run_suite --root``) through this package's
``app/output.py``, so it needs neither JAX nor the JAX package.  A host
tool: it needs ``matplotlib``, imported only when it draws.

  benchmark_1           total kinetic energy vs t; COM path
  benchmark_4           rebound trajectories per restitution
  stack_of_cylinders    COM x/L and y/L vs the digitized Zhang data
  sinking_box           box max-y (surface penetration depth) vs t

Usage:
  python -m rigid_body_2d_3d_pysph_tpu_torch.tools.plot_results \\
      [case ...] [--root DIR]

Figures land in ``<root>/<case>_output/``; a case with no output is
skipped.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..app import output as out_mod
from ..cases import REPO_ROOT


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _res(root, case):
    p = os.path.join(root, f"{case}_output", "results.npz")
    return np.load(p) if os.path.exists(p) else None


def plot_benchmark_1(root):
    r = _res(root, "benchmark_1")
    if r is None:
        return None
    plt = _plt()
    fig, ax = plt.subplots(1, 2, figsize=(9, 3.5))
    ax[0].plot(r["t"], r["total_energy"])
    ax[0].set_xlabel("t [s]")
    ax[0].set_ylabel("total KE [J]")
    ax[0].set_title("benchmark 1: energy conservation")
    ax[1].plot(r["x"], r["y"])
    ax[1].set_xlabel("x_cm")
    ax[1].set_ylabel("y_cm")
    ax[1].set_title("COM path")
    fig.tight_layout()
    p = os.path.join(root, "benchmark_1_output", "total_energy_vs_t.png")
    fig.savefig(p, dpi=150)
    plt.close(fig)
    return [p]


def plot_stack_of_cylinders(root):
    r = _res(root, "stack_of_cylinders")
    if r is None:
        return None
    plt = _plt()
    paths = []
    for comp, sim, zt, zv in (("x", "x_com", "zhang_t_x", "zhang_x"),
                              ("y", "y_com", "zhang_t_y", "zhang_y")):
        fig, ax = plt.subplots(figsize=(5, 3.5))
        ax.plot(r[zt], r[zv], "s--", label="Experiment (Zhang)")
        ax.plot(r["t"], r[sim], "-", label="Simulated")
        ax.set_xlabel("time [s]")
        ax.set_ylabel(f"{comp}/L")
        ax.legend()
        fig.tight_layout()
        paths.append(os.path.join(root, "stack_of_cylinders_output",
                                  f"{comp}com.png"))
        fig.savefig(paths[-1], dpi=150)
        plt.close(fig)
    return paths


def plot_sinking_box(root):
    r = _res(root, "sinking_box")
    if r is None:
        return None
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(r["t"], r["max_y"], label="box top")
    ax.plot(r["t"], r["y_com"], label="box COM")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("y [m]")
    ax.legend()
    fig.tight_layout()
    p = os.path.join(root, "sinking_box_output", "max_z.png")
    fig.savefig(p, dpi=150)
    plt.close(fig)
    return [p]


def plot_benchmark_4(root):
    curves = []
    for en in ("1.0", "0.5"):
        files = out_mod.get_files(
            os.path.join(root, f"benchmark_4_en_{en}_output"))
        if not files:
            continue
        t, y = [], []
        for sd, body in out_mod.iter_output(files, "body"):
            t.append(float(sd["t"]))
            y.append(body.xcm_mat[:, 1].mean())
        curves.append((en, t, y))
    if not curves:
        return None
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 3.5))
    for en, t, y in curves:
        ax.plot(t, y, label=f"e = {en}")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("mean body y_cm [m]")
    ax.legend()
    fig.tight_layout()
    p = os.path.join(root, f"benchmark_4_en_{curves[0][0]}_output",
                     "rebound.png")
    fig.savefig(p, dpi=150)
    plt.close(fig)
    return [p]


PLOTS = {
    "benchmark_1": plot_benchmark_1,
    "benchmark_4": plot_benchmark_4,
    "stack_of_cylinders": plot_stack_of_cylinders,
    "sinking_box": plot_sinking_box,
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m rigid_body_2d_3d_pysph_tpu_torch.tools.plot_results",
        description=__doc__.splitlines()[0])
    p.add_argument("cases", nargs="*",
                   help=f"cases to plot, of {', '.join(PLOTS)} (default: "
                        "all)")
    p.add_argument("--root", default=REPO_ROOT,
                   help="directory holding the <case>_output dirs")
    a = p.parse_args(argv)
    unknown = sorted(set(a.cases) - set(PLOTS))
    if unknown:
        p.error(f"no plot for {', '.join(unknown)}")
    for n in a.cases or list(PLOTS):
        paths = PLOTS[n](a.root)
        print(f"plotted {n}: {paths}" if paths else f"no output for {n}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
