"""Physics validation of the port's case outputs.

The checks of the repository's ``validate.py`` for the cases the port
runs, with their thresholds unchanged, over the npz snapshots and
``results.npz`` files that the port's cases write (the same layout as
the reference's):

* benchmark_5: the stacks stay static, COM displacement < 2 particle
  spacings over the run (4 for the pyramids);
* sinking_box: the box sinks, never rises by more than 0.02 between
  snapshots, and its early-time acceleration lies in the added-mass
  window [0.2, 0.55] m/s^2;
* dem_column_collapse: the runout more than doubles and the pile height
  falls below half the column's;
* stack_of_cylinders: the COM trajectory against the digitised Zhang
  curves (x/L, y/L RMS deviation < 0.15).

Usage: python -m rigid_body_2d_3d_pysph_tpu_torch.validate
       [--root DIR] [--json PATH] [case ...]

``--root`` is the directory that holds the ``<case>_output`` dirs (the
repository root by default).  Unlike the root ``validate.py``, it needs
no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .app import output as out_mod
from .cases import REPO_ROOT


def _files(root, case):
    return out_mod.get_files(os.path.join(root, f"{case}_output"))


def check_benchmark_5(root, case="benchmark_5_2d_two", tol_spacings=2.0,
                      spacing=0.025):
    files = _files(root, case)
    if not files:
        return None
    sd0, g0 = out_mod.load(files[0])
    sd1, g1 = out_mod.load(files[-1])
    d = np.abs(g1["body"].xcm_mat - g0["body"].xcm_mat).max()
    ok = d < tol_spacings * spacing
    return dict(ok=bool(ok), max_com_displacement=float(d))


def check_sinking_box(root):
    res_path = os.path.join(root, "sinking_box_output", "results.npz")
    if not os.path.exists(res_path):
        return None
    r = np.load(res_path)
    y = r["y_com"]
    t = r["t"] if "t" in r else np.linspace(0.0, 4.0, len(y))
    # a rho_s = 2 rho_f box under gy = -1 has the net specific gravity
    # g' = g (1 - rho_f / rho_s) = 0.5; its early descent must lie in the
    # added-mass window a in [g' / (1 + Ca_max), ~g'], Ca_max ~ 1.5 for a
    # 2:1 broadside rectangle: a in [0.2, 0.55] m/s^2 fitted over the
    # first 0.6 s
    dy = np.diff(y)
    early = t <= 0.6
    tt = t[early]
    # least-squares fit of y = y0 - 0.5 a t^2
    denom = float((tt ** 4).sum())
    a_fit = (2.0 * float(((y[0] - y[early]) * tt ** 2).sum()) / denom
             if denom > 0 else 0.0)
    ok = (y[-1] < y[0] - 0.5 and dy.max() < 0.02 and np.isfinite(y).all()
          and 0.2 <= a_fit <= 0.55)
    return dict(ok=bool(ok), y0=float(y[0]), y_end=float(y[-1]),
                max_rise=float(dy.max()), a_fit_early=float(a_fit),
                a_window=[0.2, 0.55])


def check_dem_column_collapse(root):
    res_path = os.path.join(root, "dem_column_collapse_output",
                            "results.npz")
    if not os.path.exists(res_path):
        return None
    r = np.load(res_path)
    runout = r["runout"]
    height = r["height"]
    ok = (runout[-1] > 2.0 * runout[0]) and (height[-1] < 0.5 * height[0])
    return dict(ok=bool(ok), runout=float(runout[-1]),
                height=float(height[-1]))


def check_stack_of_cylinders(root):
    res_path = os.path.join(root, "stack_of_cylinders_output", "results.npz")
    if not os.path.exists(res_path):
        return None
    r = np.load(res_path)
    t, x = r["t"], r["x_com"]
    zt, zx = r["zhang_t_x"], r["zhang_x"]
    zy_t, zy = r["zhang_t_y"], r["zhang_y"]
    y = r["y_com"]
    xi = np.interp(zt, t, x)
    yi = np.interp(zy_t, t, y)
    rms_x = float(np.sqrt(np.mean((xi - zx) ** 2)))
    rms_y = float(np.sqrt(np.mean((yi - zy) ** 2)))
    # a loose envelope: the reference's own plots deviate visibly from
    # the experiment
    return dict(ok=bool(rms_x < 0.15 and rms_y < 0.15),
                rms_x=rms_x, rms_y=rms_y)


# case -> check(root)
CHECKS = {
    "benchmark_5_2d_two": lambda r: check_benchmark_5(r, "benchmark_5_2d_two"),
    "benchmark_5_2d_three": lambda r: check_benchmark_5(
        r, "benchmark_5_2d_three"),
    "benchmark_5_2d_pyramid": lambda r: check_benchmark_5(
        r, "benchmark_5_2d_pyramid", tol_spacings=4.0),
    "benchmark_5_3d_one": lambda r: check_benchmark_5(
        r, "benchmark_5_3d_one", spacing=0.05),
    "benchmark_5_3d_two": lambda r: check_benchmark_5(
        r, "benchmark_5_3d_two", spacing=0.05),
    "benchmark_5_3d_three": lambda r: check_benchmark_5(
        r, "benchmark_5_3d_three", spacing=0.05),
    "benchmark_5_3d_pyramid": lambda r: check_benchmark_5(
        r, "benchmark_5_3d_pyramid", spacing=0.05, tol_spacings=4.0),
    "stack_of_cylinders": check_stack_of_cylinders,
    "sinking_box": check_sinking_box,
    "dem_column_collapse": check_dem_column_collapse,
}


def _throughput(root):
    """Each case's steps/s, particle count and device from its newest
    info JSON."""
    perf = {}
    for case in CHECKS:
        d = os.path.join(root, f"{case}_output")
        if not os.path.isdir(d):
            continue
        infos = sorted(
            (f for f in os.listdir(d) if f.endswith(".info.json")),
            key=lambda f: os.path.getmtime(os.path.join(d, f)))
        for f in infos[-1:]:
            with open(os.path.join(d, f)) as fh:
                info = json.load(fh)
            perf[case] = dict(
                steps_per_sec=info.get("steps_per_sec"),
                n_particles=info.get("n_particles"),
                cpu_time=info.get("cpu_time"),
                device_name=info.get("device_name"))
    return perf


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="validate")
    p.add_argument("cases", nargs="*", help="subset of case names")
    p.add_argument("--root", default=REPO_ROOT,
                   help="directory that holds the <case>_output dirs")
    p.add_argument("--json", dest="json_path", default=None,
                   help="also write the verdicts and throughput here")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    names = args.cases or list(CHECKS)
    results = {}
    for n in names:
        try:
            results[n] = CHECKS[n](root)
        except Exception as e:  # surface, don't mask
            results[n] = dict(ok=False, error=repr(e))
    print(json.dumps(results, indent=2))
    bad = [n for n, r in results.items() if r is not None and not r["ok"]]
    if args.json_path:
        with open(args.json_path, "w") as f:
            json.dump(dict(
                date=time.strftime("%Y-%m-%d %H:%M:%S"),
                n_checked=len([r for r in results.values()
                               if r is not None]),
                n_ok=len([r for r in results.values()
                          if r is not None and r["ok"]]),
                failed=bad, results=results, throughput=_throughput(root)),
                f, indent=2)
        print(f"wrote {args.json_path}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
