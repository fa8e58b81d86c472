"""Physics validation of the port's case outputs.

The checks of the repository's ``validate.py``, with their thresholds
unchanged, over the npz snapshots and ``results.npz`` files that the
port's cases write (the same layout as the reference's):

* benchmark_1: kinetic-energy drift < 1e-4 of a free body, its COM on
  the line x = y = 0.5 t within 1e-3;
* benchmark_2 (and the same-array variant): total momentum < 1e-2 and
  the cubes rebound (v1x < -0.05, v2x > 0.05);
* benchmark_3: the cubes inside the tank (-0.1 < y < 0.6) with
  |v| < 1.5;
* benchmark_4 (the ``benchmark_4_en_<e>`` runs): each cube pair falls,
  bounces, stays in the tank and settles (|v| < 0.5); the f64 oracle
  agreement (``cases/data/benchmark_4_oracle.json``: the reference's f64
  rebound within 2 % of the C++ oracle's) is read from the data file;
  the f32 first-bounce heights are recorded, not gated (the undamped
  contact is chaotic in f32);
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
from .cases import DATA_DIR, REPO_ROOT

B4_RESTITUTIONS = ("1.0", "0.8", "0.5")


def _files(root, case):
    return out_mod.get_files(os.path.join(root, f"{case}_output"))


def check_benchmark_1(root):
    files = _files(root, "benchmark_1")
    if not files:
        return None
    ke, xs, ys, ts = [], [], [], []
    for sd, body in out_mod.iter_output(files, "body"):
        ts.append(float(sd["t"]))
        ke.append(0.5 * np.sum(body.m * (body.u**2 + body.v**2)))
        xs.append(body.xcm[0])
        ys.append(body.xcm[1])
    ke = np.asarray(ke)
    drift = abs(ke[-1] - ke[0]) / ke[0]
    # straight-line COM: x == y == 0.5 t
    ts = np.asarray(ts)
    com_err = max(np.abs(np.asarray(xs) - 0.5 * ts).max(),
                  np.abs(np.asarray(ys) - 0.5 * ts).max())
    ok = drift < 1e-4 and com_err < 1e-3
    return dict(ok=bool(ok), ke_drift=float(drift), com_err=float(com_err))


def check_benchmark_2(root, case="benchmark_2"):
    files = _files(root, case)
    if not files:
        return None
    sd, groups = out_mod.load(files[-1])
    if "body1" in groups:
        v1 = groups["body1"].vcm_mat[0]
        v2 = groups["body2"].vcm_mat[0]
    else:
        v = groups["body"].vcm_mat
        v1, v2 = v[0], v[1]
    mom = v1 + v2
    # momentum relative to the per-body speed scale (an f32 run)
    ok = (np.abs(mom).max() < 1e-2 and v1[0] < -0.05 and v2[0] > 0.05)
    return dict(ok=bool(ok), momentum=[float(m) for m in mom],
                v1x=float(v1[0]), v2x=float(v2[0]))


def check_benchmark_3(root):
    files = _files(root, "benchmark_3")
    if not files:
        return None
    sd, groups = out_mod.load(files[-1])
    body = groups["body"]
    xcm = body.xcm_mat
    vcm = body.vcm_mat
    # inside the tank at tf with bounded speeds (the cubes are still
    # mid-bounce at tf = 1: a free fall from twice the body height lands
    # at ~2.8 m/s)
    ok = (xcm[:, 1] > -0.1).all() and (xcm[:, 1] < 0.6).all() and (
        np.abs(vcm).max() < 1.5)
    return dict(ok=bool(ok), y=[float(v) for v in xcm[:, 1]],
                vmax=float(np.abs(vcm).max()))


def check_benchmark_4(root):
    """The restitution sweep: each run's stability invariants (fall,
    bounce, stay in the tank, settle) are gated; the implementation's
    f64 agreement with the independent C++ oracle is read from the
    recorded data (the reference's f64 rebound within 2 % of the
    oracle's); the f32 first-bounce heights are recorded as data."""
    opath = os.path.join(DATA_DIR, "benchmark_4_oracle.json")
    oracle = None
    if os.path.exists(opath):
        with open(opath) as f:
            oracle = json.load(f)
    out = {}
    heights = {}
    ok = True
    for en in B4_RESTITUTIONS:
        files = _files(root, f"benchmark_4_en_{en}")
        if not files:
            continue
        ys = []
        for sd, body in out_mod.iter_output(files, "body"):
            ys.append(body.xcm_mat[:, 1].mean())
        ys = np.asarray(ys)
        turn = [int(i) for i in np.where(np.diff(ys) > 0)[0]
                if ys[i] < ys[0] - 0.05]
        if turn:
            i = turn[0]
            # the oracle script's definition: the first local minimum
            # after the fall, then the following peak
            heights[en] = float(ys[i:].max() - ys[i])
        else:
            heights[en] = 0.0
            ok = False  # never bounced
        if oracle and en in oracle and oracle[en].get("rebound"):
            ref = float(oracle[en]["rebound"])
            j64 = oracle[en].get("jax_f64_rebound")
            if j64 is None or abs(float(j64) - ref) > 0.02 * max(ref, 0.01):
                ok = False
                out[f"oracle_f64_mismatch_{en}"] = dict(
                    jax_f64=j64, oracle=ref)
        sd, groups = out_mod.load(files[-1])
        body = groups["body"]
        ok = ok and np.isfinite(ys).all() and (
            np.abs(body.vcm_mat).max() < 0.5) and (
            body.xcm_mat[:, 1] > -0.1).all() and (
            body.xcm_mat[:, 1] < 0.6).all()
    if not heights:
        return None
    out["first_bounce_rebound_f32"] = heights
    if oracle:
        out["oracle_rebound"] = {
            en: oracle[en]["rebound"] for en in oracle}
        out["jax_f64_rebound"] = {
            en: oracle[en].get("jax_f64_rebound") for en in oracle}
    out["ok"] = bool(ok)
    return out


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
    "benchmark_1": check_benchmark_1,
    "benchmark_2": check_benchmark_2,
    "benchmark_2_same_array": lambda r: check_benchmark_2(
        r, "benchmark_2_same_array"),
    "benchmark_3": check_benchmark_3,
    "benchmark_4": check_benchmark_4,
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
    for case in list(CHECKS) + [f"benchmark_4_en_{en}"
                                for en in B4_RESTITUTIONS]:
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
