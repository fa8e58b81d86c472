#!/usr/bin/env python3
"""Run one case through both packages' ``Application`` in float64 on the
CPU and compare every snapshot.

    python scripts/compare_apps_f64.py benchmark_3 [--max-steps N]
        [--pfreq N] [--root DIR] [--runs ref,port] [--shift EPS]

The reference runs on its XLA cell engine (``RB_TPU_ENGINE=cell``,
float64: ``RB_TPU_X64=1``), the port on CPU tensors in float64 (its
kernel wrappers run their plain versions there).  For each snapshot the
script prints the largest difference of every array, scaled by the
array's largest magnitude (at least 1), and for each rigid body its
centre-of-mass y and velocity on both sides; the last line is one JSON
object with the per-snapshot maxima and the final state.  The two runs
write under ``--root`` (default ``build/compare_<case>``).

``--runs`` names the two runs compared (``ref`` the reference, ``port``
the port; ``port,port`` or ``ref,ref`` measure how fast the case itself
amplifies a difference), and ``--shift EPS`` moves every rigid body of
the second run by EPS in x after its set-up (particles and centres of
mass alike).
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("RB_TPU_X64", "1")
os.environ.setdefault("RB_TPU_PLATFORM", "cpu")
os.environ.setdefault("RB_TPU_ENGINE", "cell")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "cases"))

# case name -> (reference module under cases/, class, port module, argv)
CASES = {
    "benchmark_3": (
        "benchmark_3_multiple_rigid_bodies_colliding_same_particle_array",
        "Benchmark3", []),
    "benchmark_2": ("benchmark_2_multiple_rigid_bodies_colliding",
                    "Benchmark2", []),
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("case", choices=sorted(CASES))
    p.add_argument("--max-steps", type=int, default=None,
                   help="steps to run (default: the case's tf)")
    p.add_argument("--pfreq", type=int, default=100)
    p.add_argument("--root", default=None)
    p.add_argument("--runs", default="ref,port")
    p.add_argument("--shift", type=float, default=0.0)
    a = p.parse_args(argv)
    runs = a.runs.split(",")

    import importlib

    import torch
    torch.set_num_threads(1)
    from rigid_body_2d_3d_pysph_tpu.app import output as jout

    mod, cls, extra = CASES[a.case]
    jmod = importlib.import_module(mod)
    tmod = importlib.import_module(
        f"rigid_body_2d_3d_pysph_tpu_torch.cases.{mod}")
    root = a.root or os.path.join(ROOT, "build", f"compare_{a.case}")
    dj, dt = os.path.join(root, "first"), os.path.join(root, "second")
    args = extra + ["--pfreq", str(a.pfreq), "--quiet"]
    if a.max_steps is not None:
        args += ["--max-steps", str(a.max_steps)]

    def app(which, shift):
        base = getattr(jmod if which == "ref" else tmod, cls)

        class Shifted(base):
            def create_particles(self):
                scene = super().create_particles()
                if not shift:
                    return scene
                rb = np.asarray(scene.is_rigid) if which == "ref" else \
                    scene.is_rigid.numpy()
                x = np.where(rb, np.asarray(scene.x) + shift,
                             np.asarray(scene.x))
                xcm = np.asarray(scene.xcm).copy()
                xcm[:, 0] += shift
                if which == "ref":
                    import jax.numpy as jnp
                    return scene.replace(x=jnp.asarray(x),
                                         xcm=jnp.asarray(xcm))
                return scene.replace(x=torch.as_tensor(x),
                                     xcm=torch.as_tensor(xcm))

        out = Shifted(fname=a.case)
        if which == "port":
            out.dtype = torch.float64
        return out

    secs = []
    for which, d, shift in ((runs[0], dj, 0.0), (runs[1], dt, a.shift)):
        t0 = time.perf_counter()
        app(which, shift).run(["-d", d] + args + (
            ["--device", "cpu"] if which == "port" else []))
        secs.append(time.perf_counter() - t0)
    tj, tt = secs
    print(f"[{a.case}] {runs[0]} {tj:.1f} s, {runs[1]} {tt:.1f} s "
          f"(float64, CPU; second run shifted by {a.shift:g})", flush=True)

    fj, ft = jout.get_files(dj), jout.get_files(dt)
    names = [os.path.basename(f) for f in fj]
    if names != [os.path.basename(f) for f in ft]:
        raise SystemExit(f"snapshot lists differ: {len(fj)} / {len(ft)}")
    rows = []
    for f1, f2 in zip(fj, ft):
        sdj, gj = jout.load(f1)
        sdt, gt = jout.load(f2)
        worst, where = 0.0, ""
        for g in gj:
            vj, vt = vars(gj[g]), vars(gt[g])
            for k in vj:
                x = np.asarray(vj[k], np.float64)
                y = np.asarray(vt[k], np.float64)
                if x.size == 0:
                    continue
                scale = max(float(np.abs(x).max()), 1.0)
                d = float(np.abs(x - y).max()) / scale
                if d > worst:
                    worst, where = d, f"{g}/{k}"
        bodies = {}
        for g in gj:
            if hasattr(gj[g], "xcm_mat"):
                bodies[g] = dict(
                    y_first=np.asarray(gj[g].xcm_mat)[:, 1].tolist(),
                    y_second=np.asarray(gt[g].xcm_mat)[:, 1].tolist(),
                    vmax_first=float(np.abs(gj[g].vcm_mat).max()),
                    vmax_second=float(np.abs(gt[g].vcm_mat).max()))
        row = dict(snapshot=os.path.basename(f1), t=float(sdj["t"]),
                   max_scaled_diff=worst, at=where, bodies=bodies)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(case=a.case, runs=runs, shift=a.shift,
                          snapshots=len(rows),
                          max_scaled_diff=max(r["max_scaled_diff"]
                                              for r in rows),
                          final=rows[-1], seconds=secs)),
          flush=True)


if __name__ == "__main__":
    main()
