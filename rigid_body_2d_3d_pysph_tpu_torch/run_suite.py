"""Run the port's cases and gate them.

Counterpart of the repository's ``run_suite.py``, over the same 18-entry
case matrix: each case runs as a subprocess
(``python -m rigid_body_2d_3d_pysph_tpu_torch.cases.<module>``) into
``<root>/<name>_output`` with ``--quiet``, and a case whose output dir
holds an info JSON is skipped unless ``--force``.  ``--validate`` then
runs the port's ``validate`` over the same root.

Usage:
  python -m rigid_body_2d_3d_pysph_tpu_torch.run_suite [cases ...]
      [--root DIR] [--max-steps N] [--force] [--validate]
      [--validate-json PATH] [--list] [-- extra case arguments]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from .cases import REPO_ROOT

PKG = "rigid_body_2d_3d_pysph_tpu_torch"

# case name -> (case module, extra argv)
MATRIX = {
    "benchmark_1": ("benchmark_1_rigid_body_rotating_and_translating_freely",
                    []),
    "benchmark_2": ("benchmark_2_multiple_rigid_bodies_colliding", []),
    "benchmark_2_same_array": (
        "benchmark_2_multiple_rigid_bodies_colliding_same_particle_array",
        []),
    "benchmark_3": (
        "benchmark_3_multiple_rigid_bodies_colliding_same_particle_array",
        []),
    "benchmark_4_en_1.0": ("benchmark_4_rigid_cube_bouncing_on_a_wall",
                           ["--coeff-of-restitution", "1.0"]),
    "benchmark_4_en_0.8": ("benchmark_4_rigid_cube_bouncing_on_a_wall",
                           ["--coeff-of-restitution", "0.8"]),
    "benchmark_4_en_0.5": ("benchmark_4_rigid_cube_bouncing_on_a_wall",
                           ["--coeff-of-restitution", "0.5"]),
    "benchmark_5_2d_two": ("benchmark_5_steady_cubes_on_a_wall_2d",
                           ["--two-cubes"]),
    "benchmark_5_2d_three": ("benchmark_5_steady_cubes_on_a_wall_2d",
                             ["--three-cubes"]),
    "benchmark_5_2d_pyramid": ("benchmark_5_steady_cubes_on_a_wall_2d",
                               ["--pyramid-cubes"]),
    "benchmark_5_3d_one": ("benchmark_5_steady_cubes_on_a_wall_3d",
                           ["--one-cube"]),
    "benchmark_5_3d_two": ("benchmark_5_steady_cubes_on_a_wall_3d",
                           ["--two-cubes"]),
    "benchmark_5_3d_three": ("benchmark_5_steady_cubes_on_a_wall_3d",
                             ["--three-cubes"]),
    "benchmark_5_3d_pyramid": ("benchmark_5_steady_cubes_on_a_wall_3d",
                               ["--pyramid-cubes"]),
    "stack_of_cylinders": ("stack_of_cylinders", []),
    "stack_of_cylinders_test_1": ("stack_of_cylinders_test_1", []),
    "sinking_box": ("rigid_body_rotating_and_sinking_in_tank_2d", []),
    "dem_column_collapse": ("dem_granular_column_collapse", []),
}


def check_name(case: str):
    """The ``validate`` check of a case (the three restitution runs of
    benchmark 4 share one; the smoke case ``stack_of_cylinders_test_1``
    has none, as in the repository's ``validate.py``)."""
    if case.startswith("benchmark_4_en_"):
        return "benchmark_4"
    return None if case == "stack_of_cylinders_test_1" else case


def run_case(name: str, root: str, force: bool = False, extra=()) -> bool:
    module, argv = MATRIX[name]
    outdir = os.path.join(root, f"{name}_output")
    done_marker = [f for f in (os.listdir(outdir) if os.path.isdir(outdir)
                               else []) if f.endswith(".info.json")]
    if done_marker and not force:
        print(f"[skip] {name} (completed; --force to re-run)", flush=True)
        return True
    cmd = [sys.executable, "-m", f"{PKG}.cases.{module}", "-d", outdir,
           "--quiet"] + argv + list(extra)
    print(f"[run ] {name}: {' '.join(cmd)}", flush=True)
    t0 = time.time()
    r = subprocess.run(cmd, cwd=REPO_ROOT)
    ok = r.returncode == 0
    print(f"[{'ok  ' if ok else 'FAIL'}] {name} ({time.time() - t0:.1f}s)",
          flush=True)
    return ok


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(prog="run_suite")
    p.add_argument("cases", nargs="*", help="subset of case names")
    p.add_argument("--list", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--root", default=REPO_ROOT,
                   help="directory for the <case>_output dirs")
    p.add_argument("--max-steps", type=int, default=None,
                   help="cap the steps of every case")
    p.add_argument("--validate", action="store_true",
                   help="after the runs, run the port's validate over the "
                        "root and write its JSON")
    p.add_argument("--validate-json", metavar="JSON",
                   default="VALIDATE_torch.json",
                   help="path of the --validate JSON (under the root "
                        "unless absolute)")
    args = p.parse_args(argv)

    if args.list:
        print("\n".join(MATRIX))
        return 0
    root = os.path.abspath(args.root)
    names = args.cases or list(MATRIX)
    if args.max_steps:
        extra = ["--max-steps", str(args.max_steps)] + extra
    results = {n: run_case(n, root, args.force, extra) for n in names}
    print(json.dumps(results, indent=2), flush=True)
    rc = 0 if all(results.values()) else 1
    if args.validate:
        checks = [c for c in dict.fromkeys(map(check_name, names)) if c]
        r = subprocess.run(
            [sys.executable, "-m", f"{PKG}.validate", "--root", root,
             "--json", os.path.join(root, args.validate_json)] + checks,
            cwd=REPO_ROOT)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
