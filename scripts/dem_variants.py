#!/usr/bin/env python3
"""Where the DEM pair kernels' time goes, on one CUDA card.

    python3 scripts/dem_variants.py [--parent DIR]

Run from the repository root on the machine with the card.  It builds
``csrc/dem.cu`` as it is and in two cut-down copies, each with ``nvcc``
into ``build/dem_variants/``:

* ``noscan``: no gate scan, so no pair list and no pair bodies (staging
  of the candidate tiles, the table load and the write-back remain);
* ``nopair``: the scan and the pair lists, the pair bodies replaced by a
  "not gated" code;

and, with ``--parent DIR``, the ``csrc/dem.cu`` of another checkout (its
entry points as this one's, or without the ``o_match`` pointer and the
table width ``LM`` of before the wide instances: L = 8 tables only).  On
``chip_smoke.py``'s DEM scenes (~104k grains in 2D, ~123k in 3D, the
contact table filled by a plain pass) it prints, per grid, the wrapper's
time and each build's time per launch: CUDA events over 50 launches into
preallocated outputs, behind a device sleep so that the host's enqueue
is not timed.  The full build and the parent are checked against the
wrapper bit for bit (sums, counts, tables and springs); the cut-down
copies compute less by design.  Also prints
ptxas's registers, shared memory and spills per kernel instance.

It imports nothing from JAX.
"""

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import _build  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk  # noqa: E402

SOURCE = os.path.join(_build.CSRC, "dem.cu")
OUT = os.path.join(ROOT, "build", "dem_variants")
CUTS = {
    "noscan": ("for (int k = 0; k < kmax; k += 2) {",
               "for (int k = 0; k < 0; k += 2) {"),
    "nopair": ("for (int i = lane; i < cnt; i += 32) pair(i);",
               "for (int i = lane; i < cnt; i += 32) lc[i] = NOT_GATED;"),
}
GRIDS = (("2D spill", 2, "spill"), ("3D spill", 3, "spill"),
         ("2D rowwin", 2, "rowwin"), ("3D rowwin", 3, "rowwin"))


def build(name, src):
    """nvcc ``src`` into OUT/<name>.so with the DEM flags; returns
    (name, library path or None, ptxas report or the error)."""
    out = os.path.join(OUT, f"{name}.so")
    res = subprocess.run([_build._nvcc(), *_build.BASE_FLAGS,
                          *_build.EXTRA_FLAGS["dem"], "-o", out, src],
                         capture_output=True, text=True)
    if res.returncode:
        return name, None, res.stderr
    return name, out, "\n".join(
        ln.strip() for ln in res.stderr.splitlines()
        if "registers" in ln or "spill" in ln or "entry function" in ln)


def sources(parent):
    with open(SOURCE) as f:
        text = f.read()
    srcs = {"full": SOURCE}
    for name, (old, new) in CUTS.items():
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the cut's anchor is not in dem.cu")
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        srcs[name] = path
    if parent:
        srcs["parent"] = os.path.join(parent, "rigid_body_2d_3d_pysph_tpu_torch",
                                      "csrc", "dem.cu")
    return srcs


def time_grid(label, dim, grid, libs, dev, old=()):
    scheme, scene = cs.dem_scene(dev, dim, grid)
    spill = grid == "spill"
    cfg = scheme.cell_config(scene) if spill else scheme.rowwin_config(scene)
    run = (tdk.lvc_displacement_cell_kernel if spill
           else tdk.lvc_displacement_rowwin_kernel)
    p = run(scene, cfg, cs.DEM_DT, scene.tng_idx, scene.tng_idx_dem_id,
            scene.tng_x, scene.tng_y, scene.tng_z, plain=True)
    tables = (p.tng_idx, p.tng_dem, p.tng_x, p.tng_y, p.tng_z)
    kern, _, args, _, _ = cs.dem_kernel_call(scheme, scene, cfg, tables)
    ref = kern(*args)
    n, L = tables[0].shape
    if spill:
        kname, ins = "dem_cell", [args[0], args[1], *tables, args[7]]
        sizes = (cfg.NC_max, args[1].shape[1], cfg.M)
    else:
        kname, ins = "dem_rowwin", [args[0], args[1], args[2], *tables,
                                    args[8]]
        sizes = (cfg.NC_max, cfg.R, cfg.M)
    mat = ins[-1]
    o_sum = torch.zeros((n, 8), device=dev)
    o_tab = torch.full((2, n, L), -1, dtype=torch.int32, device=dev)
    o_spr = torch.zeros((3, n, L), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    line = [f"[dem-variants] {label}: wrapper "
            f"{cs.cuda_ms(lambda: kern(*args), reps=50):.4f} ms"]
    inst, lm = tdk.table_instance(L)
    for name, lib in libs.items():
        fn = getattr(lib, kname)
        ptrs = [t.data_ptr() for t in ins] + [
            o_sum.data_ptr(), o_tab[0].data_ptr(), o_tab[1].data_ptr(),
            o_spr.data_ptr()]
        if name in old:      # no o_match, no LM
            argtypes = list(_build.KERNELS[kname][2])
            del argtypes[len(ptrs)]
            del argtypes[len(ptrs) + len(sizes) + 2]
            fn.argtypes = argtypes
            call = lambda: fn(*ptrs, n, *sizes, L, mat.shape[0],
                              float(cs.DEM_DT), float(cfg.radius), stream)
        else:
            fn.argtypes = _build.KERNELS[kname][2]
            call = lambda: fn(*ptrs, None, n, *sizes, L, lm, mat.shape[0],
                              float(cs.DEM_DT), float(cfg.radius), stream)
        o_sum.zero_()
        o_tab.fill_(-1)
        o_spr.zero_()
        if call() != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        if name in ("full", "parent"):
            same = (torch.equal(o_tab[0], ref[1]) and torch.equal(
                o_tab[1], ref[2]) and torch.equal(o_sum, ref[0]) and all(
                torch.equal(o_spr[k], ref[3 + k]) for k in range(3)))
            cs.check(same, f"{label} {name}: outputs differ from the "
                     "wrapper's")
        line.append(f"{name} {cs.cuda_ms(call, reps=50):.4f}")
    print(" | ".join(line), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose csrc/dem.cu to time "
                    "beside this one (spill grid)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dem_variants: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    srcs = sources(args.parent)
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(lambda kv: build(*kv), srcs.items()))
    libs = {}
    for name, path, report in built:
        print(f"[dem-variants] build {name}:\n{report}", flush=True)
        if path is None:
            return 1
        libs[name] = ctypes.CDLL(path)
    print(f"[dem-variants] {cs.smi_line()}", flush=True)
    dev = torch.device("cuda", 0)
    old = set()
    for name, path in srcs.items():
        with open(path) as f:
            if "o_match" not in f.read():
                old.add(name)
    for label, dim, grid in GRIDS:
        time_grid(label, dim, grid, libs, dev, old)
    return 0


if __name__ == "__main__":
    sys.exit(main())
