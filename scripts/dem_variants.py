#!/usr/bin/env python3
"""Where the DEM pair kernels' time goes, on one CUDA card.

    python3 scripts/dem_variants.py [--parent DIR] [--widths 8,12,...]
        [--lanes 4,24,32,64,128]

Run from the repository root on the machine with the card.  It builds
``csrc/dem.cu`` as it is and in two cut-down copies, each with ``nvcc``
into ``build/dem_variants/``:

* ``noscan``: no gate scan, so no pair list and no pair bodies (staging
  of the candidate tiles, the table load and the write-back remain);
* ``nopair``: the scan and the pair lists, the pair bodies replaced by a
  "not gated" code;

and, with ``--parent DIR``, the ``csrc/dem.cu`` of another checkout:
one of this one's entry points, or one that still takes the global
match bitmap ``o_match`` (zeros, passed here) and picks among its table
widths 8, 16, 32 and 0 (the rows in global memory).  On
``chip_smoke.py``'s DEM scenes (~104k grains in 2D at L = 8; the ~123k
3D column at each table width of ``--widths``, default 8, 12, 16, 32,
40; the contact table filled by a plain pass; the 2D column again at
each slot width of ``--lanes`` at L = 8, K4 on the spill grid of that M
and K3 on row windows of that M: the runtime-width instance, which a
parent that takes 8 and 16 lanes only refuses) it prints, per grid and
width: the bound (bytes: each particle's 13 pack fields, 8 sums and
table row of 5L words read and written once; operations: 9 a candidate
lane, 140 a gated pair), the wrapper's time (allocation and the fills of
the outputs included), the fills alone (``torch.zeros`` and
``torch.full`` of the outputs), and each build's time per launch into
preallocated outputs: CUDA events over 50 launches, behind a device
sleep so that the host's enqueue is not timed.  The full build and the
parent are checked against the wrapper bit for bit (sums, counts,
tables and springs); the cut-down copies compute less by design.  Also
prints ptxas's registers, shared memory and spills per kernel instance.

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
from rigid_body_2d_3d_pysph_tpu_torch.ops import rowwin as rw  # noqa: E402

SOURCE = os.path.join(_build.CSRC, "dem.cu")
OUT = os.path.join(ROOT, "build", "dem_variants")
CUTS = {
    "noscan": ("for (int k = 0; k < kmax; k += 2) {",
               "for (int k = 0; k < 0; k += 2) {"),
    "nopair": ("for (int i = lane; i < cnt; i += 32) pair(i);",
               "for (int i = lane; i < cnt; i += 32) lc[i] = NOT_GATED;"),
}
GRIDS = (("2D spill", 2, "spill"), ("2D rowwin", 2, "rowwin"),
         ("3D spill", 3, "spill"), ("3D rowwin", 3, "rowwin"))
PARENT_WIDTHS = (8, 16, 32)   # a parent with o_match: its table widths


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


def parent_width(L):
    """A parent with ``o_match``: the least of its widths that holds L,
    else 0 (its rows in global memory)."""
    return next((lm for lm in PARENT_WIDTHS if L <= lm), 0)


def time_grid(label, dim, grid, L, libs, dev, old=(), M=None):
    scheme, scene = cs.dem_scene(dev, dim, grid, L=L)
    spill = grid == "spill"
    if M is not None:     # the slot width set on the scheme's grid
        host = lambda k: scene[k].cpu().numpy()
        if spill:
            scheme.cell_factor = dict(cs.DEM_WIDTHS).get(M, 8.0)
            scheme.cell_M = M
        else:
            scheme._rowwin_cfg = rw.rowwin_config_from_positions(
                host("x"), host("y"), host("z"),
                scheme._contact_radius(scene), dim, M=M)
        label = f"{label} M={M}"
    cfg = scheme.cell_config(scene) if spill else scheme.rowwin_config(scene)
    run = (tdk.lvc_displacement_cell_kernel if spill
           else tdk.lvc_displacement_rowwin_kernel)
    p = run(scene, cfg, cs.DEM_DT, scene.tng_idx, scene.tng_idx_dem_id,
            scene.tng_x, scene.tng_y, scene.tng_z, plain=True)
    tables = (p.tng_idx, p.tng_dem, p.tng_x, p.tng_y, p.tng_z)
    kern, _, args, _, lanes = cs.dem_kernel_call(scheme, scene, cfg, tables)
    ref = kern(*args)
    n = tables[0].shape[0]
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
    o_match = torch.zeros((n, (L + 31) // 32), dtype=torch.int32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gated = int(ref[0][:, 7].sum())
    bms, bby = cs.bound(4 * n * (tdk.NF + 8 + 2 * 5 * L),
                        lanes * cs.OPS_PER_LANE + gated * cs.OPS_PER_DEM_PAIR)

    def fills():
        torch.zeros(n * (8 + 3 * L), dtype=torch.float32, device=dev)
        torch.full((2, n, L), -1, dtype=torch.int32, device=dev)

    inst, lm = tdk.table_instance(L)
    line = [f"[dem-variants] {label} L={L} ({inst}): n={n}, {gated} gated, "
            f"bound {bms:.4f} ms by {bby} | wrapper "
            f"{cs.cuda_ms(lambda: kern(*args), reps=50):.4f} ms, fills "
            f"{cs.cuda_ms(fills, reps=50):.4f}"]
    for name, lib in libs.items():
        fn = getattr(lib, kname)
        ptrs = [t.data_ptr() for t in ins] + [
            o_sum.data_ptr(), o_tab[0].data_ptr(), o_tab[1].data_ptr(),
            o_spr.data_ptr()]
        if name in old:      # the global match bitmap, the parent's widths
            argtypes = list(_build.KERNELS[kname][2])
            argtypes.insert(len(ptrs), ctypes.c_void_p)
            fn.argtypes = argtypes
            plm = parent_width(L)
            call = lambda: fn(*ptrs, o_match.data_ptr(), n, *sizes, L, plm,
                              mat.shape[0], float(cs.DEM_DT),
                              float(cfg.radius), stream)
        else:
            fn.argtypes = _build.KERNELS[kname][2]
            call = lambda: fn(*ptrs, n, *sizes, L, lm, mat.shape[0],
                              float(cs.DEM_DT), float(cfg.radius), stream)
        o_sum.zero_()
        o_tab.fill_(-1)
        o_spr.zero_()
        o_match.zero_()
        if call() != 0:
            if name == "parent" and M is not None:
                line.append("parent refuses the width")
                continue
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        if name in ("full", "parent"):
            same = (torch.equal(o_tab[0], ref[1]) and torch.equal(
                o_tab[1], ref[2]) and torch.equal(o_sum, ref[0]) and all(
                torch.equal(o_spr[k], ref[3 + k]) for k in range(3)))
            cs.check(same, f"{label} L={L} {name}: outputs differ from the "
                     "wrapper's")
        timed = call
        if name in old and parent_width(L) == 0:
            # its rows in global memory: the bitmap's zero fill is part of
            # every launch (its wrapper's)
            timed = lambda: (o_match.zero_(), call())
        line.append(f"{name} {cs.cuda_ms(timed, reps=50):.4f}")
    print(" | ".join(line), flush=True)
    del scheme, scene


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose csrc/dem.cu to time "
                    "beside this one")
    ap.add_argument("--widths", default="8,12,16,32,40",
                    help="table widths of the 3D column (2D: L = 8)")
    ap.add_argument("--lanes", default="4,24,32,64,128",
                    help="slot widths of the 2D column at L = 8 (empty: "
                    "none)")
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
            if "o_match" in f.read():
                old.add(name)
    widths = [int(w) for w in args.widths.split(",")]
    for label, dim, grid in GRIDS:
        for L in (widths if dim == 3 else (8,)):
            time_grid(label, dim, grid, L, libs, dev, old)
    for M in [int(m) for m in args.lanes.split(",") if m]:
        for label, dim, grid in GRIDS[:2]:
            time_grid(label, dim, grid, 8, libs, dev, old, M=M)
    return 0


if __name__ == "__main__":
    sys.exit(main())
