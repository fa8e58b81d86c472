#!/usr/bin/env python3
"""The slab phases of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/slab_phases.py [2d] [3d] [dem] [cpl2d] [cpl3d]

Run from the repository root on the machine with the card.  It builds
the kernels as ``chip_smoke.py`` does and runs its slab phases with
their checks: ``2d`` phase 28 (the 2D stack on SLAB_P slabs against the
single-device and the plain slab steps, then 200 steps and the steps/s
of SLAB_P slabs and of one), ``3d`` phase 29 (the 3D cubes on the most
slabs of at least 2 cell columns, both routes, against the slab step on
one slab), ``dem`` phase 30 (the DEM column on SLAB_P slabs), ``cpl2d``
phase 32 (the coupling slab step on the sinking box, kdk and kdkf on
SLAB_P slabs, each slab's kernels, 200 steps of each and the kdkf steps/s
of one slab), ``cpl3d`` phase 33 (the 3D box, kdkf); all five by
default.  It exits 1 when a check fails and prints the phases'
numbers as one JSON line last.  It imports nothing from JAX.
"""

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch import config  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import _build  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import (  # noqa: E402
    get_kernel)


def main() -> int:
    which = sys.argv[1:] or ["2d", "3d", "dem", "cpl2d", "cpl3d"]
    smi = cs.smi_line()
    print(f"[env] {smi} torch {torch.__version__} cuda "
          f"{torch.version.cuda} devices {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = config.device()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        list(pool.map(_build.build, _build.SOURCES))
    for k in _build.KERNELS:
        _build.load(k)
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    out = {}
    try:
        if "2d" in which:
            scheme, scene, dx = cs.contact_scene_2d(dev)
            out["2d"] = cs.phase_slab_rigid(
                scheme, scene, dx, smi, "slab-rigid-2d", cs.SLAB_P,
                long_steps=cs.N_STEPS, single_steps=2 * cs.CHUNK)
        if "3d" in which:
            scheme, scene, dx = cs.contact_scene_3d(dev)
            P3 = cs.largest_slab_count(scheme.cell_config(
                scene, get_kernel(scheme.kernel_name, 3)))
            out["3d"] = cs.phase_slab_rigid(
                scheme, scene, dx, smi, "slab-rigid-3d", P3,
                routes=("blob", "full"), one_slab_ref=True)
        if "dem" in which:
            k4 = {}
            out["dem"] = cs.phase_slab_dem(smi, cs.SLAB_P, dev, k4)
            out["dem_k4"] = k4
        cpl = {}
        if "cpl2d" in which:
            for o in ("kdk", "kdkf"):
                out[f"cpl2d_{o}"] = cs.phase_slab_coupling(
                    smi, dev, o, 2, cs.SLAB_P, cpl, long_steps=cs.N_STEPS,
                    single_steps=2 * cs.CHUNK if o == "kdkf" else 0)
        if "cpl3d" in which:
            out["cpl3d"] = cs.phase_slab_coupling(smi, dev, "kdkf", 3,
                                                  cs.SLAB_P, cpl)
        out["cpl_kernels"] = cpl
    except cs.PhaseError as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    print(f"[done] slab phases {', '.join(which)} on {smi}", flush=True)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
