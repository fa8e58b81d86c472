#!/usr/bin/env python3
"""The list-engine phases of ``chip_smoke.py`` alone, on one CUDA card.

    python3 scripts/list_phases.py [par] [r2] [r3] [dem] [cpl]

Run from the repository root on the machine with the card.  It builds
the kernels as ``chip_smoke.py`` does and runs its ``[N, K]`` list
phases with their checks: ``par`` phase 34 (20 list steps against 20
cell kernel steps: the 2D stack after phase 4's 200 steps, the DEM
column after 50 steps, the rho 8 box on the floor in the kdk and
reference orderings), ``r2`` phase 35 (the 2D stack on lists), ``r3``
phase 36 (the 3D cubes, GTVF and leapfrog), ``dem`` phase 37 (the DEM
column, LVCDisplacement and LVCForce), ``cpl`` phase 38 (the sinking
box, kdk and reference); all five by default.  A failed section is
reported and the next runs; it exits 1 when a check failed.  It imports
nothing from JAX.
"""

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


def parities(dev, smi):
    scheme, scene, dx = cs.contact_scene_2d(dev)
    end = cs.phase_main_path(scheme, scene, dx, smi, "cell-2d",
                             cs.N_STEPS)[0]
    cs.phase_engine_parity_rigid(scheme, end, "engine-parity-2d")
    del scheme, scene, end
    scheme, scene = cs.dem_scene(dev, 2)
    end = cs.phase_dem_main(scheme, scene, cs.CHUNK, "dem-cell", smi)[0]
    cs.phase_dem_parity(scheme, end, other=cs.list_twin(scheme),
                        label="dem-engine-parity")
    del scheme, scene, end
    scheme, scene, dt = cs.sinking_box_scene(dev, floor=True,
                                             rho_b=cs.CPL_PARITY_RHO)
    for ordering in ("kdk", "reference"):
        scheme.gtvf_ordering = ordering
        cs.phase_coupling_parity(scheme, scene, dt,
                                 f"{ordering}-engine-parity",
                                 other=cs.list_twin(scheme))


def rigid_2d(dev, smi):
    scheme, scene, dx = cs.contact_scene_2d(dev, engine="nklist")
    cs.phase_main_path(scheme, scene, dx, smi, "list-rigid-2d",
                       cs.LIST_STEPS)


def rigid_3d(dev, smi):
    for integ in ("gtvf", "leapfrog"):
        scheme, scene, dx = cs.contact_scene_3d(dev, integrator=integ,
                                                engine="nklist")
        cs.phase_main_path(scheme, scene, dx, smi, f"list-rigid-3d-{integ}",
                           cs.LIST_3D_STEPS)
        del scheme, scene


def dem(dev, smi):
    for model, n in (("LVCDisplacement", cs.LIST_STEPS),
                     ("LVCForce", cs.COMPARE_STEPS)):
        scheme, scene = cs.dem_scene(dev, 2, contact_model=model,
                                     engine="nklist")
        cs.phase_dem_main(scheme, scene, n, f"list-dem-{model}", smi)
        del scheme, scene


def coupling(dev, smi):
    scheme, scene, dt = cs.sinking_box_scene(dev, engine="nklist")
    for ordering in ("kdk", "reference"):
        scheme.gtvf_ordering = ordering
        cs.phase_coupling_main(scheme, scene, dt, cs.CPL_STEPS,
                               f"list-cpl-{ordering}", smi, {})


SECTIONS = dict(par=parities, r2=rigid_2d, r3=rigid_3d, dem=dem,
                cpl=coupling)


def main() -> int:
    which = sys.argv[1:] or list(SECTIONS)
    smi = cs.smi_line()
    print(f"[env] {smi} torch {torch.__version__} cuda "
          f"{torch.version.cuda} devices {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = config.device()
    t_start = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        list(pool.map(_build.build, _build.SOURCES))
    failed = []
    for name in which:
        t0 = time.perf_counter()
        try:
            SECTIONS[name](dev, smi)
        except cs.PhaseError as e:
            print(f"list_phases: {name} FAILED: {e}", flush=True)
            failed.append(name)
        print(f"[section] {name} {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s, failed: {failed}",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
