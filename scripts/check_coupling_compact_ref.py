"""The JAX package's compact coupling branch on the CPU, two checks.

    JAX_PLATFORMS=cpu python scripts/check_coupling_compact_ref.py

The reference takes the compact contact store (``cl_pid``/``cl_state``)
for a kdkf coupling scene with S >= 8 entities only on its TPU
(``models/rigid_fluid_coupling.py`` :196-223).  This forces it on the
CPU without editing the package: ``_compact_enabled`` patched to return
True on the scheme instance, the Pallas fluid kernels in interpret mode
(``fluid_pallas_interpret``), on ``tests/test_torch_coupling_compact.py``'s
scene (8 boxes of rho 8 in sliding contact in a tank, S = 9).

1. The compact branch against the full route on the same interpret
   kernels: 3 f32 kdkf steps from one state, the compact scene expanded
   (``expand_slot_scene``); prints the largest difference of every
   field (0 is bit for bit).  Two interpret-mode step compiles, about
   75 s each.
2. The same scheme with no fluid group: ``setup`` compacts (its gate
   checks the bodies only), and ``make_step`` routes kdkf to the kdk
   step, which reads the ``[N, S]`` slot fields that the store replaced;
   prints what the step does.  The port gates the store on fluid being
   present.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
os.environ["RB_TPU_X64"] = "1"    # the tests' set-up precision

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_enable_x64", True)

from rigid_body_2d_3d_pysph_tpu import geom as jgeom  # noqa: E402
from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb  # noqa: E402
from rigid_body_2d_3d_pysph_tpu.models.rigid_fluid_coupling import (  # noqa: E402,E501
    RigidFluidCouplingScheme as JRFC)
from rigid_body_2d_3d_pysph_tpu.state import (  # noqa: E402
    make_group, build_scene)

from test_pallas_fluid import _f32  # noqa: E402
from test_torch_coupling_compact import (  # noqa: E402
    DT, boxes_scene, forcing, _full)


def compact_scheme(fluid=True):
    scheme, scene = boxes_scene(make_group, build_scene, jgeom, JRFC)
    if not fluid:
        scheme.fluids = []
    scheme.engine = "cell"
    scheme.fluid_pallas_interpret = True
    scheme._compact_enabled = lambda: True
    return scheme, forcing(scheme.setup(scene), jnp.asarray)


def main():
    scheme, scene = compact_scheme()
    print(f"n={scene.n} S={scene.meta.total_no_bodies} compact store: "
          f"{'cl_pid' in scene.fields}, L={scene.cl_pid.shape[0]}",
          flush=True)
    start = _f32(scene)
    ends = {}
    for name, s0 in (("compact", start), ("full", _full(start))):
        t0 = time.perf_counter()
        step = scheme.make_step(s0)
        s = s0
        for _ in range(3):
            s = step(s, jnp.float32(DT))
        s.x.block_until_ready()
        ends[name] = s
        print(f"{name}: 3 steps in {time.perf_counter() - t0:.1f} s, "
              f"overflow {bool(s.nbr_overflow)}", flush=True)
    a = jrb.expand_slot_scene(ends["compact"])
    b = ends["full"]
    worst = 0.0
    for k in sorted(b.fields):
        if k not in a.fields or np.asarray(b.fields[k]).dtype.kind != "f":
            continue
        d = float(np.abs(np.asarray(a.fields[k], np.float64)
                         - np.asarray(b.fields[k], np.float64)).max())
        worst = max(worst, d)
        if d:
            print(f"  {k}: max |compact - full| {d:.3e}")
    print(f"compact branch vs full route (interpret kernels, f32): largest "
          f"difference {worst:.3e} over every float field; end overlap "
          f"{float(np.asarray(b.overlap).max()):.3e}, |delta_lt_x| "
          f"{float(np.abs(np.asarray(b.delta_lt_x)).max()):.3e}", flush=True)

    scheme, scene = compact_scheme(fluid=False)
    print(f"no fluid group: compact store after setup: "
          f"{'cl_pid' in scene.fields}; [N, S] slot fields: "
          f"{'contact_force_normal_x' in scene.fields}", flush=True)
    try:
        step = scheme.make_step(scene)
        s = step(scene, DT)
        s.x.block_until_ready()
        print("no fluid group: the step ran", flush=True)
    except Exception as e:    # the reference's defect shows here
        print(f"no fluid group: the step fails: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:200]}", flush=True)


if __name__ == "__main__":
    main()
