#!/usr/bin/env python3
"""The JAX package's rigid scheme on a preset classic cell grid with its
compact slot store gate open, on the CPU.

    JAX_PLATFORMS=cpu python scripts/check_classic_compact_ref.py

``RigidBody2DScheme._compact_enabled`` (``models/rigid_body.py:262``)
opens on the TPU for the GTVF step on the Pallas engine in float32 with
the quintic kernel, and reads neither the grid config's ``spill`` nor
its ``skin``'s absence.  ``setup`` then compacts the scene (the 25
``[N, S]`` slot fields become ``cl_pid`` / ``cl_state``), while
``build_rigid_gtvf_step_cell`` (``:923``) takes the sorted and compact
routes only on a spill grid: on a classic grid set as ``_cell_cfg``
before ``setup`` it takes the full route, which reads the slot fields
the store replaced.  This script forces the TPU's choices on the CPU
without editing the package: the gate open (``scheme._compact_enabled``
replaced on the instance, ``engine = "pallas"``), and the Pallas
pipelines in interpret mode
(``pallas_contact.contact_pipeline_cell_pallas`` and
``rigid_body.rigid_contact_force_eval_compact`` replaced by their
``interpret=True`` calls, the scheme's ``_cell_pipeline`` giving the
former, as it does on the TPU).  It runs one step of the two-block wall
scene of ``tests/test_torch_rigid_steppers.py`` on:

* the spill grid (the gate's case on the TPU): the compact route runs;
* a classic grid (``spill=False``): the step on the compacted scene;
* the same classic grid with the gate closed: the full route on the full
  schema runs.

It prints each case's outcome and, last, one JSON line (``defect``:
the classic case fails while both others run).  About two minutes: the
interpret-mode kernels compile.
"""

import functools
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402

from rigid_body_2d_3d_pysph_tpu.geom import get_2d_block  # noqa: E402
from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb  # noqa: E402
from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell  # noqa: E402
from rigid_body_2d_3d_pysph_tpu.ops import pallas_contact as pcops  # noqa
from rigid_body_2d_3d_pysph_tpu.state import (  # noqa: E402
    build_scene, make_group)

# the TPU's Pallas pipelines, in interpret mode
PIPELINE = functools.partial(pcops.contact_pipeline_cell_pallas,
                             interpret=True)
pcops.contact_pipeline_cell_pallas = PIPELINE
jrb.rigid_contact_force_eval_compact = functools.partial(
    jrb.rigid_contact_force_eval_compact, interpret=True)


def wall_scene():
    """Two blocks of side 0.2 (dx 0.04) 0.1 above a one-row wall, thrown
    at each other (``tests/test_torch_rigid_steppers.py``)."""
    dx = 0.04
    xb, yb = get_2d_block(dx, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.25])
    y = np.concatenate([yb, yb]) + 0.1
    bid = np.concatenate([np.zeros(len(xb), np.int32),
                          np.ones(len(xb), np.int32)])
    xw = np.arange(-8, 20) * dx
    yw = np.full(len(xw), -0.05)
    m = 2000 * dx * dx
    groups = [make_group("body", x, y, m=m, h=1.3 * dx, rho=2000.0,
                         rad_s=dx / 2, role="rigid", body_id=bid,
                         dem_id=bid),
              make_group("wall", xw, yw, m=m, h=1.3 * dx, rho=2000.0,
                         rad_s=dx / 2, role="boundary", dem_id=2)]
    return build_scene(groups, dim=2, total_no_bodies=3, spacing0=dx), dx


def run(case, spill, gate):
    scene, dx = wall_scene()
    scheme = jrb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    scheme.engine = "pallas"
    scheme._cell_pipeline = lambda: PIPELINE
    if gate:
        scheme._compact_enabled = lambda: True
    host = lambda k: np.asarray(scene[k])
    scheme._cell_cfg = jcell.config_from_positions(
        host("x"), host("y"), host("z"), 3 * 1.3 * dx, 2,
        spill=None if spill else False)
    out = dict(case=case, spill=scheme._cell_cfg.spill, M=scheme._cell_cfg.M,
               gate_open=gate)
    scene = scheme.setup(scene)
    out["compact_store"] = "cl_pid" in scene
    scene = scheme.set_linear_velocity(scene, [[5.0, -1.0, 0.0],
                                               [-5.0, 1.0, 0.0]])
    try:
        step = scheme.make_step(scene)
        end = step(scene, jnp.asarray(1e-4))
        out.update(ok=bool(np.isfinite(np.asarray(end.x)).all()),
                   error=None)
    except Exception as e:  # the outcome is what this script reports
        out.update(ok=False, error=f"{type(e).__name__}: {e}"[:300])
    print(f"[classic-compact] {case}: spill={out['spill']} M={out['M']} "
          f"gate open={gate} compact store={out['compact_store']} -> "
          + ("step ran" if out["ok"] else f"FAILED ({out['error']})"),
          flush=True)
    return out


def main():
    cases = [run("spill grid, gate open", True, True),
             run("classic grid, gate open", False, True),
             run("classic grid, gate closed", False, False)]
    broken = not cases[1]["ok"] and cases[0]["ok"] and cases[2]["ok"]
    print(json.dumps(dict(cases=cases, defect=broken)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
