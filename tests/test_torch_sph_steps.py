"""Port vs reference: the rigid schemes' steps on the cell engine with
the five non-quintic SPH kernels, float64.

The port's cell engine takes the scheme's kernel on every route (its
hand-written kernels on the card, their plain versions here); the JAX
package routes another kernel than the quintic to its XLA fused cell
engine.  Each case sets ``kernel_name`` on the reference scheme before
its set-up (the surface identification takes the kernel too), carries
the set-up state across with ``state.convert.scene_from_numpy`` on the
reference's grid configuration (the kernel's cutoff), and runs 20 steps
of both from it, on ``test_torch_rigid_steppers``' two blocks thrown at
each other over a wall (in contact within 10 steps, sliding):

* GTVF (the port's compact path: K1, the cull, K2 on the culled rows)
  with each of the five kernels;
* RK2 (the Gaussian) and leapfrog (the Wendland C4;
  ``RigidBody3DScheme`` on the 2D scene: leapfrog is the 3D scheme's),
  K1 and K2 on every slot each force evaluation.

Every field both end states hold is compared at rtol 1e-10, atol 1e-10 x
max(|field|, 1) (the two sides sum the pair terms and the per-body
forces in other orders), as in ``test_torch_rigid_steppers``.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb

from test_torch_rigid_steppers import (
    THROW, _compare_all, _port_twin, _run_both, _wall_groups)

NAMES = ("cubic", "wendland", "wendland_c4", "gaussian", "super_gaussian")


@pytest.mark.parametrize("integrator, name", [
    ("gtvf", k) for k in NAMES] + [("rk2", "gaussian"),
                                   ("leapfrog", "wendland_c4")])
def test_rigid_steps_match_xla_f64(integrator, name):
    jgroups, dx = _wall_groups(jmake_group)
    jscene = jbuild_scene(jgroups, dim=2, total_no_bodies=3, spacing0=dx)
    cls = (jrb.RigidBody3DScheme if integrator == "leapfrog"
           else jrb.RigidBody2DScheme)
    jsch = cls(["body"], ["wall"], gy=-9.81, dim=2)
    jsch.engine, jsch.integrator, jsch.kernel_name = "cell", integrator, name
    jscene = jsch.set_linear_velocity(jsch.setup(jscene), THROW)

    tcls = (trb.RigidBody3DScheme if integrator == "leapfrog"
            else trb.RigidBody2DScheme)
    tsch, tscene = _port_twin(jsch, jscene, tcls)
    tsch.kernel_name = name
    if integrator == "gtvf":
        # the port's GTVF keeps the compact store on the cell engine
        cfg = tsch._cell_cfg
        tscene = trb.compact_slot_scene(tscene, tsch.ni_max(cfg) * cfg.M)
    jend, tend = _run_both(jsch, jscene, tsch, tscene)
    # the blocks met: contacts engaged, springs evolved
    assert float(np.asarray(jend.overlap).max()) > 0
    assert float(np.abs(np.asarray(jend.delta_lt_x)).max()) > 0
    _compare_all(jend, tsch.export_scene(tend))
