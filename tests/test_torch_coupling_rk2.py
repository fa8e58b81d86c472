"""Port vs reference: the RK2 coupling step (``fluid_stepper="rk2"``).

* 10 float64 RK2 steps (Tait) of the hydrostatic tank of
  ``tests/test_fluid_coupling.py`` with a box added, sliding on the tank
  floor under the fluid (``test_torch_coupling_step``'s placement,
  seeded random velocities), so the FSI force and the contact both act,
  against the reference's ``_make_step_cell_rk2`` on its XLA cell
  engine: the fluid, body and contact-slot fields and the RK2 saved
  state at rtol 1e-10, atol 1e-10 x max(|field|, 1) (the two sides sum
  the pair terms and the per-body forces in other orders).
* The RK2 step raises with EDAC, as the reference's does.

Both sides start from one state carried across with
``state.convert.scene_from_numpy`` on the reference's grid
configuration (``test_torch_coupling_step.port_twin``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu_torch import geom as tgeom
from rigid_body_2d_3d_pysph_tpu_torch.models import (
    RigidFluidCouplingScheme as TRFC)
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group as tmake_group, build_scene as tbuild_scene)

from test_torch_coupling_step import (
    BODY, CPU, DT_CONTACT, FLUID, SLOTS, _compare, _jax_floor_scene,
    _run_reference, _velocities, coupling_scene, port_twin)

RK2_STATE = ("x0", "y0", "u0", "v0", "rho0_rk", "xcm0", "vcm0", "omega0",
             "ang_mom0", "R0")


def _rk2(jsch):
    jsch.edac = False
    jsch.fluid_stepper = "rk2"
    return jsch


def test_ten_f64_rk2_steps_match_xla():
    jsch, jscene = _jax_floor_scene()
    jscene = _velocities(jscene, 7, 0.05).replace(
        vcm=jnp.asarray([[0.05, -0.02, 0.0]]))
    jsch = _rk2(jsch)
    start, jend = _run_reference(jsch, jscene, 10, DT_CONTACT)
    tsch, tscene = port_twin(jsch, start, torch.float64)
    tsch.fluid_stepper = "rk2"
    step = tsch.make_step(tscene)
    for _ in range(10):
        tscene = step(tscene, DT_CONTACT)
    assert float(np.abs(np.asarray(jend.fx)).max()) > 0   # FSI is on
    assert float(np.asarray(jend.overlap).max()) > 0      # in contact
    assert float(np.abs(np.asarray(jend.delta_lt_x)).max()) > 0
    _compare(jend, tscene, FLUID + ("cs",) + BODY + SLOTS + RK2_STATE,
             rtol=1e-10)


def test_rk2_raises_with_edac():
    tsch, tscene, _, _ = coupling_scene(
        tmake_group, tbuild_scene, tgeom, TRFC, True, device=CPU,
        dtype=torch.float64)
    tscene = tsch.setup(tscene)
    for k in ("x0", "y0", "z0", "u0", "v0", "w0", "rho0_rk"):
        assert k in tscene
    tsch.fluid_stepper = "rk2"
    assert tsch.edac
    with pytest.raises(NotImplementedError, match="Tait"):
        tsch.make_step(tscene)
    tsch.edac = False
    assert callable(tsch.make_step(tscene))
