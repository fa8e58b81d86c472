"""Port vs reference: the kdk and reference orderings of the coupling
step and the scheme with no fluid group, end to end in float64.

Each case runs the port's step (the kernels' plain twins on CPU tensors)
against the JAX package's XLA ``_make_step_cell`` (engine ``"cell"``; its
Pallas split-pass branch runs only with the TPU contact pipeline), both
sides starting from one state carried across with
``state.convert.scene_from_numpy`` on the reference's grid
configuration (``test_torch_coupling_step.port_twin``):

* kdk and reference, 10 steps with the box sliding on the tank floor, so
  the contact engages and the tangential springs evolve;
* kdk with Tait (``edac=False``), 4 steps; kdk on the fluid-only tank
  (B6c without bodies), 4 steps;
* the no-fluid scheme (a box sliding on the tank's walls, kdkf routed to
  kdk as in the reference), 10 steps in contact, and the same in the
  reference ordering.

Tolerance rtol 1e-9, atol 1e-9 x max(|field|, 1): the XLA engine sums the
pair terms, the per-body forces and torques in other orders, and merges
the fluid/boundary and FSI-rigid classes of the force pass in two terms
where the port sums them in one.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu import geom as jgeom
from rigid_body_2d_3d_pysph_tpu.models.rigid_fluid_coupling import (
    RigidFluidCouplingScheme as JRFC)
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from test_fluid_coupling import _tank_scene
from test_torch_coupling_step import (
    BODY, DT_CONTACT, FLUID, GAP, SLOTS, _compare, _jax_floor_scene,
    _run_reference, _velocities, port_twin)

SLIDE = [[0.05, -0.02, 0.0]]


def _port_run(jsch, start, n_steps, dt):
    tsch, tscene = port_twin(jsch, start, torch.float64)
    tsch.gtvf_ordering = jsch.gtvf_ordering
    step = tsch.make_step(tscene)
    for _ in range(n_steps):
        tscene = step(tscene, dt)
    return tscene


def _assert_in_contact(jend):
    assert float(np.asarray(jend.overlap).max()) > 0
    assert float(np.abs(np.asarray(jend.delta_lt_x)).max()) > 0


@pytest.mark.parametrize("ordering", ["kdk", "reference"])
def test_ten_f64_steps_match_xla_in_contact(ordering):
    jsch, jscene = _jax_floor_scene()
    jsch.gtvf_ordering = ordering
    jscene = _velocities(jscene, 7, 0.05).replace(vcm=jnp.asarray(SLIDE))
    start, jend = _run_reference(jsch, jscene, 10, DT_CONTACT)
    tend = _port_run(jsch, start, 10, DT_CONTACT)
    _assert_in_contact(jend)
    assert float(np.abs(np.asarray(jend.fx)).max()) > 0   # FSI is on
    _compare(jend, tend, FLUID + BODY + SLOTS, rtol=1e-9)


@pytest.mark.parametrize("case", ["tait", "fluid_only"])
def test_f64_kdk_branches_match_xla(case):
    jsch, jscene, _, _, _ = _tank_scene(with_body=case == "tait")
    jsch.gtvf_ordering = "kdk"
    if case == "tait":
        jsch.edac = False
    jscene = _velocities(jscene, 9, 0.05)
    start, jend = _run_reference(jsch, jscene, 4, 1e-4)
    tend = _port_run(jsch, start, 4, 1e-4)
    names = FLUID + (("cs",) + BODY if case == "tait" else ())
    _compare(jend, tend, names, rtol=1e-9)


def _jax_no_fluid_scene():
    """The tank's walls and the box GAP dx above its floor, with no fluid
    group (the reference's stack-of-cylinders setup: an RFC scheme with
    ``fluids=[]``)."""
    dx, gy, rho0 = 0.05, -1.0, 1.0
    _, _, xt, yt = jgeom.hydrostatic_tank_2d(1.0, 1.0, 1.4, 3, dx, dx)
    xb, yb = jgeom.get_2d_block(dx, 0.2, 0.2)
    xb += 0.5
    yb += (-dx + GAP * dx) - yb.min()
    groups = [
        jmake_group("tank", xt, yt, m=rho0 * dx * dx, h=dx, rho=rho0,
                    rad_s=dx / 2, role="boundary", dem_id=1),
        jmake_group("body", xb, yb, m=2.0 * rho0 * dx * dx, h=dx,
                    rho=2.0 * rho0, rad_s=dx / 2, role="rigid",
                    body_id=np.zeros(len(xb), np.int32),
                    dem_id=np.zeros(len(xb), np.int32))]
    scene = jbuild_scene(groups, dim=2, total_no_bodies=2, spacing0=dx)
    c0 = 10 * np.sqrt(2 * abs(gy) * 1.0)
    scheme = JRFC(rigid_bodies=["body"], fluids=[], boundaries=["tank"],
                  dim=2, rho0=rho0, p0=rho0 * c0**2, c0=c0, gy=gy, nu=0.0,
                  h=dx)
    scheme.engine = "cell"
    return scheme, scheme.setup(scene)


def test_ten_f64_no_fluid_steps_match_xla_in_contact():
    jsch, jscene = _jax_no_fluid_scene()
    assert jsch.gtvf_ordering == "kdkf"       # routed to kdk on both sides
    jscene = _velocities(jscene, 3, 0.05).replace(vcm=jnp.asarray(SLIDE))
    start, jend = _run_reference(jsch, jscene, 10, DT_CONTACT)
    tend = _port_run(jsch, start, 10, DT_CONTACT)
    _assert_in_contact(jend)
    _compare(jend, tend, ("x", "y", "u", "v") + BODY + SLOTS, rtol=1e-9)


def test_ten_f64_no_fluid_reference_steps_match_xla_in_contact():
    """The reference ordering with no fluid group: the port builds its
    grid and contact pack after the kick (the positions are still x_n),
    the JAX step builds the grid before the kick and packs the kicked
    state on it."""
    jsch, jscene = _jax_no_fluid_scene()
    jsch.gtvf_ordering = "reference"
    jscene = _velocities(jscene, 3, 0.05).replace(vcm=jnp.asarray(SLIDE))
    start, jend = _run_reference(jsch, jscene, 10, DT_CONTACT)
    tend = _port_run(jsch, start, 10, DT_CONTACT)
    _assert_in_contact(jend)
    _compare(jend, tend, ("x", "y", "u", "v") + BODY + SLOTS, rtol=1e-9)
