"""Port vs reference: the coupling scheme's orderings on the cell engine
with non-quintic SPH kernels, float64.

The port's cell engine takes the scheme's kernel on every route (its
hand-written kernels on the card, their plain versions here: K1, B4, B5
in kdkf; K1, B6a, B6b, B6c and K2 on every slot in kdk and reference);
the JAX package routes another kernel than the quintic to its XLA fused
cell engine.  Each case sets ``kernel_name`` on the reference scheme
before its set-up, carries the set-up state across with
``test_torch_coupling_step.port_twin`` (the reference's grid
configuration: the kernel's cutoff) and runs 10 steps of both, on the
tank with a box of 8 times the fluid's density resting 0.95 dx above the
floor, pushed down and sliding, so the contact engages and holds: kdkf
(cubic), kdk (Wendland C2) and reference (super-Gaussian).

The fluid, body and contact-slot fields are compared at rtol 1e-10, atol
1e-10 x max(|field|, 1) (the two sides sum the pair terms in other
orders).
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

from test_torch_coupling_step import (
    BODY, DT_CONTACT, FLUID, SLOTS, _compare, _shadow_fields, _velocities,
    coupling_scene, port_twin)

RTOL = 1e-10
# the dense box: 8 times the fluid's density, pushed down onto the floor
# while it slides
RHO_BOX = 8.0
PUSH = [[0.05, -0.5, 0.0]]
CPL_STEPS = 10


def _dense_box_scene(name, ordering):
    """The reference scheme and set-up state: the box of RHO_BOX on the
    floor, pushed down and sliding, seeded fluid velocities."""
    jsch, scene, dx, rho0 = coupling_scene(jmake_group, jbuild_scene, jgeom,
                                           JRFC, True, floor=True)
    g = scene.meta.group("body")
    m, rho = np.array(scene.m), np.array(scene.rho)
    m[g.start:g.stop] *= RHO_BOX / 2.0
    rho[g.start:g.stop] *= RHO_BOX / 2.0
    scene = scene.replace(m=jnp.asarray(m), rho=jnp.asarray(rho))
    jsch.engine, jsch.kernel_name = "cell", name
    jsch.gtvf_ordering = ordering
    scene = jsch.setup(scene)
    m_fsi, rho_fsi = _shadow_fields(scene, rho0, dx)
    scene = scene.replace(m_fsi=jnp.asarray(m_fsi),
                          rho_fsi=jnp.asarray(rho_fsi))
    return jsch, _velocities(scene, 7, 0.05).replace(vcm=jnp.asarray(PUSH))


@pytest.mark.parametrize("ordering, name", [
    ("kdkf", "cubic"), ("kdk", "wendland"), ("reference", "super_gaussian")])
def test_coupling_steps_match_xla_f64(ordering, name):
    jsch, jscene = _dense_box_scene(name, ordering)
    tsch, tscene = port_twin(jsch, jscene, torch.float64)
    tsch.kernel_name = name
    tsch.gtvf_ordering = ordering
    jstep, tstep = jsch.make_step(jscene), tsch.make_step(tscene)
    for _ in range(CPL_STEPS):
        jscene = jstep(jscene, DT_CONTACT)
        tscene = tstep(tscene, DT_CONTACT)
    # the box is in contact to the end: engaged slots and springs
    assert float(np.asarray(jscene.overlap).max()) > 0
    assert float(np.abs(np.asarray(jscene.delta_lt_x)).max()) > 0
    _compare(jscene, tscene, FLUID + BODY + SLOTS, rtol=RTOL)
