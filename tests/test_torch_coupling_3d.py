"""Port vs reference: the rigid-fluid coupling step in 3D.

f64, 6 fused kdkf steps of ``coupling_scene_3d`` (a box of rho 2 dipped
into the surface of a small 3D tank, the displaced fluid's shadow mass
and density on the box, seeded random velocities on every particle):
the port's step (its kernels' plain twins on CPU tensors) against the
reference scheme's XLA kdkf branch (``engine="cell"``), every field at
rtol 1e-10 (atol 1e-10 x max(|field|, 1)).  Both start from one state,
carried across with ``state.convert.scene_from_numpy``, on the
reference's grid configuration.
"""

import numpy as np
import jax.numpy as jnp
import torch

from rigid_body_2d_3d_pysph_tpu import geom as jgeom
from rigid_body_2d_3d_pysph_tpu.models.rigid_fluid_coupling import (
    RigidFluidCouplingScheme as JRFC)
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from test_torch_coupling_step import coupling_scene_3d, port_twin

N_STEPS = 6
DT = 1e-4


def _reference_start():
    jsch, jscene = coupling_scene_3d(jmake_group, jbuild_scene, jgeom, JRFC)
    jsch.engine = "cell"
    jscene = jsch.setup(jscene)
    rb = np.asarray(jscene.is_rigid)
    dx = jscene.meta.spacing0
    rng = np.random.default_rng(31)
    vel = {k: jnp.asarray(rng.uniform(-0.05, 0.05, jscene.n))
           for k in ("u", "v", "w")}
    return jsch, jscene.replace(
        m_fsi=jnp.asarray(np.where(rb, jsch.rho0 * dx**3,
                                   np.asarray(jscene.m_fsi))),
        rho_fsi=jnp.asarray(np.where(rb, jsch.rho0,
                                     np.asarray(jscene.rho_fsi))),
        **vel)


def test_3d_kdkf_steps_match_xla_kdkf_f64():
    jsch, start = _reference_start()
    jstep = jsch.make_step(start)
    jscene = start
    for _ in range(N_STEPS):
        jscene = jstep(jscene, DT)
    tsch, tscene = port_twin(jsch, start, torch.float64)
    assert tsch.dim == 3 and tsch.gtvf_ordering == "kdkf"
    tstep = tsch.make_step(tscene)
    for _ in range(N_STEPS):
        tscene = tstep(tscene, DT)

    assert not bool(jscene.nbr_overflow) and not bool(tscene.nbr_overflow)
    # the box moved and the FSI force is on
    assert float(np.abs(np.asarray(jscene.force)).max()) > 0
    assert float(np.abs(np.asarray(jscene.vcm)).max()) > 0
    # every field (the port carries the reference's whole state across)
    assert set(jscene.fields) == set(tscene.fields)
    for name in sorted(tscene.fields):
        a = np.asarray(jscene.fields[name])
        b = tscene.fields[name].numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(b, a, err_msg=name)
            continue
        assert np.isfinite(b).all(), name
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10 * scale,
                                   err_msg=name)
