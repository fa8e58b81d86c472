"""Port vs reference: the 3D GTVF rigid step end to end.

* f64, 10 steps: two cubes on a floor slab (the scene of
  ``tests/test_pallas_contact.py`` in float64, random particle
  velocities, body state from the reference's ``setup_body_state``): the
  port's compact step (on CPU tensors its kernels run their plain twins)
  against the reference's jitted cell-engine step, rtol 1e-10 over the
  contact slot fields and the trajectory.
* The interesting-slot capacity: ``RigidBody3DScheme.ni_max`` is the
  reference's formula at capacity boosts 1 and 2.25, and on the same
  scene the compact pipeline raises ``overflow`` exactly when ``ni_max``
  is below the cull's count.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.geom import get_3d_block
from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline as JQuintic
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)
from rigid_body_2d_3d_pysph_tpu.state import rigid_setup as jrs

from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import (
    QuinticSpline as TQuintic)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_compact_contact import CHECK, PARAMS

CPU = torch.device("cpu")
TRAJ = ("x", "y", "z", "u", "v", "w", "xcm", "vcm", "omega", "R")


def _scene_3d_f64():
    """Two cubes 0.6 dx apart over a floor slab 0.7 dx below them, dx =
    0.05 (734 particles, S = 3), with seeded random particle and body
    velocities so contacts are real and the springs evolve."""
    dx = 0.05
    xb, yb, zb = get_3d_block(dx, 0.2, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.2 + 0.6 * dx])
    y = np.concatenate([yb, yb])
    z = np.concatenate([zb, zb])
    bid = np.repeat(np.arange(2, dtype=np.int32), len(xb))
    xw, yw = (a.ravel() for a in np.meshgrid(np.arange(-6, 16) * dx,
                                             np.arange(-6, 16) * dx))
    zw = np.full(len(xw), zb.min() - 0.7 * dx)
    m = 2000 * dx**3
    body = jmake_group("body", x, y, z=z, m=m, h=1.3 * dx, rho=2000.0,
                       rad_s=dx / 2, role="rigid", body_id=bid, dem_id=bid)
    wall = jmake_group("wall", xw, yw, z=zw, m=m, h=1.3 * dx, rho=2000.0,
                       rad_s=dx / 2, role="boundary", dem_id=2)
    scene = jbuild_scene([body, wall], dim=3, total_no_bodies=3,
                         spacing0=dx)
    scene = jrb._attach_contact_fields(jrs.setup_body_state(scene))
    rng = np.random.default_rng(11)
    n = scene.n
    scene = scene.replace(
        contact_force_is_boundary=jnp.ones(n),
        u=jnp.asarray(rng.uniform(-1, 1, n)),
        v=jnp.asarray(rng.uniform(-1, 1, n)),
        w=jnp.asarray(rng.uniform(-1, 1, n)),
        vcm=jnp.asarray(rng.uniform(-0.2, 0.2, (2, 3))))
    return scene, dx


def _cfgs(fields, dx):
    args = (fields["x"], fields["y"], fields["z"], 3 * 1.3 * dx, 3)
    return (jcell.config_from_positions(*args, cell_chunk=16),
            tcell.config_from_positions(*args, cell_chunk=16))


def test_ten_f64_3d_steps_match_cell_engine():
    jscene, dx = _scene_3d_f64()
    assert jscene.x.dtype == jnp.float64
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    jcfg, tcfg = _cfgs(fields, dx)
    ni = tcfg.NC_max
    dt = 1e-4

    jstep = jrb.build_rigid_gtvf_step_cell(JQuintic(dim=3), jcfg, PARAMS,
                                           False)
    tstep = trb.build_rigid_gtvf_step_cell(TQuintic(dim=3), tcfg, PARAMS,
                                           False, ni_max=ni)
    tscene = trb.compact_slot_scene(
        scene_from_numpy(fields, jscene.meta, CPU, torch.float64),
        ni * tcfg.M)
    for _ in range(10):
        jscene = jstep(jscene, dt)
        tscene = tstep(tscene, dt)
    assert not bool(jscene.nbr_overflow) and not bool(tscene.nbr_overflow)
    t = trb.expand_slot_scene(tscene)
    assert float(np.abs(np.asarray(jscene.overlap)).max()) > 0   # in contact
    for name in CHECK + TRAJ:
        a = np.asarray(jscene.fields[name])
        b = t.fields[name].numpy()
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10 * scale,
                                   err_msg=name)


def test_3d_ni_max_and_overflow():
    jscene, dx = _scene_3d_f64()
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    tscene = scene_from_numpy(fields, jscene.meta, CPU, torch.float64)
    jsch = jrb.RigidBody3DScheme(["body"], ["wall"], dim=3, gy=-9.81)
    tsch = trb.RigidBody3DScheme(["body"], ["wall"], dim=3, gy=-9.81)
    host = (fields["x"], fields["y"], fields["z"], 3 * 1.3 * dx, 3)
    for boost in (1.0, 2.25):
        jsch.capacity_boost = tsch.capacity_boost = boost
        jcfg = jcell.config_from_positions(*host, cell_chunk=16,
                                           capacity_boost=boost)
        tcfg = tcell.config_from_positions(*host, cell_chunk=16,
                                           capacity_boost=boost)
        assert tcfg.NC_max == jcfg.NC_max
        assert tsch.ni_max(tcfg) == jsch.ni_max(jcfg)
        # the formula where it does not clip at NC (a 1M-particle grid)
        big = dataclasses.replace(tcfg, NC_max=200_000)
        assert tsch.ni_max(big) == jsch.ni_max(dataclasses.replace(
            jcfg, NC_max=200_000)) == int(np.ceil(12_500 * boost))

    _, tcfg = _cfgs(fields, dx)
    kernel = TQuintic(dim=3)
    n_int = int(tck.contact_pipeline_compact(tscene, tcfg, kernel,
                                             tcfg.NC_max).n_interesting)
    assert 0 < n_int < tcfg.NC_max
    for ni, overflow in ((n_int - 1, True), (n_int, False),
                         (n_int + 1, False)):
        cc = tck.contact_pipeline_compact(tscene, tcfg, kernel, ni)
        assert int(cc.n_interesting) == n_int
        assert bool(cc.overflow) == overflow, ni
