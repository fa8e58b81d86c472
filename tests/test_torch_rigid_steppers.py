"""Port vs reference: the rigid schemes' RK2 and leapfrog steppers.

* RK2 (``integrator="rk2"``) in 2D on two blocks over a wall
  (``tests/test_cell_engine.py``'s RK2 scene), thrown at each other and
  sliding past each other so their contact engages within the run and
  the tangential springs evolve, 20 steps in float64 against the reference
  scheme's RK2 step on its XLA cell engine; the port's set-up (the full
  ``[N, S]`` schema, no compact store) equals the reference's field for
  field first.
* Leapfrog (``integrator="leapfrog"``) on the same file's free tumbling
  3D body, 20 steps in float64 against the reference's leapfrog step.
* The port's leapfrog raises in 2D, as the reference's does.

Both sides start from one state carried across with
``state.convert.scene_from_numpy`` on the reference's grid
configuration.  Every field both scenes hold (body and particle state,
forces, the contact slots) is compared at rtol 1e-10, atol 1e-10 x
max(|field|, 1): the two sides sum the pair terms and the per-body
forces in other orders.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rigid_body_2d_3d_pysph_tpu.geom import get_2d_block, get_3d_block
from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group as tmake_group, build_scene as tbuild_scene)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

CPU = torch.device("cpu")
RTOL = 1e-10
DT = 1e-4
N_STEPS = 20
# the blocks' facing sides are 1.25 dx apart (a contact engages below
# 1 dx; the one-row wall is no contact surface): closing at 10 m/s they
# touch within 10 steps and stay in contact, sliding at 2 m/s
THROW = [[5.0, -1.0, 0.0], [-5.0, 1.0, 0.0]]


def _wall_groups(make_group):
    """Two blocks 0.1 above a wall row (the RK2 scene of
    ``test_cell_engine.test_rk2_and_leapfrog_cell_match_nklist``)."""
    dx = 0.04
    xb, yb = get_2d_block(dx, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.25])
    y = np.concatenate([yb, yb]) + 0.1
    bid = np.concatenate([np.zeros(len(xb), np.int32),
                          np.ones(len(xb), np.int32)])
    xw = np.arange(-8, 20) * dx
    yw = np.full(len(xw), -0.05)
    m = 2000 * dx * dx
    body = make_group("body", x, y, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role="rigid", body_id=bid, dem_id=bid)
    wall = make_group("wall", xw, yw, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role="boundary", dem_id=2)
    return [body, wall], dx


def _free_body_group(make_group):
    """The same file's 3D free tumbling body."""
    dx = 0.04
    x3, y3, z3 = get_3d_block(dx, 0.2, 0.12, 0.16)
    grp = make_group("body", x3, y3, z3, m=2000 * dx * dx, h=1.3 * dx,
                     rho=2000.0, rad_s=dx / 2, role="rigid",
                     body_id=np.zeros(len(x3), np.int32),
                     dem_id=np.zeros(len(x3), np.int32))
    return [grp], dx, (x3, y3, z3)


def _port_twin(jsch, jscene, cls):
    """The port's scheme and scene for a set-up reference pair."""
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    tscene = scene_from_numpy(fields, jscene.meta, CPU, torch.float64)
    tsch = cls(jsch.rigid_bodies, jsch.boundaries, jsch.dim, kr=jsch.kr,
               kf=jsch.kf, fric_coeff=jsch.fric_coeff, gx=jsch.gx,
               gy=jsch.gy, gz=jsch.gz)
    tsch.integrator = jsch.integrator
    tsch._cell_cfg = tcell.CellGridConfig(**{
        f.name: getattr(jsch._cell_cfg, f.name)
        for f in dataclasses.fields(tcell.CellGridConfig)})
    return tsch, tscene


def _run_both(jsch, jscene, tsch, tscene):
    jstep = jsch.make_step(jscene)
    tstep = tsch.make_step(tscene)
    for _ in range(N_STEPS):
        jscene = jstep(jscene, jnp.asarray(DT))
        tscene = tstep(tscene, DT)
    assert not bool(jscene.nbr_overflow) and not bool(tscene.nbr_overflow)
    return jscene, tscene


def _compare_all(jend, tend):
    names = sorted(set(jend.fields) & set(tend.fields))
    assert {"x", "u", "xcm", "vcm", "omega", "R", "ang_mom", "force",
            "torque", "fx", "overlap", "delta_lt_x"} <= set(names)
    for k in names:
        a, b = np.asarray(jend[k]), tend[k].numpy()
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            assert np.isfinite(b).all(), k
            scale = max(float(np.abs(a).max(initial=0.0)), 1.0)
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL * scale,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def test_rk2_2d_matches_reference_cell_engine_f64():
    jgroups, dx = _wall_groups(jmake_group)
    jscene = jbuild_scene(jgroups, dim=2, total_no_bodies=3, spacing0=dx)
    assert jscene.x.dtype == jnp.float64
    jsch = jrb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    jsch.engine = "cell"
    jsch.integrator = "rk2"
    jscene = jsch.setup(jscene)

    # the port's set-up keeps the full [N, S] schema
    tgroups, _ = _wall_groups(tmake_group)
    tset = tbuild_scene(tgroups, dim=2, total_no_bodies=3, spacing0=dx,
                        device=CPU, dtype=torch.float64)
    tsch0 = trb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    tsch0.integrator = "rk2"
    tset = tsch0.setup(tset)
    assert "cl_pid" not in tset and tsch0.export_scene(tset) is tset
    assert set(tset.fields) == set(jscene.fields)
    _compare_all(jscene, tset)

    jscene = jsch.set_linear_velocity(jscene, THROW)
    tsch, tscene = _port_twin(jsch, jscene, trb.RigidBody2DScheme)
    jend, tend = _run_both(jsch, jscene, tsch, tscene)
    # the blocks met: contacts engaged, springs evolved
    assert float(np.asarray(jend.overlap).max()) > 0
    assert float(np.abs(np.asarray(jend.delta_lt_x)).max()) > 0
    _compare_all(jend, tend)


def test_leapfrog_3d_free_body_matches_reference_f64():
    jgroups, dx, (x3, y3, z3) = _free_body_group(jmake_group)
    jscene = jbuild_scene(jgroups, dim=3, total_no_bodies=1, spacing0=dx)
    jsch = jrb.RigidBody3DScheme(["body"], [], dim=3)
    jsch.engine = "cell"
    jsch.integrator = "leapfrog"
    # small cell chunks keep the reference's 27-cell f64 blocks small
    jsch._cell_cfg = jcell.config_from_positions(
        x3, y3, z3, 3 * 1.3 * dx, 3, cell_chunk=4)
    jscene = jsch.setup(jscene)
    jscene = jsch.set_linear_velocity(jscene, [1.0, 0.5, 0.25])
    jscene = jsch.set_angular_velocity(jscene, [0.5, 1.5, 0.25])

    tsch, tscene = _port_twin(jsch, jscene, trb.RigidBody3DScheme)
    jend, tend = _run_both(jsch, jscene, tsch, tscene)
    # it tumbled: the rotation left the identity
    assert float(np.abs(np.asarray(jend.R)[0] - np.eye(3)).max()) > 1e-3
    _compare_all(jend, tend)


def test_leapfrog_raises_in_2d():
    tgroups, dx = _wall_groups(tmake_group)
    tscene = tbuild_scene(tgroups, dim=2, total_no_bodies=3, spacing0=dx,
                          device=CPU, dtype=torch.float64)
    tsch = trb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    tsch.integrator = "leapfrog"
    tscene = tsch.setup(tscene)
    with pytest.raises(ValueError, match="3D-only"):
        tsch.make_step(tscene)
