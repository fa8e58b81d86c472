"""The port against the independent C++ engine (``csrc/rbnative.cpp``).

* DEM: the port's LVC-displacement step in float64 on CPU tensors, on
  the list engine and on the cell route (the kernels' plain versions),
  against ``rb_dem_lvc_step_n`` on ``tests/test_dem_cell.py``'s jittered
  grain blocks (2D: 25 steps, 3D: 15 steps), as
  ``tests/test_native_oracle.py`` holds the JAX list engine: states,
  forces and torques to atol 1e-10, the contact tables as (partner, dem)
  -> spring maps (slot order depends on the candidate order) to atol
  1e-10: every row in 2D, the grains' rows in 3D (the JAX package's 3D
  oracle test compares no table: the static floor's rows are read by
  nothing, and its particles a spacing apart touch with an overlap of
  rounding size, 1e-17, whose Coulomb slip test sits on its threshold).
  The set-up state is the JAX package's, carried over.
* 150 GTVF steps of the port's 2D rigid scheme in float64 on CPU tensors
(its compact contact path; the kernels' plain versions) against
``rb_gtvf_step_n`` from the same set-up state: two cubes sliding towards
each other just above a wall, the persistent contact state handed from
step to step on both sides.  The tolerances are
``tests/test_native_oracle.py``'s for the reference package (xcm, x, y
1e-8; vcm, u 1e-7; omega 1e-6; force rtol 1e-8, atol 1e-6).  The
oracle's loader is the reference package's ``native`` module; the scene
it reads is the port's.
"""

import numpy as np
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

import pytest

from rigid_body_2d_3d_pysph_tpu.native import dem_lvc_step_n, gtvf_step_n

from rigid_body_2d_3d_pysph_tpu_torch.geom import get_2d_block
from rigid_body_2d_3d_pysph_tpu_torch.models import (DEMScheme,
                                                     RigidBody2DScheme)
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    ROLE_BOUNDARY, ROLE_RIGID, build_scene, make_group)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_dem_cell import _grain_scene, _grain_scene_3d


def _table_map(ti, td, ta, tb, tc):
    return [{(int(i), int(d)): (ta[r, l], tb[r, l], tc[r, l])
             for l, (i, d) in enumerate(zip(ti[r], td[r])) if i >= 0}
            for r in range(ti.shape[0])]


@pytest.mark.parametrize("engine", ("nklist", "cell"))
@pytest.mark.parametrize("dim", (2, 3))
def test_native_dem_trajectory_matches_port(dim, engine):
    jsch, jscene = (_grain_scene(seed=11) if dim == 2
                    else _grain_scene_3d(seed=13))
    n_steps = 25 if dim == 2 else 15
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    scene = scene_from_numpy(fields, jscene.meta, torch.device("cpu"),
                             torch.float64)
    scheme = DEMScheme(["grains"], ["floor"], kn=jsch.kn, en=jsch.en,
                       gy=jsch.gy, dim=dim)
    scheme.engine = engine
    dt = 1e-5
    step = scheme.make_step(scene)
    s = scene
    for _ in range(n_steps):
        s = step(s, dt)
    assert not bool(s.nbr_overflow)
    assert int(s.total_tng_contacts.sum()) > 0

    g = scene.meta.group("grains")
    mob = np.zeros(scene.n, bool)
    mob[g.start:g.stop] = True
    out = dem_lvc_step_n(scene, mob, scheme.gx, scheme.gy, scheme.gz, dt,
                         n_steps)
    keys = (("x", "y", "u", "v", "wz", "fx", "fy", "torz") if dim == 2 else
            ("x", "y", "z", "u", "v", "w", "wx", "wy", "wz", "fx", "fy",
             "fz", "torx", "tory", "torz"))
    for k in keys:
        np.testing.assert_allclose(out[k], s[k].numpy(), atol=1e-10,
                                   err_msg=k)
    rows = slice(None) if dim == 2 else slice(g.start, g.stop)
    m_p = _table_map(*(s[k].numpy()[rows] for k in (
        "tng_idx", "tng_idx_dem_id", "tng_x", "tng_y", "tng_z")))
    m_n = _table_map(out["tng_idx"][rows], out["tng_dem"][rows],
                     *(t[rows] for t in out["tng"]))
    assert sum(len(a) for a in m_p) > 0
    for r, (a, b) in enumerate(zip(m_p, m_n)):
        assert a.keys() == b.keys(), f"row {r} contact sets differ"
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=1e-10,
                                       err_msg=f"row {r} pair {k}")


def test_native_gtvf_trajectory_matches_port():
    dx = 0.05
    xb, yb = get_2d_block(dx, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.2 + 0.6 * dx])
    y = np.concatenate([yb, yb])
    bid = np.concatenate([np.zeros(len(xb), np.int32),
                          np.ones(len(xb), np.int32)])
    xw = np.arange(-10, 20) * dx
    yw = np.full(len(xw), yb.min() - 0.7 * dx)
    body = make_group("body", x, y, m=2000 * dx * dx, h=1.3 * dx,
                      rho=2000.0, rad_s=dx / 2, role=ROLE_RIGID,
                      body_id=bid, dem_id=bid)
    wall = make_group("wall", xw, yw, m=2000 * dx * dx, h=1.3 * dx,
                      rho=2000.0, rad_s=dx / 2, role=ROLE_BOUNDARY,
                      dem_id=2)
    scene = build_scene([body, wall], dim=2, total_no_bodies=3,
                        spacing0=dx, device=torch.device("cpu"),
                        dtype=torch.float64)
    scheme = RigidBody2DScheme(rigid_bodies=["body"], boundaries=["wall"],
                               gy=-9.81, dim=2)
    scene = scheme.setup(scene)
    scene = scheme.set_linear_velocity(
        scene, np.array([[0.3, 0.0, 0.0], [-0.3, 0.0, 0.0]]))

    dt, n_steps = 1e-4, 150
    native = gtvf_step_n(scheme.export_scene(scene), kr=scheme.kr,
                         kf=scheme.kf, fric_coeff=scheme.fric_coeff, gx=0.0,
                         gy=-9.81, gz=0.0, dt=dt, n_steps=n_steps,
                         two_d=True)

    step = scheme.make_step(scene)
    s = scene
    for _ in range(n_steps):
        s = step(s, dt)
    assert not bool(s.nbr_overflow)
    # the cubes met: the contact did work along the way
    assert float(scheme.export_scene(s).overlap.max()) > 0

    np.testing.assert_allclose(native["xcm"], s.xcm.numpy(), atol=1e-8)
    np.testing.assert_allclose(native["vcm"], s.vcm.numpy(), atol=1e-7)
    np.testing.assert_allclose(native["omega"], s.omega.numpy(), atol=1e-6)
    np.testing.assert_allclose(native["x"], s.x.numpy(), atol=1e-8)
    np.testing.assert_allclose(native["y"], s.y.numpy(), atol=1e-8)
    np.testing.assert_allclose(native["u"], s.u.numpy(), atol=1e-7)
    np.testing.assert_allclose(native["force"], s.force.numpy(),
                               rtol=1e-8, atol=1e-6)
