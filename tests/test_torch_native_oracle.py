"""The port against the independent C++ engine (``csrc/rbnative.cpp``).

150 GTVF steps of the port's 2D rigid scheme in float64 on CPU tensors
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

from rigid_body_2d_3d_pysph_tpu.native import gtvf_step_n

from rigid_body_2d_3d_pysph_tpu_torch.geom import get_2d_block
from rigid_body_2d_3d_pysph_tpu_torch.models import RigidBody2DScheme
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    ROLE_BOUNDARY, ROLE_RIGID, build_scene, make_group)


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
