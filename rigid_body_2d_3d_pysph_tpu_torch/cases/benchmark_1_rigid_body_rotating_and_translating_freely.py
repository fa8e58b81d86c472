"""Benchmark 1: a cube translating and rotating freely, no gravity.

Counterpart of
``cases/benchmark_1_rigid_body_rotating_and_translating_freely.py``:
an 11 x 11-particle 1 m cube at dx = 0.1, rho = 10, one body with no
boundary, initial v = (0.5, 0.5, 0) and omega = (0, 0, 1); dt = 1e-3,
tf = 10, pfreq = 100.  The integrator's check: kinetic energy conserved
and the COM on the line x = y = 0.5 t.  ``rb2d`` (default) or ``rb3d``
through the ``SchemeChooser``.
"""

import os

import numpy as np

from ..app import output as out_mod
from ..app.application import Application
from ..geom import get_2d_block
from ..models.base import SchemeChooser
from ..models.rigid_body import RigidBody2DScheme, RigidBody3DScheme
from ..state import ROLE_RIGID, build_scene, make_group


class Case0(Application):
    def initialize(self):
        self.rho0 = 10.0
        self.hdx = 1.0
        self.dx = 0.1
        self.dim = 2
        self.dt = 1e-3
        self.tf = 10.0

    def create_particles(self):
        dx = self.dx
        x, y = get_2d_block(dx, 1.0, 1.0)
        m = np.full(len(x), dx * dx * self.rho0)
        body = make_group(
            "body", x, y, m=m, h=self.hdx * dx, rho=self.rho0, rad_s=dx,
            role=ROLE_RIGID, body_id=np.zeros(len(x), np.int32),
            dem_id=np.zeros(len(x), np.int32),
            constants={"E": 69e9, "poisson_ratio": 0.3},
        )
        scene = build_scene([body], dim=self.dim, total_no_bodies=1,
                            spacing0=dx, device=self.device,
                            dtype=self.dtype)
        scheme = self.scheme.scheme
        scene = scheme.setup(scene)
        scene = scheme.set_linear_velocity(scene, np.array([0.5, 0.5, 0.0]))
        return scheme.set_angular_velocity(scene, np.array([0.0, 0.0, 1.0]))

    def create_scheme(self):
        rb3d = RigidBody3DScheme(rigid_bodies=["body"], boundaries=None,
                                 dim=self.dim)
        rb2d = RigidBody2DScheme(rigid_bodies=["body"], boundaries=None,
                                 dim=self.dim)
        return SchemeChooser(default="rb2d", rb3d=rb3d, rb2d=rb2d)

    def configure_scheme(self):
        self.scheme.configure_solver(dt=self.dt, tf=self.tf, pfreq=100)

    def post_process(self, fname=None):
        # every snapshot in the directory (a resumed run's too)
        files = out_mod.get_files(self.output_dir)
        if not files:
            return None
        t, total_energy, xs, ys = [], [], [], []
        for sd, body in out_mod.iter_output(files, "body"):
            t.append(float(sd["t"]))
            total_energy.append(
                0.5 * np.sum(body.m * (body.u**2 + body.v**2)))
            xs.append(body.xcm[0])
            ys.append(body.xcm[1])
        res = dict(t=np.asarray(t), total_energy=np.asarray(total_energy),
                   x=np.asarray(xs), y=np.asarray(ys))
        np.savez(os.path.join(self.output_dir, "results.npz"), **res)
        return res


if __name__ == "__main__":
    app = Case0(fname="benchmark_1")
    app.run()
    app.post_process(app.info_filename)
