"""Benchmark 3: two cubes in one particle group falling under gravity
into a 5-layer tank.

Counterpart of
``cases/benchmark_3_multiple_rigid_bodies_colliding_same_particle_array.py``:
0.2 x 0.2 blocks at dx = 0.025 with body and dem ids 0 and 1, the tank
of ``hydrostatic_tank_2d`` with dem id 2, total_no_bodies = 3,
gy = -9.81; dt = 1e-4, tf = 1.  The check: the cubes stay inside the
tank with bounded speeds.
"""

import numpy as np

from ..app.application import Application
from ..geom import get_2d_block, hydrostatic_tank_2d
from ..models.base import SchemeChooser
from ..models.rigid_body import RigidBody2DScheme, RigidBody3DScheme
from ..state import ROLE_BOUNDARY, ROLE_RIGID, build_scene, make_group


class Benchmark3(Application):
    def initialize(self):
        spacing = 0.05
        self.hdx = 1.3
        self.fluid_length = 1.0
        self.fluid_height = 1.0
        self.tank_height = 1.5
        self.tank_layers = 5
        self.body_length = 0.2
        self.body_height = 0.2
        self.body_density = 2000.0
        self.body_spacing = spacing / 2.0
        self.body_h = self.hdx * self.body_spacing
        self.gy = -9.81
        self.dim = 2
        self.dt = 1e-4
        self.tf = 1.0

    def make_body_and_tank(self):
        dx = self.body_spacing
        _, _, xt, yt = hydrostatic_tank_2d(
            self.fluid_length, self.fluid_height, self.tank_height,
            self.tank_layers, dx, dx)
        xb1, yb1 = get_2d_block(dx, self.body_length, self.body_height)
        xb2 = xb1 + self.body_length * 2
        xb = np.concatenate([xb1, xb2]) - self.body_length / 2.0
        yb = np.concatenate([yb1, yb1]) + self.body_height * 2.0
        body_id = np.concatenate([
            np.zeros(len(xb1), np.int32), np.ones(len(xb1), np.int32)])
        return xb, yb, body_id, xt, yt

    def make_scene(self):
        """The cubes and the tank, before the scheme's set-up."""
        dx = self.body_spacing
        xb, yb, body_id, xt, yt = self.make_body_and_tank()
        m = self.body_density * dx**self.dim
        body = make_group(
            "body", xb, yb, m=m, h=self.body_h, rho=self.body_density,
            rad_s=dx / 2.0, role=ROLE_RIGID, body_id=body_id,
            dem_id=body_id, constants={"E": 69e9, "poisson_ratio": 0.3},
        )
        tank = make_group(
            "tank", xt, yt, m=m, h=self.body_h, rho=self.body_density,
            rad_s=dx / 2.0, role=ROLE_BOUNDARY, dem_id=2,
            constants={"E": 69e9, "poisson_ratio": 0.3},
        )
        return build_scene([body, tank], dim=self.dim, total_no_bodies=3,
                           spacing0=dx, device=self.device, dtype=self.dtype)

    def create_particles(self):
        return self.scheme.scheme.setup(self.make_scene())

    def create_scheme(self):
        kw = dict(rigid_bodies=["body"], boundaries=["tank"], gx=0.0,
                  gy=self.gy, gz=0.0, dim=2)
        return SchemeChooser(default="rb2d",
                             rb3d=RigidBody3DScheme(**kw),
                             rb2d=RigidBody2DScheme(**kw))

    def configure_scheme(self):
        self.scheme.configure_solver(dt=self.dt, tf=self.tf, pfreq=100)


if __name__ == "__main__":
    app = Benchmark3(fname="benchmark_3")
    app.run()
