"""Benchmark 2b: the head-on collision of two cubes held in one
particle group.

Counterpart of
``cases/benchmark_2_multiple_rigid_bodies_colliding_same_particle_array.py``:
benchmark 2's cubes in ONE group with body and dem ids 0 and 1,
total_no_bodies = 2, +-0.5 m/s; ``RigidBody3DScheme`` on the 2D scene;
the same dt and tf.
"""

import numpy as np

from ..app.application import Application
from ..geom import get_2d_block
from ..models.base import SchemeChooser
from ..models.rigid_body import RigidBody3DScheme
from ..state import ROLE_RIGID, build_scene, make_group


class Benchmark2SameArray(Application):
    def initialize(self):
        spacing = 0.05
        self.hdx = 1.3
        self.body_length = 0.2
        self.body_height = 0.2
        self.body_density = 2000.0
        self.body_spacing = spacing / 2.0
        self.body_h = self.hdx * self.body_spacing
        self.co = 10 * np.sqrt(2 * 9.81 * 1.0)
        self.dim = 2

    def create_particles(self):
        dx = self.body_spacing
        xb1, yb1 = get_2d_block(dx, self.body_length, self.body_height)
        xb = np.concatenate([xb1, xb1 + 2.0 * self.body_length])
        yb = np.concatenate([yb1, yb1])
        bid = np.concatenate([np.zeros(len(xb1), np.int32),
                              np.ones(len(xb1), np.int32)])
        m = self.body_density * dx**self.dim
        body = make_group(
            "body", xb, yb, m=m, h=self.body_h, rho=self.body_density,
            rad_s=dx / 2.0, role=ROLE_RIGID, body_id=bid, dem_id=bid,
            constants={"E": 69e9, "poisson_ratio": 0.3},
        )
        scene = build_scene([body], dim=self.dim, total_no_bodies=2,
                            spacing0=dx, device=self.device,
                            dtype=self.dtype)
        scheme = self.scheme.scheme
        scene = scheme.setup(scene)
        return scheme.set_linear_velocity(
            scene, np.array([[0.5, 0.0, 0.0], [-0.5, 0.0, 0.0]]))

    def create_scheme(self):
        rb3d = RigidBody3DScheme(rigid_bodies=["body"], boundaries=None,
                                 dim=self.dim)
        return SchemeChooser(default="rb3d", rb3d=rb3d)

    def configure_scheme(self):
        dt = 0.125 * 0.05 * self.hdx / (self.co * 1.1)
        self.scheme.configure_solver(dt=dt, tf=0.5, pfreq=100)


if __name__ == "__main__":
    app = Benchmark2SameArray(fname="benchmark_2_same_array")
    app.run()
