"""Benchmark 2: two rigid cubes colliding head-on, no gravity.

Counterpart of ``cases/benchmark_2_multiple_rigid_bodies_colliding.py``:
two 0.2 x 0.2 blocks at dx = 0.025 (81 particles each) as two named
groups with dem ids 0 and 1, no boundary, approaching at +-0.5 m/s;
``RigidBody3DScheme`` on the 2D scene; dt = 0.125 * 0.05 * 1.3 /
(1.1 c0) ~ 1.67e-4, tf = 0.5.  The check: total momentum stays zero and
the cubes rebound.
"""

import numpy as np

from ..app.application import Application
from ..geom import get_2d_block
from ..models.base import SchemeChooser
from ..models.rigid_body import RigidBody3DScheme
from ..state import ROLE_RIGID, build_scene, make_group


class Benchmark2(Application):
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
        xb, yb = get_2d_block(dx, self.body_length, self.body_height)
        m = self.body_density * dx**self.dim

        def grp(name, xoff, dem):
            return make_group(
                name, xb + xoff, yb, m=m, h=self.body_h,
                rho=self.body_density, rad_s=dx / 2.0, role=ROLE_RIGID,
                body_id=np.zeros(len(xb), np.int32),
                dem_id=np.full(len(xb), dem, np.int32),
                constants={"E": 69e9, "poisson_ratio": 0.3},
            )

        scene = build_scene(
            [grp("body1", 0.0, 0), grp("body2", 2.0 * self.body_length, 1)],
            dim=self.dim, total_no_bodies=2, spacing0=dx,
            device=self.device, dtype=self.dtype,
        )
        scheme = self.scheme.scheme
        scene = scheme.setup(scene)
        return scheme.set_linear_velocity(
            scene, np.array([[0.5, 0.0, 0.0], [-0.5, 0.0, 0.0]]))

    def create_scheme(self):
        rb3d = RigidBody3DScheme(rigid_bodies=["body1", "body2"],
                                 boundaries=None, dim=self.dim)
        return SchemeChooser(default="rb3d", rb3d=rb3d)

    def configure_scheme(self):
        dt = 0.125 * 0.05 * self.hdx / (self.co * 1.1)
        self.scheme.configure_solver(dt=dt, tf=0.5, pfreq=100)


if __name__ == "__main__":
    app = Benchmark2(fname="benchmark_2")
    app.run()
