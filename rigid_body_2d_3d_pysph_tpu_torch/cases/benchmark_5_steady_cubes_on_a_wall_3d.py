"""Benchmark 5 (3D): stacks of cubes resting on a 3D tank floor.

Counterpart of ``cases/benchmark_5_steady_cubes_on_a_wall_3d.py``: 0.2 m
cubes at dx = 0.05 (125 particles each), ``--one-cube`` /
``--two-cubes`` / ``--three-cubes`` / ``--pyramid-cubes``, the 3D tank of
``get_fluid_tank_3d``, surface flags from one standalone cube, dt =
1e-4, tf = 0.5.
"""

import numpy as np

from ..app.application import Application
from ..app.boundary_utils import identify_template
from ..geom import get_3d_block, get_fluid_tank_3d
from ..models.base import SchemeChooser
from ..models.rigid_body import RigidBody3DScheme
from ..state import ROLE_BOUNDARY, ROLE_RIGID, build_scene, make_group
from .benchmark_5_steady_cubes_on_a_wall_2d import tile_body_flags


class Benchmark5_3D(Application):
    def initialize(self):
        spacing = 0.05
        self.hdx = 1.0
        self.fluid_length = 1.0
        self.fluid_height = 1.0
        self.fluid_depth = 1.0
        self.tank_length = 2.0
        self.tank_height = 1.5
        self.tank_layers = 5
        self.body_length = 0.2
        self.body_height = 0.2
        self.body_depth = 0.2
        self.body_density = 2000.0
        self.body_spacing = spacing
        self.body_h = self.hdx * self.body_spacing
        self.gy = -9.81
        self.dim = 3
        self.n_cubes = 1

    def add_user_options(self, group):
        group.add_argument("--one-cube", action="store_true")
        group.add_argument("--two-cubes", action="store_true")
        group.add_argument("--three-cubes", action="store_true")
        group.add_argument("--pyramid-cubes", action="store_true")

    def consume_user_options(self):
        o = self.options
        if o.two_cubes:
            self.n_cubes = 2
        elif o.three_cubes:
            self.n_cubes = 3
        elif o.pyramid_cubes:
            self.n_cubes = 6
        else:
            self.n_cubes = 1

    def _cube(self):
        return get_3d_block(self.body_spacing, self.body_length,
                            self.body_height, self.body_depth)

    def build_stack(self):
        if self.n_cubes in (1, 2, 3):
            blocks = []
            ytop = None
            for _ in range(self.n_cubes):
                xb, yb, zb = self._cube()
                if ytop is not None:
                    yb = yb + (ytop - yb.min() + self.body_spacing)
                ytop = yb.max()
                blocks.append((xb, yb, zb))
        else:  # pyramid: 3 bottom, 2 middle, 1 top
            L, s = self.body_length, self.body_spacing
            blocks = []
            for i in range(3):
                xb, yb, zb = self._cube()
                blocks.append((xb + i * (L + L / 3.0), yb, zb))
            ytop = blocks[0][1].max()
            for i in range(2):
                xb, yb, zb = self._cube()
                blocks.append((xb + (L - L / 3.0) + i * (L + L / 3.0),
                               yb + (ytop - yb.min() + s), zb))
            ytop2 = blocks[3][1].max()
            xb, yb, zb = self._cube()
            blocks.append((xb + 2 * (L - L / 3.0) + L / 3.0,
                           yb + (ytop2 - yb.min() + s), zb))
        xb = np.concatenate([b[0] for b in blocks])
        yb = np.concatenate([b[1] for b in blocks])
        zb = np.concatenate([b[2] for b in blocks])
        bid = np.concatenate([
            np.full(len(b[0]), i, np.int32) for i, b in enumerate(blocks)])
        return xb, yb, zb, bid

    def create_particles(self):
        dx = self.body_spacing
        _, _, _, xt, yt, zt = get_fluid_tank_3d(
            self.fluid_length, self.fluid_height, self.fluid_depth,
            self.tank_length, self.tank_height, self.tank_layers, dx, dx)
        xb, yb, zb, body_id = self.build_stack()
        yb = yb + self.body_height * 2.0
        yb -= yb.min() - yt.min()
        yb += self.tank_layers * dx
        m = self.body_density * dx**self.dim
        n_bodies = int(body_id.max()) + 1

        body = make_group(
            "body", xb, yb, zb, m=m, h=self.body_h, rho=self.body_density,
            rad_s=dx / 2.0, role=ROLE_RIGID, body_id=body_id,
            dem_id=body_id, constants={"E": 69e9, "poisson_ratio": 0.3},
        )
        tank = make_group(
            "tank", xt, yt, zt, m=m, h=self.body_h, rho=self.body_density,
            rad_s=dx / 2.0, role=ROLE_BOUNDARY, dem_id=n_bodies,
            constants={"E": 69e9, "poisson_ratio": 0.3},
        )
        scene = build_scene([body, tank], dim=self.dim,
                            total_no_bodies=n_bodies + 1, spacing0=dx,
                            device=self.device, dtype=self.dtype)
        scene = self.scheme.scheme.setup(scene)

        xtpl, ytpl, ztpl = self._cube()
        isb_tpl = identify_template(xtpl, ytpl, ztpl, m=m, h=self.body_h,
                                    rho=self.body_density, dim=self.dim)
        return tile_body_flags(scene, "body", isb_tpl, n_bodies)

    def create_scheme(self):
        rb3d = RigidBody3DScheme(rigid_bodies=["body"], boundaries=["tank"],
                                 gx=0.0, gy=self.gy, gz=0.0, dim=self.dim)
        return SchemeChooser(default="rb3d", rb3d=rb3d)

    def configure_scheme(self):
        self.scheme.configure_solver(dt=1e-4, tf=0.5, pfreq=100)


if __name__ == "__main__":
    app = Benchmark5_3D(fname="benchmark_5_3d")
    app.run()
