"""Benchmark 5 (2D): stacks of cubes resting on a tank wall, the
persistent-contact and static-friction stability regression.

Counterpart of ``cases/benchmark_5_steady_cubes_on_a_wall_2d.py``: the
cube stacks ``--two-cubes`` / ``--three-cubes`` / ``--pyramid-cubes``, a
tank of 5 layers, and the surface flags of the bodies identified on one
standalone cube and tiled per body (identifying the whole stack at once
reads the touching faces as interior).  dt = 1e-4, tf = 0.5.
"""

import numpy as np
import torch

from ..app.application import Application
from ..app.boundary_utils import identify_template
from ..geom import get_2d_block, hydrostatic_tank_2d
from ..models.base import SchemeChooser
from ..models.rigid_body import RigidBody2DScheme, RigidBody3DScheme
from ..state import ROLE_BOUNDARY, ROLE_RIGID, build_scene, make_group


def tile_body_flags(scene, group: str, isb_tpl, n_bodies: int):
    """The scene with the template's surface flags tiled over the bodies
    of ``group`` (``is_boundary`` and ``contact_force_is_boundary``)."""
    g = scene.meta.group(group)
    full = scene.is_boundary.detach().cpu().numpy().copy()
    full[g.start:g.stop] = np.tile(isb_tpl, n_bodies)
    return scene.replace(
        is_boundary=torch.as_tensor(full, dtype=torch.int32,
                                    device=scene.device),
        contact_force_is_boundary=torch.as_tensor(
            full, dtype=scene.dtype, device=scene.device))


class Benchmark5_2D(Application):
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
        self.use_two_cubes = False
        self.use_three_cubes = False
        self.use_pyramid_cubes = False

    def add_user_options(self, group):
        group.add_argument("--two-cubes", action="store_true",
                           dest="use_two_cubes")
        group.add_argument("--three-cubes", action="store_true",
                           dest="use_three_cubes")
        group.add_argument("--pyramid-cubes", action="store_true",
                           dest="use_pyramid_cubes")

    def consume_user_options(self):
        for k in ("use_two_cubes", "use_three_cubes", "use_pyramid_cubes"):
            setattr(self, k, getattr(self.options, k))

    # -- the stacks --------------------------------------------------------
    def _block(self):
        return get_2d_block(self.body_spacing, self.body_length,
                            self.body_height)

    def create_two_cubes(self):
        xb1, yb1 = self._block()
        xb2, yb2 = self._block()
        yb2 += yb1.max() - yb2.min() + self.body_spacing
        return self._cat([(xb1, yb1), (xb2, yb2)])

    def create_three_cubes(self):
        blocks = []
        ytop = None
        for _ in range(3):
            xb, yb = self._block()
            if ytop is not None:
                yb += ytop - yb.min() + self.body_spacing
            ytop = yb.max()
            blocks.append((xb, yb))
        return self._cat(blocks)

    def create_pyramid_cubes(self):
        L, s = self.body_length, self.body_spacing
        b = [self._block() for _ in range(6)]
        x = [bb[0].copy() for bb in b]
        y = [bb[1].copy() for bb in b]
        x[0] -= L
        x[1] += x[0].max() - x[1].min() + L / 3.0
        x[2] += x[1].max() - x[2].min() + L / 3.0
        x[3] += x[0].min() - x[3].min() + (L - L / 3.0)
        y[3] += y[0].max() - y[3].min() + s
        y[4] += y[3].max() - y[4].max()
        x[4] += x[2].max() - x[4].max() - (L - L / 3.0)
        y[5] += y[3].max() - y[5].min() + s
        x[5] += x[3].max() - x[5].max()
        x[5] += (x[4].max() - x[3].min()) / 2.0 - L / 2.0
        return self._cat(list(zip(x, y)))

    def _cat(self, blocks):
        xb = np.concatenate([b[0] for b in blocks])
        yb = np.concatenate([b[1] for b in blocks])
        bid = np.concatenate([
            np.full(len(b[0]), i, np.int32) for i, b in enumerate(blocks)])
        return xb, yb, bid, bid.copy()

    def create_particles(self):
        dx = self.body_spacing
        _, _, xt, yt = hydrostatic_tank_2d(
            self.fluid_length, self.fluid_height, self.tank_height,
            self.tank_layers, dx, dx)
        if self.use_two_cubes:
            xb, yb, body_id, dem_id = self.create_two_cubes()
        elif self.use_three_cubes:
            xb, yb, body_id, dem_id = self.create_three_cubes()
        elif self.use_pyramid_cubes:
            xb, yb, body_id, dem_id = self.create_pyramid_cubes()
        else:
            raise SystemExit(
                "choose a configuration: --two-cubes | --three-cubes | "
                "--pyramid-cubes")
        yb += self.body_height * 2.0
        m = self.body_density * dx**self.dim
        n_bodies = int(body_id.max()) + 1

        # rest the stack on top of the tank floor
        yb -= yb.min() - yt.min()
        yb += self.tank_layers * dx

        body = make_group(
            "body", xb, yb, m=m, h=self.body_h, rho=self.body_density,
            rad_s=dx / 2.0, role=ROLE_RIGID, body_id=body_id,
            dem_id=dem_id, constants={"E": 69e9, "poisson_ratio": 0.3},
        )
        tank = make_group(
            "tank", xt, yt, m=m, h=self.body_h, rho=self.body_density,
            rad_s=dx / 2.0, role=ROLE_BOUNDARY, dem_id=n_bodies,
            constants={"E": 69e9, "poisson_ratio": 0.3},
        )
        scene = build_scene([body, tank], dim=self.dim,
                            total_no_bodies=n_bodies + 1, spacing0=dx,
                            device=self.device, dtype=self.dtype)
        scene = self.scheme.scheme.setup(scene)

        # per-body surface flags from one standalone cube
        xtpl, ytpl = self._block()
        isb_tpl = identify_template(
            xtpl, ytpl, m=m, h=self.body_h, rho=self.body_density,
            dim=self.dim)
        return tile_body_flags(scene, "body", isb_tpl, n_bodies)

    def create_scheme(self):
        kw = dict(rigid_bodies=["body"], boundaries=["tank"], gx=0.0,
                  gy=self.gy, gz=0.0, dim=2)
        return SchemeChooser(default="rb2d",
                             rb3d=RigidBody3DScheme(**kw),
                             rb2d=RigidBody2DScheme(**kw))

    def configure_scheme(self):
        self.scheme.configure_solver(dt=1e-4, tf=0.5, pfreq=100)


if __name__ == "__main__":
    app = Benchmark5_2D(fname="benchmark_5_2d")
    app.run()
