"""Two cylinders dropped on a thin dam floor through the coupling scheme
with no fluid.

Counterpart of ``cases/stack_of_cylinders_test_1.py``: cylinders of
diameter 1 cm at 1 mm spacing in one group (body and dem ids 0 and 1),
a 6 d x 2 s dam floor below them (dem id 2), run by
``RigidFluidCouplingScheme`` with ``fluids=[]``: its kdkf ordering runs
the kdk step with the contact pack alone (K1, then K2 on every slot),
the no-fluid route.  The cylinders' surface flags come from one
standalone cylinder; dt = 5e-5, tf = 0.1.
"""

import numpy as np

from ..app.application import Application
from ..app.boundary_utils import identify_template
from ..geom import create_circle_1, get_2d_block
from ..models.base import SchemeChooser
from ..models.rigid_fluid_coupling import RigidFluidCouplingScheme
from ..state import ROLE_BOUNDARY, ROLE_RIGID, build_scene, make_group
from .benchmark_5_steady_cubes_on_a_wall_2d import tile_body_flags


class StackOfCylindersTest1(Application):
    def initialize(self):
        self.dim = 2
        self.cylinder_radius = 0.5e-2
        self.cylinder_diameter = 1e-2
        self.cylinder_spacing = 1e-3
        self.cylinder_rho = 2700.0
        self.hdx = 1.0
        self.gy = -9.81
        self.h = self.hdx * self.cylinder_spacing
        self.dt = 5e-5
        self.tf = 0.1

    def create_particles(self):
        s = self.cylinder_spacing
        d, r = self.cylinder_diameter, self.cylinder_radius
        xc1, yc1 = create_circle_1(d, s, [r, r + s / 2.0])
        xc2 = xc1 + 1.5 * d
        n_per = len(xc1)
        x = np.concatenate([xc1, xc2])
        y = np.concatenate([yc1, yc1]) + 2.0 * d
        bid = np.concatenate([np.zeros(n_per, np.int32),
                              np.ones(n_per, np.int32)])
        m = self.cylinder_rho * s**2

        cylinders = make_group(
            "cylinders", x, y, m=m, h=self.h, rho=self.cylinder_rho,
            rad_s=s / 2.0, role=ROLE_RIGID, body_id=bid, dem_id=bid,
            constants={"E": 69e9, "poisson_ratio": 0.3},
        )
        # thin dam floor
        xd, yd = get_2d_block(s, 6.0 * d, 2.0 * s)
        xd += x.mean() - xd.mean()
        yd -= yd.max() + s
        dam = make_group(
            "dam", xd, yd, m=m, h=self.h, rho=self.cylinder_rho,
            rad_s=s / 2.0, role=ROLE_BOUNDARY, dem_id=2,
            constants={"E": 30e8, "poisson_ratio": 0.3},
        )
        scene = build_scene([cylinders, dam], dim=self.dim,
                            total_no_bodies=3, spacing0=s,
                            device=self.device, dtype=self.dtype)
        scene = self.scheme.scheme.setup(scene)

        # per-cylinder surface flags from one standalone cylinder
        isb_tpl = identify_template(xc1, yc1, m=m, h=self.h,
                                    rho=self.cylinder_rho, dim=self.dim)
        return tile_body_flags(scene, "cylinders", isb_tpl, 2)

    def create_scheme(self):
        rfc = RigidFluidCouplingScheme(
            rigid_bodies=["cylinders"], fluids=[], boundaries=["dam"],
            dim=2, rho0=1000.0, p0=1e5, c0=10.0, gy=self.gy, nu=0.0,
            h=self.h)
        return SchemeChooser(default="rfc", rfc=rfc)

    def configure_scheme(self):
        self.scheme.configure_solver(dt=self.dt, tf=self.tf, pfreq=100)


if __name__ == "__main__":
    app = StackOfCylindersTest1(fname="stack_of_cylinders_test_1")
    app.run()
