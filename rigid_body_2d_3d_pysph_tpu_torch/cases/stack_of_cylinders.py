"""Zhang et al.'s stack-of-cylinders collapse, the experimental
validation case.

Counterpart of ``cases/stack_of_cylinders.py``: 33 cylinders (rows of
6 and 5 alternating) of diameter 1 cm at 1 mm spacing behind a dam wall;
the retaining wall is moved +0.25 m in x at t = 0.2 s (a scheduled
event); the system's centre of mass is compared with the digitised
experimental curves ``cases/data/x_com_zhang.csv`` and
``y_com_zhang.csv``.  Restitution 0.6, dt = 5e-5, tf = 0.5 + 0.2.
"""

import os

import numpy as np
import torch

from . import DATA_DIR
from ..app import output as out_mod
from ..app.application import Application
from ..app.boundary_utils import identify_template
from ..geom import create_circle_1, get_2d_block, hydrostatic_tank_2d
from ..models.base import SchemeChooser
from ..models.rigid_body import RigidBody3DScheme
from ..state import ROLE_BOUNDARY, ROLE_RIGID, build_scene, make_group


class ZhangStackOfCylinders(Application):
    def initialize(self):
        self.dim = 2
        spacing = 1.0
        self.dam_length = 26e-2
        self.dam_height = 26e-2
        self.dam_spacing = spacing * 1e-3
        self.dam_layers = 5
        self.dam_rho = 2000.0
        self.cylinder_radius = 0.5e-2
        self.cylinder_diameter = 1e-2
        self.cylinder_spacing = spacing * 1e-3
        self.cylinder_rho = 2700.0
        self.wall_height = 20e-2
        self.wall_spacing = spacing * 1e-3
        self.wall_layers = 2
        self.wall_time = 0.2
        self.wall_rho = 2700.0
        self.hdx = 1.0
        self.gy = -9.81
        self.h = self.hdx * self.cylinder_spacing
        self.tf = 0.5 + self.wall_time
        self.dt = 5e-5

    def create_cylinders_stack(self):
        """Rows of 6 and 5 cylinders, three of each: 6-rows pitched
        d + s/4, 5-rows pitched d + s/2, offset 0.78 d up and s/2 left;
        each row shifted to clear the previous row's top by one spacing."""
        d, s, r = (self.cylinder_diameter, self.cylinder_spacing,
                   self.cylinder_radius)
        xc6, yc6 = create_circle_1(d, s, [r, r + s / 2.0])
        xc5, yc5 = create_circle_1(d, s, [2.0 * r, r + 3.0 * s])
        n_per = len(xc6)

        x_six = np.concatenate([xc6 + i * (d + s / 4.0) for i in range(6)])
        y_six = np.tile(yc6, 6)
        x_five = np.concatenate(
            [xc5 + i * (d + s / 2.0) for i in range(5)]) - s / 2.0
        y_five = np.tile(yc5, 5) + 0.78 * d

        y_six_2 = y_six + (y_five.max() - y_six.min() + s)
        y_five_2 = y_five + (y_six_2.max() - y_five.min() + s)
        y_six_3 = y_six_2 + (y_five_2.max() - y_six_2.min() + s)
        y_five_3 = y_five_2 + (y_six_3.max() - y_five_2.min() + s)

        x = np.concatenate([x_six, x_five, x_six, x_five, x_six, x_five])
        y = np.concatenate([y_six, y_five, y_six_2, y_five_2, y_six_3,
                            y_five_3])
        n_bodies = 3 * 6 + 3 * 5
        bid = np.concatenate([
            np.full(n_per, i, np.int32) for i in range(n_bodies)])
        return x, y, bid, n_per

    def create_particles(self):
        s = self.cylinder_spacing
        xc, yc, body_id, n_per = self.create_cylinders_stack()
        m = self.cylinder_rho * s**2
        n_bodies = int(body_id.max()) + 1  # 33

        cylinders = make_group(
            "cylinders", xc, yc, m=m, h=self.h, rho=self.cylinder_rho,
            rad_s=s / 2.0, role=ROLE_RIGID, body_id=body_id, dem_id=body_id,
            constants={"E": 69e9, "poisson_ratio": 0.3},
        )

        # the dam (tank walls), aligned to the cylinders; the full tank
        # lattice, as the reference case builds it
        _, _, xd, yd = hydrostatic_tank_2d(
            self.dam_length, self.dam_height, self.dam_height,
            self.dam_layers, s, s)
        xd += xc.min() - xd.min() - self.dam_spacing * self.dam_layers
        yd += yc.min() - yd.min() - self.dam_spacing * self.dam_layers
        dam = make_group(
            "dam", xd, yd, m=m, h=self.h, rho=self.cylinder_rho,
            rad_s=self.dam_spacing / 2.0, role=ROLE_BOUNDARY,
            dem_id=n_bodies, constants={"E": 30e8, "poisson_ratio": 0.3},
        )

        # the removable wall right of the stack
        xw, yw = get_2d_block(self.wall_spacing, self.cylinder_spacing / 2.0,
                              self.wall_height / 4.0)
        xw += xc.max() - xw.min() + self.cylinder_spacing
        yw += yd.min() - yw.min()
        wall = make_group(
            "wall", xw, yw, m=m, h=self.h, rho=self.cylinder_rho,
            rad_s=self.cylinder_spacing / 2.0, role=ROLE_BOUNDARY,
            dem_id=n_bodies + 1, constants={"E": 30e8, "poisson_ratio": 0.3},
        )

        scene = build_scene([cylinders, dam, wall], dim=self.dim,
                            total_no_bodies=n_bodies + 2, spacing0=s,
                            device=self.device, dtype=self.dtype)
        coeff = np.full((n_bodies, n_bodies + 2), 0.6)
        scene = self.scheme.scheme.setup(scene, coeff_of_rest=coeff)

        # per-cylinder surface flags from one standalone cylinder; every
        # wall particle is a contact surface
        isb_tpl = identify_template(
            xc[:n_per], yc[:n_per], m=m, h=self.h, rho=self.cylinder_rho,
            dim=self.dim)
        host = lambda k: scene[k].detach().cpu().numpy().copy()
        full_isb = host("is_boundary")
        cfib = host("contact_force_is_boundary")
        g = scene.meta.group("cylinders")
        full_isb[g.start:g.stop] = np.tile(isb_tpl, n_bodies)
        cfib[g.start:g.stop] = np.tile(isb_tpl, n_bodies)
        gw = scene.meta.group("wall")
        cfib[gw.start:gw.stop] = 1.0
        scene = scene.replace(
            is_boundary=torch.as_tensor(full_isb, dtype=torch.int32,
                                        device=scene.device),
            contact_force_is_boundary=torch.as_tensor(
                cfib, dtype=scene.dtype, device=scene.device))

        def yank_wall(scene):
            gw = scene.meta.group("wall")
            x = scene.x.clone()
            x[gw.start:gw.stop] += 0.25
            return scene.replace(x=x)

        self.add_event(self.wall_time, yank_wall)
        return scene

    def create_scheme(self):
        rb3d = RigidBody3DScheme(
            rigid_bodies=["cylinders"], boundaries=["dam", "wall"],
            gx=0.0, gy=self.gy, gz=0.0, dim=2, fric_coeff=0.45)
        return SchemeChooser(default="rb3d", rb3d=rb3d)

    def configure_scheme(self):
        self.scheme.configure_solver(dt=self.dt, tf=self.tf, pfreq=100)

    def post_process(self, fname=None):
        # every snapshot in the directory (a resumed run's too)
        files = out_mod.get_files(self.output_dir)
        if not files:
            return None
        t, sx, sy = [], [], []
        for sd, arr in out_mod.iter_output(files, "cylinders"):
            t.append(float(sd["t"]))
            xcm = arr.xcm_mat
            sx.append(xcm[:, 0].mean() / self.dam_length)
            sy.append(xcm[:, 1].mean() / self.dam_length)
        t = np.asarray(t) - self.wall_time
        res = dict(t=t, x_com=np.asarray(sx), y_com=np.asarray(sy))
        zx = np.loadtxt(os.path.join(DATA_DIR, "x_com_zhang.csv"),
                        delimiter=",")
        zy = np.loadtxt(os.path.join(DATA_DIR, "y_com_zhang.csv"),
                        delimiter=",")
        res["zhang_t_x"], res["zhang_x"] = zx[:, 0], zx[:, 1]
        res["zhang_t_y"], res["zhang_y"] = zy[:, 0], zy[:, 1]
        np.savez(os.path.join(self.output_dir, "results.npz"), **res)
        return res


if __name__ == "__main__":
    app = ZhangStackOfCylinders(fname="stack_of_cylinders")
    app.run()
    app.post_process(app.info_filename)
