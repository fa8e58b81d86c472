"""Sun 2015 section 3.1.2: a rigid box (rho 2) rotating and sinking in a
tank of viscous liquid (rho 1), the free-surface FSI validation.

Counterpart of ``cases/rigid_body_rotating_and_sinking_in_tank_2d.py``:
a 4 L x 3 L fluid tank at dx = 0.02, a 1 x 0.5 box at the surface 1.5 L
from the left, the hydrostatic initial pressure, the fluid carved under
the box, the box's FSI shadow mass and density set to the displaced
fluid's, gy = -1, dt = 0.25 dx hdx / (1.1 c0), tf = 4, the fused kdkf
coupling step.
"""

import os

import numpy as np
import torch

from ..app import output as out_mod
from ..app.application import Application
from ..geom import get_2d_block, hydrostatic_tank_2d
from ..models.base import SchemeChooser
from ..models.rigid_fluid_coupling import RigidFluidCouplingScheme
from ..state import (ROLE_BOUNDARY, ROLE_FLUID, ROLE_RIGID, build_scene,
                     make_group)


class SinkingBox(Application):
    def initialize(self, spacing=0.02):
        # ``spacing`` scales the particle count; h and dt follow it
        self.hdx = 1.0
        self.L = 1.0
        self.fluid_length = 4.0 * self.L
        self.fluid_height = 3.0 * self.L
        self.fluid_density = 1.0
        self.fluid_spacing = spacing
        self.tank_height = 5.0 * self.L
        self.tank_layers = 3
        self.body_length = self.L
        self.body_height = 0.5 * self.L
        self.body_density = 2.0
        self.body_spacing = spacing
        self.body_h = self.hdx * spacing
        self.h = self.hdx * spacing
        self.co = 10 * np.sqrt(2 * 9.81 * self.fluid_height)
        self.p0 = self.fluid_density * self.co**2
        self.c0 = self.co
        self.alpha = 0.1
        self.gy = -1.0
        self.dim = 2

    def create_particles(self):
        dx = self.fluid_spacing
        xf, yf, xt, yt = hydrostatic_tank_2d(
            self.fluid_length, self.fluid_height, self.tank_height,
            self.tank_layers, dx, dx)
        m_fluid = self.fluid_density * dx**self.dim

        # hydrostatic initial pressure
        p0 = -self.fluid_density * self.gy * (yf.max() - yf)

        # the rigid box at the fluid surface
        xb, yb = get_2d_block(dx, self.body_length - dx,
                              self.body_height - dx)
        xb -= xb.min() - xf.min()
        xb += 1.5 * self.L
        yb += yf.max() - yb.min() + dx
        yb -= 0.25 * self.L + dx / 2.0

        # carve the fluid under the body
        fac = 1.0 * dx
        keep = ~(
            (xf > xb.min() - fac) & (xf < xb.max() + fac)
            & (yf > yb.min() - fac) & (yf < yb.max() + fac)
        )
        xf, yf, p0 = xf[keep], yf[keep], p0[keep]

        m_body = self.body_density * dx**self.dim

        fluid = make_group("fluid", xf, yf, m=m_fluid, h=self.h,
                           rho=self.fluid_density, role=ROLE_FLUID, p=p0)
        tank = make_group(
            "tank", xt, yt, m=m_fluid, h=self.h, rho=self.fluid_density,
            rad_s=dx / 2.0, role=ROLE_BOUNDARY, dem_id=1,
            constants={"E": 69e9, "poisson_ratio": 0.3},
        )
        body = make_group(
            "body", xb, yb, m=m_body, h=self.body_h, rho=self.body_density,
            rad_s=dx / 2.0, role=ROLE_RIGID,
            body_id=np.zeros(len(xb), np.int32),
            dem_id=np.zeros(len(xb), np.int32),
            constants={"E": 69e9, "poisson_ratio": 0.3},
        )
        scene = build_scene([fluid, tank, body], dim=self.dim,
                            total_no_bodies=2, spacing0=dx,
                            device=self.device, dtype=self.dtype)
        scene = self.scheme.scheme.setup(scene)

        # the displaced fluid's shadow mass and density on the body
        g = scene.meta.group("body")
        host = lambda k: scene[k].detach().cpu().numpy().astype(np.float64)
        m_fsi, rho_fsi = host("m_fsi"), host("rho_fsi")
        m_fsi[g.start:g.stop] += self.fluid_density * dx**self.dim
        rho_fsi[g.start:g.stop] = self.fluid_density
        t = lambda a: torch.as_tensor(a, dtype=scene.dtype,
                                      device=scene.device)
        return scene.replace(m_fsi=t(m_fsi), rho_fsi=t(rho_fsi))

    def create_scheme(self):
        rfc = RigidFluidCouplingScheme(
            rigid_bodies=["body"], fluids=["fluid"], boundaries=["tank"],
            dim=2, rho0=self.fluid_density, p0=self.p0, c0=self.c0,
            gy=self.gy, nu=0.0, h=self.h)
        return SchemeChooser(default="rfc", rfc=rfc)

    def configure_scheme(self):
        dt = 0.25 * self.fluid_spacing * self.hdx / (self.co * 1.1)
        self.scheme.configure_solver(dt=dt, tf=4.0, pfreq=100)

    def post_process(self, fname=None):
        # every snapshot in the directory (a resumed run's too)
        files = out_mod.get_files(self.output_dir)
        if not files:
            return None
        t, ymax, ycm = [], [], []
        for sd, body in out_mod.iter_output(files, "body"):
            t.append(float(sd["t"]))
            ymax.append(float(np.max(body.y)))
            ycm.append(float(body.xcm[1]))
        res = dict(t=np.asarray(t), max_y=np.asarray(ymax),
                   y_com=np.asarray(ycm))
        np.savez(os.path.join(self.output_dir, "results.npz"), **res)
        return res


if __name__ == "__main__":
    app = SinkingBox(fname="sinking_box")
    app.run()
    app.post_process(app.info_filename)
