"""DEM: the 2D granular column collapse (Luding LVC contact).

Counterpart of ``cases/dem_granular_column_collapse.py``: a rectangular
column of grains collapses onto a floor; the runout length and the
final pile height are the observables.  ``--column-scale`` scales the
column's width and height.
"""

import os

import numpy as np

from ..app import output as out_mod
from ..app.application import Application
from ..geom import get_2d_block
from ..models.base import SchemeChooser
from ..models.dem import DEMScheme
from ..state import ROLE_BOUNDARY, ROLE_RIGID, build_scene, make_group


class GranularColumnCollapse(Application):
    def add_user_options(self, group):
        group.add_argument(
            "--column-scale", dest="column_scale", type=float, default=1.0,
            help="scale the column dimensions (10 -> ~113k grains)")

    def initialize(self):
        self.dim = 2
        self.radius = 1e-3            # grain radius
        self.spacing = 2.1e-3         # slightly loose packing
        self.column_width = 0.05
        self.column_height = 0.1
        self.rho = 2600.0
        self.kn = 1e5
        self.en = 0.5
        self.mu = 0.5
        self.gy = -9.81
        self.dt = 1e-6 * 5
        self.tf = 0.3

    def consume_user_options(self):
        k = float(getattr(self.options, "column_scale", 1.0) or 1.0)
        self.column_width *= k
        self.column_height *= k

    def create_particles(self):
        s = self.spacing
        xg, yg = get_2d_block(s, self.column_width, self.column_height)
        yg -= yg.min() - self.radius
        m = self.rho * np.pi * self.radius**2
        n = len(xg)
        grains = make_group(
            "sand", xg, yg, m=m, h=2.0 * self.radius / 1.0,
            rho=self.rho, rad_s=self.radius, role=ROLE_RIGID,
            body_id=np.arange(n, dtype=np.int32),
            dem_id=np.zeros(n, np.int32),
        )
        # the floor, wide enough that the runout stays on it
        xf = np.arange(-3.5 * self.column_height,
                       3.5 * self.column_height, 2 * self.radius)
        yf = np.full(len(xf), -self.radius)
        floor = make_group(
            "floor", xf, yf, m=m, h=2.0 * self.radius, rho=self.rho,
            rad_s=self.radius, role=ROLE_BOUNDARY,
            dem_id=np.ones(len(xf), np.int32),
        )
        scene = build_scene([grains, floor], dim=self.dim,
                            total_no_bodies=2, spacing0=s,
                            device=self.device, dtype=self.dtype)
        return self.scheme.scheme.setup(scene)

    def create_scheme(self):
        dem = DEMScheme(granular_particles=["sand"], boundaries=["floor"],
                        kn=self.kn, en=self.en, mu=self.mu, dim=self.dim,
                        gy=self.gy, max_tng_contacts_limit=8)
        return SchemeChooser(default="dem", dem=dem)

    def configure_scheme(self):
        self.scheme.configure_solver(dt=self.dt, tf=self.tf, pfreq=1000)

    def post_process(self, fname=None):
        # every snapshot in the directory (a resumed run's too)
        files = out_mod.get_files(self.output_dir)
        if not files:
            return None
        t, runout, height = [], [], []
        for sd, g in out_mod.iter_output(files, "sand"):
            t.append(float(sd["t"]))
            runout.append(float(g.x.max()))
            height.append(float(g.y.max()))
        res = dict(t=np.asarray(t), runout=np.asarray(runout),
                   height=np.asarray(height))
        np.savez(os.path.join(self.output_dir, "results.npz"), **res)
        return res


if __name__ == "__main__":
    app = GranularColumnCollapse(fname="dem_column_collapse")
    app.run()
    app.post_process(app.info_filename)
