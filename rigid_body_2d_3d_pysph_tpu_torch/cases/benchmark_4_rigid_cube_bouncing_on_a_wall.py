"""Benchmark 4: the cubes of benchmark 3 bouncing on the tank floor with
a chosen coefficient of restitution.

Counterpart of ``cases/benchmark_4_rigid_cube_bouncing_on_a_wall.py``:
benchmark 3's geometry, the ``--coeff-of-restitution`` option (default
1.0) and the (2, 3) restitution matrix handed to the set-up (it sets the
damping matrix eta); dt = 1e-4, tf = 3 (30,000 steps).  The check: the
cubes fall, bounce, stay in the tank and settle; the first-bounce
heights are recorded beside the f64 oracle's.
"""

import numpy as np

from .benchmark_3_multiple_rigid_bodies_colliding_same_particle_array import (
    Benchmark3,
)


class Benchmark4(Benchmark3):
    def initialize(self):
        super().initialize()
        self.coeff_of_rest = 1.0
        self.tf = 3.0

    def add_user_options(self, group):
        group.add_argument("--coeff-of-restitution", type=float,
                           dest="coeff_of_rest", default=1.0,
                           help="Coefficient of restitution")

    def consume_user_options(self):
        self.coeff_of_rest = self.options.coeff_of_rest

    def create_particles(self):
        coeff = np.full((2, 3), self.coeff_of_rest)
        return self.scheme.scheme.setup(self.make_scene(),
                                        coeff_of_rest=coeff)


if __name__ == "__main__":
    app = Benchmark4(fname="benchmark_4")
    app.run()
