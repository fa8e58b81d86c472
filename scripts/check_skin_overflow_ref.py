"""The JAX package's Verlet-skin step after an overflow rebuild, on the CPU.

    JAX_PLATFORMS=cpu python scripts/check_skin_overflow_ref.py

The reference ``Solver`` answers an overflow with ``refresh_configs``,
``adapt_scene`` and a new ``make_step`` (``app/application.py:144-147``).
The rigid schemes' ``adapt_scene`` touches only the compact store, so a
skin scene keeps the grid fields (``g_slot2p``, ``g_nbr_slots``, ...) of
the config it was built for.  This sets up ``tests/test_cell_engine.py``'s
skin scene (skin 0.3), re-sizes the config as a second rebuild does
(``grow=True``: every slack 1.5x) and takes one step.  It prints the two
configs' sizes and what the step did; a ``TypeError`` from ``lax.cond``
(its branches' grid shapes differ) is the reference's defect, and the
port's ``adapt_scene`` re-attaches the grid instead.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import jax.numpy as jnp  # noqa: E402

from rigid_body_2d_3d_pysph_tpu.geom import get_2d_block  # noqa: E402
from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb  # noqa: E402
from rigid_body_2d_3d_pysph_tpu.state import (  # noqa: E402
    make_group, build_scene)


def skin_scene():
    dx = 0.04
    xb, yb = get_2d_block(dx, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.2 + 0.6 * dx])
    y = np.concatenate([yb, yb])
    bid = np.repeat(np.arange(2, dtype=np.int32), len(xb))
    xw = np.arange(-8, 20) * dx
    yw = np.full(len(xw), yb.min() - 0.7 * dx)
    m = 2000 * dx * dx
    body = make_group("body", x, y, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role="rigid", body_id=bid, dem_id=bid)
    wall = make_group("wall", xw, yw, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role="boundary", dem_id=2)
    scene = build_scene([body, wall], dim=2, total_no_bodies=3, spacing0=dx)
    scheme = jrb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    scheme.engine, scheme.skin_factor = "cell", 0.3
    return scheme, scheme.setup(scene)


def main():
    scheme, scene = skin_scene()
    c0 = scheme._cell_cfg
    print(f"set-up config: NC {c0.NC_max}, O {c0.O}; g_slot2p "
          f"{scene.g_slot2p.shape}, g_nbr_slots {scene.g_nbr_slots.shape}")
    scheme.refresh_configs(scene, grow=True)
    scene = scheme.adapt_scene(scene)
    step = scheme.make_step(scene)
    c1 = scheme._cell_cfg
    print(f"rebuilt config: NC {c1.NC_max}, O {c1.O}; after adapt_scene "
          f"g_slot2p {scene.g_slot2p.shape}, g_nbr_slots "
          f"{scene.g_nbr_slots.shape}")
    try:
        out = step(scene, jnp.asarray(1e-4))
        print(f"the step ran: overflow {bool(out.nbr_overflow)}")
        return 0
    except TypeError as e:
        print(f"the step raised TypeError: {str(e).splitlines()[0]}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
