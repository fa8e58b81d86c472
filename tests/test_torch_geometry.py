"""The port's lattice builders against the JAX package's (numpy on both
sides, no JAX compile): ``get_fluid_tank_3d`` gives the same arrays, bit
for bit, in the same order."""

import numpy as np
import pytest

from rigid_body_2d_3d_pysph_tpu.geom import geometry as jgeom
from rigid_body_2d_3d_pysph_tpu_torch.geom import geometry as tgeom


@pytest.mark.parametrize("args,hydrostatic", [
    # benchmark 5 (3D)'s tank at a coarse spacing
    ((1.0, 1.0, 1.0, 2.0, 1.5, 5, 0.1, 0.1), False),
    # a hydrostatic tank whose wall gaps differ from the fluid spacing
    ((1.0, 0.6, 0.5, 1.0, 0.8, 3, 0.05, 0.04), True),
])
def test_fluid_tank_3d_matches_jax(args, hydrostatic):
    got = tgeom.get_fluid_tank_3d(*args, hydrostatic=hydrostatic)
    want = jgeom.get_fluid_tank_3d(*args, hydrostatic=hydrostatic)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    xf, yf, zf, xt, yt, zt = got
    # the tank brackets the fluid below and on both z sides
    assert yt.min() < yf.min() and zt.min() < zf.min() < zf.max() < zt.max()
