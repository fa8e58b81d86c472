"""The port's six SPH kernels against the JAX package's, in float64.

For each kernel name and dimension: ``sigma``, ``w``, ``dwdq``,
``gradw_scalar`` and ``w_gradw`` at seeded random r and h, with r = 0,
the support's edge and points beyond it among them; rtol 1e-12.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import kernels as jk
from rigid_body_2d_3d_pysph_tpu_torch.ops import kernels as tk

NAMES = ("quintic", "cubic", "wendland", "wendland_c4", "gaussian",
         "super_gaussian")


def _inputs(radius_scale, seed):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.01, 0.2, 200)
    q = rng.uniform(0.0, radius_scale * 1.2, 200)
    # r = 0, the support's edge, q = 1 and 2 (piece boundaries)
    q[:5] = [0.0, radius_scale, 1.0, 2.0, radius_scale * (1 + 1e-9)]
    return q * h, h


def _close(a, b, what):
    np.testing.assert_allclose(b, np.asarray(a), rtol=1e-12, atol=0.0,
                               err_msg=what)


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_jax(name, dim):
    jker = jk.get_kernel(name, dim)
    tker = tk.get_kernel(name, dim)
    assert type(tker).__name__ == type(jker).__name__
    assert tker.radius_scale == jker.radius_scale
    r, h = _inputs(jker.radius_scale, seed=17 * dim + NAMES.index(name))
    jr, jh = jnp.asarray(r), jnp.asarray(h)
    tr, th = torch.from_numpy(r), torch.from_numpy(h)
    _close(jker.sigma(jh), tker.sigma(th).numpy(), "sigma")
    for fn in ("w", "dwdq", "gradw_scalar"):
        _close(getattr(jker, fn)(jr, jh), getattr(tker, fn)(tr, th).numpy(),
               fn)
    jw, js = jker.w_gradw(jr, jh)
    tw, ts = tker.w_gradw(tr, th)
    _close(jw, tw.numpy(), "w_gradw w")
    _close(js, ts.numpy(), "w_gradw gradw")
    # nonvacuous: the kernel is nonzero inside its support
    assert np.abs(tw.numpy()).max() > 0


def test_unknown_kernel_raises():
    with pytest.raises(KeyError):
        tk.get_kernel("spline7", 2)
