"""The port's neighbour list against the JAX package's, bit for bit.

``build_neighbors`` (padded and ``compact=True``) gives the same
``idx``, ``mask``, ``n_neighbors`` and ``overflow`` as the JAX
``build_neighbors`` on seeded random 2D and 3D inputs (float64 and
float32), a lattice with negative coordinates whose points lie on cell
faces, inactive particles, and a per-cell cap M small enough to
overflow, with rows built in several chunks.  The list holds the same
pairs as ``brute_force_neighbors``; ``estimate_capacities`` and
``default_config`` give the JAX package's numbers.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import neighbors as jnb
from rigid_body_2d_3d_pysph_tpu_torch.ops import neighbors as tnb


def _random(dim, n=400, seed=1):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    z = rng.uniform(-1, 1, n) if dim == 3 else np.zeros(n)
    return x, y, z, np.ones(n, bool)


def _lattice(dim):
    """Points spaced 0.1 from -1 to 0.9 with a cutoff of 0.3: every third
    lattice line is a cell face, negative cells included."""
    xs = np.arange(-10, 10) * 0.1
    if dim == 2:
        x, y = np.meshgrid(xs, xs, indexing="ij")
        z = np.zeros_like(x)
    else:
        xs = xs[::2]
        x, y, z = np.meshgrid(xs, xs, xs, indexing="ij")
    x, y, z = x.ravel(), y.ravel(), z.ravel()
    return x, y, z, np.ones(len(x), bool)


def _inactive(dim):
    x, y, z, _ = _random(dim, 300, seed=2)
    act = np.random.default_rng(3).uniform(size=len(x)) > 0.3
    return x, y, z, act


CASES = {
    "random": (_random, 0.4, {}),
    "lattice": (_lattice, 0.3, {}),
    "inactive": (_inactive, 0.3, {}),
    "overflow": (_random, 0.4, dict(max_per_cell=3, max_neighbors=8)),
}


def _configs(dim, cutoff, n, over):
    kw = dict(cutoff=cutoff, dim=dim, n_buckets=1 << 10, row_chunk=64,
              max_neighbors=over.get("max_neighbors", 96 if dim == 2 else 160),
              max_per_cell=over.get("max_per_cell", 48))
    return jnb.NeighborConfig(**kw), tnb.NeighborConfig(**kw)


@pytest.mark.parametrize("compact", (False, True))
@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("case", sorted(CASES))
def test_list_matches_jax_bit_for_bit(case, dim, dtype, compact):
    make, cutoff, over = CASES[case]
    x, y, z, act = make(dim)
    x, y, z = (a.astype(dtype) for a in (x, y, z))
    jcfg, tcfg = _configs(dim, cutoff, len(x), over)
    jcfg = jnb.NeighborConfig(**{**jcfg.__dict__, "compact": compact})
    tcfg = tnb.NeighborConfig(**{**tcfg.__dict__, "compact": compact})
    jl = jnb.build_neighbors(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z),
                             jnp.asarray(act), jcfg)
    tl = tnb.build_neighbors(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(z), torch.from_numpy(act), tcfg)
    for k in ("idx", "mask", "n_neighbors"):
        a, b = np.asarray(getattr(jl, k)), getattr(tl, k).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert bool(tl.overflow) == bool(np.asarray(jl.overflow))
    assert bool(tl.overflow) == (case == "overflow")
    assert int(tl.n_neighbors.sum()) > len(x)      # pairs beyond self


@pytest.mark.parametrize("dim", (2, 3))
def test_same_pairs_as_brute_force(dim):
    x, y, z, act = _inactive(dim)
    cutoff = 0.3
    _, cfg = _configs(dim, cutoff, len(x), {})
    t = lambda a: torch.from_numpy(a)
    nl = tnb.build_neighbors(t(x), t(y), t(z), t(act), cfg)
    bf = tnb.brute_force_neighbors(t(x), t(y), t(z), t(act), cutoff, 256)
    jbf = jnb.brute_force_neighbors(jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(z), jnp.asarray(act), cutoff,
                                    256)
    for k in ("idx", "mask", "n_neighbors"):
        np.testing.assert_array_equal(getattr(bf, k).numpy(),
                                      np.asarray(getattr(jbf, k)))
    assert not bool(nl.overflow) and not bool(bf.overflow)

    def sets(l):
        idx, mask = l.idx.numpy(), l.mask.numpy()
        return [set(idx[i][mask[i]].tolist()) for i in range(len(idx))]

    assert sets(nl) == sets(bf)
    assert all(not s for s, a in zip(sets(nl), act) if not a)


@pytest.mark.parametrize("dim", (2, 3))
def test_capacities_and_default_config(dim):
    x, y, z, _ = _random(dim, 500, seed=4)
    for safety in (1.7, 2.0, 3.0):
        assert (tnb.estimate_capacities(x, y, z, 0.3, dim, safety)
                == jnb.estimate_capacities(x, y, z, 0.3, dim, safety))
    m, k = tnb.estimate_capacities(x, y, z, 0.3, dim)
    for n in (1, 500, 100_000):
        a = tnb.default_config(dim, 0.3, n, max_neighbors=k, max_per_cell=m)
        b = jnb.default_config(dim, 0.3, n, max_neighbors=k, max_per_cell=m)
        assert a.__dict__ == b.__dict__ and a.stencil == b.stencil
