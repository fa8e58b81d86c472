"""Port vs reference: the coupling step's three fluid pair passes.

Each plain version (``ops/fluid_kernel.py``; the wrappers run them on CPU
tensors) against the JAX package's Pallas kernel in interpret mode, on
the same f32 scene, compared per particle after each side's own grid
build, pack and unpack:

* B4 ``fluid_rates_wall`` on ``test_fluid_coupling._tank_scene`` with the
  box at the surface, EDAC and rigid bodies on;
* B5 ``fluid_forces_contact`` with the box resting 0.95 dx above the
  tank floor, so the contact columns hold gated pairs, picks and sums;
* B6c ``fluid_forces`` on the fluid-only tank (no rigid body);
* B4 and B5 again on a spill grid of 48 lanes a slot (``_m48``: the
  kdkf step on a preset spill config; on the card the passes' instances
  of two warps a slot).

Velocities and the body's p_fsi are seeded random numbers (numpy).
Tolerance: the sums differ only in summation order (f32), within
2e-5 x the column's largest magnitude (the contact normals, unit
vectors, within 2e-5 absolute); measured 2.5e-7 relative on B4.  The
contact picks (closest distance and the picked source fields) are
copies and match bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import pallas_fluid as pfops
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline as JQuintic

from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import (
    QuinticSpline as TQuintic)

from test_fluid_coupling import _tank_scene
from test_pallas_fluid import _f32
from test_torch_coupling_step import _jax_floor_scene, port_twin

TOL = 2e-5
NU_EDAC, ALPHA, G = 0.02, 0.1, (0.0, -1.0, 0.0)


def _scene(case, M=None):
    """(reference scheme, f32 reference scene) with seeded velocities
    and, on the body, a seeded p_fsi; ``M``: the scheme's grid replaced
    by a spill grid of M lanes a slot at the same cutoff."""
    if case == "floor":
        jsch, jscene = _jax_floor_scene()
    else:
        jsch, jscene, _, _, _ = _tank_scene(with_body=case == "surface")
    rng = np.random.default_rng(5)
    n = jscene.n
    rigid = np.asarray(jscene.is_rigid)
    jscene = jscene.replace(
        u=jnp.asarray(rng.uniform(-0.2, 0.2, n)),
        v=jnp.asarray(rng.uniform(-0.2, 0.2, n)),
        p_fsi=jnp.asarray(np.where(rigid, rng.uniform(0.0, 1.0, n), 0.0)))
    if M is not None:
        host = lambda k: np.asarray(jscene[k])
        jsch._cell_cfg = jcell.config_from_positions(
            host("x"), host("y"), host("z"), jsch._cell_cfg.cutoff, 2, M=M,
            spill=True)
    return jsch, _f32(jscene)


def _reference(jsch, jscene, which):
    """The JAX pass in interpret mode, unpacked to [N, W] (numpy)."""
    cfg = jsch._cell_cfg
    kernel = JQuintic(dim=2)
    c0 = jsch.c0
    S = jscene.meta.total_no_bodies

    @jax.jit
    def run(scene):
        grid, dfT, sent, _ = pfops.pack_fluid_sorted(scene, cfg,
                                                     interpret=True)
        if which == "rates_wall":
            out = pfops.fluid_rates_wall_pallas(
                scene, grid, cfg, kernel, None, dfT, NU_EDAC, c0, True, True,
                *G, interpret=True, dense=True, sent_slot=sent)
        elif which == "forces_contact":
            out = pfops.fluid_forces_contact_pallas(
                scene, grid, cfg, kernel, None, dfT, ALPHA, c0, True, S,
                4.0 * scene.meta.spacing0, interpret=True, sent_slot=sent)
            out = jnp.concatenate([out[..., :12 * S],
                                   out[..., 12 * S:12 * S + 6]], -1)
        else:
            out = pfops.fluid_forces_pallas(
                scene, grid, cfg, kernel, None, dfT, ALPHA, c0, False,
                interpret=True, dense=True, sent_slot=sent)
        return jcell.unpack(grid, cfg, out, scene.n, 0.0), grid.overflow

    out, ovf = run(jscene)
    assert not bool(ovf)
    return np.asarray(out)


def _port(jsch, jscene, which):
    tsch, tscene = port_twin(jsch, jscene, torch.float32)
    cfg = tsch._cell_cfg
    kernel = TQuintic(dim=2)
    grid, _, dfT = tfk.pack_fluid_sorted(tscene, cfg)
    assert not bool(grid.overflow)
    args = (dfT, grid.nbr_slots, kernel, cfg.radius)
    if which == "rates_wall":
        out = tfk.fluid_rates_wall(*args, NU_EDAC, tsch.c0, True, True, G)
    elif which == "forces_contact":
        # the contact columns by query row at every slot, then the forces
        fo, co = tfk.fluid_forces_contact(*args, ALPHA, tsch.c0,
                                          tscene.meta.total_no_bodies,
                                          4.0 * tscene.meta.spacing0)
        out = torch.cat([co, fo], -1)
    else:
        out = tfk.fluid_forces(*args, ALPHA, tsch.c0)
    return tcell.unpack(grid, cfg, out, tscene.n, 0.0).numpy()


def _check_sums(got, ref, cols, what, floor=1e-30):
    """Each column within TOL x its largest magnitude (at least
    ``floor``: the contact normals are unit vectors, and a component
    near 0 carries the other components' rounding)."""
    for c in cols:
        a, b = got[:, c], ref[:, c]
        scale = max(np.abs(b).max(), floor)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale,
                                   err_msg=f"{what} column {c}")


CASES = {"rates_wall": "surface", "forces_contact": "floor",
         "forces": "fluid_only", "rates_wall_m48": "surface",
         "forces_contact_m48": "floor"}


@pytest.mark.parametrize("which", list(CASES))
def test_plain_pass_matches_pallas_interpret(which):
    M = 48 if which.endswith("_m48") else None
    jsch, jscene = _scene(CASES[which], M)
    which = which.removesuffix("_m48")
    assert M is None or jsch._cell_cfg.M == M
    ref = _reference(jsch, jscene, which)
    got = _port(jsch, jscene, which)
    assert got.shape == ref.shape
    fl = np.asarray(jscene.is_fluid)
    solid = np.asarray(jscene.is_static_boundary | jscene.is_rigid)
    if which == "rates_wall":
        assert np.abs(ref[fl, :2]).max() > 0          # rates on the fluid
        assert np.abs(ref[solid, 2:]).max() > 0       # wall sums on solids
        _check_sums(got, ref, range(7), which)
        return
    width = ref.shape[1]
    _check_sums(got, ref, range(width - 6, width), which)
    assert np.abs(ref[fl, width - 6:width - 3]).max() > 0
    if which == "forces":
        return
    rigid = np.asarray(jscene.is_rigid)
    assert np.abs(ref[rigid, width - 3:]).max() > 0   # fluid -> rigid force
    S = jscene.meta.total_no_bodies
    init = 4.0 * jscene.meta.spacing0
    # the contact half: gated pairs exist, picks are exact
    closest = ref[:, 5 * S:6 * S]
    assert (closest < np.float32(init)).sum() > 0
    np.testing.assert_array_equal(got[:, 5 * S:12 * S], ref[:, 5 * S:12 * S])
    _check_sums(got, ref, range(3 * S), which, floor=1.0)
    _check_sums(got, ref, range(3 * S, 5 * S), which)
