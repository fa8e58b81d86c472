"""Port vs reference: the split fluid passes of the kdk and reference
orderings.

Each plain version (``ops/fluid_kernel.py``; the wrappers run them on CPU
tensors) against the JAX package's Pallas kernel in interpret mode, on
the same f32 scene (``test_fluid_coupling._tank_scene`` with the box at
the surface, seeded velocities and body p_fsi), compared per particle
after each side's own grid build, pack and unpack:

* B6a ``fluid_rates`` with rigid bodies, EDAC and Tait (no ``ap``);
* B6b ``wall_bc``;
* B6c ``fluid_forces`` with rigid bodies (the FSI source class and the
  fluid -> rigid force).

Tolerance: the sums differ only in summation order (f32), within 2e-5 x
the column's largest magnitude, the tolerance of ``test_torch_fluid.py``.
The JAX passes run in one jitted function, compiled once for the module.

The packs those orderings derive, held bit for bit against fresh builds:
the contact pack laid out from the coupling pack, and a coupling pack
whose columns were patched to a changed state.
"""

import numpy as np
import jax
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import pallas_fluid as pfops
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline as JQuintic

from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import (
    QuinticSpline as TQuintic)

from test_torch_coupling_step import port_twin
from test_torch_fluid import ALPHA, G, NU_EDAC, _check_sums, _scene

# pass -> (destination class, its columns that are nonzero there)
CASES = {"rates_edac": ("fluid", (0, 1)), "rates_tait": ("fluid", (0,)),
         "wall_bc": ("solid", (0, 1, 3, 4)),
         "forces_rigid": (None, (0, 1, 3, 4))}


@pytest.fixture(scope="module")
def passes():
    """(reference scene, {pass: JAX output [N, W]}, {pass: port output})."""
    jsch, jscene = _scene("surface")
    cfg = jsch._cell_cfg
    kernel = JQuintic(dim=2)
    c0 = jsch.c0

    @jax.jit
    def run(scene):
        grid, dfT, sent, _ = pfops.pack_fluid_sorted(scene, cfg,
                                                     interpret=True)
        kw = dict(interpret=True, dense=True, sent_slot=sent)
        outs = dict(
            rates_edac=pfops.fluid_rates_pallas(
                scene, grid, cfg, kernel, None, dfT, NU_EDAC, c0, True, True,
                **kw),
            rates_tait=pfops.fluid_rates_pallas(
                scene, grid, cfg, kernel, None, dfT, NU_EDAC, c0, False,
                True, **kw),
            wall_bc=pfops.wall_bc_pallas(scene, grid, cfg, kernel, None, dfT,
                                         *G, **kw),
            forces_rigid=pfops.fluid_forces_pallas(
                scene, grid, cfg, kernel, None, dfT, ALPHA, c0, True, **kw))
        return ({k: jcell.unpack(grid, cfg, v, scene.n, 0.0)
                 for k, v in outs.items()}, grid.overflow)

    ref, ovf = run(jscene)
    assert not bool(ovf)

    tsch, tscene = port_twin(jsch, jscene, torch.float32)
    tcfg = tsch._cell_cfg
    grid, _, dfT = tfk.pack_fluid_sorted(tscene, tcfg)
    assert not bool(grid.overflow)
    args = (dfT, grid.nbr_slots, TQuintic(dim=2), tcfg.radius)
    outs = dict(
        rates_edac=tfk.fluid_rates(*args, NU_EDAC, c0, True, True),
        rates_tait=tfk.fluid_rates(*args, NU_EDAC, c0, False, True),
        wall_bc=tfk.wall_bc(*args, G),
        forces_rigid=tfk.fluid_forces(*args, ALPHA, c0, True))
    got = {k: tcell.unpack(grid, tcfg, v, tscene.n, 0.0).numpy()
           for k, v in outs.items()}
    return jscene, {k: np.asarray(v) for k, v in ref.items()}, got


@pytest.mark.parametrize("which", list(CASES))
def test_split_pass_matches_pallas_interpret(passes, which):
    jscene, ref, got = passes
    ref, got = ref[which], got[which]
    assert got.shape == ref.shape
    fl = np.asarray(jscene.is_fluid)
    rigid = np.asarray(jscene.is_rigid)
    solid = np.asarray(jscene.is_static_boundary) | rigid
    dest, nonzero = CASES[which]
    if which == "forces_rigid":
        # au, av on the fluid; the fluid -> rigid force on the body
        assert min(np.abs(ref[fl, c]).max() for c in (0, 1)) > 0
        assert min(np.abs(ref[rigid, c]).max() for c in (3, 4)) > 0
    else:
        rows = fl if dest == "fluid" else solid
        assert min(np.abs(ref[rows, c]).max() for c in nonzero) > 0
    if which == "rates_tait":
        assert not ref[:, 1].any() and not got[:, 1].any()
    _check_sums(got, ref, range(ref.shape[1]), which)


def _port_scene(case):
    jsch, jscene = _scene(case)
    return port_twin(jsch, jscene, torch.float32)


def test_contact_pack_is_the_contact_build():
    tsch, tscene = _port_scene("floor")
    cfg = tsch._cell_cfg
    _, _, dfT = tfk.pack_fluid_sorted(tscene, cfg)
    _, _, ref = tck.pack_scene(tscene, cfg)
    assert torch.equal(tck.contact_pack(dfT, tfk.UNION_LAYOUT, True), ref)


def test_patched_pack_is_a_fresh_pack():
    """The reference ordering's patch of u, v, w, p after the kick, with
    one inactive particle (no lane: its write lands on the sentinel row
    as the sentinel)."""
    tsch, tscene = _port_scene("surface")
    cfg = tsch._cell_cfg
    active = tscene.active.clone()
    active[0] = False
    tscene = tscene.replace(active=active)
    rng = np.random.default_rng(17)
    new = {k: torch.as_tensor(rng.uniform(-1.0, 1.0, tscene.n),
                              dtype=torch.float32)
           for k in ("u", "v", "w", "p")}
    grid, _, dfT = tfk.pack_fluid_sorted(tscene, cfg)
    assert int(grid.dense_pos[0]) == cfg.NC_max * cfg.M
    tfk.patch_columns(dfT, grid.dense_pos, {
        tfk.FU: new["u"], tfk.FV: new["v"], tfk.FW: new["w"],
        tfk.FP: new["p"]})
    _, _, ref = tfk.pack_fluid_sorted(tscene.replace(**new), cfg)
    assert torch.equal(dfT, ref)
