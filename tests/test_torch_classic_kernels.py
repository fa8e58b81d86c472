"""Port vs reference: K2 and the split fluid passes on the classic cell
grid (one slot a cell, lanes sized from occupancy), at the lane widths
and stencils that grid gives.

* f32, against the Pallas kernel in interpret mode: the plain version of
  K2 on every slot of a 2D classic grid of 32 lanes
  (``contact_kernel.contact_pipeline_cell`` on ``pack_classic``'s
  gathered pack) against ``pallas_contact.contact_pipeline_cell_pallas``
  (the reference's cell pipeline, which pads a slot to its 128-lane
  tile).  The picks (closest distance, picked source) equal, the sums
  within rtol 1e-5 of their column (summation order), as
  ``test_torch_contact.py`` holds the spill grid's.
* f64, against the JAX XLA cell engine: K2 at M = 48 and 104 and on the
  ``sub = 2`` stencil (2D, O = 25) of the coupling tank with the box on
  its floor, and at M = 104 on the 3D cubes (O = 27), against
  ``contact_cell.contact_pipeline_cell_fused``; B6a, B6b and B6c (with
  bodies) on ``fluid_kernel.pack_fluid_classic``'s pack at the same three
  2D grids against ``fluid_cell.fluid_rates_cell``, ``wall_bc_cell`` and
  ``fluid_forces_cell``.  Each column within 1e-10 of its largest
  magnitude, the picks equal (``test_torch_sph_passes.py``'s rule).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import fluid_cell as jfc
from rigid_body_2d_3d_pysph_tpu.ops import pallas_contact as jpc
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline as JQuintic

from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import (
    QuinticSpline as TQuintic)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_pallas_contact import _scene_f32
from test_torch_contact import _assert_blocks, _scene_3d_f64
from test_torch_sph_passes import (
    ALPHA, G, NU_EDAC, _check_contact, _close, _contact_ref)
from test_torch_coupling_step import _jax_floor_scene

CPU = torch.device("cpu")
# the 2D classic grids of the f64 comparisons: the coupling grid's width
# (M = 48 at the main path's size) and the rigid 3D grid's (104), each on
# bins coarse enough to fill its lanes (36 and 81 lattice sites a bin),
# and the sub = 2 stencil (O = 25)
GRIDS_2D = (("M48", dict(spill=False, M=48, cell_factor=2.0)),
            ("M104", dict(spill=False, M=104, cell_factor=3.0)),
            ("sub2", dict(sub=2)))


def _configs(fields, dim, **kw):
    """A classic config of the scene's positions (cutoff 3 max h) on both
    sides."""
    jcfg = jcell.config_from_positions(
        fields["x"], fields["y"], fields["z"], 3.0 * float(fields["h"].max()),
        dim, cell_chunk=32, **kw)
    assert not jcfg.spill
    tcfg = tcell.CellGridConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tcell.CellGridConfig)})
    return jcfg, tcfg


def test_plain_k2_on_classic_32_lanes_matches_pallas_interpret():
    scene, dx = _scene_f32()
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    jcfg, tcfg = _configs(fields, 2, spill=False, M=32)
    assert tcfg.M == 32 and tcfg.O == 9
    S, n = scene.meta.total_no_bodies, scene.n
    init = 4.0 * scene.meta.spacing0

    @jax.jit
    def run(scene):
        grid = jcell.build_cell_grid(scene.x, scene.y, scene.z,
                                     scene.active, jcfg)
        cx, cy, cz, cw, d = jpc.contact_pipeline_cell_pallas(
            scene, grid, jcfg, JQuintic(dim=2), interpret=True)
        return grid.overflow, jnp.stack(
            [cx, cy, cz, cw, d["contact_force_dist"],
             d["closest_point_dist_to_source"], d["x_source"],
             d["y_source"], d["z_source"], d["vx_source"], d["vy_source"],
             d["vz_source"]], 1)

    ovf, ref = run(scene)
    assert not bool(ovf)
    ref = np.asarray(ref).reshape(n, 12 * S)
    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float32)
    grid, dfT = tck.pack_classic(tscene, tcfg)
    assert not bool(grid.overflow) and dfT.shape[2] == 32
    got = tck.contact_pipeline_cell(dfT, grid, tcfg, TQuintic(dim=2), S,
                                    init, n).reshape(n, 12 * S).numpy()
    assert (ref[:, 5 * S:6 * S] < init).sum() > 10     # gated pairs
    _assert_blocks(got, ref, S, rtol_sum=1e-5, exact_picks=True)


@pytest.fixture(scope="module")
def floor_scene():
    """The coupling tank with the box on its floor, seeded velocities,
    pressures and body p_fsi (``test_torch_sph_passes``'s state)."""
    jsch, jscene = _jax_floor_scene()
    rng = np.random.default_rng(11)
    n = jscene.n
    rigid = np.asarray(jscene.is_rigid)
    jscene = jscene.replace(
        u=jnp.asarray(rng.uniform(-0.2, 0.2, n)),
        v=jnp.asarray(rng.uniform(-0.2, 0.2, n)),
        p=jnp.asarray(np.asarray(jscene.p) + rng.uniform(0.0, 0.5, n)),
        p_fsi=jnp.asarray(np.where(rigid, rng.uniform(0.0, 1.0, n), 0.0)))
    return jsch, jscene


@pytest.mark.parametrize("label,kw", GRIDS_2D, ids=[g[0] for g in GRIDS_2D])
def test_plain_k2_and_split_passes_on_classic_match_xla_f64(floor_scene,
                                                            label, kw):
    jsch, scene = floor_scene
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    jcfg, tcfg = _configs(fields, 2, **kw)
    jk, tk = JQuintic(dim=2), TQuintic(dim=2)
    S, n, c0 = scene.meta.total_no_bodies, scene.n, jsch.c0
    init = 4.0 * scene.meta.spacing0

    @jax.jit
    def run(scene):
        grid = jcell.build_cell_grid(scene.x, scene.y, scene.z,
                                     scene.active, jcfg)
        df, di = jfc.pack_fluid_scene(scene, grid, jcfg)
        p_d = jcell.pack_fields(grid, jcfg, [scene.p], [0.0])[..., 0]
        pf_d = jcell.pack_fields(grid, jcfg, [scene.p_fsi], [0.0])[..., 0]
        rates = jfc.fluid_rates_cell(scene, grid, jcfg, jk, df, di,
                                     NU_EDAC, c0, True, True)
        wall = jfc.wall_bc_cell(scene, grid, jcfg, jk, df, di, *G)
        forces = jfc.fluid_forces_cell(scene, grid, jcfg, jk, df, di, p_d,
                                       pf_d, ALPHA, c0, True)
        return (grid.overflow, jnp.stack(rates, 1), jnp.stack(wall, 1),
                jnp.stack(forces, 1), _contact_ref(scene, grid, jcfg, jk))

    ovf, *ref = run(scene)
    assert not bool(ovf)
    rates, wall, forces, contact = (np.asarray(r) for r in ref)
    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float64)
    grid, dfT = tfk.pack_fluid_classic(tscene, tcfg)
    assert not bool(grid.overflow)
    assert dfT.shape[2] == tcfg.M and grid.nbr_slots.shape[1] == tcfg.O
    # the widest cell fills at least half its lanes
    lanes = (grid.slot2p < n).reshape(tcfg.NC_max, tcfg.M).sum(1)
    assert 2 * int(lanes.max()) >= tcfg.M
    args = (dfT, grid.nbr_slots, tk, tcfg.radius)
    unpack = lambda v: tcell.unpack(grid, tcfg, v, n, 0.0).numpy()
    b6a = unpack(tfk.fluid_rates(*args, NU_EDAC, c0, True, True))
    b6b = unpack(tfk.wall_bc(*args, G))
    b6c = unpack(tfk.fluid_forces(*args, ALPHA, c0, True))
    cgrid, cdfT = tck.pack_classic(tscene, tcfg)
    k2 = tck.contact_pipeline_cell(cdfT, cgrid, tcfg, tk, S, init,
                                   n).numpy()

    fl = fields["is_fluid"].astype(bool)
    rigid = fields["is_rigid"].astype(bool)
    solid = fields["is_static_boundary"].astype(bool) | rigid
    assert min(np.abs(rates[fl, c]).max() for c in (0, 1)) > 0
    assert min(np.abs(wall[solid, c]).max() for c in (0, 1, 3, 4)) > 0
    assert min(np.abs(forces[rigid, c]).max() for c in (3, 4)) > 0
    assert (contact[:, 5] < init).sum() > 0           # gated contact pairs
    for c in range(2):
        _close(b6a[:, c], rates[:, c], f"{label} B6a column {c}")
    for c in range(5):
        _close(b6b[:, c], wall[:, c], f"{label} B6b column {c}")
    for c in range(6):
        _close(b6c[:, c], forces[:, c], f"{label} B6c column {c}")
    _check_contact(k2, contact, S, f"{label} K2")


def test_plain_k2_on_classic_104_lanes_3d_matches_xla_f64():
    scene, fields, dx = _scene_3d_f64()
    jcfg, tcfg = _configs(fields, 3, M=104)
    assert tcfg.O == 27
    S, n = scene.meta.total_no_bodies, scene.n
    init = 4.0 * scene.meta.spacing0

    @jax.jit
    def run(scene):
        grid = jcell.build_cell_grid(scene.x, scene.y, scene.z,
                                     scene.active, jcfg)
        return grid.overflow, _contact_ref(scene, grid, jcfg,
                                           JQuintic(dim=3))

    ovf, ref = run(scene)
    assert not bool(ovf)
    ref = np.asarray(ref)
    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float64)
    grid, dfT = tck.pack_classic(tscene, tcfg)
    got = tck.contact_pipeline_cell(dfT, grid, tcfg, TQuintic(dim=3), S,
                                    init, n).numpy()
    assert (ref[:, 5] < init).sum() > 10
    _check_contact(got, ref, S, "3D M=104 K2")
