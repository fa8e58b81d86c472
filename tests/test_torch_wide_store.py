"""The contact columns of K2 and B5 in the layouts the steps read, past
and below the hand kernels' narrow instance (the kernels write them
there on the card; on CPU tensors the wrappers run their plain versions,
which compute the same function in the same layout).

* K2 by particle (``contact_kernel.contact_pipeline_cell``: every slot,
  each lane's 12 S columns in its particle's row) against the JAX XLA
  cell engine in f64 on blocks over a wall, at S = 70 (2D), 66 (3D) and
  9 (2D): every block within rtol 1e-10 (absolute floor 1e-10 of the
  block's largest magnitude), as ``tests/test_torch_wide_kernels_3d.py``;
  the particle layout equal bit for bit to the query-row layout unpacked
  (what the pipeline did before), and to ``rows_by_particle`` of it.
* B5 by query row at the light cull's slots (the kdkf step's compact
  route: a padding row holds the init row) and by particle (its full
  route), each equal bit for bit to the query rows of every slot
  gathered, or unpacked; the force columns the same in every layout.
* The lane map of a grid that keeps ``slot2p`` and of one that keeps
  only ``dense_pos`` agree; the wrappers refuse rows and lanes together,
  and no entity slot.

The step-level cases (the compact and full kdkf routes and rigid RK2 at
S > 64 against the JAX f64 steps) are in
``tests/test_torch_wide_store_steps.py``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import contact_cell as jcc
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline as JQuintic

from rigid_body_2d_3d_pysph_tpu_torch.models import (
    rigid_fluid_coupling as tcpl)
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import (
    QuinticSpline as TQuintic)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_torch_contact import _assert_blocks
from test_torch_coupling_compact import DX, port_scene
from test_torch_wide_kernels import blocks_scene, cfgs

CPU = torch.device("cpu")


@pytest.mark.parametrize("dim,n_blocks", [(2, 69), (3, 65), (2, 8)])
def test_contact_by_particle_matches_cell_engine_f64(dim, n_blocks):
    scene, dx = blocks_scene(n_blocks, dim, dtype=jnp.float64,
                             cols=13 if dim == 3 else 12)
    S, n = scene.meta.total_no_bodies, scene.n
    init = 4.0 * dx
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    jcfg, tcfg = cfgs(fields, dx, dim)

    @jax.jit
    def run(scene):
        grid = jcell.build_cell_grid(scene.x, scene.y, scene.z,
                                     scene.active, jcfg)
        return grid.overflow, jcc.contact_pipeline_cell_fused(
            scene, grid, jcfg, JQuintic(dim=dim))

    ovf, (cx, cy, cz, cw, dinfo) = run(scene)
    assert not bool(ovf)
    ref = np.stack([np.asarray(a) for a in (
        cx, cy, cz, cw, dinfo["contact_force_dist"],
        dinfo["closest_point_dist_to_source"], dinfo["x_source"],
        dinfo["y_source"], dinfo["z_source"], dinfo["vx_source"],
        dinfo["vy_source"], dinfo["vz_source"])], 1).reshape(n, 12 * S)

    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float64)
    kernel = TQuintic(dim=dim)
    grid, _, dfT = tck.pack_scene(tscene, tcfg, want_dense_pos=True)
    assert not bool(grid.overflow)
    cp = tck.contact_pipeline_cell(dfT, grid, tcfg, kernel, S, init, n)
    got = cp.reshape(n, 12 * S)
    q = torch.arange(tcfg.NC_max)
    rows = tck.contact_sums_reference(dfT, q, grid.nbr_slots, S,
                                      tcfg.radius, init, kernel)
    assert torch.equal(got, tcell.unpack(grid, tcfg, rows, n, 0.0))
    assert torch.equal(got, tck.rows_by_particle(
        rows, q, tcell.lane_map(grid, tcfg, n)))
    picked = ref[:, 5 * S:6 * S] < init
    assert picked.sum() > 50
    if S > tck.S_NARROW:
        assert picked[:, tck.S_NARROW:].any()
    _assert_blocks(got.numpy(), ref, S, rtol_sum=1e-10, exact_picks=False,
                   rtol_pick=1e-10)


def _b5_pack():
    """The compact route's scene of ``tests/test_torch_coupling_compact.py``
    (8 boxes in a tank, S = 9, f32) and its coupling pack."""
    tsch, tscene = port_scene(dtype=torch.float32)
    assert "cl_pid" in tscene
    cfg = tsch._cell_cfg
    grid, pt, dfT = tfk.pack_fluid_sorted(tscene, cfg)
    assert not bool(grid.overflow)
    S = tscene.meta.total_no_bodies
    args = (dfT, grid.nbr_slots, TQuintic(dim=2), cfg.radius,
            tsch.fluid_alpha, tsch.c0, S, 4.0 * DX)
    return tsch, tscene, cfg, grid, pt, dfT, args


@pytest.mark.parametrize("layout", ["rows", "lanes"])
def test_b5_layouts_equal_the_every_slot_rows(layout):
    tsch, tscene, cfg, grid, pt, dfT, args = _b5_pack()
    S, init, n = args[6], args[7], tscene.n
    every_f, every = tfk.fluid_forces_contact(*args)
    assert every.shape == (cfg.NC_max, cfg.M, 12 * S)
    assert int((every[..., 5 * S:6 * S] < init).sum()) > 0
    if layout == "rows":
        rows, cc = tcpl.culled_lanes(tscene, dfT, pt, cfg, tsch.ni_max(cfg))
        n_int = int(cc.n_interesting)
        assert 0 < n_int < rows.shape[0]
        fo, co = tfk.fluid_forces_contact(*args, rows=rows)
        assert co.shape == (rows.shape[0], cfg.M, 12 * S)
        assert torch.equal(co[:n_int], every[rows[:n_int]])
        init_row = torch.zeros(12 * S)
        init_row[5 * S:6 * S] = init
        assert bool((co[n_int:] == init_row).all())
    else:
        fo, co = tfk.fluid_forces_contact(
            *args, lanes=tcell.lane_map(grid, cfg, n))
        assert torch.equal(co, tcell.unpack(grid, cfg, every, n, 0.0)
                           .reshape(n, 12 * S))
    assert torch.equal(fo, every_f)


def test_lane_map_of_both_grid_builds_agree():
    tsch, tscene = port_scene(dtype=torch.float32)
    cfg = tsch._cell_cfg
    x, y, z, act = tscene.x, tscene.y, tscene.z, tscene.active
    full = tcell.build_cell_grid(x, y, z, act, cfg)
    packed, _ = tcell.build_cell_grid_packed(x, y, z, act, cfg, [x],
                                             want_dense_pos=True)
    assert full.slot2p.numel() == cfg.NC_max * cfg.M
    assert packed.slot2p.numel() == 0
    a = tcell.lane_map(full, cfg, tscene.n)
    b = tcell.lane_map(packed, cfg, tscene.n)
    assert torch.equal(a.lane_pid, b.lane_pid)
    assert torch.equal(a.dense_pos, b.dense_pos)
    has = a.dense_pos < cfg.NC_max * cfg.M
    assert bool(has.all())
    assert torch.equal(a.lane_pid[a.dense_pos],
                       torch.arange(tscene.n))


@pytest.mark.parametrize("bad", ["rows and lanes", "no entity"])
def test_b5_wrapper_refuses(bad):
    tsch, tscene, cfg, grid, pt, dfT, args = _b5_pack()
    with pytest.raises(ValueError):
        if bad == "rows and lanes":
            tfk.fluid_forces_contact(
                *args, rows=torch.arange(4),
                lanes=tcell.lane_map(grid, cfg, tscene.n))
        else:
            tfk.fluid_forces_contact(*args[:6], 0, args[7])
