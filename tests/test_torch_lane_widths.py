"""Port vs reference: the DEM pass and steps, and the kdkf coupling step,
at the lane widths and grid layouts the reference's steps take beside
their defaults, in float64.

* The DEM pass on a classic cell grid (one slot a cell, M sized from
  occupancy; the slab steps' classic base): the port's pass (the pack
  gathered through ``slot2p``, the plain version of ``csrc/dem.cu``'s
  kernel on CPU tensors) against the reference's ``build_cell_grid``,
  its table prune and its cell-engine DEM pass on the same config, from
  empty tables and again from the tables the first pass left at moved
  positions: the candidate order is the same, so the tables and live
  counts match exactly and the sums and springs at rtol 1e-12.
* 5 DEM steps of the 2D jittered grain block (``tests/test_dem_cell.py``)
  with ``cell_M = 32`` (the reference sweep's (8, 32) width) and with a
  preset classic config, against the reference scheme on its XLA cell
  engine: atol 1e-9 and the tables as (idx, dem) -> spring maps, as
  ``tests/test_torch_dem_step.py``.  On the preset classic config the
  reference's step runs (its cell engine builds the grid it is given),
  and so does the port's.
* The kdkf coupling step on a preset spill config of 48 lanes a slot,
  the box sliding on the tank floor: the full route and the compact
  store's route, 3 steps each, against the reference's XLA kdkf branch
  on the same config at rtol 1e-9 (``tests/test_torch_coupling_step.py``'s
  tolerance: only the summation order differs).

On CPU tensors the kernel wrappers run their plain versions.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu import geom as jgeom
from rigid_body_2d_3d_pysph_tpu.models.rigid_fluid_coupling import (
    RigidFluidCouplingScheme as JRFC)
from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import dem as jdem
from rigid_body_2d_3d_pysph_tpu.ops import dem_cell as jdc
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from rigid_body_2d_3d_pysph_tpu_torch.models import DEMScheme
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_dem_cell import _grain_scene
from test_torch_coupling_step import (
    BODY, DT_CONTACT, FLUID, SLOTS, _compare, _run_reference,
    _shadow_fields, _velocities, coupling_scene, port_twin)
from test_torch_dem_step import TRAJ_2D, _run

CPU = torch.device("cpu")
RTOL = 1e-12


def _port_cfg(jcfg):
    return tcell.CellGridConfig(**{f.name: getattr(jcfg, f.name)
                                   for f in dataclasses.fields(
                                       tcell.CellGridConfig)})


def _classic_dem_cfg(jscene):
    host = lambda k: np.asarray(jscene[k])
    cutoff = 2.0 * float(host("rad_s").max())
    cfg = jcell.config_from_positions(host("x"), host("y"), host("z"),
                                      cutoff, 2, cell_factor=2.0,
                                      spill=False, cell_chunk=16)
    assert not cfg.spill
    return cfg


def test_dem_classic_pass_matches_reference_f64():
    _, jscene = _grain_scene()
    assert jscene.x.dtype == jnp.float64
    jcfg = _classic_dem_cfg(jscene)
    tcfg = _port_cfg(jcfg)
    dt = 1e-5
    tables = tuple(jscene[k] for k in ("tng_idx", "tng_idx_dem_id", "tng_x",
                                       "tng_y", "tng_z"))
    for it in range(2):
        tscene = scene_from_numpy({k: np.asarray(v) for k, v in
                                   jscene.fields.items()}, jscene.meta, CPU,
                                  torch.float64)
        grid = jcell.build_cell_grid(jscene.x, jscene.y, jscene.z,
                                     jscene.active, jcfg)
        pruned = jdem.prune_contact_table(jscene, *tables)[:5]
        ref = jdc.lvc_displacement_cell(jscene, grid, jcfg, dt, *pruned)
        got = tdk.lvc_displacement_cell_kernel(
            tscene, tcfg, dt, *(torch.as_tensor(np.array(t))
                                for t in tables))
        assert not bool(grid.overflow) and not bool(got.overflow)
        eq = np.testing.assert_array_equal
        eq(got.tng_idx.numpy(), np.asarray(ref[6]), err_msg=f"pass {it}")
        eq(got.tng_dem.numpy(), np.asarray(ref[7]), err_msg=f"pass {it}")
        eq(got.count.numpy(), np.asarray(ref[11]), err_msg=f"pass {it}")
        assert int(got.count.sum()) > 0
        for i, nm in enumerate(["fx", "fy", "fz", "torx", "tory", "torz",
                                None, None, "tng_x", "tng_y", "tng_z"]):
            if nm is None:
                continue
            a = np.asarray(ref[i])
            np.testing.assert_allclose(
                getattr(got, nm).numpy(), a, rtol=RTOL,
                atol=RTOL * max(np.abs(a).max(), 1e-300), err_msg=nm)
        # the next pass: the tables this one left, at moved positions
        tables = ref[6:11]
        jscene = jscene.replace(x=jscene.x + 2e-3 * jscene.u,
                                y=jscene.y + 2e-3 * jscene.v)


@pytest.mark.parametrize("grid", ["M32", "classic"])
def test_dem_steps_at_other_widths_match_reference_f64(grid):
    jscheme, jscene = _grain_scene()
    tscheme = DEMScheme(["grains"], ["floor"], kn=1e5, en=0.5, gy=-9.81,
                        dim=2)
    if grid == "M32":
        tscheme.cell_M = 32
    else:
        jscheme._cell_cfg = _classic_dem_cfg(jscene)
        tscheme._cell_cfg = _port_cfg(jscheme._cell_cfg)
    _run(jscheme, jscene, tscheme, 5, TRAJ_2D)
    cfg = tscheme._cell_cfg
    assert (cfg.spill and cfg.M == 32) if grid == "M32" else not cfg.spill


@pytest.fixture(scope="module")
def kdkf48():
    """The box sliding on the tank floor, the reference's scheme on a
    preset spill config of 48 lanes a slot, and its 3 XLA kdkf steps."""
    jsch, jscene, dx, rho0 = coupling_scene(jmake_group, jbuild_scene, jgeom,
                                            JRFC, True, floor=True)
    jsch.engine = "cell"
    host = lambda k: np.asarray(jscene[k])
    jsch._cell_cfg = jcell.config_from_positions(
        host("x"), host("y"), host("z"), 3.0 * float(host("h").max()), 2,
        M=48, spill=True)
    jscene = jsch.setup(jscene)
    m_fsi, rho_fsi = _shadow_fields(jscene, rho0, dx)
    jscene = _velocities(jscene.replace(m_fsi=jnp.asarray(m_fsi),
                                        rho_fsi=jnp.asarray(rho_fsi)),
                         7, 0.05).replace(vcm=jnp.asarray([[0.05, -0.02,
                                                            0.0]]))
    assert jsch._cell_cfg.M == 48 and jsch._cell_cfg.spill
    return jsch, *_run_reference(jsch, jscene, 3, DT_CONTACT)


@pytest.mark.parametrize("route", ["full", "compact"])
def test_kdkf_on_a_48_lane_spill_grid_matches_reference_f64(kdkf48, route):
    jsch, start, jend = kdkf48
    tsch, tscene = port_twin(jsch, start, torch.float64)
    cfg = tsch._cell_cfg
    if route == "compact":
        tscene = trb.compact_slot_scene(tscene, tsch.ni_max(cfg) * cfg.M)
    step = tsch.make_step(tscene)
    for _ in range(3):
        tscene = step(tscene, DT_CONTACT)
    if route == "compact":
        assert 0 < int(tscene.n_interesting) <= tsch.ni_max(cfg)
        tscene = trb.strip_compact_fields(trb.expand_slot_scene(tscene))
    assert float(np.asarray(jend.overlap).max()) > 0
    assert float(np.abs(np.asarray(jend.delta_lt_x)).max()) > 0
    _compare(jend, tscene, FLUID + BODY + SLOTS, rtol=1e-9)
