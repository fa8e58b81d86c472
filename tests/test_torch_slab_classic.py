"""Port vs reference: the slab steps (``parallel/slab.py``) on a classic
base grid (one slot a cell, M sized from the worst cell's occupancy), on
4 CPU slabs in float64, against the reference's single-device step on
the same classic config (its XLA cell engine builds the grid it is
given).  The tolerances are those of the spill-base tests:

* the rigid step's full ``[N, S]`` route (the pack gathered through the
  local grid's ``slot2p``, the contact sums on every slot) on
  ``tests/test_torch_slab.py``'s row of 8 blocks on a floor, 5 steps:
  atol 1e-9 on x/y/u/v and xcm, 1e-7 on the body force, rows matched by
  (x, y); the blob route needs the spill grid and raises on a classic
  base, as the reference's blob evaluation does;
* the DEM step on ``tests/test_slab_dem.py``'s strip of grains, 3 steps,
  gid-keyed tables: atol 1e-8 and the tables as (partner, dem) ->
  spring maps (``tests/test_torch_slab_dem.py``);
* the coupling step, kdk and kdkf, on ``tests/test_torch_slab_coupling.py``'s
  tank (the classic grid of the coupling's lane rule, cut to the tank
  in x), 3 steps: atol 2e-8 on the fluid fields, 1e-7 on the body
  force, 1e-9 on xcm.  The slab kdkf runs B4 and B6c where the
  single-device kdkf fuses forces and contact: the same sums in another
  order.

On CPU tensors the kernel wrappers run their plain versions.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops.kernels import get_kernel as jget_kernel

from rigid_body_2d_3d_pysph_tpu_torch.models import (DEMScheme,
                                                     RigidBody2DScheme)
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as tslab
from rigid_body_2d_3d_pysph_tpu_torch.parallel.mesh import make_mesh

from test_slab_dem import _wide_grain_scene
from test_torch_slab import _assert_single_device, _wide_scene
from test_torch_slab import _port as _port64
from test_torch_slab_coupling import (FIELDS, NX, X0, _match_xy, _parts,
                                      _slab_base, _tank_scene)
from test_torch_coupling_step import port_twin
from test_torch_slab_dem import _assert_matches_reference

CPU = torch.device("cpu")
P = 4


def _port_cfg(jcfg):
    return tcell.CellGridConfig(**{f.name: getattr(jcfg, f.name)
                                   for f in dataclasses.fields(
                                       tcell.CellGridConfig)})


def _classic(scene, cutoff, **kw):
    host = lambda k: np.asarray(scene[k])
    cfg = jcell.config_from_positions(host("x"), host("y"), host("z"),
                                      cutoff, 2, spill=False, **kw)
    assert not cfg.spill
    return cfg


def _rigid_setup():
    jscheme, jscene = _wide_scene()
    kernel = jget_kernel(jscheme.kernel_name, 2)
    spill = jscheme.cell_config(jscene, kernel)
    jscheme._cell_cfg = _classic(jscene, spill.cutoff, cell_chunk=64)
    tscheme = RigidBody2DScheme(jscheme.rigid_bodies, ["floor"], dim=2,
                                gy=-9.81)
    return jscheme, jscene, tscheme, _port64(jscene), kernel


def test_rigid_slab_steps_on_a_classic_base_match_single_device():
    jscheme, jscene, tscheme, tscene, _ = _rigid_setup()
    steps, dt = 5, 1e-4
    jstep = jscheme.make_step(jscene)
    js = jscene
    for _ in range(steps):
        js = jstep(js, jnp.asarray(dt))
    cfg = tslab.make_slab_config(tscene, _port_cfg(jscheme._cell_cfg), P)
    assert cfg.slab_cells >= 2 and not cfg.base.spill
    mesh = make_mesh(P, [CPU] * P)
    parts = tslab.shard_slab_scene(
        tslab.slab_decompose(tscene, cfg, use_blob=False), mesh)
    step = tslab.make_slab_step(tscheme, parts, mesh, cfg)
    for _ in range(steps):
        parts = step(parts, dt)
    g = tslab.gather_slab_scene(parts)
    assert not bool(g.nbr_overflow) and not bool(js.nbr_overflow)
    assert float(g.overlap.max()) > 0
    _assert_single_device(g, js)


def test_rigid_blob_route_refuses_a_classic_base_as_the_reference():
    jscheme, jscene, tscheme, tscene, kernel = _rigid_setup()
    params = dict(kr=jscheme.kr, kf=jscheme.kf,
                  fric_coeff=jscheme.fric_coeff, gx=0.0, gy=-9.81, gz=0.0)
    with pytest.raises(ValueError, match="spill"):
        jrb.rigid_contact_force_eval_compact_blob(
            jrb.blobify_slot_scene(jscene), jscheme._cell_cfg, kernel,
            params, 1e-4, 64)
    cfg = tslab.make_slab_config(tscene, _port_cfg(jscheme._cell_cfg), P)
    mesh = make_mesh(P, [CPU] * P)
    parts = tslab.shard_slab_scene(tslab.slab_decompose(tscene, cfg), mesh)
    assert "slot_blob" in parts[0]
    with pytest.raises(ValueError, match="spill"):
        tslab.make_slab_step(tscheme, parts, mesh, cfg)


def test_dem_slab_steps_on_a_classic_base_match_single_device():
    jscheme, jscene = _wide_grain_scene()
    cutoff = 2.0 * float(np.asarray(jscene.rad_s).max())
    jscheme._cell_cfg = _classic(jscene, cutoff, cell_factor=4.0,
                                 cell_chunk=64)
    steps, dt = 3, 1e-5
    jstep = jscheme.make_step(jscene)
    js = jscene
    for _ in range(steps):
        js = jstep(js, jnp.asarray(dt))
    tscheme = DEMScheme(["grains"], ["floor"], kn=1e5, en=0.5, gy=-9.81,
                        dim=2)
    tscene = tslab.attach_gids(_port64(jscene))
    cfg = tslab.make_slab_config(tscene, _port_cfg(jscheme._cell_cfg), P)
    assert not cfg.base.spill
    mesh = make_mesh(P, [CPU] * P)
    parts = tslab.shard_slab_scene(tslab.slab_decompose(tscene, cfg), mesh)
    step = tslab.make_slab_dem_step(tscheme, parts, mesh, cfg, tscene.n)
    for _ in range(steps):
        parts = step(parts, dt)
        assert sum(int(p.total_tng_contacts.sum()) for p in parts) > 0
    g = tslab.gather_slab_scene(parts)
    assert not bool(g.nbr_overflow) and not bool(js.nbr_overflow)
    _assert_matches_reference(g, js)


@pytest.fixture(scope="module")
def classic_tank():
    jsch, jscene = _tank_scene()
    tsch, tscene = port_twin(jsch, jscene, torch.float64)
    classic = _classic(jscene, jsch._cell_cfg.cutoff, occupancy_safety=2.6,
                       cell_chunk=64)
    jsch._cell_cfg = _slab_base(classic, X0, NX)
    tsch._cell_cfg = _port_cfg(jsch._cell_cfg)
    cfg = tslab.make_slab_config(tscene, tsch._cell_cfg, P)
    assert cfg.slab_cells == 5 and not cfg.base.spill
    return jsch, jscene, tsch, tscene, cfg


@pytest.mark.parametrize("ordering", ["kdk", "kdkf"])
def test_coupling_slab_steps_on_a_classic_base_match_single_device(
        classic_tank, ordering):
    jsch, jscene, tsch, tscene, cfg = classic_tank
    steps, dt = 3, 1e-4
    jsch.gtvf_ordering = tsch.gtvf_ordering = ordering
    jstep = jsch.make_step(jscene)
    js = jscene
    for _ in range(steps):
        js = jstep(js, jnp.asarray(dt))
    parts, mesh = _parts(tscene, cfg)
    step = tslab.make_slab_coupling_step(tsch, parts, mesh, cfg)
    for _ in range(steps):
        parts = step(parts, dt)
    g = tslab.gather_slab_scene(parts)
    assert not bool(g.nbr_overflow) and not bool(js.nbr_overflow)
    assert float(g.overlap.max()) > 0
    assert float(np.abs(np.asarray(js.fx)).max()) > 0
    ks, kr = _match_xy(g, js)
    for k in FIELDS:
        np.testing.assert_allclose(g[k].numpy()[ks], np.asarray(js[k])[kr],
                                   rtol=0, atol=2e-8, err_msg=k)
    np.testing.assert_allclose(g.force.numpy(), np.asarray(js.force),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(g.xcm.numpy(), np.asarray(js.xcm), rtol=0,
                               atol=1e-9)
