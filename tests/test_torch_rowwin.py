"""Port vs reference: the row-window grid and the row-window DEM pass.

* The port's ``build_row_window_grid`` equals the JAX build exactly
  (configuration, run table, lane map, window tables, sorted order) on
  the ``tests/test_rowwin.py`` scenes, 2D and 3D, clumpy and not, and
  flags a particle that leaves the domain.
* The port's row-window DEM pass (on CPU tensors the kernel wrappers run
  their plain versions) against the JAX prune + cell engine over 5
  coupled f32 iterations.  The two grids order candidates differently,
  so tables are compared as (idx, dem) -> spring maps and the sums at
  f32 summation-order tolerance, as ``tests/test_pallas_dem.py``'s
  row-window test does: sums rtol 2e-4 / atol 5e-3, springs rtol 1e-3 /
  atol 1e-8, live counts exact.
* The port's row-window interface (no JAX): a DEM step on the row-window
  grid expands one pack, of the 13 source fields, and the pass reads and
  writes the contact table per particle, a particle with no lane getting
  zero sums and an empty table.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import dem as jdem
from rigid_body_2d_3d_pysph_tpu.ops import dem_cell as jdc
from rigid_body_2d_3d_pysph_tpu.ops import rowwin as jrw

from rigid_body_2d_3d_pysph_tpu_torch.models import DEMScheme
from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_cell as tdc
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
from rigid_body_2d_3d_pysph_tpu_torch.ops import rowwin as trw
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_pallas_dem import _grain_scene_f32, _table_map
from test_rowwin import _scene

CPU = torch.device("cpu")


def _builds(x, y, z, cutoff, dim, active=None):
    n = len(x)
    jcfg = jrw.rowwin_config_from_positions(x, y, z, cutoff, dim)
    tcfg = trw.rowwin_config_from_positions(x, y, z, cutoff, dim)
    for f in dataclasses.fields(jcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    act = np.ones(n, bool) if active is None else active
    pay = np.arange(n, dtype=np.float32)
    jg, jpt = jax.jit(lambda x, y, z, a, p: jrw.build_row_window_grid(
        x, y, z, a, jcfg, [p]))(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(z), jnp.asarray(act),
                                jnp.asarray(pay))
    t = lambda a: torch.as_tensor(a)
    tg, tpt = trw.build_row_window_grid(t(x), t(y), t(z), t(act), tcfg,
                                        [t(pay)])
    return (jg, jpt), (tg, tpt)


@pytest.mark.parametrize("dim,clumpy", [(2, False), (2, True),
                                        (3, False), (3, True)])
def test_row_window_grid_matches_reference(dim, clumpy):
    x, y, z = _scene(dim, clumpy=clumpy)
    (jg, jpt), (tg, tpt) = _builds(x, y, z, 0.06, dim)
    eq = np.testing.assert_array_equal
    for k in ("nbr_runs", "run_cnt", "dense_pos"):
        eq(getattr(tg, k).numpy(), np.asarray(getattr(jg, k)), err_msg=k)
    assert int(tg.n_occupied) == int(jg.n_occupied) > 0
    assert bool(tg.overflow) == bool(jg.overflow) is False
    for k in ("base", "cnt", "slot_cid", "sorted_pid"):
        eq(getattr(tpt, k).numpy(), np.asarray(getattr(jpt, k)), err_msg=k)
    assert int(tpt.n_valid) == int(jpt.n_valid)
    eq(tpt.sorted_fields.numpy()[0], np.asarray(jpt.sorted_fields[0]))


def test_row_window_grid_inactive_and_domain_exit():
    x, y, z = _scene(2, n=64, seed=3)
    act = np.arange(len(x)) < 40
    (jg, jpt), (tg, tpt) = _builds(x, y, z, 0.08, 2, act)
    np.testing.assert_array_equal(tg.dense_pos.numpy(),
                                  np.asarray(jg.dense_pos))
    assert int(tpt.n_valid) == int(jpt.n_valid) == 40

    x, y, z = _scene(2, n=32, seed=4)
    cfg = trw.rowwin_config_from_positions(x, y, z, 0.08, 2)
    x2 = x.copy()
    x2[5] = x.max() + 10.0                     # outside the domain
    t = lambda a: torch.as_tensor(a)
    tg, _ = trw.build_row_window_grid(t(x2), t(y), t(z),
                                      torch.ones(len(x), dtype=torch.bool),
                                      cfg, [t(x2)])
    jg, _ = jrw.build_row_window_grid(
        jnp.asarray(x2), jnp.asarray(y), jnp.asarray(z),
        jnp.ones(len(x), bool), jrw.rowwin_config_from_positions(
            x, y, z, 0.08, 2), [jnp.asarray(x2)])
    assert bool(tg.overflow) and bool(jg.overflow)
    np.testing.assert_array_equal(tg.dense_pos.numpy(),
                                  np.asarray(jg.dense_pos))


def test_rowwin_pass_matches_reference_cell_engine():
    _, scene = _grain_scene_f32()
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float32)
    cutoff = 2.0 * float(fields["rad_s"].max())
    jcfg = jcell.config_from_positions(fields["x"], fields["y"],
                                       fields["z"], cutoff, 2, cell_chunk=16,
                                       cell_factor=2.0)
    tcfg = trw.rowwin_config_from_positions(fields["x"], fields["y"],
                                            fields["z"], cutoff, 2)
    dt = np.float32(1e-5)

    @jax.jit
    def eval_cell(scene):
        tabs = jdem.prune_contact_table(
            scene, scene.tng_idx, scene.tng_idx_dem_id,
            scene.tng_x, scene.tng_y, scene.tng_z)[:5]
        grid = jcell.build_cell_grid(scene.x, scene.y, scene.z,
                                     scene.active, jcfg)
        return grid.overflow, jdc.lvc_displacement_cell(
            scene, grid, jcfg, jnp.float32(dt), *tabs)

    def advance_j(s, out):
        u = s.u + dt * (out[0] / s.m)
        v = s.v + dt * (out[1] / s.m - 9.81)
        return s.replace(u=u, v=v, x=s.x + dt * u, y=s.y + dt * v,
                         tng_idx=out[6], tng_idx_dem_id=out[7],
                         tng_x=out[8], tng_y=out[9], tng_z=out[10])

    def advance_t(s, r):
        u = s.u + float(dt) * (r.fx / s.m)
        v = s.v + float(dt) * (r.fy / s.m - 9.81)
        return s.replace(u=u, v=v, x=s.x + float(dt) * u,
                         y=s.y + float(dt) * v, tng_idx=r.tng_idx,
                         tng_idx_dem_id=r.tng_dem, tng_x=r.tng_x,
                         tng_y=r.tng_y, tng_z=r.tng_z)

    launches = dict(_build.LAUNCHES)
    for it in range(5):
        ovf, out_c = eval_cell(scene)
        r = tdk.lvc_displacement_rowwin_kernel(
            tscene, tcfg, float(dt), tscene.tng_idx,
            tscene.tng_idx_dem_id, tscene.tng_x, tscene.tng_y, tscene.tng_z)
        assert not bool(ovf) and not bool(r.overflow)
        for i, nm in enumerate(["fx", "fy", "fz", "torx", "tory", "torz"]):
            np.testing.assert_allclose(
                getattr(r, nm).numpy(), np.asarray(out_c[i]), rtol=2e-4,
                atol=5e-3, err_msg=f"iter {it} {nm}")
        m_c = _table_map(*out_c[6:11])
        m_t = _table_map(r.tng_idx, r.tng_dem, r.tng_x, r.tng_y, r.tng_z)
        for row, (a, b) in enumerate(zip(m_c, m_t)):
            assert a.keys() == b.keys(), f"iter {it} row {row} contacts"
            for k in a:
                np.testing.assert_allclose(
                    b[k], a[k], rtol=1e-3, atol=1e-8,
                    err_msg=f"iter {it} row {row} pair {k}")
        np.testing.assert_array_equal(r.count.numpy(), np.asarray(out_c[11]))
        assert int(r.count.sum()) > 0 and int(r.n_gated.sum()) > 0
        scene, tscene = advance_j(scene, out_c), advance_t(tscene, r)
    assert _build.LAUNCHES == launches   # CPU tensors: no kernel launched


def _port_grains(n_side=10):
    """A 2D block of grains spaced 0.995 of a diameter over a floor (the
    port's scene, float32 on the CPU), with seeded random velocities, and
    the row-window scheme set up on it."""
    r, s = 1e-3, 1.99e-3
    ax = np.arange(n_side) * s
    xg, yg = (a.ravel() for a in np.meshgrid(ax, ax))
    xf = np.arange(-4, n_side + 4) * 2 * r
    m = 2600.0 * r**2
    grains = make_group("sand", xg, yg + 0.99 * r, m=m, h=2 * r, rho=2600.0,
                        rad_s=r, role=ROLE_RIGID, dem_id=0)
    floor = make_group("floor", xf, np.full(len(xf), -r), m=m, h=2 * r,
                       rho=2600.0, rad_s=r, role=ROLE_BOUNDARY, dem_id=1)
    scene = build_scene([grains, floor], dim=2, total_no_bodies=2,
                        spacing0=s, device=CPU, dtype=torch.float32)
    scheme = DEMScheme(["sand"], ["floor"], dim=2, gy=-9.81,
                       max_tng_contacts_limit=8, dem_grid="rowwin")
    scene = scheme.setup(scene)
    rng = np.random.default_rng(5)
    vel = lambda a: torch.as_tensor(rng.uniform(-a, a, scene.n),
                                    dtype=torch.float32)
    return scheme, scene.replace(u=vel(0.05), v=vel(0.05), wz=vel(50.0))


def test_rowwin_step_expands_one_pack_of_the_source_fields(monkeypatch):
    scheme, scene = _port_grains()
    cfg = scheme.rowwin_config(scene)
    packs = []
    expand = tdk.expand_slots

    def counted(sorted_fields, base, cnt, sent, M):
        packs.append((sorted_fields.shape[0], M))
        return expand(sorted_fields, base, cnt, sent, M)

    monkeypatch.setattr(tdk, "expand_slots", counted)
    step = scheme.make_step(scene)
    for n in range(1, 4):
        scene = step(scene, 1e-5)
        assert len(packs) == n
    assert packs == [(tdc.NF, cfg.M)] * 3
    assert not bool(scene.nbr_overflow)
    assert int(scene.total_tng_contacts.sum()) > 0


def test_rowwin_reference_writes_the_table_per_particle():
    scheme, scene = _port_grains()
    cfg = scheme.rowwin_config(scene)
    p = tdk.lvc_displacement_rowwin_kernel(
        scene, cfg, 1e-5, scene.tng_idx, scene.tng_idx_dem_id, scene.tng_x,
        scene.tng_y, scene.tng_z)
    tables = (p.tng_idx, p.tng_dem, p.tng_x, p.tng_y, p.tng_z)
    # grain 5 leaves the domain: the grid flags it and gives it no lane
    gone = 5
    assert int((p.tng_idx[gone] >= 0).sum()) > 0
    x = scene.x.clone()
    x[gone] = x.max() + 10.0
    grid, pt = trw.build_row_window_grid(x, scene.y, scene.z, scene.active,
                                         cfg, tdk.dem_payload(
                                             scene.replace(x=x)))
    assert bool(grid.overflow)
    assert int(grid.dense_pos[gone]) == cfg.NC_max * cfg.M
    dfs = tdk.expand_slots(pt.sorted_fields, pt.base, pt.cnt,
                           torch.tensor(tdc.SENT), cfg.M)
    args = (dfs, grid.nbr_runs, grid.run_cnt, *tables,
            tdk.material_table(scene), 1e-5, cfg)
    out = tdk.dem_rowwin_sums_reference(*args)
    n, L = scene.n, tables[0].shape[1]
    assert [tuple(t.shape) for t in out] == [(n, 8)] + [(n, L)] * 5
    assert out[1].dtype == out[2].dtype == torch.int32
    assert bool((out[0][gone] == 0).all())
    assert bool((out[1][gone] == -1).all()) and bool((out[2][gone] == -1).all())
    assert all(bool((t[gone] == 0).all()) for t in out[3:])
    # every other grain keeps its contacts, and the wrapper on CPU tensors
    # is the plain version
    assert int(out[0][:, 6].sum()) > 0
    for a, b in zip(tdk.dem_rowwin_sums(*args), out):
        assert torch.equal(a, b)
