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
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import dem as jdem
from rigid_body_2d_3d_pysph_tpu.ops import dem_cell as jdc
from rigid_body_2d_3d_pysph_tpu.ops import rowwin as jrw

from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
from rigid_body_2d_3d_pysph_tpu_torch.ops import rowwin as trw
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
