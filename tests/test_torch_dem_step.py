"""Port vs reference: the DEM scheme's setup and step end to end.

* Setup (float64): ``moi`` and the per-entity material vectors equal the
  reference scheme's.
* 25 float64 steps of the port's 2D ``DEMScheme`` (spill grid; on CPU
  tensors its kernels run their plain versions) against the reference
  scheme on its XLA cell engine, on ``tests/test_dem_cell.py``'s jittered
  grain block over a floor; atol 1e-9 as ``tests/test_dem_cell.py``.
  The two grids order candidates differently, so the grains' contact
  tables are compared as (idx, dem) -> spring maps.
* A 3D float64 run (10 steps) on ``tests/test_dem_cell.py``'s 3D block,
  the same way, and 10 2D steps on the row-window grid.
* Every step has live table entries, so no run is vacuous.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rigid_body_2d_3d_pysph_tpu.models.dem import DEMScheme as JDEMScheme
from rigid_body_2d_3d_pysph_tpu.state import make_group as jmake_group
from rigid_body_2d_3d_pysph_tpu.state import build_scene as jbuild_scene

from rigid_body_2d_3d_pysph_tpu_torch.models import DEMScheme
from rigid_body_2d_3d_pysph_tpu_torch.state import make_group, build_scene
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_dem_cell import _grain_scene, _grain_scene_3d
from test_pallas_dem import _table_map

CPU = torch.device("cpu")
TRAJ_2D = ("x", "y", "u", "v", "wz", "fx", "fy", "torz")
TRAJ_3D = ("x", "y", "z", "u", "v", "w", "wx", "wy", "wz", "fx", "fy", "fz",
           "torx", "tory", "torz")


def _groups(make, rad=0.05):
    x = np.arange(6) * 1.9 * rad
    grains = make("grains", x, np.full(6, rad), m=2.0, h=1.2 * rad,
                  rho=2600.0, rad_s=np.linspace(rad, 1.2 * rad, 6),
                  role="rigid", body_id=np.arange(6, dtype=np.int32),
                  dem_id=np.arange(6, dtype=np.int32) % 2)
    floor = make("floor", x, np.zeros(6), m=3.0, h=1.2 * rad, rho=2600.0,
                 rad_s=rad / 2, role="boundary", dem_id=2)
    return [grains, floor]


def test_setup_matches_reference_f64():
    kw = dict(kn=2e5, en=0.3, mu=0.4, dim=2, gy=-9.81,
              max_tng_contacts_limit=5)
    mats = dict(dem_kn=[1e5, 2e5, 3e5], dem_mu=0.25)
    js = jbuild_scene(_groups(jmake_group), dim=2, total_no_bodies=3,
                      spacing0=0.1)
    js = JDEMScheme(["grains"], ["floor"], **kw).setup(js, **mats)
    ts = build_scene(_groups(make_group), dim=2, total_no_bodies=3,
                     spacing0=0.1, device=CPU, dtype=torch.float64)
    ts = DEMScheme(["grains"], ["floor"], **kw).setup(ts, **mats)
    for k in ("moi", "dem_kn", "dem_kt", "dem_alpha", "dem_mu"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-14, atol=0, err_msg=k)
    for k in ("tng_idx", "tng_idx_dem_id", "tng_x", "total_tng_contacts"):
        assert ts[k].shape == tuple(js[k].shape), k
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))


def _run(jscheme, jscene, tscheme, n_steps, names):
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    tscene = scene_from_numpy(fields, jscene.meta, CPU, torch.float64)
    jscheme.engine = "cell"
    jstep = jscheme.make_step(jscene)
    tstep = tscheme.make_step(tscene)
    dt = 1e-5
    for _ in range(n_steps):
        jscene = jstep(jscene, jnp.asarray(dt))
        tscene = tstep(tscene, dt)
        assert int(tscene.total_tng_contacts.sum()) > 0
        assert int(tscene.n_gated) >= int(tscene.total_tng_contacts.sum())
    assert not bool(np.asarray(jscene.nbr_overflow))
    assert not bool(tscene.nbr_overflow)
    for k in names:
        np.testing.assert_allclose(tscene[k].numpy(), np.asarray(jscene[k]),
                                   rtol=0, atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(tscene.total_tng_contacts.numpy(),
                                  np.asarray(jscene.total_tng_contacts))
    tabs = ("tng_idx", "tng_idx_dem_id", "tng_x", "tng_y", "tng_z")
    m_j = _table_map(*(jscene[k] for k in tabs))
    m_t = _table_map(*(tscene[k] for k in tabs))
    # granular rows only: a static boundary row carries no force, and
    # where its table overflows (a 3D floor particle touches more floor
    # and grain neighbours than it has slots) which contacts keep a slot
    # follows the grid's candidate order
    g = jscene.meta.group("grains")
    for r, (a, b) in enumerate(zip(m_j[g.start:g.stop],
                                   m_t[g.start:g.stop])):
        assert a.keys() == b.keys(), f"row {r} contacts"
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-9,
                                       err_msg=f"row {r} pair {k}")


def test_2d_steps_match_reference_cell_engine_f64():
    jscheme, jscene = _grain_scene()
    assert jscene.x.dtype == jnp.float64
    tscheme = DEMScheme(["grains"], ["floor"], kn=1e5, en=0.5, gy=-9.81,
                        dim=2)
    _run(jscheme, jscene, tscheme, 25, TRAJ_2D)


def test_2d_rowwin_steps_match_reference_cell_engine_f64():
    jscheme, jscene = _grain_scene()
    tscheme = DEMScheme(["grains"], ["floor"], kn=1e5, en=0.5, gy=-9.81,
                        dim=2, dem_grid="rowwin")
    _run(jscheme, jscene, tscheme, 10, TRAJ_2D)


def test_3d_steps_match_reference_cell_engine_f64():
    jscheme, jscene = _grain_scene_3d()
    tscheme = DEMScheme(["grains"], ["floor"], kn=1e5, en=0.5, gy=-9.81,
                        dim=3)
    _run(jscheme, jscene, tscheme, 10, TRAJ_3D)
    assert tscheme._cell_cfg.M == 8


def test_scheme_rejects_what_is_not_ported():
    """Both contact models are ported (LVCForce: ``test_torch_lvc_force``);
    the ``[N, K]`` list grid and unknown models are not."""
    assert DEMScheme(["g"], [], contact_model="LVCForce").contact_model \
        == "LVCForce"
    with pytest.raises(ValueError):
        DEMScheme(["g"], [], contact_model="Hertz")
    with pytest.raises(ValueError):
        DEMScheme(["g"], [], dem_grid="nklist")
