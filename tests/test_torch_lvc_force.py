"""Port vs reference: the DEM scheme with ``contact_model="LVCForce"``.

The scene of ``tests/test_dem_cell.py``'s LVCForce trajectory test (a
jittered block of grains over a floor, seeded random velocities and
spins) is built and set up by both packages: the set-up state (the
tangential-force tables ``tng_fx/fy/fz`` in place of the displacement
springs) and the LVCForce grid (the cubic spline's support 2 max(h),
one lane width of 16) are equal.  Then 25 float64 steps of the port's
step against the reference's cell-engine step (``lvc_force_cell``):
positions, velocities, spins, forces and torques at rtol 1e-10, atol
1e-10 x max(|field|, 1) (the two sides sum the pairs in other orders);
the contact tables' partner indices, dem ids and live counts bit for
bit (both grids list candidates in the same order, so new contacts take
the same slots) and their force springs at the same tolerance.
``--contact-model LVCForce`` is parsed as the reference parses it in
``test_torch_application.test_scheme_chooser_parses_the_reference_options``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.models.dem import DEMScheme as JDEMScheme
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from rigid_body_2d_3d_pysph_tpu_torch.models import DEMScheme
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group as tmake_group, build_scene as tbuild_scene)

CPU = torch.device("cpu")
RTOL = 1e-10
N_STEPS = 25
DT = 1e-5
TRAJ = ("x", "y", "u", "v", "wz", "fx", "fy", "torz")
TABLES = ("tng_idx", "tng_idx_dem_id", "total_tng_contacts")
SPRINGS = ("tng_fx", "tng_fy", "tng_fz")


def _scene(make_group, build_scene, scheme_cls, **build_kw):
    """``test_dem_cell.test_dem_cell_lvc_force_trajectory_matches``'s
    grains and floor with either package, set up under LVCForce."""
    rng = np.random.default_rng(99)
    rad = 0.05
    nx_, ny_ = 12, 6
    gx_, gy_ = np.meshgrid(np.arange(nx_) * 2.05 * rad,
                           np.arange(ny_) * 2.05 * rad)
    x = gx_.ravel() + rng.uniform(-0.2 * rad, 0.2 * rad, gx_.size)
    y = gy_.ravel() + 0.9 * rad + rng.uniform(0, 0.2 * rad, gx_.size)
    m = 2600.0 * (2 * rad) ** 2
    xf = np.arange(-4, nx_ * 2 + 4) * rad
    yf = np.full(len(xf), -0.55 * rad)
    u, v, wz = (rng.uniform(-0.5, 0.5, gx_.size + len(xf)),
                rng.uniform(-0.5, 0.0, gx_.size + len(xf)),
                rng.uniform(-2, 2, gx_.size + len(xf)))
    grains = make_group("grains", x, y, m=m, h=1.2 * rad, rho=2600.0,
                        rad_s=rad, role="rigid",
                        body_id=np.arange(gx_.size, dtype=np.int32),
                        dem_id=0)
    floor = make_group("floor", xf, yf, m=m, h=1.2 * rad, rho=2600.0,
                       rad_s=rad / 2, role="boundary", dem_id=1)
    scene = build_scene([grains, floor], dim=2, total_no_bodies=2,
                        spacing0=2 * rad, **build_kw)
    scheme = scheme_cls(granular_particles=["grains"], boundaries=["floor"],
                        kn=1e5, en=0.5, gy=-9.81, dim=2,
                        contact_model="LVCForce")
    scene = scheme.setup(scene)
    return scheme, scene, (u, v, wz)


def test_lvc_force_steps_match_reference_cell_engine_f64():
    jsch, jscene, (u, v, wz) = _scene(jmake_group, jbuild_scene,
                                      JDEMScheme)
    assert jscene.x.dtype == jnp.float64
    jsch.engine = "cell"
    jscene = jscene.replace(u=jnp.asarray(u), v=jnp.asarray(v),
                            wz=jnp.asarray(wz))
    tsch, tscene, _ = _scene(tmake_group, tbuild_scene, DEMScheme,
                             device=CPU, dtype=torch.float64)
    tscene = tscene.replace(u=torch.as_tensor(u), v=torch.as_tensor(v),
                            wz=torch.as_tensor(wz))

    # the set-up: force springs, the same fields and values
    assert set(tscene.fields) == set(jscene.fields)
    assert "tng_fx" in tscene and "tng_x" not in tscene
    for k in sorted(tscene.fields):
        a, b = np.asarray(jscene[k]), tscene[k].numpy()
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)

    jstep = jsch.make_step(jscene)
    tstep = tsch.make_step(tscene)
    # the reference's grid for this model, built by the port
    assert dataclasses.asdict(tsch._cell_cfg) == {
        f.name: getattr(jsch._cell_cfg, f.name)
        for f in dataclasses.fields(tcell.CellGridConfig)}
    for _ in range(N_STEPS):
        jscene = jstep(jscene, jnp.asarray(DT))
        tscene = tstep(tscene, DT)
        assert int(tscene.total_tng_contacts.sum()) > 0
        assert int(tscene.n_gated) >= int(tscene.total_tng_contacts.sum())
    assert not bool(np.asarray(jscene.nbr_overflow))
    assert not bool(tscene.nbr_overflow)
    for k in TRAJ + SPRINGS:
        a, b = np.asarray(jscene[k]), tscene[k].numpy()
        scale = max(float(np.abs(a).max()), 1.0)
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL * scale,
                                   err_msg=k)
    for k in TABLES:
        np.testing.assert_array_equal(tscene[k].numpy(),
                                      np.asarray(jscene[k]), err_msg=k)
    # the springs carried a history: some contact slipped or loaded
    assert float(np.abs(np.asarray(jscene.tng_fx)).max()) > 0
