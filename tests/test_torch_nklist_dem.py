"""The port's DEM scheme on the ``[N, K]`` list engine against the JAX
package's ``nklist`` DEM step.

Both contact models (LVCDisplacement, LVCForce) in 2D and 3D: a jittered
block of grains over a floor (``tests/test_dem_cell.py``'s scenes, seeded
random velocities and spins), set up by the JAX package and carried over
into the port; 10 float64 steps on both sides.  The contact tables'
partner indices, dem ids and live counts bit for bit on every row (both
lists hold the candidates in one order, so new contacts take the same
slots); the states, forces and torques at rtol 1e-10, atol 1e-10 x
max(|field|, 1), and so the springs of the grains' rows.  The static
floor's rows hold springs too, which nothing reads (the floor's force and
torque are zeroed): in 3D, floor particles a spacing apart touch with an
overlap of rounding size (1e-17), and those pairs' Coulomb slip test
sits on its threshold, where the two sides' last bits decide the branch;
those springs are held to be finite.  The list's cutoff is the cubic
spline's support, 2 max(h), on both sides.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.models.dem import DEMScheme as JDEMScheme
from rigid_body_2d_3d_pysph_tpu.state import make_group, build_scene

from rigid_body_2d_3d_pysph_tpu_torch.models import DEMScheme
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

CPU = torch.device("cpu")
RTOL = 1e-10
DT = 1e-5
TABLES = ("tng_idx", "tng_idx_dem_id", "total_tng_contacts")


def grain_scene(dim, contact_model="LVCDisplacement", seed=3):
    """``test_dem_cell._grain_scene`` (2D) / ``_grain_scene_3d`` (3D),
    set up by the JAX package under ``contact_model``: (JAX scheme, JAX
    scene, the port's scheme on the list engine, the port's scene)."""
    rng = np.random.default_rng(seed)
    rad = 0.05
    shape = (12, 6) if dim == 2 else (6, 4, 6)
    axes = np.meshgrid(*[np.arange(k) * 2.05 * rad for k in shape])
    n = axes[0].size
    x = axes[0].ravel() + rng.uniform(-0.2 * rad, 0.2 * rad, n)
    y = axes[1].ravel() + 0.9 * rad + rng.uniform(0, 0.2 * rad, n)
    z = (axes[2].ravel() + rng.uniform(-0.2 * rad, 0.2 * rad, n)
         if dim == 3 else None)
    m = 2600.0 * (2 * rad) ** dim
    xf = np.arange(-4, shape[0] * 2 + 4) * rad
    if dim == 3:
        xf, zf = (a.ravel() for a in np.meshgrid(
            xf, np.arange(-4, shape[2] * 2 + 4) * rad))
    else:
        zf = None
    yf = np.full(len(xf), -0.55 * rad)
    grains = make_group("grains", x, y, z=z, m=m, h=1.2 * rad, rho=2600.0,
                        rad_s=rad, role="rigid",
                        body_id=np.arange(n, dtype=np.int32), dem_id=0)
    floor = make_group("floor", xf, yf, z=zf, m=m, h=1.2 * rad, rho=2600.0,
                       rad_s=rad / 2, role="boundary", dem_id=1)
    scene = build_scene([grains, floor], dim=dim, total_no_bodies=2,
                        spacing0=2 * rad)
    kw = dict(granular_particles=["grains"], boundaries=["floor"], kn=1e5,
              en=0.5, gy=-9.81, dim=dim, contact_model=contact_model)
    jsch = JDEMScheme(**kw)
    jsch.engine = "nklist"
    scene = jsch.setup(scene)
    fdt = scene.x.dtype
    vel = dict(u=rng.uniform(-0.5, 0.5, scene.n),
               v=rng.uniform(-0.5, 0.0, scene.n))
    spins = ("wx", "wy", "wz") if dim == 3 else ("wz",)
    if dim == 3:
        vel["w"] = rng.uniform(-0.5, 0.5, scene.n)
    vel.update({k: rng.uniform(-2, 2, scene.n) for k in spins})
    jscene = scene.replace(**{k: jnp.asarray(v, fdt) for k, v in vel.items()})
    tsch = DEMScheme(**kw)
    tsch.engine = "nklist"
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    return jsch, jscene, tsch, scene_from_numpy(fields, jscene.meta, CPU,
                                                torch.float64)


def _close(a, b, what):
    a = np.asarray(a)
    scale = max(float(np.abs(a).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("dim", (2, 3))
@pytest.mark.parametrize("model", ("LVCDisplacement", "LVCForce"))
def test_list_dem_steps_match_jax_nklist_f64(model, dim):
    jsch, jscene, tsch, tscene = grain_scene(dim, model)
    jstep, tstep = jsch.make_step(jscene), tsch.make_step(tscene)
    assert tsch._nbr_cfg.__dict__ == jsch._nbr_cfg.__dict__
    assert tsch._nbr_cfg.cutoff == 2.0 * float(tscene.h.max())
    for _ in range(10):
        jscene = jstep(jscene, jnp.asarray(DT))
        tscene = tstep(tscene, DT)
    assert not bool(tscene.nbr_overflow)
    assert int(tscene.total_tng_contacts.sum()) > 0
    assert int(tscene.n_gated) > 0
    for k in TABLES:
        np.testing.assert_array_equal(tscene[k].numpy(),
                                      np.asarray(jscene[k]), err_msg=k)
    springs = tsch._springs()
    assert float(tscene[springs[0]].abs().max()) > 0
    keys = ("x", "y", "z", "u", "v", "w", "wx", "wy", "wz", "fx", "fy",
            "fz", "torx", "tory", "torz")
    for k in keys:
        _close(jscene[k], tscene[k].numpy(), k)
    g = tscene.meta.group("grains")
    for k in springs:
        _close(np.asarray(jscene[k])[g.start:g.stop],
               tscene[k].numpy()[g.start:g.stop], k)
        assert bool(torch.isfinite(tscene[k]).all()), k


def test_grids_size_from_the_kernel():
    """The LVCForce grid and the list take their cutoff from the
    kernel's support (the cubic's 2 max(h): the numbers of the literal
    they replace); the spill grid keeps the contact radius 2 max(rad_s)."""
    _, _, tsch, tscene = grain_scene(2, "LVCForce")
    h = float(tscene.h.max())
    assert tsch.cell_config(tscene).radius == 2.0 * h
    assert tsch.list_config(tscene, 2.0).cutoff == 2.0 * h
    tsch.kernel_name = "quintic"
    tsch.refresh_configs(tscene)
    assert tsch.cell_config(tscene).radius == 3.0 * h
    assert tsch.list_config(tscene, tsch._kernel_radius()).cutoff == 3.0 * h
    _, _, dsch, dscene = grain_scene(2, "LVCDisplacement")
    dsch.engine = "cell"
    assert dsch.cell_config(dscene).radius == 2.0 * float(dscene.rad_s.max())


def test_slab_steps_refuse_the_list_engine():
    from rigid_body_2d_3d_pysph_tpu_torch.models import RigidBody2DScheme
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab

    _, _, dsch, dscene = grain_scene(2)
    with pytest.raises(ValueError, match="cell engine"):
        slab.make_slab_dem_step(dsch, [dscene], None, None, dscene.n)
    rsch = RigidBody2DScheme(["grains"], ["floor"], dim=2)
    rsch.engine = "nklist"
    with pytest.raises(ValueError, match="cell engine"):
        slab.make_slab_step(rsch, [dscene], None, None)
