"""The port's rigid-fluid coupling on the ``[N, K]`` list engine against
the JAX package's ``nklist`` engine, and against the port's cell step.

* Every list fluid pass of ``ops/fluid.py`` (continuity and EDAC with
  their FSI forms, Tait, the Adami wall velocity and pressure, pressure
  gradient, artificial viscosity, both FSI forces, XSPH) against JAX in
  float64 on seeded random velocities and pressures; rtol 1e-12.
* kdk and reference, 5 float64 steps against JAX's ``_make_step_nklist``
  at rtol 1e-10 (atol 1e-10 x max(|field|, 1)) with the box sliding on
  the tank floor (contact springs live), EDAC; and kdk with Tait.  Both
  sides start from the JAX package's list set-up state.
* The port's list step against its own cell step (the kernels' plain
  versions) at 1e-8 on the tank with the box in its surface (5 steps,
  both orderings), as the JAX package holds its two engines
  (``tests/test_fluid_coupling.py``).
* kdkf on the list engine is kdk; the RK2 stepper on it raises; a slab
  step refuses a list scheme.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu import geom as jgeom
from rigid_body_2d_3d_pysph_tpu.models.rigid_fluid_coupling import (
    RigidFluidCouplingScheme as JRFC)
from rigid_body_2d_3d_pysph_tpu.ops import fluid as jfops
from rigid_body_2d_3d_pysph_tpu.ops import neighbors as jnb
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline as JQuintic
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from rigid_body_2d_3d_pysph_tpu_torch.models import (
    RigidFluidCouplingScheme as TRFC)
from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid as tfops
from rigid_body_2d_3d_pysph_tpu_torch.ops import neighbors as tnb
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import (
    QuinticSpline as TQuintic)
from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as tslab
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_torch_coupling_step import (
    BODY, DT_CONTACT, FLUID, SLOTS, _compare, _shadow_fields, _velocities,
    coupling_scene)

CPU = torch.device("cpu")
SLIDE = [[0.05, -0.02, 0.0]]


def _jax_scene(floor, engine="nklist"):
    """``coupling_scene``'s tank, fluid and box set up by the JAX package
    on ``engine``, with the box's displaced-fluid shadow fields."""
    jsch, scene, dx, rho0 = coupling_scene(jmake_group, jbuild_scene, jgeom,
                                           JRFC, True, floor=floor)
    jsch.engine = engine
    scene = jsch.setup(scene)
    m_fsi, rho_fsi = _shadow_fields(scene, rho0, dx)
    return jsch, scene.replace(m_fsi=jnp.asarray(m_fsi),
                               rho_fsi=jnp.asarray(rho_fsi))


def _twin(jsch, jscene, engine="nklist"):
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    tscene = scene_from_numpy(fields, jscene.meta, CPU, torch.float64)
    tsch = TRFC(jsch.fluids, jsch.boundaries, jsch.rigid_bodies, jsch.dim,
                jsch.rho0, jsch.p0, jsch.c0, jsch.h, jsch.nu, kr=jsch.kr,
                kf=jsch.kf, fric_coeff=jsch.fric_coeff, gamma=jsch.gamma,
                gx=jsch.gx, gy=jsch.gy, gz=jsch.gz, alpha=jsch.fluid_alpha)
    tsch.edac, tsch.gtvf_ordering = jsch.edac, jsch.gtvf_ordering
    tsch.engine = engine
    return tsch, tscene


def _close(a, b, what, rtol=1e-12):
    a = np.asarray(a)
    scale = max(float(np.abs(a).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(b.numpy(), a, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def test_list_fluid_passes_match_jax_f64():
    jsch, jscene = _jax_scene(floor=False)
    rng = np.random.default_rng(21)
    n = jscene.n
    rand = {k: rng.uniform(-a, a, n) for k, a in (
        ("u", 0.3), ("v", 0.3), ("p", 5.0), ("p_fsi", 5.0), ("au", 1.0),
        ("av", 1.0))}
    rand["rho"] = 1.0 + rng.uniform(-0.02, 0.02, n)
    jscene = jscene.replace(**{k: jnp.asarray(v) for k, v in rand.items()})
    _, tscene = _twin(jsch, jscene)
    jcfg = jsch._nbr_cfg
    tcfg = tnb.NeighborConfig(**jcfg.__dict__)
    jl = jnb.build_neighbors(jscene.x, jscene.y, jscene.z, jscene.active,
                             jcfg)
    tl = tnb.build_neighbors(tscene.x, tscene.y, tscene.z, tscene.active,
                             tcfg)
    kj, kt = JQuintic(dim=2), TQuintic(dim=2)

    def masks(s, conv):
        fl = s.is_fluid & s.active
        bd = s.is_static_boundary & s.active
        rb = s.is_rigid & s.active
        return fl, bd, rb, fl | bd

    mj, mt = masks(jscene, jnp), masks(tscene, torch)
    calls = {
        "continuity": lambda f, s, l, k, m: f.continuity(s, l, k, m[0],
                                                         m[3]),
        "continuity_fsi": lambda f, s, l, k, m: f.continuity(
            s, l, k, m[0], m[2], fsi=True),
        "edac": lambda f, s, l, k, m: f.edac(s, l, k, 0.05, 4.0, m[0],
                                             m[3]),
        "edac_fsi": lambda f, s, l, k, m: f.edac(s, l, k, 0.05, 4.0, m[0],
                                                 m[2], fsi=True),
        "tait": lambda f, s, l, k, m: f.tait_eos(s, 1.0, 4.0, 7.0, m[0]),
        "wall_velocity": lambda f, s, l, k, m: f.set_wall_velocity(
            s, l, k, m[1], m[0]),
        "wall_pressure": lambda f, s, l, k, m: tuple(
            f.solid_wall_pressure_bc(s, l, k, 0.0, -1.0, 0.0, m[d], m[0],
                                     f.set_wall_velocity(s, l, k, m[d],
                                                         m[0])[-1], c)
            for d, c in ((1, True), (2, False))),
        "pressure_gradient": lambda f, s, l, k, m:
            f.momentum_pressure_gradient(s, l, k, m[0], m[3]),
        "viscosity": lambda f, s, l, k, m: f.momentum_artificial_viscosity(
            s, l, k, 0.1, 4.0, m[0], m[0]),
        "fluid_from_rigid": lambda f, s, l, k, m:
            f.force_on_fluid_due_to_rigid_body(s, l, k, m[0], m[2]),
        "rigid_from_fluid": lambda f, s, l, k, m:
            f.force_on_rigid_body_due_to_fluid(s, l, k, m[2], m[0]),
        "xsph": lambda f, s, l, k, m: f.xsph_correction(s, l, k, 0.5, m[0],
                                                        m[0]),
    }
    for name, fn in calls.items():
        a = fn(jfops, jscene, jl, kj, mj)
        b = fn(tfops, tscene, tl, kt, mt)
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{name} {i}")
        assert max(float(y.abs().max()) for y in b) > 0, name


def _steps(jsch, jscene, tsch, tscene, n, dt):
    jstep, tstep = jsch.make_step(jscene), tsch.make_step(tscene)
    for _ in range(n):
        jscene = jstep(jscene, jnp.asarray(dt))
        tscene = tstep(tscene, dt)
    return jscene, tscene


@pytest.mark.parametrize("case", ("kdk", "reference", "kdk-tait"))
def test_list_steps_match_jax_nklist_f64(case):
    jsch, jscene = _jax_scene(floor=True)
    jsch.gtvf_ordering = case.split("-")[0]
    jsch.edac = case != "kdk-tait"
    jscene = _velocities(jscene, 7, 0.05).replace(vcm=jnp.asarray(SLIDE))
    tsch, tscene = _twin(jsch, jscene)
    jend, tend = _steps(jsch, jscene, tsch, tscene, 5, DT_CONTACT)
    assert tsch._nbr_cfg.__dict__ == jsch._nbr_cfg.__dict__
    assert float(np.asarray(jend.overlap).max()) > 0
    assert float(np.abs(np.asarray(jend.delta_lt_x)).max()) > 0
    assert float(np.abs(np.asarray(jend.fx)).max()) > 0   # FSI is on
    names = FLUID + BODY + SLOTS + (("cs",) if not jsch.edac else ())
    _compare(jend, tend, names, rtol=1e-10)


@pytest.mark.parametrize("ordering", ("kdk", "reference"))
def test_list_step_matches_port_cell_step(ordering):
    jsch, jscene = _jax_scene(floor=False)
    jsch.gtvf_ordering = ordering
    lsch, lscene = _twin(jsch, jscene, "nklist")
    csch, cscene = _twin(jsch, jscene, "cell")
    lstep, cstep = lsch.make_step(lscene), csch.make_step(cscene)
    for _ in range(5):
        lscene = lstep(lscene, 1e-4)
        cscene = cstep(cscene, 1e-4)
    assert not bool(lscene.nbr_overflow) and not bool(cscene.nbr_overflow)
    for k in ("x", "y", "u", "v", "rho", "p", "p_fsi", "arho", "au", "av",
              "fx", "fy"):
        np.testing.assert_allclose(lscene[k].numpy(), cscene[k].numpy(),
                                   rtol=1e-8, atol=1e-8, err_msg=k)
    np.testing.assert_allclose(lscene.force.numpy(), cscene.force.numpy(),
                               atol=1e-7)
    assert float(lscene.fx.abs().max()) > 0


def test_kdkf_runs_kdk_and_the_guards():
    jsch, jscene = _jax_scene(floor=True)
    jscene = _velocities(jscene, 7, 0.05).replace(vcm=jnp.asarray(SLIDE))
    a_sch, scene = _twin(jsch, jscene)
    b_sch, _ = _twin(jsch, jscene)
    a_sch.gtvf_ordering, b_sch.gtvf_ordering = "kdkf", "kdk"
    a, b = a_sch.make_step(scene), b_sch.make_step(scene)
    sa = sb = scene
    for _ in range(3):
        sa, sb = a(sa, DT_CONTACT), b(sb, DT_CONTACT)
    assert set(sa.fields) == set(sb.fields)
    for k in sa.fields:
        assert torch.equal(sa[k], sb[k]), k

    a_sch.fluid_stepper, a_sch.edac = "rk2", False
    with pytest.raises(NotImplementedError, match="cell engine"):
        a_sch.make_step(scene)
    with pytest.raises(ValueError, match="cell engine"):
        tslab.make_slab_coupling_step(b_sch, [scene], None, None)
    # another kernel on the cell engine runs (its hand kernels on the
    # card, their plain versions here)
    b_sch.engine, b_sch.kernel_name = "cell", "gaussian"
    out = b_sch.make_step(scene)(scene, DT_CONTACT)
    assert torch.isfinite(out.x).all() and torch.isfinite(out.au).all()
    assert not bool(out.nbr_overflow)
