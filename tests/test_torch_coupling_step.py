"""Port vs reference: the rigid-fluid coupling scheme's setup and its
fused kdkf step end to end.

* Setup (float64): boundary flags, normals, body state, vol, cs and the
  cell grid match the reference scheme's setup on the cell engine.
* f32, 3 steps against the reference's kdkf step with its Pallas fluid
  branch in interpret mode (``fluid_pallas_interpret``, the wiring of
  ``test_pallas_fluid.py``): the port runs its kernels' plain twins on
  CPU tensors.  Tolerance 1e-5 x max(|field|, 1) absolute: the two sides
  sum the pair terms, the per-body forces and torques in different
  orders (f32).
* f64, 10 steps against the reference's XLA kdkf branch (engine
  ``"cell"``) with the box sliding on the tank floor, so contacts engage
  and the tangential springs evolve: rtol 1e-9, atol 1e-9 x
  max(|field|, 1).  The XLA branch sums the fluid/boundary and the
  FSI-rigid source classes in two terms where the port sums them in one,
  and runs the contact pass apart from the fluid passes: only the
  summation order differs.
* f64, the Tait branch (``edac=False``) and the fluid-only branch (B6c,
  no rigid body) for 4 steps each against the same XLA branch, same
  tolerance.

Every comparison starts both sides from one state carried across with
``state.convert.scene_from_numpy``, on the reference's own grid
configuration.  Each reference trajectory is computed once per module.
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
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from rigid_body_2d_3d_pysph_tpu_torch import geom as tgeom
from rigid_body_2d_3d_pysph_tpu_torch.models import (
    RigidFluidCouplingScheme as TRFC)
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group as tmake_group, build_scene as tbuild_scene)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_fluid_coupling import _tank_scene
from test_pallas_fluid import _f32

CPU = torch.device("cpu")
FLUID = ("x", "y", "u", "v", "rho", "p", "p_fsi", "arho", "ap", "au",
         "av", "uf", "vf", "wij_adami", "vol")
BODY = ("fx", "fy", "xcm", "vcm", "omega", "force", "torque")
SLOTS = ("contact_force_normal_x", "contact_force_normal_y",
         "contact_force_dist", "closest_point_dist_to_source", "x_source",
         "y_source", "vx_source", "overlap", "fn_x", "fn_y",
         "delta_lt_x", "delta_lt_y")
# the box's face gap to the tank floor's top layer, in dx: a contact
# engages below 1 dx
GAP = 0.95
DT_CONTACT = 2e-5


def coupling_scene(make_group, build_scene, geom, scheme_cls, with_body,
                   floor=False, **build_kw):
    """``test_fluid_coupling._tank_scene``'s tank, fluid and box, built
    with either package; ``floor`` rests the box GAP dx above the tank
    floor instead of at the surface.  Returns (scheme, unset-up scene,
    dx, rho0)."""
    dx, gy, rho0 = 0.05, -1.0, 1.0
    xf, yf, xt, yt = geom.hydrostatic_tank_2d(1.0, 1.0, 1.4, 3, dx, dx)
    p0 = -rho0 * gy * (yf.max() - yf)
    m_f = rho0 * dx * dx
    c0 = 10 * np.sqrt(2 * abs(gy) * 1.0)
    groups = [make_group("tank", xt, yt, m=m_f, h=dx, rho=rho0,
                         rad_s=dx / 2, role="boundary", dem_id=1)]
    if with_body:
        xb, yb = geom.get_2d_block(dx, 0.2, 0.2)
        xb += (xf.min() + xf.max()) / 2.0
        if floor:   # the floor's top layer is at y = -dx
            yb += (-dx + GAP * dx) - yb.min()
        else:
            yb += yf.max() - yb.min() - 0.1
        keep = ~((xf > xb.min() - dx) & (xf < xb.max() + dx)
                 & (yf > yb.min() - dx) & (yf < yb.max() + dx))
        xf, yf, p0 = xf[keep], yf[keep], p0[keep]
        groups.append(make_group(
            "body", xb, yb, m=2.0 * rho0 * dx * dx, h=dx, rho=2.0 * rho0,
            rad_s=dx / 2, role="rigid",
            body_id=np.zeros(len(xb), np.int32),
            dem_id=np.zeros(len(xb), np.int32)))
    groups.insert(0, make_group("fluid", xf, yf, m=m_f, h=dx, rho=rho0,
                                role="fluid", p=p0))
    scene = build_scene(groups, dim=2, total_no_bodies=2, spacing0=dx,
                        **build_kw)
    scheme = scheme_cls(
        rigid_bodies=["body"] if with_body else [], fluids=["fluid"],
        boundaries=["tank"], dim=2, rho0=rho0, p0=rho0 * c0**2, c0=c0,
        gy=gy, nu=0.0, h=dx)
    return scheme, scene, dx, rho0


def _shadow_fields(scene, rho0, dx):
    """The displaced-fluid shadow mass and density on the body (host
    arrays), as ``_tank_scene`` sets them."""
    g = scene.meta.group("body")
    m_fsi = np.array(scene.m_fsi)
    rho_fsi = np.array(scene.rho_fsi)
    m_fsi[g.start:g.stop] = rho0 * dx * dx
    rho_fsi[g.start:g.stop] = rho0
    return m_fsi, rho_fsi


def _jax_floor_scene():
    scheme, scene, dx, rho0 = coupling_scene(jmake_group, jbuild_scene,
                                             jgeom, JRFC, True, floor=True)
    scheme.engine = "cell"
    scene = scheme.setup(scene)
    m_fsi, rho_fsi = _shadow_fields(scene, rho0, dx)
    return scheme, scene.replace(m_fsi=jnp.asarray(m_fsi),
                                 rho_fsi=jnp.asarray(rho_fsi))


def _velocities(scene, seed, amp):
    """Seeded random u, v on every particle (numpy, so both sides can be
    handed the same numbers)."""
    rng = np.random.default_rng(seed)
    dt = scene.x.dtype
    return scene.replace(u=jnp.asarray(rng.uniform(-amp, amp, scene.n), dt),
                         v=jnp.asarray(rng.uniform(-amp, amp, scene.n), dt))


def port_twin(jsch, jscene, dtype):
    """The port's scheme and scene for a set-up reference pair: the same
    parameters, the same state, the reference's grid configuration."""
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    tscene = scene_from_numpy(fields, jscene.meta, CPU, dtype)
    tsch = TRFC(jsch.fluids, jsch.boundaries, jsch.rigid_bodies, jsch.dim,
                jsch.rho0, jsch.p0, jsch.c0, jsch.h, jsch.nu, kr=jsch.kr,
                kf=jsch.kf, fric_coeff=jsch.fric_coeff, gamma=jsch.gamma,
                gx=jsch.gx, gy=jsch.gy, gz=jsch.gz, alpha=jsch.fluid_alpha)
    tsch.edac = jsch.edac
    tsch._cell_cfg = tcell.CellGridConfig(**{
        f.name: getattr(jsch._cell_cfg, f.name)
        for f in dataclasses.fields(tcell.CellGridConfig)})
    return tsch, tscene


def _run_reference(jsch, jscene, n_steps, dt):
    step = jsch.make_step(jscene)
    start = jscene
    for _ in range(n_steps):
        jscene = step(jscene, dt)
    return start, jscene


def _compare(jend, tend, names, rtol):
    assert not bool(jend.nbr_overflow) and not bool(tend.nbr_overflow)
    for name in names:
        a = np.asarray(jend.fields[name])
        b = tend.fields[name].numpy()
        assert np.isfinite(b).all(), name
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

def test_setup_matches_reference_f64():
    jsch, jscene, dx, gy, rho0 = _tank_scene(with_body=True)
    tsch, tscene, _, _ = coupling_scene(
        tmake_group, tbuild_scene, tgeom, TRFC, True, device=CPU,
        dtype=torch.float64)
    tscene = tsch.setup(tscene)
    m_fsi, rho_fsi = _shadow_fields(tscene, rho0, dx)
    tscene = tscene.replace(m_fsi=torch.as_tensor(m_fsi),
                            rho_fsi=torch.as_tensor(rho_fsi))
    assert tscene.n == jscene.n
    for g in jscene.meta.groups:   # the same groups in the same order
        tg = tscene.meta.group(g.name)
        assert (tg.start, tg.stop, tg.role) == (g.start, g.stop, g.role)
    assert dataclasses.asdict(tsch._cell_cfg) == {
        f.name: getattr(jsch._cell_cfg, f.name)
        for f in dataclasses.fields(tcell.CellGridConfig)}

    isb = np.asarray(jscene.is_boundary)
    assert 0 < int(isb.sum()) < jscene.n
    np.testing.assert_array_equal(tscene.is_boundary.numpy(), isb)
    for k in ("contact_force_is_boundary", "normal", "vol", "cs", "p",
              "m_fsi", "rho_fsi", "total_mass", "xcm", "izz",
              "inertia_tensor_body_frame",
              "inertia_tensor_inverse_body_frame",
              "inertia_tensor_inverse_global_frame", "eta", "dx0", "dy0"):
        np.testing.assert_allclose(tscene[k].numpy(), np.asarray(jscene[k]),
                                   rtol=1e-13, atol=1e-13, err_msg=k)
    for k in ("is_fluid", "is_rigid", "is_static_boundary", "dem_id",
              "body_id"):
        np.testing.assert_array_equal(tscene[k].numpy(),
                                      np.asarray(jscene[k]), err_msg=k)


def coupling_scene_3d(make_group, build_scene, geom, scheme_cls,
                      **build_kw):
    """A small 3D sinking box built with either package: a 0.5 x 0.3 x
    0.3 fluid block in a 3-layer hydrostatic tank (``get_fluid_tank_3d``)
    and a box of rho 2 dipped into its surface, the fluid carved under
    it.  Returns (scheme, unset-up scene)."""
    dx, gy, rho0 = 0.05, -1.0, 1.0
    xf, yf, zf, xt, yt, zt = geom.get_fluid_tank_3d(
        0.5, 0.3, 0.3, 0.5, 0.45, 3, dx, dx, hydrostatic=True)
    p0 = -rho0 * gy * (yf.max() - yf)
    xb, yb, zb = geom.get_3d_block(dx, 0.15, 0.1, 0.15)
    xb += (xf.min() + xf.max()) / 2 - (xb.min() + xb.max()) / 2
    zb += (zf.min() + zf.max()) / 2 - (zb.min() + zb.max()) / 2
    yb += yf.max() - yb.min() - 0.05
    keep = ~((xf > xb.min() - dx) & (xf < xb.max() + dx)
             & (yf > yb.min() - dx) & (yf < yb.max() + dx)
             & (zf > zb.min() - dx) & (zf < zb.max() + dx))
    m = rho0 * dx**3
    c0 = 10 * np.sqrt(2 * abs(gy) * 0.3)
    groups = [
        make_group("fluid", xf[keep], yf[keep], z=zf[keep], m=m, h=dx,
                   rho=rho0, role="fluid", p=p0[keep]),
        make_group("tank", xt, yt, z=zt, m=m, h=dx, rho=rho0, rad_s=dx / 2,
                   role="boundary", dem_id=1),
        make_group("body", xb, yb, z=zb, m=2.0 * m, h=dx, rho=2.0 * rho0,
                   rad_s=dx / 2, role="rigid",
                   body_id=np.zeros(len(xb), np.int32),
                   dem_id=np.zeros(len(xb), np.int32))]
    scene = build_scene(groups, dim=3, total_no_bodies=2, spacing0=dx,
                        **build_kw)
    scheme = scheme_cls(
        rigid_bodies=["body"], fluids=["fluid"], boundaries=["tank"], dim=3,
        rho0=rho0, p0=rho0 * c0**2, c0=c0, gy=gy, nu=0.0, h=dx)
    return scheme, scene


def test_setup_3d_matches_reference_f64():
    """The 3D set-up (the cell grid, surface identification of the tank
    and the box, body state, FSI and Adami fields, the RK2 step's saved
    state) equals the reference's on the cell engine, field for field."""
    jsch, jscene = coupling_scene_3d(jmake_group, jbuild_scene, jgeom, JRFC)
    jsch.engine = "cell"
    jscene = jsch.setup(jscene)
    tsch, tscene = coupling_scene_3d(tmake_group, tbuild_scene, tgeom, TRFC,
                                     device=CPU, dtype=torch.float64)
    tscene = tsch.setup(tscene)
    assert tscene.n == jscene.n
    assert dataclasses.asdict(tsch._cell_cfg) == {
        f.name: getattr(jsch._cell_cfg, f.name)
        for f in dataclasses.fields(tcell.CellGridConfig)}
    isb = np.asarray(jscene.is_boundary)
    assert 0 < int(isb[jscene.is_rigid].sum()) < int(jscene.is_rigid.sum())
    assert set(jscene.fields) == set(tscene.fields)
    for k in sorted(tscene.fields):
        a, b = tscene[k].numpy(), np.asarray(jscene[k])
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


# ---------------------------------------------------------------------------
# f32 against the Pallas kdkf branch (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pallas_reference():
    jsch, jscene, _, _, _ = _tank_scene(with_body=True)
    jscene = _f32(_velocities(jscene, 5, 0.05))
    jsch.fluid_pallas_interpret = True
    return jsch, *_run_reference(jsch, jscene, 3, jnp.float32(1e-4))


def test_three_f32_steps_match_pallas_kdkf(pallas_reference):
    jsch, start, jend = pallas_reference
    tsch, tscene = port_twin(jsch, start, torch.float32)
    step = tsch.make_step(tscene)
    for _ in range(3):
        tscene = step(tscene, 1e-4)
    assert float(np.abs(np.asarray(jend.fx)).max()) > 0   # FSI is on
    _compare(jend, tscene, FLUID + BODY, rtol=1e-5)


# ---------------------------------------------------------------------------
# f64 against the XLA kdkf branch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def floor_reference():
    # the box slides along the floor; at dt 2e-5 the 10 steps stay within
    # one contact (the light box leaves the floor after ~7e-4 s)
    jsch, jscene = _jax_floor_scene()
    jscene = _velocities(jscene, 7, 0.05).replace(
        vcm=jnp.asarray([[0.05, -0.02, 0.0]]))
    return jsch, *_run_reference(jsch, jscene, 10, DT_CONTACT)


def test_ten_f64_steps_match_xla_kdkf_in_contact(floor_reference):
    jsch, start, jend = floor_reference
    tsch, tscene = port_twin(jsch, start, torch.float64)
    step = tsch.make_step(tscene)
    for _ in range(10):
        tscene = step(tscene, DT_CONTACT)
    # the box is in contact: engaged slots, a picked source, springs
    assert float(np.asarray(jend.overlap).max()) > 0
    assert float(np.abs(np.asarray(jend.delta_lt_x)).max()) > 0
    _compare(jend, tscene, FLUID + BODY + SLOTS, rtol=1e-9)


@pytest.mark.parametrize("case", ["tait", "fluid_only"])
def test_f64_branches_match_xla_kdkf(case):
    jsch, jscene, _, _, _ = _tank_scene(with_body=case == "tait")
    if case == "tait":
        jsch.edac = False
    jscene = _velocities(jscene, 9, 0.05)
    start, jend = _run_reference(jsch, jscene, 4, 1e-4)
    tsch, tscene = port_twin(jsch, start, torch.float64)
    step = tsch.make_step(tscene)
    for _ in range(4):
        tscene = step(tscene, 1e-4)
    names = FLUID + (("cs",) + BODY if case == "tait" else ())
    _compare(jend, tscene, names, rtol=1e-9)


def test_unported_orderings_raise():
    """Every GTVF ordering is ported (``test_torch_coupling_orderings``)
    and so is the RK2 fluid stepper (``test_torch_coupling_rk2``), which
    takes Tait only: with EDAC it raises in any ordering, as the
    reference does; an unknown stepper or ordering raises too."""
    tsch, tscene, _, _ = coupling_scene(
        tmake_group, tbuild_scene, tgeom, TRFC, False, device=CPU,
        dtype=torch.float64)
    tsch.fluid_stepper = "rk2"
    for ordering in ("kdkf", "kdk", "reference"):
        tsch.gtvf_ordering = ordering
        with pytest.raises(NotImplementedError, match="Tait"):
            tsch.make_step(tscene)
    tsch.fluid_stepper = "euler"
    with pytest.raises(ValueError):
        tsch.make_step(tscene)
    tsch.fluid_stepper, tsch.gtvf_ordering = "gtvf", "kdkdk"
    with pytest.raises(ValueError):
        tsch.make_step(tscene)
