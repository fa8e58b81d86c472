"""Port vs reference: the coupling slab step (``parallel/slab.py``
``make_slab_coupling_step``) on CPU slabs, in float64.

* The scene: ``tests/test_slab_coupling.py``'s wide tank, cut to a 2 m
  tank 0.4 m deep so that four slabs of 5 cell columns cover it (the
  scheme's grid cut in x to the tank: the reference's domain pads 0.75 x
  the extent a side, which leaves the outer slabs of four empty).  Box 1
  (rho 8) starts 0.95 dx above the floor across face 1, pushed down and
  sideways (the contact engages and lasts, its floor sources partly
  ghosts), box 2 floats half submerged across face 2, and the fluid
  crosses every face.  Seeded random velocities on every particle.
* kdk and kdkf (its 10 steps in one call, ``chain=10``), 10 slab steps
  on 4 slabs against 10 steps of the reference's single-device
  ``make_step`` of the same ordering (its XLA cell branch), matched by
  (x, y), at the reference test's tolerances: atol 2e-8 on the fluid
  fields, 1e-7 on the body force, 1e-9 on xcm.
  The slab kdkf runs B4, B6c and K2 where the single-device kdkf fuses
  forces and contact (B5 on the card; the XLA branch here): the same
  sums in another order.
* The ghost bodies: rigid sources for the fluid passes, never contact
  queries; with them as queries the local rows' contact and the body
  sums would be the same (their outputs are dropped), only K2's work
  grows.
* 3D, kdkf on 2 slabs (the box across the face) against the port's
  single-device kdkf (which ``tests/test_torch_coupling_3d.py`` holds to
  the reference), every row field at rtol 1e-10.
* Redistribution of a coupling scene after fluid rows crossed a face:
  the host route equals the reference's ``redistribute`` field for
  field, the device route slab by slab as sets of rows; a step follows.
* The guards: a blob scene, the "reference" ordering and the rk2 fluid
  stepper raise.

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
from rigid_body_2d_3d_pysph_tpu.parallel import slab as jslab
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from rigid_body_2d_3d_pysph_tpu_torch import geom as tgeom
from rigid_body_2d_3d_pysph_tpu_torch.models import (
    RigidFluidCouplingScheme as TRFC)
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk
from rigid_body_2d_3d_pysph_tpu_torch.ops import rigid as rops
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel
from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as tslab
from rigid_body_2d_3d_pysph_tpu_torch.parallel.mesh import make_mesh
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group as tmake_group, build_scene as tbuild_scene)

from test_torch_coupling_step import coupling_scene_3d, port_twin

CPU = torch.device("cpu")
DT = 1e-4
STEPS = 10
STEPS_3D = 2
P = 4
DX = 0.05
# the slab grid in x: 4 slabs of 5 cells (0.15 m) from x = -1.5, so the
# faces sit at -0.75, 0 and 0.75 (the tank spans [-1.2, 1.2])
X0, NX, FACES = -1.65, 22, (-0.75, 0.0, 0.75)
FIELDS = ("x", "y", "u", "v", "rho", "p", "p_fsi", "arho", "au", "av")
# box 1's density: 8 times the fluid's, pushed down at 0.5 m/s, so its
# floor contact lasts the 10 steps (a box of rho 2 is thrown off in 8)
RHO_FLOOR_BOX = 8.0


def _tank_scene():
    """The reference's scheme and set-up scene: a 2 m tank (3 layers),
    fluid 0.4 deep, two boxes of 0.2 half a dx right of faces 1 and 2:
    box 1 (RHO_FLOOR_BOX) 0.95 dx above the floor's top layer, moving
    down and sideways, box 2 (rho 2) half submerged; the fluid carved
    around them, the displaced fluid's shadow mass and density on the
    boxes, seeded random velocities."""
    gy, rho0 = -1.0, 1.0
    xf, yf, xt, yt = jgeom.hydrostatic_tank_2d(2.0, 0.4, 0.6, 3, DX, DX)
    p0 = -rho0 * gy * (yf.max() - yf)
    xb1, yb1 = jgeom.get_2d_block(DX, 0.2, 0.2)
    boxes = [(xb1 + FACES[0] + DX / 2, yb1 - yb1.min() - DX + 0.95 * DX),
             (xb1 + FACES[1] + DX / 2, yb1 + yf.max() - yb1.min() - 0.1)]
    keep = np.ones(len(xf), bool)
    for bx, by in boxes:
        keep &= ~((xf > bx.min() - DX) & (xf < bx.max() + DX)
                  & (yf > by.min() - DX) & (yf < by.max() + DX))
    bid = np.repeat(np.arange(2, dtype=np.int32), len(xb1))
    rho_b = np.repeat([RHO_FLOOR_BOX, 2.0], len(xb1)) * rho0
    groups = [
        jmake_group("fluid", xf[keep], yf[keep], m=rho0 * DX * DX, h=DX,
                    rho=rho0, role="fluid", p=p0[keep]),
        jmake_group("tank", xt, yt, m=rho0 * DX * DX, h=DX, rho=rho0,
                    rad_s=DX / 2, role="boundary", dem_id=2),
        jmake_group("body", np.concatenate([b[0] for b in boxes]),
                    np.concatenate([b[1] for b in boxes]),
                    m=rho_b * DX * DX, h=DX, rho=rho_b, rad_s=DX / 2,
                    role="rigid", body_id=bid, dem_id=bid)]
    scene = jbuild_scene(groups, dim=2, total_no_bodies=3, spacing0=DX)
    c0 = 10 * np.sqrt(2 * abs(gy) * 0.4)
    scheme = JRFC(rigid_bodies=["body"], fluids=["fluid"],
                  boundaries=["tank"], dim=2, rho0=rho0, p0=rho0 * c0**2,
                  c0=c0, gy=gy, nu=0.0, h=DX)
    scheme.engine = "cell"
    scene = scheme.setup(scene)
    rb = np.asarray(scene.is_rigid)
    rng = np.random.default_rng(23)
    return scheme, scene.replace(
        m_fsi=jnp.asarray(np.where(rb, rho0 * DX * DX,
                                   np.asarray(scene.m_fsi))),
        rho_fsi=jnp.asarray(np.where(rb, rho0, np.asarray(scene.rho_fsi))),
        u=jnp.asarray(rng.uniform(-0.05, 0.05, scene.n)),
        v=jnp.asarray(rng.uniform(-0.05, 0.05, scene.n)),
        vcm=jnp.asarray([[0.05, -0.5, 0.0], [0.0, 0.0, 0.0]]))


def _slab_base(base, x0, nx):
    """The scheme's grid with its x extent cut to ``nx`` cells from
    ``x0``."""
    return dataclasses.replace(base, origin=(x0,) + tuple(base.origin[1:]),
                               dims=(nx,) + tuple(base.dims[1:]))


@pytest.fixture(scope="module")
def tank():
    jsch, jscene = _tank_scene()
    tsch, tscene = port_twin(jsch, jscene, torch.float64)
    cfg = tslab.make_slab_config(tscene, _slab_base(tsch._cell_cfg, X0, NX),
                                 P)
    assert cfg.slab_cells == 5
    np.testing.assert_allclose([cfg.slab_lo(d) for d in (1, 2, 3)], FACES,
                               atol=1e-12)
    return jsch, jscene, tsch, tscene, cfg


def _parts(tscene, cfg, n_slabs=P):
    mesh = make_mesh(n_slabs, [CPU] * n_slabs)
    return tslab.shard_slab_scene(
        tslab.slab_decompose(tscene, cfg, use_blob=False), mesh), mesh


def _match_xy(g, ref):
    """(port active rows in (x, y) order, reference rows in that
    order)."""
    act = g.active.numpy()
    rows = np.nonzero(act)[0]
    ks = rows[np.lexsort((g.y.numpy()[act], g.x.numpy()[act]))]
    kr = np.lexsort((np.asarray(ref.y), np.asarray(ref.x)))
    assert len(ks) == ref.n
    return ks, kr


@pytest.mark.parametrize("ordering", ["kdk", "kdkf"])
def test_slab_steps_match_reference_single_device(tank, ordering):
    jsch, jscene, tsch, tscene, cfg = tank
    jsch.gtvf_ordering = tsch.gtvf_ordering = ordering
    jstep = jsch.make_step(jscene)
    js = jscene
    for _ in range(STEPS):
        js = jstep(js, jnp.asarray(DT))
    parts, mesh = _parts(tscene, cfg)
    chain = STEPS if ordering == "kdkf" else 1   # kdkf: the steps in one call
    step = tslab.make_slab_coupling_step(tsch, parts, mesh, cfg, chain=chain)
    for _ in range(STEPS // chain):
        parts = step(parts, DT)
    g = tslab.gather_slab_scene(parts)
    assert not bool(g.nbr_overflow) and not bool(js.nbr_overflow)
    # every slab holds fluid; box 1 is in contact, the FSI force is on
    assert all(bool((p.is_fluid & p.active).any()) for p in parts)
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


def test_ghost_bodies_are_fluid_sources_not_contact_queries(tank):
    """The stage before the forces evaluation: some slab receives rigid
    ghost rows (the fluid passes' view); the contact pack clears their
    rigid bit, and K2 with them as queries gives every local row the
    same contact columns and every body the same sums."""
    jsch, jscene, tsch, tscene, cfg = tank
    tsch.gtvf_ordering = "kdk"
    parts, mesh = _parts(tscene, cfg)
    step = tslab.make_slab_coupling_step(tsch, parts, mesh, cfg)
    locs, exts, _ = step.exchange(parts, DT)
    lcfg = tslab.local_grid_config(cfg)
    kernel = get_kernel(tsch.kernel_name, 2)
    params = dict(kr=tsch.kr, kf=tsch.kf, fric_coeff=tsch.fric_coeff,
                  gx=tsch.gx, gy=tsch.gy, gz=tsch.gz)
    n_ghost_rigid = n_picks = 0
    for s, e in zip(locs, exts):
        nl = s.n
        ghost_rigid = int((e.is_rigid[nl:] & e.active[nl:]).sum())
        n_ghost_rigid += ghost_rigid
        if ghost_rigid == 0:
            continue
        grid, _, dfT = fk.pack_fluid_sorted(e, lcfg)
        as_queries = tck.contact_pack(dfT, fk.UNION_LAYOUT, True)
        cdfT = tslab.coupling_contact_pack(dfT.clone(), grid, e, nl, True)
        lane = grid.dense_pos
        rigid = tck.decode_flags(cdfT[:-1, -1])[3].reshape(-1)
        ghost_lanes = lane[nl:][lane[nl:] < rigid.shape[0]]
        assert float(rigid[ghost_lanes].sum()) == 0.0
        assert int(rigid.sum()) == int((s.is_rigid & s.active).sum())
        outs = []
        for pk in (cdfT, as_queries):
            cp = tck.contact_pipeline_cell(
                pk, grid, lcfg, kernel, s.meta.total_no_bodies,
                4.0 * s.meta.spacing0, e.n)[:nl]
            f = trb._contact_forces(s, cp, params, DT)
            outs.append((cp, rops.body_sums(f, f.fx, f.fy, f.fz,
                                            torch.float64)))
        n_picks += int((outs[0][0][:, 5] < 4.0 * DX).sum())
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])
    assert n_ghost_rigid > 0 and n_picks > 0


def _tank_scene_3d():
    """A small 3D tank (the port's set-up, float64): a 0.5 x 0.25 x 0.35
    fluid block in a 2-layer tank, a 0.15 x 0.1 x 0.1 box (rho 2) centred
    in x and z and dipped into the surface, more than the contact cutoff
    from every wall (a box between two walls in its cutoff has a contact
    normal that is the rounding noise of cancelling sums), the fluid
    carved under it, the displaced fluid's shadow mass and density on the
    box, seeded random velocities."""
    gy, rho0 = -1.0, 1.0
    xf, yf, zf, xt, yt, zt = tgeom.get_fluid_tank_3d(
        0.5, 0.25, 0.35, 0.5, 0.35, 2, DX, DX, hydrostatic=True)
    p0 = -rho0 * gy * (yf.max() - yf)
    xb, yb, zb = tgeom.get_3d_block(DX, 0.15, 0.1, 0.1)
    xb -= (xb.min() + xb.max()) / 2
    zb += (zf.min() + zf.max()) / 2 - (zb.min() + zb.max()) / 2
    yb += yf.max() - yb.min() - 0.05
    keep = ~((xf > xb.min() - DX) & (xf < xb.max() + DX)
             & (yf > yb.min() - DX) & (yf < yb.max() + DX)
             & (zf > zb.min() - DX) & (zf < zb.max() + DX))
    m = rho0 * DX**3
    groups = [
        tmake_group("fluid", xf[keep], yf[keep], z=zf[keep], m=m, h=DX,
                    rho=rho0, role="fluid", p=p0[keep]),
        tmake_group("tank", xt, yt, z=zt, m=m, h=DX, rho=rho0,
                    rad_s=DX / 2, role="boundary", dem_id=1),
        tmake_group("body", xb, yb, z=zb, m=2.0 * m, h=DX, rho=2.0 * rho0,
                    rad_s=DX / 2, role="rigid",
                    body_id=np.zeros(len(xb), np.int32),
                    dem_id=np.zeros(len(xb), np.int32))]
    scene = tbuild_scene(groups, dim=3, total_no_bodies=2, spacing0=DX,
                         device=CPU, dtype=torch.float64)
    c0 = 10 * np.sqrt(2 * abs(gy) * 0.25)
    scheme = TRFC(["fluid"], ["tank"], ["body"], dim=3, rho0=rho0,
                  p0=rho0 * c0**2, c0=c0, h=DX, nu=0.0, gy=gy)
    scene = scheme.setup(scene)
    rb = scene.is_rigid
    rng = np.random.default_rng(5)
    return scheme, scene.replace(
        m_fsi=torch.where(rb, m, scene.m_fsi),
        rho_fsi=torch.where(rb, rho0, scene.rho_fsi),
        **{k: torch.as_tensor(rng.uniform(-0.05, 0.05, scene.n))
           for k in ("u", "v", "w")})


def test_slab_kdkf_3d_matches_single_device():
    """2 slabs of 3 cells from x = -0.45 (the face at x = 0, through the
    box), STEPS_3D kdkf steps against the port's single-device step."""
    tsch, tscene = _tank_scene_3d()
    tscene = tslab.attach_gids(tscene)
    base = tsch.cell_config(tscene, get_kernel(tsch.kernel_name, 3))
    cfg = tslab.make_slab_config(tscene, _slab_base(base, -0.6, 8), 2)
    assert cfg.slab_cells == 3 and abs(cfg.slab_lo(1)) < 1e-12
    parts, mesh = _parts(tscene, cfg, 2)
    step = tslab.make_slab_coupling_step(tsch, parts, mesh, cfg)
    _, exts, _ = step.exchange(parts, DT)
    assert all(int(e.is_rigid[p.n:].sum()) > 0 for p, e in zip(parts, exts))
    single = tsch.make_step(tscene)
    s = tscene
    for _ in range(STEPS_3D):
        parts = step(parts, DT)
        s = single(s, DT)
    g = tslab.gather_slab_scene(parts)
    assert not bool(g.nbr_overflow) and not bool(s.nbr_overflow)
    rows = np.nonzero(g.active.numpy())[0]
    rows = rows[np.argsort(g.gid.numpy()[rows])]
    assert len(rows) == s.n
    for k, v in s.fields.items():
        if not (v.is_floating_point() and v.dim() >= 1 and v.shape[0] == s.n):
            continue
        a, b = g[k].numpy()[rows], v.numpy()
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * scale,
                                   err_msg=k)
    for k in ("force", "torque", "xcm", "vcm", "omega"):
        np.testing.assert_allclose(g[k].numpy(), s[k].numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=k)
    assert float(np.abs(s.force.numpy()).max()) > 0


def _assert_scenes_equal(t, j, rows=None):
    assert set(t.fields) == set(j.fields)
    for k in j.fields:
        a, b = t[k].numpy(), np.asarray(j[k])
        if rows is not None and a.ndim >= 1 and a.shape[0] == t.n:
            a, b = a[rows[0]], b[rows[1]]
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_redistribute_coupling_scene_matches_reference(tank):
    """The fluid rows moved by 1.5 dx (data only), so the fluid within
    1.5 dx left of each face crosses it."""
    jsch, jscene, tsch, tscene, cfg = tank
    jcfg = jslab.SlabConfig(**{f.name: getattr(cfg, f.name)
                               for f in dataclasses.fields(cfg)})
    shift = 1.5 * DX
    jdec = jslab.slab_decompose(jscene, jcfg)
    jdec = jdec.replace(x=jnp.where(jdec.active & jdec.is_fluid,
                                    jdec.x + shift, jdec.x))
    tdec = tslab.slab_decompose(tscene, cfg, use_blob=False)
    tdec = tdec.replace(x=torch.where(tdec.active & tdec.is_fluid,
                                      tdec.x + shift, tdec.x))
    own = np.arange(tdec.n) // cfg.n_cap
    new = tslab._slab_of(tdec.x, cfg)
    moved = tdec.active.numpy() & (new != own)
    # rows cross every face, one slab along, as many as on the
    # reference's side
    for d in range(P - 1):
        assert int((moved & (own == d) & (new == d + 1)).sum()) > 0, d
    assert not (moved & (new != own + 1)).any()
    jown = np.arange(jdec.n) // jcfg.n_cap
    assert int(moved.sum()) == int((np.asarray(jdec.active) & (
        jslab._slab_of(jdec.x, jcfg) != jown)).sum())
    jh = jslab.redistribute(jdec, jcfg)
    _assert_scenes_equal(tslab.redistribute(tdec, cfg), jh)

    mesh = make_mesh(P, [CPU] * P)
    parts = tslab.shard_slab_scene(tdec, mesh)
    parts = tslab.make_slab_redistribute(parts, mesh, cfg)(parts)
    td = tslab.gather_slab_scene(parts)
    assert not bool(td.nbr_overflow)
    order_t, order_j = [], []
    for d in range(P):
        rows = slice(d * cfg.n_cap, (d + 1) * cfg.n_cap)
        for sc, out in ((td, order_t), (jh, order_j)):
            x, y = np.asarray(sc.x)[rows], np.asarray(sc.y)[rows]
            out.append(d * cfg.n_cap + np.lexsort((y, x)))
    _assert_scenes_equal(td, jh, (np.concatenate(order_t),
                                  np.concatenate(order_j)))
    tsch.gtvf_ordering = "kdkf"
    step = tslab.make_slab_coupling_step(tsch, parts, mesh, cfg)
    assert not bool(tslab.gather_slab_scene(step(parts, DT)).nbr_overflow)


@pytest.mark.parametrize("case", ["blob", "reference", "rk2"])
def test_guards(tank, case):
    jsch, jscene, tsch, tscene, cfg = tank
    sch = TRFC(tsch.fluids, tsch.boundaries, tsch.rigid_bodies, 2, tsch.rho0,
               tsch.p0, tsch.c0, tsch.h, tsch.nu, gy=tsch.gy)
    mesh = make_mesh(P, [CPU] * P)
    parts = tslab.shard_slab_scene(
        tslab.slab_decompose(tscene, cfg, use_blob=case == "blob"), mesh)
    if case == "blob":
        assert "slot_blob" in parts[0]
        err = ValueError
    elif case == "reference":
        sch.gtvf_ordering = "reference"
        err = NotImplementedError
    else:
        sch.edac, sch.fluid_stepper = False, "rk2"
        err = NotImplementedError
    with pytest.raises(err):
        tslab.make_slab_coupling_step(sch, parts, mesh, cfg)
