"""Port vs reference: the slab decomposition of the rigid step
(``parallel/slab.py``) on CPU devices, in float64.

* ``make_slab_config``, ``slab_decompose`` (full schema and blob, the
  default) and the host ``redistribute`` of a blob scene (which keeps
  the blob) equal the reference's field for field at 4 and 8 slabs, on
  a row of 8
  blocks along a floor (``tests/test_slab.py``'s wide scene with the
  blocks 0.95 dx apart, one group each, and a 3-layer floor, so the
  contacts engage from the first step).
* ``blobify_slot_scene`` equals the reference's on a state in contact,
  and ``deblobify_slot_scene`` inverts it.
* 10 slab steps on 4 slabs (blob route: the cull and the contact sums
  on the culled rows) and on 8 (full ``[N, S]`` route: the contact sums
  on every slot) against 10 steps of the reference's single-device cell
  step, matched by (x, y): atol 1e-9 on x/y/u/v, 1e-7 on the force, as
  ``tests/test_slab.py``; the 8-slab run also row for row against the
  reference's ``make_slab_step`` on its 8 virtual devices.
* Host and on-device redistribution against the reference's host
  ``redistribute``, after every row moved by 2 dx (some cross a slab
  face; the count is asserted): the host path equal field for field,
  the device path equal slab by slab as sets of rows; a step follows.

On CPU tensors the kernel wrappers run their plain versions.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.ops.kernels import get_kernel as jget_kernel
from rigid_body_2d_3d_pysph_tpu.parallel import slab as jslab
from rigid_body_2d_3d_pysph_tpu.parallel.sharded import make_mesh as jmesh

from rigid_body_2d_3d_pysph_tpu_torch.models import RigidBody2DScheme
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel
from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as tslab
from rigid_body_2d_3d_pysph_tpu_torch.parallel.mesh import make_mesh
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from rigid_body_2d_3d_pysph_tpu.geom import get_2d_block
from rigid_body_2d_3d_pysph_tpu.models.rigid_body import (
    RigidBody2DScheme as JRigidBody2DScheme)
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY)

CPU = torch.device("cpu")
DT = 1e-4
STEPS = 10
CFG_FIELDS = ("n_dev", "slab_cells", "n_cap", "halo_cap", "nc_max_local")


def _port(jscene):
    return scene_from_numpy({k: np.asarray(v) for k, v in
                             jscene.fields.items()}, jscene.meta, CPU,
                            torch.float64)


def _wide_scene(n_blocks=8, gap=0.95):
    """8 blocks of side 0.2 in a row on a 3-layer floor, faces and floor
    ``gap`` dx apart (a contact engages below 1 dx); one group a block,
    so the faces between neighbours are surfaces."""
    dx = 0.05
    xb, yb = get_2d_block(dx, 0.2, 0.2)
    pitch = 0.2 + gap * dx
    m = 2000 * dx * dx
    groups = [make_group(f"b{b}", xb + b * pitch, yb - yb.min() + gap * dx,
                         m=m, h=1.3 * dx, rho=2000.0, rad_s=dx / 2,
                         role=ROLE_RIGID, dem_id=np.full(len(xb), b, np.int32))
              for b in range(n_blocks)]
    fx, fy = np.meshgrid(np.arange(-8, int(n_blocks * pitch / dx) + 8) * dx,
                         -np.arange(3) * dx)
    groups.append(make_group("floor", fx.ravel(), fy.ravel(), m=m,
                             h=1.3 * dx, rho=2000.0, rad_s=dx / 2,
                             role=ROLE_BOUNDARY, dem_id=n_blocks))
    scene = build_scene(groups, dim=2, total_no_bodies=n_blocks + 1,
                        spacing0=dx)
    scheme = JRigidBody2DScheme(rigid_bodies=[f"b{b}" for b in
                                              range(n_blocks)],
                                boundaries=["floor"], gy=-9.81, dim=2)
    scheme.engine = "cell"
    return scheme, scheme.setup(scene)


@pytest.fixture(scope="module")
def wide():
    """The wide scene on both sides, and 10 reference cell steps."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    jscheme, jscene = _wide_scene()
    jbase = jscheme.cell_config(jscene, jget_kernel(jscheme.kernel_name, 2))
    tscheme = RigidBody2DScheme(jscheme.rigid_bodies, ["floor"], dim=2,
                                gy=-9.81)
    tscene = _port(jscene)
    step = jscheme.make_step(jscene)
    end = jscene
    for _ in range(STEPS):
        end = step(end, jnp.asarray(DT))
    return jscheme, jscene, jbase, tscheme, tscene, end


def _configs(wide, P):
    jscheme, jscene, jbase, tscheme, tscene, _ = wide
    base = tscheme.cell_config(tscene, get_kernel(tscheme.kernel_name, 2))
    return (jslab.make_slab_config(jscene, jbase, P),
            tslab.make_slab_config(tscene, base, P))


def _assert_scenes_equal(t, j, rows=None):
    """Every field of the port scene ``t`` equals the reference's ``j``
    (rows reordered by ``rows`` = (port order, reference order))."""
    assert set(t.fields) == set(j.fields)
    for k in j.fields:
        a, b = t[k].numpy(), np.asarray(j[k])
        if rows is not None and a.ndim >= 1 and a.shape[0] == t.n:
            a, b = a[rows[0]], b[rows[1]]
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("P", [4, 8])
def test_slab_config_and_decompose_match_reference(wide, P):
    jscheme, jscene, jbase, tscheme, tscene, _ = wide
    jcfg, tcfg = _configs(wide, P)
    for f in ("cell", "M", "NC_max", "origin", "dims", "sub", "nbr_width"):
        assert getattr(tcfg.base, f) == getattr(jbase, f), f
    for f in CFG_FIELDS:
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.slab_lo(P) == jcfg.slab_lo(P)
    for blob in (False, True):
        _assert_scenes_equal(tslab.slab_decompose(tscene, tcfg, blob),
                             jslab.slab_decompose(jscene, jcfg, blob))
    # the default is the blob; the host redistribution keeps the layout
    # (the reference's returns the full schema: compare it deblobified)
    tdec = tslab.slab_decompose(tscene, tcfg)
    assert "slot_blob" in tdec
    tred = tslab.redistribute(tdec, tcfg)
    assert "slot_blob" in tred
    _assert_scenes_equal(
        trb.deblobify_slot_scene(tred),
        jslab.redistribute(jslab.slab_decompose(jscene, jcfg, True), jcfg))


def test_blob_round_trip_matches_reference(wide):
    end = wide[-1]
    jb = jrb.blobify_slot_scene(end)
    tsc = _port(end)
    tb = trb.blobify_slot_scene(tsc)
    assert float(np.abs(np.asarray(jb.slot_blob)).max()) > 0
    _assert_scenes_equal(tb, jb)
    back = trb.deblobify_slot_scene(tb)
    assert set(back.fields) == set(tsc.fields)
    for k in trb.CL_FIELDS:
        assert torch.equal(back[k], tsc[k]), k


def _match_xy(g, ref):
    """(port active rows in (x, y) order, reference rows in that
    order)."""
    act = g.active.numpy()
    rows = np.nonzero(act)[0]
    ks = rows[np.lexsort((g.y.numpy()[act], g.x.numpy()[act]))]
    kr = np.lexsort((np.asarray(ref.y), np.asarray(ref.x)))
    assert len(ks) == ref.n
    return ks, kr


def _assert_single_device(g, ref):
    ks, kr = _match_xy(g, ref)
    for k in ("x", "y", "u", "v"):
        np.testing.assert_allclose(g[k].numpy()[ks], np.asarray(ref[k])[kr],
                                   rtol=0, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(g.force.numpy(), np.asarray(ref.force),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(g.xcm.numpy(), np.asarray(ref.xcm), rtol=0,
                               atol=1e-9)


def _run(wide, P, blob):
    jscheme, jscene, jbase, tscheme, tscene, _ = wide
    _, cfg = _configs(wide, P)
    mesh = make_mesh(P, [CPU] * P)
    parts = tslab.shard_slab_scene(tslab.slab_decompose(tscene, cfg, blob),
                                   mesh)
    step = tslab.make_slab_step(tscheme, parts, mesh, cfg)
    interesting = 0
    for _ in range(STEPS):
        parts = step(parts, DT)
        if blob:
            interesting = max(interesting, max(int(p.n_interesting)
                                               for p in parts))
    g = tslab.gather_slab_scene(parts)
    assert not bool(g.nbr_overflow)
    return g, interesting


def test_slab_step_blob_route_matches_single_device(wide):
    g, interesting = _run(wide, 4, blob=True)
    assert "slot_blob" in g and "contact_force_normal_x" not in g
    assert interesting > 0            # the culled rows hold contacts
    assert float(g.slot_blob.abs().max()) > 0
    _assert_single_device(g, wide[-1])
    S = g.meta.total_no_bodies
    assert float(g.slot_blob[:, 21 * S:22 * S].max()) > 0   # overlap


def test_slab_step_full_route_matches_reference_slab_step(wide):
    jscheme, jscene, jbase, tscheme, tscene, end = wide
    P = 8
    g, _ = _run(wide, P, blob=False)
    _assert_single_device(g, end)
    assert float(g.overlap.max()) > 0
    # the reference's slab step on its 8 virtual devices, row for row
    jcfg, _ = _configs(wide, P)
    mesh = jmesh(P)
    dec = jslab.shard_slab_scene(jslab.slab_decompose(jscene, jcfg), mesh)
    jstep = jslab.make_slab_step(jscheme, dec, mesh, jcfg, chain=STEPS)
    js = jstep(dec, jnp.asarray(DT))
    assert not bool(np.asarray(js.nbr_overflow))
    np.testing.assert_array_equal(g.active.numpy(), np.asarray(js.active))
    for k in ("x", "y", "u", "v", "fx", "fy", "contact_force_dist",
              "delta_lt_x", "delta_lt_y", "fn_x", "fn_y", "overlap"):
        np.testing.assert_allclose(g[k].numpy(), np.asarray(js[k]), rtol=0,
                                   atol=1e-7 if k[0] in "fd" else 1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(g.force.numpy(), np.asarray(js.force),
                               rtol=0, atol=1e-7)


def test_redistribute_matches_reference(wide):
    """Every active row moved by 2 dx (data only: redistribution is a
    data movement), so rows near the faces change slab."""
    jscheme, jscene, jbase, tscheme, tscene, _ = wide
    P = 4
    jcfg, cfg = _configs(wide, P)
    shift = 2 * jscene.meta.spacing0
    jdec = jslab.slab_decompose(jscene, jcfg)
    jdec = jdec.replace(x=jnp.where(jdec.active, jdec.x + shift, jdec.x))
    tdec = tslab.slab_decompose(tscene, cfg, use_blob=False)
    tdec = tdec.replace(x=torch.where(tdec.active, tdec.x + shift, tdec.x))
    act = tdec.active.numpy()
    own = np.arange(tdec.n) // cfg.n_cap
    moved = act & (tslab._slab_of(tdec.x, cfg) != own)
    assert moved.sum() > 0
    jh = jslab.redistribute(jdec, jcfg)

    # host: field for field
    th = tslab.redistribute(tdec, cfg)
    _assert_scenes_equal(th, jh)

    # device: each slab holds the same rows (in its own order)
    mesh = make_mesh(P, [CPU] * P)
    parts = tslab.shard_slab_scene(tdec, mesh)
    redis = tslab.make_slab_redistribute(parts, mesh, cfg)
    parts = redis(parts)
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
    # the redistributed slabs step on
    step = tslab.make_slab_step(tscheme, parts, mesh, cfg)
    assert not bool(tslab.gather_slab_scene(step(parts, DT)).nbr_overflow)
