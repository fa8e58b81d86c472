"""The hand-written CUDA kernels against their plain PyTorch twins, on
the card.  Every test here needs an NVIDIA card and ``nvcc``; without a
card they skip.  This file imports no JAX, so on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances: the pack expansion is a copy (bit-exact); the contact
kernel's pick columns (closest distance, picked source fields) are a
minimum and copies (bit-exact, the kernel is built without FMA
contraction); its sum-derived columns differ from the twin's only by
summation order (f32: rtol 1e-5, absolute floor 1e-5 of the column's
largest magnitude).  The DEM kernels' tables and counts are bit-exact
(the gate decisions round as the twin's), their sums within the
summation-order tolerance of ``tests/test_pallas_dem.py`` and their
springs within rtol 1e-4, from an empty contact table, a filled one,
one whose contacts open and close and a crowded one (more gated partners
than table slots).  The coupling fluid kernels' sums
are within 2e-5 of each column's largest magnitude (the contact
normals, unit vectors, 2e-5 absolute), their contact picks bit for bit,
and 3 kernel coupling steps match 3 plain ones within rtol 1e-4, in each
GTVF ordering and with no fluid group, each with its launches per step.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu_torch.geom import get_2d_block, get_3d_block
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops import pack_expand as tpe
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import QuinticSpline
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group, build_scene, rigid_setup, ROLE_RIGID, ROLE_BOUNDARY)

pytestmark = pytest.mark.cuda
PARAMS = dict(kr=1e5, kf=1e3, fric_coeff=0.5, gx=0.0, gy=-9.81, gz=0.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _scene(dim, dev, dx=0.02):
    """Two touching blocks just above a wall/floor, random velocities."""
    rng = np.random.default_rng(3)
    if dim == 2:
        xb, yb = get_2d_block(dx, 0.2, 0.2)
        zb = np.zeros_like(xb)
        xw = np.arange(-10, 30) * dx
        zw = np.zeros_like(xw)
    else:
        xb, yb, zb = get_3d_block(dx, 0.1, 0.1, 0.1)
        xw, zw = (a.ravel() for a in np.meshgrid(np.arange(-5, 15) * dx,
                                                 np.arange(-5, 10) * dx))
    width = xb.max() - xb.min()
    x = np.concatenate([xb, xb + width + 0.6 * dx])
    y = np.concatenate([yb, yb])
    z = np.concatenate([zb, zb])
    bid = np.repeat(np.arange(2, dtype=np.int32), len(xb))
    yw = np.full(len(xw), yb.min() - 0.7 * dx)
    m = 2000 * dx**dim
    body = make_group("body", x, y, z=z, m=m, h=1.3 * dx, rho=2000.0,
                      role=ROLE_RIGID, body_id=bid, dem_id=bid)
    wall = make_group("wall", xw, yw, z=zw, m=m, h=1.3 * dx, rho=2000.0,
                      role=ROLE_BOUNDARY, dem_id=2)
    scene = build_scene([body, wall], dim=dim, total_no_bodies=3,
                        spacing0=dx, device=dev, dtype=torch.float32)
    scene = trb._attach_contact_fields(rigid_setup.setup_body_state(scene))
    n = scene.n
    vel = lambda: torch.as_tensor(rng.uniform(-1, 1, n), dtype=torch.float32,
                                  device=dev)
    scene = scene.replace(contact_force_is_boundary=torch.ones(
        n, dtype=torch.float32, device=dev), u=vel(), v=vel())
    if dim == 3:
        scene = scene.replace(w=vel())
    host = lambda k: scene[k].cpu().numpy()
    cfg = tcell.config_from_positions(host("x"), host("y"), host("z"),
                                      3 * 1.3 * dx, dim)
    return scene, cfg


@pytest.mark.parametrize("dim", [2, 3])
def test_pack_expand_kernel_is_bitwise_twin(dev, dim):
    scene, cfg = _scene(dim, dev)
    _, pt = tcell.build_cell_grid_packed(
        scene.x, scene.y, scene.z, scene.active, cfg,
        tck.contact_payload(scene, dim == 2))
    sent = torch.tensor(tck.sent_fields(dim == 2), device=dev)
    before = _build.LAUNCHES["pack_expand"]
    got = tpe.expand_slots(pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pack_expand"] == before + 1
    ref = tpe.expand_slots_reference(pt.sorted_fields, pt.base, pt.cnt,
                                      sent, cfg.M)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("F,M,NC", [(7, 16, 40), (9, 8, 33), (13, 5, 20),
                                    (14, 32, 17), (14, 16, 300), (7, 16, 0)])
def test_pack_expand_kernel_random_packs(dev, F, M, NC):
    """Random sorted fields and slot counts (the first slots empty, some
    full): slot widths of 5 (no 16-byte stores) and 32, the coupling
    pack's 13 and 14 fields, no slot at all (only the sentinel row)."""
    rng = np.random.default_rng(F * 1000 + M * 10 + NC)
    cnt = rng.integers(0, M + 1, NC)
    cnt[:min(NC, 2)] = 0
    cnt[2:4] = M
    base = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
    n = max(int(cnt.sum()), 1)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    sorted_f = t(rng.standard_normal((F, n)), torch.float32)
    sent = t(rng.standard_normal(F), torch.float32)
    base, cnt = t(base[:NC], torch.int64), t(cnt, torch.int64)
    got = tpe.expand_slots(sorted_f, base, cnt, sent, M)
    torch.cuda.synchronize()
    ref = tpe.expand_slots_reference(sorted_f, base, cnt, sent, M)
    assert got.shape == (NC + 1, F, M)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dim", [2, 3])
def test_contact_kernel_matches_twin(dev, dim):
    scene, cfg = _scene(dim, dev)
    kernel = QuinticSpline(dim=dim)
    S = scene.meta.total_no_bodies
    grid, pt, dfT = tck.pack_scene(scene, cfg)
    qsel, nbr, valid, _, n_int = tck.select_queries(dfT, grid, pt, cfg,
                                                    cfg.NC_max)
    assert int(n_int) > 0
    args = (dfT, qsel, nbr, S, cfg.radius, 4.0 * scene.meta.spacing0,
            kernel)
    before = _build.LAUNCHES["contact"]
    got = tck.contact_sums(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["contact"] == before + 1
    ref = tck.contact_sums_reference(*args)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert (ref[..., 5 * S:6 * S] < 4.0 * scene.meta.spacing0).any()
    np.testing.assert_array_equal(got[..., 5 * S:], ref[..., 5 * S:])
    for c in range(5):
        a, b = got[..., c * S:(c + 1) * S], ref[..., c * S:(c + 1) * S]
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30),
                                   err_msg=f"block {c}")


def _check_contact(got, ref, S):
    """Picks (blocks 5-11) bit for bit, sums within the f32 summation
    order's tolerance (the unit normals, blocks 0-2, on a scale of 1)."""
    assert torch.equal(got[..., 5 * S:], ref[..., 5 * S:])
    for c in range(5):
        a, b = got[..., c * S:(c + 1) * S], ref[..., c * S:(c + 1) * S]
        scale = max(float(b.abs().max()), 1.0 if c < 3 else 1e-30)
        assert bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-5 * scale).all()), c


def _contact_pack(dim, S, dev, seed, nrows=48, NI=40, O=12, M=16, box=5,
                  jitter=0.0):
    """A random contact pack on a lattice of spacing 2^-6 (coordinates and
    their differences exact in f32, so equal distances tie exactly):
    lanes live with p 0.6, dems uniform in [0, S), contact surface with p
    0.7, fluid with p 0.1, rigid with p 0.7; the last row all-sentinel;
    stencil rows drawn at random (the sentinel row among them) and a few
    padding query rows.  ``jitter`` moves each live lane off the lattice
    by up to that many spacings (drawn last).  Returns the kernel's
    arguments."""
    rng = np.random.default_rng(seed)
    two_d = dim == 2
    fi = tck.field_index(two_d)
    sp = 2.0 ** -6
    dfT = np.tile(np.asarray(tck.sent_fields(two_d), np.float32)[None, :, None],
                  (nrows, 1, M))
    live = rng.random((nrows - 1, M)) < 0.6
    shape = (nrows - 1, M)
    vals = dict(x=rng.integers(0, box, shape) * sp,
                y=rng.integers(0, box, shape) * sp,
                u=rng.uniform(-1, 1, shape), v=rng.uniform(-1, 1, shape),
                vol=np.full(shape, 1e-6), h=np.full(shape, 1.3 * sp),
                flags=tck.encode_flags(
                    rng.integers(0, S, shape).astype(np.float64),
                    (rng.random(shape) < 0.7).astype(np.float64),
                    (rng.random(shape) < 0.1).astype(np.float64),
                    (rng.random(shape) < 0.7).astype(np.float64)))
    if not two_d:
        vals.update(z=rng.integers(0, box, shape) * sp,
                    w=rng.uniform(-1, 1, shape))
    for k, v in vals.items():
        dfT[:-1, fi[k]] = np.where(live, v, dfT[:-1, fi[k]])
    nbr = rng.integers(0, nrows, (NI, O))
    qslot = rng.integers(0, nrows - 1, NI)
    qslot[-3:] = nrows - 1                     # padding rows
    nbr[-3:] = nrows - 1
    if jitter:
        for k in ("x", "y") + (() if two_d else ("z",)):
            off = rng.uniform(-jitter, jitter, shape) * sp
            dfT[:-1, fi[k]] = np.where(live, dfT[:-1, fi[k]] + off,
                                       dfT[:-1, fi[k]])
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    return (t(dfT, torch.float32), t(qslot, torch.int64),
            t(nbr, torch.int64), S, 2.5 * sp, 4.0 * sp, QuinticSpline(dim=dim))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("S", [3, 9, 34, 64])
def test_contact_kernel_random_packs(dev, dim, S):
    """Random packs with many dems a query lane (S = 34 is the stack of
    cylinders, 64 the kernel's bound; more than the kernel's K
    accumulators a lane, so its extra passes run) and exact distance
    ties: the kernel equals its twin."""
    args = _contact_pack(dim, S, dev, seed=S + 10 * dim)
    got = tck.contact_sums(*args)
    ref = tck.contact_sums_reference(*args)
    torch.cuda.synchronize()
    init = args[5]
    picked = ref[..., 5 * S:6 * S] < init
    assert int(picked.sum()) > 0
    if S >= 34:   # some lanes reach more dems than one pass takes
        assert int(picked.sum(-1).max()) > 4
    _check_contact(got, ref, S)


@pytest.mark.parametrize("dim", [2, 3])
def test_contact_kernel_crowded_stencil(dev, dim):
    """Stencils of 640 entries, most lanes candidates of 3 dems: more
    candidates than the kernel sorts at once (1,536: three windows here),
    so it sums them in windows and carries a dem's sums and pick across
    them."""
    S = 3
    args = _contact_pack(dim, S, dev, seed=7 + dim, nrows=40, NI=10, O=640,
                         box=4)
    got = tck.contact_sums(*args)
    ref = tck.contact_sums_reference(*args)
    torch.cuda.synchronize()
    dfT, qslot, nbr = args[:3]
    flags = tck.decode_flags(dfT[:, -1])
    cand = ((flags[1] == 1.0) & (flags[2] == 0.0) & (flags[0] >= 0)).sum(1)
    assert int(cand[nbr[0]].sum()) > 2 * 1536
    assert int((ref[..., 5 * S:6 * S] < args[5]).sum()) > 0
    _check_contact(got, ref, S)


@pytest.mark.parametrize("dim", [2, 3])
def test_contact_kernel_picks_the_lowest_lane_on_a_tie(dev, dim):
    """One query lane at the origin and three sources of one dem at the
    same distance: in stencil entries 1 and 2 (entry 0 is the sentinel
    row) and in a later lane of entry 1.  The pick is the lowest stencil
    lane, entry 1 lane 3."""
    two_d = dim == 2
    fi = tck.field_index(two_d)
    M, S, sp = 16, 3, 2.0 ** -6
    dfT = np.tile(np.asarray(tck.sent_fields(two_d), np.float32)[None, :, None],
                  (4, 1, M))

    def put(row, lane, x, y, dem, rigid, u):
        for k, v in dict(x=x, y=y, u=u, v=-u, vol=1e-6, h=1.3 * sp,
                         flags=tck.encode_flags(dem, 1.0, 0.0, rigid)).items():
            dfT[row, fi[k], lane] = v
        if not two_d:
            dfT[row, fi["z"], lane] = 0.0
            dfT[row, fi["w"], lane] = 0.0

    put(0, 0, 0.0, 0.0, 0, 1.0, 0.0)       # the query
    put(1, 3, sp, 0.0, 1, 1.0, 0.25)       # the first of the tie
    put(1, 9, 0.0, -sp, 1, 1.0, 0.5)
    put(2, 0, -sp, 0.0, 1, 1.0, 0.75)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    args = (t(dfT, torch.float32), t([0], torch.int64),
            t([[3, 1, 2]], torch.int64), S, 2.5 * sp, 4.0 * sp,
            QuinticSpline(dim=dim))
    got = tck.contact_sums(*args)
    ref = tck.contact_sums_reference(*args)
    torch.cuda.synchronize()
    _check_contact(got, ref, S)
    assert float(got[0, 0, 5 * S + 1]) == sp       # closest distance
    assert float(got[0, 0, 6 * S + 1]) == sp       # picked x
    assert float(got[0, 0, 9 * S + 1]) == 0.25     # picked u


def test_contact_kernel_one_dem_pack_gives_the_init_row(dev):
    """Every lane rigid and on the contact surface, all of one dem: no
    pair passes the gate, so every row of every slot is the init row."""
    dfT, qslot, nbr, S, cut, init, kern = _contact_pack(2, 9, dev, seed=5)
    flags = dfT[:, 6]
    dfT[:, 6] = torch.where(flags == -8.0, flags,
                            torch.full_like(flags, float(tck.encode_flags(
                                4.0, 1.0, 0.0, 1.0))))
    qslot = torch.arange(dfT.shape[0] - 1, device=dev)
    nbr = torch.randint(0, dfT.shape[0], (qslot.shape[0], 12), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    args = (dfT, qslot, nbr, S, cut, init, kern)
    got = tck.contact_sums(*args)
    torch.cuda.synchronize()
    init_row = torch.zeros(12 * S, device=dev)
    init_row[5 * S:6 * S] = init
    assert torch.equal(got, init_row.expand_as(got))
    assert torch.equal(got, tck.contact_sums_reference(*args))


@pytest.mark.parametrize("dim", [2, 3])
def test_contact_kernel_culled_rows_equal_every_slot_rows(dev, dim):
    """The culled rows (the rigid path) and every slot (the cell
    pipeline) of one pack: the culled rows' output is bit for bit the
    every-slot output at those slots."""
    scene, cfg = _scene(dim, dev)
    kernel = QuinticSpline(dim=dim)
    S = scene.meta.total_no_bodies
    grid, pt, dfT = tck.pack_scene(scene, cfg)
    qsel, nbr, valid, _, _ = tck.select_queries(dfT, grid, pt, cfg,
                                                cfg.NC_max)
    init = 4.0 * scene.meta.spacing0
    culled = tck.contact_sums(dfT, qsel, nbr, S, cfg.radius, init, kernel)
    every = tck.contact_sums(dfT, torch.arange(cfg.NC_max, device=dev),
                             grid.nbr_slots, S, cfg.radius, init, kernel)
    torch.cuda.synchronize()
    assert int(valid.sum()) > 0
    assert torch.equal(culled[valid], every[qsel[valid]])


def test_kernel_step_matches_plain_step(dev):
    scene, cfg = _scene(2, dev)
    ni = cfg.NC_max
    scene = trb.compact_slot_scene(scene, ni * cfg.M)
    kernel = QuinticSpline(dim=2)
    fast = trb.build_rigid_gtvf_step_cell(kernel, cfg, PARAMS, True, ni)
    plain = trb.build_rigid_gtvf_step_cell(kernel, cfg, PARAMS, True, ni,
                                           plain=True)
    a = b = scene
    for _ in range(3):
        a, b = fast(a, 1e-4), plain(b, 1e-4)
    assert not bool(a.nbr_overflow)
    for k in ("x", "y", "u", "v", "fx", "fy", "xcm", "vcm", "omega"):
        x, y = a[k].cpu().numpy(), b[k].cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(y).max(), 1.0),
                                   err_msg=k)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    scene, cfg = _scene(2, dev)
    _, pt = tcell.build_cell_grid_packed(
        scene.x, scene.y, scene.z, scene.active, cfg,
        tck.contact_payload(scene, True))
    sent = torch.tensor(tck.sent_fields(True), device=dev)
    with pytest.raises(ValueError):
        tpe.expand_slots(pt.sorted_fields.double(), pt.base, pt.cnt,
                         sent.double(), cfg.M)
    with pytest.raises(ValueError):
        tpe.expand_slots(pt.sorted_fields, pt.base.int(), pt.cnt.int(),
                         sent, cfg.M)
    dfT = torch.zeros((4, 7, 16), device=dev)
    q = torch.zeros(2, dtype=torch.int64, device=dev)
    nbr = torch.zeros((2, 9), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):   # every S >= 1 has an instance
        tck.contact_sums(dfT, q, nbr, 0, 0.1, 0.2, QuinticSpline(dim=2))
    with pytest.raises(ValueError):
        tck.contact_sums(dfT, q.int(), nbr.int(), 3, 0.1, 0.2,
                         QuinticSpline(dim=2))


# ---------------------------------------------------------------------------
# DEM kernels (csrc/dem.cu): table idx, dem, slot positions and counts bit
# for bit; force and torque sums within 2e-5 |ref| + 2e-5 max |ref|
# (summation order); springs within rtol 1e-4 (operation order)
# ---------------------------------------------------------------------------

def _dem_scene(dim, dev, grid="spill", table="filled", n_side=24, L=8,
               crowd=None):
    """A block of grains spaced 0.995 of a diameter (every lattice pair
    overlaps) over a floor, seeded random velocities and spins, and a
    contact table: ``"empty"`` as the setup leaves it (the kernel
    allocates every contact), ``"filled"`` by one plain pass, or
    ``"moved"``: advanced by a plain pass at positions jittered by up to
    an overlap (1e-5), then met at positions jittered again, so contacts
    open and close and slots are freed and reallocated.  ``"crowded"``
    squeezes the block (2D: both axes to 0.5; 3D: x to 0.7, y to 0.5) so
    every inner grain has 12 gated partners for its 8 slots, on a grid
    with bins of the contact radius, and meets it as ``"moved"`` from the
    empty table: full tables, new contacts dropped.  ``crowd`` squeezes
    the crowded block to that fraction on every axis instead (0.4 in 2D:
    20 gated partners a grain)."""
    from rigid_body_2d_3d_pysph_tpu_torch.models import DEMScheme
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    r, s = 1e-3, 1.99e-3
    ax = np.arange(n_side) * s
    if dim == 2:
        xg, yg = (a.ravel() for a in np.meshgrid(ax, ax))
        zg = np.zeros_like(xg)
        xf = np.arange(-10, n_side + 10) * 2 * r
        zf = np.zeros_like(xf)
    else:
        xg, yg, zg = (a.ravel() for a in np.meshgrid(ax, ax[:8], ax))
        xf, zf = (a.ravel() for a in np.meshgrid(
            np.arange(-3, n_side + 3) * 2 * r, np.arange(-3, n_side + 3) * 2 * r))
    if table == "crowded" and crowd is not None:
        xg, yg, zg = xg * crowd, yg * crowd, zg * crowd
    elif table == "crowded":
        xg, yg = xg * (0.5 if dim == 2 else 0.7), yg * 0.5
    m = 2600.0 * r**dim
    grains = make_group("sand", xg, yg + 0.99 * r, z=zg, m=m, h=2 * r,
                        rho=2600.0, rad_s=r, role=ROLE_RIGID, dem_id=0)
    floor = make_group("floor", xf, np.full(len(xf), -r), z=zf, m=m,
                       h=2 * r, rho=2600.0, rad_s=r, role=ROLE_BOUNDARY,
                       dem_id=1)
    scene = build_scene([grains, floor], dim=dim, total_no_bodies=2,
                        spacing0=s, device=dev, dtype=torch.float32)
    scheme = DEMScheme(["sand"], ["floor"], dim=dim, gy=-9.81,
                       max_tng_contacts_limit=L, dem_grid=grid)
    if table == "crowded":
        scheme.cell_factor = 1.0
    scene = scheme.setup(scene)
    rng = np.random.default_rng(11)
    rnd = lambda a: torch.as_tensor(rng.uniform(-a, a, scene.n),
                                    dtype=torch.float32, device=dev)
    scene = scene.replace(u=rnd(0.05), v=rnd(0.05), wz=rnd(50.0))
    if dim == 3:
        scene = scene.replace(w=rnd(0.05), wx=rnd(50.0), wy=rnd(50.0))
    if grid == "spill":
        cfg, run = scheme.cell_config(scene), tdk.lvc_displacement_cell_kernel
    else:
        cfg, run = scheme.rowwin_config(scene), tdk.lvc_displacement_rowwin_kernel
    axes = ("x", "y", "z")[:dim]
    jitter = lambda sc: sc.replace(**{k: sc[k] + rnd(1e-5) for k in axes})

    def plain_pass(sc):
        p = run(sc, cfg, 1e-5, sc.tng_idx, sc.tng_idx_dem_id, sc.tng_x,
                sc.tng_y, sc.tng_z, plain=True)
        assert int(p.count.sum()) > 0
        return sc.replace(tng_idx=p.tng_idx, tng_idx_dem_id=p.tng_dem,
                          tng_x=p.tng_x, tng_y=p.tng_y, tng_z=p.tng_z)

    if table == "filled":
        scene = plain_pass(scene)
    elif table == "moved":
        scene = jitter(plain_pass(jitter(plain_pass(scene))))
    elif table == "crowded":
        scene = jitter(plain_pass(jitter(scene)))
    return scene, cfg


def _table_changes(before, idx, dem):
    """(allocated, freed) slots from the table ``before`` to (idx, dem)."""
    changed = (idx != before.tng_idx) | (dem != before.tng_idx_dem_id)
    return (int((changed & (idx >= 0)).sum()),
            int((changed & (before.tng_idx >= 0)).sum()))


def _check_table_changes(table, before, sums, idx, dem):
    alloc, freed = _table_changes(before, idx, dem)
    if table == "empty":
        assert alloc > 0 and freed == 0
    if table in ("moved", "crowded"):
        assert alloc > 0 and freed > 0
    if table == "crowded":   # more gated partners than slots; full tables
        L = idx.shape[1]
        assert bool((sums[:, 7] > L).any()) and bool((sums[:, 6] == L).any())


def _check_dem_outputs(got, ref):
    """Kernel against twin (sums [N, 8], idx, dem, sx, sy, sz [N, L])."""
    assert torch.equal(got[0][:, 6:], ref[0][:, 6:])      # counts, gated
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    _check_sums(got[0][:, :6], ref[0][:, :6], "sums")
    for a, b in zip(got[3:], ref[3:]):
        assert torch.allclose(a, b, rtol=1e-4, atol=0)


def _check_sums(a, b, what):
    tol = 2e-5 * b.abs() + 2e-5 * float(b.abs().max())
    assert bool(((a - b).abs() <= tol).all()), \
        f"{what}: off by {float((a - b).abs().max())}"


TABLES = ["empty", "filled", "moved", "crowded"]


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("dim", [2, 3])
def test_dem_cell_kernel_matches_twin(dev, dim, table):
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_cell as tdc
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    scene, cfg = _dem_scene(dim, dev, table=table)
    grid, pt = tcell.build_cell_grid_packed(
        scene.x, scene.y, scene.z, scene.active, cfg, tdk.dem_payload(scene))
    assert not bool(grid.overflow)
    dfT = tpe.expand_slots(pt.sorted_fields, pt.base, pt.cnt,
                           torch.tensor(tdc.SENT, device=dev), cfg.M)
    args = (dfT, grid.nbr_slots, scene.tng_idx, scene.tng_idx_dem_id,
            scene.tng_x, scene.tng_y, scene.tng_z, tdk.material_table(scene),
            1e-5, cfg)
    before = _build.LAUNCHES["dem_cell"]
    got = tdk.dem_cell_sums(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dem_cell"] == before + 1
    ref = tdk.dem_cell_sums_reference(*args)
    assert int(ref[0][:, 7].sum()) > int(ref[0][:, 6].sum()) // 2 > 0
    _check_table_changes(table, scene, *ref[:3])
    _check_dem_outputs(got, ref)


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("dim", [2, 3])
def test_dem_rowwin_kernel_matches_twin(dev, dim, table):
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_cell as tdc
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
    from rigid_body_2d_3d_pysph_tpu_torch.ops import rowwin as trw

    scene, cfg = _dem_scene(dim, dev, grid="rowwin", table=table)
    grid, pt = trw.build_row_window_grid(
        scene.x, scene.y, scene.z, scene.active, cfg, tdk.dem_payload(scene))
    assert not bool(grid.overflow)
    dfs = tpe.expand_slots(pt.sorted_fields, pt.base, pt.cnt,
                           torch.tensor(tdc.SENT, device=dev), cfg.M)
    args = (dfs, grid.nbr_runs, grid.run_cnt, scene.tng_idx,
            scene.tng_idx_dem_id, scene.tng_x, scene.tng_y, scene.tng_z,
            tdk.material_table(scene), 1e-5, cfg)
    before = _build.LAUNCHES["dem_rowwin"]
    got = tdk.dem_rowwin_sums(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dem_rowwin"] == before + 1
    ref = tdk.dem_rowwin_sums_reference(*args)
    assert int(ref[0][:, 6].sum()) > 0
    _check_table_changes(table, scene, *ref[:3])
    _check_dem_outputs(got, ref)


@pytest.mark.parametrize("grid", ["spill", "rowwin"])
def test_dem_kernels_take_a_narrow_table(dev, grid):
    # the scheme's default table of 6 slots: rows of 24 bytes, read and
    # written a word at a time
    from rigid_body_2d_3d_pysph_tpu_torch.models import DEMScheme
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    scene, _ = _dem_scene(2, dev, grid, "moved", L=6)
    assert scene.tng_idx.shape[1] == 6
    scheme = DEMScheme(["sand"], ["floor"], dim=2, gy=-9.81,
                       max_tng_contacts_limit=6, dem_grid=grid)
    cfg = (scheme.cell_config(scene) if grid == "spill"
           else scheme.rowwin_config(scene))
    run = (tdk.lvc_displacement_cell_kernel if grid == "spill"
           else tdk.lvc_displacement_rowwin_kernel)
    tabs = (scene.tng_idx, scene.tng_idx_dem_id, scene.tng_x, scene.tng_y,
            scene.tng_z)
    got = run(scene, cfg, 1e-5, *tabs)
    ref = run(scene, cfg, 1e-5, *tabs, plain=True)
    torch.cuda.synchronize()
    assert int(ref.count.sum()) > 0
    for k in ("tng_idx", "tng_dem", "count", "n_gated"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    for k in ("tng_x", "tng_y", "tng_z"):
        assert torch.allclose(getattr(got, k), getattr(ref, k), rtol=1e-4,
                              atol=0), k
    _check_sums(torch.stack([got.fx, got.fy, got.torz]),
                torch.stack([ref.fx, ref.fy, ref.torz]), "sums")


def _sorted_tables(scene):
    """Per row, the table's (idx, dem) keys and springs sorted by key."""
    key = torch.where(scene.tng_idx >= 0,
                      scene.tng_idx.long() * 8 + scene.tng_idx_dem_id.long(),
                      torch.full_like(scene.tng_idx, 2**62, dtype=torch.long))
    key, order = torch.sort(key, 1)
    spr = torch.stack([torch.gather(scene[k], 1, order)
                       for k in ("tng_x", "tng_y", "tng_z")])
    return key, spr


def test_dem_step_kernels_match_plain_step(dev):
    from rigid_body_2d_3d_pysph_tpu_torch.models import DEMScheme

    # from an empty table (the first step allocates every contact) and
    # from one whose contacts open and close
    for grid, table in [(g, t) for g in ("spill", "rowwin")
                        for t in ("empty", "moved")]:
        scene, _ = _dem_scene(2, dev, grid, table)
        scheme = DEMScheme(["sand"], ["floor"], dim=2, gy=-9.81,
                           max_tng_contacts_limit=8, dem_grid=grid)
        fast, plain = scheme.make_step(scene), scheme.make_step(scene, True)
        a = b = scene
        for _ in range(3):
            a, b = fast(a, 1e-5), plain(b, 1e-5)
        assert not bool(a.nbr_overflow)
        for k in ("x", "y", "u", "v", "wz", "fx", "fy", "torz"):
            x, y = a[k].cpu().numpy(), b[k].cpu().numpy()
            np.testing.assert_allclose(x, y, rtol=1e-4,
                                       atol=1e-4 * max(np.abs(y).max(), 1e-30),
                                       err_msg=f"{grid} {table} {k}")
        # the tables as (idx, dem) -> spring maps per row
        ka, sa = _sorted_tables(a)
        kb, sb = _sorted_tables(b)
        assert torch.equal(ka, kb), (grid, table)
        assert torch.allclose(sa, sb, rtol=1e-4,
                              atol=1e-4 * float(sb.abs().max())), (grid, table)


@pytest.mark.parametrize("table", ["empty", "filled", "moved", "crowded"])
@pytest.mark.parametrize("dim", [2, 3])
def test_dem_cell_kernel_with_gid_identity_matches_twin(dev, dim, table):
    """K4 on a row-permuted scene whose tables key on gids (the slab
    DEM step's tables), against its plain version on the same inputs,
    and against the kernel on the unpermuted scene (rows = gids)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    scene, cfg = _dem_scene(dim, dev, table=table)
    n = scene.n
    perm = torch.as_tensor(np.random.default_rng(5).permutation(n),
                           device=dev)
    sp = scene.with_fields(**{k: v[perm] for k, v in scene.fields.items()
                              if v.dim() >= 1 and v.shape[0] == n},
                           gid=perm.to(torch.int32))
    tabs = (sp.tng_idx, sp.tng_idx_dem_id, sp.tng_x, sp.tng_y, sp.tng_z)
    before = dict(_build.LAUNCHES)
    got = tdk.lvc_displacement_cell_kernel(sp, cfg, 1e-5, *tabs, n_ident=n)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dem_cell"] == before["dem_cell"] + 1
    assert _build.LAUNCHES["pack_expand"] == before["pack_expand"] + 1
    ref = tdk.lvc_displacement_cell_kernel(sp, cfg, 1e-5, *tabs, plain=True,
                                           n_ident=n)
    assert int(ref.count.sum()) > 0
    assert torch.equal(got.tng_idx, ref.tng_idx)
    assert torch.equal(got.tng_dem, ref.tng_dem)
    assert torch.equal(got.count, ref.count)
    assert torch.equal(got.n_gated, ref.n_gated)
    sums = lambda p: torch.stack([p.fx, p.fy, p.fz, p.torx, p.tory, p.torz],
                                 1)
    _check_sums(sums(got), sums(ref), "sums")
    for a, b in ((got.tng_x, ref.tng_x), (got.tng_y, ref.tng_y),
                 (got.tng_z, ref.tng_z)):
        assert torch.allclose(a, b, rtol=1e-4, atol=0)
    if table == "crowded":
        return   # full tables: which new contacts keep a slot follows
                 # the candidate order, which the permutation changes
    # gid-keyed entries: the unpermuted scene's pass, rows permuted
    own = tdk.lvc_displacement_cell_kernel(
        scene, cfg, 1e-5, scene.tng_idx, scene.tng_idx_dem_id, scene.tng_x,
        scene.tng_y, scene.tng_z)
    key = lambda p, rows: torch.sort(torch.where(
        p.tng_idx[rows] >= 0, p.tng_idx[rows].long() * 8
        + p.tng_dem[rows].long(), 2**62), 1).values
    all_rows = torch.arange(n, device=dev)
    assert torch.equal(key(got, all_rows), key(own, perm))
    _check_sums(sums(got), sums(own)[perm], "sums against the unpermuted")


# ---------------------------------------------------------------------------
# coupling fluid kernels (csrc/fluid.cu): sums within 2e-5 of the column's
# largest magnitude (the contact normals, unit vectors, 2e-5 absolute);
# contact picks bit for bit
# ---------------------------------------------------------------------------

FLUID_GAP = 0.95   # the box's face gap to the tank floor's top layer, in dx


def _coupling_scene(dev, with_body=True, dx=0.04, compact_min_bodies=None):
    """A small sinking-box tank: fluid, a 3-layer tank and a box (rho 2)
    resting FLUID_GAP dx above the floor with the fluid void carved, so
    gated contact pairs exist; seeded random velocities and body p_fsi.
    ``compact_min_bodies`` (set before the set-up) puts the kdkf step's
    slot state in the compact store."""
    from rigid_body_2d_3d_pysph_tpu_torch.geom import hydrostatic_tank_2d
    from rigid_body_2d_3d_pysph_tpu_torch.models import (
        RigidFluidCouplingScheme)
    from rigid_body_2d_3d_pysph_tpu_torch.state import ROLE_FLUID

    gy, rho0 = -1.0, 1.0
    xf, yf, xt, yt = hydrostatic_tank_2d(1.0, 0.8, 1.2, 3, dx, dx)
    p0 = -rho0 * gy * (yf.max() - yf)
    c0 = 10 * np.sqrt(2 * abs(gy) * 0.8)
    groups = [make_group("tank", xt, yt, m=rho0 * dx * dx, h=dx, rho=rho0,
                         rad_s=dx / 2, role=ROLE_BOUNDARY, dem_id=1)]
    if with_body:
        xb, yb = get_2d_block(dx, 0.3, 0.2)
        xb += (xf.min() + xf.max()) / 2.0
        yb += (-dx + FLUID_GAP * dx) - yb.min()
        keep = ~((xf > xb.min() - dx) & (xf < xb.max() + dx)
                 & (yf > yb.min() - dx) & (yf < yb.max() + dx))
        xf, yf, p0 = xf[keep], yf[keep], p0[keep]
        groups.append(make_group(
            "body", xb, yb, m=2 * rho0 * dx * dx, h=dx, rho=2 * rho0,
            rad_s=dx / 2, role=ROLE_RIGID, body_id=np.zeros(len(xb), np.int32),
            dem_id=np.zeros(len(xb), np.int32)))
    groups.insert(0, make_group("fluid", xf, yf, m=rho0 * dx * dx, h=dx,
                                rho=rho0, role=ROLE_FLUID, p=p0))
    scene = build_scene(groups, dim=2, total_no_bodies=2, spacing0=dx,
                        device=dev, dtype=torch.float32)
    scheme = RigidFluidCouplingScheme(
        ["fluid"], ["tank"], ["body"] if with_body else [], dim=2,
        rho0=rho0, p0=rho0 * c0**2, c0=c0, h=dx, nu=0.0, gy=gy)
    if compact_min_bodies is not None:
        scheme.compact_min_bodies = compact_min_bodies
    scene = scheme.setup(scene)
    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    rigid = scene.is_rigid
    upd = dict(u=t(rng.uniform(-0.2, 0.2, scene.n)),
               v=t(rng.uniform(-0.2, 0.2, scene.n)))
    if with_body:
        upd.update(
            m_fsi=torch.where(rigid, rho0 * dx * dx, scene.m_fsi),
            rho_fsi=torch.where(rigid, rho0, scene.rho_fsi),
            p_fsi=torch.where(rigid, t(rng.uniform(0, 1, scene.n)),
                              scene.p_fsi))
    return scheme, scene.replace(**upd)


def _check_fluid_columns(got, ref, what, unit=()):
    for c in range(ref.shape[-1]):
        a, b = got[..., c], ref[..., c]
        scale = max(float(b.abs().max()), 1.0 if c in unit else 1e-30)
        err = float((a - b).abs().max())
        assert err <= 2e-5 * scale, f"{what} column {c}: {err} (scale {scale})"


@pytest.mark.parametrize("which", ["rates_wall", "rates_wall_tank",
                                   "forces_contact", "forces", "rates",
                                   "rates_tait", "wall_bc", "forces_rigid"])
def test_fluid_kernels_match_twin(dev, which):
    """Each pass against its twin on the scene its step runs it on: B4
    with and without rigid bodies, B5 with, B6c without (the kdkf step);
    B6a with rigid bodies, EDAC and Tait, B6b and B6c with rigid bodies
    (the kdk and reference orderings)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    with_body = which not in ("rates_wall_tank", "forces")
    scheme, scene = _coupling_scene(dev, with_body=with_body)
    kernel = QuinticSpline(dim=2)
    cfg = scheme.cell_config(scene, kernel)
    grid, _, dfT = tfk.pack_fluid_sorted(scene, cfg)
    assert not bool(grid.overflow)
    S = scene.meta.total_no_bodies
    init = 4.0 * scene.meta.spacing0
    args = (dfT, grid.nbr_slots, kernel, cfg.radius)
    if which.startswith("rates_wall"):
        kname = "fluid_rates_wall"
        extra = (scheme.edac_nu, scheme.c0, True, with_body,
                 (0.0, -1.0, 0.0))
        fast, plain = tfk.fluid_rates_wall, tfk.fluid_rates_wall_reference
    elif which == "forces_contact":
        kname = "fluid_forces_contact"
        extra = (scheme.fluid_alpha, scheme.c0, S, init)
        fast = tfk.fluid_forces_contact
        plain = tfk.fluid_forces_contact_reference
    elif which.startswith("rates"):
        kname = "fluid_rates"
        extra = (scheme.edac_nu, scheme.c0, which == "rates", True)
        fast, plain = tfk.fluid_rates, tfk.fluid_rates_reference
    elif which == "wall_bc":
        kname = "wall_bc"
        extra = ((0.0, -1.0, 0.0),)
        fast, plain = tfk.wall_bc, tfk.wall_bc_reference
    else:
        kname = "fluid_forces"
        extra = (scheme.fluid_alpha, scheme.c0, which == "forces_rigid")
        fast, plain = tfk.fluid_forces, tfk.fluid_forces_reference
    before = _build.LAUNCHES[kname]
    got = _dense(fast(*args, *extra))
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kname] == before + 1
    ref = _dense(plain(*args, *extra))
    assert bool(torch.isfinite(got).all())
    assert float(ref.abs().max()) > 0
    if which != "forces_contact":
        _check_fluid_columns(got, ref, which)
        return
    assert int((ref[..., 5 * S:6 * S] < init).sum()) > 0      # gated pairs
    assert torch.equal(got[..., 5 * S:12 * S], ref[..., 5 * S:12 * S])
    _check_fluid_columns(got[..., :5 * S], ref[..., :5 * S], which,
                         unit=range(3 * S))
    _check_fluid_columns(got[..., 12 * S:], ref[..., 12 * S:], which)


def _fluid_pack(dim, S, seed, NC=48, O=12, M=16, box=5):
    """A random coupling pack ``[NC + 1, 14, M]`` on a lattice of spacing
    2^-6 (coordinates and their differences exact in f32, so equal
    distances tie exactly): slot s holds a prefix of live lanes (slots
    0-2 hold 0, 1 and 16, the others a random count), each lane fluid
    (p 0.5), static boundary (0.2) or rigid (0.3); the non-fluid lanes on
    the contact boundary with p 0.7; rigid lanes of dems drawn from
    [0, S), so a slot holds several, the boundary of dem S - 1; the
    stencil rows drawn at random, the no-neighbour entry NC among them.
    Returns numpy (dfT, nbr) and h = 2^-6."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    rng = np.random.default_rng(seed)
    sp = 2.0 ** -6
    dfT = np.tile(np.asarray(tfk.SENT, np.float32)[None, :, None],
                  (NC + 1, 1, M))
    cnt = rng.integers(0, M + 1, NC)
    cnt[:3] = (0, 1, M)
    live = np.arange(M)[None, :] < cnt[:, None]
    shape = (NC, M)
    kind = rng.choice(3, size=shape, p=[0.5, 0.2, 0.3])
    fluid, sb, rigid = (kind == k for k in range(3))
    cfib = ~fluid & (rng.random(shape) < 0.7)
    dem = np.where(rigid, rng.integers(0, S, shape), S - 1)
    lattice = lambda: rng.integers(0, box, shape) * sp
    uni = lambda lo, hi: rng.uniform(lo, hi, shape)
    vol = sp ** dim
    vals = {tfk.FX: lattice(), tfk.FY: lattice(),
            tfk.FZ: lattice() if dim == 3 else np.zeros(shape),
            tfk.FU: uni(-1, 1), tfk.FV: uni(-1, 1),
            tfk.FW: uni(-1, 1) if dim == 3 else np.zeros(shape),
            tfk.FM: uni(0.5, 1.5) * vol, tfk.FRHO: uni(0.9, 1.1),
            tfk.FH: np.full(shape, sp), tfk.FP: uni(-0.5, 1.0),
            tfk.FMFSI: uni(0.5, 1.5) * vol, tfk.FRHOFSI: uni(0.9, 1.1),
            tfk.FPFSI: uni(-0.5, 1.0),
            tfk.FFLAGS: dem * 16.0 + cfib * 8.0 + sb * 4.0 + fluid * 2.0
            + rigid}
    for f, v in vals.items():
        dfT[:NC, f] = np.where(live, v, dfT[:NC, f])
    nbr = rng.integers(0, NC + 1, (NC, O))
    return dfT, nbr, sp


def _fluid_pack_args(dim, S, dev, seed, alpha=0.1, **kw):
    """The pack of :func:`_fluid_pack` on ``dev`` with B5's arguments
    (cutoff 3 h, c0 10, the contact init distance 4 h)."""
    dfT, nbr, h = _fluid_pack(dim, S, seed, **kw)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    return (t(dfT, torch.float32), t(nbr, torch.int64),
            QuinticSpline(dim=dim), 3.0 * h, alpha, 10.0, S, 4.0 * h)


def _dense(b5):
    """B5's ``(forces [NC, M, 6], contact [NC, M, 12 S])`` (by query row
    at every slot) as one ``[NC, M, 12 S + 6]`` block; another output as
    it is."""
    return torch.cat([b5[1], b5[0]], -1) if isinstance(b5, tuple) else b5


def _check_forces_contact(got, ref, S):
    """B5 against its twin: the contact columns as K2's (picks bit for
    bit), the force columns within 2e-5 of each column's largest
    magnitude."""
    got, ref = _dense(got), _dense(ref)
    _check_contact(got[..., :12 * S], ref[..., :12 * S], S)
    _check_fluid_columns(got[..., 12 * S:], ref[..., 12 * S:], "forces")


@pytest.mark.parametrize("visc", [True, False])
@pytest.mark.parametrize("S", [1, 2, 3, 9])
@pytest.mark.parametrize("dim", [2, 3])
def test_fluid_forces_kernels_random_packs(dev, dim, S, visc):
    """B5 and B6c (with and without the FSI terms) against their twins on
    random packs: slots of 0, 1 and 16 live lanes, empty stencil
    entries, rigid lanes of several dems in one slot (S = 9: more than 32
    (rigid lane, entity slot) threads a slot), viscosity on and off."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    args = _fluid_pack_args(dim, S, dev, seed=100 * dim + 10 * S + visc,
                            alpha=0.1 if visc else 0.0)
    dfT, nbr, S, init = args[0], args[1], args[6], args[7]
    flags = tfk.decode_flags(dfT[:-1, tfk.FFLAGS])
    assert int((nbr == nbr.shape[0]).sum()) > 0          # empty entries
    rigid_dems = torch.where(flags[4] == 1.0, flags[0], -1.0)
    n_dems = [len(set(r.tolist()) - {-1.0}) for r in rigid_dems]
    assert max(n_dems) >= min(S, 3)
    got = _dense(tfk.fluid_forces_contact(*args))
    ref = _dense(tfk.fluid_forces_contact_reference(*args))
    torch.cuda.synchronize()
    if S > 1:
        assert int((ref[..., 5 * S:6 * S] < init).sum()) > 0
    _check_forces_contact(got, ref, S)
    for rigid in (True, False):
        fargs = args[:6] + (rigid,)
        got = tfk.fluid_forces(*fargs)
        ref = tfk.fluid_forces_reference(*fargs)
        torch.cuda.synchronize()
        assert float(ref.abs().max()) > 0
        _check_fluid_columns(got, ref, f"B6c rigid={rigid}")


@pytest.mark.parametrize("dim", [2, 3])
def test_fluid_forces_kernels_staging_windows(dev, dim):
    """Stencils of 64 entries: more live candidates than one staging
    window holds (224), so the kernels stage and sum in windows carried
    in stencil order, and B5 (S = 9) walks them again for each further
    group of 32 contact threads."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    args = _fluid_pack_args(dim, 9, dev, seed=70 + dim, NC=24, O=64, box=4)
    dfT, nbr = args[0], args[1]
    live = (dfT[:, tfk.FFLAGS] != -16.0).sum(1)
    assert int(live[nbr].sum(1).max()) > 2 * 224
    got = _dense(tfk.fluid_forces_contact(*args))
    ref = _dense(tfk.fluid_forces_contact_reference(*args))
    torch.cuda.synchronize()
    assert int((ref[..., 5 * 9:6 * 9] < args[7]).sum()) > 0
    _check_forces_contact(got, ref, 9)
    got = tfk.fluid_forces(*args[:6], True)
    ref = tfk.fluid_forces_reference(*args[:6], True)
    torch.cuda.synchronize()
    _check_fluid_columns(got, ref, "B6c windows")


@pytest.mark.parametrize("M", [5, 32])
def test_fluid_forces_kernels_other_slot_widths(dev, M):
    """Slots of 5 lanes (an output block not a multiple of 16 bytes: the
    rows written a word at a time, six stencil entries a staging step) and
    of 32 (one entry a step, a whole warp of queries)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    args = _fluid_pack_args(2, 3, dev, seed=40 + M, M=M)
    got = _dense(tfk.fluid_forces_contact(*args))
    ref = _dense(tfk.fluid_forces_contact_reference(*args))
    torch.cuda.synchronize()
    assert int((ref[..., 5 * 3:6 * 3] < args[7]).sum()) > 0
    _check_forces_contact(got, ref, 3)
    got = tfk.fluid_forces(*args[:6], True)
    ref = tfk.fluid_forces_reference(*args[:6], True)
    torch.cuda.synchronize()
    _check_fluid_columns(got, ref, f"B6c M={M}")


def test_fluid_forces_kernels_are_deterministic(dev):
    """Two launches on the same inputs give the same bits: B5 and B6c on
    the coupling scene and on a random 3D pack of several windows."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    scheme, scene = _coupling_scene(dev)
    kernel = QuinticSpline(dim=2)
    cfg = scheme.cell_config(scene, kernel)
    grid, _, dfT = tfk.pack_fluid_sorted(scene, cfg)
    packs = [(dfT, grid.nbr_slots, kernel, cfg.radius, scheme.fluid_alpha,
              scheme.c0, scene.meta.total_no_bodies,
              4.0 * scene.meta.spacing0),
             _fluid_pack_args(3, 3, dev, seed=5, NC=24, O=64, box=4)]
    for args in packs:
        for fn, a in ((tfk.fluid_forces_contact, args),
                      (tfk.fluid_forces, args[:6] + (True,)),
                      (tfk.fluid_forces, args[:6] + (False,))):
            one, two = _dense(fn(*a)), _dense(fn(*a))
            torch.cuda.synchronize()
            assert torch.equal(one, two)


def _rates_wall_calls(dfT, nbr, kernel, cutoff, nu=0.02, c0=10.0,
                      g=(0.1, -1.0, 0.3)):
    """(label, kernel launch name, wrapper, twin, arguments) for every
    instance of the rates/wall template: B4 and B6a with EDAC and with
    Tait, each with and without the FSI-rigid source class, and B6b."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    base = (dfT, nbr, kernel, cutoff)
    calls = []
    for edac in (True, False):
        for rigid in (True, False):
            tag = f"edac={edac} rigid={rigid}"
            calls.append((f"B4 {tag}", "fluid_rates_wall",
                          tfk.fluid_rates_wall, tfk.fluid_rates_wall_reference,
                          base + (nu, c0, edac, rigid, g)))
            calls.append((f"B6a {tag}", "fluid_rates", tfk.fluid_rates,
                          tfk.fluid_rates_reference,
                          base + (nu, c0, edac, rigid)))
    calls.append(("B6b", "wall_bc", tfk.wall_bc, tfk.wall_bc_reference,
                  base + (g,)))
    return calls


def _check_rates_wall(dfT, nbr, kernel, cutoff, **kw):
    """Every rates/wall instance against its twin, one launch each;
    returns {label: kernel output}."""
    outs = {}
    for label, kname, fast, plain, args in _rates_wall_calls(
            dfT, nbr, kernel, cutoff, **kw):
        before = _build.LAUNCHES[kname]
        got = fast(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[kname] == before + 1
        ref = plain(*args)
        assert bool(torch.isfinite(got).all()), label
        _check_fluid_columns(got, ref, label)
        outs[label] = got
    return outs


@pytest.mark.parametrize("dim", [2, 3])
def test_rates_wall_kernels_random_packs(dev, dim):
    """B4, B6a (EDAC and Tait, with and without bodies) and B6b against
    their twins on random packs: slots of 0, 1 and 16 live lanes, empty
    stencil entries, fluid, wall and rigid lanes mixed in a slot."""
    args = _fluid_pack_args(dim, 3, dev, seed=300 + dim)
    dfT, nbr, kernel, cutoff = args[:4]
    assert int((nbr == nbr.shape[0]).sum()) > 0          # empty entries
    outs = _check_rates_wall(dfT, nbr, kernel, cutoff)
    assert float(outs["B6b"].abs().max()) > 0
    assert float(outs["B4 edac=True rigid=True"][..., :2].abs().max()) > 0


@pytest.mark.parametrize("dim", [2, 3])
def test_rates_wall_kernels_staging_windows(dev, dim):
    """Stencils of 64 entries: more live candidates than one staging
    window holds (160), so the sums are staged and carried in windows."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    args = _fluid_pack_args(dim, 3, dev, seed=310 + dim, NC=24, O=64, box=4)
    dfT, nbr = args[0], args[1]
    live = (dfT[:, tfk.FFLAGS] != -16.0).sum(1)
    assert int(live[nbr].sum(1).max()) > 2 * 160
    _check_rates_wall(dfT, nbr, args[2], args[3])


@pytest.mark.parametrize("M", [5, 32])
def test_rates_wall_kernels_other_slot_widths(dev, M):
    """Slots of 5 lanes (output blocks not a multiple of 16 bytes, six
    stencil entries a staging step) and of 32 (a whole warp of queries)."""
    args = _fluid_pack_args(2, 3, dev, seed=320 + M, M=M)
    _check_rates_wall(*args[:4])


def test_rates_wall_kernels_one_class_slots(dev):
    """Slots whose lanes are all sentinels, all fluid, all static boundary
    or all rigid, beside mixed ones, so the query ballot's early stop runs
    for each instance: B6b writes zeros on the fluid and sentinel slots,
    B6a on the wall, rigid and sentinel slots, B4 on the sentinel slots."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    dfT, nbr, h = _fluid_pack(2, 3, seed=330, NC=60)
    kind = np.arange(dfT.shape[0] - 1) % 5    # sentinel fluid wall rigid mixed
    flags = dfT[:-1, tfk.FFLAGS]
    live = flags != -16.0
    one = {1: 2.0, 2: 8.0 + 4.0, 3: 2 * 16.0 + 8.0 + 1.0}
    for k, f in one.items():
        rows = kind == k
        flags[rows] = np.where(live[rows], f, -16.0)
    sent = np.asarray(tfk.SENT, np.float32)[:, None]
    dfT[:-1][kind == 0] = sent
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    dfT, nbr = t(dfT, torch.float32), t(nbr, torch.int64)
    outs = _check_rates_wall(dfT, nbr, QuinticSpline(dim=2), 3.0 * h)
    kind = torch.as_tensor(kind, device=dev)
    zero = lambda out, ks: all(
        bool((out[kind == k] == 0).all()) for k in ks)
    assert zero(outs["B6b"], (0, 1))
    assert float(outs["B6b"][kind == 2].abs().max()) > 0
    for label, out in outs.items():
        if label.startswith("B6a"):
            assert zero(out, (0, 2, 3)), label
            assert float(out[kind == 1].abs().max()) > 0, label
        elif label.startswith("B4"):
            assert zero(out, (0,)), label


def test_rates_wall_kernels_are_deterministic(dev):
    """Two launches on the same inputs give the same bits: every rates/wall
    instance on the coupling scene and on a random 3D pack of several
    windows."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    scheme, scene = _coupling_scene(dev)
    kernel = QuinticSpline(dim=2)
    cfg = scheme.cell_config(scene, kernel)
    grid, _, dfT = tfk.pack_fluid_sorted(scene, cfg)
    packs = [(dfT, grid.nbr_slots, kernel, cfg.radius),
             _fluid_pack_args(3, 3, dev, seed=6, NC=24, O=64, box=4)[:4]]
    for args in packs:
        for label, _, fast, _, a in _rates_wall_calls(*args):
            one, two = fast(*a), fast(*a)
            torch.cuda.synchronize()
            assert torch.equal(one, two), label


@pytest.mark.parametrize("pack", ["coupling", "2d", "3d"])
def test_fluid_forces_contact_equals_contact_kernel(dev, pack):
    """B5's 12 S contact columns are bit for bit those of K2 on every slot
    of the contact pack laid out from the same coupling pack (both add
    each lane's gated pairs in stencil order)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    if pack == "coupling":
        scheme, scene = _coupling_scene(dev)
        kernel = QuinticSpline(dim=2)
        cfg = scheme.cell_config(scene, kernel)
        grid, _, dfT = tfk.pack_fluid_sorted(scene, cfg)
        args = (dfT, grid.nbr_slots, kernel, cfg.radius, scheme.fluid_alpha,
                scheme.c0, scene.meta.total_no_bodies,
                4.0 * scene.meta.spacing0)
    else:
        args = _fluid_pack_args(int(pack[0]), 3, dev, seed=31)
    dfT, nbr, kernel, cutoff, S, init = (args[0], args[1], args[2], args[3],
                                         args[6], args[7])
    got = _dense(tfk.fluid_forces_contact(*args))
    cdfT = tck.contact_pack(dfT, tfk.UNION_LAYOUT, kernel.dim == 2)
    k2 = tck.contact_sums(cdfT, torch.arange(nbr.shape[0], device=dev), nbr,
                          S, cutoff, init, kernel)
    torch.cuda.synchronize()
    assert int((k2[..., 5 * S:6 * S] < init).sum()) > 0
    assert torch.equal(got[..., :12 * S], k2)


def test_coupling_kernel_step_matches_plain_step(dev):
    scheme, scene = _coupling_scene(dev)
    # the box slides: at zero tangential velocity the friction's direction
    # is rounding noise, which no summation-order tolerance holds
    scene = scene.replace(vcm=torch.tensor([[0.05, -0.02, 0.0]], device=dev))
    fast, plain = scheme.make_step(scene), scheme.make_step(scene, plain=True)
    a = b = scene
    _build.reset_launches()
    for _ in range(3):
        a, b = fast(a, 1e-5), plain(b, 1e-5)
    assert _build.LAUNCHES["fluid_rates_wall"] == 3
    assert _build.LAUNCHES["fluid_forces_contact"] == 3
    assert _build.LAUNCHES["pack_expand"] == 3
    assert not bool(a.nbr_overflow)
    for k in ("x", "y", "u", "v", "rho", "p", "p_fsi", "fx", "fy", "xcm",
              "vcm", "omega"):
        x, y = a[k].cpu().numpy(), b[k].cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(y).max(), 1.0),
                                   err_msg=k)


def test_contact_kernel_on_every_slot_matches_twin(dev):
    """K2 on every slot of the contact pack laid out from a coupling pack
    (the kdk and reference orderings' cell pipeline): picks bit for bit,
    sums within tolerance, and the init row on every slot without a
    rigid lane."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    scheme, scene = _coupling_scene(dev)
    kernel = QuinticSpline(dim=2)
    cfg = scheme.cell_config(scene, kernel)
    grid, _, dfT = tfk.pack_fluid_sorted(scene, cfg)
    cdfT = tck.contact_pack(dfT, tfk.UNION_LAYOUT, True)
    S = scene.meta.total_no_bodies
    init = 4.0 * scene.meta.spacing0
    qslot = torch.arange(cfg.NC_max, device=dev)
    args = (cdfT, qslot, grid.nbr_slots, S, cfg.radius, init, kernel)
    before = _build.LAUNCHES["contact"]
    got = tck.contact_sums(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["contact"] == before + 1
    ref = tck.contact_sums_reference(*args)
    assert int((ref[..., 5 * S:6 * S] < init).sum()) > 0
    assert torch.equal(got[..., 5 * S:], ref[..., 5 * S:])
    for c in range(5):
        a, b = got[..., c * S:(c + 1) * S], ref[..., c * S:(c + 1) * S]
        # unit normals (blocks 0-2): scale 1, as in _check_fluid_columns
        scale = max(float(b.abs().max()), 1.0 if c < 3 else 1e-30)
        assert bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-5 * scale).all()), c
    no_rigid = ~(tfk.decode_flags(dfT[:cfg.NC_max, tfk.FFLAGS])[4]
                 == 1.0).any(1)
    assert bool(no_rigid.any())
    init_row = torch.zeros(12 * S, device=dev)
    init_row[5 * S:6 * S] = init
    assert torch.equal(got[no_rigid],
                       init_row.expand(int(no_rigid.sum()), cfg.M, -1))


# per-step launches of each ordering's step on the box scene
ORDERING_LAUNCHES = {
    "kdk": dict(pack_expand=2, fluid_rates=1, wall_bc=1, fluid_forces=1,
                contact=1),
    "reference": dict(pack_expand=1, fluid_rates=1, wall_bc=1,
                      fluid_forces=1, contact=1),
    "no_fluid": dict(pack_expand=1, contact=1)}


@pytest.mark.parametrize("ordering", list(ORDERING_LAUNCHES))
def test_coupling_orderings_kernel_step_matches_plain_step(dev, ordering):
    scheme, scene = _coupling_scene(dev)
    scene = scene.replace(vcm=torch.tensor([[0.05, -0.02, 0.0]], device=dev))
    if ordering == "no_fluid":
        scheme.fluids = []       # kdkf routes to kdk; the fluid stays put
    else:
        scheme.gtvf_ordering = ordering
    fast, plain = scheme.make_step(scene), scheme.make_step(scene, plain=True)
    a = b = scene
    _build.reset_launches()
    for _ in range(3):
        a, b = fast(a, 1e-5), plain(b, 1e-5)
    for k, n in ORDERING_LAUNCHES[ordering].items():
        assert _build.LAUNCHES[k] == 3 * n, k
    assert sum(_build.LAUNCHES.values()) == 3 * sum(
        ORDERING_LAUNCHES[ordering].values())
    assert not bool(a.nbr_overflow)
    assert float(b.overlap.max()) > 0
    for k in ("x", "y", "u", "v", "rho", "p", "p_fsi", "fx", "fy", "xcm",
              "vcm", "omega", "overlap"):
        x, y = a[k].cpu().numpy(), b[k].cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(y).max(), 1.0),
                                   err_msg=f"{ordering} {k}")


def test_fluid_wrappers_reject_what_the_kernels_do_not_take(dev):
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    kernel = QuinticSpline(dim=2)
    dfT = torch.zeros((5, tfk.NF, 16), device=dev)
    nbr = torch.zeros((4, 9), dtype=torch.int64, device=dev)
    g = (0.0, -1.0, 0.0)
    with pytest.raises(ValueError):
        tfk.fluid_rates_wall(dfT.double(), nbr, kernel, 0.1, 0.1, 1.0,
                             True, True, g)
    with pytest.raises(ValueError):
        tfk.fluid_forces(dfT, nbr.int(), kernel, 0.1, 0.1, 1.0)
    with pytest.raises(ValueError):
        tfk.fluid_forces_contact(dfT[:4], nbr, kernel, 0.1, 0.1, 1.0, 2, 0.1)
    with pytest.raises(ValueError):
        tfk.fluid_rates(dfT.double(), nbr, kernel, 0.1, 0.1, 1.0, True, True)
    with pytest.raises(ValueError):
        tfk.wall_bc(dfT[:, :7], nbr, kernel, 0.1, g)
    widest = torch.zeros((5, tfk.NF, tfk.MAX_LANES + 8), device=dev)
    with pytest.raises(ValueError):
        tfk.fluid_forces(widest, nbr, kernel, 0.1, 0.1, 1.0)
    with pytest.raises(ValueError):
        tfk.fluid_rates_wall(widest, nbr, kernel, 0.1, 0.1, 1.0, True, True,
                             g)
    with pytest.raises(ValueError):
        tfk.fluid_rates(widest, nbr, kernel, 0.1, 0.1, 1.0, True, True)
    with pytest.raises(ValueError):
        tfk.wall_bc(widest, nbr, kernel, 0.1, g)
    with pytest.raises(ValueError):
        tfk.fluid_forces_contact(widest, nbr, kernel, 0.1, 0.1, 1.0, 2, 0.1)
    lanes = tcell.LaneMap(torch.zeros(64, dtype=torch.int64, device=dev),
                          torch.zeros(3, dtype=torch.int64, device=dev), 3)
    with pytest.raises(ValueError):       # rows and lanes
        tfk.fluid_forces_contact(dfT, nbr, kernel, 0.1, 0.1, 1.0, 2, 0.1,
                                 rows=torch.arange(4, device=dev),
                                 lanes=lanes)
    with pytest.raises(ValueError):       # a lane map of the wrong size
        tfk.fluid_forces_contact(dfT, nbr, kernel, 0.1, 0.1, 1.0, 2, 0.1,
                                 lanes=tcell.LaneMap(lanes.lane_pid[:60],
                                                     lanes.dense_pos, 3))


SPH_NAMES = ("cubic", "wendland", "wendland_c4", "gaussian",
             "super_gaussian")


@pytest.mark.parametrize("name", SPH_NAMES)
@pytest.mark.parametrize("dim", [2, 3])
def test_sph_kernel_instances_match_twin(dev, dim, name):
    """K2 and every fluid template instance of another SPH kernel than
    the quintic (its own library, built with -DRB_SPH_KERNEL) against
    their twins on random packs: K2's and B5's picks bit for bit, the
    sums within the tolerances above, one launch each counted under the
    kernel's instance; the fluid passes' cutoff is the kernel's support
    (radius_scale h)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    kernel = get_kernel(name, dim)
    cargs = _contact_pack(dim, 9, dev, seed=500 + 10 * dim)[:6] + (kernel,)
    key = f"contact[{name}]"
    before = _build.LAUNCHES_SPH.get(key, 0)
    got = tck.contact_sums(*cargs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES_SPH[key] == before + 1
    ref = tck.contact_sums_reference(*cargs)
    assert int((ref[..., 5 * 9:6 * 9] < cargs[5]).sum()) > 0
    _check_contact(got, ref, 9)

    args = _fluid_pack_args(dim, 3, dev, seed=600 + 10 * dim)
    h = 2.0 ** -6
    args = args[:2] + (kernel, kernel.radius_scale * h) + args[4:]
    dfT, nbr, _, cutoff = args[:4]
    _check_rates_wall(dfT, nbr, kernel, cutoff)
    got = _dense(tfk.fluid_forces_contact(*args))
    ref = _dense(tfk.fluid_forces_contact_reference(*args))
    torch.cuda.synchronize()
    assert _build.LAUNCHES_SPH[f"fluid_forces_contact[{name}]"] >= 1
    assert int((ref[..., 5 * 3:6 * 3] < args[7]).sum()) > 0
    _check_forces_contact(got, ref, 3)
    for rigid in (True, False):
        fargs = args[:6] + (rigid,)
        got = tfk.fluid_forces(*fargs)
        ref = tfk.fluid_forces_reference(*fargs)
        torch.cuda.synchronize()
        _check_fluid_columns(got, ref, f"{name} B6c rigid={rigid}")


def test_sph_libraries_refuse_another_kernel_id(dev):
    """An entry point of one SPH kernel's library called with another
    kernel's id returns an error and launches nothing."""
    for kname in ("contact", "fluid_forces", "wall_bc"):
        fn = _build.load(kname, "cubic")
        nargs = len(fn.argtypes)
        args = [0] * nargs
        # the id: after the pointers and the ints before it
        idx = {"contact": 10, "fluid_forces": 9, "wall_bc": 7}[kname]
        args[idx] = 0                      # the quintic's, not the cubic's
        assert fn(*args) != 0
        if kname != "contact":
            # NC = 0, O = 1, M = 16 and the cubic's id: nothing to launch
            args[3:6] = [0, 1, 16]
            args[idx] = 1
            assert fn(*args) == 0


# ---------------------------------------------------------------------------
# The instances past the narrow ones: K2 past 64 entities (the wide
# instance: dynamic count tables, the dems in chunks of up to 2,048), B5
# past one warp's shared memory (the block assembled in the output), the
# DEM kernels past 8 table slots (16 and 32 in shared memory, wider rows
# in global memory); each against its plain version as above
# ---------------------------------------------------------------------------

def _blocks_scene(dim, n_blocks, dev, side=3, dx=0.02):
    """``n_blocks`` small blocks (side x side lattice points, 3D: cubes)
    in columns 0.95 dx apart, the lowest row 0.7 dx over a wall, seeded
    random velocities: S = n_blocks + 1 entities, every block touching
    its neighbours."""
    rng = np.random.default_rng(n_blocks + dim)
    a = np.arange(side) * dx
    cols = int(np.ceil(n_blocks ** (1.0 / (dim - 1))))
    pitch = (side - 1) * dx + 0.95 * dx
    xs, ys, zs, bid = [], [], [], []
    for b in range(n_blocks):
        i, j = b % cols, b // cols
        if dim == 2:
            x, y = (c.ravel() for c in np.meshgrid(a + i * pitch,
                                                   a + j * pitch))
            z = np.zeros_like(x)
        else:
            x, y, z = (c.ravel() for c in np.meshgrid(
                a + i * pitch, a, a + j * pitch))
        xs.append(x)
        ys.append(y)
        zs.append(z)
        bid.append(np.full(x.size, b, np.int32))
    x, y, z = (np.concatenate(v) for v in (xs, ys, zs))
    span = np.arange(-3, int((x.max() + 3 * dx) / dx) + 1) * dx
    if dim == 2:
        xw, zw = span, np.zeros_like(span)
    else:
        xw, zw = (c.ravel() for c in np.meshgrid(span, span[span <= z.max()
                                                            + 3 * dx]))
    yw = np.full(xw.size, -0.7 * dx)
    m = 2000 * dx**dim
    body = make_group("body", x, y, z=z, m=m, h=1.3 * dx, rho=2000.0,
                      role=ROLE_RIGID, body_id=np.concatenate(bid),
                      dem_id=np.concatenate(bid))
    wall = make_group("wall", xw, yw, z=zw, m=m, h=1.3 * dx, rho=2000.0,
                      role=ROLE_BOUNDARY, dem_id=n_blocks)
    scene = build_scene([body, wall], dim=dim, total_no_bodies=n_blocks + 1,
                        spacing0=dx, device=dev, dtype=torch.float32)
    n = scene.n
    vel = lambda: torch.as_tensor(rng.uniform(-1, 1, n), dtype=torch.float32,
                                  device=dev)
    scene = scene.with_fields(contact_force_is_boundary=torch.ones(
        n, dtype=torch.float32, device=dev)).replace(
        u=vel(), v=vel(), w=vel() if dim == 3 else scene.w)
    host = lambda k: scene[k].cpu().numpy()
    cfg = tcell.config_from_positions(host("x"), host("y"), host("z"),
                                      3 * 1.3 * dx, dim)
    return scene, cfg


@pytest.mark.parametrize("S", [65, 300])
@pytest.mark.parametrize("dim", [2, 3])
def test_contact_kernel_wide_on_many_bodies(dev, dim, S):
    """K2's wide instance on a scene of S - 1 touching blocks, on the
    culled rows (the rigid path) and on every slot (the cell pipeline):
    each against its plain version, the culled rows equal to every slot's
    rows at those slots bit for bit, one launch of the wide instance a
    call."""
    assert tck.contact_instance(S)[0] == "wide"
    scene, cfg = _blocks_scene(dim, S - 1, dev)
    kernel = QuinticSpline(dim=dim)
    grid, pt, dfT = tck.pack_scene(scene, cfg)
    assert not bool(grid.overflow)
    qsel, nbr, valid, _, _ = tck.select_queries(dfT, grid, pt, cfg,
                                                cfg.NC_max)
    init = 4.0 * scene.meta.spacing0
    every_q = torch.arange(cfg.NC_max, device=dev)
    outs = {}
    for label, q, nb in (("culled", qsel, nbr),
                         ("every", every_q, grid.nbr_slots)):
        args = (dfT, q, nb, S, cfg.radius, init, kernel)
        before = _build.LAUNCHES_INSTANCE.get("contact/wide", 0)
        got = tck.contact_sums(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES_INSTANCE["contact/wide"] == before + 1
        ref = tck.contact_sums_reference(*args)
        picked = ref[..., 5 * S:6 * S] < init
        assert int(picked.sum()) > 0
        # some lane picks from a dem past the narrow instance's 64
        assert bool(picked[..., 64:].any())
        _check_contact(got, ref, S)
        outs[label] = got
    assert torch.equal(outs["culled"][valid], outs["every"][qsel[valid]])


@pytest.mark.parametrize("S", [65, 300, 2100])
@pytest.mark.parametrize("dim", [2, 3])
def test_contact_kernel_wide_random_packs(dev, dim, S):
    """The wide instance on random packs with exact distance ties (S =
    2,100: two chunks of dems, the stencil walked once a chunk)."""
    args = _contact_pack(dim, S, dev, seed=S + 10 * dim)
    got = tck.contact_sums(*args)
    ref = tck.contact_sums_reference(*args)
    torch.cuda.synchronize()
    assert int((ref[..., 5 * S:6 * S] < args[5]).sum()) > 0
    _check_contact(got, ref, S)


@pytest.mark.parametrize("dim", [2, 3])
def test_contact_kernel_wide_crowded_stencil(dev, dim):
    """The wide instance over windows: stencils of 640 entries of 70
    dems, more candidates than one window sorts."""
    S = 70
    args = _contact_pack(dim, S, dev, seed=17 + dim, nrows=40, NI=10, O=640,
                         box=4)
    got = tck.contact_sums(*args)
    ref = tck.contact_sums_reference(*args)
    torch.cuda.synchronize()
    _check_contact(got, ref, S)


@pytest.mark.parametrize("S,M", [(300, 16), (1000, 5)])
@pytest.mark.parametrize("dim", [2, 3])
def test_fluid_forces_contact_wide_random_packs(dev, dim, S, M):
    """B5 at many entities (M = 16, S = 300: a slot's 231 KB of contact
    rows; M = 5, S = 1,000), by query row at every slot, against its
    twin, the rows instance counted."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    args = _fluid_pack_args(dim, S, dev, seed=300 + dim + M, M=M)
    before = _build.LAUNCHES_INSTANCE.get("fluid_forces_contact/rows", 0)
    got = _dense(tfk.fluid_forces_contact(*args))
    torch.cuda.synchronize()
    assert _build.LAUNCHES_INSTANCE["fluid_forces_contact/rows"] == before + 1
    ref = _dense(tfk.fluid_forces_contact_reference(*args))
    assert int((ref[..., 5 * S:6 * S] < args[7]).sum()) > 0
    _check_forces_contact(got, ref, S)


WIDE_TABLES = ["empty", "moved", "crowded"]


@pytest.mark.parametrize("table", WIDE_TABLES)
@pytest.mark.parametrize("L", [12, 40])
@pytest.mark.parametrize("grid", ["spill", "rowwin"])
@pytest.mark.parametrize("dim", [2, 3])
def test_dem_kernels_wide_tables(dev, dim, grid, L, table):
    """K4 and K3 with tables of 12 slots (the 16-slot instance) and 40
    (the rows in global memory) against their twins; crowded: the block
    squeezed to 0.4 (2D: ~20 gated partners a grain, more than 12
    slots; 3D: the narrow instance's crowding)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    scene, cfg = _dem_scene(dim, dev, grid, table, L=L,
                            crowd=0.4 if dim == 2 else None)
    assert scene.tng_idx.shape[1] == L
    run = (tdk.lvc_displacement_cell_kernel if grid == "spill"
           else tdk.lvc_displacement_rowwin_kernel)
    tabs = (scene.tng_idx, scene.tng_idx_dem_id, scene.tng_x, scene.tng_y,
            scene.tng_z)
    kname = "dem_cell" if grid == "spill" else "dem_rowwin"
    key = f"{kname}/{tdk.table_instance(L)[0]}"
    before = _build.LAUNCHES_INSTANCE.get(key, 0)
    got = run(scene, cfg, 1e-5, *tabs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES_INSTANCE[key] == before + 1
    ref = run(scene, cfg, 1e-5, *tabs, plain=True)
    assert int(ref.count.sum()) > 0 and not bool(ref.overflow)
    if table == "crowded" and L == 12 and dim == 2:
        assert bool((ref.n_gated > L).any()) and bool((ref.count == L).any())
    for k in ("tng_idx", "tng_dem", "count", "n_gated"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    for k in ("tng_x", "tng_y", "tng_z"):
        assert torch.allclose(getattr(got, k), getattr(ref, k), rtol=1e-4,
                              atol=0), k
    _check_sums(torch.stack([got.fx, got.fy, got.fz, got.torx, got.tory,
                             got.torz]),
                torch.stack([ref.fx, ref.fy, ref.fz, ref.torx, ref.tory,
                             ref.torz]), "sums")


@pytest.mark.parametrize("L", [1, 16, 17, 32])
def test_dem_kernels_table_widths_at_the_instance_bounds(dev, L):
    """Tables of 1 slot, of exactly 16 and 32 (full masks) and of 17 (the
    32-slot instance), spill grid, a 3D block squeezed to 0.4 (~80 gated
    partners a grain: full tables), against the twin."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    scene, cfg = _dem_scene(3, dev, "spill", "crowded", L=L, crowd=0.4)
    tabs = (scene.tng_idx, scene.tng_idx_dem_id, scene.tng_x, scene.tng_y,
            scene.tng_z)
    got = tdk.lvc_displacement_cell_kernel(scene, cfg, 1e-5, *tabs)
    ref = tdk.lvc_displacement_cell_kernel(scene, cfg, 1e-5, *tabs,
                                           plain=True)
    torch.cuda.synchronize()
    assert bool((ref.count == L).any()) and not bool(ref.overflow)
    for k in ("tng_idx", "tng_dem", "count", "n_gated"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    for k in ("tng_x", "tng_y", "tng_z"):
        assert torch.allclose(getattr(got, k), getattr(ref, k), rtol=1e-4,
                              atol=0), k


def _scatter_slots(scene, seed):
    """The contact table with each row's slots in a seeded random order:
    free slots between live ones, live ones past slot 32."""
    L = scene.tng_idx.shape[1]
    gen = torch.Generator().manual_seed(seed)
    perm = torch.argsort(torch.rand(scene.n, L, generator=gen), 1).to(
        scene.device)
    return scene.replace(**{k: torch.gather(scene[k], 1, perm) for k in (
        "tng_idx", "tng_idx_dem_id", "tng_x", "tng_y", "tng_z")})


def _dem_pass_pair(scene, cfg, grid):
    """The pass's kernel and twin outputs, the kernel's instance
    launched once."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    run = (tdk.lvc_displacement_cell_kernel if grid == "spill"
           else tdk.lvc_displacement_rowwin_kernel)
    tabs = (scene.tng_idx, scene.tng_idx_dem_id, scene.tng_x, scene.tng_y,
            scene.tng_z)
    kname = "dem_cell" if grid == "spill" else "dem_rowwin"
    key = f"{kname}/{tdk.table_instance(scene.tng_idx.shape[1])[0]}"
    before = _build.LAUNCHES_INSTANCE.get(key, 0)
    got = run(scene, cfg, 1e-5, *tabs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES_INSTANCE[key] == before + 1
    return got, run(scene, cfg, 1e-5, *tabs, plain=True)


def _check_dem_pass(got, ref):
    for k in ("tng_idx", "tng_dem", "count", "n_gated"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    for k in ("tng_x", "tng_y", "tng_z"):
        assert torch.allclose(getattr(got, k), getattr(ref, k), rtol=1e-4,
                              atol=0), k
    _check_sums(torch.stack([got.fx, got.fy, got.fz, got.torx, got.tory,
                             got.torz]),
                torch.stack([ref.fx, ref.fy, ref.fz, ref.torx, ref.tory,
                             ref.torz]), "sums")


@pytest.mark.parametrize("L", [9, 17, 33, 39, 40])
@pytest.mark.parametrize("grid", ["spill", "rowwin"])
def test_dem_kernels_wide_scattered_tables(dev, grid, L):
    """The wide instance at widths just past the narrow one, past 16 and
    32 (its bitmap's second word) and not a multiple of 4, on the 3D
    block's moved table with each row's slots scattered (free slots
    between live ones, live ones past slot 32), against the twin."""
    scene, cfg = _dem_scene(3, dev, grid, "moved", L=L)
    scene = _scatter_slots(scene, L)
    live = scene.tng_idx >= 0
    assert bool((~live[:, :-1] & live[:, 1:]).any())
    if L > 32:
        assert bool(live[:, 32:].any())
    got, ref = _dem_pass_pair(scene, cfg, grid)
    assert not bool(ref.overflow) and int(ref.count.sum()) > 0
    alloc, freed = _table_changes(scene, ref.tng_idx, ref.tng_dem)
    assert alloc > 0 and freed > 0
    _check_dem_pass(got, ref)


@pytest.mark.parametrize("grid", ["spill", "rowwin"])
def test_dem_kernels_wide_rows_past_the_list(dev, grid):
    """Rows with more live entries than the wide instance's per-query
    list holds (WIDE_LIST) match against their row in global memory:
    the 3D block squeezed to 0.4 (~80 gated partners a grain) met from
    a full table of 40 slots, beside rows of fewer entries, against the
    twin."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    scene, cfg = _dem_scene(3, dev, grid, "crowded", L=40, crowd=0.4)
    n_in = (scene.tng_idx >= 0).sum(1)
    assert bool((n_in > tdk.WIDE_LIST).any())
    assert bool(((n_in > 0) & (n_in <= tdk.WIDE_LIST)).any())
    got, ref = _dem_pass_pair(scene, cfg, grid)
    assert not bool(ref.overflow) and bool((ref.count == 40).any())
    _check_dem_pass(got, ref)


@pytest.mark.parametrize("L", [8, 40])
def test_dem_kernels_leave_the_fill_of_a_particle_without_a_lane(dev, L):
    """Grains made inactive have no lane: whatever their input rows
    hold, the kernel leaves them the wrapper's fill (zero sums, -1
    entries, zero springs), as the twin gives them."""
    scene, cfg = _dem_scene(3, dev, "spill", "filled", L=L)
    off = torch.zeros(scene.n, dtype=torch.bool, device=dev)
    off[:scene.n // 2:7] = True
    assert bool((scene.tng_idx[off] >= 0).any())
    scene = scene.replace(active=scene.active & ~off)
    got, ref = _dem_pass_pair(scene, cfg, "spill")
    _check_dem_pass(got, ref)
    for k in ("fx", "fy", "fz", "torx", "tory", "torz", "tng_x", "tng_y",
              "tng_z", "count", "n_gated"):
        assert bool((getattr(got, k)[off] == 0).all()), k
    assert bool((got.tng_idx[off] == -1).all())
    assert bool((got.tng_dem[off] == -1).all())


@pytest.mark.parametrize("table", ["filled", "moved", "crowded"])
@pytest.mark.parametrize("grid", ["spill", "rowwin"])
def test_dem_narrow_instance_equals_wide_instance_bit_for_bit(
        dev, grid, table, monkeypatch):
    """At L = 8 the narrow instance (registers, 16-byte rows) and the
    wide one (lists, bitmaps, the warp's write-back) give the same
    sums, counts, tables and springs bit for bit: the same pair bodies
    in the same candidate order."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    scene, cfg = _dem_scene(3 if table == "crowded" else 2, dev, grid, table,
                            L=8)
    run = (tdk.lvc_displacement_cell_kernel if grid == "spill"
           else tdk.lvc_displacement_rowwin_kernel)
    tabs = (scene.tng_idx, scene.tng_idx_dem_id, scene.tng_x, scene.tng_y,
            scene.tng_z)
    kname = "dem_cell" if grid == "spill" else "dem_rowwin"
    narrow = run(scene, cfg, 1e-5, *tabs)
    before = _build.LAUNCHES_INSTANCE.get(f"{kname}/wide", 0)
    monkeypatch.setattr(tdk, "table_instance", lambda L: ("wide", 0))
    wide = run(scene, cfg, 1e-5, *tabs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES_INSTANCE[f"{kname}/wide"] == before + 1
    assert int(narrow.count.sum()) > 0
    for k in narrow._fields:
        assert torch.equal(getattr(narrow, k), getattr(wide, k)), k


def test_dem_wrappers_refuse_a_table_past_the_widest(dev):
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    scene, cfg = _dem_scene(2, dev, "spill", "empty", n_side=4,
                            L=tdk.MAX_TABLE_WIDTH + 1)
    with pytest.raises(NotImplementedError):
        tdk.lvc_displacement_cell_kernel(
            scene, cfg, 1e-5, scene.tng_idx, scene.tng_idx_dem_id,
            scene.tng_x, scene.tng_y, scene.tng_z)


def test_fluid_forces_smem_takes_every_entity_count(dev):
    """B5's contact columns go to the output, not shared memory: a block
    of ``fluid_forces_contact`` takes four warps at every slot width and
    entity count up to 10,000, each with B6c's staging and lists, the
    force block at its widest (192 words), the lanes' contact rows (64),
    a list of 64 dems and a bitmap of a word every 32 entities (rounded
    to 16 bytes)."""
    smem = _build.load("fluid_forces_smem")
    ext = lambda S: (192 + 64 + 64 + (S + 31) // 32 + 3) & ~3
    for M in (5, 8, 16, 32):
        b6c = smem(M, 0)
        assert 0 < b6c < 48 * 1024
        assert smem(M, 1) == b6c + 4 * 4 * (ext(1) - ((M * 6 + 3) & ~3))
        for S in (1, 64, 65, 291, 292, 301, 1000, 10_000):
            assert smem(M, S) == smem(M, 1) + 4 * 4 * (ext(S) - ext(1)), \
                (M, S)


def _lane_map_of(dfT, sentinel, n_orphans, seed):
    """A lane map for a random pack: the live lanes' (flags word not
    ``sentinel``) particles in a random order, then ``n_orphans``
    particles without a lane."""
    flags = dfT[:-1, -1] if dfT.shape[1] != 14 else dfT[:-1, 13]
    NCM = flags.numel()
    live = torch.nonzero((flags != sentinel).reshape(-1)).reshape(-1)
    n_live = live.numel()
    n = n_live + n_orphans
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n_live, generator=gen).to(dfT.device)
    lane_pid = torch.full((NCM,), n, dtype=torch.int64, device=dfT.device)
    lane_pid[live] = perm
    dense_pos = torch.full((n,), NCM, dtype=torch.int64, device=dfT.device)
    dense_pos[perm] = live
    return tcell.LaneMap(lane_pid, dense_pos, n)


@pytest.mark.parametrize("S", [9, 65, 300])
@pytest.mark.parametrize("dim", [2, 3])
def test_contact_kernel_wide_by_particle_matches_twin(dev, dim, S):
    """K2 writing every slot's lanes by particle (the cell pipeline's
    layout; S = 9 the narrow instance, 65 and 300 the wide one): against
    its plain version, equal bit for bit to the query-row output laid
    out by particle (``rows_by_particle``, the unpack it replaces), a
    particle without a lane (inactive) all zeros, through
    ``contact_pipeline_cell`` equal to the wrapper's output."""
    scene, cfg = _blocks_scene(dim, S - 1, dev)
    active = scene.active.clone()
    active[5] = False
    scene = scene.replace(active=active)
    kernel = QuinticSpline(dim=dim)
    grid, pt, dfT = tck.pack_scene(scene, cfg, want_dense_pos=True)
    assert not bool(grid.overflow)
    init = 4.0 * scene.meta.spacing0
    q = torch.arange(cfg.NC_max, device=dev)
    lanes = tcell.lane_map(grid, cfg, scene.n)
    args = (dfT, q, grid.nbr_slots, S, cfg.radius, init, kernel)
    inst = f"contact/{tck.contact_instance(S)[0]}"
    before = _build.LAUNCHES_INSTANCE.get(inst, 0)
    got = tck.contact_sums(*args, lanes=lanes)
    torch.cuda.synchronize()
    assert _build.LAUNCHES_INSTANCE[inst] == before + 1
    assert got.shape == (scene.n, 12 * S)
    ref = tck.contact_sums_reference(*args, lanes=lanes)
    assert int((ref[:, 5 * S:6 * S] < init).sum()) > 0
    _check_contact(got, ref, S)
    rows = tck.contact_sums(*args)
    assert torch.equal(got, tck.rows_by_particle(rows, q, lanes))
    assert float(got[5].abs().max()) == 0.0
    cp = tck.contact_pipeline_cell(dfT, grid, cfg, kernel, S, init, scene.n)
    assert torch.equal(cp.reshape(scene.n, 12 * S), got)


@pytest.mark.parametrize("S", [2, 9, 300])
@pytest.mark.parametrize("dim", [2, 3])
def test_fluid_forces_contact_wide_rows_and_lanes_match_twin(dev, dim, S):
    """B5 writing its contact columns where the kdkf step reads them: by
    query row at an ascending subset of slots (some without a rigid lane,
    padding rows NC past them: the init row), and by particle through a
    lane map (particles without a lane: zeros); each against its plain
    version, both equal bit for bit to the every-slot rows gathered and
    laid out by particle; the force columns the same in all three calls;
    each instance counted."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    args = _fluid_pack_args(dim, S, dev, seed=900 + 10 * dim + S)
    dfT, nbr, init = args[0], args[1], args[7]
    NC = nbr.shape[0]
    rigid = (tfk.decode_flags(dfT[:NC, tfk.FFLAGS])[4] == 1.0).any(1)
    gen = torch.Generator().manual_seed(S)
    pick = torch.rand(NC, generator=gen).to(dev) < 0.6
    rows = torch.nonzero(pick | rigid).reshape(-1)
    rows = torch.cat([rows, torch.full((5,), NC, device=dev)])
    lanes = _lane_map_of(dfT, -16.0, 4, S)
    every_f, every = tfk.fluid_forces_contact(*args)
    outs = {}
    for name, kw in (("rows", dict(rows=rows)), ("lanes", dict(lanes=lanes))):
        before = _build.LAUNCHES_INSTANCE.get(f"fluid_forces_contact/{name}",
                                              0)
        fo, co = tfk.fluid_forces_contact(*args, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES_INSTANCE[f"fluid_forces_contact/{name}"] \
            == before + 1
        rf, rc = tfk.fluid_forces_contact_reference(*args, **kw)
        _check_fluid_columns(fo, rf, f"forces {name}")
        assert torch.equal(fo, every_f)
        _check_contact(co, rc, S)
        outs[name] = co
    if S > 1:
        assert int((every[..., 5 * S:6 * S] < init).sum()) > 0
    init_row = torch.zeros(12 * S, device=dev)
    init_row[5 * S:6 * S] = init
    real = rows < NC
    assert torch.equal(outs["rows"][real], every[rows[real]])
    assert bool((outs["rows"][~real] == init_row).all())
    q = torch.arange(NC, device=dev)
    assert torch.equal(outs["lanes"], tck.rows_by_particle(every, q, lanes))
    assert float(outs["lanes"][-4:].abs().max()) == 0.0


def test_kdkf_compact_and_full_routes_use_their_b5_layouts(dev):
    """The kdkf step's B5 launch: by query row on the compact route (the
    store from 2 entities), by particle on the full route, one a step
    each; 3 kernel steps of each route equal 3 plain ones within rtol
    1e-4."""
    for compact, inst in ((2, "rows"), (None, "lanes")):
        scheme, scene = _coupling_scene(dev, compact_min_bodies=compact)
        assert ("cl_pid" in scene) == (compact is not None)
        scene = scene.replace(vcm=torch.tensor([[0.05, -0.02, 0.0]],
                                               device=dev))
        fast = scheme.make_step(scene)
        plain = scheme.make_step(scene, plain=True)
        a = b = scene
        _build.reset_launches()
        for _ in range(3):
            a, b = fast(a, 1e-5), plain(b, 1e-5)
        assert _build.LAUNCHES_INSTANCE.get(
            f"fluid_forces_contact/{inst}", 0) == 3, inst
        assert not bool(a.nbr_overflow)
        for k in ("x", "y", "u", "v", "rho", "p", "fx", "fy", "xcm", "vcm"):
            x, y = a[k].cpu().numpy(), b[k].cpu().numpy()
            np.testing.assert_allclose(x, y, rtol=1e-4,
                                       atol=1e-4 * max(np.abs(y).max(), 1.0),
                                       err_msg=f"{inst} {k}")


# ---------------------------------------------------------------------------
# the classic cell grid (one slot a cell, lanes sized from occupancy): K2
# at other slot widths than the spill grid's 16 and stencils past 27
# entries, the split fluid passes (B6a, B6b, B6c) past one warp a slot,
# and the steps that run them
# ---------------------------------------------------------------------------

# (M, O): the classic grids' widths and stencils (2D sub = 2: 8 x 25; the
# coupling's 48 x 9; 3D: 104 x 27, 16 x 125), the kernel's widest (128),
# and widths that are not a multiple of 16
CLASSIC_K2 = [(8, 25), (24, 9), (32, 9), (40, 9), (48, 9), (104, 27),
              (128, 27), (16, 125)]


@pytest.mark.parametrize("M,O", CLASSIC_K2)
@pytest.mark.parametrize("dim", [2, 3])
def test_contact_kernel_classic_widths_match_twin(dev, dim, M, O):
    """K2 at the classic grid's slot widths and stencils against its
    plain version, counted as the width's instance: on the lattice pack
    (exact distance ties) the picks bit for bit; on the pack moved off
    the lattice every column, by query row (padding rows among them) and
    by particle (every slot, particles without a lane).  On the lattice a
    stencil symmetric about a query lane cancels its Eq. 22 sum exactly
    in one summation order and to a rounding residue in another, and the
    unit normal of that sum is then undefined (the plain version
    normalises the residue), so the sums are held off the lattice."""
    S = 9
    args = _contact_pack(dim, S, dev, seed=M + O + dim, nrows=40, NI=39,
                         O=O, M=M)
    inst = f"contact/{tck.lanes_instance('narrow', M)}"
    before = _build.LAUNCHES_INSTANCE.get(inst, 0)
    got = tck.contact_sums(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES_INSTANCE[inst] == before + 1
    assert got.shape == (39, M, 12 * S)
    ref = tck.contact_sums_reference(*args)
    assert int((ref[..., 5 * S:6 * S] < args[5]).sum()) > 0
    assert torch.equal(got[..., 5 * S:], ref[..., 5 * S:])
    args = _contact_pack(dim, S, dev, seed=M + O + dim, nrows=40, NI=39,
                         O=O, M=M, jitter=0.25)
    got = tck.contact_sums(*args)
    torch.cuda.synchronize()
    ref = tck.contact_sums_reference(*args)
    assert int((ref[..., 5 * S:6 * S] < args[5]).sum()) > 0
    _check_contact(got, ref, S)
    dfT, _, nbr = args[:3]
    q = torch.arange(39, device=dev)
    lanes = _lane_map_of(dfT, -8.0, 7, seed=M + O)
    by_p = (dfT, q, nbr) + args[3:]
    got = tck.contact_sums(*by_p, lanes=lanes)
    torch.cuda.synchronize()
    ref = tck.contact_sums_reference(*by_p, lanes=lanes)
    _check_contact(got, ref, S)
    assert float(got[-7:].abs().max()) == 0.0       # no lane: zeros


@pytest.mark.parametrize("dim", [2, 3])
def test_contact_kernel_classic_wide_and_windows_match_twin(dev, dim):
    """The classic instance with the wide dem tables (S = 70) on 104
    lanes, and a 125-entry stencil of 128 lanes with more candidates
    than three windows hold (the 3D classic stencils' case)."""
    args = _contact_pack(dim, 70, dev, seed=40 + dim, nrows=40, NI=20,
                         O=27, M=104, jitter=0.25)
    got = tck.contact_sums(*args)
    torch.cuda.synchronize()
    _check_contact(got, tck.contact_sums_reference(*args), 70)
    S = 3
    args = _contact_pack(dim, S, dev, seed=50 + dim, nrows=40, NI=6, O=125,
                         M=128, box=4, jitter=0.25)
    got = tck.contact_sums(*args)
    torch.cuda.synchronize()
    ref = tck.contact_sums_reference(*args)
    dfT, _, nbr = args[:3]
    flags = tck.decode_flags(dfT[:, -1])
    cand = ((flags[1] == 1.0) & (flags[2] == 0.0) & (flags[0] >= 0)).sum(1)
    assert int(cand[nbr[0]].sum()) > 3 * 1536
    assert int((ref[..., 5 * S:6 * S] < args[5]).sum()) > 0
    _check_contact(got, ref, S)


@pytest.mark.parametrize("M", [33, 48, 104, 176, 256])
@pytest.mark.parametrize("dim", [2, 3])
def test_split_passes_classic_widths_match_twin(dev, dim, M):
    """B6a (EDAC and Tait, with and without bodies), B6b and B6c (with
    and without bodies, with and without viscosity) on slots wider than
    a warp, against their twins, each counted as the width's instance;
    the 48-lane slots' 9-entry stencils hold more candidates than a
    staging window (160), so windows end inside an entry."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    dfT, nbr, kernel, cutoff = _fluid_pack_args(dim, 3, dev, seed=400 + M,
                                                NC=24, O=9, M=M,
                                                box=5)[:4]
    calls = [c for c in _rates_wall_calls(dfT, nbr, kernel, cutoff)
             if not c[0].startswith("B4")]
    for rigid in (True, False):
        for alpha in (0.1, 0.0):
            calls.append((f"B6c rigid={rigid} alpha={alpha}",
                          "fluid_forces", tfk.fluid_forces,
                          tfk.fluid_forces_reference,
                          (dfT, nbr, kernel, cutoff, alpha, 10.0, rigid)))
    for label, kname, fast, plain, args in calls:
        inst = f"{kname}/lanes{M}"
        before = _build.LAUNCHES_INSTANCE.get(inst, 0)
        got = fast(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES_INSTANCE[inst] == before + 1, label
        assert got.shape[1] == M and bool(torch.isfinite(got).all()), label
        _check_fluid_columns(got, plain(*args), f"M={M} {label}")


def test_classic_wrappers_refuse_widths_past_the_kernels(dev):
    """K2 takes slots of at most 128 lanes (the 3D coupling's classic
    176 raises), every fluid pass 256 (B4 and B5 at 48 lanes run:
    ``test_b4_b5_wide_slot_instances_match_twins``), the DEM kernels
    256."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    kernel = QuinticSpline(dim=2)
    q = torch.zeros(2, dtype=torch.int64, device=dev)
    nbr = torch.zeros((2, 9), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="128"):
        tck.contact_sums(torch.zeros((4, 7, 176), device=dev), q, nbr, 3,
                         0.1, 0.2, kernel)
    fnbr = torch.zeros((4, 9), dtype=torch.int64, device=dev)
    d264 = torch.zeros((5, tfk.NF, 264), device=dev)
    with pytest.raises(ValueError, match="256"):
        tfk.fluid_rates_wall(d264, fnbr, kernel, 0.1, 0.1, 1.0, True, True,
                             (0.0, -1.0, 0.0))
    with pytest.raises(ValueError, match="256"):
        tfk.fluid_forces_contact(d264, fnbr, kernel, 0.1, 0.1, 1.0, 2, 0.1)
    with pytest.raises(ValueError, match="256"):
        tfk.fluid_rates(d264, fnbr, kernel, 0.1, 0.1, 1.0, True, True)
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
    scene, cfg = _dem_scene(2, dev, "spill", "empty", n_side=4)
    d257 = torch.zeros((5, 13, 257), device=dev)
    with pytest.raises(ValueError, match="256"):
        tdk.dem_cell_sums(d257, fnbr, scene.tng_idx, scene.tng_idx_dem_id,
                          scene.tng_x, scene.tng_y, scene.tng_z,
                          tdk.material_table(scene), 1e-5, cfg)


def _classic_cfg(scene, cutoff, dim, **kw):
    host = lambda k: scene[k].cpu().numpy()
    cfg = tcell.config_from_positions(host("x"), host("y"), host("z"),
                                      cutoff, dim, **kw)
    assert not cfg.spill
    return cfg


@pytest.mark.parametrize("dim", [2, 3])
def test_classic_rigid_kernel_steps_match_plain_steps(dev, dim):
    """3 GTVF steps on the classic grid (2D sub = 2, 3D lanes from
    occupancy): one K2 on every slot a step, no K1, kernel against plain
    within rtol 1e-4."""
    scene, _ = _scene(dim, dev)
    kernel = QuinticSpline(dim=dim)
    cfg = _classic_cfg(scene, 3 * 1.3 * 0.02, dim,
                       **(dict(sub=2) if dim == 2 else dict(spill=False)))
    fast = trb.build_rigid_gtvf_step_full(
        trb._make_force_eval(kernel, PARAMS, cfg), dim == 2)
    plain = trb.build_rigid_gtvf_step_full(
        trb._make_force_eval(kernel, PARAMS, cfg, plain=True), dim == 2)
    a = b = scene
    _build.reset_launches()
    for _ in range(3):
        a, b = fast(a, 1e-4), plain(b, 1e-4)
    assert _build.LAUNCHES["contact"] == 3
    assert sum(_build.LAUNCHES.values()) == 3
    assert _build.LAUNCHES_INSTANCE[
        f"contact/{tck.lanes_instance('narrow', cfg.M)}"] == 3
    assert not bool(a.nbr_overflow) and float(b.overlap.max()) > 0
    for k in ("x", "y", "z", "u", "v", "fx", "fy", "xcm", "vcm", "omega",
              "overlap"):
        x, y = a[k].cpu().numpy(), b[k].cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(y).max(), 1.0),
                                   err_msg=k)


@pytest.mark.parametrize("ordering", ["kdk", "reference", "kdkf"])
def test_classic_coupling_kernel_steps_match_plain_steps(dev, ordering):
    """3 steps of the kdk, reference and kdkf orderings on the coupling's
    classic grid (the box tank, lanes past a warp), no K1: B6a, B6b, B6c
    and K2 a step on every slot at the grid's width (kdk, reference), B4
    and B5 by particle (kdkf)."""
    scheme, scene = _coupling_scene(dev)
    scene = scene.replace(vcm=torch.tensor([[0.05, -0.02, 0.0]], device=dev))
    h = float(scene.h.max())
    scheme._cell_cfg = _classic_cfg(scene, 3.0 * h, 2, occupancy_safety=2.6,
                                    spill=False, cell_factor=1.5)
    M = scheme._cell_cfg.M
    assert 32 < M <= 128
    scheme.gtvf_ordering = ordering
    fast, plain = scheme.make_step(scene), scheme.make_step(scene, plain=True)
    a = b = scene
    _build.reset_launches()
    for _ in range(3):
        a, b = fast(a, 1e-5), plain(b, 1e-5)
    if ordering == "kdkf":
        want = dict(fluid_rates_wall=1, fluid_forces_contact=1)
        insts = (f"fluid_rates_wall/lanes{M}",
                 f"fluid_forces_contact/lanes/lanes{M}")
    else:
        want = dict(fluid_rates=1, wall_bc=1, fluid_forces=1, contact=1)
        insts = tuple(f"{k}/lanes{M}" for k in ("fluid_rates", "wall_bc",
                                                "fluid_forces"))
    for k, n in want.items():
        assert _build.LAUNCHES[k] == 3 * n, k
    assert sum(_build.LAUNCHES.values()) == 3 * sum(want.values())
    for k in insts:
        assert _build.LAUNCHES_INSTANCE[k] == 3, k
    assert not bool(a.nbr_overflow)
    assert float(b.overlap.max()) > 0
    for k in ("x", "y", "u", "v", "rho", "p", "p_fsi", "fx", "fy", "xcm",
              "vcm", "omega", "overlap"):
        x, y = a[k].cpu().numpy(), b[k].cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(y).max(), 1.0),
                                   err_msg=f"{ordering} {k}")


def test_classic_coupling_3d_kdk_kernel_steps_match_plain_steps(dev):
    """3 kdk steps of a small 3D sinking box (a box of rho 2 dipped into
    a hydrostatic tank's surface) on its classic grid of the coupling's
    lane rule (past two warps a slot): B6a, B6b, B6c and K2 a step on
    every slot at the grid's width, no K1, against 3 plain steps."""
    from rigid_body_2d_3d_pysph_tpu_torch.geom import get_fluid_tank_3d
    from rigid_body_2d_3d_pysph_tpu_torch.models import (
        RigidFluidCouplingScheme)
    from rigid_body_2d_3d_pysph_tpu_torch.state import ROLE_FLUID

    dx, gy, rho0 = 0.05, -1.0, 1.0
    xf, yf, zf, xt, yt, zt = get_fluid_tank_3d(
        0.5, 0.3, 0.3, 0.5, 0.45, 3, dx, dx, hydrostatic=True)
    p0 = -rho0 * gy * (yf.max() - yf)
    xb, yb, zb = get_3d_block(dx, 0.15, 0.1, 0.15)
    xb += (xf.min() + xf.max()) / 2 - (xb.min() + xb.max()) / 2
    zb += (zf.min() + zf.max()) / 2 - (zb.min() + zb.max()) / 2
    yb += yf.max() - yb.min() - 0.05
    keep = ~((xf > xb.min() - dx) & (xf < xb.max() + dx)
             & (yf > yb.min() - dx) & (yf < yb.max() + dx)
             & (zf > zb.min() - dx) & (zf < zb.max() + dx))
    m, c0 = rho0 * dx**3, 10 * np.sqrt(2 * abs(gy) * 0.3)
    groups = [
        make_group("fluid", xf[keep], yf[keep], z=zf[keep], m=m, h=dx,
                   rho=rho0, role=ROLE_FLUID, p=p0[keep]),
        make_group("tank", xt, yt, z=zt, m=m, h=dx, rho=rho0, rad_s=dx / 2,
                   role=ROLE_BOUNDARY, dem_id=1),
        make_group("body", xb, yb, z=zb, m=2.0 * m, h=dx, rho=2.0 * rho0,
                   rad_s=dx / 2, role=ROLE_RIGID,
                   body_id=np.zeros(len(xb), np.int32),
                   dem_id=np.zeros(len(xb), np.int32))]
    scene = build_scene(groups, dim=3, total_no_bodies=2, spacing0=dx,
                        device=dev, dtype=torch.float32)
    scheme = RigidFluidCouplingScheme(
        ["fluid"], ["tank"], ["body"], dim=3, rho0=rho0, p0=rho0 * c0**2,
        c0=c0, h=dx, nu=0.0, gy=gy)
    scheme._cell_cfg = _classic_cfg(scene, 3.0 * dx, 3, occupancy_safety=2.6,
                                    spill=False)
    M = scheme._cell_cfg.M
    assert 64 < M <= 128 and scheme._cell_cfg.O == 27
    scene = scheme.setup(scene)
    # the box's displaced-fluid shadow mass and density
    rigid = scene.is_rigid
    scene = scene.replace(
        m_fsi=torch.where(rigid, scene.m_fsi + m, scene.m_fsi),
        rho_fsi=torch.where(rigid, rho0, scene.rho_fsi))
    scheme.gtvf_ordering = "kdk"
    fast, plain = scheme.make_step(scene), scheme.make_step(scene, plain=True)
    dt = 0.25 * dx / (1.1 * c0)
    a = b = scene
    _build.reset_launches()
    for _ in range(3):
        a, b = fast(a, dt), plain(b, dt)
    want = dict(fluid_rates=1, wall_bc=1, fluid_forces=1, contact=1)
    for k, n in want.items():
        assert _build.LAUNCHES[k] == 3 * n, k
    assert sum(_build.LAUNCHES.values()) == 3 * sum(want.values())
    for k in ("fluid_rates", "wall_bc", "fluid_forces"):
        assert _build.LAUNCHES_INSTANCE[f"{k}/lanes{M}"] == 3, k
    assert _build.LAUNCHES_INSTANCE[
        f"contact/{tck.lanes_instance('narrow', M)}"] == 3
    assert not bool(a.nbr_overflow) and not bool(b.nbr_overflow)
    assert bool(torch.isfinite(b.u).all())
    for k in ("x", "y", "z", "u", "v", "w", "rho", "p", "p_fsi", "fx", "fy",
              "fz", "xcm", "vcm", "omega"):
        x, y = a[k].cpu().numpy(), b[k].cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(y).max(), 1.0),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# every lane width: the DEM kernels' runtime-width instance, B4 and B5 past
# a warp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", [8, 12])
@pytest.mark.parametrize("M", [1, 4, 24, 32, 64, 100, 128, 200, 256, None])
@pytest.mark.parametrize("grid", ["spill", "rowwin", "classic"])
def test_dem_kernels_at_every_lane_width(dev, grid, M, L):
    """K4 (spill grid) and K3 (row windows) at M lanes a slot, and K4 on
    the classic grid (``M`` None: its lanes from occupancy), the narrow
    and the wide table instance, from the filled table and from one whose
    contacts open and close: tables bit for bit, sums and springs at the
    twin's tolerances; each launch counted as the runtime-width instance
    (8 and 16 lanes keep theirs)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
    from rigid_body_2d_3d_pysph_tpu_torch.ops import rowwin as trw

    if (grid == "classic") != (M is None):
        pytest.skip("the classic grid sizes its lanes from occupancy; the "
                    "other grids take every M")
    for table in ("filled", "moved"):
        scene, cfg0 = _dem_scene(2, dev, "rowwin" if grid == "rowwin"
                                 else "spill", table, L=L)
        host = lambda k: scene[k].cpu().numpy()
        if grid == "rowwin":
            cfg = trw.rowwin_config_from_positions(
                host("x"), host("y"), host("z"), cfg0.cutoff, 2, M=M)
            run, kname = tdk.lvc_displacement_rowwin_kernel, "dem_rowwin"
        else:
            cfg = tcell.config_from_positions(
                host("x"), host("y"), host("z"), cfg0.cutoff, 2,
                cell_factor=2.0 if (M or 8) < 8 else 4.0, M=M,
                spill=grid == "spill", cell_chunk=64)
            assert cfg.spill == (grid == "spill")
            run, kname = tdk.lvc_displacement_cell_kernel, "dem_cell"
        tabs = (scene.tng_idx, scene.tng_idx_dem_id, scene.tng_x,
                scene.tng_y, scene.tng_z)
        inst = (f"{kname}/"
                f"{tdk.lanes_instance(tdk.table_instance(L)[0], cfg.M)}")
        before = _build.LAUNCHES_INSTANCE.get(inst, 0)
        got = run(scene, cfg, 1e-5, *tabs)
        ref = run(scene, cfg, 1e-5, *tabs, plain=True)
        torch.cuda.synchronize()
        assert _build.LAUNCHES_INSTANCE.get(inst, 0) == before + 1, inst
        assert not bool(ref.overflow) and int(ref.count.sum()) > 0
        for k in ("tng_idx", "tng_dem", "count", "n_gated"):
            assert torch.equal(getattr(got, k), getattr(ref, k)), (k, table)
        for k in ("tng_x", "tng_y", "tng_z"):
            assert torch.allclose(getattr(got, k), getattr(ref, k),
                                  rtol=1e-4, atol=0), (k, table)
        _check_sums(torch.stack([got.fx, got.fy, got.torz]),
                    torch.stack([ref.fx, ref.fy, ref.torz]), "sums")


@pytest.mark.parametrize("layout", ["rows", "lanes", "every"])
@pytest.mark.parametrize("M", [33, 48, 64, 100, 256])
@pytest.mark.parametrize("dim", [2, 3])
def test_b4_b5_wide_slot_instances_match_twins(dev, dim, M, layout):
    """B4 and B5 on random packs of M lanes a slot (ceil(M / 32) warps a
    slot): B4's columns and B5's forces within 2e-5 of each column's
    largest magnitude, B5's contact columns as K2's (picks bit for bit)
    by query row at some slots, by particle, or at every slot."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk

    args = _fluid_pack_args(dim, 3, dev, seed=70 + M, M=M, NC=24)
    dfT, nbr = args[0], args[1]
    NC = nbr.shape[0]
    kw = {}
    if layout == "rows":
        kw["rows"] = torch.tensor([0, 2, 3, 7, 11, NC, NC], device=dev)
    elif layout == "lanes":
        rng = np.random.default_rng(M)
        n = NC * M + 5
        pid = rng.permutation(n)[:NC * M]
        dp = np.full(n, NC * M)
        dp[pid] = np.arange(NC * M)
        kw["lanes"] = tcell.LaneMap(torch.as_tensor(pid, device=dev),
                                    torch.as_tensor(dp, device=dev), n)
    inst = ("rows" if "lanes" not in kw else "lanes") + f"/lanes{M}"
    before = _build.LAUNCHES_INSTANCE.get(f"fluid_forces_contact/{inst}", 0)
    got = tfk.fluid_forces_contact(*args, **kw)
    ref = tfk.fluid_forces_contact_reference(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES_INSTANCE[f"fluid_forces_contact/{inst}"] \
        == before + 1
    S = 3
    gc, rc = got[1].reshape(-1, 12 * S), ref[1].reshape(-1, 12 * S)
    assert int((rc[:, 5 * S:6 * S] < args[7]).sum()) > 0
    _check_contact(gc, rc, S)
    _check_fluid_columns(got[0], ref[0], f"B5 M={M}")
    g = (0.0, -1.0, 0.0)
    for edac, rigid in ((True, True), (False, False)):
        rw = (dfT, nbr, args[2], args[3], 0.02, 10.0, edac, rigid, g)
        a, b = tfk.fluid_rates_wall(*rw), tfk.fluid_rates_wall_reference(*rw)
        torch.cuda.synchronize()
        _check_fluid_columns(a, b, f"B4 M={M}")
    assert _build.LAUNCHES_INSTANCE.get(f"fluid_rates_wall/lanes{M}", 0) > 0
