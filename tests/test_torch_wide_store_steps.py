"""Port vs reference at the step level past the hand kernels' narrow
instance (S > 64), where K2 and B5 write their contact columns in the
layouts the steps read (``tests/test_torch_wide_store.py``):

* the kdkf coupling step on 72 small boxes of rho 8 in a tank (S = 73,
  a lattice of 2^-7), each box moving down and sideways at its own
  velocity so that its contacts slide: the port's compact route (B5 by
  query row at the light cull's slots; the store from 8 entities) and
  its full route (B5 by particle) against the reference's XLA cell route
  in f64, 3 steps, every fluid, body and slot field within rtol 1e-10
  (absolute 1e-10 x max(|field|, 1)), and the two routes equal to each
  other bit for bit;
* the rigid RK2 step (K2 on every slot, by particle) on 69 blocks over a
  wall (S = 70), thrown at random velocities, against the reference's
  RK2 step on its XLA cell engine in f64, 3 steps, every field both
  scenes hold within rtol 1e-10, as ``tests/test_torch_rigid_steppers.py``.

On CPU tensors the kernel wrappers run their plain versions.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu import geom as jgeom
from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.models.rigid_fluid_coupling import (
    RigidFluidCouplingScheme as JRFC)
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb

from test_torch_coupling_compact import (
    BODY, FLUID, SLOTS, _compare, _full, _in_sliding_contact, _run, _twin)
from test_torch_rigid_steppers import _compare_all, _port_twin

# a lattice of 2^-7 and gaps of 3/4 of it: the first step's pair
# distances are exact on both sides, so a distance tie in a closest-source
# pick resolves the same way (with dx = 0.01 one tie in 72 boxes picked
# another source, and its friction direction, on the two sides), and
# every contact is well past its engagement threshold (at 0.95 dx, an
# Eq.-21 distance a few ulp from dx engages on one side only)
DX = 2.0 ** -7
BOX = 3            # particles along a box's side
ROWS, COLS = 6, 12
GAP = 0.75
DT = 2e-5
STEPS = 3


def many_boxes(make_group, build_scene, geom, scheme_cls):
    """ROWS x COLS boxes of BOX x BOX particles and rho 8 in a hydrostatic
    tank, GAP dx apart and GAP dx over the floor's top layer, the fluid
    carved a dx around each box (one group a box): (scheme, unset-up
    scene), S = ROWS COLS + 1."""
    gy, rho0 = -1.0, 1.0
    span = (BOX - 1) * DX
    pitch = span + GAP * DX
    nb = ROWS * COLS
    xf, yf, xt, yt = geom.hydrostatic_tank_2d(
        COLS * pitch + 8 * DX, ROWS * pitch + 8 * DX, ROWS * pitch + 14 * DX,
        3, DX, DX)
    p0 = -rho0 * gy * (yf.max() - yf)
    xb, yb = geom.get_2d_block(DX, span, span)
    xb, yb = xb - xb.min() + xf.min() + 4 * DX, yb - yb.min()
    boxes = [(xb + (b % COLS) * pitch, yb - DX + GAP * DX + (b // COLS) * pitch)
             for b in range(nb)]
    keep = np.ones(len(xf), bool)
    for bx, by in boxes:   # the floor's top layer is at y = -dx
        keep &= ~((xf > bx.min() - DX) & (xf < bx.max() + DX)
                  & (yf > by.min() - DX) & (yf < by.max() + DX))
    m = rho0 * DX * DX
    groups = [make_group("fluid", xf[keep], yf[keep], m=m, h=DX, rho=rho0,
                         role="fluid", p=p0[keep]),
              make_group("tank", xt, yt, m=m, h=DX, rho=rho0, rad_s=DX / 2,
                         role="boundary", dem_id=nb)]
    groups += [make_group(f"box{b}", bx, by, m=8.0 * m, h=DX, rho=8.0 * rho0,
                          rad_s=DX / 2, role="rigid",
                          body_id=np.zeros(len(bx), np.int32),
                          dem_id=np.full(len(bx), b, np.int32))
               for b, (bx, by) in enumerate(boxes)]
    scene = build_scene(groups, dim=2, total_no_bodies=nb + 1, spacing0=DX)
    c0 = 10 * np.sqrt(2 * abs(gy) * (yf.max() - yf.min()))
    scheme = scheme_cls(
        rigid_bodies=[f"box{b}" for b in range(nb)], fluids=["fluid"],
        boundaries=["tank"], dim=2, rho0=rho0, p0=rho0 * c0**2, c0=c0,
        gy=gy, nu=0.0, h=DX)
    return scheme, scene


@pytest.fixture(scope="module")
def reference():
    """The reference's set-up of the boxes (the full [N, S] schema), each
    box's velocity (down at its own speed, sideways by its row's parity)
    and the
    displaced fluid's shadow mass on the boxes, and its XLA cell route's
    STEPS f64 steps."""
    jsch, jscene = many_boxes(jmake_group, jbuild_scene, jgeom, JRFC)
    jsch.engine = "cell"
    jscene = jsch.setup(jscene)
    assert "cl_pid" not in jscene.fields
    rb = np.asarray(jscene.is_rigid)
    nb = jscene.meta.nb
    row = np.arange(nb) // COLS
    # every contact slides: neighbours in a row fall at speeds of their
    # own, neighbouring rows move sideways apart (at zero tangential
    # velocity the Coulomb friction's direction is rounding noise)
    vcm = np.stack([np.where(row % 2 == 0, 0.05, -0.05),
                    -0.3 - 0.005 * np.arange(nb), np.zeros(nb)], 1)
    jscene = jscene.replace(
        m_fsi=jnp.asarray(np.where(rb, DX * DX, np.asarray(jscene.m_fsi))),
        rho_fsi=jnp.asarray(np.where(rb, 1.0, np.asarray(jscene.rho_fsi))),
        vcm=jnp.asarray(vcm))
    end, _ = _run(jsch.make_step(jscene), jscene, STEPS, DT)
    return dict(jsch=jsch, start=jscene, end=end)


@pytest.mark.parametrize("route", ["compact", "full"])
def test_kdkf_many_bodies_matches_reference_f64(reference, route):
    tsch, tscene = _twin(reference["jsch"], reference["start"],
                         torch.float64)
    S = tscene.meta.total_no_bodies
    assert S == ROWS * COLS + 1 > 64
    cfg = tsch._cell_cfg
    full, _ = _run(tsch.make_step(tscene), tscene, STEPS, DT)
    assert "cl_pid" not in full
    end = full
    if route == "compact":
        compact = trb.compact_slot_scene(tscene, tsch.ni_max(cfg) * cfg.M)
        end, _ = _run(tsch.make_step(compact), compact, STEPS, DT)
        assert 0 < int(end.n_interesting) <= tsch.ni_max(cfg)
        expanded = _full(end)
        for k in full.fields:
            assert torch.equal(expanded[k], full[k]), k
    _in_sliding_contact(reference["end"])
    _in_sliding_contact(end)
    _compare(reference["end"], end, FLUID + BODY + SLOTS, rtol=1e-10)


def _blocks(make_group, n_blocks=69, side=3, cols=12, dx=2.0 ** -6,
            gap=0.75):
    """``n_blocks`` blocks of side x side particles in columns ``gap`` dx
    apart (in contact from the start), the lowest row 0.75 dx over a wall
    row: the groups, dx."""
    a = np.arange(side) * dx
    pitch = (side - 1) * dx + gap * dx
    xs, ys, bid = [], [], []
    for b in range(n_blocks):
        x, y = (c.ravel() for c in np.meshgrid(a + (b % cols) * pitch,
                                               a + (b // cols) * pitch))
        xs.append(x)
        ys.append(y)
        bid.append(np.full(x.size, b, np.int32))
    x, y, bid = (np.concatenate(v) for v in (xs, ys, bid))
    xw = np.arange(-3, int(round(x.max() / dx)) + 4) * dx
    m = 2000 * dx * dx
    body = make_group("body", x, y, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role="rigid", body_id=bid, dem_id=bid)
    wall = make_group("wall", xw, np.full(len(xw), -gap * dx), m=m,
                      h=1.3 * dx, rho=2000.0, rad_s=dx / 2, role="boundary",
                      dem_id=n_blocks)
    return [body, wall], dx


def test_rk2_many_bodies_matches_reference_f64():
    groups, dx = _blocks(jmake_group)
    nb = 69
    jscene = jbuild_scene(groups, dim=2, total_no_bodies=nb + 1,
                          spacing0=dx)
    jsch = jrb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    jsch.engine = "cell"
    jsch.integrator = "rk2"
    jscene = jsch.setup(jscene)
    rng = np.random.default_rng(11)
    throw = np.concatenate([rng.uniform(-1, 1, (nb, 2)),
                            np.zeros((nb, 1))], 1)
    jscene = jsch.set_linear_velocity(jscene, throw)
    tsch, tscene = _port_twin(jsch, jscene, trb.RigidBody2DScheme)
    assert tscene.meta.total_no_bodies == 70 and "cl_pid" not in tscene
    jstep, tstep = jsch.make_step(jscene), tsch.make_step(tscene)
    for _ in range(STEPS):
        jscene = jstep(jscene, jnp.asarray(1e-4))
        tscene = tstep(tscene, 1e-4)
    assert not bool(jscene.nbr_overflow) and not bool(tscene.nbr_overflow)
    # blocks in contact, some with a block past the narrow instance's 64
    overlap = np.asarray(jscene.overlap)
    assert overlap.max() > 0 and (overlap[:, 64:] > 0).any()
    _compare_all(jscene, tscene)
