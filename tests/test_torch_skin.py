"""Port vs reference: the Verlet-skin grid reuse of the rigid schemes on
the cell engine (``skin_factor > 0``), float64.

The scene is ``tests/test_cell_engine.py``'s skin case: two blocks side
by side 0.6 dx apart, a wall row at rest distance below, gravity, skin
0.3 of the cutoff.  The port's set-up (bins of cutoff + skin, the grid
and its build positions attached as ``g_*`` fields, the full ``[N, S]``
schema) equals the reference's field for field; then, from the
reference's set-up state carried across on its grid configuration:

* GTVF, 25 steps inside the reuse window (``g_xb`` unchanged on both
  sides), then one body moved past skin / 2 and one more step: both
  rebuild (``g_xb`` changes) at the same step;
* RK2 and leapfrog (``RigidBody3DScheme`` on the 2D scene), 20 steps of
  the blocks thrown at each other, so contacts engage under the skin;

every field both scenes hold within rtol 1e-10 (the reference sums the
pairs in another order), the grid tables exactly.  On the port alone:

* a run checkpointed at step 10 and resumed to step 20 equals the
  uninterrupted run bit for bit (the carried grid and its config ride
  the checkpoint);
* an overflowing skin grid is rebuilt by the ``Solver``'s overflow rule
  (``refresh_configs`` then ``adapt_scene``, which re-attaches the grid
  for the new config) and the run then equals one that started on that
  config bit for bit;
* with a skin the GTVF step packs through the carried grid: K2 on every
  slot once a step, no pack expansion, no compact store.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.geom import get_2d_block
from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from rigid_body_2d_3d_pysph_tpu_torch.app.application import Solver
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group as tmake_group, build_scene as tbuild_scene)

from test_torch_rigid_steppers import THROW, _compare_all, _port_twin

CPU = torch.device("cpu")
SKIN = 0.3
DT = 1e-4
GRID = ("g_slot2p", "g_dense_pos", "g_nbr_slots", "g_n_occ", "g_overflow")


def _groups(make_group):
    """``test_cell_engine.test_verlet_skin_matches_no_skin``'s scene."""
    dx = 0.04
    xb, yb = get_2d_block(dx, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.2 + 0.6 * dx])
    y = np.concatenate([yb, yb])
    bid = np.concatenate([np.zeros(len(xb), np.int32),
                          np.ones(len(xb), np.int32)])
    xw = np.arange(-8, 20) * dx
    yw = np.full(len(xw), yb.min() - 0.7 * dx)
    m = 2000 * dx * dx
    body = make_group("body", x, y, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role="rigid", body_id=bid, dem_id=bid)
    wall = make_group("wall", xw, yw, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role="boundary", dem_id=2)
    return [body, wall], dx, len(xb)


def _schemes(jcls, tcls, integrator):
    kw = dict(gy=-9.81, dim=2)
    jsch = jcls(["body"], ["wall"], **kw)
    tsch = tcls(["body"], ["wall"], **kw)
    for s in (jsch, tsch):
        s.engine, s.integrator, s.skin_factor = "cell", integrator, SKIN
    return jsch, tsch


def _jax_setup(integrator="gtvf", cls=jrb.RigidBody2DScheme):
    groups, dx, nb1 = _groups(jmake_group)
    jscene = jbuild_scene(groups, dim=2, total_no_bodies=3, spacing0=dx)
    jsch, _ = _schemes(cls, trb.RigidBody2DScheme, integrator)
    return jsch, jsch.setup(jscene), nb1


def _twin(jsch, jscene, cls=trb.RigidBody2DScheme):
    """The port's scheme and state for a set-up reference pair, its grid
    attached by the port (the same build: the tables equal the
    reference's)."""
    tsch, tscene = _port_twin(jsch, jscene, cls)
    tsch.skin_factor = jsch.skin_factor
    # a grid not built for the scheme's config is rebuilt
    tscene = tsch.adapt_scene(tscene)
    for k in GRID:
        np.testing.assert_array_equal(tscene[k].numpy(),
                                      np.asarray(jscene[k]), err_msg=k)
    return tsch, tscene


def _shift(scene, nb1, shift, conv):
    move = np.zeros(scene.n)
    move[:nb1] = shift
    return scene.replace(x=scene.x + conv(move))


def test_setup_matches_reference_f64():
    jsch, jscene, _ = _jax_setup()
    groups, dx, _ = _groups(tmake_group)
    tscene = tbuild_scene(groups, dim=2, total_no_bodies=3, spacing0=dx,
                          device=CPU, dtype=torch.float64)
    _, tsch = _schemes(jrb.RigidBody2DScheme, trb.RigidBody2DScheme,
                       "gtvf")
    tscene = tsch.setup(tscene)
    assert tsch._cell_cfg.skin > 0
    assert tsch._cell_cfg.cell == jsch._cell_cfg.cell
    assert tsch._cell_cfg.O == jsch._cell_cfg.O
    # the full [N, S] schema and the carried grid, as the reference's
    assert "cl_pid" not in tscene
    assert set(tscene.fields) == set(jscene.fields)
    _compare_all(jscene, tscene)


def test_gtvf_reuse_window_and_rebuild_match_reference():
    jsch, jscene, nb1 = _jax_setup()
    tsch, tscene = _twin(jsch, jscene)
    jstep, tstep = jsch.make_step(jscene), tsch.make_step(tscene)
    xb0 = tscene.g_xb.clone()
    for _ in range(25):
        jscene = jstep(jscene, jnp.asarray(DT))
        tscene = tstep(tscene, DT)
    # the reuse window: neither side rebuilt
    assert torch.equal(tscene.g_xb, xb0)
    np.testing.assert_array_equal(np.asarray(jscene.g_xb), xb0.numpy())
    assert float(np.asarray(jscene.overlap).max()) > 0
    _compare_all(jscene, tscene)

    # one body past skin / 2: both rebuild on the next step
    shift = 0.6 * SKIN * jsch._cell_cfg.radius
    jscene = _shift(jscene, nb1, shift, jnp.asarray)
    tscene = _shift(tscene, nb1, shift, torch.as_tensor)
    jscene = jstep(jscene, jnp.asarray(DT))
    tscene = tstep(tscene, DT)
    assert not torch.equal(tscene.g_xb, xb0)
    np.testing.assert_array_equal(np.asarray(jscene.g_xb),
                                  tscene.g_xb.numpy())
    _compare_all(jscene, tscene)


@pytest.mark.parametrize("integrator", ["rk2", "leapfrog"])
def test_rk2_and_leapfrog_with_skin_match_reference(integrator):
    jcls, tcls = ((jrb.RigidBody3DScheme, trb.RigidBody3DScheme)
                  if integrator == "leapfrog"
                  else (jrb.RigidBody2DScheme, trb.RigidBody2DScheme))
    jsch, jscene, _ = _jax_setup(integrator, jcls)
    jscene = jsch.set_linear_velocity(jscene, THROW)
    tsch, tscene = _twin(jsch, jscene, tcls)
    jstep, tstep = jsch.make_step(jscene), tsch.make_step(tscene)
    for _ in range(20):
        jscene = jstep(jscene, jnp.asarray(DT))
        tscene = tstep(tscene, DT)
    assert not bool(jscene.nbr_overflow) and not bool(tscene.nbr_overflow)
    assert float(np.asarray(jscene.overlap).max()) > 0
    _compare_all(jscene, tscene)


def _port_scheme(**kw):
    groups, dx, _ = _groups(tmake_group)
    scene = tbuild_scene(groups, dim=2, total_no_bodies=3, spacing0=dx,
                         device=CPU, dtype=torch.float64)
    sch = trb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    sch.skin_factor = SKIN
    for k, v in kw.items():
        setattr(sch, k, v)
    scene = sch.setup(scene)
    return sch, sch.set_linear_velocity(scene, [[2.0, -1.0, 0.0]] * 2)


def _equal(a, b):
    assert set(a.fields) == set(b.fields)
    for k in a.fields:
        assert torch.equal(a[k], b[k]), k


def test_checkpoint_resume_is_bit_for_bit(tmp_path):
    def solve(out, tf, resume=False):
        sch, scene = _port_scheme()
        solver = Solver(sch, scene, DT, tf, pfreq=5, output_dir=out,
                        checkpoint_every=1)
        return sch, solver.solve(quiet=True, resume=resume)

    _, full = solve(str(tmp_path / "a"), 20 * DT)
    out = str(tmp_path / "b")
    _, half = solve(out, 10 * DT)
    # the carried grid is the set-up's: positions moved since its build
    assert not torch.equal(half.g_xb, half.x)
    sch, resumed = solve(out, 20 * DT, resume=True)
    assert sch._grid_cfg == sch._cell_cfg
    _equal(full, resumed)


def test_overflow_rebuild_reattaches_the_grid(tmp_path):
    def run(out, narrow):
        sch, scene = _port_scheme()
        if narrow:
            # a stencil table too narrow for the grid: its build overflows
            sch._cell_cfg = dataclasses.replace(sch._cell_cfg, nbr_width=8)
            scene = sch.adapt_scene(scene)
            assert bool(scene.g_overflow)
            assert sch._grid_cfg.nbr_width == 8
        solver = Solver(sch, scene, DT, 10 * DT, pfreq=5, output_dir=out)
        return sch, solver, solver.solve(quiet=True)

    sch, solver, end = run(str(tmp_path / "a"), True)
    assert solver.rebuilds_total == 1
    assert sch._grid_cfg == sch._cell_cfg and sch._cell_cfg.nbr_width > 8
    assert end.g_nbr_slots.shape == (sch._cell_cfg.NC_max, sch._cell_cfg.O)
    assert not bool(end.nbr_overflow) and not bool(end.g_overflow)
    sch2, solver2, end2 = run(str(tmp_path / "b"), False)
    assert solver2.rebuilds_total == 0 and sch2._cell_cfg == sch._cell_cfg
    _equal(end, end2)


def test_skin_step_runs_k2_on_every_slot(monkeypatch):
    """With a skin the GTVF step packs through the carried grid (no pack
    expansion, no compact cull) and runs the contact sums on every slot,
    once a step."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    sch, scene = _port_scheme()
    assert "cl_pid" not in scene
    calls = []
    real = tck.contact_sums

    def spy(dfT, qslot, nbr, *a, **kw):
        calls.append(qslot.shape[0])
        return real(dfT, qslot, nbr, *a, **kw)

    def forbid(*a, **kw):
        raise AssertionError("pack expansion on the skin route")

    monkeypatch.setattr(tck, "contact_sums", spy)
    monkeypatch.setattr(tck, "expand_slots", forbid)
    monkeypatch.setattr(tck, "expand_slots_reference", forbid)
    step = sch.make_step(scene)
    for _ in range(3):
        scene = step(scene, DT)
    assert calls == [sch._cell_cfg.NC_max] * 3
