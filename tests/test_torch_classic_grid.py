"""Port vs reference: the classic cell grid (one slot a cell, lanes sized
from occupancy, any stencil radius ``sub``), and the routes that refuse
it.

* ``config_from_positions`` field for field against the JAX package's,
  with ``spill=False``, ``sub=2``, an explicit ``M`` and the defaults,
  in 2D and 3D, on seeded random positions (the JAX occupancy rule and
  its spill choice, ``ops/cellpairs.py:143, 168-176``).
* ``build_cell_grid`` on those classic configs against the JAX build bit
  for bit on every output (``slot2p``, ``dense_pos``, ``nbr_slots``,
  ``n_occupied``, ``overflow``), inactive particles included, and on a
  lane overflow (a cell holding more than M particles) and a cell
  overflow (more occupied cells than ``NC_max``).
* The compact contact stores need the spill grid and raise on a classic
  config, in the coupling's set-up and its compact kdkf step (the JAX
  sorted build raises, ``ops/cellpairs.py:480``); the packed build
  itself still refuses it; the full kdkf route runs there.
* The overflow rebuild (``refresh_configs``) drops a preset classic
  config, so the next ``cell_config`` sizes a spill grid, on both sides;
  a rigid GTVF run through the ``Solver`` then steps on, on the spill
  grid's compact route, bit for bit the full route's steps there.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell

from rigid_body_2d_3d_pysph_tpu_torch import geom as tgeom
from rigid_body_2d_3d_pysph_tpu_torch.app.application import Solver
from rigid_body_2d_3d_pysph_tpu_torch.models import (
    RigidFluidCouplingScheme as TRFC)
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.models import (
    rigid_fluid_coupling as tcpl)
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group as tmake_group, build_scene as tbuild_scene)

from test_torch_coupling_step import coupling_scene
from test_torch_rigid_steppers import DT, _wall_groups

CPU = torch.device("cpu")
CUTOFF = 0.1
# (label, keyword arguments): the grids a user can ask for
CONFIGS = (("classic", dict(spill=False)), ("sub2", dict(sub=2)),
           ("explicit_M", dict(M=200)), ("default", dict()),
           ("coupling", dict(occupancy_safety=2.6, spill=False)))


def _positions(dim, seed=0):
    """Seeded random positions with a denser patch (cells of unequal
    occupancy) and every 17th particle inactive."""
    rng = np.random.default_rng(seed)
    n = 900 if dim == 2 else 1500
    pts = rng.uniform(0.0, 1.0, (n, 3))
    pts[: n // 5] = rng.uniform(0.4, 0.5, (n // 5, 3))
    if dim == 2:
        pts[:, 2] = 0.0
    active = np.ones(n, bool)
    active[::17] = False
    return pts[:, 0], pts[:, 1], pts[:, 2], active


def _builds(x, y, z, active, jcfg):
    """The JAX and the port's ``build_cell_grid`` on one config."""
    tcfg = tcell.CellGridConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tcell.CellGridConfig)})
    jgrid = jax.jit(lambda *a: jcell.build_cell_grid(*a, jcfg))(
        *(jnp.asarray(a) for a in (x, y, z, active)))
    T = lambda a: torch.as_tensor(a)
    tgrid = tcell.build_cell_grid(T(x), T(y), T(z), T(active), tcfg)
    return jgrid, tgrid


def _assert_grids_equal(jgrid, tgrid):
    for name in jgrid._fields:
        a = np.asarray(getattr(jgrid, name))
        b = getattr(tgrid, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("label,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_config_from_positions_matches_reference(dim, label, kw):
    x, y, z, _ = _positions(dim)
    jcfg = jcell.config_from_positions(x, y, z, CUTOFF, dim, **kw)
    tcfg = tcell.config_from_positions(x, y, z, CUTOFF, dim, **kw)
    for f in dataclasses.fields(tcell.CellGridConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.O == jcfg.O and tcfg.stencil == jcfg.stencil
    # the layout rule: spill exactly for no M and sub 1, unless forced
    assert tcfg.spill == (label == "default")
    if not tcfg.spill:
        assert tcfg.M % 8 == 0 and tcfg.O == (2 * tcfg.sub + 1) ** dim


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("label,kw", [c for c in CONFIGS if c[0] not in
                                      ("default", "coupling")],
                         ids=["classic", "sub2", "explicit_M"])
def test_classic_build_matches_reference_bit_for_bit(dim, label, kw):
    x, y, z, active = _positions(dim)
    jcfg = jcell.config_from_positions(x, y, z, CUTOFF, dim, **kw)
    jgrid, tgrid = _builds(x, y, z, active, jcfg)
    assert not bool(jgrid.overflow)
    assert int(tgrid.n_occupied) > 0
    # every active particle has a lane; the inactive ones none
    dp = tgrid.dense_pos.numpy()
    assert (dp[active] < jcfg.NC_max * jcfg.M).all()
    assert (dp[~active] == jcfg.NC_max * jcfg.M).all()
    _assert_grids_equal(jgrid, tgrid)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("case", ["lane", "cell"])
def test_classic_build_overflows_match_reference(dim, case):
    x, y, z, active = _positions(dim, seed=1)
    jcfg = jcell.config_from_positions(x, y, z, CUTOFF, dim, spill=False)
    if case == "lane":       # the dense patch's cells hold more than 8
        jcfg = dataclasses.replace(jcfg, M=8)
    else:                    # fewer slots than occupied cells
        jcfg = dataclasses.replace(jcfg, NC_max=jcfg.NC_max // 3)
    jgrid, tgrid = _builds(x, y, z, active, jcfg)
    assert bool(jgrid.overflow) and bool(tgrid.overflow)
    _assert_grids_equal(jgrid, tgrid)


def _classic_of(scheme, scene, **kw):
    """A classic config of the scene's positions at the scheme's cutoff."""
    host = lambda k: scene[k].numpy()
    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    cutoff = kernel.radius_scale * float(host("h").max())
    return tcell.config_from_positions(host("x"), host("y"), host("z"),
                                       cutoff, scheme.dim, **kw)


def _coupling(with_spill):
    sch, scene, _, _ = coupling_scene(tmake_group, tbuild_scene, tgeom, TRFC,
                                      True, device=CPU, dtype=torch.float64)
    if not with_spill:
        sch._cell_cfg = _classic_of(sch, scene, occupancy_safety=2.6,
                                    spill=False)
    return sch, scene


def test_kdkf_and_compact_store_refuse_the_classic_grid():
    # kdkf's compact route reads the sorted build's pack tables: its step
    # raises on a classic grid, naming the spill requirement; the full
    # kdkf route runs there (held to the JAX XLA step in
    # test_torch_classic_steps.py), and so does kdk
    sch, scene = _coupling(with_spill=False)
    scene = sch.setup(scene)
    assert "cl_pid" not in scene
    with pytest.raises(ValueError, match="spill"):
        tcpl.build_coupling_kdkf_step(
            get_kernel("quintic", 2), sch._cell_cfg,
            dict(gx=0.0, gy=-1.0, gz=0.0), True, 0.1, 1.0, 1.0, 7.0, 0.1,
            True, ni_max=4)
    out = sch.make_step(scene)(scene, DT)
    assert torch.isfinite(out.x).all() and not bool(out.nbr_overflow)
    sch.gtvf_ordering = "kdk"
    sch.make_step(scene)

    # the coupling's compact store: set-up raises on a classic grid
    sch, scene = _coupling(with_spill=False)
    sch.compact_min_bodies = 1
    with pytest.raises(ValueError, match="spill"):
        sch.setup(scene)

    # the rigid scheme's compact route refuses the grid, and a scene set
    # up compact on the spill grid cannot step on a classic one
    groups, dx = _wall_groups(tmake_group)
    tscene = tbuild_scene(groups, dim=2, total_no_bodies=3, spacing0=dx,
                          device=CPU, dtype=torch.float64)
    rsch = trb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    compact = rsch.setup(tscene)
    assert "cl_pid" in compact
    classic = _classic_of(rsch, tscene, spill=False)
    with pytest.raises(ValueError, match="spill"):
        trb.build_rigid_gtvf_step_cell(get_kernel("quintic", 2), classic,
                                       {}, True, ni_max=8)
    rsch._cell_cfg = classic
    with pytest.raises(ValueError, match="spill"):
        rsch.make_step(compact)
    # the packed (sorted) build itself refuses it too
    with pytest.raises(ValueError, match="spill"):
        tcell.build_cell_grid_packed(tscene.x, tscene.y, tscene.z,
                                     tscene.active, classic, [tscene.x])


def test_overflow_rebuild_resizes_a_spill_grid():
    """The Solver's overflow rebuild (``refresh_configs``) drops the
    scheme's grid config, so a preset classic grid comes back as the
    spill grid sized from the current positions, as in the reference."""
    groups, dx = _wall_groups(tmake_group)
    tscene = tbuild_scene(groups, dim=2, total_no_bodies=3, spacing0=dx,
                          device=CPU, dtype=torch.float64)
    tsch = trb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    jsch = jrb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    jsch.engine = "cell"
    classic = _classic_of(tsch, tscene, sub=2)
    tsch._cell_cfg = classic
    jsch._cell_cfg = jcell.CellGridConfig(**dataclasses.asdict(classic))
    kernel = get_kernel("quintic", 2)
    for sch in (tsch, jsch):
        sch.refresh_configs(tscene)
        assert sch._cell_cfg is None
    tcfg = tsch.cell_config(tscene, kernel)
    jcfg = jsch.cell_config(
        type("S", (), {k: tscene[k].numpy() for k in ("x", "y", "z", "h")})(),
        jrb.get_kernel("quintic", 2))
    assert tcfg.spill and jcfg.spill
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_classic_gtvf_runs_on_after_an_overflow_rebuild(tmp_path):
    """A rigid GTVF run on a preset classic grid whose slots are too
    narrow (M 8; a cell of the blocks holds more) overflows in its first
    chunk.  The Solver's rebuild drops the config, so the chunk runs
    again on the spill grid; ``adapt_scene`` moves the full scene into
    the compact store that the spill grid's GTVF route reads.  The run
    then steps to its end and equals, bit for bit in float64, the full
    route's steps on that spill grid from the same start."""
    groups, dx = _wall_groups(tmake_group)
    scene = tbuild_scene(groups, dim=2, total_no_bodies=3, spacing0=dx,
                         device=CPU, dtype=torch.float64)
    sch = trb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    sch._cell_cfg = _classic_of(sch, scene, spill=False)
    # the blocks thrown at each other: in contact from step ~12
    scene = sch.set_linear_velocity(sch.setup(scene),
                                    [[8.0, -1.0, 0.0], [-8.0, 1.0, 0.0]])
    assert "cl_pid" not in scene
    narrow = _classic_of(sch, scene, M=8)
    sch._cell_cfg = narrow
    assert bool(sch.make_step(scene)(scene, DT).nbr_overflow)

    n_steps = 20
    solver = Solver(sch, scene, DT, n_steps * DT, pfreq=10,
                    output_dir=str(tmp_path))
    end = solver.solve(quiet=True)
    cfg = sch._cell_cfg
    assert solver.rebuilds_total == 1 and solver.count == n_steps
    assert cfg.spill and cfg != narrow
    assert "cl_pid" in end and not bool(end.nbr_overflow)

    kernel = get_kernel("quintic", 2)
    params = dict(kr=sch.kr, kf=sch.kf, fric_coeff=sch.fric_coeff,
                  gx=sch.gx, gy=sch.gy, gz=sch.gz)
    full = trb.build_rigid_gtvf_step_full(
        trb._make_force_eval(kernel, params, cell_cfg=cfg), True)
    ref = scene
    for _ in range(n_steps):
        ref = full(ref, DT)
    got = trb.strip_compact_fields(trb.expand_slot_scene(end))
    assert float(got.overlap.max()) > 0
    assert set(got.fields) - {"n_interesting"} == set(ref.fields)
    for k, v in ref.fields.items():
        assert torch.equal(got[k], v), k
