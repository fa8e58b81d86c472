"""Port vs reference: the row-sharded step (``parallel/sharded.py``) on
CPU devices, in float64.

* ``pad_scene`` and ``shard_scene`` against the reference's on 8 blocks
  (the rigid contact scene of ``tests/test_parallel.py`` and the DEM
  strip of ``tests/test_slab_dem.py``, each padded by 4 rows): every
  field of the padded scene, every block's rows against the reference's
  shard on that device, the replicated fields on every block, and
  ``gather_scene`` back to the padded scene.
* The rigid step on 4 blocks against the reference's
  ``make_sharded_step`` on its 8 virtual devices, on
  ``tests/test_parallel.py``'s scene on the cell engine with the blocks
  thrown at each other (the contact engages), at that test's
  tolerances (x, y, u, v, fx, fy atol 1e-9; force 1e-8; xcm 1e-12).
* The compact route (a set-up scene's store carried as ``slot_blob``),
  the DEM step (5 blocks, the tables keyed on the global rows) and the
  coupling step (kdkf on the spill and the classic grid and from a
  compact store, which the blocks carry as the full ``[N, S]`` schema,
  kdk on the spill grid; the box sliding on the tank floor) against the
  port's own single-device step on the padded scene, which other tests
  hold to the reference: rtol 1e-10 (summation order: a device's ghosts
  follow its own rows).
* The steppers the sharded step does not run raise
  ``NotImplementedError``, and a scheme without a grid config
  ``ValueError``.

On CPU tensors the kernel wrappers run their plain versions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.parallel import sharded as jsh

from rigid_body_2d_3d_pysph_tpu_torch import geom as tgeom
from rigid_body_2d_3d_pysph_tpu_torch.models import (
    DEMScheme, RigidBody2DScheme, RigidFluidCouplingScheme as TRFC)
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.parallel import sharded as tsh
from rigid_body_2d_3d_pysph_tpu_torch.parallel.mesh import make_mesh
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group as tmake_group, build_scene as tbuild_scene)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_parallel import _contact_scene
from test_slab_dem import _wide_grain_scene
from test_torch_coupling_step import (
    _shadow_fields, coupling_scene)
from test_torch_coupling_orderings import SLIDE

CPU = torch.device("cpu")
RTOL = 1e-10
# the rigid scene's blocks closing at 8 m/s: in contact from step 5
THROW = [[4.0, 0.0, 0.0], [-4.0, 0.0, 0.0]]
RIGID_DT = 1e-3
RIGID_STEPS = 8


def _port(jscene):
    return scene_from_numpy({k: np.asarray(v) for k, v in
                             jscene.fields.items()}, jscene.meta, CPU,
                            torch.float64)


def _cpu_mesh(d):
    return make_mesh(d, [CPU] * d)


def _contact_scene_on_cells():
    """``test_parallel``'s scheme and set-up scene on the reference's cell
    engine, its grid sized on the unpadded scene."""
    from rigid_body_2d_3d_pysph_tpu.ops.kernels import get_kernel as jget
    jsch, jscene = _contact_scene()
    jsch.engine = "cell"
    jsch.cell_config(jscene, jget(jsch.kernel_name, jsch.dim))
    return jsch, jscene


def _jax_rigid():
    jsch, jscene = _contact_scene_on_cells()
    return jsch, jsch.set_linear_velocity(jscene, THROW)


def _assert_close(a, b, names, rtol=RTOL, rows=None):
    for k in names:
        x = np.asarray(a[k]) if rows is None else np.asarray(a[k])[rows]
        y = np.asarray(b[k]) if rows is None else np.asarray(b[k])[rows]
        assert np.isfinite(x).all(), k
        scale = max(float(np.abs(y).max()), 1.0)
        np.testing.assert_allclose(x, y, rtol=rtol, atol=rtol * scale,
                                   err_msg=k)


@pytest.mark.parametrize("which", ["rigid", "dem"])
def test_pad_and_shard_match_reference(which):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jscene = (_contact_scene_on_cells() if which == "rigid"
              else _wide_grain_scene())[1]
    assert jscene.n % 8 == 4
    jpad = jsh.pad_scene(jscene, 8)
    jparts = jsh.shard_scene(jscene, jsh.make_mesh(8))
    tscene = _port(jscene)
    tpad = tsh.pad_scene(tscene, 8)
    assert tpad.n == jpad.n and set(tpad.fields) == set(jpad.fields)
    rule = tsh.scene_shardings(tpad)
    for k, v in jpad.fields.items():
        assert tpad[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(tpad[k].numpy(), np.asarray(v),
                                      err_msg=k)
        assert rule[k] == (np.ndim(v) >= 1 and np.shape(v)[0] == jpad.n)
    if which == "dem":
        assert (tpad.tng_idx[jscene.n:] == -1).all()

    parts = tsh.shard_scene(tscene, _cpu_mesh(8))
    nl = jpad.n // 8
    for k, v in jparts.fields.items():
        if not rule[k]:
            for p in parts:
                np.testing.assert_array_equal(p[k].numpy(), np.asarray(v))
            continue
        shards = sorted(v.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        assert len(shards) == 8
        for d, (p, s) in enumerate(zip(parts, shards)):
            assert (s.index[0].start or 0) == d * nl
            np.testing.assert_array_equal(p[k].numpy(), np.asarray(s.data),
                                          err_msg=k)
    back = tsh.gather_scene(parts)
    for k in jpad.fields:
        np.testing.assert_array_equal(back[k].numpy(), tpad[k].numpy())


def test_rigid_sharded_step_matches_reference_sharded_step():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    jsch, jscene = _jax_rigid()
    jmesh = jsh.make_mesh(8)
    jss = jsh.shard_scene(jscene, jmesh)
    jstep = jsh.make_sharded_step(jsch, jss, jmesh)

    tsch = RigidBody2DScheme(jsch.rigid_bodies, jsch.boundaries, dim=2,
                             gy=jsch.gy)
    tsch._cell_cfg = tcell.CellGridConfig(**{
        k: getattr(jsch._cell_cfg, k)
        for k in tcell.CellGridConfig.__dataclass_fields__})
    mesh = _cpu_mesh(4)
    parts = tsh.shard_scene(_port(jscene), mesh)
    assert "contact_force_normal_x" in parts[0]   # the full [N, S] route
    step = tsh.make_sharded_step(tsch, parts, mesh)
    for _ in range(RIGID_STEPS):
        jss = jstep(jss, jnp.asarray(RIGID_DT))
        parts = step(parts, RIGID_DT)
    out = tsh.gather_scene(parts)
    n = jscene.n
    assert float(np.asarray(jss.overlap).max()) > 0
    assert not bool(out.nbr_overflow)
    for k in ("x", "y", "u", "v", "fx", "fy"):
        np.testing.assert_allclose(out[k].numpy()[:n],
                                   np.asarray(jss[k])[:n], atol=1e-9,
                                   err_msg=k)
    np.testing.assert_allclose(out.force.numpy(), np.asarray(jss.force),
                               atol=1e-8)
    np.testing.assert_allclose(out.xcm.numpy(), np.asarray(jss.xcm),
                               atol=1e-12)


def test_rigid_compact_route_matches_single_device():
    """A scene set up with the compact store: the blocks carry it as
    ``slot_blob`` and take the compact route (the cull and K2 on the
    culled rows) at the single-device capacity."""
    tscene = _port(_contact_scene_on_cells()[1])
    tsch = RigidBody2DScheme(["body"], ["wall"], dim=2, gy=-9.81)
    tscene = tsch.setup(tscene)
    assert "cl_pid" in tscene
    tscene = tsch.set_linear_velocity(tscene, THROW)
    padded = tsh.pad_scene(tscene, 8)
    single = tsch.make_step(padded)
    mesh = _cpu_mesh(8)
    parts = tsh.shard_scene(tscene, mesh)
    assert "slot_blob" in parts[0]
    step = tsh.make_sharded_step(tsch, parts, mesh)
    for _ in range(RIGID_STEPS):
        parts = step(parts, RIGID_DT)
        padded = single(padded, RIGID_DT)
    out = tsh.gather_scene(parts)
    assert not bool(out.nbr_overflow) and not bool(padded.nbr_overflow)
    ref = trb.expand_slot_scene(padded)
    assert float(ref.overlap.max()) > 0
    _assert_close(out, padded, ("x", "y", "u", "v", "fx", "fy", "force",
                                "torque", "xcm", "vcm", "omega"))
    got = trb.deblobify_slot_scene(out)
    _assert_close(got, ref, ("delta_lt_x", "delta_lt_y", "fn_x", "fn_y",
                             "overlap"))


def test_dem_sharded_step_matches_single_device():
    jsch, jscene = _wide_grain_scene()
    tsch = DEMScheme(["grains"], ["floor"], kn=1e5, en=0.5, gy=-9.81, dim=2)
    tscene = _port(jscene)
    tsch.cell_config(tscene)        # sized on the unpadded scene
    padded = tsh.pad_scene(tscene, 5)
    assert padded.n > tscene.n
    single = tsch.make_step(padded)
    mesh = _cpu_mesh(5)
    parts = tsh.shard_scene(tscene, mesh)
    step = tsh.make_sharded_step(tsch, parts, mesh)
    gated = []
    for _ in range(3):
        padded = single(padded, 1e-5)
        parts = step(parts, 1e-5)
        gated.append((int(padded.n_gated),
                      sum(int(p.n_gated) for p in parts)))
    out = tsh.gather_scene(parts)
    assert "gid" not in out and not bool(out.nbr_overflow)
    assert all(a == b > 0 for a, b in gated)
    _assert_close(out, padded, ("x", "y", "u", "v", "wz", "fx", "fy",
                                "torz", "total_tng_contacts"))
    # the tables hold the partners' global rows: the same (partner, dem)
    # -> spring maps row for row
    def tables(s):
        cols = [s[k].numpy() for k in ("tng_idx", "tng_idx_dem_id",
                                       "tng_x", "tng_y")]
        return [{(i, d): (a, b) for i, d, a, b in zip(*r) if i >= 0}
                for r in zip(*cols)]

    for r, (ta, tb) in enumerate(zip(tables(out), tables(padded))):
        assert ta.keys() == tb.keys(), r
        for k in ta:
            np.testing.assert_allclose(ta[k], tb[k], rtol=0, atol=1e-12)


@pytest.mark.parametrize("ordering,grid", [("kdkf", "spill"),
                                           ("kdkf", "classic"),
                                           ("kdkf", "compact"),
                                           ("kdk", "spill")])
def test_coupling_sharded_step_matches_single_device(ordering, grid):
    """With ``compact`` the scene is set up with the compact store: the
    single-device step takes the compact route, the blocks the full
    ``[N, S]`` schema."""
    tsch, tscene, dx, rho0 = coupling_scene(
        tmake_group, tbuild_scene, tgeom, TRFC, True, floor=True,
        device=CPU, dtype=torch.float64)
    tsch.gtvf_ordering = ordering
    if grid == "compact":
        tsch.compact_min_bodies = 1
    if grid == "classic":
        h = float(tscene.h.max())
        host = lambda k: tscene[k].numpy()
        tsch._cell_cfg = tcell.config_from_positions(
            host("x"), host("y"), host("z"), 3.0 * h, 2,
            occupancy_safety=2.6, spill=False)
    tscene = tsch.setup(tscene)
    assert ("cl_pid" in tscene) == (grid == "compact")
    m_fsi, rho_fsi = _shadow_fields(tscene, rho0, dx)
    rng = np.random.default_rng(7)
    tscene = tscene.replace(
        m_fsi=torch.as_tensor(m_fsi), rho_fsi=torch.as_tensor(rho_fsi),
        u=torch.as_tensor(rng.uniform(-0.05, 0.05, tscene.n)),
        v=torch.as_tensor(rng.uniform(-0.05, 0.05, tscene.n)),
        vcm=torch.as_tensor(SLIDE, dtype=torch.float64))
    D = next(d for d in (2, 3, 5) if tscene.n % d)
    padded = tsh.pad_scene(tscene, D)
    assert padded.n > tscene.n
    single = tsch.make_step(padded)
    mesh = _cpu_mesh(D)
    parts = tsh.shard_scene(tscene, mesh)
    assert "contact_force_normal_x" in parts[0]   # the full [N, S] route
    step = tsh.make_sharded_step(tsch, parts, mesh)
    for _ in range(3):
        parts = step(parts, 2e-5)
        padded = single(padded, 2e-5)
    out = tsh.gather_scene(parts)
    assert not bool(out.nbr_overflow) and not bool(padded.nbr_overflow)
    if grid == "compact":
        assert "cl_pid" in padded
        padded = trb.expand_slot_scene(padded)
    assert float(padded.overlap.max()) > 0
    _assert_close(out, padded, ("x", "y", "u", "v", "rho", "p", "p_fsi",
                                "arho", "au", "av", "fx", "fy", "force",
                                "torque", "xcm", "vcm", "omega",
                                "delta_lt_x", "delta_lt_y"))


@pytest.mark.parametrize("case", ["rk2", "leapfrog", "nklist", "lvcforce",
                                  "reference", "no_config"])
def test_refusals(case):
    mesh = _cpu_mesh(2)
    if case in ("rk2", "nklist", "no_config"):
        _, jscene = _jax_rigid()
        sch = RigidBody2DScheme(["body"], ["wall"], dim=2)
        sch._cell_cfg = tcell.config_from_positions(
            np.asarray(jscene.x), np.asarray(jscene.y),
            np.asarray(jscene.z), 0.156, 2)
        parts = tsh.shard_scene(_port(jscene), mesh)
        if case == "rk2":
            sch.integrator = "rk2"
        elif case == "nklist":
            sch.engine = "nklist"
        else:
            sch._cell_cfg = None
            with pytest.raises(ValueError, match="grid config"):
                tsh.make_sharded_step(sch, parts, mesh)
            return
    elif case == "leapfrog":
        sch = trb.RigidBody3DScheme(["body"], [], dim=3)
        sch.integrator = "leapfrog"
        sch._cell_cfg = tcell.config_from_positions(
            np.zeros(4), np.zeros(4), np.zeros(4), 0.1, 3)
        parts = tsh.shard_scene(_port(_jax_rigid()[1]), mesh)
    elif case == "lvcforce":
        sch = DEMScheme(["grains"], ["floor"], dim=2,
                        contact_model="LVCForce")
        sch._cell_cfg = tcell.config_from_positions(
            np.zeros(4), np.zeros(4), np.zeros(4), 0.1, 2)
        parts = [tsh.pad_scene(_port(_wide_grain_scene()[1]), 2)] * 2
    else:
        sch, tscene, _, _ = coupling_scene(
            tmake_group, tbuild_scene, tgeom, TRFC, True, floor=True,
            device=CPU, dtype=torch.float64)
        sch.gtvf_ordering = "reference"
        tscene = sch.setup(tscene)
        parts = tsh.shard_scene(tscene, mesh)
    with pytest.raises(NotImplementedError):
        tsh.make_sharded_step(sch, parts, mesh)
