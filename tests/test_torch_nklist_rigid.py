"""The port's rigid schemes on the ``[N, K]`` list engine against the
JAX package's ``nklist`` engine.

* Set-up surface identification on a list: normals and flags against the
  JAX list route, and against the port's own cell route (flags bit for
  bit, normals to 1e-11 as the JAX package holds its two routes).
* ``contact_force_normals``, ``contact_force_distance`` (on a scene with
  an exact distance tie: the closest source is the first in neighbour
  order on both sides) and ``canelas_pair_force`` (pair and wall modes)
  against JAX in float64.
* GTVF: 10 float64 steps against JAX's ``build_rigid_gtvf_step`` at rtol
  1e-10 on two touching bodies over a wall with random velocities (live
  springs), and 3 float32 steps at rtol 1e-5, atol 1e-5 x max(|field|,
  1) (other summation orders).
* RK2 in 2D (20 steps) and leapfrog in 3D (5 steps) in float64, in
  contact.
* ``evaluate_once`` against JAX's on a summation density.
* A Solver run whose list overflows rebuilds it with a larger M and ends
  equal, bit for bit, to a run started with that M.
* A non-quintic kernel raises on the cell engine and runs on the list.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu import geom as jgeom
from rigid_body_2d_3d_pysph_tpu.app.evaluator import (
    evaluate_once as jevaluate_once)
from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.ops import contact as jcops
from rigid_body_2d_3d_pysph_tpu.ops import neighbors as jnb
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline as JQuintic
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from rigid_body_2d_3d_pysph_tpu_torch import geom as tgeom
from rigid_body_2d_3d_pysph_tpu_torch.app.application import Solver
from rigid_body_2d_3d_pysph_tpu_torch.app.evaluator import (
    evaluate_once as tevaluate_once)
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact as tcops
from rigid_body_2d_3d_pysph_tpu_torch.ops import neighbors as tnb
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import (
    QuinticSpline as TQuintic)
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group as tmake_group, build_scene as tbuild_scene)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_compact_contact import PARAMS
from test_compact_contact import _scene_f32 as _contact_scene_f32
from test_torch_step import _bench_like_groups, _compare, _scene_f64

CPU = torch.device("cpu")


def _port(jscene, dtype=torch.float64):
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    return scene_from_numpy(fields, jscene.meta, CPU, dtype)


def _configs(jscene, radius_scale=3.0):
    """The JAX and port list configs the schemes size from the scene."""
    x, y, z, h = (np.asarray(jscene[k]) for k in ("x", "y", "z", "h"))
    cutoff = float(radius_scale * h.max())
    dim = jscene.meta.dim
    m, k = jnb.estimate_capacities(x, y, z, cutoff, dim, safety=2.0)
    jcfg = jnb.default_config(dim, cutoff, jscene.n, max_neighbors=k,
                              max_per_cell=m)
    return jcfg, tnb.NeighborConfig(**dataclasses.asdict(jcfg))


def _lists(jscene, tscene):
    jcfg, tcfg = _configs(jscene)
    jl = jnb.build_neighbors(jscene.x, jscene.y, jscene.z, jscene.active,
                             jcfg)
    tl = tnb.build_neighbors(tscene.x, tscene.y, tscene.z, tscene.active,
                             tcfg)
    np.testing.assert_array_equal(tl.idx.numpy(), np.asarray(jl.idx))
    return jl, tl


def _close(a, b, what, rtol=1e-12):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    scale = max(float(np.abs(a).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# set-up and the contact passes
# ---------------------------------------------------------------------------

def test_list_boundary_identification_matches_jax_and_cell_route():
    jgroups, dx = _bench_like_groups(jmake_group, jgeom)
    tgroups, _ = _bench_like_groups(tmake_group, tgeom)
    jscene = jbuild_scene(jgroups, dim=2, total_no_bodies=3, spacing0=dx)
    jsch = jrb.RigidBody2DScheme(["body"], ["tank"], dim=2, gy=-9.81)
    jsch.engine = "nklist"
    jscene = jsch.setup(jscene)

    def port_setup(engine):
        tscene = tbuild_scene(tgroups, dim=2, total_no_bodies=3, spacing0=dx,
                              device=CPU, dtype=torch.float64)
        tsch = trb.RigidBody2DScheme(["body"], ["tank"], dim=2, gy=-9.81)
        tsch.engine = engine
        return tsch, tsch.setup(tscene)

    tsch, tscene = port_setup("nklist")
    # the list engine keeps the full [N, S] schema
    assert "cl_pid" not in tscene and tsch.export_scene(tscene) is tscene
    assert int(tscene.is_boundary.sum()) > 0
    np.testing.assert_array_equal(tscene.is_boundary.numpy(),
                                  np.asarray(jscene.is_boundary))
    np.testing.assert_array_equal(tscene.contact_force_is_boundary.numpy(),
                                  np.asarray(jscene.contact_force_is_boundary))
    _close(jscene.normal, tscene.normal, "normal")

    _, cscene = port_setup("cell")
    np.testing.assert_array_equal(cscene.is_boundary.numpy(),
                                  tscene.is_boundary.numpy())
    np.testing.assert_allclose(cscene.normal.numpy(), tscene.normal.numpy(),
                               rtol=0, atol=1e-11)


def _with_materials(scene, module):
    n = scene.n
    rng = np.random.default_rng(7)
    E = rng.uniform(1e6, 2e6, n)
    nu = rng.uniform(0.2, 0.35, n)
    conv = jnp.asarray if module == "jax" else torch.from_numpy
    return scene.with_fields(E=conv(E), poisson_ratio=conv(nu))


def test_contact_passes_match_jax_f64():
    jscene, dx = _scene_f64()
    tscene = _port(jscene)
    jl, tl = _lists(jscene, tscene)
    kernel_j, kernel_t = JQuintic(dim=2), TQuintic(dim=2)
    jn = jcops.contact_force_normals(jscene, jl, kernel_j)
    tn = tcops.contact_force_normals(tscene, tl, kernel_t)
    for i, (a, b) in enumerate(zip(jn, tn)):
        _close(a, b, f"normals {i}")
    assert float(np.asarray(jn[3]).max()) > 0
    jd = jcops.contact_force_distance(jscene, jl, kernel_j, *jn[:3])
    td = tcops.contact_force_distance(tscene, tl, kernel_t, *tn[:3])
    assert set(jd) == set(td)
    for k in jd:
        _close(jd[k], td[k], k)
    assert float(np.abs(np.asarray(jd["contact_force_dist"])).max()) > 0

    js, ts = _with_materials(jscene, "jax"), _with_materials(tscene, "torch")
    for wall_mode in (False, True):
        jf = jcops.canelas_pair_force(js, jl, wall_mode=wall_mode)
        tf = tcops.canelas_pair_force(ts, tl, wall_mode=wall_mode)
        for i, (a, b) in enumerate(zip(jf, tf)):
            _close(a, b, f"canelas {wall_mode} {i}")
        assert float(np.abs(np.asarray(jf[0])).max()) > 0


def _tie_groups(make_group):
    """A rigid row over a wall row whose particles sit symmetrically about
    each rigid particle: each has two wall sources at exactly one
    distance (a power-of-two spacing keeps every coordinate exact)."""
    dx = 2.0 ** -4
    xr = np.arange(6) * dx
    xw = np.arange(-4, 10) * dx + 0.5 * dx
    kw = dict(m=2000 * dx * dx, h=1.3 * dx, rho=2000.0, rad_s=dx / 2)
    body = make_group("body", xr, np.zeros(6), role="rigid",
                      body_id=np.zeros(6, np.int32), dem_id=0, **kw)
    wall = make_group("wall", xw, np.full(len(xw), -0.75 * dx),
                      role="boundary", dem_id=1, **kw)
    return [body, wall], dx


def test_closest_source_tie_goes_to_the_first_neighbour():
    jgroups, dx = _tie_groups(jmake_group)
    jscene = jbuild_scene(jgroups, dim=2, total_no_bodies=2, spacing0=dx)
    jscene = jrb._attach_contact_fields(jscene).replace(
        contact_force_is_boundary=jnp.ones(jscene.n))
    tscene = _port(jscene)
    jl, tl = _lists(jscene, tscene)
    kj, kt = JQuintic(dim=2), TQuintic(dim=2)
    jn = jcops.contact_force_normals(jscene, jl, kj)
    tn = tcops.contact_force_normals(tscene, tl, kt)
    jd = jcops.contact_force_distance(jscene, jl, kj, *jn[:3])
    td = tcops.contact_force_distance(tscene, tl, kt, *tn[:3])
    for k in jd:
        _close(jd[k], td[k], k)
    # every rigid particle's two nearest wall particles tie exactly; the
    # pick is the one in the lower list column
    idx, mask = tl.idx.numpy(), tl.mask.numpy()
    x, y = tscene.x.numpy(), tscene.y.numpy()
    for i in range(6):
        walls = [(c, j) for c, j in enumerate(idx[i])
                 if mask[i, c] and j >= 6]
        d = {j: (x[i] - x[j]) ** 2 + (y[i] - y[j]) ** 2 for _, j in walls}
        near = [j for j in d if d[j] == min(d.values())]
        assert len(near) == 2
        first = min((c, j) for c, j in walls if j in near)[1]
        assert td["x_source"][i, 1].item() == x[first]


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def test_ten_f64_gtvf_steps_match_jax_nklist():
    jscene, dx = _scene_f64()
    tscene = _port(jscene)
    jcfg, tcfg = _configs(jscene)
    jstep = jrb.build_rigid_gtvf_step(JQuintic(dim=2), jcfg, PARAMS, True)
    tstep = trb.build_rigid_gtvf_step(TQuintic(dim=2), tcfg, PARAMS, True)
    for _ in range(10):
        jscene = jstep(jscene, 1e-4)
        tscene = tstep(tscene, 1e-4)
    assert not bool(jscene.nbr_overflow) and not bool(tscene.nbr_overflow)
    assert float(np.abs(np.asarray(jscene.delta_lt_x)).max()) > 0
    _compare(jscene, tscene, rtol=1e-10)


def test_three_f32_gtvf_steps_match_jax_nklist():
    jscene, dx = _contact_scene_f32()
    tscene = _port(jscene, torch.float32)
    jcfg, tcfg = _configs(jscene)
    jstep = jrb.build_rigid_gtvf_step(JQuintic(dim=2), jcfg, PARAMS, True)
    tstep = trb.build_rigid_gtvf_step(TQuintic(dim=2), tcfg, PARAMS, True)
    dt = np.float32(1e-4)
    for _ in range(3):
        jscene = jstep(jscene, jnp.float32(dt))
        tscene = tstep(tscene, float(dt))
    assert not bool(tscene.nbr_overflow)
    assert tscene.x.dtype == torch.float32
    _compare(jscene, tscene, rtol=1e-5)


def _compare_all(jend, tend, rtol=1e-10):
    names = sorted(set(jend.fields) & set(tend.fields))
    assert {"x", "xcm", "vcm", "omega", "force", "overlap",
            "delta_lt_x"} <= set(names)
    for k in names:
        a, b = np.asarray(jend[k]), tend[k].numpy()
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            _close(a, b, k, rtol)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


def _cubes(make_group):
    """Two small cubes (one group each, so the faces between them are
    surface) 0.9 dx apart and 0.9 dx above a two-layer floor patch: in
    contact from the first step."""
    dx = 0.05
    xb, yb, zb = jgeom.get_3d_block(dx, 0.15, 0.15, 0.15)
    yb = yb - yb.min() + 0.9 * dx
    fx, fz = np.meshgrid(np.arange(-0.15, 0.4, dx), np.arange(-0.15, 0.15, dx))
    kw = dict(m=2000 * dx ** 3, h=1.3 * dx, rho=2000.0, rad_s=dx / 2)
    cubes = [make_group(f"body{b}", xb + b * (0.15 + 0.9 * dx), yb, zb,
                        role="rigid", dem_id=b, **kw) for b in range(2)]
    floor = make_group(
        "floor", np.tile(fx.ravel(), 2), np.repeat([0.0, -dx], fx.size),
        np.tile(fz.ravel(), 2), role="boundary", dem_id=2, **kw)
    return cubes + [floor], dx


@pytest.mark.parametrize("integrator", ("rk2", "leapfrog"))
def test_steppers_match_jax_nklist_f64(integrator):
    three = integrator == "leapfrog"
    if three:
        groups, dx = _cubes(jmake_group)
        cls_j, cls_t = jrb.RigidBody3DScheme, trb.RigidBody3DScheme
        names, dim = (["body0", "body1"], ["floor"]), 3
        vel = [[1.0, -0.5, 0.2], [-1.0, -0.5, 0.0]]
    else:
        from test_torch_rigid_steppers import THROW, _wall_groups
        groups, dx = _wall_groups(jmake_group)
        cls_j, cls_t = jrb.RigidBody2DScheme, trb.RigidBody2DScheme
        names, dim, vel = (["body"], ["wall"]), 2, THROW
    jscene = jbuild_scene(groups, dim=dim, total_no_bodies=3, spacing0=dx)
    jsch = cls_j(*names, dim=dim, gy=-9.81)
    jsch.engine, jsch.integrator = "nklist", integrator
    jscene = jsch.set_linear_velocity(jsch.setup(jscene), vel)
    tscene = _port(jscene)
    tsch = cls_t(*names, dim=dim, gy=-9.81)
    tsch.engine, tsch.integrator = "nklist", integrator
    jstep, tstep = jsch.make_step(jscene), tsch.make_step(tscene)
    assert tsch._nbr_cfg.__dict__ == jsch._nbr_cfg.__dict__
    # the 2D blocks' corners meet within 20 steps
    for _ in range(5 if three else 20):
        jscene = jstep(jscene, jnp.asarray(1e-4))
        tscene = tstep(tscene, 1e-4)
    assert not bool(tscene.nbr_overflow)
    assert float(np.asarray(jscene.overlap).max()) > 0
    _compare_all(jscene, tscene)


def test_evaluate_once_matches_jax():
    jscene, dx = _scene_f64()
    tscene = _port(jscene)

    def jfn(s, nb, k):
        j = nb.idx
        r = jnp.sqrt((s.x[:, None] - s.x[j]) ** 2
                     + (s.y[:, None] - s.y[j]) ** 2)
        w = k.w(r, 0.5 * (s.h[:, None] + s.h[j]))
        return dict(rho=jnp.sum(jnp.where(nb.mask, s.m[j] * w, 0.0), 1))

    def tfn(s, nb, k):
        j = nb.idx
        r = torch.sqrt((s.x[:, None] - s.x[j]) ** 2
                       + (s.y[:, None] - s.y[j]) ** 2)
        w = k.w(r, 0.5 * (s.h[:, None] + s.h[j]))
        return dict(rho=torch.where(nb.mask, s.m[j] * w, 0.0).sum(1))

    for name in ("quintic", "wendland"):
        a = jevaluate_once(jscene, jfn, name)
        b = tevaluate_once(tscene, tfn, name)
        _close(a.rho, b.rho, name)
        assert float(b.rho.min()) > 0
    # a scene may come back instead of a dict
    s = tevaluate_once(tscene, lambda s, nb, k: s.replace(rho=s.rho * 2))
    assert torch.equal(s.rho, tscene.rho * 2)


# ---------------------------------------------------------------------------
# the scheme surface
# ---------------------------------------------------------------------------

def _wall_scene(engine, kernel_name="quintic"):
    from test_torch_rigid_steppers import _wall_groups
    groups, dx = _wall_groups(tmake_group)
    scene = tbuild_scene(groups, dim=2, total_no_bodies=3, spacing0=dx,
                         device=CPU, dtype=torch.float64)
    sch = trb.RigidBody2DScheme(["body"], ["wall"], dim=2, gy=-9.81)
    sch.engine, sch.kernel_name = engine, kernel_name
    return sch, scene


def test_solver_overflow_rebuild_on_the_list(tmp_path):
    def run(out, m=None):
        sch, scene = _wall_scene("nklist")
        scene = sch.set_linear_velocity(sch.setup(scene),
                                        [[1.0, -1.0, 0.0]] * 2)
        if m is not None:
            sch._nbr_cfg = dataclasses.replace(sch._nbr_cfg, max_per_cell=m)
        solver = Solver(sch, scene, 1e-4, 6e-4, pfreq=3, output_dir=out)
        return sch, solver, solver.solve(quiet=True)

    sch, solver, end = run(str(tmp_path / "a"), m=2)
    assert solver.rebuilds_total == 1 and solver.steps_run == 9
    assert sch._nbr_cfg.max_per_cell > 2 and not bool(end.nbr_overflow)
    sch2, solver2, end2 = run(str(tmp_path / "b"))
    assert solver2.rebuilds_total == 0
    assert sch2._nbr_cfg == sch._nbr_cfg
    assert set(end.fields) == set(end2.fields)
    for k in end.fields:
        assert torch.equal(end[k], end2[k]), k


def test_engine_and_kernel_guards():
    # another kernel on the cell engine runs (its hand kernels on the
    # card, their plain versions here)
    sch, scene = _wall_scene("cell", "wendland")
    scene = sch.setup(scene)
    out = sch.make_step(scene)(scene, 1e-4)
    assert torch.isfinite(out.x).all() and not bool(out.nbr_overflow)
    with pytest.raises(ValueError, match="engine"):
        sch.engine = "pallas"
    sch, scene = _wall_scene("nklist", "wendland")
    scene = sch.setup(scene)
    out = sch.make_step(scene)(scene, 1e-4)
    assert torch.isfinite(out.x).all() and not bool(out.nbr_overflow)
