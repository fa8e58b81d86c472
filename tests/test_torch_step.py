"""Port vs reference: scheme setup and the 2D GTVF step end to end.

* Setup (float64): normals, boundary flags, body masses, inertia and the
  damping matrix match the reference scheme's setup on the cell engine.
* f32, 3 steps: the port's compact step (on CPU tensors its kernels run
  their plain twins) against the reference GTVF sequence around
  ``rigid_contact_force_eval_compact`` with the Pallas kernels in
  interpret mode.  Tolerance rtol 1e-5, atol 1e-5 x max(|field|, 1):
  the two sides sum the contact and body forces in different orders.
* f64, 10 steps: the port against the reference's jitted cell-engine
  step (XLA fused contact pipeline), rtol 1e-10.
* The port imports and takes a rigid step, a DEM step and a coupling
  step in a process where ``jax`` cannot load.

The scene is two touching bodies resting just above a wall with random
particle velocities, so contacts are real and the tangential springs
evolve (and carry over through the compact store) from step to step.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu import geom as jgeom
from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline as JQuintic
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)
from rigid_body_2d_3d_pysph_tpu.state import rigid_setup as jrs

from rigid_body_2d_3d_pysph_tpu_torch import geom as tgeom
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import (
    QuinticSpline as TQuintic)
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group as tmake_group, build_scene as tbuild_scene)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_compact_contact import CHECK, PARAMS, _mini_step
from test_compact_contact import _scene_f32 as _contact_scene_f32

CPU = torch.device("cpu")
TRAJ = ("x", "y", "u", "v", "xcm", "vcm", "omega")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_like_groups(make_group, geom):
    """Two bodies over a 3-layer tank (the small scene of the graft
    entry point)."""
    dx = 0.2 / 5
    xb1, yb1 = geom.get_2d_block(dx, 0.2, 0.2)
    xb = np.concatenate([xb1, xb1 + 0.25])
    yb = np.concatenate([yb1, yb1]) + 0.5
    bid = np.repeat(np.arange(2, dtype=np.int32), len(xb1))
    _, _, xt, yt = geom.hydrostatic_tank_2d(1.0, 1.0, 1.0, 3, dx, dx)
    m = 2000.0 * dx * dx
    body = make_group("body", xb, yb, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role="rigid", body_id=bid, dem_id=bid)
    tank = make_group("tank", xt, yt, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role="boundary", dem_id=2)
    return [body, tank], dx


def test_setup_matches_reference_f64():
    jgroups, dx = _bench_like_groups(jmake_group, jgeom)
    tgroups, _ = _bench_like_groups(tmake_group, tgeom)
    for a, b in zip(jgroups, tgroups):
        for k in ("x", "y", "z", "m", "h", "rho"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))

    # restitution below 1, so the damping matrix eta is not all zero
    coeff = np.random.default_rng(5).uniform(0.3, 0.9, (2, 3))
    jscene = jbuild_scene(jgroups, dim=2, total_no_bodies=3, spacing0=dx)
    jsch = jrb.RigidBody2DScheme(["body"], ["tank"], dim=2, gy=-9.81)
    jsch.engine = "cell"
    jscene = jsch.setup(jscene, coeff_of_rest=coeff)

    tscene = tbuild_scene(tgroups, dim=2, total_no_bodies=3, spacing0=dx,
                          device=CPU, dtype=torch.float64)
    tsch = trb.RigidBody2DScheme(["body"], ["tank"], dim=2, gy=-9.81)
    tscene = tsch.setup(tscene, coeff_of_rest=coeff)
    assert np.abs(tscene.eta.numpy()).max() > 0

    assert int(np.asarray(jscene.is_boundary).sum()) > 0
    np.testing.assert_array_equal(tscene.is_boundary.numpy(),
                                  np.asarray(jscene.is_boundary))
    np.testing.assert_array_equal(tscene.contact_force_is_boundary.numpy(),
                                  np.asarray(jscene.contact_force_is_boundary))
    np.testing.assert_allclose(tscene.normal.numpy(),
                               np.asarray(jscene.normal), rtol=1e-12,
                               atol=1e-12)
    for k in ("total_mass", "xcm", "izz", "inertia_tensor_body_frame",
              "inertia_tensor_inverse_body_frame", "eta", "dx0", "dy0"):
        np.testing.assert_allclose(tscene[k].numpy(), np.asarray(jscene[k]),
                                   rtol=1e-14, atol=1e-14, err_msg=k)
    # a virgin scene's compact store is empty
    assert (tscene.cl_pid.numpy() == tscene.n).all()
    cfg = tsch.cell_config(tscene, TQuintic(dim=2))
    assert tscene.cl_pid.shape[0] == tsch.ni_max(cfg) * cfg.M


def _compare(j, t, rtol):
    assert float(np.abs(np.asarray(j.overlap)).max()) > 0   # nonvacuous
    for name in CHECK + TRAJ:
        a = np.asarray(j.fields[name])
        b = t.fields[name].numpy()
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                                   err_msg=name)


def test_three_f32_steps_match_compact_pallas_interpret():
    jscene, dx = _contact_scene_f32()
    kernel = JQuintic(dim=2)
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    args = (fields["x"], fields["y"], fields["z"], 3 * 1.3 * dx, 2)
    jcfg = jcell.config_from_positions(*args, cell_chunk=16)
    tcfg = tcell.config_from_positions(*args, cell_chunk=16)
    ni = jcfg.NC_max
    dt = np.float32(1e-4)

    tscene = trb.compact_slot_scene(
        scene_from_numpy(fields, jscene.meta, CPU, torch.float32),
        ni * tcfg.M)
    jscene = jrb.compact_slot_scene(jscene, ni * jcfg.M)
    # one compile of the interpret-mode evaluation serves all three steps
    ev = jax.jit(lambda s: jrb.rigid_contact_force_eval_compact(
        s, jcfg, kernel, PARAMS, jnp.float32(dt), ni, interpret=True))
    step = trb.build_rigid_gtvf_step_cell(TQuintic(dim=2), tcfg, PARAMS,
                                          True, ni_max=ni)
    for _ in range(3):
        jscene, ovf = _mini_step(jscene, jcfg, kernel, jnp.float32(dt), ev)
        tscene = step(tscene, float(dt))
        assert not bool(ovf) and not bool(tscene.nbr_overflow)
        assert int(tscene.n_interesting) > 0
    _compare(jrb.expand_slot_scene(jscene), trb.expand_slot_scene(tscene),
             rtol=1e-5)


def _scene_f64():
    """The f32 contact scene's geometry and velocities in float64."""
    dx = 0.05
    xb, yb = jgeom.get_2d_block(dx, 0.2, 0.2)
    x = np.concatenate([xb, xb + 0.2 + 0.6 * dx])
    y = np.concatenate([yb, yb])
    bid = np.repeat(np.arange(2, dtype=np.int32), len(xb))
    xw = np.arange(-10, 20) * dx
    yw = np.full(len(xw), yb.min() - 0.7 * dx)
    body = jmake_group("body", x, y, m=2000 * dx * dx, h=1.3 * dx,
                       rho=2000.0, rad_s=dx / 2, role="rigid",
                       body_id=bid, dem_id=bid)
    wall = jmake_group("wall", xw, yw, m=2000 * dx * dx, h=1.3 * dx,
                       rho=2000.0, rad_s=dx / 2, role="boundary", dem_id=2)
    scene = jbuild_scene([body, wall], dim=2, total_no_bodies=3,
                         spacing0=dx)
    scene = jrb._attach_contact_fields(jrs.setup_body_state(scene))
    rng = np.random.default_rng(11)
    n = scene.n
    scene = scene.replace(
        contact_force_is_boundary=jnp.ones(n),
        u=jnp.asarray(rng.uniform(-1, 1, n)),
        v=jnp.asarray(rng.uniform(-1, 1, n)),
        vcm=jnp.asarray([[0.1, -0.2, 0.0], [-0.1, 0.1, 0.0]]))
    return scene, dx


def test_ten_f64_steps_match_cell_engine():
    jscene, dx = _scene_f64()
    assert jscene.x.dtype == jnp.float64
    kernel = JQuintic(dim=2)
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    args = (fields["x"], fields["y"], fields["z"], 3 * 1.3 * dx, 2)
    jcfg = jcell.config_from_positions(*args, cell_chunk=16)
    tcfg = tcell.config_from_positions(*args, cell_chunk=16)
    ni = tcfg.NC_max
    dt = 1e-4

    jstep = jrb.build_rigid_gtvf_step_cell(kernel, jcfg, PARAMS, True)
    tstep = trb.build_rigid_gtvf_step_cell(TQuintic(dim=2), tcfg, PARAMS,
                                           True, ni_max=ni)
    tscene = trb.compact_slot_scene(
        scene_from_numpy(fields, jscene.meta, CPU, torch.float64),
        ni * tcfg.M)
    for _ in range(10):
        jscene = jstep(jscene, dt)
        tscene = tstep(tscene, dt)
    assert not bool(jscene.nbr_overflow) and not bool(tscene.nbr_overflow)
    _compare(jscene, trb.expand_slot_scene(tscene), rtol=1e-10)


_NO_JAX = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
import numpy as np, torch
from rigid_body_2d_3d_pysph_tpu_torch.geom import get_2d_block
from rigid_body_2d_3d_pysph_tpu_torch.models import RigidBody2DScheme
from rigid_body_2d_3d_pysph_tpu_torch.state import make_group, build_scene
dx = 0.05
xb, yb = get_2d_block(dx, 0.2, 0.2)
x = np.concatenate([xb, xb + 0.2 + 0.6 * dx]); y = np.concatenate([yb, yb])
bid = np.repeat(np.arange(2, dtype=np.int32), len(xb))
xw = np.arange(-10, 20) * dx; yw = np.full(len(xw), yb.min() - 0.7 * dx)
kw = dict(m=2000 * dx * dx, h=1.3 * dx, rho=2000.0, rad_s=dx / 2)
body = make_group("body", x, y, role="rigid", body_id=bid, dem_id=bid, **kw)
wall = make_group("wall", xw, yw, role="boundary", dem_id=2, **kw)
scene = build_scene([body, wall], dim=2, total_no_bodies=3, spacing0=dx,
                    device=torch.device("cpu"), dtype=torch.float32)
scheme = RigidBody2DScheme(["body"], ["wall"], dim=2, gy=-9.81)
scene = scheme.setup(scene)
scene = scheme.make_step(scene)(scene, 1e-4)
assert torch.isfinite(scene.x).all() and not bool(scene.nbr_overflow)
from rigid_body_2d_3d_pysph_tpu_torch.models.dem import DEMScheme
r = 1e-3
xg, yg = get_2d_block(1.99 * r, 0.02, 0.01)
grains = make_group("sand", xg, yg - yg.min() + r, m=1e-5, h=2 * r,
                    rho=2600.0, rad_s=r, role="rigid", dem_id=0)
xf = np.arange(-0.01, 0.03, 2 * r)
floor = make_group("floor", xf, np.full(len(xf), -r), m=1e-5, h=2 * r,
                   rho=2600.0, rad_s=r, role="boundary", dem_id=1)
dem = build_scene([grains, floor], dim=2, total_no_bodies=2, spacing0=2 * r,
                  device=torch.device("cpu"), dtype=torch.float32)
dscheme = DEMScheme(["sand"], ["floor"], gy=-9.81, max_tng_contacts_limit=8)
dem = dscheme.setup(dem)
dem = dscheme.make_step(dem)(dem, 5e-6)
assert torch.isfinite(dem.fy).all() and not bool(dem.nbr_overflow)
assert int(dem.total_tng_contacts.sum()) > 0
from rigid_body_2d_3d_pysph_tpu_torch.geom import hydrostatic_tank_2d
from rigid_body_2d_3d_pysph_tpu_torch.models import RigidFluidCouplingScheme
dx = 0.1
xf, yf, xt, yt = hydrostatic_tank_2d(0.6, 0.5, 0.8, 3, dx, dx)
xb, yb = get_2d_block(dx, 0.2, 0.1)
xb += xf.mean(); yb += yf.max() - yb.min() - 0.05
keep = ~((xf > xb.min() - dx) & (xf < xb.max() + dx) & (yf > yb.min() - dx))
fkw = dict(m=dx * dx, h=dx, rho=1.0)
cpl = build_scene(
    [make_group("fluid", xf[keep], yf[keep], role="fluid",
                p=yf.max() - yf[keep], **fkw),
     make_group("tank", xt, yt, role="boundary", dem_id=1, **fkw),
     make_group("body", xb, yb, m=2 * dx * dx, h=dx, rho=2.0, role="rigid",
                body_id=0, dem_id=0)],
    dim=2, total_no_bodies=2, spacing0=dx, device=torch.device("cpu"),
    dtype=torch.float32)
cscheme = RigidFluidCouplingScheme(["fluid"], ["tank"], ["body"], dim=2,
                                   rho0=1.0, p0=100.0, c0=10.0, h=dx, nu=0.0,
                                   gy=-1.0)
cpl = cscheme.setup(cpl)
rb = cpl.is_rigid           # the displaced-fluid shadow of the body
cpl = cpl.replace(m_fsi=torch.where(rb, dx * dx, cpl.m_fsi),
                  rho_fsi=torch.where(rb, 1.0, cpl.rho_fsi))
cpl = cscheme.make_step(cpl)(cpl, 1e-4)
assert torch.isfinite(cpl.rho).all() and torch.isfinite(cpl.force).all()
assert not bool(cpl.nbr_overflow) and float(cpl.fx.abs().max()) > 0
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
