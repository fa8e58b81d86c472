"""Port vs reference: the rigid and coupling steps on the classic cell
grid (a classic config set as the scheme's ``_cell_cfg`` before
``setup``), end to end in float64.

* The rigid scheme's set-up on a classic ``sub = 2`` grid (surface
  identification on that grid, the full ``[N, S]`` schema, no compact
  store) equals the reference's field for field.
* GTVF, 20 steps in 2D on that grid (two blocks over a wall thrown at
  each other, ``test_torch_rigid_steppers``' scene) and 12 steps in 3D
  on the ``sub = 2`` grid (two cubes thrown at each other; M 16, O 125),
  and
  RK2 in 2D, 20 steps on the classic ``spill=False`` grid, against the
  JAX ``make_step`` on its XLA cell engine with the same ``_cell_cfg``
  (its full route: the sorted and compact routes need the spill grid),
  rtol 1e-10; the contacts engage and the springs evolve.
* The coupling's kdk and kdkf orderings, 10 steps each with the box
  sliding on the tank floor, on the classic grid of the coupling's lane
  rule (``occupancy_safety=2.6``), against the JAX ``_make_step_cell``
  (kdk) and the XLA branch of ``_make_step_cell_kdkf``, rtol 1e-9
  (``test_torch_coupling_orderings``' tolerance).

Both sides start from one state carried across with
``state.convert.scene_from_numpy``; atol is rtol x max(|field|, 1).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu import geom as jgeom
from rigid_body_2d_3d_pysph_tpu.geom import get_3d_block
from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.models.rigid_fluid_coupling import (
    RigidFluidCouplingScheme as JRFC)
from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group as tmake_group, build_scene as tbuild_scene)

from test_torch_coupling_step import (
    BODY, DT_CONTACT, FLUID, SLOTS, _compare, _run_reference,
    _shadow_fields, _velocities, coupling_scene)
from test_torch_coupling_orderings import SLIDE, _assert_in_contact, _port_run
from test_torch_rigid_steppers import (
    CPU, _compare_all, _port_twin, _wall_groups)

DT = 1e-4
# the wall scene's blocks closing at 16 m/s: in contact from ~13 steps on
THROW = [[8.0, -1.0, 0.0], [-8.0, 1.0, 0.0]]


def _classic(scene, cutoff, dim, **kw):
    host = lambda k: np.asarray(scene[k])
    cfg = jcell.config_from_positions(host("x"), host("y"), host("z"),
                                      cutoff, dim, cell_chunk=8, **kw)
    assert not cfg.spill
    return cfg


def _run(jsch, jscene, tsch, tscene, n_steps):
    jstep = jsch.make_step(jscene)
    tstep = tsch.make_step(tscene)
    for _ in range(n_steps):
        jscene = jstep(jscene, jnp.asarray(DT))
        tscene = tstep(tscene, DT)
    assert not bool(jscene.nbr_overflow) and not bool(tscene.nbr_overflow)
    assert float(np.asarray(jscene.overlap).max()) > 0
    assert float(np.abs(np.asarray(jscene.delta_lt_x)).max()) > 0
    return jscene, tscene


def _wall_pair(integrator, **grid_kw):
    """The reference's set-up scene on a classic grid, thrown, and its
    port twin."""
    jgroups, dx = _wall_groups(jmake_group)
    jscene = jbuild_scene(jgroups, dim=2, total_no_bodies=3, spacing0=dx)
    jsch = jrb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    jsch.engine = "cell"
    jsch.integrator = integrator
    jsch._cell_cfg = _classic(jscene, 3 * 1.3 * dx, 2, **grid_kw)
    jscene = jsch.setup(jscene)
    return jsch, jscene, dx


def test_gtvf_2d_sub2_setup_and_steps_match_reference_f64():
    jsch, jscene, dx = _wall_pair("gtvf", sub=2)
    assert jsch._cell_cfg.O == 25
    # the port's set-up on the same classic grid: the full schema
    tgroups, _ = _wall_groups(tmake_group)
    tset = tbuild_scene(tgroups, dim=2, total_no_bodies=3, spacing0=dx,
                        device=CPU, dtype=torch.float64)
    tsch0 = trb.RigidBody2DScheme(["body"], ["wall"], gy=-9.81, dim=2)
    tsch0._cell_cfg = tcell.CellGridConfig(
        **dataclasses.asdict(jsch._cell_cfg))
    tset = tsch0.setup(tset)
    assert "cl_pid" not in tset and set(tset.fields) == set(jscene.fields)
    assert int(np.asarray(jscene.is_boundary).sum()) > 0
    _compare_all(jscene, tset)

    jscene = jsch.set_linear_velocity(jscene, THROW)
    tsch, tscene = _port_twin(jsch, jscene, trb.RigidBody2DScheme)
    _compare_all(*_run(jsch, jscene, tsch, tscene, 20))


def test_rk2_2d_classic_steps_match_reference_f64():
    jsch, jscene, _ = _wall_pair("rk2", spill=False)
    jscene = jsch.set_linear_velocity(jscene, THROW)
    tsch, tscene = _port_twin(jsch, jscene, trb.RigidBody2DScheme)
    _compare_all(*_run(jsch, jscene, tsch, tscene, 20))


def test_gtvf_3d_sub2_matches_reference_f64():
    """Two cubes of 4^3 lattice sites 1.05 dx apart, thrown at each
    other, on the 3D ``sub = 2`` grid (M = 16, O = 125)."""
    dx = 0.04
    xb, yb, zb = get_3d_block(dx, 0.12, 0.12, 0.12)
    gap = xb.max() - xb.min() + 1.05 * dx
    x = np.concatenate([xb, xb + gap])
    y, z = np.concatenate([yb, yb]), np.concatenate([zb, zb])
    bid = np.repeat(np.arange(2, dtype=np.int32), len(xb))
    body = jmake_group("body", x, y, z, m=2000 * dx ** 3, h=1.3 * dx,
                       rho=2000.0, rad_s=dx / 2, role="rigid", body_id=bid,
                       dem_id=bid)
    jscene = jbuild_scene([body], dim=3, total_no_bodies=2, spacing0=dx)
    jsch = jrb.RigidBody3DScheme(["body"], [], dim=3)
    jsch.engine = "cell"
    jsch._cell_cfg = _classic(jscene, 3 * 1.3 * dx, 3, sub=2)
    assert jsch._cell_cfg.O == 125
    jscene = jsch.setup(jscene)
    jscene = jsch.set_linear_velocity(jscene, [[8.0, 0.5, 0.2],
                                               [-8.0, -0.5, 0.0]])
    tsch, tscene = _port_twin(jsch, jscene, trb.RigidBody3DScheme)
    _compare_all(*_run(jsch, jscene, tsch, tscene, 12))


def _coupling_classic_matches_xla(ordering):
    """10 f64 steps of ``ordering`` with the box sliding on the tank
    floor, on the classic grid of the coupling's lane rule, against the
    JAX XLA step of that ordering."""
    jsch, jscene, dx, rho0 = coupling_scene(jmake_group, jbuild_scene,
                                            jgeom, JRFC, True, floor=True)
    jsch.engine = "cell"
    jsch.gtvf_ordering = ordering
    h = float(np.asarray(jscene.h).max())
    jsch._cell_cfg = _classic(jscene, 3.0 * h, 2, occupancy_safety=2.6,
                              spill=False)
    assert jsch._cell_cfg.M > 16
    jscene = jsch.setup(jscene)
    m_fsi, rho_fsi = _shadow_fields(jscene, rho0, dx)
    jscene = jscene.replace(m_fsi=jnp.asarray(m_fsi),
                            rho_fsi=jnp.asarray(rho_fsi))
    jscene = _velocities(jscene, 7, 0.05).replace(vcm=jnp.asarray(SLIDE))
    start, jend = _run_reference(jsch, jscene, 10, DT_CONTACT)
    tend = _port_run(jsch, start, 10, DT_CONTACT)
    _assert_in_contact(jend)
    assert float(np.abs(np.asarray(jend.fx)).max()) > 0   # FSI is on
    _compare(jend, tend, FLUID + BODY + SLOTS, rtol=1e-9)


def test_kdk_coupling_classic_matches_xla_f64():
    _coupling_classic_matches_xla("kdk")


def test_kdkf_coupling_classic_matches_xla_f64():
    """The fused kdkf step on the classic grid: the port gathers its pack
    through ``slot2p`` and runs B4 and B5 (contact columns by particle)
    where the JAX XLA branch runs the split passes and the contact
    pipeline; the sums differ in order only."""
    _coupling_classic_matches_xla("kdkf")

