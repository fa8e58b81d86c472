"""Port vs reference past the hand kernels' narrow instances, 3D contact
and the DEM spill grid (see ``tests/test_torch_wide_kernels.py``):

* 3D, f64: K2's plain version (the wide instance's, S > 64) against the
  XLA cell engine on 65 small cubes over a floor slab (S = 66), rtol
  1e-10, as ``tests/test_torch_contact.py``'s 3D case.
* The DEM spill-grid pass at L = 12 table slots (the wide instance on
  the card): the port (on CPU tensors its kernel wrapper runs the plain
  version) against the Pallas spill kernel in interpret mode on a
  crowded grain block (up to 15 gated partners a grain: full tables,
  contacts dropped), over 2 coupled f32 iterations from the empty table,
  as ``tests/test_torch_dem.py``: tables, slot positions and counts
  exact, sums within rtol 2e-5 / atol 2e-3, springs within rtol 1e-4
  (absolute floor 1e-5 of the largest).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.models import DEMScheme as JDEMScheme
from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import contact_cell as jcc
from rigid_body_2d_3d_pysph_tpu.ops import pallas_dem as jpd
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline as JQuintic
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY)

from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import (
    QuinticSpline as TQuintic)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_torch_contact import _assert_blocks
from test_torch_wide_kernels import blocks_scene, cfgs

CPU = torch.device("cpu")
L_WIDE = 12


def test_contact_twin_3d_66_entities_matches_cell_engine_f64():
    scene, dx = blocks_scene(65, 3, dtype=jnp.float64, cols=13)
    S, n = scene.meta.total_no_bodies, scene.n
    assert S == 66 and tck.contact_instance(S)[0] == "wide"
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    jcfg, tcfg = cfgs(fields, dx, 3)

    @jax.jit
    def run(scene):
        grid = jcell.build_cell_grid(scene.x, scene.y, scene.z,
                                     scene.active, jcfg)
        return grid.overflow, jcc.contact_pipeline_cell_fused(
            scene, grid, jcfg, JQuintic(dim=3))

    ovf, (cx, cy, cz, cw, dinfo) = run(scene)
    assert not bool(ovf)
    ref = np.stack([np.asarray(a) for a in (
        cx, cy, cz, cw, dinfo["contact_force_dist"],
        dinfo["closest_point_dist_to_source"], dinfo["x_source"],
        dinfo["y_source"], dinfo["z_source"], dinfo["vx_source"],
        dinfo["vy_source"], dinfo["vz_source"])], 1).reshape(n, 12 * S)
    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float64)
    cc = tck.contact_pipeline_compact(tscene, tcfg, TQuintic(dim=3),
                                      tcfg.NC_max)
    assert not bool(cc.overflow)
    pid = cc.pid.reshape(-1).numpy()
    out = cc.out.reshape(-1, 12 * S).numpy()
    live = pid < n
    got = np.zeros((n, 12 * S))
    got[:, 5 * S:6 * S] = 4.0 * dx
    got[pid[live]] = out[live]
    picked = ref[:, 5 * S:6 * S] < 4.0 * dx
    assert picked[:, 64:].any() and picked.sum() > 100
    _assert_blocks(got, ref, S, rtol_sum=1e-10, exact_picks=False,
                   rtol_pick=1e-10)


def crowded_grains(L=L_WIDE, nx=8, ny=6, seed=3):
    """A 2D block of grains on a lattice of 0.9 radii (up to 15 gated
    partners a grain, more than L table slots) over a floor, set up by
    the reference's DEM scheme with tables of L slots, f32, seeded random
    velocities and spins.  Returns the scene."""
    rng = np.random.default_rng(seed)
    rad = 0.05
    gx, gy = np.meshgrid(np.arange(nx) * 0.9 * rad, np.arange(ny) * 0.9 * rad)
    x = gx.ravel() + rng.uniform(-0.05 * rad, 0.05 * rad, gx.size)
    y = gy.ravel() + 0.9 * rad + rng.uniform(0, 0.05 * rad, gx.size)
    m = 2600.0 * (2 * rad) ** 2
    xf = np.arange(-4, nx + 4) * rad
    grains = make_group("grains", x, y, m=m, h=1.2 * rad, rho=2600.0,
                        rad_s=rad, role=ROLE_RIGID,
                        body_id=np.arange(gx.size, dtype=np.int32), dem_id=0)
    floor = make_group("floor", xf, np.full(len(xf), -0.55 * rad), m=m,
                       h=1.2 * rad, rho=2600.0, rad_s=rad / 2,
                       role=ROLE_BOUNDARY, dem_id=1)
    scene = build_scene([grains, floor], dim=2, total_no_bodies=2,
                        spacing0=2 * rad)
    scheme = JDEMScheme(granular_particles=["grains"], boundaries=["floor"],
                        kn=1e5, en=0.5, gy=-9.81, dim=2,
                        max_tng_contacts_limit=L)
    scene = scheme.setup(scene)
    f32 = jnp.float32
    fields = {k: (v.astype(f32) if hasattr(v, "dtype")
                  and v.dtype in (jnp.float64, jnp.float32) else v)
              for k, v in scene.fields.items()}
    scene = type(scene)(fields, scene.meta)
    return scene.replace(
        u=jnp.asarray(rng.uniform(-0.5, 0.5, scene.n), f32),
        v=jnp.asarray(rng.uniform(-0.5, 0.0, scene.n), f32),
        wz=jnp.asarray(rng.uniform(-2, 2, scene.n), f32))


def check_dem_pass(r, out_j, it):
    """The port's pass ``r`` against the reference's outputs ``out_j``
    (sums, idx, dem, springs, counts)."""
    for i, nm in enumerate(["fx", "fy", "fz", "torx", "tory", "torz"]):
        np.testing.assert_allclose(
            getattr(r, nm).numpy(), np.asarray(out_j[i]), rtol=2e-5,
            atol=2e-3, err_msg=f"iter {it} {nm}")
    eq = np.testing.assert_array_equal
    eq(r.tng_idx.numpy(), np.asarray(out_j[6]), err_msg=f"iter {it}")
    eq(r.tng_dem.numpy(), np.asarray(out_j[7]), err_msg=f"iter {it}")
    eq(r.count.numpy(), np.asarray(out_j[11]), err_msg=f"iter {it}")
    for k, nm in enumerate(["tng_x", "tng_y", "tng_z"]):
        ref = np.asarray(out_j[8 + k])
        np.testing.assert_allclose(
            getattr(r, nm).numpy(), ref, rtol=1e-4,
            atol=max(1e-9, 1e-5 * np.abs(ref).max()),
            err_msg=f"iter {it} {nm}")


def advance(scene, out_j, dt):
    """The reference's state one step on (its sums and tables), so each
    iteration compares one pass on equal inputs while the tables
    evolve."""
    u = scene.u + dt * (out_j[0] / scene.m)
    v = scene.v + dt * (out_j[1] / scene.m - 9.81)
    return scene.replace(
        u=u, v=v, x=scene.x + dt * u, y=scene.y + dt * v,
        tng_idx=out_j[6], tng_idx_dem_id=out_j[7], tng_x=out_j[8],
        tng_y=out_j[9], tng_z=out_j[10])


def test_dem_spill_pass_12_slots_matches_pallas_interpret():
    scene = crowded_grains()
    assert scene.tng_idx.shape[1] == L_WIDE
    assert tdk.table_instance(L_WIDE)[0] == "wide"
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    cutoff = 2.0 * float(fields["rad_s"].max())
    args = (fields["x"], fields["y"], fields["z"], cutoff, 2)
    jcfg = jcell.config_from_positions(*args, cell_chunk=16, cell_factor=2.0)
    tcfg = tcell.config_from_positions(*args, cell_chunk=16, cell_factor=2.0)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    dt = np.float32(1e-5)

    @jax.jit
    def eval_pallas(scene):
        grid = jcell.build_cell_grid(scene.x, scene.y, scene.z,
                                     scene.active, jcfg)
        return grid.overflow, jpd.lvc_displacement_cell_pallas(
            scene, grid, jcfg, jnp.float32(dt), scene.tng_idx,
            scene.tng_idx_dem_id, scene.tng_x, scene.tng_y, scene.tng_z,
            interpret=True)

    launches = dict(_build.LAUNCHES)
    for it in range(2):
        ovf, out_j = eval_pallas(scene)
        tscene = scene_from_numpy({k: np.asarray(v) for k, v in
                                   scene.fields.items()}, scene.meta, CPU,
                                  torch.float32)
        r = tdk.lvc_displacement_cell_kernel(
            tscene, tcfg, float(dt), tscene.tng_idx, tscene.tng_idx_dem_id,
            tscene.tng_x, tscene.tng_y, tscene.tng_z)
        assert not bool(ovf) and not bool(r.overflow)
        # more gated partners than slots: full tables past the 8 of the
        # narrow instance, contacts dropped
        assert int(r.n_gated.max()) > L_WIDE
        assert int(r.count.max()) == L_WIDE
        check_dem_pass(r, out_j, it)
        scene = advance(scene, out_j, dt)
    assert _build.LAUNCHES == launches   # CPU tensors: no kernel launched
