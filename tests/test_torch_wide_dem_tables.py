"""Port vs reference: the spill-grid DEM pass on a wide contact table.

The port's spill-grid pass (grid build, pack expansion, the DEM pass; on
CPU tensors each kernel wrapper runs its plain version, the wide
instance's counterpart on the card) against the reference package's XLA
cell-engine pass (``prune_contact_table`` then ``ops/dem_cell.py``
``lvc_displacement_cell`` on the same grid configuration, so the
candidates come in the same order) in float64 over 3 passes, at L = 40
table slots: the grains' rows hold their partners scattered over the
slots, past slot 32 and with free slots between live ones, one row is
full (its partners and stale ones that no longer touch), and the grains
move between passes so that contacts open and close and freed slots are
taken again.  Tables and live counts equal; the gated counts equal an
all-pairs count; sums and springs within rtol 1e-10 (the same
operations in another framework).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.models import DEMScheme as JDEMScheme
from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import dem as jdem
from rigid_body_2d_3d_pysph_tpu.ops import dem_cell as jdc
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY)

from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

CPU = torch.device("cpu")
L = 40
RAD = 0.05
RTOL = 1e-10


def _grains(seed=5, nx=9, ny=6):
    """A 2D hexagonal block of grains 1.6 radii apart (up to 6 touching
    partners a grain, and the floor) over a floor, f64, with seeded
    velocities and spins, set up by the reference's DEM scheme with
    tables of L slots."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(nx) * 1.6 * RAD,
                         np.arange(ny) * 1.6 * RAD * np.sqrt(0.75))
    gx = gx + 0.8 * RAD * (np.arange(ny)[:, None] % 2)
    x = gx.ravel() + rng.uniform(-0.1 * RAD, 0.1 * RAD, gx.size)
    y = gy.ravel() + 0.9 * RAD + rng.uniform(0, 0.1 * RAD, gx.size)
    m = 2600.0 * (2 * RAD) ** 2
    xf = np.arange(-4, 2 * nx + 4) * RAD * 0.8
    grains = make_group("grains", x, y, m=m, h=1.2 * RAD, rho=2600.0,
                        rad_s=RAD, role=ROLE_RIGID,
                        body_id=np.arange(gx.size, dtype=np.int32), dem_id=0)
    floor = make_group("floor", xf, np.full(len(xf), -0.5 * RAD), m=m,
                       h=1.2 * RAD, rho=2600.0, rad_s=RAD / 2,
                       role=ROLE_BOUNDARY, dem_id=1)
    scene = build_scene([grains, floor], dim=2, total_no_bodies=2,
                        spacing0=2 * RAD)
    scheme = JDEMScheme(granular_particles=["grains"], boundaries=["floor"],
                        kn=1e5, en=0.5, gy=-9.81, dim=2,
                        max_tng_contacts_limit=L)
    scene = scheme.setup(scene)
    assert scene.x.dtype == jnp.float64
    f64 = lambda a: jnp.asarray(a, jnp.float64)
    return scene.replace(u=f64(rng.uniform(-0.5, 0.5, scene.n)),
                         v=f64(rng.uniform(-0.5, 0.0, scene.n)),
                         wz=f64(rng.uniform(-2, 2, scene.n)))


def _touching(f):
    """[n, n] pairs that pass the pass's gate (j != i, r > 0, overlap >
    0; every touching pair is inside the cutoff 2 max(rad))."""
    d = [f[k][:, None] - f[k][None, :] for k in ("x", "y", "z")]
    r = np.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    rad = f["rad_s"]
    act = f["active"].astype(bool)
    gate = (r > 0) & (rad[:, None] + rad[None, :] - r > 0)
    return gate & act[:, None] & act[None, :] & ~np.eye(len(r), dtype=bool)


def _wide_tables(f, rng):
    """Each grain's touching partners at random slots over all L (holes
    between them, slots past 32 used), one in five left out (a new
    contact); the first grain's row full: its partners and stale ones
    that do not touch it; random springs on live slots."""
    n = len(f["x"])
    touch = _touching(f)
    grains = np.flatnonzero(f["dem_id"] == 0)
    idx = np.full((n, L), -1, np.int32)
    dem = np.full((n, L), -1, np.int32)
    for i in grains:
        part = np.flatnonzero(touch[i])
        part = part[rng.uniform(size=len(part)) < 0.8]
        if i == grains[0]:
            stale = [j for j in range(n) if j != i and not touch[i, j]]
            part = np.concatenate([part, rng.choice(stale, L - len(part),
                                                    replace=False)])
        slots = rng.choice(L, len(part), replace=False)
        idx[i, slots] = part
        dem[i, slots] = f["dem_id"][part]
    spr = rng.uniform(-1e-4, 1e-4, (3, n, L)) * (idx >= 0)
    return idx, dem, spr


def test_wide_table_spill_pass_matches_xla_cell_engine_f64():
    rng = np.random.default_rng(7)
    scene = _grains()
    f = {k: np.asarray(v) for k, v in scene.fields.items()}
    idx, dem, spr = _wide_tables(f, rng)
    live = idx >= 0
    assert live[:, 32:].any() and live.all(1).any()
    assert (~live[:, :-1] & live[:, 1:]).any()       # holes before a live slot
    scene = scene.replace(tng_idx=jnp.asarray(idx),
                          tng_idx_dem_id=jnp.asarray(dem),
                          tng_x=jnp.asarray(spr[0]), tng_y=jnp.asarray(spr[1]),
                          tng_z=jnp.asarray(spr[2]))
    cutoff = 2.0 * float(f["rad_s"].max())
    args = (f["x"], f["y"], f["z"], cutoff, 2)
    jcfg = jcell.config_from_positions(*args, cell_chunk=16, cell_factor=2.0)
    tcfg = tcell.config_from_positions(*args, cell_chunk=16, cell_factor=2.0)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    dt = 1e-5

    @jax.jit
    def xla_pass(scene):
        tabs = jdem.prune_contact_table(
            scene, scene.tng_idx, scene.tng_idx_dem_id, scene.tng_x,
            scene.tng_y, scene.tng_z)[:5]
        grid = jcell.build_cell_grid(scene.x, scene.y, scene.z,
                                     scene.active, jcfg)
        return grid.overflow, jdc.lvc_displacement_cell(scene, grid, jcfg,
                                                        dt, *tabs)

    launches = dict(_build.LAUNCHES)
    freed = taken = 0
    for it in range(3):
        f = {k: np.asarray(v) for k, v in scene.fields.items()}
        ovf, out_j = xla_pass(scene)
        ts = scene_from_numpy(f, scene.meta, CPU, torch.float64)
        r = tdk.lvc_displacement_cell_kernel(
            ts, tcfg, dt, ts.tng_idx, ts.tng_idx_dem_id, ts.tng_x, ts.tng_y,
            ts.tng_z)
        assert not bool(ovf) and not bool(r.overflow)
        eq = np.testing.assert_array_equal
        eq(r.tng_idx.numpy(), np.asarray(out_j[6]), err_msg=f"pass {it}")
        eq(r.tng_dem.numpy(), np.asarray(out_j[7]), err_msg=f"pass {it}")
        eq(r.count.numpy(), np.asarray(out_j[11]), err_msg=f"pass {it}")
        eq(r.n_gated.numpy(), _touching(f).sum(1), err_msg=f"pass {it}")
        for i, nm in enumerate(["fx", "fy", "fz", "torx", "tory", "torz",
                                "tng_x", "tng_y", "tng_z"]):
            ref = np.asarray(out_j[i if i < 6 else i + 2])
            np.testing.assert_allclose(getattr(r, nm).numpy(), ref,
                                       rtol=RTOL, atol=0,
                                       err_msg=f"pass {it} {nm}")
        new_idx = np.asarray(out_j[6])
        changed = (new_idx != f["tng_idx"]) | (
            np.asarray(out_j[7]) != f["tng_idx_dem_id"])
        freed += int((changed & (f["tng_idx"] >= 0)).sum())
        taken += int((changed & (f["tng_idx"] >= 0) & (new_idx >= 0)).sum())
        assert int(r.count.sum()) > 0 and (new_idx[:, 32:] >= 0).any()
        # the grains move by up to 0.3 radii a pass: contacts open and
        # close
        mv = lambda a: jnp.asarray(
            np.asarray(a) + rng.uniform(-0.3 * RAD, 0.3 * RAD, a.shape))
        scene = scene.replace(
            x=mv(scene.x), y=mv(scene.y), tng_idx=out_j[6],
            tng_idx_dem_id=out_j[7], tng_x=out_j[8], tng_y=out_j[9],
            tng_z=out_j[10])
    assert freed > 20 and taken > 5
    assert _build.LAUNCHES == launches   # CPU tensors: no kernel launched
