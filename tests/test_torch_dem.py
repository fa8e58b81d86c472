"""Port vs reference: the DEM contact ops and the spill-grid DEM pass.

* ``prune_contact_table`` and ``lvc_displacement_core`` against the JAX
  ones in float64 on the ``tests/test_dem_contact_table.py`` cases and a
  crowded cluster whose 4-slot tables overflow (rtol 1e-12: the same
  operations in the same order).
* The port's spill-grid pass (grid build, pack expansion, the DEM pass;
  on CPU tensors each kernel wrapper runs its plain version) against the
  Pallas spill-grid kernel in interpret mode over 5 coupled f32
  iterations on the ``tests/test_pallas_dem.py`` scene and grid (each
  iteration starts both sides from the reference's state), at the
  default 16 lanes a slot and at 32 and 4 (``csrc/dem.cu``'s
  runtime-width instance on the card; the reference pads a slot to 128
  lanes whatever its M).  The
  candidate order is the same, so table slot positions and live counts
  match exactly; the sums differ by summation order (rtol 2e-5 / atol
  2e-3, as ``tests/test_pallas_dem.py``).  The springs take rtol 1e-4
  with an absolute floor of 1e-5 x the largest spring: XLA:CPU (both
  JAX engines) and PyTorch round the f32 spring update differently
  (operation order, contracted multiply-adds), ~1e-8 absolute on springs
  of ~1e-2, and the projection s - (s.n) n cancels on the small ones.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import dem as jdem
from rigid_body_2d_3d_pysph_tpu.ops import pallas_dem as jpd

from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem as tdem
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_dem_contact_table import _scene as _table_scene
from test_pallas_dem import _grain_scene_f32

CPU = torch.device("cpu")
RTOL = 1e-12


def _cluster_scene():
    """20 grains of 5 entities crowded into a 0.5 box: many overlaps per
    grain, more than a 4-slot table holds."""
    rng = np.random.default_rng(17)
    pts = rng.uniform(0.0, 0.5, (20, 2))
    scheme, scene = _table_scene([tuple(p) for p in pts],
                                 [tuple(v) for v in
                                  rng.uniform(-1, 1, (20, 2))])
    return scene.replace(dem_id=jnp.asarray(np.arange(20) % 5, jnp.int32))


def _cases():
    return [
        _table_scene([(0.0, 0.0), (0.15, 0.0), (5.0, 0.0)],
                     velocities=[(0.1, 0.05), (-0.1, 0.0), (0, 0)])[1],
        _table_scene([(0.0, 0.0), (0.15, 0.0)],
                     velocities=[(0.0, 0.2), (0.0, -0.2)])[1],
        _cluster_scene(),
    ]


def _tables(rng, n, L, dem_id, overlapping):
    """A random table per row: some live partners (overlapping or not,
    with right or wrong dem), some free slots."""
    idx = np.full((n, L), -1, np.int32)
    dem = np.full((n, L), -1, np.int32)
    for i in range(n):
        cands = [j for j in range(n) if j != i]
        rng.shuffle(cands)
        # partners that overlap first, so some survive the prune
        cands.sort(key=lambda j: not overlapping[i, j])
        for l in range(L):
            if cands and (l == 0 or rng.uniform() < 0.6):
                j = cands.pop(0)
                idx[i, l] = j
                dem[i, l] = dem_id[j] if rng.uniform() < 0.9 else 7
    spr = rng.uniform(-1e-3, 1e-3, (3, n, L)) * (idx >= 0)
    return idx, dem, spr


def _pair_inputs(fields):
    """All-pairs [N, N] candidate arrays of the core, from numpy."""
    x, y, z = fields["x"], fields["y"], fields["z"]
    n = len(x)
    j = np.broadcast_to(np.arange(n), (n, n)).copy()
    xij, yij, zij = (a[:, None] - a[j] for a in (x, y, z))
    rij = np.sqrt(xij * xij + yij * yij + zij * zij)
    cand = j != np.arange(n)[:, None]
    keys = ("u", "v", "w", "wx", "wy", "wz", "rad_s", "m")
    q = {("rad" if k == "rad_s" else k): fields[k][:, None] for k in keys}
    s = {("rad" if k == "rad_s" else k): fields[k][j] for k in keys}
    mat = {k: fields[k][fields["dem_id"][j]] for k in
           ("dem_kn", "dem_kt", "dem_alpha", "dem_mu")}
    return q, s, xij, yij, zij, rij, cand, j, fields["dem_id"][j], mat


@pytest.mark.parametrize("case", [0, 1, 2])
def test_prune_and_core_match_reference_f64(case):
    scene = _cases()[case]
    rng = np.random.default_rng(case)
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    n, L = fields["tng_idx"].shape
    ts = scene_from_numpy(fields, scene.meta, CPU, torch.float64)
    q, s, xij, yij, zij, rij, cand, j, dem_j, mat = _pair_inputs(fields)
    overlapping = (q["rad"] + s["rad"] - rij) > 0
    idx, dem, spr = _tables(rng, n, L, fields["dem_id"], overlapping)

    jp = jdem.prune_contact_table(scene, jnp.asarray(idx), jnp.asarray(dem),
                                  *map(jnp.asarray, spr))
    tp = tdem.prune_contact_table(ts, torch.as_tensor(idx),
                                  torch.as_tensor(dem),
                                  *map(torch.as_tensor, spr))
    kept = int(np.asarray(jp[5]).sum())
    assert kept > 0 and (case < 2 or kept < int((idx >= 0).sum()))
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=0)

    dt = 1e-4
    mats = [mat[k] for k in ("dem_kn", "dem_kt", "dem_alpha", "dem_mu")]
    jout = jdem.lvc_displacement_core(
        {k: jnp.asarray(v) for k, v in q.items()},
        {k: jnp.asarray(v) for k, v in s.items()},
        *map(jnp.asarray, (xij, yij, zij, rij, cand, j, dem_j)), dt,
        *map(jnp.asarray, mats), *jp[:5])
    tt = lambda a: torch.as_tensor(np.array(a))
    tout = tdem.lvc_displacement_core(
        {k: tt(v) for k, v in q.items()}, {k: tt(v) for k, v in s.items()},
        *map(tt, (xij, yij, zij, rij, cand, j, dem_j)), dt, *map(tt, mats),
        *tp[:5])
    assert int(np.asarray(jout[11]).sum()) > 0
    for i, (a, b) in enumerate(zip(jout, tout)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=1e-300, err_msg=f"output {i}")
    if case == 2:   # tables overflow: more gated pairs than live slots
        assert (tout[12].numpy() > tout[11].numpy()).any()


@pytest.mark.parametrize("M", [None, 32, 4])
def test_spill_pass_matches_pallas_interpret(M):
    _, scene = _grain_scene_f32()
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float32)
    cutoff = 2.0 * float(fields["rad_s"].max())
    args = (fields["x"], fields["y"], fields["z"], cutoff, 2)
    kw = dict(cell_chunk=16, cell_factor=2.0, M=M, spill=True)
    jcfg = jcell.config_from_positions(*args, **kw)
    tcfg = tcell.config_from_positions(*args, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.spill and tcfg.M == (M or 16)
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
    # 32 lanes: an empty table's pass and a filled one's; 4 lanes: the
    # empty table's (the filled table's pass at 32 lanes runs the same
    # runtime-width instance of csrc/dem.cu on the card)
    for it in range({None: 5, 32: 2, 4: 1}[M]):
        ovf, out_j = eval_pallas(scene)
        r = tdk.lvc_displacement_cell_kernel(
            tscene, tcfg, float(dt), tscene.tng_idx, tscene.tng_idx_dem_id,
            tscene.tng_x, tscene.tng_y, tscene.tng_z)
        assert not bool(ovf) and not bool(r.overflow)
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
        assert int(r.count.sum()) > 0
        # both sides go on from the reference's state, so each iteration
        # compares one pass on equal inputs while the tables evolve
        u = scene.u + dt * (out_j[0] / scene.m)
        v = scene.v + dt * (out_j[1] / scene.m - 9.81)
        scene = scene.replace(
            u=u, v=v, x=scene.x + dt * u, y=scene.y + dt * v,
            tng_idx=out_j[6], tng_idx_dem_id=out_j[7], tng_x=out_j[8],
            tng_y=out_j[9], tng_z=out_j[10])
        tscene = scene_from_numpy({k: np.asarray(v) for k, v in
                                   scene.fields.items()}, scene.meta, CPU,
                                  torch.float32)
    assert _build.LAUNCHES == launches   # CPU tensors: no kernel launched
