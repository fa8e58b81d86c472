"""Port vs reference: the interest cull, the contact sums and the Eq.-24
force core.

* The cull keeps exactly the reference's interesting slots.
* 2D, f32: the port's compact pipeline (on CPU tensors it runs the
  plain twin of the CUDA contact kernel) against the Pallas pipeline in
  interpret mode.  Pick columns (closest distance, picked x/y/z/u/v/w)
  must be equal: they are a minimum and copies of source values, and
  both sides compute the pair distance with the same f32 operations.
  Sum-derived columns (cfn, wij sum, distance) differ only by summation
  order: rtol 1e-5, with an absolute floor of 1e-5 of the column's
  largest magnitude for components that cancel to ~0.
* 3D, f64: the twin against the XLA cell engine (the 3D interpret run is
  a slow test on the reference side), rtol 1e-10.
* ``contact_force_core`` in f64, rtol 1e-12.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import contact as jcontact
from rigid_body_2d_3d_pysph_tpu.ops import contact_cell as jcc
from rigid_body_2d_3d_pysph_tpu.ops import pallas_contact as jpc
from rigid_body_2d_3d_pysph_tpu.ops import pallas_pack as jpack
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline as JQuintic

from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact as tcontact
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import (
    QuinticSpline as TQuintic)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_pallas_contact import _scene_f32, _scene_3d_f32

CPU = torch.device("cpu")
PICK_BLOCKS = range(5, 12)      # closest distance + 6 picked fields
SUM_BLOCKS = range(0, 5)        # cfn x/y/z, wij sum, contact distance


def _cfgs(fields, dx, dim):
    args = (fields["x"], fields["y"], fields["z"], 3 * 1.3 * dx, dim)
    return (jcell.config_from_positions(*args, cell_chunk=16),
            tcell.config_from_positions(*args, cell_chunk=16))


def _f32_pair():
    scene, dx = _scene_f32()
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    jcfg, tcfg = _cfgs(fields, dx, 2)
    return scene, scene_from_numpy(fields, scene.meta, CPU, torch.float32), \
        jcfg, tcfg


def test_cull_matches_reference():
    scene, tscene, jcfg, tcfg = _f32_pair()

    @jax.jit
    def run(scene):
        grid, pt = jcell.build_cell_grid_packed(
            scene.x, scene.y, scene.z, scene.active, jcfg,
            jpc.contact_payload(scene, True))
        dfT = jpack.expand_dft_pallas(pt, grid.n_occupied, jcfg,
                                      jpc.sent_fields(True), interpret=True)
        return jpc._cull_interesting_slots(dfT, pt.slot_cid, jcfg)

    j_int, j_isl = run(scene)
    _, tpt = tcell.build_cell_grid_packed(
        tscene.x, tscene.y, tscene.z, tscene.active, tcfg,
        tck.contact_payload(tscene, True))
    dfT = tck.expand_slots(tpt.sorted_fields, tpt.base, tpt.cnt,
                           torch.tensor(tck.sent_fields(True)), tcfg.M)
    t_int, t_isl = tck.cull_interesting_slots(dfT, tpt.slot_cid, tcfg)
    assert int(t_int.sum()) > 0
    np.testing.assert_array_equal(t_int.numpy(), np.asarray(j_int))
    np.testing.assert_array_equal(t_isl.numpy(), np.asarray(j_isl))


def _assert_blocks(got, ref, S, rtol_sum, exact_picks, rtol_pick=0.0):
    for c in range(12):
        a = got[..., c * S:(c + 1) * S]
        b = ref[..., c * S:(c + 1) * S]
        if c in PICK_BLOCKS and exact_picks:
            np.testing.assert_array_equal(a, b, err_msg=f"block {c}")
        else:
            rtol = rtol_sum if c in SUM_BLOCKS else rtol_pick
            scale = max(np.abs(b).max(), 1e-30)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                                       err_msg=f"block {c}")


def test_compact_pipeline_2d_matches_pallas_interpret():
    scene, tscene, jcfg, tcfg = _f32_pair()
    S = scene.meta.total_no_bodies
    ni = jcfg.NC_max
    kernel = JQuintic(dim=2)
    out_j, pid_j, uvw_j, grid_j, ovf_j = jax.jit(
        lambda s: jpc.contact_pipeline_compact_pallas(
            s, jcfg, kernel, ni, interpret=True))(scene)
    cc = tck.contact_pipeline_compact(tscene, tcfg, TQuintic(dim=2), ni)
    assert not bool(ovf_j) and not bool(cc.overflow)
    n_int = int(cc.n_interesting)
    assert n_int > 0
    # rows past n_int are never written by the Pallas kernel
    out_j = np.asarray(out_j)[:n_int, :, :12 * S]
    out_t = cc.out.numpy()[:n_int]
    pid_t = cc.pid.numpy()[:n_int]
    np.testing.assert_array_equal(pid_t, np.asarray(pid_j)[:n_int])
    for a, b in zip((cc.u, cc.v, cc.w), uvw_j):
        np.testing.assert_array_equal(a.numpy()[:n_int],
                                      np.asarray(b)[:n_int])
    live = pid_t < scene.n
    assert (out_t[live][:, 5 * S:6 * S] < 4.0 * scene.meta.spacing0).any()
    _assert_blocks(out_t[live], out_j[live], S, rtol_sum=1e-5,
                   exact_picks=True)
    # padding rows hold the init row
    init = np.zeros(12 * S, np.float32)
    init[5 * S:6 * S] = np.float32(4.0 * scene.meta.spacing0)
    np.testing.assert_array_equal(
        cc.out.numpy()[n_int:],
        np.broadcast_to(init, cc.out.shape[1:])[None].repeat(
            cc.out.shape[0] - n_int, 0))


def _scene_3d_f64():
    """The 3D two-cubes-on-a-floor scene in float64."""
    scene32, dx = _scene_3d_f32()
    rng = np.random.default_rng(5)
    n = scene32.n
    fields = {k: (np.asarray(v).astype(np.float64)
                  if np.asarray(v).dtype == np.float32 else np.asarray(v))
              for k, v in scene32.fields.items()}
    for k in ("u", "v", "w"):
        fields[k] = rng.uniform(-1, 1, n)
    return type(scene32)({k: jnp.asarray(v) for k, v in fields.items()},
                         scene32.meta), fields, dx


def test_contact_twin_3d_matches_cell_engine_f64():
    scene, fields, dx = _scene_3d_f64()
    jcfg, tcfg = _cfgs(fields, dx, 3)
    S, n = scene.meta.total_no_bodies, scene.n

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
        dinfo["vy_source"], dinfo["vz_source"])], 1)     # [N, 12, S]

    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float64)
    cc = tck.contact_pipeline_compact(tscene, tcfg, TQuintic(dim=3),
                                      tcfg.NC_max)
    assert not bool(cc.overflow)
    pid = cc.pid.reshape(-1).numpy()
    out = cc.out.reshape(-1, 12 * S).numpy()
    live = pid < n
    # particles outside the kept slots hold the init row on both sides
    got = np.zeros((n, 12 * S))
    got[:, 5 * S:6 * S] = 4.0 * scene.meta.spacing0
    got[pid[live]] = out[live]
    ref = ref.reshape(n, 12 * S)
    assert (ref[:, 5 * S:6 * S] < 4.0 * scene.meta.spacing0).any()
    _assert_blocks(got, ref, S, rtol_sum=1e-10, exact_picks=False,
                   rtol_pick=1e-10)


def test_contact_force_core_f64():
    rng = np.random.default_rng(3)
    L, S, nb = 64, 3, 2
    dx = 0.05
    u, v, w = (rng.uniform(-1, 1, L) for _ in range(3))
    m = rng.uniform(1, 2, L)
    bid = rng.integers(-1, nb, L).astype(np.int32)
    eta = rng.uniform(0, 1, (nb, S))
    cfn = rng.normal(size=(3, L, S))
    cfn /= np.linalg.norm(cfn, axis=0)
    cfn[:, ::5] = 0.0
    dist = rng.uniform(-0.2 * dx, 1.5 * dx, (L, S))
    dist[::7] = 0.0
    dinfo = dict(contact_force_dist=dist)
    for k in ("vx_source", "vy_source", "vz_source"):
        dinfo[k] = rng.uniform(-1, 1, (L, S))
    dinfo["vx_source"][::3] = u[::3, None]      # some lanes not moving
    dinfo["vy_source"][::3] = v[::3, None]
    dinfo["vz_source"][::3] = w[::3, None]
    springs = [rng.uniform(-1e-3, 1e-3, (L, S)) for _ in range(6)]
    args = (nb, dx, 1e-4, 1e5, 1e3, 0.5)

    j = jcontact.contact_force_core(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), jnp.asarray(m),
        jnp.asarray(bid), jnp.asarray(eta), *args,
        *(jnp.asarray(c) for c in cfn),
        {k: jnp.asarray(a) for k, a in dinfo.items()},
        *(jnp.asarray(s) for s in springs))
    T = lambda a: torch.as_tensor(a)
    t = tcontact.contact_force_core(
        T(u), T(v), T(w), T(m), T(bid), T(eta), *args,
        *(T(c) for c in cfn), {k: T(a) for k, a in dinfo.items()},
        *(T(s) for s in springs))
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max())
    assert set(t[3]) == set(j[3])
    for k in j[3]:
        b = np.asarray(j[3][k])
        np.testing.assert_allclose(t[3][k].numpy(), b, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(b).max(), 1.0),
                                   err_msg=k)
