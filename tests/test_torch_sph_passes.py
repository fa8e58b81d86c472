"""Port vs reference: the cell engine's pair passes with the five
non-quintic SPH kernels (cubic, Wendland C2 and C4, Gaussian,
super-Gaussian), float64.

For each kernel, the plain versions of the hand-written kernels (the
wrappers run them on CPU tensors) against the JAX package's XLA cell
functions on the same state, each side on its own grid of the kernel's
cutoff (radius_scale x max h), compared per particle after the unpack:

* K2 (``contact_kernel.contact_pipeline_cell``, every slot) on two
  blocks over a wall, 0.6 dx apart (so both support radii hold gated
  pairs), against ``contact_cell.contact_pipeline_cell_fused`` (its
  ``contact_sums_fused`` pass);
* the five fluid passes on the coupling tank with the box resting on the
  floor (``test_torch_coupling_step._jax_floor_scene``, seeded
  velocities and body p_fsi): B4 ``fluid_rates_wall``, B6a
  ``fluid_rates`` (EDAC, rigid bodies), B6b ``wall_bc``, B6c
  ``fluid_forces`` (rigid bodies) and B5 ``fluid_forces_contact``
  against ``fluid_cell.fluid_rates_cell``, ``wall_bc_cell``,
  ``fluid_forces_cell`` and, for B5's contact columns, the contact
  pipeline on the same grid.

Tolerance: each column within 1e-10 x its largest magnitude (the two
sides sum the pair terms in other orders; the contact normals, unit
vectors, within 1e-10 absolute); the contact picks are copies of source
values and the closest distances a minimum: equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import contact_cell as jcc
from rigid_body_2d_3d_pysph_tpu.ops import fluid_cell as jfc
from rigid_body_2d_3d_pysph_tpu.ops.kernels import get_kernel as jkernel

from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel as tkernel
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_pallas_contact import _scene_f32
from test_torch_coupling_step import _jax_floor_scene

CPU = torch.device("cpu")
NAMES = ("cubic", "wendland", "wendland_c4", "gaussian", "super_gaussian")
RTOL = 1e-10
PICKS = range(5, 12)            # closest distance + 6 picked fields
NU_EDAC, ALPHA, G = 0.02, 0.1, (0.0, -1.0, 0.0)


def _f64(scene):
    fields = {k: (np.asarray(v).astype(np.float64)
                  if np.asarray(v).dtype == np.float32 else np.asarray(v))
              for k, v in scene.fields.items()}
    return type(scene)({k: jnp.asarray(v) for k, v in fields.items()},
                       scene.meta), fields


def _configs(fields, name, dim=2):
    """The kernel's grid (cutoff radius_scale x max h) on both sides."""
    cutoff = jkernel(name, dim).radius_scale * float(fields["h"].max())
    jcfg = jcell.config_from_positions(fields["x"], fields["y"],
                                       fields["z"], cutoff, dim,
                                       cell_chunk=64)
    tcfg = tcell.CellGridConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tcell.CellGridConfig)})
    return jcfg, tcfg


def _close(got, ref, what, exact=False, floor=1e-30):
    assert np.isfinite(got).all(), what
    if exact:
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    scale = max(float(np.abs(ref).max(initial=0.0)), floor)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale,
                               err_msg=what)


def _contact_ref(scene, grid, cfg, kernel):
    """JAX's contact columns as [N, 12, S] (the port's block order)."""
    cx, cy, cz, cw, d = jcc.contact_pipeline_cell_fused(scene, grid, cfg,
                                                        kernel)
    return jnp.stack([cx, cy, cz, cw, d["contact_force_dist"],
                      d["closest_point_dist_to_source"], d["x_source"],
                      d["y_source"], d["z_source"], d["vx_source"],
                      d["vy_source"], d["vz_source"]], 1)


def _check_contact(got, ref, S, what):
    """[N, 12, S] blocks; the picks exactly, the sums within RTOL (the
    normals, unit vectors, within RTOL absolute: a component near 0
    carries the others' rounding)."""
    for c in range(12):
        _close(got[:, c], ref[:, c], f"{what} block {c}", exact=c in PICKS,
               floor=1.0 if c < 3 else 1e-30)


@pytest.mark.parametrize("name", NAMES)
def test_plain_contact_sums_match_xla_f64(name):
    scene, fields = _f64(_scene_f32()[0])
    jcfg, tcfg = _configs(fields, name)
    jk, tk = jkernel(name, 2), tkernel(name, 2)
    S, n = scene.meta.total_no_bodies, scene.n

    @jax.jit
    def run(scene):
        grid = jcell.build_cell_grid(scene.x, scene.y, scene.z,
                                     scene.active, jcfg)
        return grid.overflow, _contact_ref(scene, grid, jcfg, jk)

    ovf, ref = run(scene)
    assert not bool(ovf)
    ref = np.asarray(ref)
    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float64)
    grid, _, dfT = tck.pack_scene(tscene, tcfg, want_dense_pos=True)
    assert not bool(grid.overflow)
    got = tck.contact_pipeline_cell(dfT, grid, tcfg, tk, S,
                                    4.0 * scene.meta.spacing0, n).numpy()
    # gated pairs on both bodies' facing sides
    assert (ref[:, 5] < 4.0 * scene.meta.spacing0).sum() > 10
    assert np.abs(ref[:, 3]).max() > 0
    _check_contact(got, ref, S, name)


@pytest.fixture(scope="module")
def floor_scene():
    jsch, jscene = _jax_floor_scene()
    rng = np.random.default_rng(5)
    n = jscene.n
    rigid = np.asarray(jscene.is_rigid)
    jscene = jscene.replace(
        u=jnp.asarray(rng.uniform(-0.2, 0.2, n)),
        v=jnp.asarray(rng.uniform(-0.2, 0.2, n)),
        p=jnp.asarray(np.asarray(jscene.p) + rng.uniform(0.0, 0.5, n)),
        p_fsi=jnp.asarray(np.where(rigid, rng.uniform(0.0, 1.0, n), 0.0)))
    return jsch, jscene


@pytest.mark.parametrize("name", NAMES)
def test_plain_fluid_passes_match_xla_f64(floor_scene, name):
    jsch, scene = floor_scene
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    jcfg, tcfg = _configs(fields, name)
    jk, tk = jkernel(name, 2), tkernel(name, 2)
    S, n, c0 = scene.meta.total_no_bodies, scene.n, jsch.c0

    @jax.jit
    def run(scene):
        grid = jcell.build_cell_grid(scene.x, scene.y, scene.z,
                                     scene.active, jcfg)
        df, di = jfc.pack_fluid_scene(scene, grid, jcfg)
        p_d = jcell.pack_fields(grid, jcfg, [scene.p], [0.0])[..., 0]
        pf_d = jcell.pack_fields(grid, jcfg, [scene.p_fsi], [0.0])[..., 0]
        rates = jfc.fluid_rates_cell(scene, grid, jcfg, jk, df, di,
                                     NU_EDAC, c0, True, True)
        wall = jfc.wall_bc_cell(scene, grid, jcfg, jk, df, di, *G)
        forces = jfc.fluid_forces_cell(scene, grid, jcfg, jk, df, di, p_d,
                                       pf_d, ALPHA, c0, True)
        return (grid.overflow, jnp.stack(rates, 1), jnp.stack(wall, 1),
                jnp.stack(forces, 1), _contact_ref(scene, grid, jcfg, jk))

    ovf, *ref = run(scene)
    assert not bool(ovf)
    rates, wall, forces, contact = (np.asarray(r) for r in ref)
    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float64)
    grid, _, dfT = tfk.pack_fluid_sorted(tscene, tcfg)
    assert not bool(grid.overflow)
    args = (dfT, grid.nbr_slots, tk, tcfg.radius)
    init = 4.0 * scene.meta.spacing0
    outs = dict(
        b4=tfk.fluid_rates_wall(*args, NU_EDAC, c0, True, True, G),
        b6a=tfk.fluid_rates(*args, NU_EDAC, c0, True, True),
        b6b=tfk.wall_bc(*args, G),
        b6c=tfk.fluid_forces(*args, ALPHA, c0, True),
        b5=torch.cat(tfk.fluid_forces_contact(*args, ALPHA, c0, S,
                                              init)[::-1], -1))
    got = {k: tcell.unpack(grid, tcfg, v, n, 0.0).numpy()
           for k, v in outs.items()}

    fl = fields["is_fluid"].astype(bool)
    rigid = fields["is_rigid"].astype(bool)
    solid = fields["is_static_boundary"].astype(bool) | rigid
    assert min(np.abs(rates[fl, c]).max() for c in (0, 1)) > 0
    assert min(np.abs(wall[solid, c]).max() for c in (0, 1, 3, 4)) > 0
    assert min(np.abs(forces[rigid, c]).max() for c in (3, 4)) > 0
    assert (contact[:, 5] < init).sum() > 0           # gated contact pairs
    for c in range(2):
        _close(got["b4"][:, c], rates[:, c], f"B4 column {c}")
        _close(got["b6a"][:, c], rates[:, c], f"B6a column {c}")
    for c in range(5):
        _close(got["b4"][:, 2 + c], wall[:, c], f"B4 column {2 + c}")
        _close(got["b6b"][:, c], wall[:, c], f"B6b column {c}")
    for c in range(6):
        _close(got["b6c"][:, c], forces[:, c], f"B6c column {c}")
        _close(got["b5"][:, 12 * S + c], forces[:, c],
               f"B5 force column {c}")
    _check_contact(got["b5"][:, :12 * S].reshape(n, 12, S), contact, S,
                   f"B5 {name}")
