"""Port vs reference: two non-quintic SPH kernels through the TPU
kernels in interpret mode, float32.

The Pallas bodies evaluate whatever ``Kernel`` they are handed; these
cases show that with another kernel they compute what the port's plain
versions (and so the hand-written kernels, held to them on the card)
compute:

* K2 with the cubic spline in 2D: the port's compact pipeline (K1, cull,
  K2's plain version) against ``contact_pipeline_compact_pallas``, on the
  two blocks over a wall of ``test_torch_contact``, each on its own grid
  of the cubic's cutoff (2 x max h); picks bit for bit, sums within rtol
  1e-5 (f32 summation order), as there;
* B4 (``fluid_rates_wall``) with the Wendland C2 kernel on the coupling
  tank with the box at the surface, against ``fluid_rates_wall_pallas``
  on the Wendland kernel's grid; each column within 2e-5 x its largest
  magnitude, as in ``test_torch_fluid``.
"""

import dataclasses

import numpy as np
import jax
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import pallas_contact as jpc
from rigid_body_2d_3d_pysph_tpu.ops import pallas_fluid as pfops
from rigid_body_2d_3d_pysph_tpu.ops.kernels import get_kernel as jkernel

from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as tfk
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel as tkernel
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_pallas_contact import _scene_f32
from test_torch_contact import _assert_blocks
from test_torch_coupling_step import port_twin
from test_torch_fluid import G, NU_EDAC, _check_sums, _scene

CPU = torch.device("cpu")


def _cfg_for(fields, name, dim=2, **kw):
    cutoff = jkernel(name, dim).radius_scale * float(fields["h"].max())
    return jcell.config_from_positions(fields["x"], fields["y"],
                                       fields["z"], cutoff, dim, **kw)


def _port_cfg(jcfg):
    return tcell.CellGridConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(tcell.CellGridConfig)})


def test_cubic_contact_matches_pallas_interpret():
    scene, _ = _scene_f32()
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    jcfg = _cfg_for(fields, "cubic", cell_chunk=16)
    tcfg = _port_cfg(jcfg)
    S = scene.meta.total_no_bodies
    ni = jcfg.NC_max
    out_j, pid_j, _, _, ovf_j = jax.jit(
        lambda s: jpc.contact_pipeline_compact_pallas(
            s, jcfg, jkernel("cubic", 2), ni, interpret=True))(scene)
    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float32)
    cc = tck.contact_pipeline_compact(tscene, tcfg, tkernel("cubic", 2), ni)
    assert not bool(ovf_j) and not bool(cc.overflow)
    n_int = int(cc.n_interesting)
    assert n_int > 0
    pid_t = cc.pid.numpy()[:n_int]
    np.testing.assert_array_equal(pid_t, np.asarray(pid_j)[:n_int])
    live = pid_t < scene.n
    out_j = np.asarray(out_j)[:n_int, :, :12 * S][live]
    out_t = cc.out.numpy()[:n_int][live]
    # gated pairs within the cubic's support (2h = 2.6 dx)
    assert (out_t[:, 5 * S:6 * S] < 4.0 * scene.meta.spacing0).sum() > 10
    _assert_blocks(out_t, out_j, S, rtol_sum=1e-5, exact_picks=True)


def test_wendland_rates_wall_matches_pallas_interpret():
    jsch, jscene = _scene("surface")
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    jcfg = _cfg_for(fields, "wendland")
    kernel = jkernel("wendland", 2)
    c0 = jsch.c0

    @jax.jit
    def run(scene):
        grid, dfT, sent, _ = pfops.pack_fluid_sorted(scene, jcfg,
                                                     interpret=True)
        out = pfops.fluid_rates_wall_pallas(
            scene, grid, jcfg, kernel, None, dfT, NU_EDAC, c0, True, True,
            *G, interpret=True, dense=True, sent_slot=sent)
        return jcell.unpack(grid, jcfg, out, scene.n, 0.0), grid.overflow

    ref, ovf = run(jscene)
    assert not bool(ovf)
    ref = np.asarray(ref)
    _, tscene = port_twin(jsch, jscene, torch.float32)
    tcfg = _port_cfg(jcfg)
    grid, _, dfT = tfk.pack_fluid_sorted(tscene, tcfg)
    assert not bool(grid.overflow)
    out = tfk.fluid_rates_wall(dfT, grid.nbr_slots, tkernel("wendland", 2),
                               tcfg.radius, NU_EDAC, c0, True, True, G)
    got = tcell.unpack(grid, tcfg, out, tscene.n, 0.0).numpy()
    fl = np.asarray(jscene.is_fluid)
    solid = np.asarray(jscene.is_static_boundary | jscene.is_rigid)
    assert np.abs(ref[fl, :2]).max() > 0          # rates on the fluid
    assert np.abs(ref[solid, 2:]).max() > 0       # wall sums on solids
    _check_sums(got, ref[:, :7], range(7), "wendland rates_wall")
