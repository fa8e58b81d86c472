"""Port vs reference: the packed spill-grid build and pack expansion.

The port's ``build_cell_grid_packed`` must reproduce the JAX build
exactly (sorted order, slot tables, stencil rows), and its pack
expansion (the plain PyTorch twin of the CUDA kernel, which is what a
CPU tensor runs) must equal the Pallas kernel in interpret mode bit for
bit on the occupied rows.  Both sides start from the same f32 state.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import pallas_contact as jpc
from rigid_body_2d_3d_pysph_tpu.ops import pallas_pack as jpack

from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops import pack_expand as tpe
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_pallas_contact import _scene_f32, _scene_3d_f32

CPU = torch.device("cpu")


def _both(dim):
    scene, dx = _scene_f32() if dim == 2 else _scene_3d_f32()
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float32)
    cutoff = 3 * 1.3 * dx
    args = (fields["x"], fields["y"], fields["z"], cutoff, dim)
    jcfg = jcell.config_from_positions(*args, cell_chunk=16)
    tcfg = tcell.config_from_positions(*args, cell_chunk=16)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.spill
    return scene, tscene, jcfg, tcfg


def _jax_packed(scene, cfg, two_d):
    payload = [p.astype(jnp.float32)
               for p in jpc.contact_payload(scene, two_d)]

    @jax.jit
    def run(scene):
        return jcell.build_cell_grid_packed(scene.x, scene.y, scene.z,
                                            scene.active, cfg, payload)
    return run(scene)


@pytest.mark.parametrize("dim", [2, 3])
def test_packed_grid_matches_reference(dim):
    scene, tscene, jcfg, tcfg = _both(dim)
    two_d = dim == 2
    jg, jpt = _jax_packed(scene, jcfg, two_d)
    tg, tpt = tcell.build_cell_grid_packed(
        tscene.x, tscene.y, tscene.z, tscene.active, tcfg,
        tck.contact_payload(tscene, two_d))

    eq = np.testing.assert_array_equal
    eq(tpt.sorted_fields.numpy(),
       np.stack([np.asarray(f) for f in jpt.sorted_fields]))
    eq(tpt.sorted_pid.numpy(), np.asarray(jpt.sorted_pid))
    eq(tpt.base.numpy(), np.asarray(jpt.base))
    eq(tpt.cnt.numpy(), np.asarray(jpt.cnt))
    eq(tpt.slot_cid.numpy(), np.asarray(jpt.slot_cid))
    assert int(tpt.n_valid) == int(jpt.n_valid)
    assert int(tg.n_occupied) == int(jg.n_occupied)
    eq(tg.nbr_slots.numpy(), np.asarray(jg.nbr_slots))
    assert bool(tg.overflow) == bool(jg.overflow) is False


@pytest.mark.parametrize("dim", [2, 3])
def test_expand_twin_matches_pallas_interpret(dim):
    scene, tscene, jcfg, tcfg = _both(dim)
    two_d = dim == 2
    jg, jpt = _jax_packed(scene, jcfg, two_d)
    sent = tck.sent_fields(two_d)
    dft_j = np.asarray(jpack.expand_dft_pallas(jpt, jg.n_occupied, jcfg,
                                               sent, interpret=True))

    _, tpt = tcell.build_cell_grid_packed(
        tscene.x, tscene.y, tscene.z, tscene.active, tcfg,
        tck.contact_payload(tscene, two_d))
    launches = dict(_build.LAUNCHES)
    dft_t = tpe.expand_slots(tpt.sorted_fields, tpt.base, tpt.cnt,
                             torch.tensor(sent, dtype=torch.float32),
                             tcfg.M).numpy()
    assert _build.LAUNCHES == launches   # CPU: the twin ran, no launch
    M, NC = tcfg.M, tcfg.NC_max
    n_occ = int(jg.n_occupied)
    assert dft_t.shape == (NC + 1, len(sent), M)
    # occupied rows: bit for bit against the Pallas kernel's M live lanes
    np.testing.assert_array_equal(dft_t[:n_occ], dft_j[:n_occ, :, :M])
    # every other row of the port's layout is all-sentinel (the Pallas
    # kernel writes only up to its program padding)
    sent_blk = np.broadcast_to(np.asarray(sent, np.float32)[:, None],
                               (len(sent), M))
    np.testing.assert_array_equal(
        dft_t[n_occ:], np.broadcast_to(sent_blk, (NC + 1 - n_occ,) +
                                       sent_blk.shape))
    np.testing.assert_array_equal(dft_j[n_occ, :, :M], sent_blk)
