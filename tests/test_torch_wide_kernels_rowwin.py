"""Port vs reference past the DEM kernels' narrow instance, the
row-window grid (see ``tests/test_torch_wide_kernels.py``): the port's
row-window pass at L = 12 table slots (the 16-slot instance on the
card; on CPU tensors its kernel wrapper runs the plain version) against
the Pallas row-window kernel in interpret mode on the crowded grain
block of ``tests/test_torch_wide_kernels_3d.py`` (full tables, contacts
dropped), over 2 coupled f32 iterations from the empty table: tables,
slot positions and counts exact, sums within rtol 2e-5 / atol 2e-3,
springs within rtol 1e-4 (absolute floor 1e-5 of the largest).  The
reference kernel's interpret-mode compile takes about two minutes, so
this test has a file of its own.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import pallas_dem as jpd
from rigid_body_2d_3d_pysph_tpu.ops import rowwin as jrw

from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
from rigid_body_2d_3d_pysph_tpu_torch.ops import rowwin as trw
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_torch_wide_kernels_3d import (L_WIDE, advance, check_dem_pass,
                                        crowded_grains)

CPU = torch.device("cpu")


def test_dem_rowwin_pass_12_slots_matches_pallas_interpret():
    scene = crowded_grains()
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    args = (fields["x"], fields["y"], fields["z"],
            2.0 * float(fields["rad_s"].max()), 2)
    jcfg = jrw.rowwin_config_from_positions(*args)
    tcfg = trw.rowwin_config_from_positions(*args)
    dt = np.float32(1e-5)

    @jax.jit
    def eval_pallas(scene):
        return jpd.lvc_displacement_rowwin_pallas(
            scene, jcfg, jnp.float32(dt), scene.tng_idx,
            scene.tng_idx_dem_id, scene.tng_x, scene.tng_y, scene.tng_z,
            interpret=True)

    launches = dict(_build.LAUNCHES)
    for it in range(2):
        out_j = eval_pallas(scene)
        tscene = scene_from_numpy({k: np.asarray(v) for k, v in
                                   scene.fields.items()}, scene.meta, CPU,
                                  torch.float32)
        r = tdk.lvc_displacement_rowwin_kernel(
            tscene, tcfg, float(dt), tscene.tng_idx, tscene.tng_idx_dem_id,
            tscene.tng_x, tscene.tng_y, tscene.tng_z)
        assert not bool(np.asarray(out_j[12].overflow)) \
            and not bool(r.overflow)
        assert int(r.n_gated.max()) > L_WIDE
        assert int(r.count.max()) == L_WIDE
        check_dem_pass(r, out_j, it)
        scene = advance(scene, out_j, dt)
    assert _build.LAUNCHES == launches   # CPU tensors: no kernel launched
