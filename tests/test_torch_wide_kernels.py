"""Port vs reference at the sizes past the hand kernels' narrow
instances, and the size-to-instance choices; the port's snapshot
viewer.

* K2's plain version (what the wide instance, S > 64, is held to on the
  card) against the Pallas compact pipeline in interpret mode on a 2D
  scene of 69 small touching blocks over a wall (S = 70), f32: the pick
  columns (closest distance, picked x/y/u/v) equal, the sum columns
  within rtol 1e-5 (absolute floor 1e-5 of the column's largest
  magnitude: summation order), as ``tests/test_torch_contact.py``.
* ``contact_instance`` and ``dem_kernel.table_instance``: every size
  the JAX kernels take maps to a documented instance; more than 8 DEM
  entities still raise.  (B5 has one instance at every S: its contact
  columns go straight to the output, ``tests/test_torch_wide_store.py``.)
* ``tools/view_snapshots.py`` renders PNG frames from the snapshots of a
  short case run on the CPU, in a subprocess that loads no JAX.

The 3D contact sums at S = 66 and the DEM spill pass at L = 12 are in
``tests/test_torch_wide_kernels_3d.py``, the DEM row-window pass at L =
12 in ``tests/test_torch_wide_kernels_rowwin.py`` (each reference
compile takes a minute or more).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.models.rigid_body import (
    _attach_contact_fields)
from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import pallas_contact as jpc
from rigid_body_2d_3d_pysph_tpu.ops.kernels import QuinticSpline as JQuintic
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY)
from rigid_body_2d_3d_pysph_tpu.state import rigid_setup as rs

from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import (
    QuinticSpline as TQuintic)
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_torch_contact import _assert_blocks

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def blocks_scene(n_blocks, dim, dtype=jnp.float32, dx=2.0**-4, side=3,
                 cols=12, seed=7):
    """``n_blocks`` blocks (side x side lattice points, 3D: cubes) in
    columns 5/8 dx apart (a contact engages below 1 dx), the lowest row
    11/16 dx over a wall, S = n_blocks + 1, built by the reference
    package with seeded random velocities, every field in ``dtype``.
    Every coordinate is a multiple of dx / 16 = 2^-8, so each squared
    pair distance is exact in f32 and XLA:CPU's contracted multiply-adds
    round it as the port does: equal distances, equal picks.  Returns
    (scene, dx)."""
    a = np.arange(side) * dx
    pitch = (side - 1) * dx + 0.625 * dx
    xs, ys, zs, bid = [], [], [], []
    for b in range(n_blocks):
        i, j = b % cols, b // cols
        if dim == 2:
            x, y = (c.ravel() for c in np.meshgrid(a + i * pitch,
                                                   a + j * pitch))
            z = np.zeros_like(x)
        else:
            x, y, z = (c.ravel() for c in np.meshgrid(a + i * pitch, a,
                                                      a + j * pitch))
        xs.append(x)
        ys.append(y)
        zs.append(z)
        bid.append(np.full(x.size, b, np.int32))
    x, y, z, bid = (np.concatenate(v) for v in (xs, ys, zs, bid))
    span = np.arange(-3, int(round(x.max() / dx)) + 4) * dx
    if dim == 2:
        xw, zw = span, np.zeros_like(span)
    else:
        zspan = np.arange(-3, int(round(z.max() / dx)) + 4) * dx
        xw, zw = (c.ravel() for c in np.meshgrid(span, zspan))
    yw = np.full(xw.size, -0.6875 * dx)
    m = 2000 * dx**dim
    kw = dict(m=m, h=1.3 * dx, rho=2000.0, rad_s=dx / 2)
    body = make_group("body", x, y, z=z, role=ROLE_RIGID, body_id=bid,
                      dem_id=bid, **kw)
    wall = make_group("wall", xw, yw, z=zw, role=ROLE_BOUNDARY,
                      dem_id=n_blocks, **kw)
    scene = build_scene([body, wall], dim=dim, total_no_bodies=n_blocks + 1,
                        spacing0=dx)
    scene = _attach_contact_fields(rs.setup_body_state(scene))
    rng = np.random.default_rng(seed)
    n = scene.n
    fields = {k: (v.astype(dtype) if hasattr(v, "dtype")
                  and v.dtype in (jnp.float64, jnp.float32) else v)
              for k, v in scene.fields.items()}
    scene = type(scene)(fields, scene.meta)
    vel = {k: jnp.asarray(rng.uniform(-1, 1, n), dtype)
           for k in ("u", "v", "w")[:dim]}
    return scene.replace(contact_force_is_boundary=jnp.ones(n, dtype),
                         **vel), dx


def cfgs(fields, dx, dim):
    args = (fields["x"], fields["y"], fields["z"], 3 * 1.3 * dx, dim)
    return (jcell.config_from_positions(*args, cell_chunk=16),
            tcell.config_from_positions(*args, cell_chunk=16))


def test_contact_pipeline_2d_70_entities_matches_pallas_interpret():
    scene, dx = blocks_scene(69, 2)
    S = scene.meta.total_no_bodies
    assert S == 70 and tck.contact_instance(S)[0] == "wide"
    fields = {k: np.asarray(v) for k, v in scene.fields.items()}
    jcfg, tcfg = cfgs(fields, dx, 2)
    ni = jcfg.NC_max
    out_j, pid_j, _, _, ovf_j = jax.jit(
        lambda s: jpc.contact_pipeline_compact_pallas(
            s, jcfg, JQuintic(dim=2), ni, interpret=True))(scene)
    tscene = scene_from_numpy(fields, scene.meta, CPU, torch.float32)
    cc = tck.contact_pipeline_compact(tscene, tcfg, TQuintic(dim=2), ni)
    assert not bool(ovf_j) and not bool(cc.overflow)
    n_int = int(cc.n_interesting)
    assert n_int > 0
    out_j = np.asarray(out_j)[:n_int, :, :12 * S]
    out_t = cc.out.numpy()[:n_int]
    pid_t = cc.pid.numpy()[:n_int]
    np.testing.assert_array_equal(pid_t, np.asarray(pid_j)[:n_int])
    live = pid_t < scene.n
    picked = out_t[live][:, 5 * S:6 * S] < 4.0 * dx
    # picks from entity slots past the narrow instance's 64
    assert picked[:, 64:].any() and picked.sum() > 100
    _assert_blocks(out_t[live], out_j[live], S, rtol_sum=1e-5,
                   exact_picks=True)


@pytest.mark.parametrize("S,want", [(1, ("narrow", 0)), (64, ("narrow", 0)),
                                    (65, ("wide", 65)), (300, ("wide", 300)),
                                    (5000, ("wide", 2048))])
def test_contact_instance_takes_every_size(S, want):
    """K2: the narrow instance up to 64 entities, the wide one past it,
    its dems in chunks of at most 2,048 (5,000: three chunks)."""
    assert tck.contact_instance(S) == want
    if want[0] == "wide":
        assert -(-S // want[1]) == (3 if S == 5000 else 1)


def test_contact_instance_refuses_no_entity():
    with pytest.raises(ValueError):
        tck.contact_instance(0)


@pytest.mark.parametrize("L,want", [(1, ("l8", 8)), (8, ("l8", 8)),
                                    (12, ("wide", 0)), (32, ("wide", 0)),
                                    (40, ("wide", 0)), (9, ("wide", 0)),
                                    (8192, ("wide", 0))])
def test_dem_table_instance_takes_every_width(L, want):
    """The DEM kernels: the narrow instance up to 8 slots, past it the
    wide one (the width a runtime argument, up to MAX_TABLE_WIDTH); the
    sizes check accepts every width."""
    assert tdk.table_instance(L) == want
    assert L <= tdk.MAX_TABLE_WIDTH
    tdk.check_sizes(1000, L, 2)


def test_dem_sizes_still_refuse_more_than_8_entities_and_no_slot():
    with pytest.raises(NotImplementedError):
        tdk.check_sizes(1000, 12, 9)
    with pytest.raises(ValueError):
        tdk.check_sizes(1000, 0, 2)
    with pytest.raises(ValueError):
        tdk.table_instance(0)


def test_viewer_renders_a_port_run_without_jax(tmp_path):
    """A short benchmark-1 run on the CPU, then the viewer (every
    snapshot, coloured by a field, with a GIF) and the plot tool, in one
    subprocess that never loads JAX or the JAX package."""
    pytest.importorskip("matplotlib")
    out = tmp_path / "benchmark_1_output"
    code = f"""
import json, runpy, sys
sys.argv = ["case", "--device", "cpu", "--max-steps", "10", "--pfreq", "5",
            "-d", {str(out)!r}, "--quiet"]
runpy.run_module("rigid_body_2d_3d_pysph_tpu_torch.cases."
                 "benchmark_1_rigid_body_rotating_and_translating_freely",
                 run_name="__main__")
from rigid_body_2d_3d_pysph_tpu_torch.tools import plot_results
from rigid_body_2d_3d_pysph_tpu_torch.tools import view_snapshots
frames = view_snapshots.render({str(out)!r}, every=1, field="u", gif=True)
plots = plot_results.plot_benchmark_1({str(tmp_path)!r})
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m.split(".")[0] == "rigid_body_2d_3d_pysph_tpu")
print(json.dumps(dict(frames=frames, plots=plots, bad=bad)))
"""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert len(got["frames"]) == 3
    for p in got["frames"] + got["plots"]:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert (out / "animation.gif").exists()
