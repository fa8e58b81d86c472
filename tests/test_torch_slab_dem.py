"""Port vs reference: the slab-decomposed DEM step (``parallel/slab.py``,
gid-keyed contact tables) on 4 CPU devices, in float64, on
``tests/test_slab_dem.py``'s strip of grains.

* 5 slab steps, then a redistribution from a stale decomposition (the
  rows placed by positions 2 spacings to the right, so rows near the
  face sit in the wrong slab: the count is asserted), then 5 more,
  against 10 steps of the reference's single-device cell step: x/y/u/v,
  spin, force and torque at atol 1e-8 (``tests/test_slab_dem.py``),
  the grains' tables equal as gid-keyed (partner, dem) -> spring maps,
  live contacts every step.
* On-device redistribution equals the host's slab by slab as sets of
  rows (every field, the tables too).
* The gid-keyed DEM pass (``lvc_displacement_cell_kernel`` with
  ``n_ident``) on a row-permuted scene that carries gids against the
  reference's ``ops/dem_cell.py`` pass with gids (its prune through the
  gid -> row table), and against the port's own pass on the unpermuted
  scene.

On CPU tensors the kernel wrappers run their plain versions.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu.ops import cellpairs as jcell
from rigid_body_2d_3d_pysph_tpu.ops import dem as jdem
from rigid_body_2d_3d_pysph_tpu.ops import dem_cell as jdem_cell

from rigid_body_2d_3d_pysph_tpu_torch.models import DEMScheme
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as dk
from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as tslab
from rigid_body_2d_3d_pysph_tpu_torch.parallel.mesh import make_mesh
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy
from rigid_body_2d_3d_pysph_tpu_torch.state.scene import Scene

from test_slab_dem import _wide_grain_scene

CPU = torch.device("cpu")
DT = 1e-5
P = 4
HALF = 5
TRAJ = ("x", "y", "u", "v", "wz", "fx", "fy", "torz", "total_tng_contacts")


def _port(jscene):
    return scene_from_numpy({k: np.asarray(v) for k, v in
                             jscene.fields.items()}, jscene.meta, CPU,
                            torch.float64)


def _table_maps(idx, dem, sx, sy):
    """Per row, the table as a (partner, dem) -> (spring x, y) map."""
    return [{(int(i), int(d)): (a, b) for i, d, a, b in zip(*r) if i >= 0}
            for r in zip(idx, dem, sx, sy)]


def _assert_tables_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            np.testing.assert_allclose(ra[k], rb[k], rtol=0, atol=1e-12)


def _by_gid(g):
    """The gathered slab scene's active rows in gid order."""
    act = g.active.numpy()
    rows = np.nonzero(act)[0]
    return rows[np.argsort(g.gid.numpy()[act])]


def _assert_matches_reference(g, ref):
    rows = _by_gid(g)
    assert len(rows) == ref.n
    assert np.array_equal(g.gid.numpy()[rows], np.arange(ref.n))
    for k in TRAJ:
        np.testing.assert_allclose(g[k].numpy()[rows], np.asarray(ref[k]),
                                   rtol=0, atol=1e-8, err_msg=k)
    # granular rows (``tests/test_torch_dem_step.py``): where a static
    # floor row's table overflows, which contacts keep a slot follows the
    # grid's candidate order
    gr = np.asarray(ref.is_rigid)
    _assert_tables_equal(
        _table_maps(*(g[k].numpy()[rows][gr] for k in
                      ("tng_idx", "tng_idx_dem_id", "tng_x", "tng_y"))),
        _table_maps(*(np.asarray(ref[k])[gr] for k in
                      ("tng_idx", "tng_idx_dem_id", "tng_x", "tng_y"))))


def _stale(g, cfg, shift):
    """``g`` decomposed as if every row sat ``shift`` further right."""
    fields = dict(g.fields)
    fields["x_true"] = g.x
    fields["x"] = torch.where(g.active, g.x + shift, g.x)
    dec = tslab.redistribute(Scene(fields, g.meta), cfg)
    fields = dict(dec.fields)
    fields["x"] = fields.pop("x_true")
    return Scene(fields, dec.meta)


@pytest.fixture(scope="module")
def dem_run():
    jscheme, jscene = _wide_grain_scene()
    jstep = jscheme.make_step(jscene)
    refs = [jscene]
    for _ in range(2 * HALF):
        refs.append(jstep(refs[-1], jnp.asarray(DT)))

    tscheme = DEMScheme(["grains"], ["floor"], kn=1e5, en=0.5, gy=-9.81,
                        dim=2)
    tscene = tslab.attach_gids(_port(jscene))
    cfg = tslab.make_slab_config(tscene, tscheme.cell_config(tscene), P)
    mesh = make_mesh(P, [CPU] * P)
    parts = tslab.shard_slab_scene(tslab.slab_decompose(tscene, cfg), mesh)
    step = tslab.make_slab_dem_step(tscheme, parts, mesh, cfg, tscene.n)
    live = []

    def run(parts):
        for _ in range(HALF):
            parts = step(parts, DT)
            live.append(sum(int(p.total_tng_contacts.sum()) for p in parts))
        return parts

    parts = run(parts)
    mid = tslab.gather_slab_scene(parts)
    stale = _stale(mid, cfg, 2 * jscene.meta.spacing0)
    own = np.arange(stale.n) // cfg.n_cap
    moved = int((stale.active.numpy()
                 & (tslab._slab_of(stale.x, cfg) != own)).sum())
    host = tslab.redistribute(stale, cfg)
    parts = tslab.shard_slab_scene(stale, mesh)
    parts = tslab.make_slab_redistribute(parts, mesh, cfg)(parts)
    dev = tslab.gather_slab_scene(parts)
    end = tslab.gather_slab_scene(run(parts))
    return dict(refs=refs, cfg=cfg, mid=mid, moved=moved, host=host,
                dev=dev, end=end, live=live, tscheme=tscheme)


def test_slab_dem_steps_match_single_device(dem_run):
    r = dem_run
    assert min(r["live"]) > 0
    for g in (r["mid"], r["end"]):
        assert not bool(g.nbr_overflow)
    _assert_matches_reference(r["mid"], r["refs"][HALF])
    _assert_matches_reference(r["end"], r["refs"][2 * HALF])


def test_slab_dem_redistribution_moves_rows_and_keeps_tables(dem_run):
    r = dem_run
    cfg, host, dev = r["cfg"], r["host"], r["dev"]
    assert r["moved"] > 0
    assert not bool(dev.nbr_overflow)
    assert int(dev.total_tng_contacts.sum()) > 0
    own = np.arange(dev.n) // cfg.n_cap
    for g in (host, dev):
        act = g.active.numpy()
        assert act.sum() == r["refs"][0].n
        assert (tslab._slab_of(g.x, cfg)[act] == own[act]).all()
    # slab by slab, the same rows (every field) on both paths
    for d in range(P):
        rows = np.arange(d * cfg.n_cap, (d + 1) * cfg.n_cap)
        sel = [rows[np.argsort(np.where(g.active.numpy()[rows],
                                        g.gid.numpy()[rows], 1 << 30),
                               kind="stable")] for g in (host, dev)]
        for k in host.fields:
            a, b = host[k].numpy(), dev[k].numpy()
            if a.ndim >= 1 and a.shape[0] == host.n:
                a, b = a[sel[0]], b[sel[1]]
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_dem_gid_pass_matches_reference(dem_run):
    """One pass on a row-permuted scene whose tables key on gids."""
    ref = dem_run["refs"][HALF]
    n = ref.n
    perm = np.random.default_rng(7).permutation(n)
    jf = {k: (np.asarray(v)[perm] if np.ndim(v) >= 1
              and np.shape(v)[0] == n else np.asarray(v))
          for k, v in ref.fields.items()}
    jf["gid"] = perm.astype(np.int32)
    jscene_p = type(ref)({k: jnp.asarray(v) for k, v in jf.items()},
                         ref.meta)
    jcfg = dem_run["tscheme"].cell_config(_port(ref))
    jcfg = jcell.CellGridConfig(**{f: getattr(jcfg, f) for f in (
        "cell", "M", "NC_max", "origin", "dims", "dim", "cell_chunk",
        "cutoff", "sub", "skin", "spill", "nbr_width", "max_spill")})
    grid = jcell.build_cell_grid(jscene_p.x, jscene_p.y, jscene_p.z,
                                 jscene_p.active, jcfg)
    row_of_gid = jnp.full(n + 1, n, jnp.int32).at[jscene_p.gid].set(
        jnp.arange(n, dtype=jnp.int32))
    tabs = jdem.prune_contact_table(
        jscene_p, jscene_p.tng_idx, jscene_p.tng_idx_dem_id,
        jscene_p.tng_x, jscene_p.tng_y, jscene_p.tng_z,
        row_of_gid=row_of_gid)[:5]
    jout = [np.asarray(a) for a in jdem_cell.lvc_displacement_cell(
        jscene_p, grid, jcfg, DT, *tabs)]

    tcfg = dem_run["tscheme"].cell_config(_port(ref))
    tp = _port(jscene_p)
    tp = tp.with_fields(gid=torch.as_tensor(perm, dtype=torch.int32))
    out = dk.lvc_displacement_cell_kernel(
        tp, tcfg, DT, tp.tng_idx, tp.tng_idx_dem_id, tp.tng_x, tp.tng_y,
        tp.tng_z, n_ident=n)
    for i, k in enumerate(("fx", "fy", "fz", "torx", "tory", "torz")):
        np.testing.assert_allclose(getattr(out, k).numpy(), jout[i],
                                   rtol=0, atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(out.count.numpy(), jout[11])
    assert int(out.count.sum()) > 0
    _assert_tables_equal(
        _table_maps(out.tng_idx.numpy(), out.tng_dem.numpy(),
                    out.tng_x.numpy(), out.tng_y.numpy()),
        _table_maps(jout[6], jout[7], jout[8], jout[9]))

    # the port's pass on the unpermuted scene (rows are gids there)
    t0 = _port(ref)
    own = dk.lvc_displacement_cell_kernel(
        t0, tcfg, DT, t0.tng_idx, t0.tng_idx_dem_id, t0.tng_x, t0.tng_y,
        t0.tng_z)
    for k in ("fx", "fy", "torz"):
        np.testing.assert_allclose(getattr(out, k).numpy(),
                                   getattr(own, k).numpy()[perm], rtol=0,
                                   atol=1e-9, err_msg=k)
    _assert_tables_equal(
        _table_maps(out.tng_idx.numpy(), out.tng_dem.numpy(),
                    out.tng_x.numpy(), out.tng_y.numpy()),
        _table_maps(*(getattr(own, k).numpy()[perm] for k in
                      ("tng_idx", "tng_dem", "tng_x", "tng_y"))))
