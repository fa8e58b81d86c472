"""The DEM LVC-displacement step's contact pass on the two DEM grids.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/pallas_dem.py``.  Both
paths fuse the contact-table prune into the pair pass's slot matching
(sound because the grid's cutoff is at least 2 max(rad_s), so every
still-overlapping partner is a candidate):

* the spill grid (default): grid build with the 13 source fields riding
  the cell sort, pack expansion (K1) and :func:`dem_cell_sums`
  (``csrc/dem.cu`` ``dem_cell`` for CUDA tensors), which reads and
  writes the ``[N, L]`` contact table in particle order;
* the row-window grid: the 13 fields and the 5L table columns ride the
  window sort, two pack expansions (sources, tables) and
  :func:`dem_rowwin_sums` (``dem_rowwin``), unpacked through the grid's
  lane map.

Each kernel wrapper runs its plain version for CPU tensors: the
reference package's prune followed by the dense-block pair pass
(``ops/dem_cell.py``) on the same inputs.  Integers ride the f32 source
pack as exact floats, so the wrappers take fewer than 2^24 particles,
at most 8 entities and at most 8 table slots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .cellpairs import CellGridConfig, build_cell_grid_packed, pack_rows, unpack
from .dem import prune_contact_table
from .dem_cell import (NF, SENT, PackedParticles, grid_from_pack,
                       lvc_cell_dense, lvc_displacement_cell)
from .pack_expand import expand_slots, expand_slots_reference
from .rowwin import RowWinConfig, build_row_window_grid

MAX_PARTICLES = 1 << 24   # exact float integers in the f32 source pack
L_MAX = 8                 # compile-time bounds of csrc/dem.cu
E_MAX = 8


def dem_payload(scene):
    """The source pack's 13 fields as per-particle [N] tensors."""
    fdt = scene.dtype
    ident = torch.arange(scene.n, dtype=fdt, device=scene.device)
    return [scene.x, scene.y, scene.z, scene.u, scene.v, scene.w,
            scene.wx, scene.wy, scene.wz, scene.rad_s, scene.m,
            scene.dem_id.to(fdt), ident]


def material_table(scene):
    """[E, 4]: kn, kt, alpha, mu per entity (indexed by source dem id)."""
    return torch.stack([scene.dem_kn, scene.dem_kt, scene.dem_alpha,
                        scene.dem_mu], 1)


def check_sizes(n: int, L: int, E: int) -> None:
    if n >= MAX_PARTICLES:
        raise ValueError(f"DEM kernels: {n} particles (indices ride f32, "
                         f"max {MAX_PARTICLES - 1})")
    if not 1 <= L <= L_MAX:
        raise ValueError(f"DEM kernels: table width {L} (max {L_MAX})")
    if E > E_MAX:
        raise NotImplementedError(f"DEM kernels: {E} entities (max {E_MAX})")


def _check_cuda(name, floats, ints64=(), ints32=()):
    dev = floats[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError(f"{name}: the kernel takes float32")
    if any(t.dtype != torch.int64 for t in ints64) or \
            any(t.dtype != torch.int32 for t in ints32):
        raise ValueError(f"{name}: index tables have the wrong dtype")


# ---------------------------------------------------------------------------
# spill grid (replaces pallas_dem._kernel)
# ---------------------------------------------------------------------------

def dem_cell_sums_reference(dfT, nbr, tng_idx, tng_dem, tng_x, tng_y, tng_z,
                            mat, dt, cfg: CellGridConfig):
    """Plain version of the spill-grid kernel: the prune, then the pair
    pass over each slot's stencil row.  ``dfT [NC + 1, 13, M]`` source
    pack, ``nbr [NC, O]``, tables [N, L], ``mat [E, 4]``.  Returns
    ``(sums [N, 8], idx, dem, sx, sy, sz [N, L])``."""
    n = tng_idx.shape[0]
    df = dfT.transpose(1, 2)
    grid = grid_from_pack(df, nbr, n)
    pruned = prune_contact_table(PackedParticles(grid, cfg, df, n),
                                 tng_idx, tng_dem, tng_x, tng_y, tng_z)[:5]
    return lvc_displacement_cell(df, grid, cfg, dt, mat, *pruned)


def dem_cell_sums(dfT, nbr, tng_idx, tng_dem, tng_x, tng_y, tng_z, mat, dt,
                  cfg: CellGridConfig):
    """The spill-grid DEM pass (see :func:`dem_cell_sums_reference`)."""
    n, L = tng_idx.shape
    if dfT.dim() != 3 or dfT.shape[1] != NF or nbr.dim() != 2 \
            or nbr.shape[0] != dfT.shape[0] - 1 or mat.shape[1:] != (4,):
        raise ValueError("dem_cell_sums: bad shapes "
                         f"{tuple(dfT.shape)}, {tuple(nbr.shape)}, "
                         f"{tuple(mat.shape)}")
    check_sizes(n, L, mat.shape[0])
    if dfT.device.type == "cpu":
        return dem_cell_sums_reference(dfT, nbr, tng_idx, tng_dem, tng_x,
                                       tng_y, tng_z, mat, dt, cfg)
    _check_cuda("dem_cell_sums", (dfT, tng_x, tng_y, tng_z, mat), (nbr,),
                (tng_idx, tng_dem))
    args = [t.contiguous() for t in (dfT, nbr, tng_idx, tng_dem, tng_x,
                                     tng_y, tng_z, mat)]
    dev = dfT.device
    o_sum = torch.zeros((n, 8), dtype=torch.float32, device=dev)
    o_idx = torch.full((n, L), -1, dtype=torch.int32, device=dev)
    o_dem = torch.full((n, L), -1, dtype=torch.int32, device=dev)
    o_spr = torch.zeros((3, n, L), dtype=torch.float32, device=dev)
    NC, O = nbr.shape
    fn = _build.load("dem_cell")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*[t.data_ptr() for t in args], o_sum.data_ptr(),
             o_idx.data_ptr(), o_dem.data_ptr(), o_spr.data_ptr(), n, NC, O,
             dfT.shape[2], L, mat.shape[0], float(dt), float(cfg.radius),
             stream)
    _build.check(err, "dem_cell_sums")
    _build.LAUNCHES["dem_cell"] += 1
    return o_sum, o_idx, o_dem, o_spr[0], o_spr[1], o_spr[2]


# ---------------------------------------------------------------------------
# row-window grid (replaces pallas_dem._win_kernel)
# ---------------------------------------------------------------------------

def rowwin_sources(nbr_runs, run_cnt, cfg: RowWinConfig):
    """[NCW, R * max_run] source slots per window, runs in order; slots
    past a run's count (they belong to other rows) read the all-sentinel
    row NCW."""
    NCW = cfg.NC_max
    t = torch.arange(cfg.max_run, device=nbr_runs.device)
    slots = nbr_runs[:, :, None] + t
    ok = t < run_cnt[:, :, None]
    return torch.where(ok, torch.clamp(slots, 0, NCW), NCW).reshape(NCW, -1)


def dem_rowwin_sums_reference(dfs, dft, nbr_runs, run_cnt, mat, dt, n: int,
                              cfg: RowWinConfig):
    """Plain version of the row-window kernel: the prune, then the pair
    pass over each window's runs with the overhang slots masked.
    ``dfs [NCW + 1, 13, M]`` source pack, ``dft [NCW + 1, 5L, M]`` table
    pack (idx | dem | sx | sy | sz).  Returns ``[NCW, M, 8 + 5L]``: the
    8 sums, then the table as floats."""
    L = dft.shape[1] // 5
    df = dfs.transpose(1, 2)
    nbr = rowwin_sources(nbr_runs, run_cnt, cfg)
    grid = grid_from_pack(df, nbr, n)
    tab = unpack(grid, cfg, dft[:cfg.NC_max].transpose(1, 2), n, -1.0)
    ti, td = tab[:, :L].to(torch.int32), tab[:, L:2 * L].to(torch.int32)
    pruned = prune_contact_table(
        PackedParticles(grid, cfg, df, n), ti, td, tab[:, 2 * L:3 * L],
        tab[:, 3 * L:4 * L], tab[:, 4 * L:])[:5]
    dense = [pack_rows(grid, cfg, t, -1 if i < 2 else 0.0)
             for i, t in enumerate(pruned)]
    sums, ti, td, ta, tb, tc = lvc_cell_dense(df, nbr, *dense, mat, dt, cfg)
    fdt = sums.dtype
    return torch.cat([sums, ti.to(fdt), td.to(fdt), ta, tb, tc], 2)


def dem_rowwin_sums(dfs, dft, nbr_runs, run_cnt, mat, dt, n: int,
                    cfg: RowWinConfig):
    """The row-window DEM pass (see :func:`dem_rowwin_sums_reference`);
    every lane of every window is written."""
    NCW, M, R = cfg.NC_max, cfg.M, cfg.R
    L = dft.shape[1] // 5
    if dfs.shape != (NCW + 1, NF, M) or dft.shape != (NCW + 1, 5 * L, M) \
            or nbr_runs.shape != (NCW, R) or run_cnt.shape != (NCW, R):
        raise ValueError("dem_rowwin_sums: bad shapes "
                         f"{tuple(dfs.shape)}, {tuple(dft.shape)}, "
                         f"{tuple(nbr_runs.shape)}, {tuple(run_cnt.shape)}")
    check_sizes(n, L, mat.shape[0])
    if dfs.device.type == "cpu":
        return dem_rowwin_sums_reference(dfs, dft, nbr_runs, run_cnt, mat,
                                         dt, n, cfg)
    _check_cuda("dem_rowwin_sums", (dfs, dft, mat), (nbr_runs, run_cnt))
    args = [t.contiguous() for t in (dfs, dft, nbr_runs, run_cnt, mat)]
    out = torch.empty((NCW, M, 8 + 5 * L), dtype=torch.float32,
                      device=dfs.device)
    fn = _build.load("dem_rowwin")
    stream = torch.cuda.current_stream(dfs.device).cuda_stream
    err = fn(*[t.data_ptr() for t in args], out.data_ptr(), NCW, R, M, L,
             mat.shape[0], float(dt), float(cfg.radius), stream)
    _build.check(err, "dem_rowwin_sums")
    _build.LAUNCHES["dem_rowwin"] += 1
    return out


# ---------------------------------------------------------------------------
# scene-level passes
# ---------------------------------------------------------------------------

class DemPass(NamedTuple):
    fx: torch.Tensor            # [N] contact force and torque sums
    fy: torch.Tensor
    fz: torch.Tensor
    torx: torch.Tensor
    tory: torch.Tensor
    torz: torch.Tensor
    tng_idx: torch.Tensor       # [N, L] updated contact table
    tng_dem: torch.Tensor
    tng_x: torch.Tensor
    tng_y: torch.Tensor
    tng_z: torch.Tensor
    count: torch.Tensor         # [N] live table entries
    n_gated: torch.Tensor       # [N] gated pairs (contacts this step)
    overflow: torch.Tensor      # 0-d bool: grid capacity


def _pass(sums, ti, td, ta, tb, tc, overflow, fdt):
    s = sums.to(fdt)
    return DemPass(*s[:, :6].unbind(1), ti, td, ta.to(fdt), tb.to(fdt),
                   tc.to(fdt), sums[:, 6].to(torch.int32),
                   sums[:, 7].to(torch.int32), overflow)


def lvc_displacement_cell_kernel(scene, cfg: CellGridConfig, dt,
                                 tng_idx, tng_dem, tng_x, tng_y, tng_z,
                                 plain: bool = False) -> DemPass:
    """The spill-grid pass (prune fused).  ``plain`` runs K1's and K4's
    plain versions even on CUDA tensors (the reference on the card)."""
    grid, pt = build_cell_grid_packed(scene.x, scene.y, scene.z,
                                      scene.active, cfg, dem_payload(scene))
    sent = torch.tensor(SENT, dtype=scene.dtype, device=scene.device)
    expand = expand_slots_reference if plain else expand_slots
    sums_fn = dem_cell_sums_reference if plain else dem_cell_sums
    dfT = expand(pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)
    out = sums_fn(dfT, grid.nbr_slots, tng_idx, tng_dem, tng_x, tng_y,
                  tng_z, material_table(scene), dt, cfg)
    return _pass(*out, grid.overflow, scene.dtype)


def unpack_dem_out(dense, grid, cfg, n: int, L: int):
    """[NC, M, 8 + 5L] -> (sums [N, 8], idx, dem [N, L] int32, sx, sy, sz
    [N, L]) in particle order, with one gather; a particle with no lane
    gets zero sums and an empty table."""
    flat = unpack(grid, cfg, dense, n, 0.0)
    dropped = grid.dense_pos >= cfg.NC_max * cfg.M
    tabi = torch.where(dropped[:, None], -1.0, flat[:, 8:8 + 2 * L]
                       ).to(torch.int32)
    return (flat[:, :8], tabi[:, :L], tabi[:, L:], flat[:, 8 + 2 * L:8 + 3 * L],
            flat[:, 8 + 3 * L:8 + 4 * L], flat[:, 8 + 4 * L:])


def lvc_displacement_rowwin_kernel(scene, cfg: RowWinConfig, dt,
                                   tng_idx, tng_dem, tng_x, tng_y, tng_z,
                                   plain: bool = False) -> DemPass:
    """The row-window pass (prune fused): the sources and the table ride
    the window sort, two pack expansions, the kernel, one unpack."""
    n, L = tng_idx.shape
    fdt = scene.dtype
    tab = torch.cat([tng_idx.to(fdt), tng_dem.to(fdt), tng_x, tng_y, tng_z],
                    1).T
    grid, pt = build_row_window_grid(scene.x, scene.y, scene.z,
                                     scene.active, cfg,
                                     dem_payload(scene) + list(tab))
    expand = expand_slots_reference if plain else expand_slots
    sums_fn = dem_rowwin_sums_reference if plain else dem_rowwin_sums
    mk = lambda v: torch.tensor(v, dtype=fdt, device=scene.device)
    dfs = expand(pt.sorted_fields[:NF], pt.base, pt.cnt, mk(SENT), cfg.M)
    dft = expand(pt.sorted_fields[NF:], pt.base, pt.cnt,
                 mk([-1.0] * (2 * L) + [0.0] * (3 * L)), cfg.M)
    dense = sums_fn(dfs, dft, grid.nbr_runs, grid.run_cnt,
                    material_table(scene), dt, n, cfg)
    return _pass(*unpack_dem_out(dense, grid, cfg, n, L), grid.overflow, fdt)
