"""The DEM step's contact pass: LVC displacement on the two DEM grids,
and LVCForce.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/pallas_dem.py``.  Both
paths fuse the contact-table prune into the pair pass's slot matching
(sound because the grid's cutoff is at least 2 max(rad_s), so every
still-overlapping partner is a candidate):

* the spill grid (default): grid build with the 13 source fields riding
  the cell sort, pack expansion (K1) and :func:`dem_cell_sums`
  (``csrc/dem.cu`` ``dem_cell`` for CUDA tensors), which reads and
  writes the ``[N, L]`` contact table in particle order; on a classic
  grid (a preset config, or a slab step's classic base) the pack is
  gathered through ``slot2p`` instead of K1 and the same kernel runs on
  the grid's stencil rows;
* the row-window grid: the 13 source fields ride the window sort, one
  pack expansion (K1) and :func:`dem_rowwin_sums` (``dem_rowwin``),
  which reads and writes the table in particle order as the spill
  kernel does.

Each kernel wrapper runs its plain version for CPU tensors: the
reference package's prune followed by the dense-block pair pass
(``ops/dem_cell.py``) on the same inputs.

The LVCForce pass (:func:`lvc_force_pass`) has no kernel: the reference
package runs it in XLA only (its Pallas DEM kernels cover LVC
displacement).  It is the reference's cell-engine sequence in PyTorch
ops: the prune, a grid build and the dense-block pass.  Integers ride the f32 source
pack as exact floats, so the wrappers take fewer than 2^24 particles and
at most 8 entities (as the reference's kernels); a table of up to
``MAX_TABLE_WIDTH`` slots has a kernel instance (:func:`table_instance`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .cellpairs import (CellGridConfig, build_cell_grid,
                        build_cell_grid_packed, pack_fields)
from .dem import prune_contact_table
from .dem_cell import (NF, SENT, PackedParticles, dem_payload,
                       grid_from_pack, lvc_displacement_cell, lvc_force_cell)
from .pack_expand import expand_slots, expand_slots_reference
from .rowwin import RowWinConfig, build_row_window_grid

MAX_PARTICLES = 1 << 24   # exact float integers in the f32 source pack
E_MAX = 8                 # entities (the reference kernels' bound too)
# csrc/dem.cu's narrow instance holds a query's table of up to 8 slots in
# registers; the wide one (width 0) lists each row's live entries and
# keeps a match bitmap of ceil(L / 32) words a query in shared memory,
# which bounds its width (MAX_WIDE_L there)
NARROW_WIDTH = 8
MAX_TABLE_WIDTH = 8192
WIDE_LIST = 16            # live entries a query's list holds (dem.cu CL)
# csrc/dem.cu takes any slot width up to MAX_LANES (MAX_M there): 8 and 16
# lanes (the spill grids' widths) are instances of their own, every other
# width runs the runtime-width instance (counted as "<table>/lanes<M>")
OWN_M = (8, 16)
MAX_LANES = 256


def material_table(scene):
    """[E, 4]: kn, kt, alpha, mu per entity (indexed by source dem id)."""
    return torch.stack([scene.dem_kn, scene.dem_kt, scene.dem_alpha,
                        scene.dem_mu], 1)


def check_sizes(n: int, L: int, E: int) -> None:
    if n >= MAX_PARTICLES:
        raise ValueError(f"DEM kernels: {n} particles (indices ride f32, "
                         f"max {MAX_PARTICLES - 1})")
    if L < 1:
        raise ValueError(f"DEM kernels: table width {L} (at least 1)")
    if E > E_MAX:
        raise NotImplementedError(f"DEM kernels: {E} entities (max {E_MAX})")


def table_instance(L: int) -> tuple[str, int]:
    """The ``csrc/dem.cu`` instance for a table of L slots: ``("l8",
    8)`` up to 8 slots (L = 8 on 16-byte rows), else ``("wide", 0)``,
    the width a runtime argument.  Both instances give the same
    tables."""
    if L < 1:
        raise ValueError(f"DEM kernels: table width {L} (at least 1)")
    return ("l8", NARROW_WIDTH) if L <= NARROW_WIDTH else ("wide", 0)


def _check_cuda(name, M, floats, ints64=(), ints32=()):
    dev = floats[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError(f"{name}: the kernel takes float32")
    if any(t.dtype != torch.int64 for t in ints64) or \
            any(t.dtype != torch.int32 for t in ints32):
        raise ValueError(f"{name}: index tables have the wrong dtype")
    if not 1 <= M <= MAX_LANES:
        raise ValueError(f"{name}: {M} lanes a slot (the kernel takes 1 to "
                         f"{MAX_LANES})")
    L = ints32[0].shape[1]
    if L > MAX_TABLE_WIDTH:
        raise NotImplementedError(f"{name}: table width {L} (the kernel "
                                  f"takes at most {MAX_TABLE_WIDTH})")


def lanes_instance(inst: str, M: int) -> str:
    """The launch-count key of table instance ``inst`` at M lanes a slot:
    8 and 16 lanes keep the table instance's name, another width runs the
    runtime-width instance (``"<inst>/lanes<M>"``)."""
    return inst if M in OWN_M else f"{inst}/lanes{M}"


def _launch(kernel, pack, index_tables, tables, mat, sizes, dt, cutoff):
    """Allocate the per-particle outputs with the fill of a particle that
    has no lane (zero sums, -1 table entries, zero springs), launch
    ``kernel`` and return ``(sums [N, 8], idx, dem, sx, sy, sz [N, L])``."""
    n, L = tables[0].shape
    dev = pack.device
    inst, lm = table_instance(L)
    args = [t.contiguous() for t in (pack, *index_tables, *tables, mat)]
    # two fills: the sums and springs in one float buffer, idx and dem in
    # one int buffer
    flt = torch.zeros(n * (8 + 3 * L), dtype=torch.float32, device=dev)
    o_sum, o_spr = flt[:n * 8].view(n, 8), flt[n * 8:].view(3, n, L)
    o_idx, o_dem = torch.full((2, n, L), -1, dtype=torch.int32, device=dev)
    fn = _build.load(kernel)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*[t.data_ptr() for t in args], o_sum.data_ptr(),
             o_idx.data_ptr(), o_dem.data_ptr(), o_spr.data_ptr(), n,
             *sizes, L, lm, mat.shape[0], float(dt), float(cutoff), stream)
    _build.check(err, kernel)
    _build.count(kernel, instance=lanes_instance(inst, pack.shape[2]))
    return o_sum, o_idx, o_dem, o_spr[0], o_spr[1], o_spr[2]


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
    _check_cuda("dem_cell_sums", dfT.shape[2],
                (dfT, tng_x, tng_y, tng_z, mat), (nbr,), (tng_idx, tng_dem))
    NC, O = nbr.shape
    return _launch("dem_cell", dfT, (nbr,),
                   (tng_idx, tng_dem, tng_x, tng_y, tng_z), mat,
                   (NC, O, dfT.shape[2]), dt, cfg.radius)


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


def dem_rowwin_sums_reference(dfs, nbr_runs, run_cnt, tng_idx, tng_dem,
                              tng_x, tng_y, tng_z, mat, dt,
                              cfg: RowWinConfig):
    """Plain version of the row-window kernel: the spill kernel's plain
    version over each window's runs (:func:`rowwin_sources`, the overhang
    slots masked).  ``dfs [NCW + 1, 13, M]`` source pack, ``nbr_runs``,
    ``run_cnt [NCW, R]``, tables [N, L].  Returns ``(sums [N, 8], idx,
    dem, sx, sy, sz [N, L])``; a particle with no lane gets zero sums and
    an empty table."""
    return dem_cell_sums_reference(
        dfs, rowwin_sources(nbr_runs, run_cnt, cfg), tng_idx, tng_dem, tng_x,
        tng_y, tng_z, mat, dt, cfg)


def dem_rowwin_sums(dfs, nbr_runs, run_cnt, tng_idx, tng_dem, tng_x, tng_y,
                    tng_z, mat, dt, cfg: RowWinConfig):
    """The row-window DEM pass (see :func:`dem_rowwin_sums_reference`)."""
    NCW, M, R = cfg.NC_max, cfg.M, cfg.R
    n, L = tng_idx.shape
    if dfs.shape != (NCW + 1, NF, M) or nbr_runs.shape != (NCW, R) \
            or run_cnt.shape != (NCW, R) or mat.shape[1:] != (4,):
        raise ValueError("dem_rowwin_sums: bad shapes "
                         f"{tuple(dfs.shape)}, {tuple(nbr_runs.shape)}, "
                         f"{tuple(run_cnt.shape)}, {tuple(mat.shape)}")
    check_sizes(n, L, mat.shape[0])
    if dfs.device.type == "cpu":
        return dem_rowwin_sums_reference(dfs, nbr_runs, run_cnt, tng_idx,
                                         tng_dem, tng_x, tng_y, tng_z, mat,
                                         dt, cfg)
    _check_cuda("dem_rowwin_sums", M, (dfs, tng_x, tng_y, tng_z, mat),
                (nbr_runs, run_cnt), (tng_idx, tng_dem))
    return _launch("dem_rowwin", dfs, (nbr_runs, run_cnt),
                   (tng_idx, tng_dem, tng_x, tng_y, tng_z), mat,
                   (NCW, R, M), dt, cfg.radius)


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


def gid_rows(scene, n_ident: int):
    """``[n_ident + 1]``: the row of each gid among the scene's active
    rows, ``scene.n`` for a gid that is absent."""
    n, dev = scene.n, scene.device
    key = torch.where(scene.active & (scene.gid >= 0),
                      scene.gid.to(torch.int64), n_ident)
    row_of = torch.full((n_ident + 1,), n, dtype=torch.int64, device=dev)
    row_of = row_of.scatter(0, key, torch.arange(n, device=dev))
    return torch.cat([row_of[:n_ident], row_of.new_full((1,), n)])


def dem_pack(scene, cfg: CellGridConfig, plain: bool = False):
    """``(grid, dfT [NC + 1, 13, M])``: the DEM source pack of ``cfg``'s
    grid at the scene's positions, row NC all sentinels.  The spill grid
    carries the 13 fields through its cell sort and expands them (K1;
    ``plain``: its plain version); the classic grid (one slot a cell,
    ``cfg.spill`` False) gathers them through ``slot2p`` (no K1), as
    ``contact_kernel.pack_classic`` does."""
    sent = torch.tensor(SENT, dtype=scene.dtype, device=scene.device)
    if not cfg.spill:
        grid = build_cell_grid(scene.x, scene.y, scene.z, scene.active, cfg)
        df = pack_fields(grid, cfg, dem_payload(scene), SENT)
        row = sent[None, :, None].expand(1, NF, cfg.M)
        return grid, torch.cat([df.transpose(1, 2), row], 0).contiguous()
    grid, pt = build_cell_grid_packed(scene.x, scene.y, scene.z,
                                      scene.active, cfg, dem_payload(scene))
    expand = expand_slots_reference if plain else expand_slots
    return grid, expand(pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)


def lvc_displacement_cell_kernel(scene, cfg: CellGridConfig, dt,
                                 tng_idx, tng_dem, tng_x, tng_y, tng_z,
                                 plain: bool = False,
                                 n_ident: int | None = None) -> DemPass:
    """The cell-grid pass (prune fused) on the spill grid (K1, K4) or
    the classic one (the pack gathered, K4; :func:`dem_pack`).  ``plain``
    runs K1's and K4's plain versions even on CUDA tensors (the reference
    on the card).

    ``n_ident``: the table entries are the partners' gids (below
    ``n_ident``; the slab step's tables), not their rows.  K4 reads and
    writes the table at the row its pack's index field names, so the
    index field stays the row: the entries go to rows before the pass (a
    partner absent from the scene to -1, freed as a separated pair) and
    back to gids after it, the table the reference's gid-keyed pass
    (``pallas_dem.py:467``) gives."""
    if n_ident is not None:
        row = gid_rows(scene, n_ident)[
            torch.clamp(tng_idx.to(torch.int64), 0, n_ident)]
        tng_idx = torch.where((tng_idx >= 0) & (row < scene.n), row,
                              -1).to(torch.int32)
    grid, dfT = dem_pack(scene, cfg, plain)
    sums_fn = dem_cell_sums_reference if plain else dem_cell_sums
    out = sums_fn(dfT, grid.nbr_slots, tng_idx, tng_dem, tng_x, tng_y,
                  tng_z, material_table(scene), dt, cfg)
    res = _pass(*out, grid.overflow, scene.dtype)
    if n_ident is None:
        return res
    idx = res.tng_idx
    gid = scene.gid[torch.clamp(idx.to(torch.int64), min=0)]
    return res._replace(tng_idx=torch.where(idx >= 0, gid, -1).to(
        torch.int32))


def lvc_displacement_rowwin_kernel(scene, cfg: RowWinConfig, dt,
                                   tng_idx, tng_dem, tng_x, tng_y, tng_z,
                                   plain: bool = False) -> DemPass:
    """The row-window pass (prune fused): the sources ride the window
    sort, one pack expansion, the kernel on the per-particle table."""
    grid, pt = build_row_window_grid(scene.x, scene.y, scene.z,
                                     scene.active, cfg, dem_payload(scene))
    sent = torch.tensor(SENT, dtype=scene.dtype, device=scene.device)
    expand = expand_slots_reference if plain else expand_slots
    sums_fn = dem_rowwin_sums_reference if plain else dem_rowwin_sums
    dfs = expand(pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)
    out = sums_fn(dfs, grid.nbr_runs, grid.run_cnt, tng_idx, tng_dem, tng_x,
                  tng_y, tng_z, material_table(scene), dt, cfg)
    return _pass(*out, grid.overflow, scene.dtype)


def lvc_force_pass(scene, cfg: CellGridConfig, dt, kn: float, mu: float,
                   en: float, tng_idx, tng_dem, tng_fx, tng_fy,
                   tng_fz) -> DemPass:
    """The LVCForce pass (the reference package's cell-engine branch):
    the table pruned on the scene's positions, a grid build on ``cfg``
    and :func:`dem_cell.lvc_force_cell`.  The pass's ``tng_x/y/z`` are
    the tangential-force springs."""
    pruned = prune_contact_table(scene, tng_idx, tng_dem, tng_fx, tng_fy,
                                 tng_fz)[:5]
    grid = build_cell_grid(scene.x, scene.y, scene.z, scene.active, cfg)
    out = lvc_force_cell(scene, grid, cfg, dt, kn, mu, en, *pruned)
    return _pass(*out, grid.overflow, scene.dtype)
