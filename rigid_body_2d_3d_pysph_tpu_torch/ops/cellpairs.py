"""The spill cell grid: particles binned into a bounded grid, sorted by
cell, and laid out as dense slots of M lanes.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/cellpairs.py`` (spill
layout only, which is what ``config_from_positions`` picks for the
rigid-contact scheme in 2D and 3D).  A cell holding more than M
particles takes ceil(count/M) consecutive slots; each slot's stencil
row lists the slot runs of its cell's 9 (2D) or 27 (3D) neighbour cells,
packed into ``cfg.O`` entries (``NC_max`` = no neighbour).

The build is sorts and scans (``torch.sort(stable=True)``, ``cumsum``,
``cummax``): the lane order inside a cell is the stable order of the
particle index, exactly as the reference's stable ``lax.sort``, and the
stencil order is the reference's, so lane order (which decides
closest-source ties) is identical on both sides.

Index tensors are int64 (PyTorch's indexing type), and the kernels read
them as int64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch


@dataclass(frozen=True)
class CellGridConfig:
    cell: float                  # bin size ((cutoff + skin) / sub)
    M: int                       # dense-slot lane width
    NC_max: int                  # max occupied slots
    origin: tuple                # grid AABB min corner (3,)
    dims: tuple                  # cells per axis (3,), z = 1 in 2D
    dim: int = 2
    cell_chunk: int = 512        # cells per chunk of the setup-time passes
    cutoff: float = 0.0          # interaction radius (defaults to cell)
    sub: int = 1                 # bins per cutoff (stencil radius)
    skin: float = 0.0            # Verlet skin: the grid is rebuilt only
    #                              when a particle has moved > skin / 2
    spill: bool = False          # slot spillover layout
    nbr_width: int = 0           # packed stencil-slot table width
    max_spill: int = 4           # max slots per cell

    @property
    def O(self) -> int:
        return self.nbr_width if (self.spill and self.nbr_width) \
            else len(self.stencil)

    @property
    def radius(self) -> float:
        return self.cutoff if self.cutoff > 0 else self.cell

    @property
    def stencil(self):
        r = tuple(range(-self.sub, self.sub + 1))
        if self.dim == 2:
            return tuple((dx, dy, 0) for dx in r for dy in r)
        return tuple((dx, dy, dz) for dx in r for dy in r for dz in r)

    @property
    def n_cells_total(self) -> int:
        return int(np.prod(self.dims))


def config_from_positions(x, y, z, cutoff: float, dim: int,
                          cell_chunk: int = 512,
                          capacity_boost: float = 1.0,
                          cell_factor: float = 1.0,
                          M: int = 16, skin: float = 0.0) -> CellGridConfig:
    """Host-side (numpy): the spill grid for these positions, as the
    reference's ``config_from_positions`` builds it in spill mode
    (stencil radius 1).  Bins are ``cell_factor`` x (the cutoff + the
    Verlet ``skin``: a grid built at some positions holds every pair
    within the cutoff until a particle has moved skin / 2; the DEM
    grid's bins are coarser than its contact radius) and hold ``M``
    lanes per slot.  The domain is the initial bounding box widened by
    0.75 x its extent; the slot capacity is 1.6 x the occupied slots and
    the packed stencil width 1.6 x the worst initial stencil of those
    bins, every slack scaled by ``capacity_boost`` (the overflow-rebuild
    rule raises it)."""
    slack = 0.75 * capacity_boost
    nc_factor = 1.6 * capacity_boost
    sub = 1
    cell = float(cell_factor) * (float(cutoff) + float(skin))
    x = np.asarray(x); y = np.asarray(y); z = np.asarray(z)
    pts = [x, y] + ([z] if dim == 3 else [])
    lo = np.array([p.min() for p in pts])
    hi = np.array([p.max() for p in pts])
    ext = np.maximum(hi - lo, cell)
    lo = lo - slack * ext - 2 * cutoff
    hi = hi + slack * ext + 2 * cutoff
    dims = [int(np.ceil((hi[i] - lo[i]) / cell)) + 2 * sub
            for i in range(len(lo))]
    if dim == 2:
        origin = (float(lo[0]), float(lo[1]), 0.0)
        dims = (dims[0], dims[1], 1)
    else:
        origin = (float(lo[0]), float(lo[1]), float(lo[2]))
        dims = (dims[0], dims[1], dims[2])

    cells = np.floor((np.stack([x, y, z], -1)
                      - np.array(origin)) / cell).astype(np.int64)
    if dim == 2:
        cells[:, 2] = 0
    uniq, counts = np.unique(cells, axis=0, return_counts=True)
    nsl = -(-counts // M)
    NC_max = max(64, int(np.ceil(nsl.sum() * nc_factor)))
    occmap = {tuple(c): int(s) for c, s in zip(uniq, nsl)}
    r = range(-sub, sub + 1)
    worst = 0
    for c in map(tuple, uniq):
        s = sum(occmap.get((c[0] + i, c[1] + j, c[2] + k), 0)
                for i in r for j in r for k in (r if dim == 3 else (0,)))
        worst = max(worst, s)
    O_p = max(len(r) ** dim, int(np.ceil(worst * 1.6 * capacity_boost)))
    # the reference rounds O*M up to its 128-lane tile; kept so both
    # sides build the same table width
    lane_q = max(1, 128 // M)
    O_p = -(-O_p // lane_q) * lane_q
    return CellGridConfig(cell=cell, M=int(M), NC_max=NC_max, origin=origin,
                          dims=dims, dim=dim, cell_chunk=cell_chunk,
                          cutoff=float(cutoff), sub=sub, skin=float(skin),
                          spill=True, nbr_width=int(O_p))


class CellGrid(NamedTuple):
    slot2p: torch.Tensor     # [NC_max * M] particle per lane (n = empty)
    dense_pos: torch.Tensor  # [N] lane of each particle (NC_max*M = none)
    nbr_slots: torch.Tensor  # [NC_max, O] neighbour slots (NC_max = none)
    n_occupied: torch.Tensor  # 0-d int64
    overflow: torch.Tensor   # 0-d bool


class PackTables(NamedTuple):
    """Sidecar of :func:`build_cell_grid_packed`: the pack fields in
    cell-sorted order plus the per-slot expansion tables of the pack
    kernel (slot s covers sorted rows ``[base[s], base[s] + cnt[s])``)."""
    sorted_fields: torch.Tensor  # [F, N] cell-sorted pack fields
    base: torch.Tensor           # [NC_max]
    cnt: torch.Tensor            # [NC_max] (0 for empty slots)
    n_valid: torch.Tensor        # 0-d: active in-domain particles
    slot_cid: torch.Tensor       # [NC_max] linear cell id (G = empty)
    sorted_pid: torch.Tensor     # [N] particle index per sorted row


def _check_spill(cfg: CellGridConfig):
    if not cfg.spill:
        raise ValueError("the port builds the spillover grid only "
                         "(cfg.spill=True)")


def _cell_keys(x, y, z, active, cfg: CellGridConfig):
    """Linear cell id per particle (G = out of domain / inactive)."""
    inv = 1.0 / cfg.cell
    ox, oy, oz = cfg.origin
    gx, gy, gz = cfg.dims
    cx = torch.floor((x - ox) * inv).to(torch.int64)
    cy = torch.floor((y - oy) * inv).to(torch.int64)
    cz = (torch.floor((z - oz) * inv).to(torch.int64)
          if cfg.dim == 3 else torch.zeros_like(cx))
    sb = cfg.sub
    in_dom = ((cx >= sb) & (cx < gx - sb) & (cy >= sb) & (cy < gy - sb)
              & (cz >= (sb if cfg.dim == 3 else 0))
              & (cz < (gz - sb if cfg.dim == 3 else 1)))
    dom_overflow = torch.any(active & ~in_dom)
    G = cfg.n_cells_total
    cid = cx + gx * (cy + gy * cz)
    key = torch.where(active & in_dom, cid, torch.full_like(cid, G))
    return key, dom_overflow, G


def _stencil_rows(table, qcells, stencil, dims, G, sentinel):
    """``table[q + off]`` for every stencil offset: [len(q), O]; rows of
    ``qcells == G`` come out all-sentinel."""
    gx, gy, gz = dims
    offs = [dx_ + gx * (dy_ + gy * dz_) for (dx_, dy_, dz_) in stencil]
    maxoff = max(abs(o) for o in offs)
    dev = table.device
    pad = torch.full((maxoff,), sentinel, dtype=table.dtype, device=dev)
    tp = torch.cat([pad, table, pad])
    off_t = torch.tensor(offs, dtype=torch.int64, device=dev)
    rows = tp[torch.clamp(qcells, 0, G - 1)[:, None] + off_t[None, :]
              + maxoff]
    return torch.where((qcells < G)[:, None], rows,
                       torch.full_like(rows, sentinel))


def _scatter_drop(size, fill, index, values, dtype):
    """``full(size, fill)`` with ``out[index] = values``; an index equal
    to ``size`` is dropped (it lands in a spare row that is cut off)."""
    out = torch.full((size + 1,), fill, dtype=dtype, device=index.device)
    out[index] = values.to(dtype)
    return out[:size]


def _sort_grid(x, y, z, active, cfg: CellGridConfig):
    n = x.shape[0]
    key, dom_overflow, G = _cell_keys(x, y, z, active, cfg)
    ks, order = torch.sort(key, stable=True)
    valid_s = ks < G
    head = valid_s & torch.cat(
        [torch.ones(1, dtype=torch.bool, device=x.device), ks[1:] != ks[:-1]])
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    return n, G, ks, order, valid_s, head, idx, dom_overflow


def build_cell_grid(x, y, z, active, cfg: CellGridConfig) -> CellGrid:
    """The spill grid with its slot2p / dense_pos maps (setup-time
    boundary identification packs and unpacks through them)."""
    _check_spill(cfg)
    grid, _ = _finish_spill_grid(cfg, *_sort_grid(x, y, z, active, cfg))
    return grid


def _finish_spill_grid(cfg: CellGridConfig, n, G, ks, order, valid_s,
                       head, idx, dom_overflow, want_pack: bool = False,
                       want_dense_pos: bool = False):
    """Slot runs, the packed stencil table and (``want_pack``) the
    per-slot expansion tables instead of the slot2p / dense_pos maps
    (``want_dense_pos`` keeps dense_pos beside them); mirrors the
    reference step by step."""
    M = cfg.M
    NC = cfg.NC_max
    O_p = cfg.O
    dev = ks.device
    i64 = torch.int64

    start = torch.cummax(torch.where(head, idx, torch.full_like(idx, -1)),
                         0).values
    rank = idx - start
    lane = rank % M
    subhead = valid_s & (lane == 0)
    vslot = torch.cumsum(subhead.to(i64), 0) - 1
    n_occ = torch.where(valid_s.any(), vslot[-1] + 1,
                        torch.zeros((), dtype=i64, device=dev))
    cap_overflow = n_occ > NC

    slot_ok = valid_s & (vslot < NC)
    dense_pos_sorted = torch.where(
        slot_ok, torch.clamp(vslot, 0, NC - 1) * M + lane,
        torch.full_like(vslot, NC * M))
    empty = torch.zeros((0,), dtype=i64, device=dev)
    slot2p = empty if want_pack else _scatter_drop(
        NC * M, n, dense_pos_sorted, order, i64)
    dense_pos = empty if want_pack and not want_dense_pos else _scatter_drop(
        n, NC * M, torch.where(slot_ok, order, torch.full_like(order, n)),
        dense_pos_sorted, i64)

    # occupied cells compacted to the front: (cid, base slot[, start])
    n_cells = head.to(i64).sum()
    key2 = torch.where(head, vslot, torch.full_like(vslot, 2 ** 30))
    _, perm = torch.sort(key2, stable=True)
    cid_c, base_c = ks[perm], vslot[perm]
    sst_c = idx[perm] if want_pack else None
    if n < NC:
        cid_c = torch.cat([cid_c, torch.full((NC - n,), G, dtype=i64,
                                             device=dev)])
        base_c = torch.cat([base_c, torch.zeros(NC - n, dtype=i64,
                                                device=dev)])
        if want_pack:
            sst_c = torch.cat([sst_c, torch.zeros(NC - n, dtype=i64,
                                                  device=dev)])
    iota_nc = torch.arange(NC, dtype=i64, device=dev)
    n_cells_c = torch.clamp(n_cells, max=NC)
    cellmask = iota_nc < n_cells_c
    occ_cid = torch.where(cellmask, cid_c[:NC], torch.full_like(iota_nc, G))
    occ_base = torch.where(cellmask, base_c[:NC],
                           torch.full_like(iota_nc, NC))
    zero1 = torch.zeros(1, dtype=i64, device=dev)
    base_ext = torch.cat([base_c[1:NC + 1], zero1])[:NC]
    base_nxt = torch.where(iota_nc + 1 < n_cells_c, base_ext,
                           n_occ.expand(NC))
    occ_nsl = torch.where(cellmask,
                          torch.clamp(base_nxt - occ_base, 0, 2 ** 10),
                          torch.zeros_like(iota_nc))
    spill_deep = torch.any(occ_nsl > cfg.max_spill)

    # cell id -> packed (base * SH + nslots) direct-address table
    SH = 32
    packed = _scatter_drop(G, NC * SH, occ_cid,
                           occ_base * SH + torch.clamp(occ_nsl, max=SH - 1),
                           i64)
    pv_all = _stencil_rows(packed, occ_cid, cfg.stencil, cfg.dims, G,
                           NC * SH)                       # [NC, O9]
    nb_base = pv_all // SH
    nb_nsl = pv_all % SH
    pos = torch.cumsum(nb_nsl, 1) - nb_nsl                # exclusive
    spill_ovf = torch.any(pos[:, -1] + nb_nsl[:, -1] > O_p)

    # slot runs into the packed row: entry pos[o] + j holds base[o] + j
    # (column O_p is a spare that absorbs masked and overflowing entries)
    j = torch.arange(cfg.max_spill, dtype=i64, device=dev)
    col = pos[:, :, None] + j
    m = (j < nb_nsl[:, :, None]) & (col < O_p)
    col = torch.where(m, col, torch.full_like(col, O_p))
    val = nb_base[:, :, None] + j
    tbl = torch.full((NC, O_p + 1), NC, dtype=i64, device=dev)
    tbl.scatter_(1, col.reshape(NC, -1), val.reshape(NC, -1))
    tbl = tbl[:, :O_p]

    def cell2slot_expand(vals):
        """Scatter per-cell values at their base slot, fill the run with
        cummax (valid for values nondecreasing over cells)."""
        e = _scatter_drop(NC, 0,
                          torch.where(cellmask, torch.clamp(occ_base, 0,
                                                            NC - 1),
                                      torch.full_like(occ_base, NC)),
                          vals, i64)
        return torch.cummax(e, 0).values

    s2c = cell2slot_expand(iota_nc)
    nbr_slots = tbl[s2c]                                  # [NC, O_p]
    grid = CellGrid(slot2p=slot2p, dense_pos=dense_pos,
                    nbr_slots=nbr_slots, n_occupied=n_occ,
                    overflow=(dom_overflow | cap_overflow | spill_ovf
                              | spill_deep))
    if not want_pack:
        return grid, None

    n_valid = valid_s.to(i64).sum()
    occ_sst = torch.where(cellmask, sst_c[:NC], torch.zeros_like(iota_nc))
    sst_ext = torch.cat([sst_c[1:NC + 1], zero1])[:NC]
    cell_end = torch.where(iota_nc + 1 < n_cells_c, sst_ext,
                           n_valid.expand(NC))
    negA = cell2slot_expand(M * occ_base - occ_sst)
    end_s = cell2slot_expand(cell_end)
    base_slot = M * iota_nc - negA
    valid_slot = iota_nc < torch.clamp(n_occ, max=NC)
    cnt_slot = torch.clamp(end_s - base_slot, 0, M)
    base_slot = torch.where(valid_slot, base_slot, n_valid.expand(NC))
    cnt_slot = torch.where(valid_slot, cnt_slot, torch.zeros_like(cnt_slot))
    slot_cid = torch.where(valid_slot, cell2slot_expand(occ_cid),
                           torch.full_like(iota_nc, G))
    return grid, (base_slot, cnt_slot, n_valid, slot_cid)


def build_cell_grid_packed(x, y, z, active, cfg: CellGridConfig, payload,
                           want_dense_pos: bool = False):
    """Spill grid build that carries ``payload`` (a list of [N] tensors
    of one floating dtype) into cell-sorted order with the sort's
    permutation: returns ``(CellGrid, PackTables)``; ``slot2p`` is
    empty, and ``dense_pos`` too unless ``want_dense_pos`` (the
    coupling step unpacks its dense outputs through it)."""
    _check_spill(cfg)
    n, G, ks, order, valid_s, head, idx, dom_overflow = _sort_grid(
        x, y, z, active, cfg)
    sorted_fields = torch.stack(list(payload), 0).index_select(1, order)
    grid, pack = _finish_spill_grid(cfg, n, G, ks, order, valid_s, head,
                                    idx, dom_overflow, want_pack=True,
                                    want_dense_pos=want_dense_pos)
    base, cnt, n_valid, slot_cid = pack
    return grid, PackTables(sorted_fields=sorted_fields.contiguous(),
                            base=base, cnt=cnt, n_valid=n_valid,
                            slot_cid=slot_cid, sorted_pid=order)


# ---------------------------------------------------------------------------
# gather-packing for the setup-time passes
# ---------------------------------------------------------------------------

def pack_fields(grid: CellGrid, cfg: CellGridConfig, fields, sentinels):
    """Per-particle [N] tensors -> dense [NC_max, M, F] (empty lanes hold
    the per-field sentinel)."""
    stacked = torch.stack(list(fields), -1)
    pad = torch.tensor(sentinels, dtype=stacked.dtype,
                       device=stacked.device)[None, :]
    ext = torch.cat([stacked, pad], 0)
    return ext[grid.slot2p].reshape(cfg.NC_max, cfg.M, len(fields))


def pack_rows(grid: CellGrid, cfg: CellGridConfig, arr, sentinel=0.0):
    """Per-particle [N, R] -> dense [NC_max, M, R] (empty lanes hold
    ``sentinel``)."""
    pad = torch.full((1, arr.shape[1]), sentinel, dtype=arr.dtype,
                     device=arr.device)
    return torch.cat([arr, pad], 0)[grid.slot2p].reshape(
        cfg.NC_max, cfg.M, arr.shape[1])


def unpack(grid: CellGrid, cfg: CellGridConfig, dense, n: int, fill=0.0):
    """Dense [NC_max, M, ...] -> per-particle [N, ...] (original order);
    particles without a lane get ``fill``."""
    flat = dense.reshape((cfg.NC_max * cfg.M,) + tuple(dense.shape[2:]))
    pad = torch.full((1,) + tuple(flat.shape[1:]), fill, dtype=flat.dtype,
                     device=flat.device)
    return torch.cat([flat, pad], 0)[grid.dense_pos]


class LaneMap(NamedTuple):
    """Both directions between a grid's lanes and its particles, for the
    kernels that write per-particle rows straight from their slots."""
    lane_pid: torch.Tensor   # [NC_max * M] particle per lane (n = empty)
    dense_pos: torch.Tensor  # [n] lane of each particle (NC_max * M = none)
    n: int


def lane_map(grid: CellGrid, cfg: CellGridConfig, n: int) -> LaneMap:
    """The :class:`LaneMap` of ``grid`` (which keeps ``dense_pos``): its
    ``slot2p`` where the build kept it, else ``dense_pos`` inverted."""
    NCM = cfg.NC_max * cfg.M
    if grid.slot2p.numel() == NCM:
        return LaneMap(grid.slot2p, grid.dense_pos, n)
    dp = grid.dense_pos
    pid = _scatter_drop(NCM, n, dp, torch.arange(n, device=dp.device),
                        torch.int64)
    return LaneMap(pid, dp, n)


def gather_source_block(dense, nbr_slots_block, cfg: CellGridConfig,
                        sentinel_row):
    """[NC_max, M, F] sources for a block of slots: [C, O, M, F];
    missing neighbours (== NC_max) read ``sentinel_row``."""
    sent = torch.as_tensor(sentinel_row, dtype=dense.dtype,
                           device=dense.device)
    sent = torch.broadcast_to(sent, dense.shape[1:])[None]
    ext = torch.cat([dense, sent], 0)
    return ext[torch.clamp(nbr_slots_block, max=cfg.NC_max)]


def map_over_cells(cfg: CellGridConfig, fn, *dense_args):
    """``fn(*blocks)`` over chunks of ``cfg.cell_chunk`` slots,
    concatenated along the slot axis (bounds the pair tensors' memory)."""
    C = cfg.cell_chunk
    outs = []
    for s in range(0, cfg.NC_max, C):
        outs.append(fn(*[a[s:s + C] for a in dense_args]))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o, 0) for o in zip(*outs))
    return torch.cat(outs, 0)
