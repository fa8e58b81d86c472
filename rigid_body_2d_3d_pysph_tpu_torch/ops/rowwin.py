"""Row-window grid: sorted M-particle windows with per-row slot runs.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/rowwin.py``.  Slots are
consecutive windows of the cell-sorted order, split at row boundaries
(a row is one y-bin in 2D, one (y, z)-bin in 3D), so every window holds
up to M consecutive sorted particles of one row.  A window's candidate
sources are, for each of the R = 3 (2D) / 9 (3D) neighbour rows, the
contiguous sorted run of positions whose cell-x lies within one bin of
the window's own x-span, stored as ``run_cnt`` consecutive window slots
from ``nbr_runs``.  Bins equal the cutoff.

The build is a stable ``torch.sort`` of the cell key, one gather of the
payload, cumsum / cummax scans, scatters at unique targets and binary
searches of the sorted keys (where the reference builds a table over
every bin of the domain); the ``PackTables`` it returns feed the port's
pack expansion (``ops/pack_expand.py``) unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .cellpairs import PackTables, _cell_keys, _scatter_drop


@dataclass(frozen=True)
class RowWinConfig:
    cell: float                 # bin size (== cutoff)
    M: int                      # window width
    NC_max: int                 # window capacity: ceil(n/M) + rows + 1
    origin: tuple               # grid AABB min corner (3,)
    dims: tuple                 # cells per axis, gz = 1 in 2D
    dim: int = 2
    cutoff: float = 0.0
    max_run: int = 4            # slots per neighbour-row run
    sub: int = 1                # stencil radius (for _cell_keys; always 1)
    cell_chunk: int = 512       # windows per chunk of the plain pair pass

    @property
    def R(self) -> int:
        return 3 if self.dim == 2 else 9

    @property
    def radius(self) -> float:
        return self.cutoff if self.cutoff > 0 else self.cell

    @property
    def n_cells_total(self) -> int:
        return int(np.prod(self.dims))


class RowWinGrid(NamedTuple):
    nbr_runs: torch.Tensor   # [NC_max, R] first slot of each row run
    run_cnt: torch.Tensor    # [NC_max, R] slots in each run (<= max_run)
    dense_pos: torch.Tensor  # [N] window * M + lane (NC_max * M = none)
    n_occupied: torch.Tensor  # 0-d: windows
    overflow: torch.Tensor   # 0-d bool: domain exit or run > max_run


def rowwin_config_from_positions(x, y, z, cutoff: float, dim: int,
                                 M: int = 8, slack: float = 0.35,
                                 max_run: int | None = None,
                                 capacity_boost: float = 1.0
                                 ) -> RowWinConfig:
    """Host-side sizing.  ``max_run`` defaults to 1.5 x the worst initial
    run length, scaled by ``capacity_boost``."""
    cell = float(cutoff)
    x = np.asarray(x); y = np.asarray(y); z = np.asarray(z)
    pts = [x, y] + ([z] if dim == 3 else [])
    lo = np.array([p.min() for p in pts])
    hi = np.array([p.max() for p in pts])
    ext = np.maximum(hi - lo, cell)
    lo = lo - slack * ext - 2 * cell
    hi = hi + slack * ext + 2 * cell
    dims = [int(np.ceil((hi[i] - lo[i]) / cell)) + 2 for i in range(len(lo))]
    if dim == 2:
        origin = (float(lo[0]), float(lo[1]), 0.0)
        dims = (dims[0], dims[1], 1)
    else:
        origin = (float(lo[0]), float(lo[1]), float(lo[2]))
        dims = (dims[0], dims[1], dims[2])
    n = x.shape[0]
    NCW = -(-n // M) + int(dims[1]) * int(dims[2]) + 1
    cfg = RowWinConfig(cell=cell, M=M, NC_max=NCW, origin=origin,
                       dims=dims, dim=dim, cutoff=float(cutoff),
                       max_run=8)
    if max_run is None:
        worst = _worst_run_np(x, y, z, cfg)
        max_run = max(2, int(np.ceil(worst * 1.5 * capacity_boost)))
    return RowWinConfig(cell=cell, M=M, NC_max=NCW, origin=origin,
                        dims=dims, dim=dim, cutoff=float(cutoff),
                        max_run=int(max_run))


def _np_windows(x, y, z, cfg: RowWinConfig):
    """Numpy version of the window / run layout (config sizing, tests).
    Returns (order, wbase, wcnt, wrow, wcxa, wcxb, runs[(w, r, sa, sb)])."""
    gx, gy, gz = cfg.dims
    ox, oy, oz = cfg.origin
    cx = np.floor((np.asarray(x) - ox) / cfg.cell).astype(np.int64)
    cy = np.floor((np.asarray(y) - oy) / cfg.cell).astype(np.int64)
    cz = (np.floor((np.asarray(z) - oz) / cfg.cell).astype(np.int64)
          if cfg.dim == 3 else np.zeros_like(cx))
    key = cx + gx * (cy + gy * cz)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    rowid = ks // gx
    kx = ks % gx
    M = cfg.M
    wbase, wcnt, wrow, wcxa, wcxb = [], [], [], [], []
    i = 0
    n = len(ks)
    while i < n:
        j = i
        while j < n and rowid[j] == rowid[i] and j - i < M:
            j += 1
        wbase.append(i); wcnt.append(j - i); wrow.append(rowid[i])
        wcxa.append(kx[i]); wcxb.append(kx[j - 1])
        i = j
    runs = []
    offsets = ([(dy, 0) for dy in (-1, 0, 1)] if cfg.dim == 2 else
               [(dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)])
    for w in range(len(wbase)):
        for (dy, dz) in offsets:
            r = wrow[w] + dy + gy * dz
            clo = r * gx + wcxa[w] - 1
            chi = r * gx + wcxb[w] + 2
            lo = np.searchsorted(ks, clo, side="left")
            hi = np.searchsorted(ks, chi, side="left")
            if hi <= lo:
                continue
            fp = np.searchsorted(ks, r * gx, side="left")
            wf = np.searchsorted(wbase, fp, side="left")
            sa = wf + (lo - fp) // M
            sb = wf + (hi - 1 - fp) // M + 1
            runs.append((w, r, sa, sb))
    return order, wbase, wcnt, wrow, wcxa, wcxb, runs


def _worst_run_np(x, y, z, cfg: RowWinConfig) -> int:
    runs = _np_windows(x, y, z, cfg)[6]
    return max((sb - sa for (_w, _r, sa, sb) in runs), default=1)


def build_row_window_grid(x, y, z, active, cfg: RowWinConfig, payload):
    """Sort by cell (the payload, a list of [N] tensors of one floating
    dtype, follows the sort's permutation), split the row windows and
    build the per-window run table.  Returns ``(RowWinGrid,
    PackTables)``."""
    n = x.shape[0]
    gx, gy, gz = cfg.dims
    M = cfg.M
    NCW = cfg.NC_max
    dev = x.device
    i64 = torch.int64
    key, dom_overflow, G = _cell_keys(x, y, z, active, cfg)

    ks, order = torch.sort(key, stable=True)
    sorted_fields = torch.stack(list(payload), 0).index_select(1, order)
    idx = torch.arange(n, dtype=i64, device=dev)
    valid = ks < G
    n_valid = valid.to(i64).sum()

    rowid = ks // gx
    first = torch.ones(1, dtype=torch.bool, device=dev)
    headr = valid & torch.cat([first, rowid[1:] != rowid[:-1]])
    rstart = torch.cummax(torch.where(headr, idx, -1), 0).values
    lane = (idx - rstart) % M
    subhead = valid & (lane == 0)
    win = torch.cumsum(subhead.to(i64), 0) - 1
    n_occ = torch.where(valid.any(), win[-1] + 1,
                        torch.zeros((), dtype=i64, device=dev))

    # particle -> window * M + lane, back to particle order
    flat = torch.where(valid & (win < NCW), win * M + lane,
                       torch.full_like(win, NCW * M))
    dense_pos = torch.empty(n, dtype=i64, device=dev)
    dense_pos[order] = flat

    # per-window tables, scattered at the window heads
    iw = torch.arange(NCW, dtype=i64, device=dev)
    wvalid = iw < torch.clamp(n_occ, max=NCW)
    tgt = torch.where(subhead, win, torch.full_like(win, NCW))
    wcid_f = _scatter_drop(NCW, G, tgt, ks, i64)
    wpos_f = _scatter_drop(NCW, 0, tgt, idx, i64)
    wbase = torch.where(wvalid, wpos_f, n_valid.expand(NCW))
    wnext = torch.cat([wbase[1:], n_valid[None]])
    wcnt = torch.clamp(torch.where(wvalid, wnext - wbase,
                                   torch.zeros_like(wbase)), 0, M)
    wrow = wcid_f // gx
    wcxa = wcid_f - wrow * gx
    lastp = torch.clamp(wbase + wcnt - 1, 0, n - 1)
    kl = ks[lastp]
    wcxb = torch.where(wvalid, kl - (kl // gx) * gx, wcxa)

    # P(c) = first sorted position with cell id >= c, a binary search of
    # the sorted keys (the inactive tail holds key G, so P(G) = n_valid)
    def P(c):
        return torch.searchsorted(ks, c)

    # runs: per neighbour row, the sorted band [(r, cxa - 1), (r, cxb + 2))
    # mapped to window slots of that row
    offsets = ([dy for dy in (-1, 0, 1)] if cfg.dim == 2 else
               [dy + gy * dz for dz in (-1, 0, 1) for dy in (-1, 0, 1)])
    sent = torch.clamp(n_occ, max=NCW)      # the all-sentinel window row
    run_sa, run_ct = [], []
    run_ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for off in offsets:
        r = wrow + off
        clo = torch.clamp(r * gx + wcxa - 1, 0, G)
        chi = torch.clamp(r * gx + wcxb + 2, 0, G)
        lo, hi = P(clo), P(chi)
        fp = P(torch.clamp(r * gx, 0, G))
        wf = win[torch.clamp(fp, 0, n - 1)]
        nonempty = wvalid & (hi > lo)
        sa = wf + torch.div(lo - fp, M, rounding_mode="floor")
        nsl = (torch.div(hi - 1 - fp, M, rounding_mode="floor") + 1
               - torch.div(lo - fp, M, rounding_mode="floor"))
        run_ovf = run_ovf | (nonempty & (nsl > cfg.max_run)).any()
        run_sa.append(torch.where(nonempty, sa, sent))
        run_ct.append(torch.where(nonempty,
                                  torch.clamp(nsl, max=cfg.max_run),
                                  torch.zeros_like(nsl)))
    grid = RowWinGrid(nbr_runs=torch.stack(run_sa, 1),
                      run_cnt=torch.stack(run_ct, 1),
                      dense_pos=dense_pos, n_occupied=n_occ,
                      overflow=dom_overflow | run_ovf)
    pt = PackTables(sorted_fields=sorted_fields.contiguous(), base=wbase,
                    cnt=wcnt, n_valid=n_valid,
                    slot_cid=torch.where(wvalid, wcid_f,
                                         torch.full_like(wcid_f, G)),
                    sorted_pid=order)
    return grid, pt
