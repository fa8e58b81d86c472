"""Fixed-capacity hash-grid neighbour search: the ``[N, K]`` list engine.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/neighbors.py``, and the
same list bit for bit (``idx``, ``mask``, ``n_neighbors``, ``overflow``,
in the same column order):

1. cell coordinates ``floor(x * (1 / cutoff))`` (a multiply by the
   reciprocal, so a particle on a cell face lands where the reference's
   lands), hashed into a power-of-two bucket space;
2. a stable sort of the particles by bucket key (inactive particles get
   the key ``n_buckets`` and sort last);
3. per particle, the 9 (2D) or 27 (3D) stencil cells found by a binary
   search of the sorted keys;
4. candidates verified by their exact cell coordinates (a hash collision
   makes no false pair) and by distance <= cutoff;
5. the padded ``[N, O * M]`` candidate list (default), or with
   ``compact=True`` the first K hits of each row packed into ``[N, K]``.

The list includes the particle itself; inactive particles have no
neighbours and appear in no list.  ``overflow`` reports a stencil cell
holding more than M candidates (or, compact, a row with more than K
hits), so the Solver re-sizes the list instead of dropping pairs.  Rows are
built ``row_chunk`` at a time, which bounds the memory of the
``[C, O, M]`` candidate tensors.

The hash multiplies the 32-bit two's-complement cell coordinates by three
32-bit constants modulo 2^32 and masks to ``n_buckets``.  PyTorch has no
full ``uint32`` arithmetic; the masked hash depends only on the low
log2(n_buckets) bits of each operand, so it is computed in ``int64`` on
the operands masked to those bits (each product < 2^62), which gives the
same bits on every device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

_H1 = 0x8DA6B343
_H2 = 0xD8163841
_H3 = 0xCB1AB31F


class NeighborList(NamedTuple):
    idx: torch.Tensor          # [N, K] int32 neighbour indices (self too)
    mask: torch.Tensor         # [N, K] bool
    n_neighbors: torch.Tensor  # [N] int32
    overflow: torch.Tensor     # 0-d bool


@dataclass(frozen=True)
class NeighborConfig:
    cutoff: float           # interaction radius == cell size
    max_neighbors: int      # K (compact mode only)
    max_per_cell: int       # M: candidate cap per stencil cell
    dim: int = 3
    n_buckets: int = 1 << 16  # power of two
    row_chunk: int = 4096   # rows built at a time (memory bound)
    # compact=True packs the hits into [N, K] by a positional scatter;
    # the default keeps the padded [N, stencil * M] candidate list
    compact: bool = False

    @property
    def stencil(self):
        r = (-1, 0, 1)
        if self.dim == 2:
            return tuple((dx, dy, 0) for dx in r for dy in r)
        return tuple((dx, dy, dz) for dx in r for dy in r for dz in r)


def _hash_cells(cx, cy, cz, n_buckets: int):
    """``(cx H1 + cy H2 + cz H3 mod 2^32) & (n_buckets - 1)`` on int64."""
    if n_buckets & (n_buckets - 1) or not 0 < n_buckets <= 1 << 31:
        raise ValueError(f"n_buckets={n_buckets}: a power of two <= 2^31")
    mask = n_buckets - 1
    k = ((cx & mask) * (_H1 & mask)) & mask
    k = (k + (((cy & mask) * (_H2 & mask)) & mask)) & mask
    return (k + (((cz & mask) * (_H3 & mask)) & mask)) & mask


def default_config(dim: int, cutoff: float, n: int,
                   max_neighbors: int | None = None,
                   max_per_cell: int | None = None) -> NeighborConfig:
    """Heuristic capacities; size from measured occupancy with
    :func:`estimate_capacities` where possible."""
    if max_per_cell is None:
        max_per_cell = 48 if dim == 2 else 96
    if max_neighbors is None:
        max_neighbors = 96 if dim == 2 else 160
    n_buckets = 1 << max(10, int(np.ceil(np.log2(max(2 * n, 2)))))
    return NeighborConfig(
        cutoff=float(cutoff),
        max_neighbors=int(max_neighbors),
        max_per_cell=int(max_per_cell),
        dim=dim,
        n_buckets=n_buckets,
    )


def estimate_capacities(x, y, z, cutoff: float, dim: int,
                        safety: float = 1.7) -> tuple[int, int]:
    """Host-side (numpy): the occupancy of the positions' cells and the
    (max_per_cell, max_neighbors) it calls for, with headroom."""
    pos = np.stack([x, y, z if dim == 3 else np.zeros_like(x)], -1)
    cells = np.floor(pos / cutoff).astype(np.int64)
    _, counts = np.unique(cells, axis=0, return_counts=True)
    m = int(np.ceil(counts.max() * safety)) + 2
    k_est = int(np.ceil(counts.max() * (9 if dim == 2 else 27) * 0.6 * safety))
    return m, max(k_est, 16)


def build_neighbors(x, y, z, active, cfg: NeighborConfig) -> NeighborList:
    """The neighbour list of the positions ``x, y, z`` [N] (``active``
    [N] bool) on ``cfg``."""
    n = x.shape[0]
    dev = x.device
    inv = 1.0 / cfg.cutoff
    cx = torch.floor(x * inv).to(torch.int32).to(torch.int64)
    cy = torch.floor(y * inv).to(torch.int32).to(torch.int64)
    cz = (torch.floor(z * inv).to(torch.int32).to(torch.int64)
          if cfg.dim == 3 else torch.zeros_like(cx))

    key = _hash_cells(cx, cy, cz, cfg.n_buckets)
    # inactive particles sort to the very end with an out-of-range key
    key = torch.where(active, key, torch.full_like(key, cfg.n_buckets))
    order = torch.argsort(key, stable=True)
    skey = key[order]
    scx, scy, scz = cx[order], cy[order], cz[order]

    # the stencil's offsets, made on the device (a host copy would wait
    # for the stream): (dx, dy, dz) with dz fastest, as ``cfg.stencil``
    r = torch.arange(-1, 2, device=dev)
    axes = (r, r, torch.zeros(1, dtype=r.dtype, device=dev)) \
        if cfg.dim == 2 else (r, r, r)
    offsets = torch.stack([a.reshape(-1) for a in torch.meshgrid(
        *axes, indexing="ij")], 1)
    n_off = offsets.shape[0]
    M, K = cfg.max_per_cell, cfg.max_neighbors
    arange_m = torch.arange(M, device=dev)
    r2max = cfg.cutoff * cfg.cutoff

    idx_parts, mask_parts, cnt_parts = [], [], []
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for s in range(0, n, cfg.row_chunk):
        rows = torch.arange(s, min(s + cfg.row_chunk, n), device=dev)
        C = rows.shape[0]
        bx, by, bz = cx[rows], cy[rows], cz[rows]
        # stencil cells of this block: [C, O]
        qx = bx[:, None] + offsets[None, :, 0]
        qy = by[:, None] + offsets[None, :, 1]
        qz = bz[:, None] + offsets[None, :, 2]
        qkey = _hash_cells(qx, qy, qz, cfg.n_buckets)
        lo = torch.searchsorted(skey, qkey.reshape(-1)).reshape(qkey.shape)
        hi = torch.searchsorted(skey, qkey.reshape(-1),
                                right=True).reshape(qkey.shape)
        cell_overflow = torch.any(hi - lo > M)

        # candidate slots [C, O, M] in sorted space
        slots = lo[..., None] + arange_m
        valid = slots < hi[..., None]
        slots = torch.clamp(slots, max=n - 1)
        cell_match = ((scx[slots] == qx[..., None])
                      & (scy[slots] == qy[..., None]))
        if cfg.dim == 3:
            cell_match &= scz[slots] == qz[..., None]

        cand = order[slots]                    # original indices
        dx = x[cand] - x[rows][:, None, None]
        dy = y[cand] - y[rows][:, None, None]
        dz = z[cand] - z[rows][:, None, None]
        r2 = dx * dx + dy * dy + dz * dz
        ok = (valid & cell_match & (r2 <= r2max) & active[cand]
              & active[rows][:, None, None])

        ok_f = ok.reshape(C, n_off * M)
        cand_f = cand.reshape(C, n_off * M).to(torch.int32)
        count = ok_f.sum(1).to(torch.int32)
        if cfg.compact:
            # compact [C, O*M] -> [C, K] by a positional scatter; column K
            # is the scratch column of the pairs that are not written
            pos_in_row = torch.cumsum(ok_f.to(torch.int32), 1) - 1
            cell_overflow = cell_overflow | torch.any(count > K)
            write = ok_f & (pos_in_row < K)
            dst = torch.where(write, pos_in_row,
                              torch.full_like(pos_in_row, K)).to(torch.int64)
            out_idx = torch.zeros((C, K + 1), dtype=torch.int32, device=dev)
            out_mask = torch.zeros((C, K + 1), dtype=torch.bool, device=dev)
            cand_f = out_idx.scatter_(1, dst, cand_f)[:, :K]
            ok_f = out_mask.scatter_(1, dst, write)[:, :K]
            count = torch.clamp(count, max=K)
        idx_parts.append(cand_f)
        mask_parts.append(ok_f)
        cnt_parts.append(count)
        overflow = overflow | cell_overflow
    return NeighborList(idx=torch.cat(idx_parts), mask=torch.cat(mask_parts),
                        n_neighbors=torch.cat(cnt_parts), overflow=overflow)


def brute_force_neighbors(x, y, z, active, cutoff: float,
                          max_neighbors: int) -> NeighborList:
    """The O(N^2) list: the tests' oracle (and tiny scenes)."""
    n = x.shape[0]
    dev = x.device
    pos = torch.stack([x, y, z], -1)
    d2 = torch.sum((pos[:, None, :] - pos[None, :, :]) ** 2, -1)
    ok = (d2 <= cutoff * cutoff) & active[None, :] & active[:, None]
    pos_in_row = torch.cumsum(ok.to(torch.int32), 1) - 1
    count = pos_in_row[:, -1] + 1
    K = max_neighbors
    write = ok & (pos_in_row < K)
    dst = torch.where(write, pos_in_row,
                      torch.full_like(pos_in_row, K)).to(torch.int64)
    cand = torch.arange(n, dtype=torch.int32, device=dev).expand(n, n)
    idx = torch.zeros((n, K + 1), dtype=torch.int32, device=dev).scatter_(
        1, dst, cand)[:, :K]
    mask = torch.zeros((n, K + 1), dtype=torch.bool, device=dev).scatter_(
        1, dst, write)[:, :K]
    return NeighborList(idx=idx, mask=mask,
                        n_neighbors=torch.clamp(count, max=K).to(torch.int32),
                        overflow=torch.any(count > K))
