"""Setup-time surface identification on the cell grid (either layout).

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/boundary_cell.py``: the
same three passes (raw SPH normals with the 0.25/h acceptance,
kernel-weighted smoothing, the cos-angle interior filter), each over
chunks of cell slots with dense [C, M, O*M] pair tensors.  It runs once
per scene, so it is plain PyTorch; the JAX side has no kernel here
either.
"""

from __future__ import annotations

import torch

from .cellpairs import (CellGrid, CellGridConfig, gather_source_block,
                        map_over_cells, pack_fields, unpack)
from .ieee import sqrt

_BIG = 1.0e9
_BX, _BY, _BZ, _BM, _BRHO, _BH, _BGRP = range(7)
_SENT = [_BIG, _BIG, _BIG, 0.0, 1.0, 1.0, -1.0]


def _geom(qf, sf):
    C, O, M, F = sf.shape
    s = sf.reshape(C, 1, O * M, F)
    q = qf[:, :, None, :]
    xij = q[..., _BX] - s[..., _BX]
    yij = q[..., _BY] - s[..., _BY]
    zij = q[..., _BZ] - s[..., _BZ]
    rij = sqrt(xij**2 + yij**2 + zij**2)
    hij = 0.5 * (q[..., _BH] + s[..., _BH])
    return s, q, xij, yij, zij, rij, hij


def _normalize(v, keep_above):
    mag = torch.linalg.vector_norm(v, dim=-1)
    keep = mag > keep_above
    inv = torch.where(keep, 1.0 / torch.clamp(mag, min=1e-300),
                      torch.zeros_like(mag))
    return v * inv[..., None]


def boundary_identification_cell(scene, grid: CellGrid,
                                 cfg: CellGridConfig, kernel, group_sel):
    """(normal [N, 3], is_boundary [N] int32) for particles with
    ``group_sel >= 0``; each group identifies against itself."""
    df = pack_fields(grid, cfg, [scene.x, scene.y, scene.z, scene.m,
                                 scene.rho, scene.h, group_sel], _SENT)

    def same_group(q, s):
        return (q[..., _BGRP] == s[..., _BGRP]) & (q[..., _BGRP] >= 0)

    def block_normals(qf, nbrs):
        sf = gather_source_block(df, nbrs, cfg, _SENT)
        s, q, xij, yij, zij, rij, hij = _geom(qf, sf)
        gate = same_group(q, s) & (rij <= cfg.radius)
        fac = torch.where(gate, -(s[..., _BM] / s[..., _BRHO])
                          * kernel.gradw_scalar(rij, hij),
                          torch.zeros_like(rij))
        return torch.stack([torch.sum(fac * xij, -1),
                            torch.sum(fac * yij, -1),
                            torch.sum(fac * zij, -1)], -1)

    ntmp = map_over_cells(cfg, block_normals, df, grid.nbr_slots)
    ntmp = _normalize(ntmp, 0.25 / df[..., _BH])

    def block_smooth(qf, nbrs):
        sf = gather_source_block(df, nbrs, cfg, _SENT)
        st = gather_source_block(ntmp, nbrs, cfg, 0.0)
        s, q, xij, yij, zij, rij, hij = _geom(qf, sf)
        C, O, M, F = sf.shape
        stf = st.reshape(C, 1, O * M, 3)
        gate = same_group(q, s) & (rij <= cfg.radius)
        fac = torch.where(gate, (s[..., _BM] / s[..., _BRHO])
                          * kernel.w(rij, hij), torch.zeros_like(rij))
        return torch.stack([torch.sum(fac * stf[..., 0], -1),
                            torch.sum(fac * stf[..., 1], -1),
                            torch.sum(fac * stf[..., 2], -1)], -1)

    nsm = map_over_cells(cfg, block_smooth, df, grid.nbr_slots)
    nsm = _normalize(nsm, 1e-3)

    def block_cos(qf, qn, nbrs):
        sf = gather_source_block(df, nbrs, cfg, _SENT)
        s, q, xij, yij, zij, rij, hij = _geom(qf, sf)
        h_i = qf[..., _BH][:, :, None]
        gate = (same_group(q, s) & (rij > 1e-9 * h_i)
                & (rij < 2.0 * h_i))
        dot = -(qn[..., 0][:, :, None] * xij
                + qn[..., 1][:, :, None] * yij
                + qn[..., 2][:, :, None] * zij)
        fac = torch.where(gate, dot / torch.clamp(rij, min=1e-300),
                          torch.full_like(rij, -float("inf")))
        return torch.any(fac > 0.5, dim=-1)

    interior = map_over_cells(cfg, block_cos, df, nsm, grid.nbr_slots)
    norm2 = torch.sum(nsm * nsm, -1)
    isb_d = ((norm2 > 1e-6) & ~interior & (df[..., _BGRP] >= 0)
             ).to(torch.int32)
    n = scene.n
    return unpack(grid, cfg, nsm, n), unpack(grid, cfg, isb_d, n)
