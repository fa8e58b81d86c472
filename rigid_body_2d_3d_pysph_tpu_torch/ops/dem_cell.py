"""The LVC pair passes on dense slot blocks: the plain version of the
DEM kernels (LVC displacement) and the LVCForce pass.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/dem_cell.py``
(``lvc_displacement_cell``, ``lvc_force_cell``).  Candidates come from
each slot's stencil row: ``nbr [NC, O]`` lists source slots of the
dense source pack in order (``NC`` = the all-sentinel row), and the
query lanes own their ``[M, L]`` table rows, so chunks over slots
compose.  The spill grid's stencil rows and the row-window grid's
per-window slot runs are both such lists.  The passes are
:func:`ops.dem.lvc_displacement_core` and :func:`ops.dem.lvc_force_core`,
chunked with ``map_over_cells``.

Source pack field order (both DEM kernels read it): x y z u v w wx wy wz
rad m dem idx; dem and the particle index ride as exact floats, and an
empty lane holds ``SENT`` (far away, index -1).
"""

from __future__ import annotations

import torch

from .cellpairs import CellGrid, map_over_cells, pack_fields, pack_rows, unpack
from .dem import _material_rows, lvc_displacement_core, lvc_force_core
from .ieee import sqrt

_BIG = 1.0e9
(DX, DY, DZ, DU, DV, DW, DWX, DWY, DWZ, DRAD, DM, DDEM, DIDX) = range(13)
NF = 13
SENT = [_BIG, _BIG, _BIG, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
        -1.0, -1.0]


def dem_payload(scene):
    """The source pack's 13 fields as per-particle [N] tensors.  The
    identity field is the row, also on a scene with ``gid``: the DEM
    kernels and this module's pass address the ``[N, L]`` table by it,
    and a gid-keyed table is translated to rows around the pass
    (``dem_kernel.lvc_displacement_cell_kernel``)."""
    fdt = scene.dtype
    ident = torch.arange(scene.n, dtype=fdt, device=scene.device)
    return [scene.x, scene.y, scene.z, scene.u, scene.v, scene.w,
            scene.wx, scene.wy, scene.wz, scene.rad_s, scene.m,
            scene.dem_id.to(fdt), ident]


def grid_from_pack(df, nbr, n: int) -> CellGrid:
    """The lane maps of a dense source pack ``df [NC + 1, M, 13]``, read
    from its particle-index field: ``slot2p`` (n = empty lane) and
    ``dense_pos`` (NC * M = no lane)."""
    NC, M = df.shape[0] - 1, df.shape[1]
    pid = df[:NC, :, DIDX].reshape(NC * M).to(torch.int64)
    slot2p = torch.where(pid >= 0, pid, n)
    dense_pos = torch.full((n + 1,), NC * M, dtype=torch.int64,
                           device=df.device)
    dense_pos[slot2p] = torch.arange(NC * M, device=df.device)
    n_occ = torch.zeros((), dtype=torch.int64, device=df.device)
    return CellGrid(slot2p=slot2p, dense_pos=dense_pos[:n], nbr_slots=nbr,
                    n_occupied=n_occ,
                    overflow=torch.zeros((), dtype=torch.bool,
                                         device=df.device))


class PackedParticles:
    """Per-particle fields read back from a dense source pack (for the
    prune; particles with no lane read as far away)."""

    def __init__(self, grid: CellGrid, cfg, df, n: int):
        flat = unpack(grid, cfg, df[:cfg.NC_max], n, _BIG)     # [N, 13]
        self.n = n
        self.x, self.y, self.z = flat[:, DX], flat[:, DY], flat[:, DZ]
        self.rad_s = flat[:, DRAD]
        self.dem_id = flat[:, DDEM].to(torch.int32)


def _displacement_pair(mat, dt):
    """The LVC-displacement pair function of :func:`lvc_cell_dense` for
    the per-entity materials ``mat [E, 4]`` (kn kt alpha mu)."""
    kn_t, kt_t, al_t, mu_t = mat.unbind(1)

    def pair(q, s, xij, yij, zij, rij, cand, j, dem_j, *tables):
        return lvc_displacement_core(
            q, s, xij, yij, zij, rij, cand, j, dem_j, dt,
            _material_rows(dem_j, kn_t), _material_rows(dem_j, kt_t),
            _material_rows(dem_j, al_t), _material_rows(dem_j, mu_t),
            *tables)

    return pair


def _force_pair(dt, kn, mu, en):
    """The LVCForce pair function of :func:`lvc_cell_dense` (scalar
    materials; a zero distance is no candidate)."""

    def pair(q, s, xij, yij, zij, rij, cand, j, dem_j, *tables):
        return lvc_force_core(q, s, xij, yij, zij, rij, cand & (rij > 0),
                              j, dem_j, dt, kn, mu, en, *tables)

    return pair


def lvc_cell_dense(df, nbr, t_idx, t_dem, t_x, t_y, t_z, mat, dt, cfg,
                   pair=None):
    """The pair pass on dense blocks.  ``df [NC + 1, M, 13]`` source
    pack, ``nbr [NC, O]`` source slots per query slot, tables
    ``[NC, M, L]``, ``mat [E, 4]`` (kn kt alpha mu per entity).
    Returns ``(sums [NC, M, 8], idx, dem, sx, sy, sz [NC, M, L])``; sums
    columns are fx fy fz torx tory torz, live count, gated pairs.
    ``pair`` replaces the LVC-displacement pair function (the LVCForce
    pass passes :func:`_force_pair`; ``mat`` is then unused)."""
    L = t_idx.shape[2]
    cutoff = cfg.radius
    pair = pair or _displacement_pair(mat, dt)

    def block(qf, ti, td, ta, tb, tc, nb):
        C, M, _ = qf.shape
        sf = df[torch.clamp(nb, max=df.shape[0] - 1)]     # [C, O, M, 13]
        K = sf.shape[1] * M
        R = C * M
        sfr = sf.reshape(C, 1, K, NF)

        def s_of(i):
            return torch.broadcast_to(sfr[..., i], (C, M, K)).reshape(R, K)

        def q_of(i):
            return qf[:, :, i].reshape(R, 1)

        keys = (("u", DU), ("v", DV), ("w", DW), ("wx", DWX), ("wy", DWY),
                ("wz", DWZ), ("rad", DRAD), ("m", DM))
        q = {k: q_of(i) for k, i in keys}
        s = {k: s_of(i) for k, i in keys}
        xij = q_of(DX) - s_of(DX)
        yij = q_of(DY) - s_of(DY)
        zij = q_of(DZ) - s_of(DZ)
        rij = sqrt(xij * xij + yij * yij + zij * zij)
        j = s_of(DIDX).to(torch.int64)
        dem_j = s_of(DDEM).to(torch.int64)
        cand = (j >= 0) & (j != q_of(DIDX).to(torch.int64)) & (rij <= cutoff)
        out = pair(q, s, xij, yij, zij, rij, cand, j, dem_j,
                   ti.reshape(R, L), td.reshape(R, L),
                   ta.reshape(R, L), tb.reshape(R, L), tc.reshape(R, L))
        (fx, fy, fz, trx, try_, trz, ti2, td2, ta2, tb2, tc2, cnt,
         ngate) = out
        sums = torch.stack([fx, fy, fz, trx, try_, trz, cnt.to(fx.dtype),
                            ngate.to(fx.dtype)], -1)

        def resh(a):
            return a.reshape((C, M) + tuple(a.shape[1:]))

        return (resh(sums), resh(ti2), resh(td2), resh(ta2), resh(tb2),
                resh(tc2))

    NC = cfg.NC_max
    return map_over_cells(cfg, block, df[:NC], t_idx, t_dem, t_x, t_y, t_z,
                          nbr)


def lvc_displacement_cell(df, grid: CellGrid, cfg, dt, mat,
                          tng_idx, tng_dem, tng_x, tng_y, tng_z):
    """The pair pass with per-particle tables in and out (the reference
    package's ``lvc_displacement_cell``): tables packed to the grid's
    lanes, :func:`lvc_cell_dense`, unpacked back.  Returns (sums [N, 8],
    idx, dem, sx, sy, sz [N, L]); a particle with no lane gets zero sums
    and an empty table."""
    n = tng_idx.shape[0]
    sums, ti, td, ta, tb, tc = lvc_cell_dense(
        df, grid.nbr_slots, pack_rows(grid, cfg, tng_idx, -1),
        pack_rows(grid, cfg, tng_dem, -1), pack_rows(grid, cfg, tng_x),
        pack_rows(grid, cfg, tng_y), pack_rows(grid, cfg, tng_z), mat, dt,
        cfg)
    return (unpack(grid, cfg, sums, n), unpack(grid, cfg, ti, n, -1),
            unpack(grid, cfg, td, n, -1), unpack(grid, cfg, ta, n),
            unpack(grid, cfg, tb, n), unpack(grid, cfg, tc, n))


def lvc_force_cell(scene, grid: CellGrid, cfg, dt, kn: float, mu: float,
                   en: float, tng_idx, tng_dem, tng_fx, tng_fy, tng_fz):
    """The LVCForce pass on ``grid`` (the reference package's
    ``lvc_force_cell``; the caller prunes the table first): the source
    pack gathered to the grid's lanes, :func:`lvc_cell_dense` with the
    force pair, the sums and table unpacked.  Returns (sums [N, 8], idx,
    dem, fx, fy, fz [N, L]); a particle with no lane gets zero sums and
    an empty table."""
    n = scene.n
    df = pack_fields(grid, cfg, dem_payload(scene), SENT)
    sent = torch.tensor(SENT, dtype=df.dtype, device=df.device)
    df = torch.cat([df, sent.expand(1, cfg.M, NF)], 0)
    sums, ti, td, ta, tb, tc = lvc_cell_dense(
        df, grid.nbr_slots, pack_rows(grid, cfg, tng_idx, -1),
        pack_rows(grid, cfg, tng_dem, -1), pack_rows(grid, cfg, tng_fx),
        pack_rows(grid, cfg, tng_fy), pack_rows(grid, cfg, tng_fz), None,
        dt, cfg, pair=_force_pair(dt, kn, mu, en))
    return (unpack(grid, cfg, sums, n), unpack(grid, cfg, ti, n, -1),
            unpack(grid, cfg, td, n, -1), unpack(grid, cfg, ta, n),
            unpack(grid, cfg, tb, n), unpack(grid, cfg, tc, n))
