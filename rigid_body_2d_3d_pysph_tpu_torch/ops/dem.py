"""Granular DEM: Luding linear viscoelastic contact (LVC) with Coulomb
friction and a persistent per-pair tangential history.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/dem.py``: the
``LVCDisplacement`` core (the tangential spring stores a displacement)
and the ``LVCForce`` core (it stores the tangential force), and their
``[N, K]`` neighbour-list entry points ``lvc_displacement`` and
``lvc_force``.  The contact table is a
fixed ``[N, L]`` slot array keyed by (partner index, partner dem id):
the prune frees slots whose pair no longer overlaps, and new contacts
take the lowest free slots in candidate order.

Deviations kept from the reference package: the torque is reset at
every force evaluation (the original never zeroes it); ``LVCForce``
uses the repulsive normal force and the unsquared Coulomb comparison
(the original's are sign and square slips in code it never runs).
"""

from __future__ import annotations

import math

import torch

from .ieee import sqrt
from .neighbors import NeighborList
from .pairs import pair_data


def prune_contact_table(scene, tng_idx, tng_dem, tng_a, tng_b, tng_c):
    """Free the slots whose pair no longer overlaps or whose partner's
    dem id changed.  ``scene`` needs ``x, y, z, rad_s, dem_id`` [N] and
    ``n``.  Returns the pruned table and the live count per row."""
    live = tng_idx >= 0
    j = torch.clamp(tng_idx, 0, scene.n - 1).to(torch.int64)
    dx = scene.x[:, None] - scene.x[j]
    dy = scene.y[:, None] - scene.y[j]
    dz = scene.z[:, None] - scene.z[j]
    rij = sqrt(dx * dx + dy * dy + dz * dz)
    overlap = scene.rad_s[:, None] + scene.rad_s[j] - rij
    keep = live & (overlap > 0.0) & (tng_dem == scene.dem_id[j])
    zero = torch.zeros((), dtype=tng_a.dtype, device=tng_a.device)
    tng_idx = torch.where(keep, tng_idx, -1)
    tng_dem = torch.where(keep, tng_dem, -1)
    tng_a = torch.where(keep, tng_a, zero)
    tng_b = torch.where(keep, tng_b, zero)
    tng_c = torch.where(keep, tng_c, zero)
    count = keep.sum(1).to(torch.int32)
    return tng_idx, tng_dem, tng_a, tng_b, tng_c, count


def _match_slots(tng_idx, tng_dem, j, dem_j):
    """[R, K] pairs -> (found, slot of the matching (idx, dem) entry in
    the [R, L] table, -1 if absent)."""
    eq = ((tng_idx[:, None, :] == j[:, :, None])
          & (tng_dem[:, None, :] == dem_j[:, :, None]))       # [R, K, L]
    found = eq.any(2)
    slot = torch.argmax(eq.to(torch.int8), dim=2)
    return found, torch.where(found, slot, -1)


def _allocate_slots(free_mask, new_mask):
    """The r-th new contact of a row takes the row's r-th free slot;
    [R, K] slot ids, -1 where the table is full (contact dropped)."""
    L = free_mask.shape[1]
    free_rank = torch.cumsum(free_mask.to(torch.int64), 1) - 1
    n_free = free_mask.sum(1)
    new_rank = torch.cumsum(new_mask.to(torch.int64), 1) - 1
    ok = new_mask & (new_rank < n_free[:, None])
    match = (free_mask[:, None, :]
             & (free_rank[:, None, :] == new_rank[:, :, None]))  # [R,K,L]
    iota = torch.arange(L, device=free_mask.device)
    slot = torch.where(match, iota, 0).sum(2)
    return torch.where(ok, slot, -1)


def lvc_displacement_core(q, s, xij, yij, zij, rij, cand, j, dem_j, dt,
                          kn, kt, alpha, mu,
                          tng_idx, tng_dem, tng_x, tng_y, tng_z):
    """Layout-agnostic LVC-displacement pair pass.

    ``q``: [R, 1] query columns (u, v, w, wx, wy, wz, rad, m); ``s``:
    [R, K] source fields (same keys); ``cand`` [R, K] candidate validity
    (self pairs excluded); materials [R, K] by source dem id; the table
    [R, L].  Returns the force and torque sums [R], the updated table,
    the live count [R] and the gated-pair count [R]."""
    overlap = q["rad"] + s["rad"] - rij
    gate = cand & (rij > 0) & (overlap > 0)

    rinv = 1.0 / torch.clamp(rij, min=1e-300)
    nx, ny, nz = xij * rinv, yij * rinv, zij * rinv

    # contact-point velocities including rotation
    a_i = q["rad"] - overlap / 2.0
    a_j = s["rad"] - overlap / 2.0
    vi_x = q["u"] + (q["wy"] * nz - q["wz"] * ny) * a_i
    vi_y = q["v"] + (q["wz"] * nx - q["wx"] * nz) * a_i
    vi_z = q["w"] + (q["wx"] * ny - q["wy"] * nx) * a_i
    vj_x = s["u"] + (-s["wy"] * nz + s["wz"] * ny) * a_j
    vj_y = s["v"] + (-s["wz"] * nx + s["wx"] * nz) * a_j
    vj_z = s["w"] + (-s["wx"] * ny + s["wy"] * nx) * a_j
    vij_x, vij_y, vij_z = vi_x - vj_x, vi_y - vj_y, vi_z - vj_z
    vdotn = vij_x * nx + vij_y * ny + vij_z * nz
    vt_x = vij_x - vdotn * nx
    vt_y = vij_y - vdotn * ny
    vt_z = vij_z - vdotn * nz

    m_eff = q["m"] * s["m"] / (q["m"] + s["m"])
    eta_n = alpha * sqrt(m_eff)
    fn = kn * overlap - eta_n * vdotn
    fn_x, fn_y, fn_z = fn * nx, fn * ny, fn * nz

    # tangential history
    found, slot_found = _match_slots(tng_idx, tng_dem, j, dem_j)
    found = found & gate
    new_mask = gate & ~found
    slot_new = _allocate_slots(tng_idx < 0, new_mask)

    zero = torch.zeros((), dtype=rij.dtype, device=rij.device)
    Lc = tng_x.shape[1]
    sf = torch.clamp(slot_found, 0, Lc - 1)
    sx = torch.where(found, torch.gather(tng_x, 1, sf), zero)
    sy = torch.where(found, torch.gather(tng_y, 1, sf), zero)
    sz = torch.where(found, torch.gather(tng_z, 1, sf), zero)
    sdotn = sx * nx + sy * ny + sz * nz
    sx, sy, sz = sx - sdotn * nx, sy - sdotn * ny, sz - sdotn * nz

    ft_x = -kt * sx - eta_n * vt_x
    ft_y = -kt * sy - eta_n * vt_y
    ft_z = -kt * sz - eta_n * vt_z
    ft_magn = sqrt(ft_x * ft_x + ft_y * ft_y + ft_z * ft_z)
    has_t = ft_magn > 1e-12
    inv_ft = torch.where(has_t, 1.0 / torch.clamp(ft_magn, min=1e-300),
                         zero)
    tx, ty, tz = ft_x * inv_ft, ft_y * inv_ft, ft_z * inv_ft

    fn_mu = mu * fn
    slip = ft_magn > fn_mu
    # saturated: force capped and spring rescaled; else the spring grows
    ft_x = torch.where(slip, fn_mu * tx, ft_x)
    ft_y = torch.where(slip, fn_mu * ty, ft_y)
    ft_z = torch.where(slip, fn_mu * tz, ft_z)
    kt_inv = 1.0 / torch.where(kt > 0, kt, torch.ones_like(kt))
    new_sx = torch.where(slip, -kt_inv * (fn_mu * tx + eta_n * vt_x),
                         sx + vt_x * dt)
    new_sy = torch.where(slip, -kt_inv * (fn_mu * ty + eta_n * vt_y),
                         sy + vt_y * dt)
    new_sz = torch.where(slip, -kt_inv * (fn_mu * tz + eta_n * vt_z),
                         sz + vt_z * dt)

    # new contacts contribute no tangential force this step
    ft_x = torch.where(found, ft_x, zero)
    ft_y = torch.where(found, ft_y, zero)
    ft_z = torch.where(found, ft_z, zero)

    # write-back: each (row, slot) has at most one contributing pair
    # (candidate lists hold no duplicates), so a masked K-sum per slot
    # is the scatter
    sfl = torch.where(found, sf, -1)

    def slot_write(tab, val_found, val_new, with_found=True):
        cols = []
        for l in range(Lc):
            m_n = slot_new == l
            v = torch.where(m_n.any(1),
                            torch.where(m_n, val_new, 0).sum(1).to(tab.dtype),
                            tab[:, l])
            if with_found:
                m_f = sfl == l
                v = torch.where(m_f.any(1), torch.where(
                    m_f, val_found, zero).sum(1).to(tab.dtype), v)
            cols.append(v)
        return torch.stack(cols, 1)

    tng_x = slot_write(tng_x, new_sx, zero)
    tng_y = slot_write(tng_y, new_sy, zero)
    tng_z = slot_write(tng_z, new_sz, zero)
    tng_idx = slot_write(tng_idx, None, j.to(tng_idx.dtype), False)
    tng_dem = slot_write(tng_dem, None, dem_j.to(tng_dem.dtype), False)

    def gsum(v):
        return torch.where(gate, v, zero).sum(1)

    fx = gsum(fn_x + ft_x)
    fy = gsum(fn_y + ft_y)
    fz = gsum(fn_z + ft_z)
    # torque = (n x ft) * a_i
    torx = gsum((ny * ft_z - nz * ft_y) * a_i)
    tory = gsum((nz * ft_x - nx * ft_z) * a_i)
    torz = gsum((nx * ft_y - ny * ft_x) * a_i)
    count = (tng_idx >= 0).sum(1).to(torch.int32)
    n_gated = gate.sum(1).to(torch.int32)
    return (fx, fy, fz, torx, tory, torz,
            tng_idx, tng_dem, tng_x, tng_y, tng_z, count, n_gated)


def _material_rows(dem_j, table):
    """``table[dem_j]`` for the small static entity table (0 where dem_j
    names no entity)."""
    out = torch.zeros(dem_j.shape, dtype=table.dtype, device=table.device)
    for e in range(table.shape[0]):
        out = torch.where(dem_j == e, table[e], out)
    return out


def lvc_force_core(q, s, xij, yij, zij, rij, cand, j, dem_j, dt,
                   kn: float, mu: float, en: float,
                   tng_idx, tng_dem, tng_fx, tng_fy, tng_fz):
    """Layout-agnostic LVCForce pair pass (tangential-force springs;
    scalar material constants: kt = 2/7 kn, alpha from the restitution
    coefficient).  Arguments as :func:`lvc_displacement_core`, with
    ``cand`` already excluding zero distances; returns the same 13
    values, the table's springs being tangential forces."""
    kt = 2.0 / 7.0 * kn
    log_en = math.log(en)
    alpha = 2.0 * math.sqrt(kn) * abs(log_en) / math.sqrt(
        math.pi ** 2 + log_en ** 2)

    overlap = q["rad"] + s["rad"] - rij
    gate = cand & (overlap > 0)
    rinv = 1.0 / torch.clamp(rij, min=1e-300)
    nx, ny, nz = xij * rinv, yij * rinv, zij * rinv

    a_i = q["rad"] - overlap / 2.0
    a_j = s["rad"] - overlap / 2.0
    vi_x = q["u"] + (q["wy"] * nz - q["wz"] * ny) * a_i
    vi_y = q["v"] + (q["wz"] * nx - q["wx"] * nz) * a_i
    vi_z = q["w"] + (q["wx"] * ny - q["wy"] * nx) * a_i
    vj_x = s["u"] + (-s["wy"] * nz + s["wz"] * ny) * a_j
    vj_y = s["v"] + (-s["wz"] * nx + s["wx"] * nz) * a_j
    vj_z = s["w"] + (-s["wx"] * ny + s["wy"] * nx) * a_j
    vr_x, vr_y, vr_z = vi_x - vj_x, vi_y - vj_y, vi_z - vj_z
    vdotn = vr_x * nx + vr_y * ny + vr_z * nz
    vt_x = vr_x - vdotn * nx
    vt_y = vr_y - vdotn * ny
    vt_z = vr_z - vdotn * nz

    m_eff = q["m"] * s["m"] / (q["m"] + s["m"])
    eta_n = alpha * sqrt(m_eff)
    fn = kn * overlap - eta_n * vdotn
    fn_x, fn_y, fn_z = fn * nx, fn * ny, fn * nz

    found, slot_found = _match_slots(tng_idx, tng_dem, j, dem_j)
    found = found & gate
    new_mask = gate & ~found
    slot_new = _allocate_slots(tng_idx < 0, new_mask)
    Lc = tng_fx.shape[1]
    sf = torch.clamp(slot_found, 0, Lc - 1)
    # the slot this pair writes: its found slot or a fresh one
    eff = torch.where(found, sf, slot_new)
    live = eff >= 0

    zero = torch.zeros((), dtype=rij.dtype, device=rij.device)
    fx_s = torch.where(found, torch.gather(tng_fx, 1, sf), zero) \
        - kt * vt_x * dt
    fy_s = torch.where(found, torch.gather(tng_fy, 1, sf), zero) \
        - kt * vt_y * dt
    fz_s = torch.where(found, torch.gather(tng_fz, 1, sf), zero) \
        - kt * vt_z * dt

    # Coulomb cap
    fn_magn = sqrt(fn_x * fn_x + fn_y * fn_y + fn_z * fn_z)
    ft_magn = sqrt(fx_s * fx_s + fy_s * fy_s + fz_s * fz_s)
    fn_mu = mu * fn_magn
    slip = ft_magn >= fn_mu
    inv = torch.where(ft_magn > 0, 1.0 / torch.clamp(ft_magn, min=1e-300),
                      zero)
    fx_s = torch.where(slip, fn_mu * fx_s * inv, fx_s)
    fy_s = torch.where(slip, fn_mu * fy_s * inv, fy_s)
    fz_s = torch.where(slip, fn_mu * fz_s * inv, fz_s)

    # write-back: each (row, slot) takes at most one pair (candidate
    # lists hold no duplicates); the pairs that write nothing go to a
    # spare column that is dropped
    def write(tab, where_to, val):
        ext = torch.cat([tab, torch.zeros_like(tab[:, :1])], 1)
        ext.scatter_(1, torch.where(where_to >= 0, where_to, Lc),
                     torch.where(where_to >= 0, val,
                                 torch.zeros_like(val)).to(tab.dtype))
        return ext[:, :Lc]

    tng_fx = write(tng_fx, eff, fx_s)
    tng_fy = write(tng_fy, eff, fy_s)
    tng_fz = write(tng_fz, eff, fz_s)
    tng_idx = write(tng_idx, slot_new, j)
    tng_dem = write(tng_dem, slot_new, dem_j)

    gl = gate & live

    def gsum(v):
        return torch.where(gl, v, zero).sum(1)

    fx = gsum(fn_x + fx_s)
    fy = gsum(fn_y + fy_s)
    fz = gsum(fn_z + fz_s)
    torx = gsum((ny * fz_s - nz * fy_s) * a_i)
    tory = gsum((nz * fx_s - nx * fz_s) * a_i)
    torz = gsum((nx * fy_s - ny * fx_s) * a_i)
    count = (tng_idx >= 0).sum(1).to(torch.int32)
    n_gated = gate.sum(1).to(torch.int32)
    return (fx, fy, fz, torx, tory, torz,
            tng_idx, tng_dem, tng_fx, tng_fy, tng_fz, count, n_gated)


def _list_columns(scene, j):
    """The query columns [N, 1] and the source fields [N, K] of the
    LVC cores."""
    keys = ("u", "v", "w", "wx", "wy", "wz")
    q = {k: scene[k][:, None] for k in keys}
    s = {k: scene[k][j] for k in keys}
    q.update(rad=scene.rad_s[:, None], m=scene.m[:, None])
    s.update(rad=scene.rad_s[j], m=scene.m[j])
    return q, s


def _not_self(scene, j):
    return j != torch.arange(scene.n, device=j.device)[:, None]


def lvc_displacement(scene, nbrs: NeighborList, dt,
                     tng_idx, tng_dem, tng_x, tng_y, tng_z):
    """LVC with tangential-displacement springs on the ``[N, K]`` list;
    the per-entity tables ``dem_kn, dem_kt, dem_alpha, dem_mu`` are read
    by source dem id.  Returns the 13 values of
    :func:`lvc_displacement_core`."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    dem_j = scene.dem_id[j]
    q, s = _list_columns(scene, j)
    return lvc_displacement_core(
        q, s, pd.xij, pd.yij, pd.zij, pd.rij, pd.mask & _not_self(scene, j),
        j, dem_j, dt, scene.dem_kn[dem_j], scene.dem_kt[dem_j],
        scene.dem_alpha[dem_j], scene.dem_mu[dem_j],
        tng_idx, tng_dem, tng_x, tng_y, tng_z)


def lvc_force(scene, nbrs: NeighborList, dt, kn: float, mu: float, en: float,
              tng_idx, tng_dem, tng_fx, tng_fy, tng_fz):
    """LVC with tangential-force springs on the ``[N, K]`` list (scalar
    kn, mu, en).  Returns the 13 values of :func:`lvc_force_core`."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    q, s = _list_columns(scene, j)
    cand = pd.mask & _not_self(scene, j) & (pd.rij > 0)
    return lvc_force_core(q, s, pd.xij, pd.yij, pd.zij, pd.rij, cand, j,
                          scene.dem_id[j], dt, kn, mu, en,
                          tng_idx, tng_dem, tng_fx, tng_fy, tng_fz)
