"""Mofidi et al. (2022) contact: the Eq.-22 normals and Eq.-21 distance
on neighbour lists, and the Eq.-24 force on explicit per-lane arrays;
the Canelas (2016) Hertzian pair force.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/contact.py``:

* ``contact_force_normals`` / ``contact_force_distance``: the ``[N, K]``
  list engine's Eq.-22 and Eq.-21 sums into ``[N, S]`` slots by source
  dem id, and the closest source particle of each slot (the first
  minimum in neighbour order).  The cell engine computes the same in
  ``csrc/contact.cu`` (K2) and its plain version;
* ``contact_force`` / ``contact_force_core``: a normal spring-dashpot
  plus a Coulomb-capped tangential spring per (destination,
  source-entity slot), with the reference's quirks kept (the spring
  reset to the unit tangent, the stale normal force reused when the
  relative motion is zero, 0 instead of NaN for a degenerate tangent);
* ``canelas_pair_force``: dormant in the reference's schemes, ported
  for completeness.
"""

from __future__ import annotations

import torch

from .ieee import sqrt
from .neighbors import NeighborList
from .pairs import argmin_to_slots, pair_data, scatter_to_slots
from .rigid import gather_body_rows


def _contact_gate(scene, pd):
    """The pair gate: a rigid destination, a source flagged as a contact
    surface, another dem entity, a non-fluid source."""
    j = pd.j
    return (pd.mask & scene.is_rigid[:, None]
            & (scene.contact_force_is_boundary[j] == 1.0)
            & (scene.dem_id[:, None] != scene.dem_id[j])
            & ~scene.is_fluid[j])


def contact_force_normals(scene, nbrs: NeighborList, kernel):
    """Eq. 22: the SPH-averaged contact normal of each (particle, source
    entity).  Returns (cfn_x, cfn_y, cfn_z, wij_norm), each [N, S]."""
    S = scene.meta.total_no_bodies
    pd = pair_data(scene, nbrs)
    gate = _contact_gate(scene, pd)
    wij = kernel.w(pd.rij, pd.hij)
    rinv = 1.0 / torch.clamp(pd.rij, min=1e-300)
    tmp = scene.m[:, None] / scene.rho[:, None] * rinv * wij
    slot = scene.dem_id[pd.j]
    sx = scatter_to_slots(pd.xij * tmp, slot, gate, S)
    sy = scatter_to_slots(pd.yij * tmp, slot, gate, S)
    sz = scatter_to_slots(pd.zij * tmp, slot, gate, S)
    # tmp * r_ij == (m / rho) W
    sw = scatter_to_slots(tmp * pd.rij, slot, gate, S)

    zero = torch.zeros((), dtype=sw.dtype, device=sw.device)
    has = sw > 1e-12
    inv_w = torch.where(has, 1.0 / torch.clamp(sw, min=1e-300), zero)
    mx, my, mz = sx * inv_w, sy * inv_w, sz * inv_w
    mag = sqrt(mx * mx + my * my + mz * mz)
    inv_m = torch.where(has & (mag > 0), 1.0 / torch.clamp(mag, min=1e-300),
                        zero)
    return mx * inv_m, my * inv_m, mz * inv_m, sw


def contact_force_distance(scene, nbrs: NeighborList, kernel,
                           cfn_x, cfn_y, cfn_z):
    """Eq. 21: the SPH-mean penetration distance along each slot's
    normal, and the closest source particle of each slot.  Returns the
    dict of ``contact_force_dist``, ``closest_point_dist_to_source`` and
    the closest source's position and velocity, each [N, S]."""
    S = scene.meta.total_no_bodies
    init_dist = 4.0 * scene.meta.spacing0
    pd = pair_data(scene, nbrs)
    j = pd.j
    gate = _contact_gate(scene, pd)
    wij = kernel.w(pd.rij, pd.hij)
    tmp = scene.m[:, None] / scene.rho[:, None] * wij
    slot = scene.dem_id[j]
    # the slot's normal at each pair (a gated pair's slot is in range)
    sl = torch.clamp(slot.to(torch.int64), 0, S - 1)
    proj = (torch.gather(cfn_x, 1, sl) * pd.xij
            + torch.gather(cfn_y, 1, sl) * pd.yij
            + torch.gather(cfn_z, 1, sl) * pd.zij)

    dist_tmp = scatter_to_slots(proj * tmp, slot, gate, S)
    w_sum = scatter_to_slots(tmp, slot, gate, S)
    has = w_sum > 1e-12
    dist = torch.where(has, dist_tmp / torch.where(has, w_sum, 1.0),
                       torch.zeros_like(w_sum))

    # the closest source (strictly below init; ties go to the first
    # candidate in neighbour order, as the reference's sequential scan)
    min_d, arg_k, found = argmin_to_slots(pd.rij, slot, gate, S, init_dist)
    src = torch.gather(j, 1, torch.clamp(arg_k, 0, j.shape[1] - 1))
    src = torch.clamp(src.to(torch.int64), 0, scene.n - 1)

    def pick(field):
        return torch.where(found, field[src], torch.zeros_like(min_d))

    return dict(
        contact_force_dist=dist,
        closest_point_dist_to_source=min_d,
        x_source=pick(scene.x), y_source=pick(scene.y),
        z_source=pick(scene.z), vx_source=pick(scene.u),
        vy_source=pick(scene.v), vz_source=pick(scene.w))


def contact_force(scene, dt, kr: float, kf: float, fric_coeff: float,
                  cfn_x, cfn_y, cfn_z, dist_info,
                  delta_lt_x, delta_lt_y, delta_lt_z,
                  fn_x_prev, fn_y_prev, fn_z_prev):
    """Eq. 24 on every particle's [N, S] slot map (the full schema, as
    the coupling step keeps it)."""
    return contact_force_core(
        scene.u, scene.v, scene.w, scene.m, scene.body_id, scene.eta,
        scene.meta.nb, scene.meta.spacing0, dt, kr, kf, fric_coeff,
        cfn_x, cfn_y, cfn_z, dist_info,
        delta_lt_x, delta_lt_y, delta_lt_z,
        fn_x_prev, fn_y_prev, fn_z_prev)


def contact_force_core(u, v, w, m, body_id, eta_body, nb: int,
                       spacing0: float, dt, kr: float, kf: float,
                       fric_coeff: float, cfn_x, cfn_y, cfn_z, dist_info,
                       delta_lt_x, delta_lt_y, delta_lt_z,
                       fn_x_prev, fn_y_prev, fn_z_prev):
    """Eq. 24 on [L] lane vectors and [L, S] slot maps.  Returns the
    per-lane force increments (fx, fy, fz) and the new slot state."""
    dist = dist_info["contact_force_dist"]
    zero = torch.zeros_like(dist)
    overlap = spacing0 - dist
    engaged = (overlap > 0.0) & (dist != 0.0)

    vij_x = u[:, None] - dist_info["vx_source"]
    vij_y = v[:, None] - dist_info["vy_source"]
    vij_z = w[:, None] - dist_info["vz_source"]
    vij_dot_n = vij_x * cfn_x + vij_y * cfn_y + vij_z * cfn_z

    # damping: eta[body_id(i), slot] * sqrt(m_i / 2 * kr)
    bid = torch.clamp(body_id, 0, nb - 1).to(torch.int64)
    eta = gather_body_rows(eta_body, bid) * sqrt(m[:, None] / 2.0 * kr)

    tmp = kr * overlap
    fn_nx = (tmp - eta * vij_dot_n) * cfn_x
    fn_ny = (tmp - eta * vij_dot_n) * cfn_y
    fn_nz = (tmp - eta * vij_dot_n) * cfn_z

    vij_magn = sqrt(vij_x**2 + vij_y**2 + vij_z**2)
    moving = vij_magn >= 1e-12

    tx = vij_x - cfn_x * vij_dot_n
    ty = vij_y - cfn_y * vij_dot_n
    tz = vij_z - cfn_z * vij_dot_n
    ti_magn = sqrt(tx * tx + ty * ty + tz * tz)
    has_t = ti_magn > 1e-12
    inv_t = torch.where(has_t, 1.0 / torch.clamp(ti_magn, min=1e-300), zero)
    ti_x, ti_y, ti_z = tx * inv_t, ty * inv_t, tz * inv_t

    dls_x = delta_lt_x + vij_x * dt
    dls_y = delta_lt_y + vij_y * dt
    dls_z = delta_lt_z + vij_z * dt
    dl_dot_t = dls_x * ti_x + dls_y * ti_y + dls_z * ti_z
    new_dl_x = dl_dot_t * ti_x
    new_dl_y = dl_dot_t * ti_y
    new_dl_z = dl_dot_t * ti_z

    ft_magn = sqrt((kf * new_dl_x) ** 2 + (kf * new_dl_y) ** 2
                   + (kf * new_dl_z) ** 2)
    fn_magn = sqrt(fn_nx**2 + fn_ny**2 + fn_nz**2)
    ft_star = torch.minimum(fric_coeff * fn_magn, ft_magn)
    ft_nx = -ft_star * ti_x
    ft_ny = -ft_star * ti_y
    ft_nz = -ft_star * ti_z

    reset_ok = ft_star > 0.0
    dl_after_x = torch.where(reset_ok, ti_x, zero)
    dl_after_y = torch.where(reset_ok, ti_y, zero)
    dl_after_z = torch.where(reset_ok, ti_z, zero)

    em = engaged & moving

    def sel(mv, st):
        return torch.where(engaged, torch.where(moving, mv, st), zero)

    out = dict(
        overlap=torch.where(engaged, overlap, zero),
        ft_x=torch.where(em, ft_nx, zero),
        ft_y=torch.where(em, ft_ny, zero),
        ft_z=torch.where(em, ft_nz, zero),
        fn_x=sel(fn_nx, fn_x_prev),
        fn_y=sel(fn_ny, fn_y_prev),
        fn_z=sel(fn_nz, fn_z_prev),
        delta_lt_x=sel(dl_after_x, zero),
        delta_lt_y=sel(dl_after_y, zero),
        delta_lt_z=sel(dl_after_z, zero),
        ti_x=torch.where(em, ti_x, zero),
        ti_y=torch.where(em, ti_y, zero),
        ti_z=torch.where(em, ti_z, zero),
    )
    dfx = torch.sum(out["fn_x"] + out["ft_x"], dim=1)
    dfy = torch.sum(out["fn_y"] + out["ft_y"], dim=1)
    dfz = torch.sum(out["fn_z"] + out["ft_z"], dim=1)
    return dfx, dfy, dfz, out


def canelas_pair_force(scene, nbrs: NeighborList, Cn: float = 1.4e-5,
                       wall_mode: bool = False):
    """Hertzian normal contact: F_n = kn delta^1.5 n - gamma_n (v . n) n
    with kn = 4/3 E* sqrt(r*), gamma_n = Cn sqrt(6 m* E* sqrt(r*)).
    ``wall_mode`` takes the destination's own mass and radius as the
    effective ones (the reference's rigid-wall variant) instead of the
    harmonic means.  E and the Poisson ratio are per-particle fields
    ``E`` and ``poisson_ratio``.  Returns (fx, fy, fz) [N]."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    overlap = scene.rad_s[:, None] + scene.rad_s[j] - pd.rij
    gate = (pd.mask & scene.is_rigid[:, None]
            & (scene.dem_id[:, None] != scene.dem_id[j]) & (pd.rij > 0)
            & ~scene.is_fluid[j] & (overlap > 0))

    rinv = 1.0 / torch.clamp(pd.rij, min=1e-300)
    nx, ny, nz = pd.xij * rinv, pd.yij * rinv, pd.zij * rinv
    vr_dot_n = ((scene.u[:, None] - scene.u[j]) * nx
                + (scene.v[:, None] - scene.v[j]) * ny
                + (scene.w[:, None] - scene.w[j]) * nz)

    nu_i = scene.poisson_ratio[:, None]
    nu_j = scene.poisson_ratio[j]
    E_eff = 1.0 / ((1 - nu_i**2) / scene.E[:, None]
                   + (1 - nu_j**2) / scene.E[j])

    nb = scene.meta.nb
    bid = torch.clamp(scene.body_id.to(torch.int64), 0, nb - 1)
    m_i = scene.total_mass[bid][:, None]
    if wall_mode:
        m_eff = m_i.expand(pd.rij.shape)
        r_eff = scene.rad_s[:, None].expand(pd.rij.shape)
    else:
        m_j = scene.total_mass[torch.clamp(scene.body_id[j].to(torch.int64),
                                           0, nb - 1)]
        m_eff = m_i * m_j / (m_i + m_j)
        r_i = scene.rad_s[:, None]
        r_j = scene.rad_s[j]
        r_eff = r_i * r_j / (r_i + r_j)

    kn = 4.0 / 3.0 * E_eff * sqrt(r_eff)
    gamma_n = Cn * sqrt(6.0 * m_eff * E_eff * sqrt(r_eff))
    mag = kn * torch.clamp(overlap, min=0.0) ** 1.5 - gamma_n * vr_dot_n
    zero = torch.zeros((), dtype=mag.dtype, device=mag.device)
    return tuple(torch.where(gate, mag * c, zero).sum(1)
                 for c in (nx, ny, nz))
