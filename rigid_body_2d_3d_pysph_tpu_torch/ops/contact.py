"""Mofidi et al. (2022) Eq. 24 contact force on explicit per-lane arrays.

Counterpart of ``contact_force`` and ``contact_force_core`` in
``rigid_body_2d_3d_pysph_tpu/ops/contact.py``: a normal spring-dashpot
plus a Coulomb-capped tangential spring per (destination, source-entity
slot), with the reference's quirks kept (the spring reset to the unit
tangent, the stale normal force reused when the relative motion is
zero, 0 instead of NaN for a degenerate tangent).
"""

from __future__ import annotations

import torch

from .rigid import gather_body_rows


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
    eta = gather_body_rows(eta_body, bid) * torch.sqrt(m[:, None] / 2.0 * kr)

    tmp = kr * overlap
    fn_nx = (tmp - eta * vij_dot_n) * cfn_x
    fn_ny = (tmp - eta * vij_dot_n) * cfn_y
    fn_nz = (tmp - eta * vij_dot_n) * cfn_z

    vij_magn = torch.sqrt(vij_x**2 + vij_y**2 + vij_z**2)
    moving = vij_magn >= 1e-12

    tx = vij_x - cfn_x * vij_dot_n
    ty = vij_y - cfn_y * vij_dot_n
    tz = vij_z - cfn_z * vij_dot_n
    ti_magn = torch.sqrt(tx * tx + ty * ty + tz * tz)
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

    ft_magn = torch.sqrt((kf * new_dl_x) ** 2 + (kf * new_dl_y) ** 2
                         + (kf * new_dl_z) ** 2)
    fn_magn = torch.sqrt(fn_nx**2 + fn_ny**2 + fn_nz**2)
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
