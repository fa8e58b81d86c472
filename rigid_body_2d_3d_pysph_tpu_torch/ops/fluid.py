"""Weakly-compressible SPH fluid passes on neighbour lists, and the
fluid's equation of state.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/fluid.py``: continuity
and EDAC rates (and their FSI forms, which read the body particles'
shadow fluid mass, density and pressure), the Tait equation of state,
the Adami wall velocity and pressure, the pressure-gradient and
artificial-viscosity momentum terms, the two FSI forces and XSPH, each a
masked ``[N, K]`` reduction on the ``[N, K]`` list engine.  The cell
engine computes the same passes in ``csrc/fluid.cu`` (B4-B6c) and their
plain versions (``ops/fluid_kernel.py``).

Pair conventions as PySPH: x_ij = x_i - x_j, v_ij = v_i - v_j,
h_ij = (h_i + h_j) / 2, eps = 0.01 h_ij^2.
"""

from __future__ import annotations

import torch

from .kernels import Kernel
from .neighbors import NeighborList
from .pairs import masked_sum, pair_data


def _gate(pd, dest_mask, src_mask):
    return pd.mask & dest_mask[:, None] & src_mask[pd.j]


def _dw_vec(kernel, pd):
    s = kernel.gradw_scalar(pd.rij, pd.hij)
    return s * pd.xij, s * pd.yij, s * pd.zij


def _vij(scene, j):
    return (scene.u[:, None] - scene.u[j],
            scene.v[:, None] - scene.v[j],
            scene.w[:, None] - scene.w[j])


def continuity(scene, nbrs: NeighborList, kernel: Kernel, dest_mask,
               src_mask, fsi: bool = False):
    """arho_i = sum_j rho_i (m_j / rho_j) (v_ij . DW_ij); the FSI form
    reads the source's shadow ``m_fsi / rho_fsi``."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    gate = _gate(pd, dest_mask, src_mask)
    dwx, dwy, dwz = _dw_vec(kernel, pd)
    uij, vij, wij = _vij(scene, j)
    vdotdw = uij * dwx + vij * dwy + wij * dwz
    if fsi:
        fac = scene.rho[:, None] * scene.m_fsi[j] / scene.rho_fsi[j]
    else:
        fac = scene.rho[:, None] * scene.m[j] / scene.rho[j]
    return masked_sum(fac * vdotdw, gate)


def edac(scene, nbrs: NeighborList, kernel: Kernel, nu: float, c0_ref: float,
         dest_mask, src_mask, fsi: bool = False):
    """The EDAC pressure rate: the advective term (continuity x c0^2)
    and the viscous pressure damping."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    gate = _gate(pd, dest_mask, src_mask)
    dwx, dwy, dwz = _dw_vec(kernel, pd)
    uij, vij, wij = _vij(scene, j)
    vdotdw = uij * dwx + vij * dwy + wij * dwz
    xdotdw = pd.xij * dwx + pd.yij * dwy + pd.zij * dwz

    rhoi = scene.rho[:, None]
    if fsi:
        mj, rhoj, pj = scene.m_fsi[j], scene.rho_fsi[j], scene.p_fsi[j]
    else:
        mj, rhoj, pj = scene.m[j], scene.rho[j], scene.p[j]
    cs2 = c0_ref * c0_ref
    ap = masked_sum(rhoi / rhoj * cs2 * mj * vdotdw, gate)

    Vi = scene.m[:, None] / rhoi
    Vj = mj / rhoj
    etaij = 2.0 * nu * (rhoi * rhoj) / (rhoi + rhoj)
    eps = 0.01 * pd.hij * pd.hij
    tmp = (1.0 / scene.m[:, None]) * (Vi * Vi + Vj * Vj) * etaij * xdotdw / (
        pd.rij * pd.rij + eps)
    return ap + masked_sum(tmp * (scene.p[:, None] - pj), gate)


def tait_eos(scene, rho0: float, c0: float, gamma: float, dest_mask):
    """p = (c0^2 rho0 / gamma) ((rho / rho0)^gamma - 1) and the sound
    speed cs = c0 (rho / rho0)^((gamma - 1) / 2) on ``dest_mask``; other
    particles keep their p and cs (PySPH ``TaitEOS``)."""
    ratio = scene.rho / rho0
    B = c0 * c0 * rho0 / gamma
    p = B * (ratio ** gamma - 1.0)
    cs = c0 * ratio ** (0.5 * (gamma - 1.0))
    return (torch.where(dest_mask, p, scene.p),
            torch.where(dest_mask, cs, scene.cs))


def set_wall_velocity(scene, nbrs: NeighborList, kernel: Kernel, dest_mask,
                      fluid_mask):
    """Adami ghost velocities: the Shepard average of the fluid velocity
    at wall particles and u_g = 2 u_wall - u_f.  Returns (uf, vf, wf, ug,
    vg, wg, wij_sum)."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    gate = _gate(pd, dest_mask, fluid_mask)
    wij = kernel.w(pd.rij, pd.hij)
    sw = masked_sum(torch.where(gate, wij, torch.zeros_like(wij)), gate)
    uf = masked_sum(scene.u[j] * wij, gate)
    vf = masked_sum(scene.v[j] * wij, gate)
    wf = masked_sum(scene.w[j] * wij, gate)
    inv = torch.where(sw > 1e-12, 1.0 / torch.clamp(sw, min=1e-300),
                      torch.zeros_like(sw))
    uf, vf, wf = uf * inv, vf * inv, wf * inv
    return (uf, vf, wf, 2.0 * scene.u - uf, 2.0 * scene.v - vf,
            2.0 * scene.w - wf, sw)


def solid_wall_pressure_bc(scene, nbrs: NeighborList, kernel: Kernel,
                           gx, gy, gz, dest_mask, fluid_mask, wij_sum,
                           clamp: bool):
    """The Adami wall pressure p_w = sum_j [p_j + rho_j (g - a_w) . x_ij]
    W_ij / sum_j W_ij, with the wall's acceleration from its au/av/aw;
    ``clamp`` clamps it at 0 (the reference's ``ClampWallPressure``)."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    gate = _gate(pd, dest_mask, fluid_mask)
    wij = kernel.w(pd.rij, pd.hij)
    gdotx = ((gx - scene.au[:, None]) * pd.xij
             + (gy - scene.av[:, None]) * pd.yij
             + (gz - scene.aw[:, None]) * pd.zij)
    num = masked_sum((scene.p[j] + scene.rho[j] * gdotx) * wij, gate)
    has = wij_sum > 1e-14
    p = torch.where(has, num / torch.where(has, wij_sum, 1.0), num)
    return torch.clamp(p, min=0.0) if clamp else p


def momentum_pressure_gradient(scene, nbrs: NeighborList, kernel: Kernel,
                               dest_mask, src_mask):
    """a_i += -m_j (p_i / rho_i^2 + p_j / rho_j^2) DW_ij (the scheme
    adds gravity)."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    gate = _gate(pd, dest_mask, src_mask)
    dwx, dwy, dwz = _dw_vec(kernel, pd)
    pij = (scene.p[:, None] / scene.rho[:, None] ** 2
           + scene.p[j] / scene.rho[j] ** 2)
    tmp = -scene.m[j] * pij
    return (masked_sum(tmp * dwx, gate), masked_sum(tmp * dwy, gate),
            masked_sum(tmp * dwz, gate))


def momentum_artificial_viscosity(scene, nbrs: NeighborList, kernel: Kernel,
                                  alpha: float, c0: float, dest_mask,
                                  src_mask):
    """Monaghan's artificial viscosity, on approaching pairs
    (v_ij . x_ij < 0) only."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    gate = _gate(pd, dest_mask, src_mask)
    dwx, dwy, dwz = _dw_vec(kernel, pd)
    uij, vij, wij = _vij(scene, j)
    vdotx = uij * pd.xij + vij * pd.yij + wij * pd.zij
    eps = 0.01 * pd.hij * pd.hij
    muij = pd.hij * vdotx / (pd.rij * pd.rij + eps)
    rhoij1 = 2.0 / (scene.rho[:, None] + scene.rho[j])
    piij = torch.where(vdotx < 0, -alpha * c0 * muij * scene.m[j] * rhoij1,
                       torch.zeros_like(muij))
    return (masked_sum(-piij * dwx, gate), masked_sum(-piij * dwy, gate),
            masked_sum(-piij * dwz, gate))


def force_on_fluid_due_to_rigid_body(scene, nbrs: NeighborList,
                                     kernel: Kernel, dest_mask, rigid_mask):
    """a_i += -m_fsi_j (p_i / rho_i^2 + p_fsi_j / rho_fsi_j^2) DW_ij."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    gate = _gate(pd, dest_mask, rigid_mask)
    dwx, dwy, dwz = _dw_vec(kernel, pd)
    pij = (scene.p[:, None] / scene.rho[:, None] ** 2
           + scene.p_fsi[j] / scene.rho_fsi[j] ** 2)
    tmp = -scene.m_fsi[j] * pij
    return (masked_sum(tmp * dwx, gate), masked_sum(tmp * dwy, gate),
            masked_sum(tmp * dwz, gate))


def force_on_rigid_body_due_to_fluid(scene, nbrs: NeighborList,
                                     kernel: Kernel, dest_mask, fluid_mask):
    """f_i -= m_fsi_i m_j (p_j / rho_j^2 + p_fsi_i / rho_fsi_i^2) DW_ij
    (the Akinci and Liu coupling force)."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    gate = _gate(pd, dest_mask, fluid_mask)
    dwx, dwy, dwz = _dw_vec(kernel, pd)
    t1 = (scene.p[j] / scene.rho[j] ** 2
          + scene.p_fsi[:, None] / scene.rho_fsi[:, None] ** 2)
    fac = -scene.m_fsi[:, None] * scene.m[j] * t1
    return (masked_sum(fac * dwx, gate), masked_sum(fac * dwy, gate),
            masked_sum(fac * dwz, gate))


def xsph_correction(scene, nbrs: NeighborList, kernel: Kernel, eps: float,
                    dest_mask, src_mask):
    """XSPH velocity smoothing: dx_i/dt = u_i - eps sum_j m_j /
    rho_ij_bar v_ij W_ij (returns the correction terms)."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    gate = _gate(pd, dest_mask, src_mask)
    wij = kernel.w(pd.rij, pd.hij)
    uij, vij, wvij = _vij(scene, j)
    fac = eps * scene.m[j] * 2.0 / (scene.rho[:, None] + scene.rho[j]) * wij
    return (-masked_sum(fac * uij, gate), -masked_sum(fac * vij, gate),
            -masked_sum(fac * wvij, gate))
