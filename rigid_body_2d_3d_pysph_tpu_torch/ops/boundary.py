"""Free-surface (boundary-particle) identification on neighbour lists.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/boundary.py``: the
reference's three one-shot passes as masked ``[N, K]`` reductions,

1. raw SPH normals n_tmp_i = sum_j -(m_j / rho_j) DW_ij, kept where
   |n| > 0.25 / h,
2. smoothed normals n_i = sum_j (m_j / rho_j) W_ij n_tmp_j, normalised
   where |n| > 1e-3,
3. a particle with a normal is interior if a neighbour with
   1e-9 h < r_ij < 2 h lies in the 60-degree cone behind the normal.

The cell-grid route of the same passes is ``ops/boundary_cell.py``.
"""

from __future__ import annotations

import torch

from .ieee import sqrt
from .kernels import Kernel
from .neighbors import NeighborList
from .pairs import masked_sum, pair_data


def _gate(pd, dest_mask, src_mask):
    return pd.mask & dest_mask[:, None] & src_mask[pd.j]


def compute_normals(scene, nbrs: NeighborList, kernel: Kernel, dest_mask,
                    src_mask):
    """Raw SPH normals -> ``normal_tmp`` [N, 3]."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    gate = _gate(pd, dest_mask, src_mask)
    fac = -(scene.m[j] / scene.rho[j]) * kernel.gradw_scalar(pd.rij, pd.hij)
    nx = masked_sum(fac * pd.xij, gate)
    ny = masked_sum(fac * pd.yij, gate)
    nz = masked_sum(fac * pd.zij, gate)
    mag = sqrt(nx * nx + ny * ny + nz * nz)
    keep = mag > 0.25 / scene.h
    inv = torch.where(keep, 1.0 / torch.clamp(mag, min=1e-300),
                      torch.zeros_like(mag))
    return torch.stack([nx * inv, ny * inv, nz * inv], -1)


def smooth_normals(scene, nbrs: NeighborList, kernel: Kernel, normal_tmp,
                   dest_mask, src_mask):
    """Kernel-smoothed normals -> ``normal`` [N, 3]."""
    pd = pair_data(scene, nbrs)
    j = pd.j
    gate = _gate(pd, dest_mask, src_mask)
    fac = (scene.m[j] / scene.rho[j]) * kernel.w(pd.rij, pd.hij)
    n = torch.stack([masked_sum(fac * normal_tmp[j, c], gate)
                     for c in range(3)], -1)
    mag = sqrt(torch.sum(n * n, -1))
    inv = torch.where(mag > 1e-3, 1.0 / torch.clamp(mag, min=1e-300),
                      torch.zeros_like(mag))
    return n * inv[:, None]


def identify_boundary_cos_angle(scene, nbrs: NeighborList, normal,
                                dest_mask, src_mask):
    """Surface flag -> ``is_boundary`` [N] int32 (1 = on the surface)."""
    pd = pair_data(scene, nbrs)
    candidate = torch.sum(normal * normal, -1) > 1e-6
    h_i = scene.h[:, None]
    in_range = (pd.rij > 1e-9 * h_i) & (pd.rij < 2.0 * h_i)
    gate = _gate(pd, dest_mask, src_mask) & in_range
    dot = -(normal[:, None, 0] * pd.xij + normal[:, None, 1] * pd.yij
            + normal[:, None, 2] * pd.zij)
    fac = torch.where(gate, dot / torch.clamp(pd.rij, min=1e-300),
                      torch.full_like(dot, -float("inf")))
    interior = torch.any(fac > 0.5, 1)
    return (candidate & dest_mask & ~interior).to(torch.int32)


def boundary_identification(scene, nbrs: NeighborList, kernel: Kernel,
                            dest_mask, src_mask=None):
    """The three passes; returns (normal [N, 3], is_boundary [N]).  The
    sources default to the destination group itself."""
    if src_mask is None:
        src_mask = dest_mask
    ntmp = compute_normals(scene, nbrs, kernel, dest_mask, src_mask)
    n = smooth_normals(scene, nbrs, kernel, ntmp, dest_mask, src_mask)
    isb = identify_boundary_cos_angle(scene, nbrs, n, dest_mask, src_mask)
    return n, isb
