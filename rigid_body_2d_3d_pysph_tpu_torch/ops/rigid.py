"""Rigid-body per-step ops: gravity load, per-body force/torque sums and
the batched body-frame linear algebra.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/rigid.py``.  The
reference's one-hot MXU contractions for body-row gathers are a TPU
device; here a body row is an index gather.  The per-body sums stay a
one-hot matrix product: it is deterministic (no atomics), so repeated
runs give identical bits, and it runs in full precision (the caller
keeps TF32 off, as the card's default is).  :func:`body_sums` gives the
same sums in another dtype: the slab step adds its slabs' partial sums
in float64 and rounds once.
"""

from __future__ import annotations

import torch


def gather_body_rows(arr, bid):
    """``arr[bid]`` for per-body state ``arr [B, ...]``."""
    return arr.index_select(0, bid)


def body_force(scene, gx: float, gy: float, gz: float, dest_mask):
    """f_i = m_i * g on destination particles, zero elsewhere (this
    also resets the per-evaluation force)."""
    m = torch.where(dest_mask, scene.m, torch.zeros_like(scene.m))
    return m * gx, m * gy, m * gz


def sum_up_external_forces(scene, fx, fy, fz):
    """Per-body total force and torque about the body's COM:
    ``frc[b] = sum_i f_i``, ``trq[b] = sum_i (r_i - xcm_b) x f_i``."""
    tot = body_sums(scene, fx, fy, fz, fx.dtype)
    return tot[:, :3], tot[:, 3:]


def body_sums(scene, fx, fy, fz, dtype):
    """``[B, 6]``: the per-body force and torque of
    :func:`sum_up_external_forces`, accumulated and returned in
    ``dtype``."""
    nb = scene.meta.nb
    rigid = scene.is_rigid & scene.active
    zero = torch.zeros_like(fx)
    bid = torch.where(rigid, scene.body_id, 0).to(torch.int64)
    fx = torch.where(rigid, fx, zero)
    fy = torch.where(rigid, fy, zero)
    fz = torch.where(rigid, fz, zero)

    xcm_p = gather_body_rows(scene.xcm, bid)
    dx = scene.x - xcm_p[:, 0]
    dy = scene.y - xcm_p[:, 1]
    dz = scene.z - xcm_p[:, 2]
    tx = dy * fz - dz * fy
    ty = dz * fx - dx * fz
    tz = dx * fy - dy * fx

    oh = ((bid[:, None] == torch.arange(nb, device=bid.device)[None, :])
          & rigid[:, None]).to(dtype)                      # [N, B]
    vec = torch.stack([fx, fy, fz, tx, ty, tz], dim=-1).to(dtype)  # [N, 6]
    return torch.matmul(oh.transpose(0, 1), vec)           # [B, 6]


def gram_schmidt_columns(R):
    """Re-orthonormalise rotation matrices [B, 3, 3] column by column
    (col0 -> col1 -> col2)."""
    a1, a2, a3 = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True)
    b2 = a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1
    b2 = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True)
    b3 = (a3 - torch.sum(b1 * a3, -1, keepdim=True) * b1
          - torch.sum(b2 * a3, -1, keepdim=True) * b2)
    b3 = b3 / torch.linalg.vector_norm(b3, dim=-1, keepdim=True)
    return torch.stack([b1, b2, b3], dim=-1)


def omega_cross_matrix(om):
    """[B, 3] -> [B, 3, 3] skew matrices with Omega @ v = om x v."""
    z = torch.zeros_like(om[..., 0])
    return torch.stack([
        torch.stack([z, -om[..., 2], om[..., 1]], -1),
        torch.stack([om[..., 2], z, -om[..., 0]], -1),
        torch.stack([-om[..., 1], om[..., 0], z], -1),
    ], dim=-2)


def rotate_body_frame_vectors(R, bid, vx, vy, vz):
    """dr = R[bid] @ (vx, vy, vz) per particle; returns (dx, dy, dz)."""
    Rb = gather_body_rows(R, bid)
    dx = Rb[:, 0, 0] * vx + Rb[:, 0, 1] * vy + Rb[:, 0, 2] * vz
    dy = Rb[:, 1, 0] * vx + Rb[:, 1, 1] * vy + Rb[:, 1, 2] * vz
    dz = Rb[:, 2, 0] * vx + Rb[:, 2, 1] * vy + Rb[:, 2, 2] * vz
    return dx, dy, dz
