"""Host-side rigid-body setup math (numpy, float64).

Counterpart of ``rigid_body_2d_3d_pysph_tpu/state/rigid_setup.py``:
total mass, centre of mass, inertia tensors (3D) and izz (2D),
body-frame position vectors and the restitution damping matrix.  The
math runs once on the host in float64 and is then cast to the scene's
working dtype on the scene's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .scene import Scene


def compute_body_masses(x, y, z, m, body_id, nb):
    """Per-body total mass and centre of mass."""
    total_mass = np.zeros(nb)
    xcm = np.zeros((nb, 3))
    np.add.at(total_mass, body_id, m)
    np.add.at(xcm[:, 0], body_id, m * x)
    np.add.at(xcm[:, 1], body_id, m * y)
    np.add.at(xcm[:, 2], body_id, m * z)
    if not (total_mass > 0).all():
        raise ValueError("every body needs a positive total mass")
    xcm /= total_mass[:, None]
    return total_mass, xcm


def compute_izz(x, y, m, body_id, xcm, nb):
    """2D scalar moment of inertia."""
    dx = x - xcm[body_id, 0]
    dy = y - xcm[body_id, 1]
    izz = np.zeros(nb)
    np.add.at(izz, body_id, m * (dx**2 + dy**2))
    return izz


def compute_eta(coeff_of_rest: np.ndarray, slot_mask: np.ndarray) -> np.ndarray:
    """Restitution -> damping factor matrix:
    ``eta[i, k] = -2 ln(e_ik) / sqrt(ln^2 e_ik + pi^2)`` for every slot k
    that is a real dem entity (the m_star factor is applied at force
    time, as in the reference implementation)."""
    coeff = np.asarray(coeff_of_rest, dtype=np.float64)
    with np.errstate(divide="ignore"):
        t1 = np.log(coeff)
    t2 = t1**2 + math.pi**2
    eta = -2.0 * t1 * np.sqrt(1.0 / t2)
    return np.where(np.asarray(slot_mask, bool)[None, :], eta, 0.0)


def _inertia_with_safe_inverse(x, y, z, m, body_id, xcm, nb):
    """Inertia tensors + inverse; exactly-zero diagonal entries of a
    singular tensor are regularised to 1 before inverting."""
    dx = x - xcm[body_id, 0]
    dy = y - xcm[body_id, 1]
    dz = z - xcm[body_id, 2]
    I = np.zeros((nb, 3, 3))
    np.add.at(I[:, 0, 0], body_id, m * (dy**2 + dz**2))
    np.add.at(I[:, 1, 1], body_id, m * (dx**2 + dz**2))
    np.add.at(I[:, 2, 2], body_id, m * (dx**2 + dy**2))
    np.add.at(I[:, 0, 1], body_id, -m * dx * dy)
    np.add.at(I[:, 0, 2], body_id, -m * dx * dz)
    np.add.at(I[:, 1, 2], body_id, -m * dy * dz)
    I[:, 1, 0] = I[:, 0, 1]
    I[:, 2, 0] = I[:, 0, 2]
    I[:, 2, 1] = I[:, 1, 2]
    I_inv = np.zeros_like(I)
    for b in range(nb):
        Ib = I[b]
        if abs(np.linalg.det(Ib)) < 1e-300:
            Ib = Ib.copy()
            for d in range(3):
                if Ib[d, d] == 0.0:
                    Ib[d, d] = 1.0
        I_inv[b] = np.linalg.inv(Ib)
    return I, I_inv


def setup_body_state(scene: Scene,
                     coeff_of_rest: np.ndarray | None = None) -> Scene:
    """Attach all per-body state and body-frame vectors to the scene."""
    meta = scene.meta
    nb, S = meta.nb, meta.total_no_bodies
    dev, fdt = scene.device, scene.dtype
    host = lambda k: scene[k].detach().cpu().numpy()

    x = host("x").astype(np.float64)
    y = host("y").astype(np.float64)
    z = host("z").astype(np.float64)
    m = host("m").astype(np.float64)
    body_id = host("body_id")
    is_rigid = host("is_rigid")

    bid = np.where(is_rigid, body_id, 0)
    mr = np.where(is_rigid, m, 0.0)
    total_mass, xcm = compute_body_masses(x, y, z, mr, bid, nb)
    I, I_inv = _inertia_with_safe_inverse(
        x[is_rigid], y[is_rigid], z[is_rigid], m[is_rigid],
        body_id[is_rigid], xcm, nb)
    izz = compute_izz(x[is_rigid], y[is_rigid], m[is_rigid],
                      body_id[is_rigid], xcm, nb)

    dx0 = np.where(is_rigid, x - xcm[bid, 0], 0.0)
    dy0 = np.where(is_rigid, y - xcm[bid, 1], 0.0)
    dz0 = np.where(is_rigid, z - xcm[bid, 2], 0.0)

    dem = host("dem_id")
    slot_mask = np.zeros(S, bool)
    slot_mask[np.unique(dem)] = True
    if coeff_of_rest is None:
        coeff_of_rest = np.ones((nb, S))
    eta = compute_eta(coeff_of_rest, slot_mask)

    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=fdt,
                                  device=dev)
    z3 = lambda: torch.zeros((nb, 3), dtype=fdt, device=dev)
    eye = np.broadcast_to(np.eye(3), (nb, 3, 3)).copy()
    fields = dict(
        dx0=t(dx0), dy0=t(dy0), dz0=t(dz0),
        fx=torch.zeros(scene.n, dtype=fdt, device=dev),
        fy=torch.zeros(scene.n, dtype=fdt, device=dev),
        fz=torch.zeros(scene.n, dtype=fdt, device=dev),
        total_mass=t(total_mass), xcm=t(xcm), xcm0=t(xcm),
        R=t(eye), R0=t(eye), izz=t(izz),
        inertia_tensor_body_frame=t(I),
        inertia_tensor_inverse_body_frame=t(I_inv),
        inertia_tensor_global_frame=t(I),
        inertia_tensor_inverse_global_frame=t(I_inv),
        force=z3(), torque=z3(), vcm=z3(), vcm0=z3(),
        ang_mom=z3(), ang_mom0=z3(), omega=z3(), omega0=z3(),
        eta=t(eta), coeff_of_rest=t(coeff_of_rest),
    )
    return scene.with_fields(**fields)
