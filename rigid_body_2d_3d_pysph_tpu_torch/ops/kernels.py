"""The quintic B-spline SPH kernel (support 3h), PySPH semantics.

Counterpart of ``QuinticSpline`` in
``rigid_body_2d_3d_pysph_tpu/ops/kernels.py``; the other five kernels
of that module are not ported yet.

* ``w(rij, h)``            -> W_ij,
* ``dwdq(rij, h)``         -> dW/dq with q = rij / h,
* ``gradw_scalar(rij, h)`` -> s with DW_ij = s * x_ij (0 at rij = 0),
* ``w_gradw(rij, h)``      -> both from one evaluation (the fluid passes).

Integer powers are written as the multiplication chains XLA lowers
``x**n`` to (x^4 = (x^2)^2, x^5 = x * x^4), so the port's values follow
the reference's rounding, and ``csrc/contact.cu`` evaluates the same
chain.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

M_PI = math.pi


def _pow4(t):
    t2 = t * t
    return t2 * t2


def _pow5(t):
    return t * _pow4(t)


def _guarded_inv(r):
    eps = 1e-12
    return torch.where(r > eps, 1.0 / torch.clamp(r, min=eps),
                       torch.zeros_like(r))


@dataclass(frozen=True)
class QuinticSpline:
    dim: int = 2
    radius_scale: float = 3.0

    @property
    def sigma_denominator(self) -> float:
        """sigma(h) = num / (denominator * h^dim), num = 7 (2D) or 1."""
        if self.dim == 2:
            return 478.0 * M_PI
        return 120.0 * M_PI

    def sigma(self, h):
        if self.dim == 2:
            return 7.0 / (478.0 * M_PI * h * h)
        return 1.0 / (120.0 * M_PI * h * h * h)

    @staticmethod
    def _pieces(q):
        t3 = torch.clamp(3.0 - q, min=0.0)
        t2 = torch.clamp(2.0 - q, min=0.0)
        t1 = torch.clamp(1.0 - q, min=0.0)
        return t3, t2, t1

    def w(self, rij, h):
        q = rij / h
        t3, t2, t1 = self._pieces(q)
        val = _pow5(t3) - 6.0 * _pow5(t2) + 15.0 * _pow5(t1)
        return self.sigma(h) * val

    def dwdq(self, rij, h):
        q = rij / h
        t3, t2, t1 = self._pieces(q)
        val = -5.0 * _pow4(t3) + 30.0 * _pow4(t2) - 75.0 * _pow4(t1)
        return self.sigma(h) * val

    def gradw_scalar(self, rij, h):
        return self.dwdq(rij, h) / h * _guarded_inv(rij)

    def w_gradw(self, rij, h):
        """(w, gradw_scalar) from one q, one sigma and the shared 4th
        powers (t^5 = t^4 * t, the reference's chain), bit-identical to
        :meth:`w` and :meth:`gradw_scalar`."""
        q = rij / h
        t3, t2, t1 = self._pieces(q)
        t3_4, t2_4, t1_4 = _pow4(t3), _pow4(t2), _pow4(t1)
        sig = self.sigma(h)
        w = sig * (t3_4 * t3 - 6.0 * (t2_4 * t2) + 15.0 * (t1_4 * t1))
        dval = -5.0 * t3_4 + 30.0 * t2_4 - 75.0 * t1_4
        return w, sig * dval / h * _guarded_inv(rij)


KERNELS = {"quintic": QuinticSpline}


def get_kernel(name: str, dim: int) -> QuinticSpline:
    return KERNELS[name](dim=dim)
