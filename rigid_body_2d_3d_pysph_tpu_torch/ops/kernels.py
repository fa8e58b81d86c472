"""Closed-form SPH smoothing kernels, PySPH semantics.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/kernels.py``: the
quintic B-spline (support 3h, the rigid and coupling schemes' default),
the cubic B-spline (support 2h, the DEM scheme's), the Wendland C2 and
C4 quintics (2h), the Gaussian and the super-Gaussian (3h).

* ``w(rij, h)``            -> W_ij,
* ``dwdq(rij, h)``         -> dW/dq with q = rij / h,
* ``gradw_scalar(rij, h)`` -> s with DW_ij = s * x_ij (0 at rij = 0),
* ``w_gradw(rij, h)``      -> both from one evaluation (the fluid passes).

Integer powers are written as the multiplication chains XLA lowers
``x**n`` to (binary exponentiation: x^3 = x * x^2, x^4 = (x^2)^2,
x^5 = x * x^4, x^6 = x^2 * x^4), so the port's values follow the
reference's rounding.  Every kernel runs on both engines: the cell
engine's hand-written kernels (``csrc/contact.cu``, ``csrc/fluid.cu``)
evaluate the same chains in ``csrc/sph_kernels.cuh``, one library per
kernel (``device_id`` picks it at compile time), from the
``sigma_constants`` pair that ``sigma`` divides by.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import torch

from .ieee import exp

M_PI = math.pi


def _pow2(t):
    return t * t


def _pow3(t):
    return t * _pow2(t)


def _pow4(t):
    t2 = t * t
    return t2 * t2


def _pow5(t):
    return t * _pow4(t)


def _pow6(t):
    t2 = t * t
    return t2 * (t2 * t2)


def _hpow(h, dim: int):
    """h**dim (the integer-power chain)."""
    return {1: lambda t: t, 2: _pow2, 3: _pow3}[dim](h)


def _hchain(den, h, dim: int):
    """den * h * ... * h (dim factors of h, left to right): the
    denominator of ``num / (den * h * h)`` as Python evaluates it."""
    t = den * h
    for _ in range(dim - 1):
        t = t * h
    return t


def _guarded_inv(r):
    eps = 1e-12
    return torch.where(r > eps, 1.0 / torch.clamp(r, min=eps),
                       torch.zeros_like(r))


def _pos(t):
    return torch.clamp(t, min=0.0)


def _within(q, val, limit=3.0):
    """``val`` where q <= limit, 0 beyond."""
    return torch.where(q <= limit, val, torch.zeros_like(val))


@dataclass(frozen=True)
class Kernel:
    """Base class; ``radius_scale`` is the support radius in units of h."""

    dim: int = 2
    radius_scale: float = 2.0

    #: the name in ``KERNELS`` and the id of its device code
    #: (``csrc/sph_kernels.cuh``, built with ``-DRB_SPH_KERNEL=<id>``)
    name: ClassVar[str] = ""
    device_id: ClassVar[int] = -1

    def sigma_constants(self) -> tuple:
        """(num, den) with sigma(h) = num / (den h^dim); the kernel
        wrappers hand both to the device code as float32."""
        raise NotImplementedError

    def sigma(self, h):
        num, den = self.sigma_constants()
        return num / _hchain(den, h, self.dim)

    def w(self, rij, h):
        raise NotImplementedError

    def dwdq(self, rij, h):
        raise NotImplementedError

    def gradw_scalar(self, rij, h):
        """s with DW_ij = s * x_ij: dW/dq / (h * rij), 0 at rij = 0."""
        return self.dwdq(rij, h) / h * _guarded_inv(rij)

    def w_gradw(self, rij, h):
        """(w, gradw_scalar); the quintic overrides it to share pieces."""
        return self.w(rij, h), self.gradw_scalar(rij, h)


@dataclass(frozen=True)
class QuinticSpline(Kernel):
    """Quintic B-spline, support 3h."""

    radius_scale: float = 3.0
    name = "quintic"
    device_id = 0

    def sigma_constants(self):
        if self.dim == 2:
            return 7.0, 478.0 * M_PI
        return 1.0, 120.0 * M_PI

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


@dataclass(frozen=True)
class CubicSpline(Kernel):
    """Cubic B-spline, support 2h (the DEM scheme's default)."""

    radius_scale: float = 2.0
    name = "cubic"
    device_id = 1

    def sigma_constants(self):
        if self.dim == 1:
            return 2.0, 3.0
        if self.dim == 2:
            return 10.0, 7.0 * M_PI
        return 1.0, M_PI

    def w(self, rij, h):
        q = rij / h
        inner = 1.0 - 1.5 * q * q * (1.0 - 0.5 * q)
        outer = 0.25 * _pow3(_pos(2.0 - q))
        return self.sigma(h) * torch.where(q <= 1.0, inner, outer)

    def dwdq(self, rij, h):
        q = rij / h
        inner = -3.0 * q + 2.25 * q * q
        outer = -0.75 * _pow2(_pos(2.0 - q))
        return self.sigma(h) * torch.where(q <= 1.0, inner, outer)


@dataclass(frozen=True)
class WendlandQuintic(Kernel):
    """Wendland C2 quintic, support 2h (dim >= 2)."""

    radius_scale: float = 2.0
    name = "wendland"
    device_id = 2

    def sigma_constants(self):
        if self.dim == 2:
            return 7.0, 4.0 * M_PI
        return 21.0, 16.0 * M_PI

    def w(self, rij, h):
        q = rij / h
        t = _pos(1.0 - 0.5 * q)
        return self.sigma(h) * _pow4(t) * (2.0 * q + 1.0)

    def dwdq(self, rij, h):
        q = rij / h
        t = _pos(1.0 - 0.5 * q)
        return self.sigma(h) * (-5.0 * q) * _pow3(t)


@dataclass(frozen=True)
class WendlandQuinticC4(Kernel):
    """Wendland C4, support 2h (dim >= 2)."""

    radius_scale: float = 2.0
    name = "wendland_c4"
    device_id = 3

    def sigma_constants(self):
        if self.dim == 2:
            return 9.0, 4.0 * M_PI
        return 495.0, 256.0 * M_PI

    def w(self, rij, h):
        q = rij / h
        t = _pos(1.0 - 0.5 * q)
        return (self.sigma(h) * _pow6(t)
                * (35.0 / 12.0 * q * q + 3.0 * q + 1.0))

    def dwdq(self, rij, h):
        q = rij / h
        t = _pos(1.0 - 0.5 * q)
        return (self.sigma(h) * (-14.0 / 3.0) * q * (1.0 + 2.5 * q)
                * _pow5(t))


@dataclass(frozen=True)
class Gaussian(Kernel):
    """Gaussian kernel, support 3h."""

    radius_scale: float = 3.0
    name = "gaussian"
    device_id = 4

    def sigma_constants(self):
        return 1.0, M_PI ** (self.dim / 2.0)

    def sigma(self, h):
        """1 / (pi^(d/2) h^d), h^d as the chain h * (h * h)."""
        num, den = self.sigma_constants()
        return num / (den * _hpow(h, self.dim))

    def w(self, rij, h):
        q = rij / h
        return _within(q, self.sigma(h) * exp(-q * q))

    def dwdq(self, rij, h):
        q = rij / h
        return _within(q, self.sigma(h) * (-2.0 * q) * exp(-q * q))


@dataclass(frozen=True)
class SuperGaussian(Kernel):
    """Super-Gaussian kernel, support 3h."""

    radius_scale: float = 3.0
    name = "super_gaussian"
    device_id = 5

    def sigma_constants(self):
        return 1.0, M_PI ** (self.dim / 2.0)

    def sigma(self, h):
        """1 / (pi^(d/2) h^d), h^d as the chain h * (h * h)."""
        num, den = self.sigma_constants()
        return num / (den * _hpow(h, self.dim))

    def w(self, rij, h):
        q = rij / h
        d = self.dim
        return _within(q, self.sigma(h) * exp(-q * q)
                       * (d / 2.0 + 1.0 - q * q))

    def dwdq(self, rij, h):
        q = rij / h
        d = self.dim
        val = exp(-q * q) * (-2.0 * q) * (d / 2.0 + 2.0 - q * q)
        return _within(q, self.sigma(h) * val)


KERNELS = {
    "quintic": QuinticSpline,
    "cubic": CubicSpline,
    "wendland": WendlandQuintic,
    "wendland_c4": WendlandQuinticC4,
    "gaussian": Gaussian,
    "super_gaussian": SuperGaussian,
}


def get_kernel(name: str, dim: int) -> Kernel:
    return KERNELS[name](dim=dim)
