"""Fluid equation of state.

Counterpart of ``tait_eos`` in ``rigid_body_2d_3d_pysph_tpu/ops/fluid.py``.
The rest of that module is the ``[N, K]`` neighbour-list engine, which
the port does not carry: its pair passes run on the cell grid
(``ops/fluid_kernel.py``).
"""

from __future__ import annotations

import torch


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
