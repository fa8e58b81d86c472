"""Shared helpers of the ``[N, K]`` neighbour-list pair passes.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/pairs.py``.  A pair pass
gathers the source fields at the list's indices, computes the pair
quantities (x_ij, r_ij, h_ij), masks, and reduces over K (sums) or into
``[N, S]`` contact slots by source dem id.  Values are masked before a
sum, so an ``inf`` of a masked pair (a self pair's 1/r) never reaches it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ieee import sqrt
from .neighbors import NeighborList


class PairData(NamedTuple):
    j: torch.Tensor      # [N, K] neighbour indices
    mask: torch.Tensor   # [N, K] base validity
    xij: torch.Tensor    # [N, K] x_i - x_j
    yij: torch.Tensor
    zij: torch.Tensor
    rij: torch.Tensor    # [N, K] |x_ij|
    hij: torch.Tensor    # [N, K] (h_i + h_j) / 2


def pair_data(scene, nbrs: NeighborList) -> PairData:
    j = nbrs.idx
    xij = scene.x[:, None] - scene.x[j]
    yij = scene.y[:, None] - scene.y[j]
    zij = scene.z[:, None] - scene.z[j]
    rij = sqrt(xij * xij + yij * yij + zij * zij)
    hij = 0.5 * (scene.h[:, None] + scene.h[j])
    return PairData(j=j, mask=nbrs.mask, xij=xij, yij=yij, zij=zij,
                    rij=rij, hij=hij)


def masked_sum(values, mask, dim=1):
    return torch.sum(torch.where(mask, values, torch.zeros_like(values)),
                     dim=dim)


def scatter_to_slots(values, slot, mask, n_slots: int):
    """``[N, S]`` sums of the ``[N, K]`` pair values by slot (the source's
    dem id): S masked reductions over K, as the reference computes it."""
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    vals = torch.where(mask, values, zero)
    return torch.stack([torch.sum(torch.where(slot == s, vals, zero), 1)
                        for s in range(n_slots)], 1)


def _full_like(values, init):
    """``init`` in ``values``' dtype, made on its device (a host copy would
    wait for the stream)."""
    return torch.full((), init, dtype=values.dtype, device=values.device)


def scatter_min_to_slots(values, slot, mask, n_slots: int, init):
    """``[N, S]`` minima of the pair values by slot, starting from
    ``init``."""
    big = _full_like(values, init)
    vals = torch.where(mask, values, big)
    return torch.stack(
        [torch.minimum(torch.min(torch.where(slot == s, vals, big), 1).values,
                       big) for s in range(n_slots)], 1)


def argmin_to_slots(values, slot, mask, n_slots: int, init):
    """Per (particle, slot): the minimum (from ``init``), the column k of
    the first minimum in neighbour order (``torch.argmin`` returns the
    first), and whether one was found (strictly below ``init``)."""
    big = _full_like(values, init)
    vals = torch.where(mask, values, big)
    mins, args, founds = [], [], []
    for s in range(n_slots):
        v = torch.where(slot == s, vals, big)
        k_star = torch.argmin(v, 1)
        v_star = torch.gather(v, 1, k_star[:, None])[:, 0]
        mins.append(torch.minimum(v_star, big))
        args.append(k_star)
        founds.append(v_star < big)
    return torch.stack(mins, 1), torch.stack(args, 1), torch.stack(founds, 1)
