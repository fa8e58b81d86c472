"""The devices a slab-decomposed run drives, one slab each.

Counterpart of ``make_mesh`` in
``rigid_body_2d_3d_pysph_tpu/parallel/sharded.py``: there a 1D JAX
``Mesh`` with axis ``"p"``; here the ordered list of torch devices that
one process drives, slab d on ``devices[d]``.  A list may name one
device more than once (P slabs on one card, or on the CPU in tests, as
the reference's tests run 8 virtual XLA:CPU devices).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch


@dataclass(frozen=True)
class Mesh:
    devices: tuple   # torch.device per slab, in ring order

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_dev: int, devices: Sequence | None = None) -> Mesh:
    """``n_dev`` slabs on ``devices`` (any torch devices, repeats
    allowed); ``None`` means ``cuda:0 ... cuda:n_dev-1`` and raises when
    fewer cards exist.  Nothing is folded onto fewer devices or moved to
    the CPU unless the list says so."""
    if n_dev < 1:
        raise ValueError(f"make_mesh: {n_dev} slabs")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_dev:
            raise RuntimeError(f"make_mesh: {n_dev} cards asked for, {have} "
                               "present; pass devices= to put several "
                               "slabs on one device")
        devices = [torch.device("cuda", d) for d in range(n_dev)]
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n_dev:
        raise ValueError(f"make_mesh: {len(devices)} devices for {n_dev} "
                         "slabs")
    return Mesh(devices)
