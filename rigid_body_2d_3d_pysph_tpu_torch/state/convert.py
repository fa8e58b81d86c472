"""Carry a reference scene's state over into the port.

``scene_from_numpy`` takes the fields of a JAX-package ``Scene`` as
numpy arrays plus its ``SceneMeta`` (read by attribute only, so this
module needs nothing from the JAX package) and builds the port's Scene
on ``device`` in ``dtype``.  Both sides then start from the same state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import config
from .scene import GroupSpec, Scene, SceneMeta


def meta_from(meta) -> SceneMeta:
    """A port ``SceneMeta`` from any object with the reference meta's
    attributes."""
    groups = tuple(GroupSpec(name=g.name, start=int(g.start),
                             stop=int(g.stop), role=g.role,
                             constants=tuple(g.constants))
                   for g in meta.groups)
    return SceneMeta(dim=int(meta.dim), groups=groups, nb=int(meta.nb),
                     total_no_bodies=int(meta.total_no_bodies),
                     spacing0=float(meta.spacing0))


def scene_from_numpy(fields: Dict[str, np.ndarray], meta, device,
                     dtype: torch.dtype) -> Scene:
    """Floating fields go to ``dtype``; integer fields to int32; bools
    stay bool."""
    config.check_dtype(dtype)
    out = {}
    for k, v in fields.items():
        a = np.array(v)   # a writable host copy
        if a.dtype == np.bool_:
            out[k] = torch.as_tensor(a, dtype=torch.bool, device=device)
        elif np.issubdtype(a.dtype, np.integer):
            out[k] = torch.as_tensor(a.astype(np.int32), device=device)
        else:
            out[k] = torch.as_tensor(a, device=device).to(dtype)
    return Scene(out, meta_from(meta))
