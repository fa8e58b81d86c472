"""Particle + rigid-body state as a dict of tensors plus static metadata.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/state/scene.py``.  All named
particle arrays of a simulation ("body", "tank", ...) are concatenated
into one Scene; group identity survives as a static table of index
ranges (``GroupSpec``) plus per-particle role masks.  Per-body state is
shaped (``xcm [B, 3]``, ``R [B, 3, 3]``, ``eta [B, S]``).

The Scene is a value: ``replace`` / ``with_fields`` return a new Scene
that shares the untouched tensors with the old one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import config

ROLE_RIGID = "rigid"
ROLE_BOUNDARY = "boundary"
ROLE_FLUID = "fluid"


@dataclass(frozen=True)
class GroupSpec:
    """Static description of one named particle array inside the Scene."""

    name: str
    start: int
    stop: int
    role: str
    constants: Tuple[Tuple[str, float], ...] = ()

    @property
    def size(self) -> int:
        return self.stop - self.start


@dataclass(frozen=True)
class SceneMeta:
    """Static scene metadata."""

    dim: int
    groups: Tuple[GroupSpec, ...]
    nb: int                # number of rigid bodies
    total_no_bodies: int   # S: contact slot count
    spacing0: float        # contact rest distance

    def group(self, name: str) -> GroupSpec:
        for g in self.groups:
            if g.name == name:
                return g
        raise KeyError(name)

    @property
    def n(self) -> int:
        return max(g.stop for g in self.groups) if self.groups else 0


class Scene:
    """SoA particle/body state: ``fields`` maps names to tensors."""

    def __init__(self, fields: Dict[str, torch.Tensor], meta: SceneMeta):
        object.__setattr__(self, "fields", fields)
        object.__setattr__(self, "meta", meta)

    def __setattr__(self, k, v):
        raise AttributeError("Scene is immutable; use replace/with_fields")

    def __getattr__(self, k):
        try:
            return self.fields[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __getitem__(self, k):
        return self.fields[k]

    def __contains__(self, k):
        return k in self.fields

    @property
    def n(self) -> int:
        return self.fields["x"].shape[0]

    @property
    def device(self) -> torch.device:
        return self.fields["x"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.fields["x"].dtype

    def replace(self, **kw) -> "Scene":
        new = dict(self.fields)
        for k, v in kw.items():
            if k not in new:
                raise KeyError(f"unknown field {k!r}; use with_fields to add")
            new[k] = v
        return Scene(new, self.meta)

    def with_fields(self, **kw) -> "Scene":
        new = dict(self.fields)
        new.update(kw)
        return Scene(new, self.meta)


@dataclass
class GroupArrays:
    """Host-side staging container for one named particle array."""

    name: str
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    m: np.ndarray
    h: np.ndarray
    rho: np.ndarray
    rad_s: np.ndarray
    role: str = ROLE_RIGID
    body_id: Optional[np.ndarray] = None
    dem_id: Optional[np.ndarray] = None
    constants: Dict[str, float] = dataclasses.field(default_factory=dict)
    extra: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return len(self.x)


def make_group(name: str, x, y, z=None, m=None, h=None, rho=None,
               rad_s=None, role: str = ROLE_RIGID, body_id=None,
               dem_id=None, constants: Optional[Dict[str, float]] = None,
               **extra) -> GroupArrays:
    """Build a staging group; scalars broadcast like PySPH's
    ``get_particle_array``."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64)).ravel()
    n = len(x)

    def _arr(v, default=0.0):
        if v is None:
            return np.full(n, default, dtype=np.float64)
        v = np.asarray(v, dtype=np.float64)
        return np.full(n, float(v), dtype=np.float64) if v.ndim == 0 \
            else v.ravel()

    def _iarr(v):
        if v is None:
            return None
        v = np.asarray(v, dtype=np.int32)
        return np.full(n, int(v), dtype=np.int32) if v.ndim == 0 \
            else v.ravel()

    return GroupArrays(
        name=name, x=x, y=_arr(y), z=_arr(z), m=_arr(m, 1.0),
        h=_arr(h, 1.0), rho=_arr(rho, 1.0), rad_s=_arr(rad_s, 0.0),
        role=role, body_id=_iarr(body_id), dem_id=_iarr(dem_id),
        constants=dict(constants or {}),
        extra={k: np.asarray(v) for k, v in extra.items()},
    )


def build_scene(groups, dim: int, total_no_bodies: Optional[int] = None,
                spacing0: float = 0.0, *, device: torch.device,
                dtype: torch.dtype) -> Scene:
    """Concatenate staging groups into a Scene with core fields.

    Rigid groups get global body indices: each rigid group's local
    ``body_id`` is offset by the number of bodies in preceding rigid
    groups."""
    config.check_dtype(dtype)
    idt = np.int32
    specs = []
    offset = 0
    body_offset = 0
    cat: Dict[str, list] = {
        "x": [], "y": [], "z": [], "u": [], "v": [], "w": [],
        "m": [], "h": [], "rho": [], "rad_s": [], "p": [],
        "body_id": [], "dem_id": [], "group_id": [],
        "is_rigid": [], "is_static_boundary": [], "is_fluid": [],
    }
    extra_cat: Dict[str, list] = {}

    for gi, g in enumerate(groups):
        n = g.size
        specs.append(GroupSpec(name=g.name, start=offset, stop=offset + n,
                               role=g.role,
                               constants=tuple(sorted(g.constants.items()))))
        for k in ("x", "y", "z", "m", "h", "rho", "rad_s"):
            cat[k].append(getattr(g, k))
        for k in ("u", "v", "w"):
            cat[k].append(np.zeros(n))
        extra = dict(g.extra)
        cat["p"].append(extra.pop("p", np.zeros(n)))

        if g.role == ROLE_RIGID:
            local_bid = g.body_id if g.body_id is not None \
                else np.zeros(n, idt)
            gbid = local_bid.astype(idt) + body_offset
            body_offset += int(local_bid.max()) + 1
        else:
            gbid = np.full(n, -1, idt)
        cat["body_id"].append(gbid)
        dem = g.dem_id if g.dem_id is not None else np.zeros(n, idt)
        cat["dem_id"].append(dem.astype(idt))
        cat["group_id"].append(np.full(n, gi, idt))
        cat["is_rigid"].append(np.full(n, g.role == ROLE_RIGID, bool))
        cat["is_static_boundary"].append(
            np.full(n, g.role == ROLE_BOUNDARY, bool))
        cat["is_fluid"].append(np.full(n, g.role == ROLE_FLUID, bool))
        for k, v in extra.items():
            extra_cat.setdefault(k, []).append((gi, v))
        offset += n

    if total_no_bodies is None:
        all_dem = np.concatenate(cat["dem_id"])
        total_no_bodies = int(all_dem.max()) + 1 if len(all_dem) else 1

    fields: Dict[str, torch.Tensor] = {}
    for k, vs in cat.items():
        arr = np.concatenate(vs) if vs else np.zeros(0)
        if k in ("body_id", "dem_id", "group_id"):
            fields[k] = torch.as_tensor(arr, dtype=torch.int32,
                                        device=device)
        elif k.startswith("is_"):
            fields[k] = torch.as_tensor(arr, dtype=torch.bool,
                                        device=device)
        else:
            fields[k] = torch.as_tensor(arr, dtype=dtype, device=device)

    for k, pieces in extra_cat.items():
        sample = pieces[0][1]
        full = np.zeros((offset,) + sample.shape[1:], dtype=np.float64)
        for gi, v in pieces:
            s = specs[gi]
            full[s.start:s.stop] = v
        fields[k] = torch.as_tensor(full, dtype=dtype, device=device)

    fields["active"] = torch.ones(offset, dtype=torch.bool, device=device)
    meta = SceneMeta(dim=dim, groups=tuple(specs), nb=body_offset,
                     total_no_bodies=int(total_no_bodies),
                     spacing0=float(spacing0))
    return Scene(fields, meta)
