"""Row-sharded execution: the particle axis split into contiguous blocks
over a list of devices.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/parallel/sharded.py``.  The
reference annotates every ``[N, ...]`` field as split by rows over a 1D
mesh, replicates the rest, and lets GSPMD turn the step's neighbour
gathers into all-gathers and its body ``segment_sum`` into partial sums
and an all-reduce.  Here one process drives the devices of a
:class:`~.mesh.Mesh` and does that work explicitly:

* :func:`pad_scene` rounds N up to a multiple of the mesh size with
  inactive rows parked far outside the domain (the reference's fills);
  :func:`shard_scene` pads and splits the particle-axis fields
  (:func:`scene_shardings`) into one contiguous block a device, block d
  on ``mesh.devices[d]``, every other field copied to each;
  :func:`gather_scene` puts the blocks back together (tests and IO).
* :func:`make_sharded_step` runs the slab steps' evaluation
  (``slab.rigid_step``, ``slab.dem_step``, ``slab.coupling_step``) with
  :class:`RowGather` as the ghost source: each device takes its own rows
  as queries and every other block's rows as source-only ghosts, sent by
  ``Tensor.to(device, non_blocking=True)``, on the scheme's own grid
  (each device's scene holds all N rows).  The body force and torque are
  the blocks' partial sums added in rank order in float64 and rounded
  once, as the slab steps add theirs.

The result is the scheme's single-device step on the padded scene to
summation order: a device's ghosts follow its own rows, so a cell's
lanes are ordered otherwise than in one scene.  The step repeats the
grid build and the pair passes over all N rows on every device (the
reference's GSPMD path is correct but, as its slab module says,
communication-oblivious): it is the reference's layout, not a way to
scale.  Nothing in a step reads the device from the host.
"""

from __future__ import annotations

from typing import List

import torch

from ..models import rigid_body as rb
from ..models.dem import DEMScheme
from ..models.rigid_fluid_coupling import (FLUID_FIELDS,
                                           RigidFluidCouplingScheme)
from ..state.scene import Scene
from . import slab
from .mesh import Mesh

# where the padding rows sit (the reference's ``far``)
FAR = 1.0e6


def scene_shardings(scene: Scene) -> dict:
    """The reference's rule as {field: True where split by rows, False
    where replicated}: a tensor whose first axis is the particle axis is
    split, anything else replicated."""
    return {k: slab._is_row(v, scene.n) for k, v in scene.fields.items()}


# the id fields a padding row holds at -1 (the reference's ``pad_scene``
# leaves ``dem_id`` at 0)
_PAD_IDS = ("tng_idx", "tng_idx_dem_id")


def pad_scene(scene: Scene, multiple: int) -> Scene:
    """The scene with N rounded up to a multiple of ``multiple`` by
    inactive rows at ``FAR`` (unit mass, density, h and moi; empty
    contact tables; every other field zero).  A compact contact store's
    empty entries (``cl_pid == N``) follow N to the padded count."""
    n = scene.n
    n_pad = (-n) % multiple
    if n_pad == 0:
        return scene
    fields = {}
    for k, v in scene.fields.items():
        if not slab._is_row(v, n):
            fields[k] = v
            continue
        pad = torch.full((n_pad,) + tuple(v.shape[1:]),
                         slab._pad_value(k, FAR, _PAD_IDS),
                         dtype=v.dtype, device=v.device)
        fields[k] = torch.cat([v, pad])
    if "cl_pid" in fields:
        pid = fields["cl_pid"]
        fields["cl_pid"] = torch.where(pid >= n, n + n_pad, pid)
    return Scene(fields, scene.meta)


def shard_scene(scene: Scene, mesh: Mesh) -> List[Scene]:
    """The padded scene's row blocks, block d on ``mesh.devices[d]``
    (rows ``[d N / D, (d + 1) N / D)``), every other field copied to
    each.  A compact contact store is expanded first.  A rigid scene
    then carries it as the row-aligned ``slot_blob``, so that each entry
    lives with the device that owns its row (the slab steps' blob
    layout), and the step takes the compact route; a coupling scene (its
    fluid fields) keeps the full ``[N, S]`` schema, which the coupling
    step reads, and the step takes the full route, whose per-particle
    result is the compact route's."""
    if "cl_pid" in scene:
        scene = rb.strip_compact_fields(rb.expand_slot_scene(scene))
        if FLUID_FIELDS[0] not in scene:
            scene = rb.blobify_slot_scene(scene)
    return slab.shard_slab_scene(pad_scene(scene, mesh.size), mesh)


def gather_scene(parts: List[Scene]) -> Scene:
    """The blocks as one padded scene on block 0's device (rows in block
    order, other fields from block 0, ``nbr_overflow`` of any block)."""
    return slab.gather_slab_scene(parts)


class RowGather:
    """The row-sharded step's ghost source: device d sends all its rows
    (an inactive row as an invalid ghost) to every other device, and
    receives the other blocks' rows in rank order, ``(D - 1) N / D`` ghost
    rows.  Nothing overflows."""

    def __init__(self, mesh: Mesh, nl: int):
        self.devices = mesh.devices
        self.n_ghost = (mesh.size - 1) * nl

    def rows(self, d: int, s: Scene):
        take = torch.arange(s.n, device=s.device)
        return ((take, s.active),), torch.zeros((), dtype=torch.bool,
                                                device=s.device)

    def route(self, bufs):
        out = []
        for d, dev in enumerate(self.devices):
            got = [b[0].to(dev, non_blocking=True)
                   for e, b in enumerate(bufs) if e != d]
            out.append(torch.cat(got, 0) if got else bufs[d][0][:0])
        return out


def _grid_config(scheme):
    """The scheme's grid, sized on the unpadded scene (padding rows sit
    at ``FAR``, so a config read from the padded positions would span
    them)."""
    if scheme._cell_cfg is None:
        raise ValueError("make_sharded_step: the scheme has no grid config; "
                         "size it on the unpadded scene first (setup, "
                         "cell_config or make_step)")
    return scheme._cell_cfg


def make_sharded_step(scheme, parts: List[Scene], mesh: Mesh):
    """The scheme's step over the row blocks of :func:`shard_scene`, as
    ``step(parts, dt) -> parts``: the rigid GTVF step (blob scenes the
    compact route, at the single-device capacity ``ni_max`` a device;
    full ``[N, S]`` scenes K2 on every slot), the DEM step (LVC
    displacement on the spill grid; the tables keep their partners'
    global rows, which are the blocks' gids) or the coupling step (kdk or
    kdkf; the full ``[N, S]`` schema).  A capacity overflow on any device
    raises ``nbr_overflow`` on every one.  Any other stepper raises
    ``NotImplementedError`` naming itself."""
    what = "make_sharded_step"
    if len(parts) != mesh.size:
        raise ValueError(f"{what}: {len(parts)} blocks, {mesh.size} devices")
    if scheme.engine != "cell":
        raise NotImplementedError(f"{what} runs the cell engine, not the "
                                  f"{scheme.engine!r} engine")
    nl = parts[0].n
    halo = RowGather(mesh, nl)
    cfg = _grid_config(scheme)
    if isinstance(scheme, RigidFluidCouplingScheme):
        inner = slab.coupling_step(scheme, parts, halo, cfg, what=what)
    elif isinstance(scheme, DEMScheme):
        if scheme.dem_grid != "spill":
            raise NotImplementedError(f"{what} runs the DEM spill grid, not "
                                      f"the {scheme.dem_grid!r} grid")

        def gid_of(d, s):
            return torch.arange(d * nl, (d + 1) * nl, dtype=torch.int32,
                                device=s.device)

        inner = slab.dem_step(scheme, parts, halo, cfg, mesh.size * nl,
                              gid_of, what=what)
    elif isinstance(scheme, rb._RigidBodySchemeBase):
        if scheme.uses_skin:
            raise NotImplementedError(f"{what} builds the grid every step; "
                                      "the Verlet skin (skin_factor > 0) "
                                      "is not sharded")
        inner = slab.rigid_step(scheme, parts, halo, cfg, what=what)
    else:
        raise NotImplementedError(f"{what}: {type(scheme).__name__}")

    def step(parts, dt):
        parts = inner(parts, dt)
        # an overflow anywhere is every device's
        anyo = slab._rank_sum([p.nbr_overflow.to(torch.int32)
                               for p in parts], mesh.devices)
        return [p.replace(nbr_overflow=a > 0) for p, a in zip(parts, anyo)]

    return step
