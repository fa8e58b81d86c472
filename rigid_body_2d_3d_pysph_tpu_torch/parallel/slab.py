"""Spatially local multi-device execution: the x-slab decomposition of
the rigid, DEM and rigid-fluid coupling steps, with ring halo exchanges.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/parallel/slab.py``.  The
reference is single-controller: one
``shard_map`` over a 1D mesh runs every slab, halos move by
``ppermute`` and the per-body sums by ``psum``.  Here one process drives
the list of devices of a :class:`~.mesh.Mesh` (slab d on
``mesh.devices[d]``; a device may hold several slabs):

* The cell grid's geometry stays global; slab d owns the cell columns
  ``[d W, (d + 1) W)`` and bins its own particles plus the ghosts it
  receives, on a local grid of ``nc_max_local`` slots.
* :func:`slab_decompose` (host, numpy) orders the particles by slab and
  pads each slab to ``n_cap`` rows; :func:`shard_slab_scene` splits that
  scene into one local scene a slab, on its device, and
  :func:`gather_slab_scene` puts them back together (tests and IO).
  :func:`redistribute` (host) and :func:`make_slab_redistribute` (on the
  devices) re-establish ownership between chunks of steps.
* A step compacts each slab's rows within ``halo_width`` of its faces
  into ``[halo_cap, F + 1]`` buffers (a validity column), sends them to
  the ring neighbours (``Tensor.to(device, non_blocking=True)``; the
  edge slabs receive zero buffers, valid = 0) and appends the received
  rows as source-only ghosts.  The body force and torque are the
  slabs' partial sums added in rank order and handed to every slab,
  accumulated in float64 and rounded once to the scene's dtype, so the
  total does not depend on how the particles split into slabs but for
  ties.
  Nothing in a step reads the device from the host: capacity overflows
  fold into ``nbr_overflow``.
* A received buffer or the summed force may be the sender's own tensor
  (``Tensor.to`` of the current device returns it): nothing here writes
  into a tensor in place.
* The ghosts come from a halo object: :class:`RingHalo` (the face rows,
  to the ring neighbours) for the slab steps, ``sharded.RowGather``
  (every other block's rows) for the row-sharded step of
  ``parallel/sharded.py``; both run one evaluation (:func:`rigid_step`,
  :func:`dem_step`, :func:`coupling_step`).

Each slab's evaluation runs the hand-written kernels of the
single-device paths: the rigid blob route K1 (``csrc/pack_expand.cu``),
the interest cull and K2 (``csrc/contact.cu``) on the culled rows; the
full ``[N, S]`` route K1 and K2 on every slot; the DEM step K1 and K4
(``csrc/dem.cu`` ``dem_cell``); the coupling step K1, the fluid passes of
its ordering (``csrc/fluid.cu``: kdk B6a, B6b, B6c; kdkf B4, B6c) and K2
on every slot.  ``plain=True`` runs their plain versions instead, on any
device.

The base grid may be the spill grid or a classic one (one slot a cell,
``cellpairs.config_from_positions(..., spill=False)``, or ``sub >= 2``),
as the reference's slab steps build whatever base they are given.  On a
classic base each pack is gathered through the local grid's ``slot2p``
(no K1: ``contact_kernel.pack_classic``, ``dem_kernel.dem_pack``,
``fluid_kernel.pack_fluid_classic``) and the same kernels run at the
base's lane width; the rigid blob route needs the spill grid and raises
on a classic base, as the reference's sorted build does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..models import dem as dem_model
from ..models import rigid_body as rb
from ..models import rigid_fluid_coupling as cpl
from ..ops import cellpairs as cellmod
from ..ops import contact_kernel as tck
from ..ops import dem_kernel as dk
from ..ops import fluid_kernel as fk
from ..ops import rigid as rops
from ..ops.fluid import tait_eos
from ..ops.kernels import get_kernel
from ..state.scene import Scene
from .mesh import Mesh

# fields a ghost (source-only) particle carries into the contact pass
GHOST_FIELDS = ("x", "y", "z", "u", "v", "w", "h", "m", "rho",
                "contact_force_is_boundary")
# ghost columns of the DEM pass
DEM_GHOST_FIELDS = ("x", "y", "z", "u", "v", "w", "wx", "wy", "wz",
                    "rad_s", "m")
_BIG = 1.0e9
# integers (gids, table entries) ride float columns: exact below 2^24 in
# float32
MAX_GID = 1 << 24
# make_slab_config's headroom over the initial state: slab rows, face
# band rows, occupied grid slots
CAP_SAFETY = 1.35
HALO_SAFETY = 2.0
SLOT_SAFETY = 1.6


@dataclass(frozen=True)
class SlabConfig:
    """Static decomposition parameters (the same for every slab)."""

    base: cellmod.CellGridConfig  # global grid geometry
    n_dev: int                    # slabs along x
    slab_cells: int               # owned cell columns a slab
    n_cap: int                    # particle rows a slab
    halo_cap: int                 # ghost rows a face
    nc_max_local: int             # occupied-slot bound a slab

    @property
    def halo_width(self) -> float:
        # one stencil ring of cells covers the cutoff
        return self.base.cell * self.base.sub

    def slab_lo(self, d: int) -> float:
        """x of slab d's lower face."""
        return self.base.origin[0] + (self.base.sub + d * self.slab_cells
                                      ) * self.base.cell


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _slab_of(x, cfg: SlabConfig) -> np.ndarray:
    """Owning slab per particle (clipped to the mesh), on the host."""
    cx = np.floor((_host(x) - cfg.base.origin[0]) / cfg.base.cell
                  ).astype(np.int64) - cfg.base.sub
    return np.clip(cx // cfg.slab_cells, 0, cfg.n_dev - 1)


def _is_row(v, n: int) -> bool:
    return torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == n


# the fields an inactive padding row holds at -1
_PAD_IDS = ("gid", "tng_idx", "tng_idx_dem_id", "dem_id")


def _pad_value(k: str, far: float = _BIG, ids=_PAD_IDS) -> float:
    """The fill of an inactive padding row: positions at ``far``; unit
    mass, density, h and moi; -1 in the id fields ``ids``; 0 (``active``
    False) elsewhere."""
    if k in ("x", "y", "z"):
        return far
    if k in ("m", "rho", "h", "moi"):
        return 1.0
    if k in ids:
        return -1.0
    return 0.0


def make_slab_config(scene: Scene, base: cellmod.CellGridConfig,
                     n_dev: int) -> SlabConfig:
    """Size the decomposition from the current particle positions (host
    side): ``n_cap`` CAP_SAFETY x the fullest slab and ``halo_cap``
    HALO_SAFETY x the fullest face band, each rounded up to a multiple of
    8, ``nc_max_local`` SLOT_SAFETY x the most slots a slab and its two
    neighbours occupy."""
    interior = base.dims[0] - 2 * base.sub
    slab_cells = -(-interior // n_dev)
    cfg = SlabConfig(base=base, n_dev=n_dev, slab_cells=int(slab_cells),
                     n_cap=0, halo_cap=0, nc_max_local=0)
    x = _host(scene.x)
    slab = _slab_of(x, cfg)
    counts = np.bincount(slab, minlength=n_dev)
    n_cap = int(-(-int(counts.max() * CAP_SAFETY) // 8) * 8)
    w = cfg.halo_width
    h_max = 0
    for d in range(n_dev):
        lo, hi = cfg.slab_lo(d), cfg.slab_lo(d + 1)
        h_max = max(h_max, int(((x >= lo) & (x < lo + w)).sum()),
                    int(((x >= hi - w) & (x < hi)).sum()))
    halo_cap = int(-(-max(8, int(h_max * HALO_SAFETY)) // 8) * 8)
    cells = np.floor((x - base.origin[0]) / base.cell).astype(np.int64)
    cy = np.floor((_host(scene.y) - base.origin[1]) / base.cell
                  ).astype(np.int64)
    cz = (np.floor((_host(scene.z) - base.origin[2]) / base.cell
                   ).astype(np.int64) if base.dim == 3
          else np.zeros_like(cells))
    nc_local = 0
    for d in range(n_dev):
        m = (slab >= max(d - 1, 0)) & (slab <= min(d + 1, n_dev - 1))
        _, cnts = np.unique(np.stack([cells[m], cy[m], cz[m]], 1),
                            axis=0, return_counts=True)
        occ = int((-(-cnts // base.M)).sum()) if base.spill else len(cnts)
        nc_local = max(nc_local, occ)
    return SlabConfig(base=base, n_dev=n_dev, slab_cells=int(slab_cells),
                      n_cap=n_cap, halo_cap=halo_cap,
                      nc_max_local=max(64, int(nc_local * SLOT_SAFETY)))


def slab_decompose(scene: Scene, cfg: SlabConfig,
                   use_blob: bool = True) -> Scene:
    """Host side: the particles ordered by owning slab, each slab padded
    to ``n_cap`` rows with inactive sentinels: one ``[n_dev * n_cap]``
    scene on the input's device.  On a rigid scene a compact slot store
    is expanded and dropped first; ``use_blob`` (the default, the route
    of the single-device GTVF step) stores the 25 ``[N, S]`` slot fields
    as one ``slot_blob`` (the compact slab route), else the full schema
    (the slab step then runs K2 on every slot).  A scene without slot
    fields (DEM) is decomposed as it is."""
    if "cl_pid" in scene:
        scene = rb.strip_compact_fields(rb.expand_slot_scene(scene))
    if use_blob and rb.CL_FIELDS[0] in scene:
        scene = rb.blobify_slot_scene(scene)
    elif not use_blob and "slot_blob" in scene:
        scene = rb.deblobify_slot_scene(scene)
    slab = _slab_of(scene.x, cfg)
    n = scene.n
    parts, pads = [], []
    for d in range(cfg.n_dev):
        idx = np.nonzero(slab == d)[0]
        if len(idx) > cfg.n_cap:
            raise RuntimeError(f"slab {d} holds {len(idx)} > capacity "
                               f"{cfg.n_cap}")
        parts.append(idx)
        pads.append(cfg.n_cap - len(idx))
    fields = {}
    for k, v in scene.fields.items():
        if not _is_row(v, n):
            fields[k] = v
            continue
        arr = _host(v)
        out = []
        for idx, n_pad in zip(parts, pads):
            out.append(arr[idx])
            if n_pad:
                out.append(np.full((n_pad,) + arr.shape[1:], _pad_value(k),
                                   arr.dtype))
        fields[k] = torch.as_tensor(np.concatenate(out), device=v.device)
    out = Scene(fields, scene.meta)
    return out.replace(active=out.active & (out.x < _BIG / 2))


def redistribute(scene: Scene, cfg: SlabConfig) -> Scene:
    """Host side re-decomposition between chunks of steps: the active
    rows of a decomposed scene (:func:`gather_slab_scene`) decomposed
    again by their current positions, in the scene's slot layout."""
    keep = torch.as_tensor(np.nonzero(_host(scene.active))[0],
                           device=scene.device)
    n = scene.n
    fields = {k: (v[keep] if _is_row(v, n) else v)
              for k, v in scene.fields.items()}
    return slab_decompose(Scene(fields, scene.meta), cfg,
                          use_blob="slot_blob" in scene)


def attach_gids(scene: Scene) -> Scene:
    """Persistent particle ids (int32 row index at attach time), before
    :func:`slab_decompose`: the slab DEM step keys its contact tables on
    them, so the tables survive ghost renumbering and redistribution.
    They ride float columns in the exchanges, so ``n`` stays below
    2^24."""
    if scene.n >= MAX_GID:
        raise ValueError(f"attach_gids: {scene.n} particles; gids ride "
                         f"float32 columns, exact below {MAX_GID}")
    return scene.with_fields(gid=torch.arange(scene.n, dtype=torch.int32,
                                              device=scene.device))


def shard_slab_scene(scene: Scene, mesh: Mesh) -> List[Scene]:
    """Split a decomposed scene into its slabs' local scenes, slab d on
    ``mesh.devices[d]``: rows ``[d n_cap, (d + 1) n_cap)``, every other
    field (the bodies, the materials, the flags) copied to each."""
    D = mesh.size
    n = scene.n
    if n % D:
        raise ValueError(f"shard_slab_scene: {n} rows over {D} slabs")
    nl = n // D
    out = []
    for d, dev in enumerate(mesh.devices):
        fields = {k: (v[d * nl:(d + 1) * nl] if _is_row(v, n) else v
                      ).to(dev).clone() for k, v in scene.fields.items()}
        out.append(Scene(fields, scene.meta))
    return out


def gather_slab_scene(parts: List[Scene]) -> Scene:
    """The slabs' local scenes as one decomposed scene on slab 0's
    device: rows concatenated in slab order, other fields from slab 0,
    ``nbr_overflow`` of any slab."""
    dev = parts[0].device
    nl = parts[0].n
    fields = {}
    for k, v in parts[0].fields.items():
        if _is_row(v, nl):
            fields[k] = torch.cat([p[k].to(dev) for p in parts])
        else:
            fields[k] = v
    if "nbr_overflow" in fields:
        ovf = fields["nbr_overflow"]
        for p in parts[1:]:
            ovf = ovf | p.nbr_overflow.to(dev)
        fields["nbr_overflow"] = ovf
    return Scene(fields, parts[0].meta)


# ---------------------------------------------------------------------------
# per-slab pieces of the steps
# ---------------------------------------------------------------------------

def _take_rows(cols, take, valid, flag_at=None):
    """``[cap, F + 1]``: rows ``take`` of the columns (zero where not
    ``valid``) with the validity column inserted at ``flag_at`` (last by
    default)."""
    flag_at = len(cols) if flag_at is None else flag_at
    buf = torch.stack(cols, 1)[take]
    buf = torch.where(valid[:, None], buf, torch.zeros_like(buf))
    flag = valid.to(buf.dtype)[:, None]
    return torch.cat([buf[:, :flag_at], flag, buf[:, flag_at:]], 1)


def _first_rows(mask, cap: int):
    """The first ``cap`` rows matching ``mask`` (stable order): (rows,
    valid, whether more rows matched than fit)."""
    n = mask.shape[0]
    order = torch.argsort((~mask).to(torch.int32), stable=True)
    count = mask.sum()
    idx = torch.arange(cap, device=mask.device)
    return order[torch.clamp(idx, max=n - 1)], idx < count, count > cap


def _compact_rows(mask, cols, cap: int, flag_at=None):
    """The first ``cap`` rows matching ``mask`` (stable order) as a
    ``[cap, F + 1]`` buffer with a validity column (at ``flag_at``, last
    by default), and whether more rows matched than fit."""
    take, valid, ovf = _first_rows(mask, cap)
    return _take_rows(cols, take, valid, flag_at), ovf


def _face_rows(m_left, m_right, cap: int, two_faces: bool):
    """Each face's first ``cap`` band rows as ((rows, valid) left,
    (rows, valid) right, overflow).  ``two_faces`` takes both from one
    stable 3-way sort (left band 0, right band 1, rest 2: the sorted
    prefix is the left band, the following run the right one), which
    needs disjoint bands (slabs of at least 2 cells); the rows equal two
    :func:`_first_rows` calls."""
    if not two_faces:
        tl, vl, ovl = _first_rows(m_left, cap)
        tr, vr, ovr = _first_rows(m_right, cap)
        return (tl, vl), (tr, vr), ovl | ovr
    n = m_left.shape[0]
    key = torch.where(m_left, 0, torch.where(m_right, 1, 2))
    order = torch.argsort(key.to(torch.int32), stable=True)
    nl, nr = m_left.sum(), m_right.sum()
    idx = torch.arange(cap, device=m_left.device)
    return ((order[torch.clamp(idx, max=n - 1)], idx < nl),
            (order[torch.clamp(nl + idx, max=n - 1)], idx < nr),
            (nl > cap) | (nr > cap))


def _face_masks(s: Scene, d: int, cfg: SlabConfig):
    """Slab d's active rows within ``halo_width`` of its lower and upper
    faces."""
    w = cfg.halo_width
    return (s.active & (s.x < cfg.slab_lo(d) + w),
            s.active & (s.x >= cfg.slab_lo(d + 1) - w))


def _ring(left_bufs, right_bufs, devices):
    """The ring sends: slab d receives slab d-1's right buffer and slab
    d+1's left buffer (zeros at the edges, valid = 0) as ``[2H, F]``."""
    D = len(devices)
    out = []
    for d, dev in enumerate(devices):
        fl = (right_bufs[d - 1].to(dev, non_blocking=True) if d > 0
              else torch.zeros_like(right_bufs[d]))
        fr = (left_bufs[d + 1].to(dev, non_blocking=True) if d < D - 1
              else torch.zeros_like(left_bufs[d]))
        out.append(torch.cat([fl, fr], 0))
    return out


class RingHalo:
    """The slab ring as a ghost source: slab d sends its active rows
    within ``halo_width`` of each face (the first ``halo_cap`` of each)
    to the neighbour across that face, and receives ``2 halo_cap`` ghost
    rows (:func:`_ring`).  The row-sharded step's source is
    ``sharded.RowGather``; the step builders below take either."""

    def __init__(self, mesh: Mesh, cfg: SlabConfig):
        self.devices = mesh.devices
        self.cfg = cfg
        self.n_ghost = 2 * cfg.halo_cap

    def rows(self, d: int, s: Scene):
        """The rows slab d sends, as a list of (rows, valid) selections,
        and whether more rows matched than fit."""
        rl, rr, ovf = _face_rows(*_face_masks(s, d, self.cfg),
                                 self.cfg.halo_cap, self.cfg.slab_cells >= 2)
        return (rl, rr), ovf

    def route(self, bufs):
        """``bufs[d]``: slab d's buffers, one a selection of
        :meth:`rows` -> each slab's received ``[n_ghost, F]``."""
        return _ring([b[0] for b in bufs], [b[1] for b in bufs],
                     self.devices)


def _ghost_tails(g, fields, flag: int, dem: int):
    """The ghost rows from the received buffers ``g`` (``fields`` in
    column order, the validity flag in column ``flag``, the dem id in
    column ``dem``): an invalid row sits far away with dem id -1.
    Returns (valid, field -> ghost column)."""
    gv = g[:, flag] > 0.5
    tails = {k: g[:, i] for i, k in enumerate(fields)}
    for k in ("x", "y", "z"):
        tails[k] = torch.where(gv, tails[k], torch.full_like(tails[k], _BIG))
    tails["dem_id"] = torch.where(gv, g[:, dem].to(torch.int32), -1)
    tails["active"] = gv
    return gv, tails


def _rank_sum(vals, devices):
    """The reference's ``psum``: the slabs' tensors added in rank order
    (on slab 0's device), the total handed to every slab."""
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v.to(acc.device, non_blocking=True)
    return [acc.to(dev, non_blocking=True) for dev in devices]


def _extend(scene_l: Scene, n_ghost: int, tails: dict) -> Scene:
    """The local scene with ``n_ghost`` ghost rows appended: ``tails[k]``
    where given, else zeros (so ``is_rigid`` = 0: ghosts are never
    queries and add nothing to a body sum)."""
    nl = scene_l.n
    ext = {}
    for k, v in scene_l.fields.items():
        if not _is_row(v, nl):
            ext[k] = v
            continue
        tail = tails.get(k)
        if tail is None:
            tail = torch.zeros((n_ghost,) + tuple(v.shape[1:]),
                               dtype=v.dtype, device=v.device)
        ext[k] = torch.cat([v, tail.to(v.dtype)], 0)
    return Scene(ext, scene_l.meta)


def on_device(dev):
    """The kernel wrappers launch on the current CUDA device: make it
    the slab's for its evaluation (a no-op on one card and on the
    CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _drop_ghosts(scene_e: Scene, nl: int, n_ghost: int) -> Scene:
    return Scene({k: (v[:nl] if _is_row(v, nl + n_ghost) else v)
                  for k, v in scene_e.fields.items()}, scene_e.meta)


def local_grid_config(cfg: SlabConfig) -> cellmod.CellGridConfig:
    """A slab's grid: the global geometry with ``nc_max_local`` slots
    (the chunk of the plain versions' passes covers all of them)."""
    chunk = min(cfg.base.cell_chunk, -(-cfg.nc_max_local // 8) * 8)
    return dataclasses.replace(cfg.base, NC_max=cfg.nc_max_local,
                               cell_chunk=chunk, skin=0.0)


def _check_engine(scheme, what: str):
    """The slab steps run the cell engine only, as the reference's do."""
    if scheme.engine != "cell":
        raise ValueError(f"{what} runs the cell engine; the scheme's engine "
                         f"is {scheme.engine!r} (set engine='cell')")


def _check_parts(parts, mesh: Mesh, cfg: SlabConfig):
    if len(parts) != mesh.size or mesh.size != cfg.n_dev:
        raise ValueError(f"{len(parts)} local scenes, {mesh.size} devices, "
                         f"{cfg.n_dev} slabs")


# ---------------------------------------------------------------------------
# the rigid slab step
# ---------------------------------------------------------------------------

def make_slab_step(scheme, parts: List[Scene], mesh: Mesh, cfg: SlabConfig,
                   chain: int = 1, plain: bool = False):
    """The rigid GTVF step over the slabs, as ``step(parts, dt) ->
    parts``: per slab the half-kick, the face compaction, the ring
    exchange, the local evaluation on the slab and its ghosts, the
    rank-order sum of the body force and torque, the drift and the second
    half-kick.  Blob scenes (``slot_blob``) take the compact route (K1,
    the cull, K2 on the culled rows; ``n_interesting`` per slab), full
    ``[N, S]`` scenes K1 and K2 on every slot with the ``[N, S]`` tail.
    On a classic base the full route gathers its pack (no K1) and runs
    K2 at the base's width; the blob route raises there.
    ``chain`` steps a call; ``plain`` runs the kernels' plain versions.
    ``step.exchange(parts, dt)`` runs the stage before the evaluation
    (the kicked scenes, the extended scenes, the face overflows): the
    kernels' inputs at the slab path's shapes."""
    _check_engine(scheme, "make_slab_step")
    _check_parts(parts, mesh, cfg)
    return rigid_step(scheme, parts, RingHalo(mesh, cfg),
                      local_grid_config(cfg), chain, plain, "make_slab_step")


def rigid_step(scheme, parts: List[Scene], halo, local_cfg, chain: int = 1,
               plain: bool = False, what: str = "the rigid step"):
    """:func:`make_slab_step` with the ghosts from ``halo``
    (:class:`RingHalo` or ``sharded.RowGather``), each device's rows and
    ghosts on the grid ``local_cfg``; the compact route's capacity is the
    scheme's ``ni_max`` on that grid."""
    if scheme.integrator != "gtvf":
        raise NotImplementedError(f"{what} runs the GTVF integrator, not "
                                  f"{scheme.integrator!r}")
    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    params = dict(kr=scheme.kr, kf=scheme.kf, fric_coeff=scheme.fric_coeff,
                  gx=scheme.gx, gy=scheme.gy, gz=scheme.gz)
    two_d = scheme.two_d
    ni_max = scheme.ni_max(local_cfg)
    NG = halo.n_ghost
    NGF = len(GHOST_FIELDS)
    blob = "slot_blob" in parts[0]
    if not blob and "contact_force_normal_x" not in parts[0]:
        raise ValueError(f"{what}: the local scenes carry neither "
                         "slot_blob nor the [N, S] slot fields")
    if blob and not local_cfg.spill:
        raise ValueError(f"{what}: the blob route's sorted pack "
                         "build requires a spillover grid (cfg.spill=True); "
                         "a classic base runs the full [N, S] route "
                         "(slab_decompose(..., use_blob=False))")

    def evaluate(scene_e, dt):
        """(scene with the per-particle forces, overflow, interesting
        slots or None): the body sums are the step's."""
        if blob:
            scene_e, cc = rb.rigid_contact_force_eval_compact_blob(
                scene_e, local_cfg, kernel, params, dt, ni_max, plain)
            return scene_e, cc.overflow, cc.n_interesting
        grid, dfT = tck.pack_contact(scene_e, local_cfg, plain)
        cp = tck.contact_pipeline_cell(
            dfT, grid, local_cfg, kernel, scene_e.meta.total_no_bodies,
            4.0 * scene_e.meta.spacing0, scene_e.n, plain).to(scene_e.dtype)
        return (rb._contact_forces(scene_e, cp, params, dt), grid.overflow,
                None)

    def exchange(parts, dt):
        """The half-kick, the ghost buffers and their sends: (kicked
        local scenes, extended scenes, send overflows)."""
        kicked, bufs, ovfs = [], [], []
        for d, s in enumerate(parts):
            s = rb._particles_from_body_velocity(
                rb._body_half_kick(s, dt, two_d))
            fdt = s.dtype
            cols = ([s[k] for k in GHOST_FIELDS]
                    + [s.dem_id.to(fdt), s.is_fluid.to(fdt)])
            rows, ovf = halo.rows(d, s)
            kicked.append(s)
            bufs.append([_take_rows(cols, *r, NGF) for r in rows])
            ovfs.append(ovf)
        exts = []
        for s, g in zip(kicked, halo.route(bufs)):
            gv, tails = _ghost_tails(g, GHOST_FIELDS, NGF, NGF + 1)
            tails["is_fluid"] = gv & (g[:, NGF + 2] > 0.5)
            exts.append(_extend(s, NG, tails))
        return kicked, exts, ovfs

    def one(parts, dt):
        kicked, exts, ovfs = exchange(parts, dt)
        evald, sums = [], []
        for s, e, ovf in zip(kicked, exts, ovfs):
            with on_device(e.device):
                se, govf, n_int = evaluate(e, dt)
            se = _drop_ghosts(se, s.n, NG)
            se = se.replace(nbr_overflow=se.nbr_overflow | govf | ovf)
            if n_int is not None:
                se = se.with_fields(n_interesting=n_int)
            evald.append(se)
            # the slab's partial body sums in float64, rounded once
            # after the rank-order sum
            sums.append(rops.body_sums(se, se.fx, se.fy, se.fz,
                                       torch.float64))
        sums = _rank_sum(sums, halo.devices)

        out = []
        for s, ft in zip(evald, sums):
            ft = ft.to(s.dtype)
            s = s.replace(force=ft[:, :3], torque=ft[:, 3:])
            s = rb._particles_from_body_position(rb._body_drift(s, dt, two_d))
            out.append(rb._particles_from_body_velocity(
                rb._body_half_kick(s, dt, two_d)))
        return out

    def step(parts, dt):
        for _ in range(chain):
            parts = one(parts, dt)
        return parts

    step.exchange = exchange
    return step


# ---------------------------------------------------------------------------
# on-device redistribution
# ---------------------------------------------------------------------------

def make_slab_redistribute(parts: List[Scene], mesh: Mesh, cfg: SlabConfig):
    """On-device re-decomposition, as ``redis(parts) -> parts``: each
    slab compacts the rows that left it (current slab != own) toward
    each neighbour, sends them one slab along the ring, and packs the
    arrivals behind its stayers; the rest are padding rows.  At most
    ``halo_cap`` rows a face a call and one slab of travel: a row two
    slabs away, or more rows than fit, raise ``nbr_overflow`` on every
    slab.  Every row field travels (contact tables too: their entries are
    gids), flattened to float columns of the scene's dtype."""
    _check_parts(parts, mesh, cfg)
    D = cfg.n_dev
    E = cfg.halo_cap
    s0 = parts[0]
    nl = s0.n
    keys = sorted(k for k, v in s0.fields.items() if _is_row(v, nl))
    widths = [int(np.prod(s0[k].shape[1:])) for k in keys]
    starts = np.concatenate([[0], np.cumsum(widths)]).tolist()
    pads = np.repeat([_pad_value(k) for k in keys], widths)
    a_col = starts[keys.index("active")]

    def flatten(s):
        return torch.cat([s[k].reshape(nl, -1).to(s.dtype) for k in keys], 1)

    def unflatten(buf, s):
        upd = {}
        for k, c0, c1 in zip(keys, starts[:-1], starts[1:]):
            v = s[k]
            col = buf[:, c0:c1].reshape(v.shape)
            upd[k] = col > 0.5 if v.dtype == torch.bool else col.to(v.dtype)
        return s.replace(**upd)

    def redis(parts):
        bufs, gol, gor, stays, ovfs = [], [], [], [], []
        for d, s in enumerate(parts):
            cx = torch.floor((s.x - cfg.base.origin[0]) / cfg.base.cell
                             ).to(torch.int64) - cfg.base.sub
            slab = torch.clamp(torch.div(cx, cfg.slab_cells,
                                         rounding_mode="floor"), 0, D - 1)
            act = s.active
            stay = act & (slab == d)
            far = act & ((slab < d - 1) | (slab > d + 1))
            buf = flatten(s)
            cols = list(buf.unbind(1))
            bl, ovl = _compact_rows(act & (slab < d), cols, E)
            br, ovr = _compact_rows(act & (slab > d), cols, E)
            bufs.append(buf)
            gol.append(bl)
            gor.append(br)
            stays.append(stay)
            ovfs.append(ovl | ovr | far.any())
        # slab d receives d-1's rightward rows, then d+1's leftward ones
        arrivals = _ring(gol, gor, mesh.devices)

        out, row_ovfs = [], []
        for s, buf, stay, arr, ovf in zip(parts, bufs, stays, arrivals,
                                          ovfs):
            dev = buf.device
            order = torch.argsort((~stay).to(torch.int32), stable=True)
            sbuf = buf[order]
            n_stay = stay.sum()
            avalid = arr[:, -1] > 0.5
            arank = torch.cumsum(avalid.to(torch.int64), 0) - 1
            n_tot = n_stay + avalid.sum()
            # arrivals past the capacity go to a dropped row nl
            dest = torch.where(avalid, torch.clamp(n_stay + arank, max=nl),
                               nl)
            sbuf = torch.cat([sbuf, sbuf[:1]], 0)
            sbuf = sbuf.index_copy(0, dest, arr[:, :-1])[:nl]
            live = torch.arange(nl, device=dev) < n_tot
            padv = torch.as_tensor(pads, dtype=buf.dtype, device=dev)
            sbuf = torch.where(live[:, None], sbuf, padv[None, :])
            sbuf = torch.cat([sbuf[:, :a_col], live.to(buf.dtype)[:, None],
                              sbuf[:, a_col + 1:]], 1)
            out.append(unflatten(sbuf, s))
            row_ovfs.append(ovf | (n_tot > nl))
        # any slab's overflow counts on every slab
        anyo = _rank_sum([o.to(torch.int32) for o in row_ovfs],
                         mesh.devices)
        return [s.replace(nbr_overflow=s.nbr_overflow | (a > 0))
                for s, a in zip(out, anyo)]

    return redis


# ---------------------------------------------------------------------------
# the DEM slab step
# ---------------------------------------------------------------------------

def make_slab_dem_step(scheme, parts: List[Scene], mesh: Mesh,
                       cfg: SlabConfig, n_global: int, plain: bool = False):
    """The DEM step (LVC displacement) over the slabs, as
    ``step(parts, dt) -> parts``: the half-kick of the granular rows
    (``is_rigid``), the halo of ``DEM_GHOST_FIELDS`` with ``dem_id`` and
    ``gid`` (ghost rows: empty tables, ``moi`` 1), the grid build, K1
    (spill base; a classic base gathers the pack) and K4 on the slab and
    its ghosts, force assembly, the drift and the second half-kick.  The contact tables are keyed on gids (below
    ``n_global``, :func:`attach_gids`): DEM sums are per query, so the
    two ring sends are the only exchange.  ``plain`` runs the kernels'
    plain versions; ``step.exchange`` as in :func:`make_slab_step`."""
    _check_engine(scheme, "make_slab_dem_step")
    _check_parts(parts, mesh, cfg)
    if "gid" not in parts[0]:
        raise ValueError("make_slab_dem_step: attach_gids before "
                         "slab_decompose")
    return dem_step(scheme, parts, RingHalo(mesh, cfg),
                    local_grid_config(cfg), n_global, lambda d, s: s.gid,
                    plain, "make_slab_dem_step")


def dem_step(scheme, parts: List[Scene], halo, local_cfg, n_global: int,
             gid_of, plain: bool = False, what: str = "the DEM step"):
    """:func:`make_slab_dem_step` with the ghosts from ``halo``, each
    device's rows and ghosts on the grid ``local_cfg``; ``gid_of(d, s)``
    gives device d's rows' gids (below ``n_global``), the keys of the
    contact tables.  A local scene without a ``gid`` field gets none
    back."""
    if n_global >= MAX_GID:
        raise ValueError(f"{what}: {n_global} gids; they ride "
                         f"float32 columns, exact below {MAX_GID}")
    if scheme.contact_model != "LVCDisplacement":
        raise NotImplementedError(f"{what} runs LVCDisplacement, not "
                                  f"{scheme.contact_model!r}")
    if local_cfg.radius < 2.0 * float(max(p.rad_s.max() for p in parts)):
        raise ValueError("the DEM grid's cutoff is below 2 max(rad_s): "
                         "the fused prune would miss overlapping pairs")
    NG = halo.n_ghost
    NGF = len(DEM_GHOST_FIELDS)
    gx, gy, gz = scheme.gx, scheme.gy, scheme.gz
    springs = scheme._springs()
    # the granular rows move (``is_rigid``: the DEM set-up's mobile
    # groups), ghosts and boundaries stay
    half_kick = lambda s, half: dem_model.dem_half_kick(s, s.is_rigid, half)

    def exchange(parts, dt):
        """The half-kick, the ghost buffers and their sends: (kicked
        local scenes, extended scenes, send overflows)."""
        kicked, gids, bufs, ovfs = [], [], [], []
        for d, s in enumerate(parts):
            s = half_kick(s, 0.5 * dt)
            fdt = s.dtype
            gid = gid_of(d, s)
            cols = ([s[k] for k in DEM_GHOST_FIELDS]
                    + [s.dem_id.to(fdt), gid.to(fdt)])
            rows, ovf = halo.rows(d, s)
            kicked.append(s)
            gids.append(gid)
            bufs.append([_take_rows(cols, *r) for r in rows])
            ovfs.append(ovf)
        exts = []
        for s, gid, g in zip(kicked, gids, halo.route(bufs)):
            # the validity flag rides last, after dem_id and gid
            gv, tails = _ghost_tails(g, DEM_GHOST_FIELDS, NGF + 2, NGF)
            tails["gid"] = torch.where(gv, g[:, NGF + 1].to(torch.int32), -1)
            L = s.tng_idx.shape[1]
            tails["tng_idx"] = torch.full((NG, L), -1, dtype=torch.int32,
                                          device=g.device)
            tails["tng_idx_dem_id"] = tails["tng_idx"]
            tails["moi"] = torch.ones(NG, dtype=s.dtype, device=g.device)
            exts.append(_extend(s.with_fields(gid=gid), NG, tails))
        return kicked, exts, ovfs

    def step(parts, dt):
        half = 0.5 * dt
        kicked, exts, ovfs = exchange(parts, dt)
        out = []
        for s, se, ovf in zip(kicked, exts, ovfs):
            with on_device(se.device):
                r = dk.lvc_displacement_cell_kernel(
                    se, local_cfg, dt, se.tng_idx, se.tng_idx_dem_id,
                    *(se[k] for k in springs), plain=plain,
                    n_ident=n_global)
            se = dem_model.dem_apply_pass(se, r, springs, se.is_rigid, gx,
                                          gy, gz)
            se = _drop_ghosts(se, s.n, NG)
            if "gid" not in s:
                se = Scene({k: v for k, v in se.fields.items()
                            if k != "gid"}, se.meta)
            se = se.replace(nbr_overflow=se.nbr_overflow | ovf)
            se = se.with_fields(n_gated=r.n_gated[:s.n].sum())
            se = dem_model.dem_drift(se, se.is_rigid, dt)
            out.append(half_kick(se, half))
        return out

    step.exchange = exchange
    return step


# ---------------------------------------------------------------------------
# the coupling slab step
# ---------------------------------------------------------------------------

# ghost columns of the coupling passes (fluid rates, wall sums, forces and
# the FSI terms, the contact), then dem_id, is_fluid, is_static_boundary,
# is_rigid and the validity flag
CPL_GHOST_FIELDS = ("x", "y", "z", "u", "v", "w", "h", "m", "rho", "p",
                    "m_fsi", "rho_fsi", "p_fsi",
                    "contact_force_is_boundary")
_CPL_FLAGS = ("dem_id", "is_fluid", "is_static_boundary", "is_rigid")


def coupling_contact_pack(dfT, grid, scene_e: Scene, nl: int, two_d: bool):
    """The contact pack of a slab's coupling pack ``dfT`` of the extended
    scene ``scene_e`` (local rows first, ``nl`` of them): the ghost rows'
    flags lose their rigid bit first (in ``dfT``, in place), so K2 takes
    no ghost as a query, while the fluid passes before it saw ghost
    bodies as rigid sources; then ``contact_kernel.contact_pack``."""
    ghost = fk.fluid_flags(scene_e)[nl:] - scene_e.is_rigid[nl:].to(
        scene_e.dtype)
    fk.patch_columns(dfT, grid.dense_pos[nl:], {fk.FFLAGS: ghost})
    return tck.contact_pack(dfT, fk.UNION_LAYOUT, two_d)


def make_slab_coupling_step(scheme, parts: List[Scene], mesh: Mesh,
                            cfg: SlabConfig, chain: int = 1,
                            plain: bool = False):
    """The rigid-fluid coupling step over the slabs in the scheme's
    ``gtvf_ordering``, kdk or kdkf (``make_slab_coupling_step`` of the
    reference, ``parallel/slab.py:738-1230``), as ``step(parts, dt) ->
    parts``:

    * kdk: kick -> exchange at x_n -> K1, rates (B6a) -> drift, Tait ->
      exchange at x_n+1 -> K1, wall sums (B6b) -> the updated (p, p_fsi)
      resent for the ghost rows and patched into the pack -> forces (B6c)
      -> K2 on every slot -> rank-order body sums -> kick;
    * kdkf: kick, drift -> exchange -> K1, rates + wall sums (B4) -> the
      thermo update, (p, p_fsi, rho) resent and patched -> B6c -> K2 ->
      body sums -> kick.  The single-device kdkf runs B5 in place of
      B6c + K2: the same sums in another order.

    An exchange sends ``CPL_GHOST_FIELDS`` and the flags of each face's
    rows; a ghost is a rigid source for the fluid passes and never a
    contact query (:func:`coupling_contact_pack`); the FSI forces of
    ghost rows and their contact outputs are dropped, so a body's sum
    holds its own slab's rows only.  With no fluid group kdkf runs kdk, as
    the single-device step does.  The local scenes carry the full
    ``[N, S]`` slot schema (``slab_decompose(..., use_blob=False)``).
    ``chain`` steps a call; ``plain`` runs the kernels' plain versions.
    ``step.exchange(parts, dt)`` runs the ordering's stage before its
    forces evaluation: (local scenes, extended scenes as the fluid passes
    see them, overflows)."""
    _check_engine(scheme, "make_slab_coupling_step")
    _check_parts(parts, mesh, cfg)
    return coupling_step(scheme, parts, RingHalo(mesh, cfg),
                         local_grid_config(cfg), chain, plain,
                         "make_slab_coupling_step")


def coupling_step(scheme, parts: List[Scene], halo, local_cfg,
                  chain: int = 1, plain: bool = False,
                  what: str = "the coupling step"):
    """:func:`make_slab_coupling_step` with the ghosts from ``halo``, each
    device's rows and ghosts on the grid ``local_cfg``."""
    if scheme.fluid_stepper != "gtvf":
        raise NotImplementedError(f"{what} runs the GTVF stepper, not "
                                  f"{scheme.fluid_stepper!r}")
    if scheme.gtvf_ordering not in ("kdk", "kdkf"):
        raise NotImplementedError(f"{what} runs the kdk and kdkf "
                                  "orderings, not "
                                  f"{scheme.gtvf_ordering!r}")
    if "slot_blob" in parts[0] or "contact_force_normal_x" not in parts[0]:
        raise ValueError(f"{what}: the local scenes need the full [N, S] "
                         "slot fields (slab_decompose(..., use_blob=False); "
                         "a scene set up without the compact store)")
    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    params = dict(kr=scheme.kr, kf=scheme.kf, fric_coeff=scheme.fric_coeff,
                  gx=scheme.gx, gy=scheme.gy, gz=scheme.gz)
    gvec = (scheme.gx, scheme.gy, scheme.gz)
    edac, nu_edac, c0 = scheme.edac, scheme.edac_nu, scheme.c0
    rho0, gamma, alpha = scheme.rho0, scheme.gamma, scheme.fluid_alpha
    has_fluid = len(scheme.fluids) > 0
    has_rigid = len(scheme.rigid_bodies) > 0
    kdkf = scheme.gtvf_ordering == "kdkf" and has_fluid
    cutoff = local_cfg.radius
    two_d = local_cfg.dim == 2
    NG = halo.n_ghost
    NGF = len(CPL_GHOST_FIELDS)
    if plain:
        rates_wall, wall, forces = (fk.fluid_rates_wall_reference,
                                    fk.wall_bc_reference,
                                    fk.fluid_forces_reference)
    else:
        rates_wall, wall, forces = (fk.fluid_rates_wall, fk.wall_bc,
                                    fk.fluid_forces)

    def exchange(parts):
        """The ghost rows at the current positions to the devices that
        take them: (extended scenes, sent rows, send overflows).  With
        fluid a ghost row keeps its owner's is_rigid (a rigid source for
        the fluid passes; :func:`coupling_contact_pack` clears it for
        K2), else it has is_rigid = 0 (the contact pack is packed from
        the scene)."""
        rows, bufs, ovfs = [], [], []
        for d, s in enumerate(parts):
            cols = ([s[k] for k in CPL_GHOST_FIELDS]
                    + [s[k].to(s.dtype) for k in _CPL_FLAGS])
            sel, ovf = halo.rows(d, s)
            rows.append(sel)
            bufs.append([_take_rows(cols, *r) for r in sel])
            ovfs.append(ovf)
        exts = []
        for s, g in zip(parts, halo.route(bufs)):
            gv, tails = _ghost_tails(g, CPL_GHOST_FIELDS, NGF + 4, NGF)
            for k in ("rho", "rho_fsi", "m", "h"):
                tails[k] = torch.where(gv, tails[k],
                                       torch.ones_like(tails[k]))
            for i, k in enumerate(_CPL_FLAGS[1:] if has_fluid
                                  else _CPL_FLAGS[1:3]):
                tails[k] = gv & (g[:, NGF + 1 + i] > 0.5)
            exts.append(_extend(s, NG, tails))
        return exts, rows, ovfs

    def resend(exts, rows, values):
        """Each device's ``values`` ({pack row: [nl] tensor}, its local
        rows' updated columns) for the rows of its last exchange, to the
        devices that took them: {pack row: [nl + n_ghost] tensor} a
        device, the received values in the ghost rows (0 in an invalid
        ghost row, which has no lane)."""
        bufs = []
        for sel, v in zip(rows, values):
            cols = list(v.values())
            bufs.append([_take_rows(cols, *r) for r in sel])
        out = []
        for e, v, g in zip(exts, values, halo.route(bufs)):
            gv = g[:, -1] > 0.5
            out.append({r: torch.cat([x, torch.where(gv, g[:, i].to(x.dtype),
                                                     x.new_zeros(()))])
                        for i, (r, x) in enumerate(v.items())})
        return out

    def pack(e):
        """(grid, pack) of an extended scene: the coupling pack, or with no
        fluid the contact pack; one K1 launch."""
        with on_device(e.device):
            return cpl._pack(e, local_cfg, has_fluid, plain)

    def unpacked(grid, dense, e, nl):
        return cellmod.unpack(grid, local_cfg, dense, e.n, 0.0).to(
            e.dtype)[:nl]

    def stage(parts, dt):
        """The step before its forces evaluation: (local scenes at x_n+1,
        extended scenes, face rows, overflows)."""
        locs = []
        for s in parts:
            fl = cpl._masks(s)[0]
            s = cpl._kick(s, dt, fl, has_fluid, has_rigid)
            if kdkf:   # the thermo update rides the pack
                s = s.replace(
                    x=torch.where(fl, s.x + dt * s.u, s.x),
                    y=torch.where(fl, s.y + dt * s.v, s.y),
                    z=torch.where(fl, s.z + dt * s.w, s.z))
                if has_rigid:
                    s = rb._particles_from_body_position(
                        rb._body_drift(s, dt, two_d=False))
            locs.append(s)
        ovfs = [s.nbr_overflow for s in locs]
        if not kdkf:
            if has_fluid:   # the rates at x_n
                exts, _, eovf = exchange(locs)
                for d, (s, e) in enumerate(zip(locs, exts)):
                    grid, dfT = pack(e)
                    with on_device(e.device):
                        r = cpl._rates(e, grid, dfT, kernel, local_cfg,
                                       nu_edac, c0, edac, has_rigid, plain)
                    locs[d] = s.replace(arho=r.arho[:s.n], ap=r.ap[:s.n])
                    ovfs[d] = ovfs[d] | eovf[d] | grid.overflow
            for d, s in enumerate(locs):
                fl = cpl._masks(s)[0]
                s = cpl._drift(s, dt, fl, edac, has_fluid, has_rigid)
                if has_fluid and not edac:
                    p, cs = tait_eos(s, rho0, c0, gamma, fl)
                    s = s.replace(p=p, cs=cs)
                locs[d] = s
        exts, rows, eovf = exchange(locs)
        return locs, exts, rows, [o | e for o, e in zip(ovfs, eovf)]

    def one(parts, dt):
        locs, exts, rows, ovfs = stage(parts, dt)
        packs, walls, values = [], [], []
        for d, (s, e) in enumerate(zip(locs, exts)):
            grid, dfT = pack(e)
            ovfs[d] = ovfs[d] | grid.overflow
            packs.append((grid, dfT))
            if not has_fluid:
                continue
            with on_device(e.device):
                if kdkf:
                    rw = rates_wall(dfT, grid.nbr_slots, kernel, cutoff,
                                    nu_edac, c0, edac, has_rigid, gvec)
                else:
                    rw = wall(dfT, grid.nbr_slots, kernel, cutoff, gvec)
            out = unpacked(grid, rw, e, s.n)
            if kdkf:
                # the thermo update of the local rows (the single-device
                # kdkf step's, from the rates on the pre-update pack)
                fl = cpl._masks(s)[0]
                zero = torch.zeros((), dtype=s.dtype, device=s.device)
                arho = torch.where(fl, out[:, 0], zero)
                ap = torch.where(fl, out[:, 1], zero)
                rho_new = s.rho + dt * arho
                upd = dict(arho=arho, ap=ap,
                           rho=torch.where(fl, rho_new, s.rho),
                           vol=torch.where(fl, s.m / rho_new, s.vol))
                if edac:
                    upd["p"] = torch.where(fl, s.p + dt * ap, s.p)
                else:
                    upd["p"], upd["cs"] = tait_eos(s.replace(rho=upd["rho"]),
                                                   rho0, c0, gamma, fl)
                s = locs[d] = s.replace(**upd)
                out = out[:, 2:]
            walls.append(out)
            p, p_fsi = cpl.wall_pressures(s, out)
            v = {fk.FP: p, fk.FPFSI: p_fsi}
            if kdkf:
                v[fk.FRHO] = s.rho
            values.append(v)
        if has_fluid:
            # the owners' updated columns in the ghost rows, then in the
            # pack's lanes: a ghost's own sums saw only part of its stencil
            for (grid, dfT), v in zip(packs, resend(exts, rows, values)):
                fk.patch_columns(dfT, grid.dense_pos, v)

        evald, sums = [], []
        for d, (s, e, (grid, dfT)) in enumerate(zip(locs, exts, packs)):
            nl = s.n
            extra = None
            with on_device(e.device):
                if has_fluid:
                    fo = unpacked(grid, forces(dfT, grid.nbr_slots, kernel,
                                               cutoff, alpha, c0, has_rigid),
                                  e, nl)
                    s = cpl._apply_wall_forces(s, walls[d], fo, gvec)
                    rbm = s.is_rigid & s.active
                    zero = torch.zeros((), dtype=s.dtype, device=s.device)
                    extra = tuple(torch.where(rbm, fo[:, c], zero)
                                  for c in (3, 4, 5))
                if has_rigid:
                    cdfT = (coupling_contact_pack(dfT, grid, e, nl, two_d)
                            if has_fluid else dfT)
                    cp = tck.contact_pipeline_cell(
                        cdfT, grid, local_cfg, kernel,
                        s.meta.total_no_bodies, 4.0 * s.meta.spacing0, e.n,
                        plain).to(s.dtype)[:nl]
                    s = rb._contact_forces(s, cp, params, dt, extra)
                    # the slab's partial body sums in float64, rounded
                    # once after the rank-order sum
                    sums.append(rops.body_sums(s, s.fx, s.fy, s.fz,
                                               torch.float64))
            evald.append(s.replace(nbr_overflow=ovfs[d]))
        if has_rigid:
            evald = [s.replace(force=ft[:, :3].to(s.dtype),
                               torque=ft[:, 3:].to(s.dtype))
                     for s, ft in zip(evald, _rank_sum(sums, halo.devices))]
        return [cpl._kick(s, dt, cpl._masks(s)[0], has_fluid, has_rigid)
                for s in evald]

    def step(parts, dt):
        for _ in range(chain):
            parts = one(parts, dt)
        return parts

    def stage_exchange(parts, dt):
        locs, exts, _, ovfs = stage(parts, dt)
        return locs, exts, ovfs

    step.exchange = stage_exchange
    return step
