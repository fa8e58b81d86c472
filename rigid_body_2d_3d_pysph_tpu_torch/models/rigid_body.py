"""Rigid-body contact schemes (3D rotation-matrix dynamics, 2D scalar
inertia) with the GTVF kick-drift-kick integrator on the compact
interesting-slot contact path, or the RK2 and leapfrog steppers on the
full ``[N, S]`` slot schema.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/models/rigid_body.py``.
The scheme's ``integrator`` attribute picks the stepper:

* ``"gtvf"`` (default): body half-kick with the stored force and
  particle velocities from the bodies; the stage-2 contact evaluation
  (grid build, pack expansion, interest cull, contact sums, the Eq.-24
  tail on the culled lanes, force assembly and the per-body force/torque
  sums); drift and particle positions; the second half-kick with the
  fresh force and particle velocities;
* ``"rk2"``: save the body state, evaluate, advance half a step from the
  saved state, evaluate again, advance a full step from the saved state
  (two evaluations a step);
* ``"leapfrog"`` (3D only, as in the reference): save, advance half a
  step with the stored force, evaluate, advance a full step from the
  saved state.

The RK2 and leapfrog evaluations run the contact on every slot of the
grid (``contact_kernel.contact_pipeline_cell``) and the Eq.-24 tail on
every particle, as the reference's ``_make_force_eval`` does.

With ``skin_factor > 0`` (the Verlet skin, cell engine) the bins widen by
the skin, the grid rides the scene (``attach_grid_fields``) and each
force evaluation of every stepper rebuilds it only when a particle has
moved more than skin / 2 (``grid_for_step``); the pack is gathered
through the carried grid (no K1), K2 runs on every slot, and GTVF keeps
the full ``[N, S]`` schema too (``build_rigid_gtvf_step_full``), as the
reference turns its sorted and compact routes off with a skin.  The
scheme's ``kernel_name`` may be any of the six SPH kernels on either
engine.

A classic grid config (``cellpairs.config_from_positions`` with
``spill=False``, ``sub >= 2`` or an explicit ``M``; set as the scheme's
``_cell_cfg`` before ``setup``) takes the same full route: each force
evaluation builds the classic grid, gathers the pack through its
``slot2p`` (``contact_kernel.pack_classic``, no K1) and runs K2 on every
slot, as the reference's step does off its sorted and compact routes;
``setup`` keeps the full schema, and the compact route refuses the grid.

With ``engine = "nklist"`` every stepper runs on the ``[N, K]``
neighbour list instead (``build_rigid_gtvf_step``, the list branch of
``_make_force_eval``): a list build a force evaluation, the Eq.-22/21
sums and the closest-source pick as masked list reductions
(``ops/contact.py``), the Eq.-24 tail on every particle, and the full
``[N, S]`` slot schema (no compact store); the surface identification
of ``setup`` runs on a list too.  It launches no hand-written kernel.

Unlike the reference, which takes the compact path only on its TPU,
the port takes it on every device; only the kernel wrappers look at
the device (kernel for CUDA tensors, plain version for CPU tensors).
The steps are eager Python functions.

Slot state is stored compactly: ``cl_pid [L]`` (covered particle ids,
n = empty) and ``cl_state [L, 25 S]`` (their slot rows, ``CL_FIELDS``
block order, in the scene's dtype), with L = ni_max * M.  Uncovered
particles implicitly hold the init row (zeros, closest distance =
4 * spacing0).  ``expand_slot_scene`` materialises the [N, S] view.  The
slab step (``parallel/slab.py``) keeps the slot state row-aligned
instead, as one ``slot_blob [N, 25 S]`` (``blobify_slot_scene``), which
rides its exchanges like any particle field
(``rigid_contact_force_eval_compact_blob``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops import cellpairs as cellmod
from ..ops import contact as cops
from ..ops import neighbors as nbmod
from ..ops import rigid as rops
from ..ops.boundary import boundary_identification
from ..ops.boundary_cell import boundary_identification_cell
from ..ops import contact_kernel as tck
from ..ops.contact_kernel import contact_pipeline_compact
from ..ops.kernels import get_kernel
from ..state import rigid_setup
from ..state.scene import Scene
from .base import Scheme

# [N, S] contact-slot fields of the full (uncompacted) schema
SLOT_FIELDS = (
    "contact_force_normal_x", "contact_force_normal_y",
    "contact_force_normal_z", "contact_force_normal_wij",
    "contact_force_dist", "overlap",
    "ft_x", "ft_y", "ft_z",
    "fn_x", "fn_y", "fn_z",
    "delta_lt_x", "delta_lt_y", "delta_lt_z",
    "vx_source", "vy_source", "vz_source",
    "x_source", "y_source", "z_source",
    "ti_x", "ti_y", "ti_z",
    "closest_point_dist_to_source",
)

# cl_state column blocks (S columns each): the 12 kernel-derived fields,
# then the contact-force outputs; the persistent tangential springs
# (delta_lt_*, fn_*) are blocks 12..17
CL_FIELDS = (
    "contact_force_normal_x", "contact_force_normal_y",
    "contact_force_normal_z", "contact_force_normal_wij",
    "contact_force_dist", "closest_point_dist_to_source",
    "x_source", "y_source", "z_source",
    "vx_source", "vy_source", "vz_source",
    "delta_lt_x", "delta_lt_y", "delta_lt_z",
    "fn_x", "fn_y", "fn_z",
    "ft_x", "ft_y", "ft_z",
    "overlap", "ti_x", "ti_y", "ti_z",
)
_CL_SPRING0 = 12


def _attach_contact_fields(scene: Scene) -> Scene:
    n, S = scene.n, scene.meta.total_no_bodies
    dev, fdt = scene.device, scene.dtype
    fields = {k: torch.zeros((n, S), dtype=fdt, device=dev)
              for k in SLOT_FIELDS if k not in scene}
    if "normal" not in scene:
        fields["normal"] = torch.zeros((n, 3), dtype=fdt, device=dev)
        fields["normal0"] = torch.zeros((n, 3), dtype=fdt, device=dev)
        fields["is_boundary"] = torch.zeros(n, dtype=torch.int32,
                                            device=dev)
    if "contact_force_is_boundary" not in scene:
        fields["contact_force_is_boundary"] = torch.zeros(
            n, dtype=fdt, device=dev)
    if "nbr_overflow" not in scene:
        fields["nbr_overflow"] = torch.zeros((), dtype=torch.bool,
                                             device=dev)
    return scene.with_fields(**fields)


def run_boundary_identification_cell(scene: Scene, kernel, cell_cfg,
                                     group_names: Sequence[str]) -> Scene:
    """Setup-time surface identification on the cell grid (each group
    identifies against itself)."""
    sel = np.full(scene.n, -1.0)
    for gi, name in enumerate(group_names):
        g = scene.meta.group(name)
        sel[g.start:g.stop] = float(gi)
    sel_t = torch.as_tensor(sel, dtype=scene.dtype, device=scene.device)
    grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z, scene.active,
                                   cell_cfg)
    normal, isb = boundary_identification_cell(scene, grid, cell_cfg,
                                               kernel, sel_t)
    if bool(grid.overflow):
        raise RuntimeError("cell-grid overflow during boundary "
                           "identification: increase grid capacity")
    mask = sel_t >= 0
    normal = torch.where(mask[:, None], normal, scene.normal)
    isb = torch.where(mask, isb, scene.is_boundary)
    return scene.replace(normal=normal, normal0=normal, is_boundary=isb)


def run_boundary_identification(scene: Scene, kernel,
                                cfg: nbmod.NeighborConfig,
                                group_names: Sequence[str]) -> Scene:
    """Setup-time surface identification on one neighbour list (each
    group identifies against itself)."""
    nbrs = nbmod.build_neighbors(scene.x, scene.y, scene.z, scene.active,
                                 cfg)
    if bool(nbrs.overflow):
        raise RuntimeError("neighbour-list overflow during boundary "
                           "identification: increase its capacity")
    normal, isb = scene.normal, scene.is_boundary
    idx = torch.arange(scene.n, device=scene.device)
    for name in group_names:
        g = scene.meta.group(name)
        mask = (idx >= g.start) & (idx < g.stop)
        n_g, b_g = boundary_identification(scene, nbrs, kernel, mask, mask)
        normal = torch.where(mask[:, None], n_g, normal)
        isb = torch.where(mask, b_g, isb)
    return scene.replace(normal=normal, normal0=normal, is_boundary=isb)


class _RigidBodySchemeBase(Scheme):
    two_d = False

    def __init__(self, rigid_bodies, boundaries, dim, kr=1e5, kf=1e5,
                 en=0.5, fric_coeff=0.5, gx=0.0, gy=0.0, gz=0.0):
        self.rigid_bodies = list(rigid_bodies or [])
        self.boundaries = list(boundaries or [])
        self.dim = dim
        self.kr = kr
        self.kf = kf
        self.en = en
        self.fric_coeff = fric_coeff
        self.gx, self.gy, self.gz = gx, gy, gz
        self.kernel_name = "quintic"
        # "gtvf", "rk2" or "leapfrog" (3D only)
        self.integrator = "gtvf"
        # the Verlet skin as a fraction of the cutoff (cell engine): > 0
        # widens the bins by the skin, carries the grid in the scene and
        # rebuilds it only when some particle has moved more than skin / 2
        self.skin_factor = 0.0
        self._cell_cfg = None
        # the config the scene's carried grid (g_*) was built for
        self._grid_cfg = None

    def add_user_options(self, group):
        group.add_argument("--kr-stiffness", dest="kr", default=1e5,
                           type=float, help="Repulsive spring stiffness")
        group.add_argument("--kf-stiffness", dest="kf", default=1e3,
                           type=float, help="Tangential spring stiffness")
        group.add_argument("--fric-coeff", dest="fric_coeff", default=0.5,
                           type=float, help="Friction coefficient")

    def consume_user_options(self, options):
        for k in ("kr", "kf", "fric_coeff"):
            if hasattr(options, k):
                setattr(self, k, getattr(options, k))

    def set_linear_velocity(self, scene: Scene, vel) -> Scene:
        return rigid_setup.set_linear_velocity(scene, vel)

    def set_angular_velocity(self, scene: Scene, omega) -> Scene:
        return rigid_setup.set_angular_velocity(scene, omega)

    def setup(self, scene: Scene, coeff_of_rest=None) -> Scene:
        scene = _attach_contact_fields(scene)
        scene = rigid_setup.setup_body_state(scene, coeff_of_rest)
        kernel = get_kernel(self.kernel_name, self.dim)
        names = self.rigid_bodies + self.boundaries
        if self.engine == "nklist":
            scene = run_boundary_identification(
                scene, kernel, self.list_config(scene, kernel.radius_scale),
                names)
        else:
            scene = run_boundary_identification_cell(
                scene, kernel, self.cell_config(scene, kernel), names)
        scene = scene.replace(
            contact_force_is_boundary=scene.is_boundary.to(scene.dtype))
        if self.uses_skin:
            scene = self._attach_grid(scene, kernel)
        if not self.uses_compact(scene, kernel):
            return scene
        cfg = self.cell_config(scene, kernel)
        return compact_slot_scene(scene, self.ni_max(cfg) * cfg.M)

    def uses_compact(self, scene: Scene, kernel) -> bool:
        """The compact route: GTVF on the cell engine's spill grid with no
        skin.  The RK2 and leapfrog steps, the list engine, the skin and
        the classic grid keep the full [N, S] schema."""
        return (self.integrator == "gtvf" and self.engine == "cell"
                and not self.uses_skin
                and self.cell_config(scene, kernel).spill)

    @property
    def uses_skin(self) -> bool:
        """The Verlet-skin route: the cell engine with ``skin_factor``
        > 0."""
        return self.engine == "cell" and self.skin_factor > 0

    def _attach_grid(self, scene: Scene, kernel) -> Scene:
        cfg = self.cell_config(scene, kernel)
        self._grid_cfg = cfg
        return attach_grid_fields(scene, cfg)

    def adapt_scene(self, scene: Scene) -> Scene:
        """Pad the compact store to the current capacity (after an
        overflow rebuild raised ni_max); compact a full scene that now
        takes the compact route (a classic grid set before the set-up
        comes back from an overflow rebuild as the spill grid); rebuild
        the carried skin grid when the grid config is not the one it was
        built for (after an overflow rebuild re-sized it; a checkpoint's
        grid keeps its config, ``_grid_cfg``, so a resumed run goes on
        with it)."""
        kernel = get_kernel(self.kernel_name, self.dim)
        cfg = self.cell_config(scene, kernel)
        if "g_xb" in scene and cfg != self._grid_cfg:
            scene = self._attach_grid(scene, kernel)
        if "cl_pid" not in scene and self.uses_compact(scene, kernel):
            return compact_slot_scene(scene, self.ni_max(cfg) * cfg.M)
        return fit_compact_store(scene, cfg, self.capacity_boost)

    def export_scene(self, scene: Scene) -> Scene:
        """IO view: the [N, S] slot fields materialised."""
        return expand_slot_scene(scene)

    def cell_config(self, scene: Scene, kernel) -> cellmod.CellGridConfig:
        if self._cell_cfg is None:
            host = lambda k: scene[k].detach().cpu().numpy()
            cutoff = float(kernel.radius_scale * host("h").max())
            self._cell_cfg = cellmod.config_from_positions(
                host("x"), host("y"), host("z"), cutoff, self.dim,
                capacity_boost=self.capacity_boost,
                skin=self.skin_factor * cutoff)
        return self._cell_cfg

    def ni_max(self, cfg: cellmod.CellGridConfig) -> int:
        """Interesting-slot capacity: NC for small contact-dense scenes,
        a small fraction of NC at scale (interest is surface-bound); the
        overflow rebuild widens it through capacity_boost."""
        return compact_capacity(cfg, self.capacity_boost)

    def make_step(self, scene: Scene, plain: bool = False):
        """The ``integrator``'s step on the scheme's ``engine`` as an
        eager ``step(scene, dt) -> scene``.  ``plain=True`` runs the
        kernels' plain versions even on CUDA tensors (the cell engine's
        kernel step's reference on the card; the list engine has no
        kernel)."""
        kernel = get_kernel(self.kernel_name, self.dim)
        params = dict(kr=self.kr, kf=self.kf, fric_coeff=self.fric_coeff,
                      gx=self.gx, gy=self.gy, gz=self.gz)
        if self.integrator not in ("gtvf", "rk2", "leapfrog"):
            raise ValueError(f"integrator={self.integrator!r}: one of "
                             "'gtvf', 'rk2', 'leapfrog'")
        if self.integrator == "leapfrog" and self.two_d:
            raise ValueError("leapfrog stepper is 3D-only "
                             "(reference rigid_body_3d.py:228)")
        if self.engine == "nklist":
            cfg = dict(nbr_cfg=self.list_config(scene, kernel.radius_scale))
        else:
            cfg = dict(cell_cfg=self.cell_config(scene, kernel), plain=plain)
        if self.integrator == "rk2":
            return build_rigid_rk2_step(kernel, params, self.two_d, **cfg)
        if self.integrator == "leapfrog":
            return build_rigid_leapfrog_step(kernel, params, **cfg)
        if self.engine == "nklist":
            return build_rigid_gtvf_step(kernel, cfg["nbr_cfg"], params,
                                         self.two_d)
        if not self.uses_compact(scene, kernel):
            if "cl_pid" in scene:
                raise ValueError(
                    "the scene holds the compact contact store, which "
                    "only the GTVF step on the spill grid "
                    "(cfg.spill=True) with no skin reads: set the scene "
                    "up under the scheme's present grid config")
            return build_rigid_gtvf_step_full(
                _make_force_eval(kernel, params, **cfg), self.two_d)
        return build_rigid_gtvf_step_cell(
            kernel, cfg["cell_cfg"], params, self.two_d,
            ni_max=self.ni_max(cfg["cell_cfg"]), plain=plain)


class RigidBody3DScheme(_RigidBodySchemeBase):
    name = "rb3d"
    two_d = False


class RigidBody2DScheme(_RigidBodySchemeBase):
    name = "rb2d"
    two_d = True


# ---------------------------------------------------------------------------
# stepper stages
# ---------------------------------------------------------------------------

def _body_half_kick(scene, dt, two_d):
    """Half-kick of the body velocities (2D: x/y and omega_z via izz)."""
    M = scene.total_mass[:, None]
    if two_d:
        vxy = scene.vcm[:, :2] + 0.5 * dt * scene.force[:, :2] / M
        vcm = torch.cat([vxy, scene.vcm[:, 2:]], 1)
        izz = torch.where(scene.izz > 0, scene.izz,
                          torch.ones_like(scene.izz))
        oz = scene.omega[:, 2] + 0.5 * dt * scene.torque[:, 2] / izz
        omega = torch.cat([scene.omega[:, :2], oz[:, None]], 1)
        return scene.replace(vcm=vcm, omega=omega)
    vcm = scene.vcm + 0.5 * dt * scene.force / M
    ang_mom = scene.ang_mom + 0.5 * dt * scene.torque
    omega = torch.einsum("bij,bj->bi",
                         scene.inertia_tensor_inverse_global_frame, ang_mom)
    return scene.replace(vcm=vcm, ang_mom=ang_mom, omega=omega)


def _body_drift(scene, dt, two_d):
    """Advance COM and orientation (2D skips z and the inertia update)."""
    if two_d:
        xy = scene.xcm[:, :2] + dt * scene.vcm[:, :2]
        xcm = torch.cat([xy, scene.xcm[:, 2:]], 1)
    else:
        xcm = scene.xcm + dt * scene.vcm
    Om = rops.omega_cross_matrix(scene.omega)
    R = scene.R + dt * torch.einsum("bij,bjk->bik", Om, scene.R)
    R = rops.gram_schmidt_columns(R)
    out = dict(xcm=xcm, R=R)
    if not two_d:
        out["inertia_tensor_inverse_global_frame"] = torch.einsum(
            "bij,bjk,blk->bil", R, scene.inertia_tensor_inverse_body_frame,
            R)
    return scene.replace(**out)


def _body_ids(scene):
    rigid = scene.is_rigid
    return rigid, torch.where(rigid, scene.body_id, 0).to(torch.int64)


def _particles_from_body_velocity(scene):
    """u = vcm + omega x (R dr0) on rigid particles."""
    rigid, bid = _body_ids(scene)
    dx, dy, dz = rops.rotate_body_frame_vectors(scene.R, bid, scene.dx0,
                                                scene.dy0, scene.dz0)
    om = rops.gather_body_rows(scene.omega, bid)
    du = om[:, 1] * dz - om[:, 2] * dy
    dv = om[:, 2] * dx - om[:, 0] * dz
    dw = om[:, 0] * dy - om[:, 1] * dx
    vcm = rops.gather_body_rows(scene.vcm, bid)
    return scene.replace(
        u=torch.where(rigid, vcm[:, 0] + du, scene.u),
        v=torch.where(rigid, vcm[:, 1] + dv, scene.v),
        w=torch.where(rigid, vcm[:, 2] + dw, scene.w))


def _particles_from_body_position(scene):
    """x = xcm + R dr0 on rigid particles; surface normals rotate too."""
    rigid, bid = _body_ids(scene)
    dx, dy, dz = rops.rotate_body_frame_vectors(scene.R, bid, scene.dx0,
                                                scene.dy0, scene.dz0)
    xcm = rops.gather_body_rows(scene.xcm, bid)
    nx, ny, nz = rops.rotate_body_frame_vectors(
        scene.R, bid, scene.normal0[:, 0], scene.normal0[:, 1],
        scene.normal0[:, 2])
    rot_n = torch.stack([nx, ny, nz], -1)
    upd_n = (rigid & (scene.is_boundary == 1))[:, None]
    return scene.replace(
        x=torch.where(rigid, xcm[:, 0] + dx, scene.x),
        y=torch.where(rigid, xcm[:, 1] + dy, scene.y),
        z=torch.where(rigid, xcm[:, 2] + dz, scene.z),
        normal=torch.where(upd_n, rot_n, scene.normal))


# ---------------------------------------------------------------------------
# compact slot store
# ---------------------------------------------------------------------------

# the least interesting-slot capacity before ``capacity_boost``
NI_MAX_FLOOR = 512


def compact_capacity(cfg: cellmod.CellGridConfig, boost: float) -> int:
    """Interesting-slot capacity of the compact route at ``boost``
    (``capacity_boost``): NC for small contact-dense scenes, a small
    fraction of NC at scale (interest is surface-bound)."""
    nc = cfg.NC_max
    return min(nc, int(np.ceil(max(NI_MAX_FLOOR, nc // 16) * boost)))


def fit_compact_store(scene: Scene, cfg: cellmod.CellGridConfig,
                      boost: float) -> Scene:
    """Pad a compact store to its capacity on ``cfg`` at ``boost`` (after
    an overflow rebuild raised it); a full scene passes through."""
    if "cl_pid" not in scene:
        return scene
    return migrate_compact_scene(scene, compact_capacity(cfg, boost) * cfg.M)


def compact_slot_scene(scene: Scene, L: int) -> Scene:
    """Replace the 25 [N, S] slot fields with the compact store of
    capacity L (host-side).  A row not representable in L slots raises."""
    if "cl_pid" in scene:
        return migrate_compact_scene(scene, L)
    n, S = scene.n, scene.meta.total_no_bodies
    init_dist = 4.0 * scene.meta.spacing0
    dev = np.zeros(n, bool)
    cols = []
    for name in CL_FIELDS:
        v = scene[name].detach().cpu().numpy()
        base = init_dist if name == "closest_point_dist_to_source" else 0.0
        # a pre-first-evaluation scene holds 0 in `closest`: equivalent
        dv = (v != base).any(axis=1)
        if name == "closest_point_dist_to_source":
            dv &= (v != 0.0).any(axis=1)
        dev |= dv
        cols.append(v)
    idx = np.nonzero(dev)[0]
    if len(idx) > L:
        raise ValueError(f"{len(idx)} occupied slot rows exceed the "
                         f"compact capacity {L}")
    cl_pid = np.full(L, n, np.int64)
    cl_pid[:len(idx)] = idx
    cl_state = np.zeros((L, 25 * S), np.float64)
    for i, v in enumerate(cols):
        cl_state[:len(idx), i * S:(i + 1) * S] = v[idx]
    fields = {k: v for k, v in scene.fields.items() if k not in CL_FIELDS}
    fields["cl_pid"] = torch.as_tensor(cl_pid, device=scene.device)
    fields["cl_state"] = torch.as_tensor(cl_state, dtype=scene.dtype,
                                         device=scene.device)
    return Scene(fields, scene.meta)


def migrate_compact_scene(scene: Scene, L: int) -> Scene:
    """Pad (never shrink) the compact store to capacity L."""
    L0 = scene.cl_pid.shape[0]
    if L0 == L:
        return scene
    if L0 > L:
        raise ValueError(f"compact capacity cannot shrink ({L0} -> {L})")
    pad_pid = torch.full((L - L0,), scene.n, dtype=scene.cl_pid.dtype,
                         device=scene.device)
    pad_state = torch.zeros((L - L0, scene.cl_state.shape[1]),
                            dtype=scene.cl_state.dtype, device=scene.device)
    return scene.replace(cl_pid=torch.cat([scene.cl_pid, pad_pid]),
                         cl_state=torch.cat([scene.cl_state, pad_state]))


def expand_slot_scene(scene: Scene) -> Scene:
    """Materialise the 25 [N, S] slot fields from the compact store
    (uncovered rows are the init row); no-op for full scenes."""
    if "cl_pid" not in scene:
        return scene
    n, S = scene.n, scene.meta.total_no_bodies
    dev, fdt = scene.device, scene.cl_state.dtype
    tgt = torch.clamp(scene.cl_pid, max=n)
    scat = torch.zeros((n + 1, 25 * S), dtype=fdt, device=dev)
    scat[tgt] = scene.cl_state
    covered = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    covered[tgt] = True
    scat, covered = scat[:n], covered[:n]
    upd = {}
    for i, name in enumerate(CL_FIELDS):
        colv = scat[:, i * S:(i + 1) * S]
        if name == "closest_point_dist_to_source":
            colv = torch.where(covered[:, None], colv, torch.full_like(
                colv, 4.0 * scene.meta.spacing0))
        upd[name] = colv
    return scene.with_fields(**upd)


def strip_compact_fields(scene: Scene) -> Scene:
    """Drop ``cl_pid``/``cl_state`` (after :func:`expand_slot_scene`):
    the slab path carries the full schema or the row-aligned blob."""
    if "cl_pid" not in scene:
        return scene
    return Scene({k: v for k, v in scene.fields.items()
                  if k not in ("cl_pid", "cl_state")}, scene.meta)


def blobify_slot_scene(scene: Scene) -> Scene:
    """Replace the 25 [N, S] slot fields with one row-aligned
    ``slot_blob [N, 25 S]`` (``CL_FIELDS`` block order), the slab path's
    slot layout: it rides the halo and redistribution exchanges like any
    per-particle field.  A row with no contact work is all zero (the
    closest-distance block included: write-only, never an input)."""
    blob = torch.cat([scene[name].to(scene.dtype) for name in CL_FIELDS],
                     dim=1)
    fields = {k: v for k, v in scene.fields.items() if k not in CL_FIELDS}
    fields["slot_blob"] = blob
    return Scene(fields, scene.meta)


def deblobify_slot_scene(scene: Scene) -> Scene:
    """Inverse of :func:`blobify_slot_scene` (tests and IO)."""
    if "slot_blob" not in scene:
        return scene
    S = scene.meta.total_no_bodies
    blob = scene.slot_blob
    fields = {k: v for k, v in scene.fields.items() if k != "slot_blob"}
    for i, name in enumerate(CL_FIELDS):
        fields[name] = blob[:, i * S:(i + 1) * S]
    return Scene(fields, scene.meta)


# ---------------------------------------------------------------------------
# stage-2 evaluation on the compact path
# ---------------------------------------------------------------------------

def rigid_contact_force_eval_compact(scene, cell_cfg, kernel, params, dt,
                                     ni_max: int, plain: bool = False):
    """Contact pipeline + Eq.-24 tail on the interesting lanes.  Returns
    ``(scene, CompactContact)``; its ``overflow`` covers the grid and the
    interesting-slot capacity.  ``plain``: the kernels' plain versions
    (see :func:`build_rigid_gtvf_step_cell`)."""
    cc = contact_pipeline_compact(scene, cell_cfg, kernel, ni_max, plain)
    NI, M = cc.pid.shape
    flat = cc.out.reshape(NI * M, cc.out.shape[-1]).to(scene.dtype)
    scene = _compact_contact_tail(scene, flat, cc.pid, cc.u, cc.v, cc.w,
                                  params=params, dt=dt)
    return scene, cc


def rigid_contact_force_eval_compact_blob(scene, cell_cfg, kernel, params,
                                          dt, ni_max: int,
                                          plain: bool = False):
    """The compact evaluation for blob scenes (the slab step's local
    evaluation): K1, the cull and K2 on the culled rows as
    :func:`rigid_contact_force_eval_compact`, but the springs come from a
    row gather of ``slot_blob`` at the lanes' particles and the new blob
    is a full rewrite (zeros and one row scatter), so ghost and stale
    rows need no bookkeeping.  Returns ``(scene, CompactContact)`` with
    the per-particle forces and no body sums (the slab step sums its
    slabs' forces itself)."""
    cc = contact_pipeline_compact(scene, cell_cfg, kernel, ni_max, plain)
    n, S = scene.n, scene.meta.total_no_bodies
    NI, M = cc.pid.shape
    L = NI * M
    fdt, dev = scene.dtype, scene.device
    flat = cc.out.reshape(L, cc.out.shape[-1]).to(fdt)

    def blk(i):
        return flat[:, i * S:(i + 1) * S]

    dinfo = dict(
        contact_force_dist=blk(4), closest_point_dist_to_source=blk(5),
        x_source=blk(6), y_source=blk(7), z_source=blk(8),
        vx_source=blk(9), vy_source=blk(10), vz_source=blk(11))
    pidf = cc.pid.reshape(L)
    valid_lane = pidf < n
    pclip = torch.clamp(pidf, max=n - 1)
    zero = torch.zeros((), dtype=fdt, device=dev)
    m_c = torch.where(valid_lane, scene.m[pclip], zero)
    bid_c = torch.where(valid_lane, scene.body_id[pclip].to(torch.int64), 0)
    spr_c = torch.where(
        valid_lane[:, None],
        scene.slot_blob[pclip, _CL_SPRING0 * S:(_CL_SPRING0 + 6) * S],
        zero)
    dfx, dfy, dfz, slots = cops.contact_force_core(
        cc.u.reshape(L).to(fdt), cc.v.reshape(L).to(fdt),
        cc.w.reshape(L).to(fdt), m_c, bid_c, scene.eta, scene.meta.nb,
        scene.meta.spacing0, dt, params["kr"], params["kf"],
        params["fric_coeff"], blk(0), blk(1), blk(2), dinfo,
        spr_c[:, 0:S], spr_c[:, S:2 * S], spr_c[:, 2 * S:3 * S],
        spr_c[:, 3 * S:4 * S], spr_c[:, 4 * S:5 * S], spr_c[:, 5 * S:6 * S])

    tgt = torch.where(valid_lane, pidf, torch.full_like(pidf, n))
    fxg, fyg, fzg = rops.body_force(scene, params["gx"], params["gy"],
                                    params["gz"], scene.is_rigid)
    dxyz = torch.zeros((n + 1, 3), dtype=fdt, device=dev)
    dxyz[tgt] = torch.stack([dfx, dfy, dfz], dim=1)
    fx = fxg + dxyz[:n, 0]
    fy = fyg + dxyz[:n, 1]
    fz = fzg + dxyz[:n, 2]
    new_rows = torch.cat([flat[:, :12 * S]]
                         + [slots[k] for k in CL_FIELDS[12:]], dim=1)
    blob = torch.zeros((n + 1, 25 * S), dtype=fdt, device=dev)
    blob[tgt] = new_rows.to(fdt)
    return scene.replace(fx=fx, fy=fy, fz=fz, slot_blob=blob[:n]), cc


def _compact_contact_tail(scene, flat, pid, u_c, v_c, w_c, params, dt,
                          extra_fx=None):
    """Eq.-24 tail, force assembly and the new compact slot store on the
    compacted lanes.  ``flat`` [L, >= 12 S]: the contact output blocks in
    ``CL_FIELDS[:12]`` order; ``pid`` [NI, M] particle ids (n = empty);
    ``extra_fx`` the coupling step's fluid -> rigid force (fx, fy, fz)
    [N] each, added before the body sums as the full route adds it, or
    None."""
    n, S = scene.n, scene.meta.total_no_bodies
    L = flat.shape[0]
    fdt, dev = scene.dtype, scene.device

    def blk(i):
        return flat[:, i * S:(i + 1) * S]

    dinfo = dict(
        contact_force_dist=blk(4), closest_point_dist_to_source=blk(5),
        x_source=blk(6), y_source=blk(7), z_source=blk(8),
        vx_source=blk(9), vy_source=blk(10), vz_source=blk(11))

    pidf = pid.reshape(L)
    valid_lane = pidf < n
    pclip = torch.clamp(pidf, max=n - 1)
    m_c = torch.where(valid_lane, scene.m[pclip], torch.zeros((), dtype=fdt,
                                                               device=dev))
    bid_c = torch.where(valid_lane, scene.body_id[pclip].to(torch.int64), 0)

    # persistent springs from the last step's store: pid -> previous lane
    # through an inverse table (uncovered particles read zero springs)
    prev_pid = scene.cl_pid
    Lp = prev_pid.shape[0]
    inv = torch.full((n + 1,), Lp, dtype=torch.int64, device=dev)
    inv[torch.clamp(prev_pid, max=n)] = torch.arange(Lp, device=dev)
    prev_lane = inv[pclip]
    has_prev = valid_lane & (prev_lane < Lp)
    spr_rows = scene.cl_state[:, _CL_SPRING0 * S:(_CL_SPRING0 + 6) * S]
    spr_c = torch.where(has_prev[:, None],
                        spr_rows[torch.clamp(prev_lane, max=Lp - 1)],
                        torch.zeros((), dtype=spr_rows.dtype, device=dev)
                        ).to(fdt)

    dfx, dfy, dfz, slots = cops.contact_force_core(
        u_c.reshape(L).to(fdt), v_c.reshape(L).to(fdt),
        w_c.reshape(L).to(fdt), m_c, bid_c, scene.eta, scene.meta.nb,
        scene.meta.spacing0, dt, params["kr"], params["kf"],
        params["fric_coeff"], blk(0), blk(1), blk(2), dinfo,
        spr_c[:, 0:S], spr_c[:, S:2 * S], spr_c[:, 2 * S:3 * S],
        spr_c[:, 3 * S:4 * S], spr_c[:, 4 * S:5 * S], spr_c[:, 5 * S:6 * S])

    # per-particle force assembly (row n takes the empty lanes)
    tgt = torch.where(valid_lane, pidf, torch.full_like(pidf, n))
    fxg, fyg, fzg = rops.body_force(scene, params["gx"], params["gy"],
                                    params["gz"], scene.is_rigid)
    dxyz = torch.zeros((n + 1, 3), dtype=fdt, device=dev)
    dxyz[tgt] = torch.stack([dfx, dfy, dfz], dim=1)
    dxyz = dxyz[:n]
    fx = fxg + dxyz[:, 0]
    fy = fyg + dxyz[:, 1]
    fz = fzg + dxyz[:, 2]
    if extra_fx is not None:
        efx, efy, efz = extra_fx
        fx, fy, fz = fx + efx, fy + efy, fz + efz
    force, torque = rops.sum_up_external_forces(scene, fx, fy, fz)

    new_state = torch.cat([flat[:, :12 * S]]
                          + [slots[k] for k in CL_FIELDS[12:]], dim=1)
    return scene.replace(fx=fx, fy=fy, fz=fz, force=force, torque=torque,
                         cl_pid=tgt, cl_state=new_state.to(fdt))


def _contact_forces(scene, cp, params, dt, extra_fx=None):
    """Eq.-24 tail on the full [N, S] slot schema from the unpacked
    contact columns ``cp [N, 12, S]`` (the cell pipeline's output):
    gravity, the contact force and ``extra_fx`` (the coupling step's
    fluid -> rigid force, or None) per particle, and the new slot state;
    no body sums."""
    dinfo = dict(
        contact_force_dist=cp[:, 4],
        closest_point_dist_to_source=cp[:, 5],
        x_source=cp[:, 6], y_source=cp[:, 7], z_source=cp[:, 8],
        vx_source=cp[:, 9], vy_source=cp[:, 10], vz_source=cp[:, 11])
    return _slot_forces(scene, cp[:, 0], cp[:, 1], cp[:, 2], cp[:, 3], dinfo,
                        params, dt, extra_fx)


def _slot_forces(scene, cfn_x, cfn_y, cfn_z, cfn_w, dinfo, params, dt,
                 extra_fx=None):
    """:func:`_contact_forces` on the Eq.-22 normals and the Eq.-21
    ``dinfo`` columns, each [N, S]."""
    fx, fy, fz = rops.body_force(scene, params["gx"], params["gy"],
                                 params["gz"], scene.is_rigid)
    dfx, dfy, dfz, slots = cops.contact_force(
        scene, dt, params["kr"], params["kf"], params["fric_coeff"],
        cfn_x, cfn_y, cfn_z, dinfo,
        scene.delta_lt_x, scene.delta_lt_y, scene.delta_lt_z,
        scene.fn_x, scene.fn_y, scene.fn_z)
    fx, fy, fz = fx + dfx, fy + dfy, fz + dfz
    if extra_fx is not None:
        efx, efy, efz = extra_fx
        fx, fy, fz = fx + efx, fy + efy, fz + efz
    return scene.replace(
        fx=fx, fy=fy, fz=fz,
        contact_force_normal_x=cfn_x, contact_force_normal_y=cfn_y,
        contact_force_normal_z=cfn_z, contact_force_normal_wij=cfn_w,
        **dinfo, **slots)


def _with_body_sums(scene):
    force, torque = rops.sum_up_external_forces(scene, scene.fx, scene.fy,
                                                scene.fz)
    return scene.replace(force=force, torque=torque)


def _contact_tail(scene, cp, params, dt, extra_fx=None):
    """:func:`_contact_forces` and the per-body sums."""
    return _with_body_sums(_contact_forces(scene, cp, params, dt, extra_fx))


def rigid_contact_force_eval(scene, nbrs, kernel, params, dt,
                             extra_force=None):
    """The stage-2 evaluation on a neighbour list: the Eq.-22 normals,
    the Eq.-21 distance and closest sources, gravity, the Eq.-24 contact
    force, ``extra_force(scene, nbrs)`` (the coupling step's fluid ->
    rigid force, or None) and the per-body sums."""
    cfn_x, cfn_y, cfn_z, cfn_w = cops.contact_force_normals(scene, nbrs,
                                                            kernel)
    dinfo = cops.contact_force_distance(scene, nbrs, kernel, cfn_x, cfn_y,
                                        cfn_z)
    extra_fx = None if extra_force is None else extra_force(scene, nbrs)
    return _with_body_sums(_slot_forces(scene, cfn_x, cfn_y, cfn_z, cfn_w,
                                        dinfo, params, dt, extra_fx))


def build_rigid_gtvf_step_cell(kernel, cell_cfg, params: dict, two_d: bool,
                               ni_max: int, plain: bool = False):
    """One GTVF timestep on the compact contact path, as an eager
    function ``step(scene, dt) -> scene``.  The step also records the
    cull's interesting-slot count in ``scene.n_interesting`` (a 0-d
    device tensor, read by diagnostics without a sync per step).
    ``plain=True`` runs the pack and contact kernels' plain PyTorch
    versions even on CUDA tensors: the kernel step's reference on the
    card.  The route needs the spill grid (``cell_cfg.spill``)."""
    if not cell_cfg.spill:
        raise ValueError("the compact contact route requires a spillover "
                         "grid (cfg.spill=True)")

    def step(scene: Scene, dt: float) -> Scene:
        scene = _body_half_kick(scene, dt, two_d)
        scene = _particles_from_body_velocity(scene)
        scene, cc = rigid_contact_force_eval_compact(
            scene, cell_cfg, kernel, params, dt, ni_max, plain)
        scene = scene.with_fields(
            nbr_overflow=scene.nbr_overflow | cc.overflow,
            n_interesting=cc.n_interesting)
        scene = _body_drift(scene, dt, two_d)
        scene = _particles_from_body_position(scene)
        scene = _body_half_kick(scene, dt, two_d)
        scene = _particles_from_body_velocity(scene)
        return scene

    return step


def build_rigid_gtvf_step_full(force_eval, two_d: bool):
    """One GTVF timestep on the full ``[N, S]`` schema around the
    stage-2 evaluation ``force_eval(scene, dt)`` (a list evaluation, or
    the cell engine's on the carried Verlet-skin grid), as an eager
    ``step(scene, dt) -> scene``."""

    def step(scene: Scene, dt: float) -> Scene:
        scene = _body_half_kick(scene, dt, two_d)
        scene = _particles_from_body_velocity(scene)
        scene = force_eval(scene, dt)
        scene = _body_drift(scene, dt, two_d)
        scene = _particles_from_body_position(scene)
        scene = _body_half_kick(scene, dt, two_d)
        return _particles_from_body_velocity(scene)

    return step


def build_rigid_gtvf_step(kernel, cfg: nbmod.NeighborConfig, params: dict,
                          two_d: bool):
    """One GTVF timestep on the neighbour-list engine, as an eager
    ``step(scene, dt) -> scene``: the list is rebuilt at the kicked
    state's positions for the stage-2 evaluation."""
    return build_rigid_gtvf_step_full(
        _make_force_eval(kernel, params, nbr_cfg=cfg), two_d)


def attach_grid_fields(scene: Scene, cell_cfg) -> Scene:
    """The Verlet-skin grid (the reference's ``attach_grid_fields``): the
    grid of ``cell_cfg`` built at the scene's positions, and those
    positions, as scene fields (``g_slot2p``, ``g_dense_pos``,
    ``g_nbr_slots``, ``g_n_occ``, ``g_overflow``; ``g_xb``, ``g_yb``,
    ``g_zb``), so they ride checkpoints like every other field."""
    grid = cellmod.build_cell_grid(scene.x, scene.y, scene.z, scene.active,
                                   cell_cfg)
    return scene.with_fields(
        g_slot2p=grid.slot2p, g_dense_pos=grid.dense_pos,
        g_nbr_slots=grid.nbr_slots, g_n_occ=grid.n_occupied,
        g_overflow=grid.overflow,
        g_xb=scene.x, g_yb=scene.y, g_zb=scene.z)


def grid_for_step(scene: Scene, cell_cfg):
    """The carried Verlet-skin grid for a force evaluation, rebuilt at the
    current positions exactly when some active particle has moved more
    than skin / 2 since its build (max d^2 > (skin / 2)^2, the
    reference's strict ``>``).  The reference decides on the device with
    ``lax.cond``; this eager step reads that one bool on the host, a
    device sync every force evaluation.  Returns ``(scene, grid)``."""
    dx = scene.x - scene.g_xb
    dy = scene.y - scene.g_yb
    dz = scene.z - scene.g_zb
    d2 = dx * dx + dy * dy + dz * dz
    max_d2 = torch.where(scene.active, d2, torch.zeros_like(d2)).max()
    if bool(max_d2 > (0.5 * cell_cfg.skin) ** 2):
        scene = attach_grid_fields(scene, cell_cfg)
    grid = cellmod.CellGrid(
        slot2p=scene.g_slot2p, dense_pos=scene.g_dense_pos,
        nbr_slots=scene.g_nbr_slots, n_occupied=scene.g_n_occ,
        overflow=scene.g_overflow)
    return scene, grid


def _make_force_eval(kernel, params: dict, cell_cfg=None,
                     plain: bool = False, nbr_cfg=None):
    """The stage-2 evaluation on the full ``[N, S]`` schema (the RK2 and
    leapfrog steppers', the list engine's, the Verlet skin's and the
    classic grid's), with the grid's or the list's overflow ORed into
    ``nbr_overflow``.  With ``nbr_cfg``, a list build and
    :func:`rigid_contact_force_eval`; else the contact pack on a grid,
    the contact sums on every slot (K2) and the Eq.-24 tail on every
    particle: a spill grid build with pack expansion (K1), with a skin
    (``cell_cfg.skin > 0``) the carried grid (:func:`grid_for_step`) and
    its gathered pack (no K1), or a classic grid build and its gathered
    pack (no K1).  ``plain`` runs the kernels' plain versions even on
    CUDA tensors."""
    if nbr_cfg is not None:
        def ev(scene, dt):
            nbrs = nbmod.build_neighbors(scene.x, scene.y, scene.z,
                                         scene.active, nbr_cfg)
            scene = rigid_contact_force_eval(scene, nbrs, kernel, params,
                                             dt)
            return scene.replace(nbr_overflow=scene.nbr_overflow
                                 | nbrs.overflow)
        return ev

    def ev(scene, dt):
        if cell_cfg.skin > 0:
            scene, grid = grid_for_step(scene, cell_cfg)
            dfT = tck.pack_grid(scene, grid, cell_cfg)
        else:
            grid, dfT = tck.pack_contact(scene, cell_cfg, plain)
        cp = tck.contact_pipeline_cell(
            dfT, grid, cell_cfg, kernel, scene.meta.total_no_bodies,
            4.0 * scene.meta.spacing0, scene.n, plain).to(scene.dtype)
        scene = _contact_tail(scene, cp, params, dt)
        return scene.replace(nbr_overflow=scene.nbr_overflow
                             | grid.overflow)

    return ev


def _rotate_from_saved(scene, frac_dt):
    """R = GS(R0 + frac_dt Omega(omega) R) and, with it, the global
    inverse inertia R I_body^-1 R^T."""
    Om = rops.omega_cross_matrix(scene.omega)
    R = rops.gram_schmidt_columns(
        scene.R0 + frac_dt * torch.einsum("bij,bjk->bik", Om, scene.R))
    Iinv = torch.einsum("bij,bjk,blk->bil", R,
                        scene.inertia_tensor_inverse_body_frame, R)
    return R, Iinv


def _rk2_body_stage(scene, frac_dt, two_d):
    """RK2 predictor/corrector body update from the saved state: the COM
    and velocity advance from the saved ``xcm0``/``vcm0`` with the
    current velocity and force, R from ``R0`` with the current omega.
    ``ang_mom0`` is saved per body (the reference's initialise keeps
    body 0's only, an indexing slip; the JAX package saves every body's,
    as here)."""
    M = scene.total_mass[:, None]
    R, Iinv = _rotate_from_saved(scene, frac_dt)
    if two_d:
        vxy = scene.vcm0[:, :2] + frac_dt * scene.force[:, :2] / M
        xy = scene.xcm0[:, :2] + frac_dt * scene.vcm[:, :2]
        izz = torch.where(scene.izz > 0, scene.izz,
                          torch.ones_like(scene.izz))
        oz = scene.omega0[:, 2] + frac_dt * scene.torque[:, 2] / izz
        return scene.replace(
            xcm=torch.cat([xy, scene.xcm0[:, 2:]], 1),
            vcm=torch.cat([vxy, scene.vcm0[:, 2:]], 1), R=R,
            omega=torch.cat([scene.omega0[:, :2], oz[:, None]], 1))
    ang_mom = scene.ang_mom0 + frac_dt * scene.torque
    return scene.replace(
        xcm=scene.xcm0 + frac_dt * scene.vcm,
        vcm=scene.vcm0 + frac_dt * scene.force / M, R=R,
        inertia_tensor_inverse_global_frame=Iinv, ang_mom=ang_mom,
        omega=torch.einsum("bij,bj->bi", Iinv, ang_mom))


def build_rigid_rk2_step(kernel, params: dict, two_d: bool, cell_cfg=None,
                         plain: bool = False, nbr_cfg=None):
    """Predict-evaluate-correct RK2 timestep (the reference's
    ``RK2RigidBody3DStep``): two force evaluations a step, each one K1
    and one K2 on every slot, or a list build and the list passes with
    ``nbr_cfg``.  ``plain`` as in :func:`build_rigid_gtvf_step_cell`."""
    force_eval = _make_force_eval(kernel, params, cell_cfg, plain, nbr_cfg)

    def stage(scene, frac_dt):
        scene = _rk2_body_stage(scene, frac_dt, two_d)
        return _particles_from_body_velocity(
            _particles_from_body_position(scene))

    def step(scene: Scene, dt: float) -> Scene:
        scene = scene.replace(xcm0=scene.xcm, vcm0=scene.vcm,
                              ang_mom0=scene.ang_mom, omega0=scene.omega,
                              R0=scene.R)
        # predictor: forces at t, half a step; corrector: forces at the
        # midpoint, a full step from the saved state
        scene = stage(force_eval(scene, dt), 0.5 * dt)
        return stage(force_eval(scene, dt), dt)

    return step


def _leapfrog_body_stage(scene, frac_dt):
    """The reference's ``LeapFrogRigidBody3DStep`` body update: the COM
    advances from the saved state with the pre-update velocity, the
    velocity with the current force, R from ``R0`` with the current
    omega (``ang_mom0`` saved per body, as for RK2)."""
    M = scene.total_mass[:, None]
    R, Iinv = _rotate_from_saved(scene, frac_dt)
    ang_mom = scene.ang_mom0 + frac_dt * scene.torque
    return scene.replace(
        xcm=scene.xcm0 + frac_dt * scene.vcm,
        vcm=scene.vcm0 + frac_dt * scene.force / M, R=R, ang_mom=ang_mom,
        omega=torch.einsum("bij,bj->bi", Iinv, ang_mom),
        inertia_tensor_inverse_global_frame=Iinv)


def build_rigid_leapfrog_step(kernel, params: dict, cell_cfg=None,
                              plain: bool = False, nbr_cfg=None):
    """The reference's ``LeapFrogRigidBody3DStep`` under the GTVF
    sequencing (save, half a step with the stored force, one force
    evaluation, a full step from the saved state); 3D only.  One K1 and
    one K2 on every slot a step, or one list evaluation with
    ``nbr_cfg``."""
    force_eval = _make_force_eval(kernel, params, cell_cfg, plain, nbr_cfg)

    def stage(scene, frac_dt):
        scene = _leapfrog_body_stage(scene, frac_dt)
        return _particles_from_body_velocity(
            _particles_from_body_position(scene))

    def step(scene: Scene, dt: float) -> Scene:
        scene = scene.replace(xcm0=scene.xcm, vcm0=scene.vcm,
                              ang_mom0=scene.ang_mom, R0=scene.R)
        scene = stage(scene, 0.5 * dt)
        return stage(force_eval(scene, dt), dt)

    return step


def make_multi_step(step, n: int):
    """n steps chained as a Python loop."""

    def multi(scene: Scene, dt: float) -> Scene:
        for _ in range(n):
            scene = step(scene, dt)
        return scene

    return multi
