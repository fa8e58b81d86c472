"""DEM granular scheme: Luding LVC contact with the GTVF stage order.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/models/dem.py``.  One step
is, in order: half-kick of velocity and spin with the stored force and
torque; the contact pass (``ops/dem_kernel.py``); force and torque
assembly on the mobile groups (boundaries stay static and carry zero
force); drift; the second half-kick.

Per-particle state: angular velocity ``wx/wy/wz``, torque, the scalar
moment of inertia ``moi`` and the ``[N, L]`` tangential contact table.

``contact_model`` (``--contact-model``) picks the contact law:

* ``"LVCDisplacement"`` (default): displacement springs
  ``tng_x/y/z``, per-entity material vectors
  ``dem_kn/dem_kt/dem_alpha/dem_mu`` read by source dem id, the table
  prune fused into the kernel's pass.  The grid is a constructor
  argument: ``dem_grid="spill"`` (default, the cell-keyed spill grid,
  kernel ``dem_cell``) or ``"rowwin"`` (the row-window grid, kernel
  ``dem_rowwin``).  Unlike the reference package, which takes its kernel
  path only on a TPU, the port takes it on every device; the kernel
  wrappers run their plain versions on CPU tensors.
* ``"LVCForce"``: tangential-force springs ``tng_fx/fy/fz`` and the
  scheme's scalar kn, mu, en; the prune, then the pair pass on a spill
  grid of the cubic spline's support, in PyTorch ops on every device
  (the reference package runs it in XLA only: it has no kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cellpairs as cellmod
from ..ops import dem_kernel as dk
from ..ops import rowwin as rwmod
from ..state.scene import Scene
from .base import Scheme


class DEMScheme(Scheme):
    name = "dem"

    def __init__(self, granular_particles, boundaries, kn=1e5, en=0.5,
                 dim=2, gx=0.0, gy=0.0, gz=0.0,
                 contact_model="LVCDisplacement", max_tng_contacts_limit=6,
                 mu=0.5, dem_grid="spill"):
        if contact_model not in ("LVCDisplacement", "LVCForce"):
            raise ValueError(f"unknown contact model {contact_model!r}")
        if dem_grid not in ("spill", "rowwin"):
            raise ValueError(f"unknown DEM grid {dem_grid!r}")
        self.granular_particles = list(granular_particles or [])
        self.boundaries = list(boundaries or [])
        self.dim = dim
        self.kn = kn
        self.en = en
        self.mu = mu
        self.gx, self.gy, self.gz = gx, gy, gz
        self.contact_model = contact_model
        self.max_tng_contacts_limit = int(max_tng_contacts_limit)
        self.dem_grid = dem_grid
        # spill-grid bins are cell_factor x the contact radius, M lanes a
        # slot: the reference package's DEM defaults
        self.cell_factor = 4.0 if dim == 2 else 2.0
        self.cell_M = 16 if dim == 2 else 8
        self._cell_cfg = None
        self._rowwin_cfg = None

    def add_user_options(self, group):
        group.add_argument("--contact-model", dest="contact_model",
                           default="LVCDisplacement",
                           choices=["LVCDisplacement", "LVCForce"],
                           help="DEM contact model")

    def consume_user_options(self, options):
        if hasattr(options, "contact_model"):
            self.contact_model = options.contact_model

    def derived_lvc_constants(self):
        """kt = 2/7 kn; alpha from the restitution coefficient."""
        log_en = np.log(self.en)
        alpha = 2.0 * np.sqrt(self.kn) * abs(log_en) / np.sqrt(
            np.pi**2 + log_en**2)
        return 2.0 / 7.0 * self.kn, alpha

    def setup(self, scene: Scene, dem_kn=None, dem_kt=None, dem_alpha=None,
              dem_mu=None) -> Scene:
        """Attach the DEM state (per-entity tables default to the
        scheme's constants; ``moi`` defaults to the sphere's 2/5 m r^2)."""
        fdt, dev = scene.dtype, scene.device
        n = scene.n
        L = self.max_tng_contacts_limit
        n_ent = scene.meta.total_no_bodies
        kt_d, alpha_d = self.derived_lvc_constants()

        def tab(v, default):
            v = default if v is None else v
            return torch.as_tensor(
                np.broadcast_to(np.asarray(v, float), (n_ent,)).copy(),
                dtype=fdt, device=dev)

        zeros = lambda *s: torch.zeros(s, dtype=fdt, device=dev)
        empty = lambda: torch.full((n, L), -1, dtype=torch.int32, device=dev)
        fields = dict(
            fx=zeros(n), fy=zeros(n), fz=zeros(n),
            wx=zeros(n), wy=zeros(n), wz=zeros(n),
            torx=zeros(n), tory=zeros(n), torz=zeros(n),
            tng_idx=empty(), tng_idx_dem_id=empty(),
            total_tng_contacts=torch.zeros(n, dtype=torch.int32, device=dev),
            dem_kn=tab(dem_kn, self.kn), dem_kt=tab(dem_kt, kt_d),
            dem_alpha=tab(dem_alpha, alpha_d), dem_mu=tab(dem_mu, self.mu),
            nbr_overflow=torch.zeros((), dtype=torch.bool, device=dev),
        )
        for k in self._springs():
            fields[k] = zeros(n, L)
        if "moi" not in scene:
            host = lambda k: scene[k].detach().cpu().numpy()
            fields["moi"] = torch.as_tensor(
                0.4 * host("m") * host("rad_s") ** 2, dtype=fdt, device=dev)
        return scene.with_fields(**fields)

    def _springs(self):
        """The contact table's spring fields."""
        if self.contact_model == "LVCDisplacement":
            return ("tng_x", "tng_y", "tng_z")
        return ("tng_fx", "tng_fy", "tng_fz")

    def _contact_radius(self, scene: Scene) -> float:
        # the fused prune needs every overlapping pair to be a
        # candidate: cutoff = 2 max(rad_s), read once on the host
        return 2.0 * float(scene.rad_s.detach().cpu().max())

    def cell_config(self, scene: Scene) -> cellmod.CellGridConfig:
        """The spill grid of the DEM kernel: cutoff = the contact radius,
        bins ``cell_factor`` x coarser, ``cell_M`` lanes a slot.  For
        LVCForce, the reference package's grid of that model: cutoff =
        the cubic spline's support 2 max(h), bins of the cutoff, 16
        lanes a slot; its pass runs in PyTorch ops a chunk of slots at a
        time, and on the card in chunks of 4,096 slots (fewer launches;
        a [query lane, candidate] tensor of such a chunk is 64 MiB in
        float32 at 16 lanes and 16 stencil slots)."""
        if self._cell_cfg is None:
            host = lambda k: scene[k].detach().cpu().numpy()
            kw = dict(cell_factor=self.cell_factor, M=self.cell_M)
            cutoff = self._contact_radius(scene)
            if self.contact_model == "LVCForce":
                cutoff = 2.0 * float(host("h").max())
                kw = dict(cell_factor=1.0, M=16, cell_chunk=(
                    4096 if scene.device.type == "cuda" else 512))
            self._cell_cfg = cellmod.config_from_positions(
                host("x"), host("y"), host("z"), cutoff, self.dim,
                capacity_boost=self.capacity_boost, **kw)
        return self._cell_cfg

    def rowwin_config(self, scene: Scene) -> rwmod.RowWinConfig:
        """The row-window grid (bins = the contact radius)."""
        if self._rowwin_cfg is None:
            host = lambda k: scene[k].detach().cpu().numpy()
            self._rowwin_cfg = rwmod.rowwin_config_from_positions(
                host("x"), host("y"), host("z"), self._contact_radius(scene),
                self.dim, capacity_boost=self.capacity_boost)
        return self._rowwin_cfg

    def refresh_configs(self, scene: Scene, grow: bool = False) -> None:
        super().refresh_configs(scene, grow)
        self._rowwin_cfg = None

    def make_step(self, scene: Scene, plain: bool = False):
        """An eager ``step(scene, dt)``.  The step records the gated pairs
        of its contact pass in ``scene.n_gated`` (a 0-d device tensor,
        read without a sync per step).  ``plain=True`` runs the kernels'
        plain versions even on CUDA tensors: the kernel step's reference
        on the card."""
        springs = self._springs()
        if self.contact_model == "LVCForce":
            cfg = self.cell_config(scene)
            kn, mu, en = self.kn, self.mu, self.en

            def contact(scene, cfg, dt, *tables, plain):
                return dk.lvc_force_pass(scene, cfg, dt, kn, mu, en,
                                         *tables)
        else:
            if self.dem_grid == "rowwin":
                cfg = self.rowwin_config(scene)
                contact = dk.lvc_displacement_rowwin_kernel
            else:
                cfg = self.cell_config(scene)
                contact = dk.lvc_displacement_cell_kernel
            if cfg.radius < self._contact_radius(scene):
                raise ValueError("the DEM grid's cutoff is below 2 "
                                 "max(rad_s): the fused prune would miss "
                                 "overlapping pairs")
        gx, gy, gz = self.gx, self.gy, self.gz
        # only the granular groups move (boundaries static)
        mob = np.zeros(scene.n, bool)
        for g in scene.meta.groups:
            if g.name in self.granular_particles:
                mob[g.start:g.stop] = True
        mobile = torch.as_tensor(mob, device=scene.device)

        def half_kick(scene, half):
            m_inv = 1.0 / scene.m
            I_inv = 1.0 / scene.moi
            sel = lambda new, old: torch.where(mobile, new, old)
            return scene.replace(
                u=sel(scene.u + half * scene.fx * m_inv, scene.u),
                v=sel(scene.v + half * scene.fy * m_inv, scene.v),
                w=sel(scene.w + half * scene.fz * m_inv, scene.w),
                wx=sel(scene.wx + half * scene.torx * I_inv, scene.wx),
                wy=sel(scene.wy + half * scene.tory * I_inv, scene.wy),
                wz=sel(scene.wz + half * scene.torz * I_inv, scene.wz))

        def step(scene: Scene, dt: float) -> Scene:
            half = 0.5 * dt
            scene = half_kick(scene, half)
            r = contact(scene, cfg, dt, scene.tng_idx, scene.tng_idx_dem_id,
                        *(scene[k] for k in springs), plain=plain)
            gmask = mobile & scene.active
            zero = torch.zeros((), dtype=scene.dtype, device=scene.device)
            scene = scene.replace(
                tng_idx=r.tng_idx, tng_idx_dem_id=r.tng_dem,
                **dict(zip(springs, (r.tng_x, r.tng_y, r.tng_z))),
                total_tng_contacts=r.count,
                nbr_overflow=scene.nbr_overflow | r.overflow,
                fx=torch.where(gmask, scene.m * gx + r.fx, zero),
                fy=torch.where(gmask, scene.m * gy + r.fy, zero),
                fz=torch.where(gmask, scene.m * gz + r.fz, zero),
                torx=torch.where(gmask, r.torx, zero),
                tory=torch.where(gmask, r.tory, zero),
                torz=torch.where(gmask, r.torz, zero))
            scene = scene.with_fields(n_gated=r.n_gated.sum())
            sel = lambda new, old: torch.where(mobile, new, old)
            scene = scene.replace(x=sel(scene.x + dt * scene.u, scene.x),
                                  y=sel(scene.y + dt * scene.v, scene.y),
                                  z=sel(scene.z + dt * scene.w, scene.z))
            return half_kick(scene, half)

        return step
