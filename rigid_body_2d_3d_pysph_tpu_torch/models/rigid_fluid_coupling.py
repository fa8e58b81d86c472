"""Rigid-fluid coupling scheme: WCSPH (EDAC or Tait) fluid, Adami wall
conditions, two-way FSI and the Mofidi rigid contact, in the three GTVF
orderings of the reference, or the RK2 predictor-corrector step.

Counterpart of ``RigidFluidCouplingScheme`` in
``rigid_body_2d_3d_pysph_tpu/models/rigid_fluid_coupling.py``, the
branches the JAX package runs off the TPU, as eager functions
``step(scene, dt) -> scene`` on the full ``[N, S]`` slot schema
(``_contact_tail``):

* kdkf, the fused kick-drift-kick (``_make_step_cell_kdkf`` :421-746):
  one grid build and one 14-field pack per step, three pair passes on
  that pack with the thermo updates patched into its columns between
  them, one unpack::

    kick -> drift -> build + pack (K1) -> rates + wall sums (B4) ->
    patch rho (and p: EDAC or Tait) -> patch the wall and body
    pressures p, p_fsi -> forces + contact (B5; B6c without bodies) ->
    one unpack of the 13 fluid columns (B5 writes its contact columns by
    particle, the layout the tail reads) -> thermo, wall and force
    updates -> contact tail with the fluid -> rigid force -> kick

* kdk (``_make_step_cell`` :809-917), two grids a step::

    kick -> build + pack at x_n (K1) -> rates (B6a) -> drift -> Tait ->
    build + pack at x_n+1 (K1) -> wall sums (B6b) -> patch p, p_fsi ->
    forces (B6c) -> contact on every slot (K2) -> kick

* reference, the PySPH staging (``_make_step_cell`` :919-1018), one
  grid a step::

    build + pack at x_n (K1) -> rates (B6a) on the pre-kick velocities
    -> kick -> Tait -> patch u, v, w, p -> wall sums (B6b) -> patch p,
    p_fsi -> forces (B6c) -> contact on every slot (K2) -> drift -> kick

* rk2 (``fluid_stepper = "rk2"``, ``_make_step_cell_rk2`` :294-419;
  Tait only), two evaluations a step, each on one grid::

    save -> [Tait -> build + pack (K1) -> rates (B6a) -> wall sums (B6b)
    -> patch p, p_fsi -> forces (B6c) -> contact on every slot (K2)] ->
    stage dt/2 from the saved state -> [the same] -> stage dt

  A stage moves the fluid's x from the saved state with the current
  velocity, then its velocity and density with the current rates, and
  runs the rigid RK2 body stage.

A scheme with no fluid group runs kdk for kdkf, as the reference does
(``make_step`` :279-289): kicks, drift, one grid with the contact pack
alone (K1), contact, kick.  The kdk and reference steps patch their
pack's columns where the reference repacks (``pack_fluid_pallas`` at
:771/:784/:797): the passes see the same values.  With fluid, their
contact pack is laid out from the coupling pack
(``contact_kernel.contact_pack``), so a grid costs one K1 launch.

With ``engine = "nklist"`` the kdk and reference orderings run on the
``[N, K]`` neighbour list instead (``build_coupling_nklist_step``, the
reference's ``_make_step_nklist`` :1020-1259): the list passes of
``ops/fluid.py`` and the rigid list evaluation, one list build at x_n+1
for kdk's forces (and one at x_n for its rates), one at x_n for the
reference staging; kdkf runs kdk there, and the RK2 stepper raises, as
in the reference.  It launches no hand-written kernel.

With S >= ``compact_min_bodies`` entities, kdkf keeps the contact slot
state in the compact store of the rigid scheme (``cl_pid``,
``cl_state``; ``rigid_body.compact_slot_scene``), the route the
reference takes on its TPU from S = 8 (``setup`` :196-205, the branch
of ``_make_step_cell_kdkf`` :549-579 and :716-724).  The light cull
(``contact_kernel.cull_rigid_query_slots``) picks the slots that hold a
rigid lane before B5 runs; B5 runs on every slot as before and writes
its contact columns at the first ``ni_max`` of them only, by query row
(``CompactContact.out``); the one unpack takes the 13 fluid columns; and
the Eq.-24 tail runs on the culled lanes
(``rigid_body._compact_contact_tail``, with the fluid -> rigid force
added before the body sums).  More interesting slots than ``ni_max``
raise ``nbr_overflow``, and the overflow rebuild widens the store
(``adapt_scene``).  The launches are those of the full route, one K1,
one B4 and one B5 a step, and the results are the full route's bit for
bit (a padding row past the culled slots holds the init row).  The gate (``_compact_enabled``) is the reference's, with the cell
engine for its Pallas engine, and fluid present: the reference
compacts a scene with no fluid group too, whose kdk step then reads the
slot fields that the store replaced.  Like the rigid scheme's compact
route, it runs on every device and SPH kernel (the kernels' plain
versions on CPU tensors).  RK2, kdk, reference, the list engine and
fewer entities keep the full ``[N, S]`` schema.  ``compact_min_bodies``
is 97 by default: on an H100 the compact route measured slower than the
full one up to S = 64 (its cull, gather and inverse table add ~95
launches to a host-bound step) and faster from S = 97, where the full
route's ``[N, S]`` tail outgrows them (``scripts/compact_crossover.py``);
8 gives the reference's gate, None turns the store off.

Bodies are integrated in 3D (``two_d=False``) even in 2D scenes, as the
reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cellpairs as cellmod
from ..ops import fluid as fops
from ..ops import fluid_kernel as fk
from ..ops import neighbors as nbmod
from ..ops.cellpairs import lane_map, unpack
from ..ops import contact_kernel as tck
from ..ops.fluid import tait_eos
from ..ops.kernels import get_kernel
from ..state import rigid_setup
from ..state.scene import Scene
from .base import Scheme
from .rigid_body import (
    _attach_contact_fields,
    _body_drift,
    _body_half_kick,
    _compact_contact_tail,
    _contact_tail,
    compact_capacity,
    compact_slot_scene,
    expand_slot_scene,
    fit_compact_store,
    _particles_from_body_position,
    _particles_from_body_velocity,
    _rk2_body_stage,
    rigid_contact_force_eval,
    run_boundary_identification,
    run_boundary_identification_cell,
)

# per-particle fields the scheme attaches, the RK2 step's saved state
# (x0 ... rho0_rk) last
FLUID_FIELDS = ("rho_fsi", "m_fsi", "p_fsi", "wij_adami", "uf", "vf", "wf",
                "ug", "vg", "wg", "arho", "ap", "au", "av", "aw", "vol",
                "cs", "x0", "y0", "z0", "u0", "v0", "w0", "rho0_rk")
# entities (bodies and walls) from which kdkf keeps the compact store
# (None: never): on an H100, compact / full ms a step was 1.03-1.38 at S =
# 9-64, 0.97 and 1.11 at 65, 0.76-0.81 at 97 and 129 in two timed calls
# of scripts/compact_crossover.py
COMPACT_MIN_BODIES = 97


class RigidFluidCouplingScheme(Scheme):
    name = "rfc"

    def __init__(self, fluids, boundaries, rigid_bodies, dim, rho0, p0, c0,
                 h, nu, kr=1e5, kf=1e5, en=0.5, fric_coeff=0.5, gamma=7.0,
                 gx=0.0, gy=0.0, gz=0.0, alpha=0.1, beta=0.0,
                 kernel_choice="1", kernel_factor=3, edac_alpha=0.5):
        self.fluids = list(fluids or [])
        self.boundaries = list(boundaries or [])
        self.rigid_bodies = list(rigid_bodies or [])
        self.dim = dim
        # plain Python floats, so no numpy scalar widens a float32 pass
        self.rho0, self.p0, self.c0, self.gamma = (
            float(rho0), float(p0), float(c0), float(gamma))
        self.h = float(h)
        self.nu = float(nu)
        self.kr, self.kf, self.en, self.fric_coeff = (
            float(kr), float(kf), float(en), float(fric_coeff))
        self.gx, self.gy, self.gz = float(gx), float(gy), float(gz)
        self.fluid_alpha = float(alpha)
        self.beta = float(beta)
        self.edac = True
        self.edac_alpha = edac_alpha
        self.kernel_name = "quintic"
        self.gtvf_ordering = "kdkf"
        # "gtvf" (in ``gtvf_ordering``) or "rk2" (Tait only)
        self.fluid_stepper = "gtvf"
        self.compact_min_bodies = COMPACT_MIN_BODIES
        self._cell_cfg = None

    @property
    def edac_nu(self):
        """nu_edac = alpha h c0 / 8."""
        return self.fluid_alpha * self.h * self.c0 / 8.0

    def add_user_options(self, group):
        group.add_argument("--kr-stiffness", dest="kr", default=1e5,
                           type=float)
        group.add_argument("--kf-stiffness", dest="kf", default=1e3,
                           type=float)
        group.add_argument("--fric-coeff", dest="fric_coeff", default=0.5,
                           type=float)
        group.add_argument("--fluid-alpha", dest="fluid_alpha", default=0.5,
                           type=float, help="Artificial viscosity")
        group.add_argument("--edac", dest="edac", action="store_true",
                           default=True)
        group.add_argument("--no-edac", dest="edac", action="store_false")
        group.add_argument("--gtvf-ordering", dest="gtvf_ordering",
                           choices=("kdk", "kdkf", "reference"),
                           default=None,
                           help="GTVF stage ordering: kdk (two grids a "
                                "step), kdkf (one fused grid a step), "
                                "reference (PySPH staging)")

    def consume_user_options(self, options):
        for k in ("kr", "kf", "fric_coeff", "fluid_alpha", "edac"):
            if hasattr(options, k):
                setattr(self, k, getattr(options, k))
        if getattr(options, "gtvf_ordering", None):
            self.gtvf_ordering = options.gtvf_ordering

    def set_linear_velocity(self, scene: Scene, vel) -> Scene:
        return rigid_setup.set_linear_velocity(scene, vel)

    def set_angular_velocity(self, scene: Scene, omega) -> Scene:
        return rigid_setup.set_angular_velocity(scene, omega)

    # -- setup ------------------------------------------------------------
    def setup(self, scene: Scene, coeff_of_rest=None,
              identify_boundaries: bool = True) -> Scene:
        """Contact slots, body state, the FSI shadow and Adami ghost
        fields, the fluid rate fields, vol = m / rho and cs = c0; then
        surface identification of the bodies and walls on the cell grid,
        which also sets ``contact_force_is_boundary``."""
        n, dev, fdt = scene.n, scene.device, scene.dtype
        scene = _attach_contact_fields(scene)
        if scene.meta.nb > 0:
            scene = rigid_setup.setup_body_state(scene, coeff_of_rest)
        scene = scene.with_fields(**{
            k: torch.zeros(n, dtype=fdt, device=dev)
            for k in FLUID_FIELDS if k not in scene})
        m = scene.m.detach().cpu().numpy().astype(np.float64)
        rho = scene.rho.detach().cpu().numpy().astype(np.float64)
        vol = m / np.where(rho > 0, rho, 1.0)
        scene = scene.replace(
            vol=torch.as_tensor(vol, dtype=fdt, device=dev),
            cs=torch.full((n,), self.c0, dtype=fdt, device=dev))
        if identify_boundaries and (self.rigid_bodies or self.boundaries):
            kernel = get_kernel(self.kernel_name, self.dim)
            names = self.rigid_bodies + self.boundaries
            if self.engine == "nklist":
                scene = run_boundary_identification(
                    scene, kernel,
                    self.list_config(scene, kernel.radius_scale), names)
            else:
                scene = run_boundary_identification_cell(
                    scene, kernel, self.cell_config(scene, kernel), names)
            scene = scene.replace(
                contact_force_is_boundary=scene.is_boundary.to(fdt))
        if self._compact_enabled() and self.compact_min_bodies is not None \
                and scene.meta.total_no_bodies >= self.compact_min_bodies:
            kernel = get_kernel(self.kernel_name, self.dim)
            cfg = self.cell_config(scene, kernel)
            scene = compact_slot_scene(scene, self.ni_max(cfg) * cfg.M)
        return scene

    def _compact_enabled(self) -> bool:
        """The compact store's gate (reference :207-223): the fused kdkf
        GTVF step on the cell engine, with rigid bodies and fluid."""
        return (self.engine == "cell" and self.gtvf_ordering == "kdkf"
                and self.fluid_stepper == "gtvf"
                and bool(self.rigid_bodies) and bool(self.fluids))

    def ni_max(self, cfg: cellmod.CellGridConfig) -> int:
        """Interesting-slot capacity (reference :225-228), widened by the
        overflow rebuild through ``capacity_boost``."""
        return compact_capacity(cfg, self.capacity_boost)

    def adapt_scene(self, scene: Scene) -> Scene:
        """Pad the compact store to the current capacity (after an
        overflow rebuild raised ``ni_max``)."""
        scene = super().adapt_scene(scene)
        if "cl_pid" not in scene:
            return scene
        return fit_compact_store(scene, self.cell_config(scene, get_kernel(
            self.kernel_name, self.dim)), self.capacity_boost)

    def export_scene(self, scene: Scene) -> Scene:
        """IO view: the [N, S] slot fields materialised."""
        return expand_slot_scene(scene)

    def cell_config(self, scene: Scene, kernel) -> cellmod.CellGridConfig:
        if self._cell_cfg is None:
            host = lambda k: scene[k].detach().cpu().numpy()
            cutoff = float(kernel.radius_scale * host("h").max())
            self._cell_cfg = cellmod.config_from_positions(
                host("x"), host("y"), host("z"), cutoff, self.dim,
                capacity_boost=self.capacity_boost)
        return self._cell_cfg

    # -- the step -----------------------------------------------------------
    def make_step(self, scene: Scene, plain: bool = False):
        """The step of ``fluid_stepper`` (and, for GTVF, of
        ``gtvf_ordering``) as an eager ``step(scene, dt) -> scene``; kdkf
        with no fluid group runs kdk (reference :279-289).  ``plain=True``
        runs the kernels' plain versions even on CUDA tensors (the kernel
        step's reference on the card)."""
        if self.fluid_stepper not in ("gtvf", "rk2"):
            raise ValueError(f"fluid_stepper={self.fluid_stepper!r}: one "
                             "of 'gtvf', 'rk2'")
        if self.fluid_stepper == "rk2" and self.engine == "nklist":
            raise NotImplementedError("rk2 fluid stepper: cell engine")
        if self.fluid_stepper == "rk2" and self.edac:
            raise NotImplementedError(
                "rk2 fluid stepper integrates rho only (reference "
                "RK2FluidStep :228-271 has no p0/ap state) — use "
                "Tait EOS (edac=False)")
        step_builds = dict(kdkf=build_coupling_kdkf_step,
                           kdk=build_coupling_kdk_step,
                           reference=build_coupling_reference_step)
        ordering = self.gtvf_ordering
        if ordering not in step_builds:
            raise ValueError(f"gtvf_ordering={ordering!r}: one of "
                             f"{sorted(step_builds)}")
        if self.fluid_stepper == "rk2":
            ordering = "rk2"
            step_builds["rk2"] = build_coupling_rk2_step
        elif ordering == "kdkf" and (not self.fluids
                                     or self.engine == "nklist"):
            # the fusion changes the fluid's grid schedule only
            ordering = "kdk"
        compact = "cl_pid" in scene
        if compact and not (self._compact_enabled() and ordering == "kdkf"):
            raise ValueError(
                "the scene holds the compact contact store, which only the "
                "kdkf step on the cell engine with fluid and bodies reads: "
                "set the scene up under the scheme's present settings, or "
                "expand it (rigid_body.expand_slot_scene and "
                "strip_compact_fields)")
        kernel = get_kernel(self.kernel_name, self.dim)
        params = dict(kr=self.kr, kf=self.kf, fric_coeff=self.fric_coeff,
                      gx=self.gx, gy=self.gy, gz=self.gz)
        if self.engine == "nklist":
            return build_coupling_nklist_step(
                kernel, self.list_config(scene, kernel.radius_scale), params,
                ordering,
                edac=self.edac, nu_edac=self.edac_nu, c0=self.c0,
                rho0=self.rho0, gamma=self.gamma,
                fluid_alpha=self.fluid_alpha,
                has_fluid=len(self.fluids) > 0,
                has_rigid=len(self.rigid_bodies) > 0)
        args = dict(
            kernel=kernel, cfg=self.cell_config(scene, kernel), params=params,
            edac=self.edac, nu_edac=self.edac_nu, c0=self.c0,
            rho0=self.rho0, gamma=self.gamma, fluid_alpha=self.fluid_alpha,
            has_rigid=len(self.rigid_bodies) > 0, plain=plain)
        if ordering != "kdkf":
            args["has_fluid"] = len(self.fluids) > 0
        elif compact:
            args["ni_max"] = self.ni_max(args["cfg"])
        if ordering == "rk2":
            del args["edac"]
        return step_builds[ordering](**args)


def _masks(scene):
    """(fluid, static boundary, rigid, solid) over the active particles."""
    fl = scene.is_fluid & scene.active
    bd = scene.is_static_boundary & scene.active
    rb = scene.is_rigid & scene.active
    return fl, bd, rb, bd | rb


def _kick(scene, dt, fl, has_fluid, has_rigid):
    """Half-kick of the fluid velocities and the bodies, and the body
    particles' velocities from their bodies."""
    if has_fluid:
        scene = scene.replace(
            u=torch.where(fl, scene.u + 0.5 * dt * scene.au, scene.u),
            v=torch.where(fl, scene.v + 0.5 * dt * scene.av, scene.v),
            w=torch.where(fl, scene.w + 0.5 * dt * scene.aw, scene.w))
    if has_rigid:
        scene = _particles_from_body_velocity(
            _body_half_kick(scene, dt, two_d=False))
    return scene


def _drift(scene, dt, fl, edac, has_fluid, has_rigid):
    """Fluid positions, density, volume (and the EDAC pressure) from the
    stored rates; the bodies and their particles' positions."""
    if has_fluid:
        rho_new = scene.rho + dt * scene.arho
        upd = dict(
            x=torch.where(fl, scene.x + dt * scene.u, scene.x),
            y=torch.where(fl, scene.y + dt * scene.v, scene.y),
            z=torch.where(fl, scene.z + dt * scene.w, scene.z),
            rho=torch.where(fl, rho_new, scene.rho),
            vol=torch.where(fl, scene.m / rho_new, scene.vol))
        if edac:
            upd["p"] = torch.where(fl, scene.p + dt * scene.ap, scene.p)
        scene = scene.replace(**upd)
    if has_rigid:
        scene = _particles_from_body_position(
            _body_drift(scene, dt, two_d=False))
    return scene


def _wall_pressure(sw, p_num):
    """The Shepard wall pressure p_num / sw where sw > 1e-14."""
    has = sw > 1e-14
    return torch.where(has, p_num / torch.where(has, sw, 1.0), p_num), has


def wall_pressures(scene, wall):
    """(p, p_fsi) after the Adami sums ``wall [N, 5]``: the Shepard
    pressure clamped at 0 on the walls, unclamped on the bodies."""
    _, bd, rb, _ = _masks(scene)
    p_bc, _ = _wall_pressure(wall[:, 3], wall[:, 4])
    return (torch.where(bd, torch.clamp(p_bc, min=0.0), scene.p),
            torch.where(rb, p_bc, scene.p_fsi))


def _apply_wall_forces(scene, wall, forces, gvec):
    """The wall and body updates from the Adami sums ``wall [N, 5]`` (uf,
    vf, wf, sw, p_num) and the fluid accelerations from the force columns
    ``forces [N, >= 3]`` (au, av, aw, ...)."""
    fl, _, _, solid = _masks(scene)
    zero = torch.zeros((), dtype=scene.dtype, device=scene.device)
    sw = wall[:, 3]
    _, has = _wall_pressure(sw, wall[:, 4])
    inv = torch.where(has, 1.0 / torch.clamp(sw, min=1e-300), zero)
    ufn, vfn, wfn = wall[:, 0] * inv, wall[:, 1] * inv, wall[:, 2] * inv
    p, p_fsi = wall_pressures(scene, wall)
    return scene.replace(
        p=p, p_fsi=p_fsi,
        uf=torch.where(solid, ufn, scene.uf),
        vf=torch.where(solid, vfn, scene.vf),
        wf=torch.where(solid, wfn, scene.wf),
        ug=torch.where(solid, 2.0 * scene.u - ufn, scene.ug),
        vg=torch.where(solid, 2.0 * scene.v - vfn, scene.vg),
        wg=torch.where(solid, 2.0 * scene.w - wfn, scene.wg),
        wij_adami=torch.where(solid, sw, scene.wij_adami),
        au=torch.where(fl, gvec[0] + forces[:, 0], zero),
        av=torch.where(fl, gvec[1] + forces[:, 1], zero),
        aw=torch.where(fl, gvec[2] + forces[:, 2], zero))


def culled_lanes(scene, dfT, pt, cfg, ni_max: int):
    """The compact route's light cull on the coupling pack ``dfT``, run
    before B5: ``(rows, cc)``, the first ``ni_max`` slots with a rigid
    lane (``rows [ni_max]``, ascending, NC past their count: where B5
    writes its contact rows) and their lanes' particles and query
    velocities (reference :556-574) as a ``CompactContact`` whose ``out``
    is B5's to fill."""
    NC, M = cfg.NC_max, cfg.M
    interesting, islot = tck.cull_rigid_query_slots(dfT, pt.slot_cid, cfg)
    n_int = interesting.to(torch.int64).sum()
    isl = islot[:ni_max]
    valid = isl < NC
    isl_c = torch.clamp(isl, 0, NC - 1)
    qsel = torch.where(valid, isl, torch.full_like(isl, NC))
    pid, u_c, v_c, w_c = tck.compact_lanes(
        dfT, pt, qsel, valid, isl_c, scene.n, M, (fk.FU, fk.FV, fk.FW))
    return qsel, tck.CompactContact(out=None, pid=pid, u=u_c, v=v_c, w=w_c,
                                    overflow=n_int > ni_max,
                                    n_interesting=n_int)


def build_coupling_kdkf_step(kernel, cfg, params: dict, edac: bool,
                             nu_edac: float, c0: float, rho0: float,
                             gamma: float, fluid_alpha: float,
                             has_rigid: bool, plain: bool = False,
                             ni_max: int = 0):
    """One fused kdkf timestep (see the module docstring); ``ni_max > 0``
    takes the compact route on a scene that holds the compact store, and
    records the light cull's count in ``scene.n_interesting``."""
    gvec = (params["gx"], params["gy"], params["gz"])
    NC = cfg.NC_max
    cutoff = cfg.radius

    def eval_passes(scene, dt):
        """Build, pack and the pair passes with the dense column patches
        between them -> (grid, [N, 13] = arho, ap, uf, vf, wf, sw, p_num,
        au, av, aw, fx, fy, fz, contact: the columns [N, 12, S], the
        culled lanes (``ni_max > 0``) or None)."""
        if plain:
            rates_wall = fk.fluid_rates_wall_reference
            forces = fk.fluid_forces_reference
            forces_contact = fk.fluid_forces_contact_reference
        else:
            rates_wall, forces = fk.fluid_rates_wall, fk.fluid_forces
            forces_contact = fk.fluid_forces_contact
        S = scene.meta.total_no_bodies
        grid, pt, dfT = fk.pack_fluid_sorted(scene, cfg, plain)
        nbr = grid.nbr_slots
        _, _, sb, fl, rg = fk.decode_flags(dfT[:NC, fk.FFLAGS])
        fl_l, bd_l, rb_l = fl == 1.0, sb == 1.0, rg == 1.0

        rw = rates_wall(dfT, nbr, kernel, cutoff, nu_edac, c0, edac,
                        has_rigid, gvec)                  # [NC, M, 7]
        rho_d = dfT[:NC, fk.FRHO]
        p_d = dfT[:NC, fk.FP]
        rho_new = torch.where(fl_l, rho_d + dt * rw[..., 0], rho_d)
        if edac:
            p_new = torch.where(fl_l, p_d + dt * rw[..., 1], p_d)
        else:
            B = c0 * c0 * rho0 / gamma
            p_new = torch.where(fl_l, B * ((rho_new / rho0) ** gamma - 1.0),
                                p_d)
        # the wall pressures: Shepard p_num / sw where sw > 1e-14,
        # clamped at 0 on walls, unclamped on bodies (p_fsi)
        pbc, _ = _wall_pressure(rw[..., 5], rw[..., 6])
        p2 = torch.where(bd_l, torch.clamp(pbc, min=0.0), p_new)
        pfsi2 = torch.where(rb_l, pbc, dfT[:NC, fk.FPFSI])
        # the patches write the step's fresh pack in place
        dfT[:NC, fk.FRHO] = rho_new
        dfT[:NC, fk.FP] = p2
        dfT[:NC, fk.FPFSI] = pfsi2

        if not has_rigid:
            fo = forces(dfT, nbr, kernel, cutoff, fluid_alpha, c0)
            flat = unpack(grid, cfg, torch.cat([rw, fo], -1), scene.n, 0.0)
            return grid, flat.to(scene.dtype), None
        init = 4.0 * scene.meta.spacing0
        if ni_max:
            # B5 writes its contact rows at the light cull's slots
            rows, cc = culled_lanes(scene, dfT, pt, cfg, ni_max)
            fo, cout = forces_contact(dfT, nbr, kernel, cutoff, fluid_alpha,
                                      c0, S, init, rows=rows)
            out = unpack(grid, cfg, torch.cat([rw, fo], -1), scene.n,
                         0.0).to(scene.dtype)
            return grid, out, cc._replace(out=cout)
        # B5 writes its contact columns by particle, as the tail reads them
        fo, cp = forces_contact(dfT, nbr, kernel, cutoff, fluid_alpha, c0, S,
                                init, lanes=lane_map(grid, cfg, scene.n))
        out = unpack(grid, cfg, torch.cat([rw, fo], -1), scene.n,
                     0.0).to(scene.dtype)
        return grid, out, cp.reshape(scene.n, 12, S).to(scene.dtype)

    def step(scene: Scene, dt: float) -> Scene:
        fl, _, rb, _ = _masks(scene)
        zero = torch.zeros((), dtype=scene.dtype, device=scene.device)

        # kick, then drift the positions (the thermo update rides the pack)
        scene = _kick(scene, dt, fl, True, has_rigid)
        scene = scene.replace(
            x=torch.where(fl, scene.x + dt * scene.u, scene.x),
            y=torch.where(fl, scene.y + dt * scene.v, scene.y),
            z=torch.where(fl, scene.z + dt * scene.w, scene.z))
        if has_rigid:
            scene = _particles_from_body_position(
                _body_drift(scene, dt, two_d=False))

        grid, out, cp = eval_passes(scene, dt)
        arho = torch.where(fl, out[:, 0], zero)
        ap = torch.where(fl, out[:, 1], zero)
        rho_new = scene.rho + dt * arho
        upd = dict(arho=arho, ap=ap,
                   rho=torch.where(fl, rho_new, scene.rho),
                   vol=torch.where(fl, scene.m / rho_new, scene.vol))
        if edac:
            upd["p"] = torch.where(fl, scene.p + dt * ap, scene.p)
        else:
            upd["p"], upd["cs"] = tait_eos(scene.replace(rho=upd["rho"]),
                                           rho0, c0, gamma, fl)
        scene = _apply_wall_forces(scene.replace(**upd), out[:, 2:7],
                                   out[:, 7:], gvec)
        ovf = scene.nbr_overflow | grid.overflow
        if has_rigid:
            extra = tuple(torch.where(rb, out[:, c], zero)
                          for c in (10, 11, 12))
            if ni_max:
                flat = cp.out.reshape(-1, cp.out.shape[-1]).to(scene.dtype)
                scene = _compact_contact_tail(
                    scene, flat, cp.pid, cp.u, cp.v, cp.w, params=params,
                    dt=dt, extra_fx=extra)
                scene = scene.with_fields(n_interesting=cp.n_interesting)
                ovf = ovf | cp.overflow
            else:
                scene = _contact_tail(scene, cp, params, dt, extra)
        scene = scene.replace(nbr_overflow=ovf)
        return _kick(scene, dt, fl, True, has_rigid)

    return step


def _split_passes(kernel, cfg, params: dict, fluid_alpha: float, c0: float,
                  has_fluid: bool, has_rigid: bool, plain: bool):
    """The forces evaluation that the kdk and reference orderings share,
    on one grid and its pack ``dfT`` (:func:`_pack`) holding the current
    state: the wall sums (B6b), the wall and body pressures patched into
    the pack, the forces (B6c), then the contact on every slot (K2) on
    the contact pack laid out from the coupling pack (with no fluid,
    ``dfT`` is the contact pack).  Returns ``forces(scene, grid, dfT,
    dt) -> scene`` with the wall, force and contact updates applied."""
    gvec = (params["gx"], params["gy"], params["gz"])
    NC = cfg.NC_max
    cutoff = cfg.radius

    def evaluate(scene, grid, dfT, dt):
        wall = fk.wall_bc_reference if plain else fk.wall_bc
        forces = fk.fluid_forces_reference if plain else fk.fluid_forces
        n, S = scene.n, scene.meta.total_no_bodies
        nbr = grid.nbr_slots
        extra = None
        if has_fluid:
            wb = wall(dfT, nbr, kernel, cutoff, gvec)         # [NC, M, 5]
            _, _, sb, _, rg = fk.decode_flags(dfT[:NC, fk.FFLAGS])
            pbc, _ = _wall_pressure(wb[..., 3], wb[..., 4])
            dfT[:NC, fk.FP] = torch.where(sb == 1.0, torch.clamp(pbc, min=0.0),
                                          dfT[:NC, fk.FP])
            dfT[:NC, fk.FPFSI] = torch.where(rg == 1.0, pbc,
                                             dfT[:NC, fk.FPFSI])
            fo = forces(dfT, nbr, kernel, cutoff, fluid_alpha, c0,
                        has_rigid)                             # [NC, M, 6]
            out = unpack(grid, cfg, torch.cat([wb, fo], -1), n,
                         0.0).to(scene.dtype)
            scene = _apply_wall_forces(scene, out[:, :5], out[:, 5:], gvec)
            rb = scene.is_rigid & scene.active
            zero = torch.zeros((), dtype=scene.dtype, device=scene.device)
            extra = tuple(torch.where(rb, out[:, c], zero)
                          for c in (8, 9, 10))
        if has_rigid:
            cdfT = (tck.contact_pack(dfT, fk.UNION_LAYOUT, cfg.dim == 2)
                    if has_fluid else dfT)
            cp = tck.contact_pipeline_cell(
                cdfT, grid, cfg, kernel, S, 4.0 * scene.meta.spacing0, n,
                plain).to(scene.dtype)
            scene = _contact_tail(scene, cp, params, dt, extra)
        return scene

    return evaluate


def _pack(scene, cfg, has_fluid: bool, plain: bool):
    """(grid, pack) of the forces evaluation: the coupling pack, or with
    no fluid the contact pack itself; one K1 launch either way."""
    if has_fluid:
        grid, _, dfT = fk.pack_fluid_sorted(scene, cfg, plain)
    else:
        grid, _, dfT = tck.pack_scene(scene, cfg, plain, want_dense_pos=True)
    return grid, dfT


def _rates(scene, grid, dfT, kernel, cfg, nu_edac, c0, edac, has_rigid,
           plain):
    """B6a on the pack ``dfT`` -> the scene with arho, ap on the fluid."""
    rates = fk.fluid_rates_reference if plain else fk.fluid_rates
    r = unpack(grid, cfg, rates(dfT, grid.nbr_slots, kernel, cfg.radius,
                                nu_edac, c0, edac, has_rigid),
               scene.n, 0.0).to(scene.dtype)
    fl = scene.is_fluid & scene.active
    zero = torch.zeros((), dtype=scene.dtype, device=scene.device)
    return scene.replace(arho=torch.where(fl, r[:, 0], zero),
                         ap=torch.where(fl, r[:, 1], zero))


def build_coupling_kdk_step(kernel, cfg, params: dict, edac: bool,
                            nu_edac: float, c0: float, rho0: float,
                            gamma: float, fluid_alpha: float,
                            has_fluid: bool, has_rigid: bool,
                            plain: bool = False):
    """One kdk timestep (see the module docstring): the rates on a grid at
    x_n, the wall sums, forces and contact on a grid at x_n+1."""
    evaluate = _split_passes(kernel, cfg, params, fluid_alpha, c0,
                             has_fluid, has_rigid, plain)

    def step(scene: Scene, dt: float) -> Scene:
        fl = _masks(scene)[0]
        scene = _kick(scene, dt, fl, has_fluid, has_rigid)
        ovf = scene.nbr_overflow
        if has_fluid:
            grid, _, dfT = fk.pack_fluid_sorted(scene, cfg, plain)
            ovf = ovf | grid.overflow
            scene = _rates(scene, grid, dfT, kernel, cfg, nu_edac, c0, edac,
                           has_rigid, plain)
        scene = _drift(scene, dt, fl, edac, has_fluid, has_rigid)
        if has_fluid and not edac:
            p, cs = tait_eos(scene, rho0, c0, gamma, fl)
            scene = scene.replace(p=p, cs=cs)
        grid, dfT = _pack(scene, cfg, has_fluid, plain)
        scene = evaluate(scene, grid, dfT, dt)
        scene = scene.replace(nbr_overflow=ovf | grid.overflow)
        return _kick(scene, dt, fl, has_fluid, has_rigid)

    return step


def build_coupling_reference_step(kernel, cfg, params: dict, edac: bool,
                                  nu_edac: float, c0: float, rho0: float,
                                  gamma: float, fluid_alpha: float,
                                  has_fluid: bool, has_rigid: bool,
                                  plain: bool = False):
    """One step in the reference's staging (see the module docstring): one
    grid at x_n; the rates on the pre-kick velocities, the rest after the
    kick, then the drift and the second kick."""
    evaluate = _split_passes(kernel, cfg, params, fluid_alpha, c0,
                             has_fluid, has_rigid, plain)

    def step(scene: Scene, dt: float) -> Scene:
        fl = _masks(scene)[0]
        if has_fluid:
            grid, dfT = _pack(scene, cfg, True, plain)
            scene = _rates(scene, grid, dfT, kernel, cfg, nu_edac, c0, edac,
                           has_rigid, plain)
        scene = _kick(scene, dt, fl, has_fluid, has_rigid)
        if has_fluid:
            if not edac:
                p, cs = tait_eos(scene, rho0, c0, gamma, fl)
                scene = scene.replace(p=p, cs=cs)
            # the kick and the equation of state, in the pack's lanes
            fk.patch_columns(dfT, grid.dense_pos, {
                fk.FU: scene.u, fk.FV: scene.v, fk.FW: scene.w,
                fk.FP: scene.p})
        else:
            # the positions are still x_n: the contact pack of the kicked
            # state is the x_n pack with the kicked velocities
            grid, dfT = _pack(scene, cfg, False, plain)
        scene = evaluate(scene, grid, dfT, dt)
        scene = scene.replace(nbr_overflow=scene.nbr_overflow
                              | grid.overflow)
        scene = _drift(scene, dt, fl, edac, has_fluid, has_rigid)
        return _kick(scene, dt, fl, has_fluid, has_rigid)

    return step


def build_coupling_rk2_step(kernel, cfg, params: dict, nu_edac: float,
                            c0: float, rho0: float, gamma: float,
                            fluid_alpha: float, has_fluid: bool,
                            has_rigid: bool, plain: bool = False):
    """One RK2 timestep (see the module docstring), Tait only: two
    evaluations a step, each the kdk ordering's passes on one grid."""
    passes = _split_passes(kernel, cfg, params, fluid_alpha, c0, has_fluid,
                           has_rigid, plain)

    def evaluate(scene, dt, fl):
        """Tait, rates, wall sums, forces and contact at the current
        state -> (scene, the grid's overflow)."""
        if has_fluid:
            p, cs = tait_eos(scene, rho0, c0, gamma, fl)
            scene = scene.replace(p=p, cs=cs)
        grid, dfT = _pack(scene, cfg, has_fluid, plain)
        if has_fluid:
            # the Tait rates: arho only (the reference step has no ap)
            scene = scene.replace(arho=_rates(
                scene, grid, dfT, kernel, cfg, nu_edac, c0, False,
                has_rigid, plain).arho)
        return passes(scene, grid, dfT, dt), grid.overflow

    def stage(scene, frac_dt, fl):
        """The fluid from the saved state (x with the current velocity,
        then the velocity and density with the current rates) and the
        RK2 body stage."""
        if has_fluid:
            rho_new = scene.rho0_rk + frac_dt * scene.arho
            scene = scene.replace(
                x=torch.where(fl, scene.x0 + frac_dt * scene.u, scene.x),
                y=torch.where(fl, scene.y0 + frac_dt * scene.v, scene.y),
                z=torch.where(fl, scene.z0 + frac_dt * scene.w, scene.z),
                u=torch.where(fl, scene.u0 + frac_dt * scene.au, scene.u),
                v=torch.where(fl, scene.v0 + frac_dt * scene.av, scene.v),
                w=torch.where(fl, scene.w0 + frac_dt * scene.aw, scene.w),
                rho=torch.where(fl, rho_new, scene.rho),
                vol=torch.where(fl, scene.m / rho_new, scene.vol))
        if has_rigid:
            scene = _particles_from_body_velocity(
                _particles_from_body_position(
                    _rk2_body_stage(scene, frac_dt, two_d=False)))
        return scene

    def step(scene: Scene, dt: float) -> Scene:
        fl = _masks(scene)[0]
        save = {}
        if has_fluid:
            save.update(x0=scene.x, y0=scene.y, z0=scene.z, u0=scene.u,
                        v0=scene.v, w0=scene.w, rho0_rk=scene.rho)
        if has_rigid:
            save.update(xcm0=scene.xcm, vcm0=scene.vcm,
                        ang_mom0=scene.ang_mom, omega0=scene.omega,
                        R0=scene.R)
        scene = scene.replace(**save)
        scene, ovf1 = evaluate(scene, dt, fl)
        scene = stage(scene, 0.5 * dt, fl)
        scene, ovf2 = evaluate(scene, dt, fl)
        scene = stage(scene, dt, fl)
        return scene.replace(nbr_overflow=scene.nbr_overflow | ovf1 | ovf2)

    return step


def build_coupling_nklist_step(kernel, cfg: nbmod.NeighborConfig,
                               params: dict, ordering: str, edac: bool,
                               nu_edac: float, c0: float, rho0: float,
                               gamma: float, fluid_alpha: float,
                               has_fluid: bool, has_rigid: bool):
    """One step of the kdk or reference ordering on the neighbour-list
    engine (see the module docstring)."""
    gx, gy, gz = params["gx"], params["gy"], params["gz"]

    def build(scene):
        return nbmod.build_neighbors(scene.x, scene.y, scene.z,
                                     scene.active, cfg)

    def rates(scene, nbrs, fl, rb, fl_bd):
        """(arho, ap) of the continuity and EDAC passes."""
        arho = fops.continuity(scene, nbrs, kernel, fl, fl_bd)
        ap = (fops.edac(scene, nbrs, kernel, nu_edac, c0, fl, fl_bd)
              if edac else torch.zeros_like(arho))
        if has_rigid:
            arho = arho + fops.continuity(scene, nbrs, kernel, fl, rb,
                                          fsi=True)
            if edac:
                ap = ap + fops.edac(scene, nbrs, kernel, nu_edac, c0, fl, rb,
                                    fsi=True)
        return arho, ap

    def wall(scene, nbrs, dest, fl, clamp, p_name):
        """The Adami velocity and pressure of the ``dest`` rows."""
        uf, vf, wf, ug, vg, wg, sw = fops.set_wall_velocity(
            scene, nbrs, kernel, dest, fl)
        p = fops.solid_wall_pressure_bc(scene, nbrs, kernel, gx, gy, gz,
                                        dest, fl, sw, clamp=clamp)
        upd = dict(uf=uf, vf=vf, wf=wf, ug=ug, vg=vg, wg=wg, wij_adami=sw)
        upd[p_name] = p
        return scene.replace(**{k: torch.where(dest, v, scene[k])
                                for k, v in upd.items()})

    def fluid_stage2(scene, nbrs, fl, bd, rb, fl_bd):
        """The wall and body conditions and the fluid momentum."""
        if not edac:
            p, cs = tait_eos(scene, rho0, c0, gamma, fl)
            scene = scene.replace(p=p, cs=cs)
        scene = wall(scene, nbrs, bd, fl, True, "p")
        if has_rigid:
            scene = wall(scene, nbrs, rb, fl, False, "p_fsi")
        aux, auy, auz = fops.momentum_pressure_gradient(scene, nbrs, kernel,
                                                        fl, fl_bd)
        if abs(fluid_alpha) > 1e-14:
            vx, vy, vz = fops.momentum_artificial_viscosity(
                scene, nbrs, kernel, fluid_alpha, c0, fl, fl)
            aux, auy, auz = aux + vx, auy + vy, auz + vz
        if has_rigid:
            rx, ry, rz = fops.force_on_fluid_due_to_rigid_body(
                scene, nbrs, kernel, fl, rb)
            aux, auy, auz = aux + rx, auy + ry, auz + rz
        zero = torch.zeros((), dtype=scene.dtype, device=scene.device)
        return scene.replace(au=torch.where(fl, gx + aux, zero),
                             av=torch.where(fl, gy + auy, zero),
                             aw=torch.where(fl, gz + auz, zero))

    def forces(scene, nbrs, dt, fl, bd, rb, fl_bd):
        """Stage 2: the fluid's, then the bodies' with the fluid ->
        rigid force."""
        if has_fluid:
            scene = fluid_stage2(scene, nbrs, fl, bd, rb, fl_bd)
        if has_rigid:
            extra = None
            if has_fluid:
                def extra(sc, nb):
                    return fops.force_on_rigid_body_due_to_fluid(
                        sc, nb, kernel, rb, fl)
            scene = rigid_contact_force_eval(scene, nbrs, kernel, params, dt,
                                             extra_force=extra)
        return scene

    def step_kdk(scene: Scene, dt: float) -> Scene:
        fl, bd, rb, _ = _masks(scene)
        fl_bd = fl | bd
        zero = torch.zeros((), dtype=scene.dtype, device=scene.device)
        scene = _kick(scene, dt, fl, has_fluid, has_rigid)
        ovf = scene.nbr_overflow
        if has_fluid:
            nbrs = build(scene)
            ovf = ovf | nbrs.overflow
            arho, ap = rates(scene, nbrs, fl, rb, fl_bd)
            scene = scene.replace(arho=torch.where(fl, arho, zero),
                                  ap=torch.where(fl, ap, zero))
        scene = _drift(scene, dt, fl, edac, has_fluid, has_rigid)
        nbrs = build(scene)
        ovf = ovf | nbrs.overflow
        scene = forces(scene, nbrs, dt, fl, bd, rb, fl_bd)
        scene = scene.replace(nbr_overflow=ovf)
        return _kick(scene, dt, fl, has_fluid, has_rigid)

    def step_reference(scene: Scene, dt: float) -> Scene:
        fl, bd, rb, _ = _masks(scene)
        fl_bd = fl | bd
        nbrs = build(scene)
        if has_fluid:
            arho, ap = rates(scene, nbrs, fl, rb, fl_bd)
            scene = scene.replace(arho=arho, ap=ap)
        scene = _kick(scene, dt, fl, has_fluid, has_rigid)
        scene = forces(scene, nbrs, dt, fl, bd, rb, fl_bd)
        scene = scene.replace(nbr_overflow=scene.nbr_overflow
                              | nbrs.overflow)
        scene = _drift(scene, dt, fl, edac, has_fluid, has_rigid)
        return _kick(scene, dt, fl, has_fluid, has_rigid)

    return step_kdk if ordering == "kdk" else step_reference
