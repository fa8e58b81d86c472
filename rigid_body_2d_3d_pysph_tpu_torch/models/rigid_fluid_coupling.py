"""Rigid-fluid coupling scheme: WCSPH (EDAC or Tait) fluid, Adami wall
conditions, two-way FSI and the Mofidi rigid contact, in the fused
kick-drift-kick step (the "kdkf" GTVF ordering).

Counterpart of ``RigidFluidCouplingScheme`` in
``rigid_body_2d_3d_pysph_tpu/models/rigid_fluid_coupling.py``, the
branch of ``_make_step_cell_kdkf`` (:421-746) that the JAX package runs
off the TPU: one grid build and one 14-field pack per step, three pair
passes on that pack with the thermo updates patched into its columns
between them, one unpack, and the contact tail on the full ``[N, S]``
slot schema (``_contact_force_tail``).  One step:

    kick -> drift -> build + pack (K1) -> rates + wall sums (B4) ->
    patch rho (and p: EDAC or Tait) -> patch the wall and body
    pressures p, p_fsi -> forces + contact (B5; B6c without bodies) ->
    one unpack -> thermo, wall and force updates -> contact tail with
    the fluid -> rigid force -> kick

Bodies are integrated in 3D (``two_d=False``) even in 2D scenes, as the
reference does.  Not ported: the kdk and reference orderings, the RK2
fluid stepper and the compact contact tail at S >= 8 (ROADMAP A8).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cellpairs as cellmod
from ..ops import fluid_kernel as fk
from ..ops.cellpairs import unpack
from ..ops.fluid import tait_eos
from ..ops.kernels import get_kernel
from ..state import rigid_setup
from ..state.scene import Scene
from .base import Scheme
from .rigid_body import (
    _attach_contact_fields,
    _body_drift,
    _body_half_kick,
    _contact_force_tail,
    _particles_from_body_position,
    _particles_from_body_velocity,
    run_boundary_identification_cell,
)

# per-particle fields the scheme attaches (the reference also attaches
# the RK2 stepper's saved state, which the port does not carry)
FLUID_FIELDS = ("rho_fsi", "m_fsi", "p_fsi", "wij_adami", "uf", "vf", "wf",
                "ug", "vg", "wg", "arho", "ap", "au", "av", "aw", "vol",
                "cs")


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
        self.fluid_stepper = "gtvf"
        self._cell_cfg = None

    @property
    def edac_nu(self):
        """nu_edac = alpha h c0 / 8."""
        return self.fluid_alpha * self.h * self.c0 / 8.0

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
            scene = run_boundary_identification_cell(
                scene, kernel, self.cell_config(scene, kernel),
                self.rigid_bodies + self.boundaries)
            scene = scene.replace(
                contact_force_is_boundary=scene.is_boundary.to(fdt))
        return scene

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
        """The fused kdkf step as an eager ``step(scene, dt) -> scene``.
        ``plain=True`` runs the kernels' plain versions even on CUDA
        tensors (the kernel step's reference on the card)."""
        if self.fluid_stepper != "gtvf":
            raise NotImplementedError(
                f"fluid_stepper={self.fluid_stepper!r}: the RK2 fluid "
                "stepper is not ported (ROADMAP A8)")
        if self.gtvf_ordering != "kdkf" or not self.fluids:
            raise NotImplementedError(
                f"gtvf_ordering={self.gtvf_ordering!r} with "
                f"{len(self.fluids)} fluid group(s): only the fused kdkf "
                "step with fluid is ported (the kdk and reference "
                "orderings, ROADMAP A8 / B6)")
        kernel = get_kernel(self.kernel_name, self.dim)
        return build_coupling_kdkf_step(
            kernel, self.cell_config(scene, kernel),
            dict(kr=self.kr, kf=self.kf, fric_coeff=self.fric_coeff,
                 gx=self.gx, gy=self.gy, gz=self.gz),
            edac=self.edac, nu_edac=self.edac_nu, c0=self.c0,
            rho0=self.rho0, gamma=self.gamma, fluid_alpha=self.fluid_alpha,
            has_rigid=len(self.rigid_bodies) > 0, plain=plain)


def build_coupling_kdkf_step(kernel, cfg, params: dict, edac: bool,
                             nu_edac: float, c0: float, rho0: float,
                             gamma: float, fluid_alpha: float,
                             has_rigid: bool, plain: bool = False):
    """One fused kdkf timestep (see the module docstring)."""
    gvec = (params["gx"], params["gy"], params["gz"])
    NC = cfg.NC_max
    cutoff = cfg.radius

    def eval_passes(scene, dt):
        """Build, pack and the pair passes with the dense column patches
        between them -> (grid, [N, 13] = arho, ap, uf, vf, wf, sw, p_num,
        au, av, aw, fx, fy, fz, contact columns [N, 12, S] or None)."""
        if plain:
            rates_wall = fk.fluid_rates_wall_reference
            forces = fk.fluid_forces_reference
            forces_contact = fk.fluid_forces_contact_reference
        else:
            rates_wall, forces = fk.fluid_rates_wall, fk.fluid_forces
            forces_contact = fk.fluid_forces_contact
        S = scene.meta.total_no_bodies
        grid, _, dfT = fk.pack_fluid_sorted(scene, cfg, plain)
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
        sw = rw[..., 5]
        has = sw > 1e-14
        pbc = torch.where(has, rw[..., 6] / torch.where(has, sw, 1.0),
                          rw[..., 6])
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
        fc = forces_contact(dfT, nbr, kernel, cutoff, fluid_alpha, c0, S,
                            4.0 * scene.meta.spacing0)    # [NC, M, 12S + 6]
        flat = unpack(grid, cfg, torch.cat([rw, fc], -1), scene.n,
                      0.0).to(scene.dtype)
        out = torch.cat([flat[:, :7], flat[:, 7 + 12 * S:]], 1)
        return grid, out, flat[:, 7:7 + 12 * S].reshape(scene.n, 12, S)

    def step(scene: Scene, dt: float) -> Scene:
        fl = scene.is_fluid & scene.active
        bd = scene.is_static_boundary & scene.active
        rb = scene.is_rigid & scene.active
        solid = bd | rb
        zero = torch.zeros((), dtype=scene.dtype, device=scene.device)

        def kick(s):
            s = s.replace(u=torch.where(fl, s.u + 0.5 * dt * s.au, s.u),
                          v=torch.where(fl, s.v + 0.5 * dt * s.av, s.v),
                          w=torch.where(fl, s.w + 0.5 * dt * s.aw, s.w))
            if has_rigid:
                s = _particles_from_body_velocity(
                    _body_half_kick(s, dt, two_d=False))
            return s

        # kick, then drift the positions (the thermo update rides the pack)
        scene = kick(scene)
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
        scene = scene.replace(**upd)

        sw = out[:, 5]
        has = sw > 1e-14
        p_bc = torch.where(has, out[:, 6] / torch.where(has, sw, 1.0),
                           out[:, 6])
        inv = torch.where(has, 1.0 / torch.clamp(sw, min=1e-300), zero)
        ufn, vfn, wfn = out[:, 2] * inv, out[:, 3] * inv, out[:, 4] * inv
        scene = scene.replace(
            p=torch.where(bd, torch.clamp(p_bc, min=0.0), scene.p),
            p_fsi=torch.where(rb, p_bc, scene.p_fsi),
            uf=torch.where(solid, ufn, scene.uf),
            vf=torch.where(solid, vfn, scene.vf),
            wf=torch.where(solid, wfn, scene.wf),
            ug=torch.where(solid, 2.0 * scene.u - ufn, scene.ug),
            vg=torch.where(solid, 2.0 * scene.v - vfn, scene.vg),
            wg=torch.where(solid, 2.0 * scene.w - wfn, scene.wg),
            wij_adami=torch.where(solid, sw, scene.wij_adami),
            au=torch.where(fl, params["gx"] + out[:, 7], zero),
            av=torch.where(fl, params["gy"] + out[:, 8], zero),
            aw=torch.where(fl, params["gz"] + out[:, 9], zero))
        if has_rigid:
            extra = tuple(torch.where(rb, out[:, c], zero)
                          for c in (10, 11, 12))
            dinfo = dict(
                contact_force_dist=cp[:, 4],
                closest_point_dist_to_source=cp[:, 5],
                x_source=cp[:, 6], y_source=cp[:, 7], z_source=cp[:, 8],
                vx_source=cp[:, 9], vy_source=cp[:, 10],
                vz_source=cp[:, 11])
            scene = _contact_force_tail(scene, cp[:, 0], cp[:, 1], cp[:, 2],
                                        cp[:, 3], dinfo, params, dt,
                                        extra_fx=extra)
        scene = scene.replace(nbr_overflow=scene.nbr_overflow
                              | grid.overflow)
        return kick(scene)

    return step
