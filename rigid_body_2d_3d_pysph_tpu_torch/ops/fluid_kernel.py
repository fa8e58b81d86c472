"""The coupling scheme's fluid pair passes on the spill cell grid.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/pallas_fluid.py``: the
14-field coupling pack, its sentinels and flags word, the sorted pack
build (grid build + pack expansion K1 with F = 14), and the pair passes
of the coupling steps, each with its plain PyTorch twin.  The fused kdkf
step runs

* :func:`fluid_rates_wall` (B4): per query lane, continuity ``arho`` and
  EDAC ``ap`` for fluid queries and the Adami Shepard sums
  (uf, vf, wf, sw, p_num) for wall and body queries -> ``[NC, M, 7]``;
* :func:`fluid_forces_contact` (B5): (au, av, aw, fx, fy, fz) ->
  ``[NC, M, 6]``, and the Mofidi contact columns of K2 in K2's order (the
  union layout: 3D geometry, V = m / rho, the contact gate's boundary bit
  is ``contact_force_is_boundary``) in the layout the step reads: by
  query row at the light cull's slots, ``[NI, M, 12 S]`` (the compact
  route), or by particle, ``[n, 12 S]`` (the full route);

and the kdk and reference orderings run the split passes

* :func:`fluid_rates` (B6a): ``arho`` and ``ap`` alone -> ``[NC, M, 2]``;
* :func:`wall_bc` (B6b): the Adami sums alone -> ``[NC, M, 5]``;
* :func:`fluid_forces` (B6c): the 6 force columns, with or without the
  FSI terms of rigid bodies -> ``[NC, M, 6]`` (the kdkf step's pass
  too when there is no rigid body).

Each wrapper runs its twin for CPU tensors and ``csrc/fluid.cu`` for
CUDA tensors (float32), in the library of the pass's SPH kernel (any of
the six of ``ops/kernels.py``); it raises on any other device.  The pack is
``dfT [NC + 1, 14, M]``: query slot s is row s, a stencil entry NC (no
neighbour) reads the all-sentinel row NC.  Unlike the TPU kernels, every
row's output is written (sentinel lanes hold zeros and the contact init
row), and nothing is padded to 128 columns.

With rigid bodies, B4, B5 and B6c sum the fluid/boundary and the
FSI-rigid source classes in one term over per-lane selected (m, rho, p),
as the TPU kernels do (``pallas_fluid.py:423-433, 519-531``); B6a sums
the two classes apart and adds the sums (``:348-351``).
"""

from __future__ import annotations

import torch

from . import _build
from .cellpairs import CellGridConfig, build_cell_grid_packed
from .cellpairs import LaneMap
from .contact_kernel import PackLayout, contact_sums_reference
from .ieee import sqrt
from .kernels import Kernel
from .pack_expand import expand_slots, expand_slots_reference

_BIG = 1.0e9
_MAX_PAIR_ELEMS = 1 << 22   # pair lanes per chunk of the plain versions

# Field rows of the coupling pack.  The flags word is dem*16 + cfib*8 +
# static_boundary*4 + fluid*2 + rigid (cfib = contact_force_is_boundary),
# exact for dem < 2^19; the sentinel -16 decodes to dem -1, all bits 0.
(FX, FY, FZ, FU, FV, FW, FM, FRHO, FH, FP,
 FMFSI, FRHOFSI, FPFSI, FFLAGS) = range(14)
NF = 14
SENT = [_BIG, _BIG, _BIG, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0,
        0.0, 1.0, 0.0, -16.0]


def decode_flags(f):
    """flags -> (dem, cfib, static_boundary, fluid, rigid) as floats."""
    dem = torch.floor(f * (1.0 / 16.0))
    r = f - 16.0 * dem
    cfib = torch.floor(r * 0.125)
    r = r - 8.0 * cfib
    sbdry = torch.floor(r * 0.25)
    r = r - 4.0 * sbdry
    fluid = torch.floor(r * 0.5)
    rigid = r - 2.0 * fluid
    return dem, cfib, sbdry, fluid, rigid


def _decode_contact(f):
    dem, cfib, _, fluid, rigid = decode_flags(f)
    return dem, cfib, fluid, rigid


# the coupling pack read by the contact pass (pallas_contact._pair_body
# with union=True, two_d=False)
UNION_LAYOUT = PackLayout(
    dict(x=FX, y=FY, z=FZ, u=FU, v=FV, w=FW, m=FM, rho=FRHO, h=FH,
         flags=FFLAGS), _decode_contact, False)


def fluid_flags(scene):
    """The packed per-particle flags field."""
    fdt = scene.dtype
    return (scene.dem_id.to(fdt) * 16.0
            + scene.contact_force_is_boundary * 8.0
            + scene.is_static_boundary.to(fdt) * 4.0
            + scene.is_fluid.to(fdt) * 2.0
            + scene.is_rigid.to(fdt))


def fluid_payload(scene):
    return [scene.x, scene.y, scene.z, scene.u, scene.v, scene.w,
            scene.m, scene.rho, scene.h, scene.p,
            scene.m_fsi, scene.rho_fsi, scene.p_fsi, fluid_flags(scene)]


def pack_fluid_sorted(scene, cfg: CellGridConfig, plain: bool = False):
    """Grid build with the 14 fields riding the cell sort, then pack
    expansion: ``(grid, pack tables, dfT [NC + 1, 14, M])``; the grid
    keeps ``dense_pos`` for the step's one unpack.  ``plain`` runs the
    expansion's plain version even on CUDA tensors."""
    grid, pt = build_cell_grid_packed(scene.x, scene.y, scene.z,
                                      scene.active, cfg,
                                      fluid_payload(scene),
                                      want_dense_pos=True)
    sent = torch.tensor(SENT, dtype=scene.dtype, device=scene.device)
    expand = expand_slots_reference if plain else expand_slots
    return grid, pt, expand(pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)


def patch_columns(dfT, dense_pos, values: dict):
    """Write per-particle ``values`` ({pack row: [N] tensor}) into their
    lanes of the pack ``dfT [NC + 1, 14, M]`` in place.  A particle
    without a lane (``dense_pos == NC M``) writes the row's sentinel
    into the all-sentinel row NC, which leaves it unchanged."""
    NC1, F, M = dfT.shape
    has = dense_pos < (NC1 - 1) * M
    base = (dense_pos // M) * (F * M) + dense_pos % M
    rows = list(values)
    idx = torch.stack([base + r * M for r in rows])
    vals = torch.stack([torch.where(has, values[r].to(dfT.dtype),
                                    torch.full_like(dfT[0, 0, :1], SENT[r]))
                        for r in rows])
    dfT.view(-1)[idx.reshape(-1)] = vals.reshape(-1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _over_slots(dfT, nbr, width, body):
    """``body(q [B, F, M], src [B, F, O M]) -> [B, M, width]`` over all
    NC query slots in chunks of at most ``_MAX_PAIR_ELEMS`` pair lanes."""
    NC, O = nbr.shape
    F, M = dfT.shape[1], dfT.shape[2]
    chunk = max(1, _MAX_PAIR_ELEMS // (M * O * M))
    outs = []
    for c0 in range(0, NC, chunk):
        nb = nbr[c0:c0 + chunk]
        B = nb.shape[0]
        src = dfT[nb].permute(0, 2, 1, 3).reshape(B, F, O * M)
        outs.append(body(dfT[c0:c0 + B], src))
    if not outs:
        return torch.zeros((0, M, width), dtype=dfT.dtype, device=dfT.device)
    return torch.cat(outs, 0)


def _pair_geom(q, src, kernel: Kernel):
    def qc(f):
        return q[:, f, :, None]                       # [B, M, 1]

    def sr(f):
        return src[:, f, None, :]                     # [B, 1, OM]

    xij = qc(FX) - sr(FX)
    yij = qc(FY) - sr(FY)
    zij = qc(FZ) - sr(FZ)
    r2 = xij * xij + yij * yij + zij * zij
    rij = sqrt(r2)
    hij = 0.5 * (qc(FH) + sr(FH))
    return qc, sr, xij, yij, zij, rij, r2, hij


def fluid_rates_wall_reference(dfT, nbr, kernel: Kernel,
                               cutoff: float, nu_edac: float, c0: float,
                               edac: bool, has_rigid: bool, g):
    """Plain version of B4 (``pallas_fluid.py:389-448``): ``[NC, M, 7]``
    = (arho, ap, uf, vf, wf, sw, p_num).  The wall sums read the source
    p and rho as packed, before the step's thermo update."""
    cs2 = c0 * c0
    gx, gy, gz = g

    def body(q, src):
        qc, sr, xij, yij, zij, rij, r2, hij = _pair_geom(q, src, kernel)
        in_range = rij <= cutoff
        _, _, q_sb, q_fl, q_rg = decode_flags(qc(FFLAGS))
        _, _, s_sb, s_fl, s_rg = decode_flags(sr(FFLAGS))
        dest_fluid = q_fl == 1.0
        src_fluid = s_fl == 1.0
        src_flbd = src_fluid | (s_sb == 1.0)
        src_rigid = s_rg == 1.0
        zero = torch.zeros_like(rij)

        w_all, dw = kernel.w_gradw(rij, hij)
        dwx, dwy, dwz = dw * xij, dw * yij, dw * zij
        vdotdw = ((qc(FU) - sr(FU)) * dwx + (qc(FV) - sr(FV)) * dwy
                  + (qc(FW) - sr(FW)) * dwz)
        rhoi, pi, mi = qc(FRHO), qc(FP), qc(FM)
        if has_rigid:
            mj = torch.where(src_rigid, sr(FMFSI), sr(FM))
            rhoj = torch.where(src_rigid, sr(FRHOFSI), sr(FRHO))
            pj = torch.where(src_rigid, sr(FPFSI), sr(FP))
            gate = src_flbd | src_rigid
        else:
            mj, rhoj, pj, gate = sr(FM), sr(FRHO), sr(FP), src_flbd
        g_r = gate & dest_fluid & in_range
        arho = torch.where(g_r, rhoi * mj / rhoj * vdotdw, zero).sum(-1)
        if edac:
            xdotdw = xij * dwx + yij * dwy + zij * dwz
            eps = 0.01 * hij * hij
            ap1 = rhoi / rhoj * cs2 * mj * vdotdw
            Vi = mi / rhoi
            Vj = mj / rhoj
            etaij = 2.0 * nu_edac * (rhoi * rhoj) / (rhoi + rhoj)
            tmp = (1.0 / torch.clamp(mi, min=1e-30)) * (Vi * Vi + Vj * Vj) \
                * etaij * xdotdw / (r2 + eps)
            ap = torch.where(g_r, ap1 + tmp * (pi - pj), zero).sum(-1)
        else:
            ap = torch.zeros_like(arho)

        dest_solid = (q_sb == 1.0) | (q_rg == 1.0)
        w = torch.where(dest_solid & src_fluid & in_range, w_all, zero)
        gdotx = gx * xij + gy * yij + gz * zij
        return torch.stack(
            [arho, ap, (sr(FU) * w).sum(-1), (sr(FV) * w).sum(-1),
             (sr(FW) * w).sum(-1), w.sum(-1),
             ((sr(FP) + sr(FRHO) * gdotx) * w).sum(-1)], -1)

    return _over_slots(dfT, nbr, 7, body)


def fluid_rates_reference(dfT, nbr, kernel: Kernel, cutoff: float,
                          nu_edac: float, c0: float, edac: bool,
                          has_rigid: bool):
    """Plain version of B6a (``pallas_fluid.py:315-352``): ``[NC, M, 2]``
    = (arho, ap) on fluid queries; with rigid bodies the FSI-rigid source
    class (m_fsi, rho_fsi, p_fsi) is summed apart from the fluid/boundary
    class and the two sums are added."""
    cs2 = c0 * c0

    def body(q, src):
        qc, sr, xij, yij, zij, rij, r2, hij = _pair_geom(q, src, kernel)
        in_range = rij <= cutoff
        q_fl = decode_flags(qc(FFLAGS))[3]
        _, _, s_sb, s_fl, s_rg = decode_flags(sr(FFLAGS))
        dest_fluid = q_fl == 1.0
        zero = torch.zeros_like(rij)

        dw = kernel.gradw_scalar(rij, hij)
        dwx, dwy, dwz = dw * xij, dw * yij, dw * zij
        vdotdw = ((qc(FU) - sr(FU)) * dwx + (qc(FV) - sr(FV)) * dwy
                  + (qc(FW) - sr(FW)) * dwz)
        xdotdw = xij * dwx + yij * dwy + zij * dwz
        eps = 0.01 * hij * hij
        rhoi, pi, mi = qc(FRHO), qc(FP), qc(FM)

        def rates(mj, rhoj, pj, gate):
            g = gate & dest_fluid & in_range
            arho = torch.where(g, rhoi * mj / rhoj * vdotdw, zero).sum(-1)
            if not edac:
                return arho, torch.zeros_like(arho)
            ap1 = rhoi / rhoj * cs2 * mj * vdotdw
            Vi = mi / rhoi
            Vj = mj / rhoj
            etaij = 2.0 * nu_edac * (rhoi * rhoj) / (rhoi + rhoj)
            tmp = (1.0 / torch.clamp(mi, min=1e-30)) * (Vi * Vi + Vj * Vj) \
                * etaij * xdotdw / (r2 + eps)
            return arho, torch.where(g, ap1 + tmp * (pi - pj), zero).sum(-1)

        arho, ap = rates(sr(FM), sr(FRHO), sr(FP), (s_fl == 1.0) | (s_sb == 1.0))
        if has_rigid:
            a2, p2 = rates(sr(FMFSI), sr(FRHOFSI), sr(FPFSI), s_rg == 1.0)
            arho, ap = arho + a2, ap + p2
        return torch.stack([arho, ap], -1)

    return _over_slots(dfT, nbr, 2, body)


def wall_bc_reference(dfT, nbr, kernel: Kernel, cutoff: float, g):
    """Plain version of B6b (``pallas_fluid.py:468-482``): ``[NC, M, 5]``
    = (uf, vf, wf, sw, p_num) on wall and body queries over fluid
    sources, the formulas of B4's columns 2-6."""
    gx, gy, gz = g

    def body(q, src):
        qc, sr, xij, yij, zij, rij, r2, hij = _pair_geom(q, src, kernel)
        _, _, q_sb, _, q_rg = decode_flags(qc(FFLAGS))
        s_fl = decode_flags(sr(FFLAGS))[3]
        gate = ((q_sb == 1.0) | (q_rg == 1.0)) & (s_fl == 1.0) \
            & (rij <= cutoff)
        w = torch.where(gate, kernel.w(rij, hij), torch.zeros_like(rij))
        gdotx = gx * xij + gy * yij + gz * zij
        return torch.stack(
            [(sr(FU) * w).sum(-1), (sr(FV) * w).sum(-1),
             (sr(FW) * w).sum(-1), w.sum(-1),
             ((sr(FP) + sr(FRHO) * gdotx) * w).sum(-1)], -1)

    return _over_slots(dfT, nbr, 5, body)


def _forces_reference(dfT, nbr, kernel: Kernel, cutoff: float,
                      fluid_alpha: float, c0: float, has_rigid: bool):
    """The force columns (``pallas_fluid.py:494-559``): ``[NC, M, 6]`` =
    (au, av, aw, fx, fy, fz); reads p and p_fsi after the wall-pressure
    patch."""

    def body(q, src):
        qc, sr, xij, yij, zij, rij, r2, hij = _pair_geom(q, src, kernel)
        in_range = rij <= cutoff
        _, _, _, q_fl, q_rg = decode_flags(qc(FFLAGS))
        _, _, s_sb, s_fl, s_rg = decode_flags(sr(FFLAGS))
        dest_fluid = q_fl == 1.0
        src_fluid = s_fl == 1.0
        src_flbd = src_fluid | (s_sb == 1.0)
        src_rigid = s_rg == 1.0
        zero = torch.zeros_like(rij)

        dw = kernel.gradw_scalar(rij, hij)
        dwx, dwy, dwz = dw * xij, dw * yij, dw * zij
        rhoi, rhoj = qc(FRHO), sr(FRHO)
        pi, pj = qc(FP), sr(FP)
        mj = sr(FM)
        if has_rigid:
            mj_e = torch.where(src_rigid, sr(FMFSI), mj)
            rhoj_e = torch.where(src_rigid, sr(FRHOFSI), rhoj)
            pj_e = torch.where(src_rigid, sr(FPFSI), pj)
            g_pg = dest_fluid & (src_flbd | src_rigid) & in_range
        else:
            mj_e, rhoj_e, pj_e = mj, rhoj, pj
            g_pg = dest_fluid & src_flbd & in_range
        pij = pi / (rhoi * rhoi) + pj_e / (rhoj_e * rhoj_e)
        t = torch.where(g_pg, -mj_e * pij, zero)
        au, av, aw = (t * dwx).sum(-1), (t * dwy).sum(-1), (t * dwz).sum(-1)

        if abs(fluid_alpha) > 1e-14:
            vdotx = ((qc(FU) - sr(FU)) * xij + (qc(FV) - sr(FV)) * yij
                     + (qc(FW) - sr(FW)) * zij)
            eps = 0.01 * hij * hij
            muij = hij * vdotx / (r2 + eps)
            piij = torch.where(
                (vdotx < 0.0) & dest_fluid & src_fluid & in_range,
                -fluid_alpha * c0 * muij * mj * (2.0 / (rhoi + rhoj)), zero)
            au = au + (-piij * dwx).sum(-1)
            av = av + (-piij * dwy).sum(-1)
            aw = aw + (-piij * dwz).sum(-1)

        if has_rigid:
            g_fr = (q_rg == 1.0) & src_fluid & in_range
            t1 = pj / (rhoj * rhoj) + qc(FPFSI) / torch.clamp(
                qc(FRHOFSI) * qc(FRHOFSI), min=1e-30)
            fac = torch.where(g_fr, -qc(FMFSI) * mj * t1, zero)
            fx, fy, fz = ((fac * dwx).sum(-1), (fac * dwy).sum(-1),
                          (fac * dwz).sum(-1))
        else:
            fx = fy = fz = torch.zeros_like(au)
        return torch.stack([au, av, aw, fx, fy, fz], -1)

    return _over_slots(dfT, nbr, 6, body)


def fluid_forces_reference(dfT, nbr, kernel: Kernel, cutoff: float,
                           fluid_alpha: float, c0: float,
                           has_rigid: bool = False):
    """Plain version of B6c: the force columns, with the FSI terms when
    ``has_rigid``."""
    return _forces_reference(dfT, nbr, kernel, cutoff, fluid_alpha, c0,
                             has_rigid)


def fluid_forces_contact_reference(dfT, nbr, kernel: Kernel,
                                   cutoff: float, fluid_alpha: float,
                                   c0: float, S: int, init_dist: float,
                                   rows=None, lanes: LaneMap | None = None):
    """Plain version of B5: ``(forces [NC, M, 6], contact)``, the 6 force
    columns with rigid bodies present and K2's 12 S contact columns on
    the union layout, as :func:`fluid_forces_contact` lays them out."""
    NC = nbr.shape[0]
    forces = _forces_reference(dfT, nbr, kernel, cutoff, fluid_alpha, c0,
                               True)
    if rows is None:
        qslot, nb = torch.arange(NC, dtype=torch.int64, device=dfT.device), nbr
    else:
        # a padding row (NC) queries the all-sentinel row: the init row
        qslot = torch.clamp(rows.to(torch.int64), 0, NC)
        nb = nbr[torch.clamp(qslot, max=NC - 1)]
    contact = contact_sums_reference(dfT, qslot, nb, S, cutoff, init_dist,
                                     kernel, UNION_LAYOUT, lanes)
    return forces, contact


# ---------------------------------------------------------------------------
# kernel wrappers (csrc/fluid.cu for CUDA tensors)
# ---------------------------------------------------------------------------

def _check(name, dfT, nbr):
    """The common shape checks; True when the kernel runs (CUDA: float32,
    int64 stencil rows, M <= 32 lanes a slot, since a slot is one warp's
    work in both templates)."""
    if dfT.dim() != 3 or dfT.shape[1] != NF or nbr.dim() != 2 \
            or dfT.shape[0] != nbr.shape[0] + 1:
        raise ValueError(f"{name}: bad shapes {tuple(dfT.shape)}, "
                         f"{tuple(nbr.shape)} (want [NC + 1, {NF}, M], "
                         "[NC, O])")
    if dfT.device.type == "cpu":
        return False
    if dfT.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dfT.device}")
    if dfT.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32")
    if nbr.dtype != torch.int64:
        raise ValueError(f"{name}: the kernel takes an int64 stencil table")
    if dfT.shape[2] > 32:
        raise ValueError(f"{name}: the kernel takes M <= 32 lanes a slot, "
                         f"got {dfT.shape[2]}")
    return True


def _launch(kname, kernel: Kernel, dfT, nbr, width, ints, floats):
    """``kname`` of ``kernel``'s library on the pack: ``ints`` (the
    entry's int arguments before the SPH kernel's id), the kernel's id,
    ``floats``, then the kernel's sigma constants."""
    NC, O = nbr.shape
    M = dfT.shape[2]
    dfT, nbr = dfT.contiguous(), nbr.contiguous()
    out = torch.empty((NC, M, width), dtype=torch.float32, device=dfT.device)
    fn = _build.load(kname, kernel.name)
    stream = torch.cuda.current_stream(dfT.device).cuda_stream
    sig_num, sig_den = kernel.sigma_constants()
    err = fn(dfT.data_ptr(), nbr.data_ptr(), out.data_ptr(), NC, O, M,
             *ints, kernel.device_id, *(float(f) for f in floats),
             float(sig_num), float(sig_den), stream)
    _build.check(err, kname)
    _build.count(kname, kernel.name)
    return out


def fluid_rates_wall(dfT, nbr, kernel: Kernel, cutoff: float,
                     nu_edac: float, c0: float, edac: bool, has_rigid: bool,
                     g):
    """B4 on the pack ``dfT [NC + 1, 14, M]`` over the stencil rows
    ``nbr [NC, O]`` -> ``[NC, M, 7]``."""
    if not _check("fluid_rates_wall", dfT, nbr):
        return fluid_rates_wall_reference(dfT, nbr, kernel, cutoff, nu_edac,
                                          c0, edac, has_rigid, g)
    return _launch("fluid_rates_wall", kernel, dfT, nbr, 7,
                   (int(kernel.dim == 2), int(edac), int(has_rigid)),
                   (cutoff, 2.0 * nu_edac, c0 * c0, g[0], g[1], g[2]))


def fluid_rates(dfT, nbr, kernel: Kernel, cutoff: float,
                nu_edac: float, c0: float, edac: bool, has_rigid: bool):
    """B6a: continuity and EDAC rates -> ``[NC, M, 2]``."""
    if not _check("fluid_rates", dfT, nbr):
        return fluid_rates_reference(dfT, nbr, kernel, cutoff, nu_edac, c0,
                                     edac, has_rigid)
    return _launch("fluid_rates", kernel, dfT, nbr, 2,
                   (int(kernel.dim == 2), int(edac), int(has_rigid)),
                   (cutoff, 2.0 * nu_edac, c0 * c0))


def wall_bc(dfT, nbr, kernel: Kernel, cutoff: float, g):
    """B6b: the Adami wall sums -> ``[NC, M, 5]``."""
    if not _check("wall_bc", dfT, nbr):
        return wall_bc_reference(dfT, nbr, kernel, cutoff, g)
    return _launch("wall_bc", kernel, dfT, nbr, 5, (int(kernel.dim == 2),),
                   (cutoff, g[0], g[1], g[2]))


def fluid_forces(dfT, nbr, kernel: Kernel, cutoff: float,
                 fluid_alpha: float, c0: float, has_rigid: bool = False):
    """B6c: the 6 force columns -> ``[NC, M, 6]``; ``has_rigid`` adds the
    FSI source class and the fluid -> rigid force."""
    if not _check("fluid_forces", dfT, nbr):
        return fluid_forces_reference(dfT, nbr, kernel, cutoff, fluid_alpha,
                                      c0, has_rigid)
    return _launch("fluid_forces", kernel, dfT, nbr, 6,
                   (int(kernel.dim == 2), int(abs(fluid_alpha) > 1e-14),
                    int(has_rigid)),
                   (cutoff, -fluid_alpha * c0))


def fluid_forces_contact(dfT, nbr, kernel: Kernel, cutoff: float,
                         fluid_alpha: float, c0: float, S: int,
                         init_dist: float, rows=None,
                         lanes: LaneMap | None = None):
    """B5: the force and contact columns in one sweep -> ``(forces [NC,
    M, 6], contact)``.  The contact columns are written where the step
    reads them: by query row at the slots ``rows [NI]`` (int64,
    ascending, NC past their count: ``[NI, M, 12 S]``, a padding row the
    init row), by particle with ``lanes`` (``[n, 12 S]``, a particle
    without a lane zeros), or with neither by query row at every slot
    (``[NC, M, 12 S]``).  Counted as the instance ``"rows"`` or
    ``"lanes"``."""
    if rows is not None and lanes is not None:
        raise ValueError("fluid_forces_contact: rows or lanes, not both")
    if S < 1:
        raise ValueError(f"fluid_forces_contact: S={S} (at least 1)")
    if not _check("fluid_forces_contact", dfT, nbr):
        return fluid_forces_contact_reference(dfT, nbr, kernel, cutoff,
                                              fluid_alpha, c0, S, init_dist,
                                              rows, lanes)
    NC, O = nbr.shape
    M = dfT.shape[2]
    dev = dfT.device
    dfT, nbr = dfT.contiguous(), nbr.contiguous()
    if lanes is None:
        if rows is None:
            rows = torch.arange(NC, dtype=torch.int64, device=dev)
        if rows.dtype != torch.int64:
            raise ValueError("fluid_forces_contact: int64 rows")
        rows = rows.contiguous()
        NI, n = rows.shape[0], 0
        cout = torch.empty((NI, M, 12 * S), dtype=torch.float32, device=dev)
        ptrs = (rows.data_ptr(), None, None)
    else:
        lp, dp = lanes.lane_pid.contiguous(), lanes.dense_pos.contiguous()
        if lp.dtype != torch.int64 or dp.dtype != torch.int64 \
                or lp.shape[0] != NC * M:
            raise ValueError("fluid_forces_contact: an int64 lane map of "
                             f"{NC * M} lanes")
        NI, n = 0, lanes.n
        cout = torch.empty((n, 12 * S), dtype=torch.float32, device=dev)
        ptrs = (None, lp.data_ptr(), dp.data_ptr())
    fout = torch.empty((NC, M, 6), dtype=torch.float32, device=dev)
    fn = _build.load("fluid_forces_contact", kernel.name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sig_num, sig_den = kernel.sigma_constants()
    err = fn(dfT.data_ptr(), nbr.data_ptr(), fout.data_ptr(),
             cout.data_ptr(), *ptrs, NC, O, M, S, NI, n,
             int(kernel.dim == 2), int(abs(fluid_alpha) > 1e-14),
             kernel.device_id, float(cutoff), float(-fluid_alpha * c0),
             float(init_dist), float(sig_num), float(sig_den), stream)
    _build.check(err, "fluid_forces_contact")
    _build.count("fluid_forces_contact", kernel.name,
                 "rows" if lanes is None else "lanes")
    return fout, cout
