"""The Mofidi contact pair pass on the compact interesting-slot path.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/pallas_contact.py``:
the packed contact fields and their sentinels, the interest cull
(``_cull_interesting_slots``, plain PyTorch here as it is XLA there) and
the light cull of the coupling step's compact route
(``_cull_rigid_query_slots``), the contact sums (``contact_sums``:
``csrc/contact.cu`` for CUDA tensors, :func:`contact_sums_reference`
for CPU tensors) and the compact pipeline that drives pack expansion,
cull and contact sums.

The cell pipeline (:func:`contact_pipeline_cell`, the coupling steps'
contact pass) runs the same sums on every slot of a grid that exists, on
this pack built directly (:func:`pack_scene`) or laid out from the rows
of another pack (:func:`contact_pack`, the coupling pack).

Output of the contact sums: 12 S columns a lane, column ``c * S + s``
for block c of (cfn x/y/z, wij sum, contact distance, closest distance,
picked source x/y/z/u/v/w) and source-entity slot s, in one of two
layouts: by query row, ``[NI, M, 12 S]`` (the culled rows; every lane is
written, and a query lane with no gated pair, a sentinel lane or a
padding row, holds the init row: zeros, closest distance = init_dist), or
by particle, ``[n, 12 S]`` (every slot of the cell pipeline: each lane's
row goes to its particle's row, the layout the Eq.-24 tail reads, and a
particle without a lane gets zeros, as an unpack fills it).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import _build
from .cellpairs import (CellGridConfig, LaneMap, build_cell_grid_packed,
                        lane_map, pack_fields)
from .ieee import sqrt
from .kernels import Kernel
from .pack_expand import expand_slots, expand_slots_reference

_BIG = 1.0e9
S_NARROW = 64       # csrc/contact.cu's narrow instance: dems as 64-bit masks
WIDE_CHUNK = 2048   # its wide instance: the most dems a chunk
_MAX_PACK_LANES = 1 << 31   # csrc/contact.cu keeps a pack lane in an int
_MAX_PAIR_ELEMS = 1 << 22   # pair lanes per chunk of the plain version

# Pack field order.  The flags word is dem_id*8 + boundary*4 + fluid*2
# + rigid, exact for dem_id < 2^20; the sentinel -8 decodes to dem -1.
_FIELDS_3D = ("x", "y", "z", "u", "v", "w", "vol", "h", "flags")
_FIELDS_2D = ("x", "y", "u", "v", "vol", "h", "flags")
_SENT = [_BIG, _BIG, _BIG, 0.0, 0.0, 0.0, 0.0, 1.0, -8.0]
_SENT_2D = [_BIG, _BIG, 0.0, 0.0, 0.0, 1.0, -8.0]


def sent_fields(two_d: bool):
    return _SENT_2D if two_d else _SENT


def field_index(two_d: bool):
    names = _FIELDS_2D if two_d else _FIELDS_3D
    return {k: i for i, k in enumerate(names)}


def encode_flags(dem, bdry, fluid, rigid):
    """The flags word from its parts (floats or 0/1 tensors)."""
    return dem * 8.0 + bdry * 4.0 + fluid * 2.0 + rigid


def decode_flags(f):
    """flags -> (dem_id, is_boundary, is_fluid, is_rigid) as floats."""
    dem = torch.floor(f * 0.125)
    r = f - 8.0 * dem
    bdry = torch.floor(r * 0.25)
    r = r - 4.0 * bdry
    fluid = torch.floor(r * 0.5)
    rigid = r - 2.0 * fluid
    return dem, bdry, fluid, rigid


class PackLayout(NamedTuple):
    """How the contact pass reads a pack: the field rows (``vol``, or
    ``m`` and ``rho`` for V = m / rho), the flags decoder (-> dem,
    contact boundary, fluid, rigid) and whether the geometry is 2D."""
    fields: dict
    decode: Callable
    two_d: bool


def rigid_layout(two_d: bool) -> PackLayout:
    """The contact pack's own layout (F = 7 in 2D, 9 in 3D)."""
    return PackLayout(field_index(two_d), decode_flags, two_d)


def contact_payload(scene, two_d: bool):
    """The packed contact fields as per-particle [N] tensors (2D drops
    z and w, identically zero there)."""
    fdt = scene.dtype
    flags = encode_flags(scene.dem_id.to(fdt),
                         scene.contact_force_is_boundary,
                         scene.is_fluid.to(fdt), scene.is_rigid.to(fdt))
    vol = scene.m / scene.rho
    if two_d:
        return [scene.x, scene.y, scene.u, scene.v, vol, scene.h, flags]
    return [scene.x, scene.y, scene.z, scene.u, scene.v, scene.w, vol,
            scene.h, flags]


def cull_interesting_slots(dfT, slot_cid, cfg: CellGridConfig):
    """Conservative per-slot interest test for the contact gate: a slot
    can produce a gated pair only if it holds a rigid query lane and its
    cell's stencil holds a contact-surface, non-fluid source of a dem
    other than some query's.  Exact for the dem/flag gates and
    conservative in distance, so culled slots' output is exactly the
    init row.  Returns ``(interesting [NC] bool, islot [NC])`` with the
    interesting slot ids first, ascending, then NC."""
    NC = cfg.NC_max
    G = cfg.n_cells_total
    gx, gy, _ = cfg.dims
    F = dfT.shape[1]
    dev = dfT.device
    BIGD = 2.0e9
    dem, bdry, fluid, rigid = decode_flags(dfT[:NC, F - 1, :])
    qmask = rigid == 1.0
    smask = (bdry == 1.0) & (fluid == 0.0)
    big = torch.full_like(dem, BIGD)
    qdmin = torch.where(qmask, dem, big).amin(1)
    qdmax = torch.where(qmask, dem, -big).amax(1)
    sdmin = torch.where(smask, dem, big).amin(1)
    sdmax = torch.where(smask, dem, -big).amax(1)

    # per-cell source tables over the dense cell-id space (scatter
    # min/max merges the slots of a multi-slot cell)
    live = slot_cid < G
    cidc = torch.where(live, slot_cid, torch.full_like(slot_cid, G))
    bigs = torch.full_like(sdmin, BIGD)
    smin_g = torch.full((G + 1,), BIGD, dtype=dem.dtype, device=dev
                        ).scatter_reduce(0, cidc, torch.where(live, sdmin,
                                                              bigs),
                                         "amin")[:G]
    smax_g = torch.full((G + 1,), -BIGD, dtype=dem.dtype, device=dev
                        ).scatter_reduce(0, cidc, torch.where(live, sdmax,
                                                              -bigs),
                                         "amax")[:G]

    # union over each slot's stencil cells (the domain's boundary ring
    # is particle-free, so offsets never wrap)
    offs = torch.tensor([dx_ + gx * (dy_ + gy * dz_)
                         for (dx_, dy_, dz_) in cfg.stencil],
                        dtype=torch.int64, device=dev)
    maxoff = int(offs.abs().max())
    pad = torch.full((maxoff,), BIGD, dtype=dem.dtype, device=dev)
    pmin = torch.cat([pad, smin_g, pad])
    pmax = torch.cat([-pad, smax_g, -pad])
    at = torch.clamp(slot_cid, 0, G - 1)[:, None] + offs[None, :] + maxoff
    sminu = torch.where(live, pmin[at].amin(1), bigs)
    smaxu = torch.where(live, pmax[at].amax(1), -bigs)

    has_q = qdmin < BIGD
    has_s = sminu < BIGD
    uniform = (qdmin == qdmax) & (sminu == smaxu) & (qdmin == sminu)
    interesting = has_q & has_s & ~uniform & live
    iota = torch.arange(NC, dtype=torch.int64, device=dev)
    islot = torch.sort(torch.where(interesting, iota,
                                   torch.full_like(iota, NC))).values
    return interesting, islot


def cull_rigid_query_slots(dfT, slot_cid, cfg: CellGridConfig):
    """The light interest test on the coupling pack ``dfT`` (the union
    layout of ``pallas_contact.py:578-603``, its flags word read by
    ``fluid_kernel.decode_flags``): a slot is interesting if and only if
    it holds a rigid query lane and is live (``slot_cid < G``).  A
    superset of :func:`cull_interesting_slots` (a rigid query with no
    gated source writes the init row), for scenes whose rigid particles
    are few among many (the coupling scheme).  Returns ``(interesting
    [NC] bool, islot [NC])`` with the interesting slot ids first,
    ascending, then NC."""
    from .fluid_kernel import FFLAGS, decode_flags as decode_union

    NC = cfg.NC_max
    G = cfg.n_cells_total
    rigid = decode_union(dfT[:NC, FFLAGS, :])[4]
    interesting = (rigid == 1.0).any(1) & (slot_cid < G)
    iota = torch.arange(NC, dtype=torch.int64, device=dfT.device)
    islot = torch.sort(torch.where(interesting, iota,
                                   torch.full_like(iota, NC))).values
    return interesting, islot


def rows_by_particle(rows, qslot, lanes: LaneMap):
    """Query rows ``rows [NI, M, W]`` laid out by particle, ``[n, W]``:
    lane l of row b is pack lane ``qslot[b] M + l`` and goes to its
    particle's row (``lanes.lane_pid``); a particle without a lane gets
    zeros."""
    NI, M, W = rows.shape
    n, lp = lanes.n, lanes.lane_pid
    L = lp.shape[0]
    lane = qslot.to(torch.int64)[:, None] * M + torch.arange(
        M, device=rows.device)
    pid = torch.cat([lp, lp.new_full((1,), n)])[
        torch.where((lane >= 0) & (lane < L), lane, L)]   # lane L: none
    pid = torch.where((pid >= 0) & (pid < n), pid, n)
    out = torch.zeros((n + 1, W), dtype=rows.dtype, device=rows.device)
    out[pid.reshape(-1)] = rows.reshape(NI * M, W)
    return out[:n]


def contact_sums_reference(dfT, qslot, nbr, S: int, cutoff: float,
                           init_dist: float, kernel: Kernel,
                           layout: PackLayout | None = None,
                           lanes: LaneMap | None = None):
    """Plain PyTorch version of the contact kernel (same inputs, same
    output: ``[NI, M, 12 S]`` by query row, or with ``lanes`` ``[n, 12
    S]`` by particle).  Rows are processed in chunks of at most
    ``_MAX_PAIR_ELEMS`` pair lanes to bound memory.  ``layout`` reads
    another pack (the coupling pack, ``ops/fluid_kernel.py``); the
    kernel's sigma stays that of ``kernel.dim``."""
    layout = layout or rigid_layout(kernel.dim == 2)
    two_d = layout.two_d
    fi = layout.fields
    NI, O = nbr.shape
    F, M = dfT.shape[1], dfT.shape[2]
    OM = O * M
    dt = dfT.dtype
    dev = dfT.device
    chunk = max(1, _MAX_PAIR_ELEMS // (M * OM))
    lane = torch.arange(OM, device=dev)
    src_names = ("x", "y", "z", "u", "v", "w")
    outs = []
    for c0 in range(0, NI, chunk):
        qs = qslot[c0:c0 + chunk].to(torch.int64)
        nb = nbr[c0:c0 + chunk].to(torch.int64)
        B = qs.shape[0]
        q = dfT[qs]                                            # [B, F, M]
        src = dfT[nb].permute(0, 2, 1, 3).reshape(B, F, OM)    # [B, F, OM]

        def qcol(k):
            return q[:, fi[k], :, None]                        # [B, M, 1]

        def srow(k):
            return src[:, fi[k], None, :]                      # [B, 1, OM]

        xij = qcol("x") - srow("x")
        yij = qcol("y") - srow("y")
        if two_d:
            rij = sqrt(xij * xij + yij * yij)
        else:
            zij = qcol("z") - srow("z")
            rij = sqrt(xij * xij + yij * yij + zij * zij)
        hij = 0.5 * (qcol("h") + srow("h"))
        wij = kernel.w(rij, hij)
        s_dem, s_bdry, s_fluid, _ = layout.decode(srow("flags"))
        q_dem, _, _, q_rigid = layout.decode(qcol("flags"))
        gate = ((s_bdry == 1.0) & (s_dem != q_dem) & (s_fluid == 0.0)
                & (q_rigid == 1.0) & (rij <= cutoff))
        zero = torch.zeros_like(rij)
        rinv = 1.0 / torch.clamp(rij, min=1e-30)
        vol = qcol("vol") if "vol" in fi else qcol("m") / qcol("rho")
        t1 = torch.where(gate, vol * rinv * wij, zero)
        t2 = t1 * rij

        # per-slot sums: [B, nq*M, OM] x one-hot [B, OM, S]
        oh = (s_dem[:, 0, :, None]
              == torch.arange(S, device=dev, dtype=dt)).to(dt)
        if two_d:
            quants = [t1 * xij, t1 * yij, t2, t2 * xij, t2 * yij]
        else:
            quants = [t1 * xij, t1 * yij, t1 * zij, t2,
                      t2 * xij, t2 * yij, t2 * zij]
        nq = len(quants)
        sums = torch.bmm(torch.stack(quants, 1).reshape(B, nq * M, OM), oh
                         ).reshape(B, nq, M, S)
        if two_d:
            q0, q1, q3, q4, q5 = sums.unbind(1)
            q2 = q6 = torch.zeros_like(q0)
        else:
            q0, q1, q2, q3, q4, q5, q6 = sums.unbind(1)

        # closest gated source per slot, lowest lane on a tie
        r_g = torch.where(gate, rij, torch.full_like(rij, _BIG))
        names = src_names[:2] + src_names[3:5] if two_d else src_names
        fields = torch.stack([src[:, fi[k], :] for k in names], 1)
        fields = torch.cat([fields, torch.zeros_like(fields[..., :1])], -1)
        mins, picks = [], []
        for s in range(S):
            m = s_dem == float(s)                              # [B, 1, OM]
            mn = torch.where(m, r_g, torch.full_like(r_g, _BIG)).amin(-1)
            pick = gate & m & (r_g <= mn[..., None])
            ls = torch.where(pick, lane, torch.full_like(lane, OM)).amin(-1)
            got = torch.gather(fields, 2, ls[:, None, :].expand(
                B, len(names), M))                             # [B, nf, M]
            mins.append(mn)
            picks.append(got)
        min_r = torch.stack(mins, -1)                          # [B, M, S]
        srcs = torch.stack(picks, -1)                          # [B, nf, M, S]
        if two_d:
            zs = torch.zeros_like(srcs[:, 0])
            srcs = torch.stack([srcs[:, 0], srcs[:, 1], zs,
                                srcs[:, 2], srcs[:, 3], zs], 1)

        # epilogue
        has = q3 > 1e-12
        zq = torch.zeros_like(q3)
        inv_w = torch.where(has, 1.0 / torch.clamp(q3, min=1e-30), zq)
        mx, my, mz = q0 * inv_w, q1 * inv_w, q2 * inv_w
        mag = sqrt(mx * mx + my * my + mz * mz)
        inv_m = torch.where(has & (mag > 0),
                            1.0 / torch.clamp(mag, min=1e-30), zq)
        cfn_x, cfn_y, cfn_z = mx * inv_m, my * inv_m, mz * inv_m
        num = cfn_x * q4 + cfn_y * q5 + cfn_z * q6
        dist = torch.where(has, num / torch.where(has, q3, zq + 1.0), zq)
        found = min_r < init_dist
        mind = torch.clamp(min_r, max=init_dist)
        srcs = torch.where(found[:, None], srcs, torch.zeros_like(srcs))
        cols = torch.stack([cfn_x, cfn_y, cfn_z, q3, dist, mind]
                           + list(srcs.unbind(1)), 2)          # [B,M,12,S]
        outs.append(cols.reshape(B, M, 12 * S))
    rows = (torch.cat(outs, 0) if outs
            else torch.zeros((0, M, 12 * S), dtype=dt, device=dev))
    return rows if lanes is None else rows_by_particle(rows, qslot, lanes)


def contact_instance(S: int) -> tuple[str, int]:
    """The ``csrc/contact.cu`` instance for S source-entity slots:
    ``("narrow", 0)`` up to S_NARROW (a row's dems as 64-bit masks, static
    count tables), else ``("wide", chunk)``: the count tables in dynamic
    shared memory, the dems taken ``chunk = min(S, WIDE_CHUNK)`` at a
    time.  Both give the same output; every S >= 1 has one."""
    if S < 1:
        raise ValueError(f"contact kernel: S={S} (at least 1)")
    if S <= S_NARROW:
        return "narrow", 0
    return "wide", min(S, WIDE_CHUNK)


def contact_sums(dfT, qslot, nbr, S: int, cutoff: float, init_dist: float,
                 kernel: Kernel, lanes: LaneMap | None = None):
    """Contact sums for the query slots ``qslot [NI]`` over the stencil
    rows ``nbr [NI, O]`` of the dense pack ``dfT [R, F, M]``: the culled
    rows of the compact path (``[NI, M, 12 S]`` by query row), or with
    ``lanes`` every slot of a grid (the cell pipeline: ``[n, 12 S]`` by
    particle; ``qslot`` must then cover every slot that holds a
    particle), where a row without a rigid lane costs the kernel only its
    init rows.  On CUDA tensors the library of ``kernel`` (any of the six
    SPH kernels) runs."""
    two_d = kernel.dim == 2
    F = len(_FIELDS_2D if two_d else _FIELDS_3D)
    if dfT.dim() != 3 or dfT.shape[1] != F or qslot.dim() != 1 \
            or nbr.dim() != 2 or nbr.shape[0] != qslot.shape[0]:
        raise ValueError("contact_sums: bad shapes "
                         f"{tuple(dfT.shape)}, {tuple(qslot.shape)}, "
                         f"{tuple(nbr.shape)} for dim {kernel.dim}")
    if dfT.device.type == "cpu":
        return contact_sums_reference(dfT, qslot, nbr, S, cutoff,
                                      init_dist, kernel, lanes=lanes)
    if dfT.device.type != "cuda":
        raise ValueError(f"unsupported device {dfT.device}")
    if dfT.dtype != torch.float32:
        raise ValueError("the contact kernel takes float32")
    if qslot.dtype != torch.int64 or nbr.dtype != torch.int64:
        raise ValueError("the contact kernel takes int64 qslot/nbr")
    R, M = dfT.shape[0], dfT.shape[2]
    inst, chunk = contact_instance(S)
    if M != 16 or R * M >= _MAX_PACK_LANES:
        raise ValueError(f"contact kernel limits: M={M} (16), {R * M} pack "
                         f"lanes (below {_MAX_PACK_LANES})")
    NI, O = nbr.shape
    dfT, qslot, nbr = dfT.contiguous(), qslot.contiguous(), nbr.contiguous()
    if lanes is None:
        out = torch.empty((NI, M, 12 * S), dtype=torch.float32,
                          device=dfT.device)
        lp = dp = None
        n = n_lanes = 0
    else:
        lp, dp = lanes.lane_pid.contiguous(), lanes.dense_pos.contiguous()
        if lp.dtype != torch.int64 or dp.dtype != torch.int64:
            raise ValueError("the contact kernel takes an int64 lane map")
        n, n_lanes = lanes.n, lp.shape[0]
        out = torch.empty((n, 12 * S), dtype=torch.float32,
                          device=dfT.device)
        lp, dp = lp.data_ptr(), dp.data_ptr()
    sig_num, sig_den = kernel.sigma_constants()
    fn = _build.load("contact", kernel.name)
    stream = torch.cuda.current_stream(dfT.device).cuda_stream
    err = fn(dfT.data_ptr(), qslot.data_ptr(), nbr.data_ptr(),
             out.data_ptr(), lp, dp, NI, O, R, M, S, chunk, n, n_lanes,
             int(two_d), kernel.device_id, float(cutoff), float(init_dist),
             float(sig_num), float(sig_den), stream)
    _build.check(err, "contact_sums")
    _build.count("contact", kernel.name, inst)
    return out


def contact_pipeline_cell(dfT, grid, cfg: CellGridConfig,
                          kernel: Kernel, S: int, init_dist: float,
                          n: int, plain: bool = False):
    """The cell pipeline (``pallas_contact.py:433-475``): the contact sums
    on every slot of the contact pack ``dfT [NC + 1, F, M]`` of ``grid``
    (no interest cull; ``grid`` keeps ``dense_pos``), written by particle
    as ``[N, 12, S]`` (block c of the 12, source-entity slot s; a
    particle without a lane gets zeros).  ``plain`` runs the sums' plain
    version even on CUDA tensors."""
    qslot = torch.arange(cfg.NC_max, dtype=torch.int64, device=dfT.device)
    args = (dfT, qslot, grid.nbr_slots, S, cfg.radius, init_dist, kernel)
    lanes = lane_map(grid, cfg, n)
    if plain:
        out = contact_sums_reference(*args, lanes=lanes)
    else:
        out = contact_sums(*args, lanes=lanes)
    return out.reshape(n, 12, S)


class CompactContact(NamedTuple):
    out: torch.Tensor           # [NI, M, 12 S]
    pid: torch.Tensor           # [NI, M] particle per lane (n = empty)
    u: torch.Tensor             # [NI, M] query velocities
    v: torch.Tensor
    w: torch.Tensor
    overflow: torch.Tensor      # 0-d bool: grid or cull capacity
    n_interesting: torch.Tensor  # 0-d: slots the cull found


def pack_scene(scene, cfg: CellGridConfig, plain: bool = False,
               want_dense_pos: bool = False):
    """Grid build with the pack fields riding the sort, then pack
    expansion: ``(grid, pack tables, dfT [NC + 1, F, M])``.  ``plain``
    runs the expansion's plain version even on CUDA tensors (for
    comparisons on the card); ``want_dense_pos`` keeps the grid's
    ``dense_pos`` for the lane map of the cell pipeline."""
    two_d = cfg.dim == 2
    grid, pt = build_cell_grid_packed(
        scene.x, scene.y, scene.z, scene.active, cfg,
        contact_payload(scene, two_d), want_dense_pos=want_dense_pos)
    sent = torch.tensor(sent_fields(two_d), dtype=scene.dtype,
                        device=scene.device)
    expand = expand_slots_reference if plain else expand_slots
    return grid, pt, expand(pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)


def pack_grid(scene, grid, cfg: CellGridConfig):
    """The contact pack ``dfT [NC + 1, F, M]`` of ``scene`` on a grid
    built earlier (the Verlet-skin grid, carried across steps): the
    fields gathered through its ``slot2p`` (``pack_fields``, no K1: the
    lanes keep the order of the grid's build), row NC all sentinels."""
    two_d = cfg.dim == 2
    sent = sent_fields(two_d)
    df = pack_fields(grid, cfg, contact_payload(scene, two_d), sent)
    row = torch.tensor(sent, dtype=df.dtype, device=df.device)
    row = row[None, :, None].expand(1, len(sent), cfg.M)
    return torch.cat([df.transpose(1, 2), row], 0).contiguous()


def contact_pack(dfT, layout: PackLayout, two_d: bool):
    """This module's pack (F = 7 in 2D, 9 in 3D) laid out from the rows
    of another pack ``dfT [R, F', M]`` that ``layout`` reads (the
    coupling pack: ``fluid_kernel.UNION_LAYOUT``): V = m / rho and the
    flags word re-encoded from the layout's decoder, so the other pack's
    sentinel lanes become this pack's."""
    fi = layout.fields
    dem, bdry, fluid, rigid = layout.decode(dfT[:, fi["flags"]])
    rows = dict(vol=dfT[:, fi["m"]] / dfT[:, fi["rho"]],
                flags=encode_flags(dem, bdry, fluid, rigid))
    names = _FIELDS_2D if two_d else _FIELDS_3D
    return torch.stack([rows[k] if k in rows else dfT[:, fi[k]]
                        for k in names], 1)


def select_queries(dfT, grid, pt, cfg: CellGridConfig, ni_max: int):
    """The interest cull and the first ``ni_max`` interesting slots:
    ``(qsel [NI], nbr [NI, O], valid [NI], slot [NI], n_interesting)``;
    padding rows query the all-sentinel row NC."""
    NC = cfg.NC_max
    interesting, islot = cull_interesting_slots(dfT, pt.slot_cid, cfg)
    isl = islot[:ni_max]
    valid = isl < NC
    isl_c = torch.clamp(isl, 0, NC - 1)
    qsel = torch.where(valid, isl, torch.full_like(isl, NC))
    nbr = grid.nbr_slots[isl_c]
    nbr = torch.where(valid[:, None], nbr, torch.full_like(nbr, NC))
    return qsel, nbr, valid, isl_c, interesting.to(torch.int64).sum()


def compact_lanes(dfT, pt, qsel, valid, isl_c, n: int, M: int, rows):
    """The culled rows' lanes: ``(pid [NI, M], u, v, w [NI, M])``, each
    lane's particle id from the sorted-pack tables (n = empty lane) and
    its query velocity from the pack's rows ``rows = (u, v, w)`` of the
    query slots ``qsel`` (``w = None``: zeros, the 2D contact pack)."""
    base_c = torch.where(valid, pt.base[isl_c], torch.full_like(qsel, n))
    cnt_c = torch.where(valid, pt.cnt[isl_c], torch.zeros_like(qsel))
    lane = torch.arange(M, device=dfT.device)[None, :]
    sidx = torch.clamp(base_c[:, None] + lane, 0, max(n - 1, 0))
    pid = torch.where(lane < cnt_c[:, None], pt.sorted_pid[sidx],
                      torch.full_like(sidx, n))
    qI = dfT[qsel]                                       # [NI, F, M]
    iu, iv, iw = rows
    u_c, v_c = qI[:, iu], qI[:, iv]
    w_c = torch.zeros_like(u_c) if iw is None else qI[:, iw]
    return pid, u_c, v_c, w_c


def contact_pipeline_compact(scene, cfg: CellGridConfig,
                             kernel: Kernel, ni_max: int,
                             plain: bool = False) -> CompactContact:
    """Pack, cull and contact sums on at most ``ni_max`` interesting
    slots.  ``overflow`` is raised when the grid overflows or the cull
    finds more than ``ni_max`` slots (the caller then re-sizes).
    ``plain`` runs both kernels' plain versions even on CUDA tensors."""
    S = scene.meta.total_no_bodies
    M = cfg.M
    n = scene.n
    two_d = cfg.dim == 2
    fi = field_index(two_d)

    grid, pt, dfT = pack_scene(scene, cfg, plain)
    qsel, nbr, valid, isl_c, n_int = select_queries(dfT, grid, pt, cfg,
                                                    ni_max)
    sums = contact_sums_reference if plain else contact_sums
    out = sums(dfT, qsel, nbr, S, cfg.radius, 4.0 * scene.meta.spacing0,
               kernel)

    pid, u_c, v_c, w_c = compact_lanes(
        dfT, pt, qsel, valid, isl_c, n, M,
        (fi["u"], fi["v"], None if two_d else fi["w"]))
    return CompactContact(out=out, pid=pid, u=u_c, v=v_c, w=w_c,
                          overflow=grid.overflow | (n_int > ni_max),
                          n_interesting=n_int)
