#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the
CUDA toolkit.  Phases, in order (any failure exits non-zero and prints
no result line):

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 off for matmul and cuDNN;
2. build: every hand-written kernel source in ``csrc/`` (one nvcc each,
   all started together; sm_90a), with seconds and register reports;
3. rigid kernels against their plain twins on the card at the main
   path's shapes (2D, F = 7) and on phase 5a's 3D scene (F = 9, 27-cell
   stencil): pack expansion bit for bit, contact picks bit for bit,
   contact sums within rtol 1e-5 (f32 summation order), K2 on every slot
   equal bit for bit to K2 on the culled rows at their slots; kernel and
   twin times in ms; in 3D
   K2 also on every interesting row (the rows the 3D path runs once its
   overflow rebuilds have raised ``ni_max``), timed with its bound;
4. the rigid main path: ``RigidBody2DScheme.setup`` -> ``make_step`` ->
   ``step`` for 200 steps at dt = 1e-4 on a ~105k-particle scene that is
   in contact from the first step (a resting stack of 8 blocks in two
   rows of 4 on a tank floor), in chunks with the overflow-rebuild rule;
   checks launch counts, interesting slots, overlap, finiteness,
   overflow, COM drift < 2 dx, and that no block dropped half the
   free-fall distance (the stack is carried by contact), and prints
   steps/s;
5. 20 rigid kernel steps against 20 twin steps from one state;
5a. the 3D main path: ``RigidBody3DScheme.setup`` -> ``make_step`` ->
   ``step`` for 200 steps at dt = 1e-4 on 8 cubes at rest on a floor slab
   (~116.5k particles, S = 9), in chunks with the overflow-rebuild rule
   (each rebuild and the final ``ni_max``, NC and O printed), under
   phase 4's gates (COM drift over x, y and z); prints steps/s;
5b. 20 3D kernel steps against 20 twin steps from 5a's end state;
6. DEM kernels against their twins on ~100k grains in contact (2D spill
   grid, 3D spill grid, 2D row-window grid, 3D row-window grid), each
   from an empty contact table (every contact allocated), a filled one,
   and one whose contacts open and close (positions jittered by up to an
   overlap: slots freed and reallocated); the 2D grids also on a crowded
   column (grains at half the spacing, so each has ~12 gated partners
   for its 8 slots: full tables, new contacts dropped, pair lists
   emptied many times a warp): tables, slot positions and counts bit for
   bit, force and torque sums within 2e-5 |ref| + 2e-5 max |ref|,
   springs within rtol 1e-4; times, gated pairs, candidate lanes;
7. the DEM main path (``DEMScheme`` LVC displacement, spill grid): 200
   steps at dt = 5e-6 of a granular column whose grains start 0.5 %
   overlapped, in chunks with the overflow-rebuild rule; checks one
   kernel launch per step, live contacts every step, finiteness,
   overflow, the floor and the overlap; prints steps/s;
8. the same on the row-window grid for 100 steps (one DEM launch and one
   pack expansion per step);
9. 20 DEM kernel steps against 20 twin steps from one state;
10. the coupling fluid kernels (B4 rates + wall sums, B5 forces +
    contact) against their twins on the sinking box of
    ``cases/rigid_body_rotating_and_sinking_in_tank_2d.py`` at bench.py's
    coupling size (~96.9k particles, seeded random velocities) and on a
    placement with the box resting 0.95 dx above the tank floor (gated
    contact pairs > 0): sums within 2e-5 of each column's largest
    magnitude (f32 summation order; the unit contact normals 2e-5
    absolute), contact picks bit for bit, two launches on the same
    inputs bit for bit; times, lanes and pairs; K1 on the sinking box's
    coupling pack (F = 14) bit for bit, timed with its bound;
11. the coupling main path: ``RigidFluidCouplingScheme.setup`` ->
    ``make_step`` -> ``step``, 200 fused kdkf steps of the sinking box at
    the case's dt = 0.25 dx / (1.1 c0), in chunks with the
    overflow-rebuild rule; checks one K1, one B4 and one B5 launch per
    step and no K2, finiteness, overflow, fluid rho within 5 % of rho0
    and the box's COM lower at the end; prints steps/s;
12. the fluid-only tank (the same tank without the box): B4 (no rigid
    body) and B6c against their twins on its pack as in phase 10, timed,
    then 50 steps:
    one K1, one B4 and one B6c launch per step;
13. 20 coupling kernel steps against 20 twin steps on the contact
    placement with a box of 8 times the fluid's density, in contact to
    the end (overlap and tangential springs nonzero in both runs); the
    fluid, body and contact-slot fields within rtol 1e-4;
14. (run beside phase 10, on its two scenes) the split fluid passes of
    the kdk and reference orderings (B6a with EDAC and with Tait, B6b,
    B6c with rigid bodies) and K2 on every slot of the contact pack laid
    out from the coupling pack, against their twins on the sinking box
    (timed) and with the box on the floor (contact picks > 0): sums as
    in phase 10 (two launches bit for bit), K2's picks bit for bit;
    times, lanes and pairs;
15. the kdk ordering: ``gtvf_ordering="kdk"``, 200 steps of the sinking
    box as in phase 11; checks two K1, one B6a, one B6b, one B6c and one
    K2 launch per step and nothing else, and the gates of phase 11;
16. the reference ordering, the same with one K1 launch per step;
17. the no-fluid route: an RFC scheme with ``fluids=[]`` on phase 4's
    resting stack, 50 steps at dt = 1e-4 (kdkf routed to kdk): K2 on
    every slot of its pack against its twin, then one K1 and one K2
    launch per step and nothing else, overlap > 0, finite fields;
18. 20 kdk and 20 reference kernel steps against as many twin steps on
    phase 13's placement, in contact to the end, as in phase 13;
19. the sinking box in 3D (``RigidFluidCouplingScheme(dim=3)`` set-up,
    ~97k particles): every fluid pass (B4, B5, B6a with EDAC and with
    Tait, B6b, B6c with and without bodies) and K1 on its pack against
    their twins as in phase 10, each timed with its bound;
20. a JSON line of per-kernel numbers (``launches`` from the kernel's
    first main path, ``launches_by_path`` from every path it ran on,
    ``rigid-3d`` among them; K2's 3D times at the set-up ``ni_max`` and
    on every interesting row beside its 2D time; K1 on the 3D rigid pack
    and on the 2D and 3D coupling packs; every fluid pass's 3D time;
    ptxas's registers, static and dynamic shared memory and spills of
    every rates/wall and forces instance the paths launch), then the
    result line.

It imports nothing from JAX or the JAX package.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DT = 1e-4
N_STEPS = 200
CHUNK = 50
COMPARE_STEPS = 20
REPS = 20
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's ~2 GHz: REPS launches queue
# step-vs-step tolerance: the contact sums' f32 summation order differs
# between kernel and twin, and 20 steps of a stiff contact carry it on
STEP_RTOL = 1e-4
SUM_RTOL = 1e-5
# DEM: the bench's grains (radius 1e-3, rho 2600) spaced 0.5 % under a
# diameter, so every lattice neighbour overlaps by 1e-5 m at step 0; the
# column case's dt
DEM_R = 1e-3
DEM_SPACING = 2 * DEM_R * (1 - 0.005)
DEM_OVERLAP = 2 * DEM_R - DEM_SPACING
DEM_DT = 5e-6
DEM_STEPS = 200
DEM_ROWWIN_STEPS = 100
DEM_SUM_RTOL = 2e-5        # summation order (tests/test_pallas_dem.py)
DEM_SPRING_RTOL = 1e-4     # operation order
# the crowded column: grains at this fraction of DEM_SPACING (0.995 r),
# so the 4 axial, 4 diagonal and 4 second axial lattice neighbours all
# overlap: 12 gated partners for an L = 8 table
DEM_CROWD = 0.5
# the least time a kernel could take: H100 SXM HBM rate and f32 peak
# outside the tensor cores (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
OPS_PER_LANE = 9           # any candidate lane: 3 sub, 3 mul, 2 add, sqrt
OPS_PER_DEM_PAIR = 140     # the LVC body per gated pair (csrc/dem.cu)
# face gap of the resting stack in dx: a contact engages below 1 dx, and
# the 0.05 dx overlap of a 0.95 dx gap pushes a face with about the
# weight of one block (kr * 0.05 dx per face particle), so the stack
# starts near rest; the 0.3-0.4 dx overlaps of a 0.6-0.7 dx gap throw it
GAP = 0.95
G = 9.81
# the 3D scene's cube faces over the 3-layer floor slab: their Eq.-21
# contact distance exceeds the gap by this many dx near a gap of dx (the
# lower layers' share of the weighted sums; 0.99819 dx at a gap of
# 0.99341 dx, at dx = 0.025 and 0.0154 alike, as the sums scale with dx)
FLOOR_EPS = 0.00478
# coupling: bench.py's coupling workload at BENCH_N = 100000 (the sinking
# box with its spacing scaled from 0.02 at ~33k particles)
CPL_N = 100_000
CPL_STEPS = 200
CPL_TANK_STEPS = 50
CPL_NOFLUID_STEPS = 50
FLUID_SUM_RTOL = 2e-5      # f32 summation order of the fluid sums
# the step comparison's box: 8 times the fluid's density (steel in
# water), so the floor contact it starts in lasts the 20 steps (the
# case's box, rho 2, is thrown off the floor within them)
CPL_PARITY_RHO = 8.0
# f32 operations of the fluid pair bodies (csrc/fluid.cu), counted from
# the source (an add, mul, div, sqrt, floor, min or max is one): per
# in-range pair of the classes a body runs on, the flags decode and h_ij,
# the spline's gradient or W, then the body's own terms; per gated
# contact pair, W and the Mofidi accumulation
OPS_PAIR_HEAD = 18         # flags decode (16), h_ij (2)
OPS_GRADW = 27             # dW/dr / r of the quintic spline
OPS_W = 24                 # W of the quintic spline
OPS_CONTINUITY = 15        # dW vector, v_ij . dW, rho_i m_j / rho_j term
OPS_EDAC = 28              # the EDAC pressure rate's further terms
OPS_WALL = 16              # g . x_ij and the five Shepard sums
OPS_PGRAD = 13             # dW vector, p_i/rho_i^2 + p_j/rho_j^2, 3 sums
OPS_VISC_TEST = 9          # v_ij . x_ij and its sign (fluid sources)
OPS_VISC = 16              # the viscous term where v_ij . x_ij < 0
OPS_FSI = 14               # dW vector, the fluid -> rigid term, 3 sums
OPS_PER_CONTACT_PAIR = 35


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def smi_line():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    lines = res.stdout.strip().splitlines()
    return lines[0] if res.returncode == 0 and lines else \
        f"nvidia-smi failed: {res.stderr.strip()}"


def cuda_ms(fn, reps=REPS, warmup=3):
    """Mean device time of ``fn()`` in ms over ``reps`` calls.  The card
    first spins for SLEEP_CYCLES while the host queues the calls, so a
    call whose host side (checks, allocations, the launch) outlasts its
    kernels is not timed as host time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """(least ms, what bounds it) for this many bytes and f32 ops."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def slot_lanes(cnt, nbr):
    """Live (query, source) lane pairs of slots with ``cnt`` live lanes
    whose sources are the slots ``nbr`` lists (>= len(cnt) = none)."""
    ext = torch.cat([cnt, torch.zeros(1, dtype=cnt.dtype,
                                      device=cnt.device)])
    src = ext[torch.clamp(nbr, 0, cnt.shape[0])].sum(1)
    return int((cnt[:nbr.shape[0]] * src).sum())


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def contact_scene_2d(dev, n_target=100_000, coupling=False):
    """8 blocks of side 0.2 in two rows of 4 on the floor of a 3-layer
    tank (the bench's body size and count), a resting stack: the bottom
    row sits GAP dx above the floor's surface layer, neighbours GAP dx
    apart, the top row GAP dx above the bottom row.  A contact engages
    below 1 dx, so every block is in contact at once.  ``coupling`` sets
    it up under a rigid-fluid coupling scheme with no fluid group (the
    reference's stack-of-cylinders setup) instead of the rigid scheme."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import (
        get_2d_block, create_tank_2d_from_block_2d)
    from rigid_body_2d_3d_pysph_tpu_torch.models import (
        RigidBody2DScheme, RigidFluidCouplingScheme)
    from rigid_body_2d_3d_pysph_tpu_torch.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY)

    n_bodies = 8
    side = max(int(np.sqrt(n_target / n_bodies)), 12)
    dx = 0.2 / (side - 1)
    xb1, yb1 = get_2d_block(dx, 0.2, 0.2)
    floor_top = -dx                      # the tank's surface layer
    pitch = 0.2 + GAP * dx
    m = 2000.0 * dx * dx
    # one group per block: surface identification runs per group, and in
    # one shared group the faces that touch a neighbour would read as
    # interior and carry no contact
    bodies = []
    for b in range(n_bodies):
        col, row = b % 4, b // 4
        bodies.append(make_group(
            f"body{b}", xb1 + 0.1 + col * pitch,
            yb1 + 0.1 + floor_top + GAP * dx + row * pitch, m=m,
            h=1.3 * dx, rho=2000.0, rad_s=dx / 2, role=ROLE_RIGID,
            dem_id=np.full(len(xb1), b, np.int32)))
    xt, yt = create_tank_2d_from_block_2d(
        np.array([-0.15, 1.1]), np.array([0.0, 1.2]), 1.25, 1.2, dx, 3)
    tank = make_group("tank", xt, yt, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_BOUNDARY, dem_id=n_bodies)
    scene = build_scene(bodies + [tank], dim=2,
                        total_no_bodies=n_bodies + 1, spacing0=dx,
                        device=dev, dtype=config.WORK_DTYPE)
    names = [g.name for g in bodies]
    if coupling:
        scheme = RigidFluidCouplingScheme(
            [], ["tank"], names, dim=2, rho0=2000.0, p0=0.0, c0=1.0,
            h=1.3 * dx, nu=0.0, gy=-9.81)
    else:
        scheme = RigidBody2DScheme(names, ["tank"], dim=2, gy=-9.81)
    return scheme, scheme.setup(scene), dx


def contact_scene_3d(dev, n_target=100_000):
    """8 cubes of side 0.2 in a 4 x 2 layout on a 3-layer floor slab, at
    rest on it (the 3D bench's body size).  Each cube's bottom face sits
    where the floor carries its weight: the face's overlap is m g / (kr
    n_face), a few 1e-4 dx, and the gap is dx less that overlap and
    FLOOR_EPS (the Eq.-21 distance of a face over the slab exceeds the gap
    by that much, the lower layers' share of the sums).  Neighbours stand
    0.95 dx apart: a 3.9 dx cell then never holds 5 lattice rows along an
    axis, so no cell needs more than the grid's 4 slots of 16 (a closer 3D
    stack overflows ``max_spill`` in the reference too); the cubes are one
    group, so the faces between neighbours are interior to the surface
    identification and carry no contact."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import get_3d_block
    from rigid_body_2d_3d_pysph_tpu_torch.models import RigidBody3DScheme
    from rigid_body_2d_3d_pysph_tpu_torch.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY)

    n_bodies = 8
    side = max(int(round((n_target / n_bodies) ** (1 / 3))), 5)
    dx = 0.2 / (side - 1)
    xb1, yb1, zb1 = get_3d_block(dx, 0.2, 0.2, 0.2)
    scheme = RigidBody3DScheme(["body"], ["floor"], dim=3, gy=-G)
    m = 2000.0 * dx**3
    n_face = side * side
    rest = m * len(xb1) * G / (scheme.kr * n_face)
    floor_gap = dx - rest - FLOOR_EPS * dx
    pitch = 0.2 + 0.95 * dx
    xs, ys, zs, bid = [], [], [], []
    for b in range(n_bodies):
        col, row = b % 4, b // 4
        xs.append(xb1 + col * pitch)
        ys.append(yb1 + 0.1 + floor_gap)
        zs.append(zb1 + row * pitch)
        bid.append(np.full(len(xb1), b, np.int32))
    fx, fz = np.meshgrid(np.arange(-0.15, 0.8, dx), np.arange(-0.15, 0.4, dx))
    xf = np.concatenate([fx.ravel()] * 3)
    zf = np.concatenate([fz.ravel()] * 3)
    yf = np.concatenate([np.full(fx.size, -k * dx) for k in range(3)])
    body = make_group("body", np.concatenate(xs), np.concatenate(ys),
                      z=np.concatenate(zs), m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_RIGID,
                      body_id=np.concatenate(bid), dem_id=np.concatenate(bid))
    floor = make_group("floor", xf, yf, z=zf, m=m, h=1.3 * dx, rho=2000.0,
                       rad_s=dx / 2, role=ROLE_BOUNDARY, dem_id=n_bodies)
    scene = build_scene([body, floor], dim=3, total_no_bodies=n_bodies + 1,
                        spacing0=dx, device=dev, dtype=config.WORK_DTYPE)
    return scheme, scheme.setup(scene), dx


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def contact_rows(dfT, grid, pt, cfg, kernel, S, init, ni, label):
    """K2 on the first ``ni`` interesting rows against its twin (picks
    bit for bit, sums within SUM_RTOL), timed, with its bound.  Returns
    the numbers (with the rows' interesting-slot count), the output and
    the rows' slots and validity."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck

    qsel, nbr, valid, _, n_int = tck.select_queries(dfT, grid, pt, cfg, ni)
    n_int = int(n_int)
    check(n_int > 0, f"{label}: no interesting slots")
    args = (dfT, qsel, nbr, S, cfg.radius, init, kernel)
    out = tck.contact_sums(*args)
    out_ref = tck.contact_sums_reference(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    check(torch.equal(out[..., 5 * S:], out_ref[..., 5 * S:]),
          f"{label}: contact picks != twin (max "
          f"{float((out[..., 5 * S:] - out_ref[..., 5 * S:]).abs().max())})")
    for c in range(5):
        a, b = out[..., c * S:(c + 1) * S], out_ref[..., c * S:(c + 1) * S]
        tol = SUM_RTOL * b.abs() + SUM_RTOL * float(b.abs().max())
        check(bool(((a - b).abs() <= tol).all()),
              f"{label}: contact block {c} off by "
              f"{float((a - b).abs().max())}")
    rows = int(valid.sum())
    t = dict(err=float((out - out_ref).abs().max()), rows=rows,
             ni=qsel.shape[0], n_int=n_int,
             ms=cuda_ms(lambda: tck.contact_sums(*args)),
             plain_ms=cuda_ms(lambda: tck.contact_sums_reference(*args)))
    # least time: K2 needs the F fields of the particles in the slots that
    # the rows' stencils reach and writes 12S values per live query lane
    # (the sentinel lanes of the pack and the stencil are layout, not
    # work), and tests every live candidate lane of a live query lane
    NC = cfg.NC_max
    cnt_ext = torch.cat([pt.cnt, torch.zeros(1, dtype=pt.cnt.dtype,
                                             device=pt.cnt.device)])
    t["lanes"] = int((cnt_ext[torch.clamp(qsel, max=NC)]
                      * cnt_ext[torch.clamp(nbr, max=NC)].sum(1)).sum())
    reached = torch.zeros(NC + 1, dtype=torch.bool, device=dfT.device)
    reached[nbr[valid].reshape(-1)] = True
    n_src = int(pt.cnt[reached[:NC]].sum())
    n_query = int(pt.cnt[qsel[valid]].sum())
    t["bound"], t["bound_by"] = bound(
        4 * (n_src * dfT.shape[1] + n_query * 12 * S),
        t["lanes"] * OPS_PER_LANE)
    print(f"[kernels] {label}: K2 on {rows} rows (ni {t['ni']}, interesting "
          f"{n_int}, O {nbr.shape[1]}): {t['ms']:.4f} ms (plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound']:.4f} ms by "
          f"{t['bound_by']}; {t['lanes']} live candidate lanes, {n_src} "
          f"source and {n_query} query particles); picks exact, max_abs_err "
          f"{t['err']:.3e}", flush=True)
    return t, out, qsel, valid


def phase_kernels(scheme, scene, label, timings):
    """Kernels against twins at this scene's main-path shapes (with
    seeded random velocities so the picked u/v/w are not all zero); in
    3D, K2 also on every interesting row, as the 3D path runs it once
    its overflow rebuilds have raised ``ni_max``."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    from rigid_body_2d_3d_pysph_tpu_torch.ops import pack_expand as tpe
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    cfg = scheme.cell_config(scene, kernel)
    gen = torch.Generator(device=scene.device).manual_seed(7)
    rnd = lambda: torch.rand(scene.n, generator=gen, device=scene.device) - 0.5
    vel = dict(u=rnd(), v=rnd())
    if scheme.dim == 3:
        vel["w"] = rnd()
    scene = scene.replace(**vel)
    S = scene.meta.total_no_bodies
    two_d = scheme.dim == 2
    init = 4.0 * scene.meta.spacing0

    grid, pt, dfT = tck.pack_scene(scene, cfg)
    sent = torch.tensor(tck.sent_fields(two_d), device=scene.device)
    k1_args = (pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)
    ref = tpe.expand_slots_reference(*k1_args)
    torch.cuda.synchronize()
    k1_err = float((dfT - ref).abs().max())
    check(torch.equal(dfT, ref), f"{label}: pack expansion != twin")
    print(f"[kernels] {label}: NC={cfg.NC_max} M={cfg.M} O={cfg.O} "
          f"F={dfT.shape[1]} S={S} | pack max_abs_err={k1_err}", flush=True)

    k2, culled, qsel, valid = contact_rows(dfT, grid, pt, cfg, kernel, S,
                                           init, scheme.ni_max(cfg), label)
    # the every-slot launch (the cell pipeline's) at the culled rows: the
    # same output bit for bit
    every = tck.contact_sums(dfT, torch.arange(cfg.NC_max, device=dfT.device),
                             grid.nbr_slots, S, cfg.radius, init, kernel)
    torch.cuda.synchronize()
    check(torch.equal(culled[valid], every[qsel[valid]]),
          f"{label}: K2 on every slot != K2 on the culled rows")
    del every, culled
    t = dict(
        pack_ms=cuda_ms(lambda: tpe.expand_slots(*k1_args)),
        pack_plain_ms=cuda_ms(lambda: tpe.expand_slots_reference(*k1_args)),
        contact_ms=k2["ms"], contact_plain_ms=k2["plain_ms"],
        contact_bound=k2["bound"], contact_bound_by=k2["bound_by"],
        pack_err=k1_err, contact_err=k2["err"])
    t["pack_bound"], t["pack_bound_by"] = bound(
        nbytes(pt.sorted_fields, pt.base, pt.cnt, sent, dfT), 0)
    if not two_d:
        k2all, _, _, _ = contact_rows(
            dfT, grid, pt, cfg, kernel, S, init,
            max(scheme.ni_max(cfg), k2["n_int"]), f"{label} all rows")
        t.update(contact_all_rows_ms=k2all["ms"],
                 contact_all_rows_plain_ms=k2all["plain_ms"],
                 contact_all_rows_bound=k2all["bound"],
                 contact_all_rows_bound_by=k2all["bound_by"],
                 contact_all_rows=k2all["rows"],
                 contact_err=max(k2["err"], k2all["err"]))
    print(f"[kernels] {label}: pack {t['pack_ms']:.4f} ms "
          f"(plain {t['pack_plain_ms']:.4f} ms, bound "
          f"{t['pack_bound']:.4f} ms by {t['pack_bound_by']})", flush=True)
    timings[label] = t


def phase_main_path(scheme, scene, dx, smi, label="main"):
    from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    step = scheme.make_step(scene)
    xcm0 = scene.xcm.clone()
    _build.reset_launches()
    steps_run = done = rebuilds = 0
    chunk_s, n_int, lanes = [], [], []
    while done < N_STEPS:
        chunk_start = scene
        cfg = scheme.cell_config(scene, kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = []
        for _ in range(CHUNK):
            scene = step(scene, DT)
            stats.append(scene.n_interesting)
        torch.cuda.synchronize()
        el = time.perf_counter() - t0
        steps_run += CHUNK
        if bool(scene.nbr_overflow):
            # the reference Solver's rule: re-size from the chunk's start
            # state (1.5x slack from the second try on) and re-run it
            rebuilds += 1
            check(rebuilds <= 8, "overflow persists after 8 rebuilds")
            scheme.refresh_configs(chunk_start, grow=rebuilds > 1)
            chunk_start = scheme.adapt_scene(chunk_start)
            step = scheme.make_step(chunk_start)
            scene = chunk_start
            cfg = scheme.cell_config(scene, kernel)
            print(f"[{label}] step {done}: capacity overflow, rebuilt "
                  f"(x{rebuilds}, boost {scheme.capacity_boost:.2f}, "
                  f"ni_max {scheme.ni_max(cfg)}, NC {cfg.NC_max}, O "
                  f"{cfg.O})", flush=True)
            continue
        rebuilds = 0
        done += CHUNK
        ni = torch.stack(stats).cpu().numpy()
        n_int.append(ni)
        lanes.append(ni * cfg.M * cfg.O * cfg.M)
        chunk_s.append(el)
        ov = float(scheme.export_scene(scene).overlap.max())
        print(f"[{label}] steps {done - CHUNK}-{done}: {el:.3f} s, interesting "
              f"slots {ni.min()}-{ni.max()}, max overlap {ov:.3e}",
              flush=True)

    n_int = np.concatenate(n_int)
    lanes = np.concatenate(lanes)
    launches = dict(_build.LAUNCHES)
    check(launches["pack_expand"] == steps_run,
          f"pack kernel launched {launches['pack_expand']} times in "
          f"{steps_run} steps")
    check(launches["contact"] == steps_run,
          f"contact kernel launched {launches['contact']} times in "
          f"{steps_run} steps")
    check(bool((n_int > 0).all()), "a step had no interesting slot")
    full = scheme.export_scene(scene)
    max_overlap = float(full.overlap.max())
    check(max_overlap > 0, "no overlap: the contact kernel did no work")
    for k, v in full.fields.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"non-finite field {k}")
    check(not bool(scene.nbr_overflow), "overflow at the end")
    dim = scheme.dim
    drift = float((scene.xcm[:, :dim] - xcm0[:, :dim]).norm(dim=1).max())
    check(drift < 2 * dx, f"COM drift {drift:.3e} >= 2 dx = {2 * dx:.3e}")
    # static stack: with no contact force every block would have dropped
    # the free-fall distance g t^2 / 2 (GTVF is exact for constant force);
    # resting, none may have dropped half of it
    fall = 0.5 * G * (done * DT) ** 2
    drop = float((xcm0[:, 1] - scene.xcm[:, 1]).max())
    check(drop < 0.5 * fall, f"a block dropped {drop:.3e}, >= half the "
          f"free-fall distance {fall:.3e}: the stack is not carried")
    steady = chunk_s[1:] or chunk_s
    sps = CHUNK * len(steady) / sum(steady)
    print(f"[{label}] n={scene.n} dx={dx:.6g} steps={done} (run {steps_run}) "
          f"launches pack={launches['pack_expand']} "
          f"contact={launches['contact']} | interesting slots/step "
          f"min {n_int.min()} mean {n_int.mean():.1f} max {n_int.max()} | "
          f"candidate lanes/step mean {lanes.mean():.4g} | max overlap "
          f"{max_overlap:.4e} ({max_overlap / dx:.3f} dx) | max COM drift "
          f"{drift:.4e} ({drift / dx:.3f} dx) | max drop {drop:.4e} "
          f"(free fall {fall:.4e})", flush=True)
    cfg = scheme.cell_config(scene, kernel)
    print(f"[{label}] final config: ni_max {scheme.ni_max(cfg)}, NC "
          f"{cfg.NC_max}, O {cfg.O}, capacity boost "
          f"{scheme.capacity_boost:.4g}", flush=True)
    print(f"[{label}] {sps:.2f} steps/s steady (chunks 2+), "
          f"{CHUNK * len(chunk_s) / sum(chunk_s):.2f} steps/s all chunks, "
          f"on {smi}", flush=True)
    return scene, launches, dict(steps_per_s=sps, n=scene.n)


def phase_step_parity(scheme, scene):
    from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    cfg = scheme.cell_config(scene, kernel)
    params = dict(kr=scheme.kr, kf=scheme.kf, fric_coeff=scheme.fric_coeff,
                  gx=scheme.gx, gy=scheme.gy, gz=scheme.gz)
    fast = trb.make_multi_step(scheme.make_step(scene), COMPARE_STEPS)
    plain = trb.make_multi_step(trb.build_rigid_gtvf_step_cell(
        kernel, cfg, params, scheme.two_d, scheme.ni_max(cfg), plain=True),
        COMPARE_STEPS)
    a, b = fast(scene, DT), plain(scene, DT)
    torch.cuda.synchronize()
    check(not bool(a.nbr_overflow) and not bool(b.nbr_overflow),
          "overflow during the step comparison")
    worst = []
    for k in ("xcm", "vcm", "omega", "fx", "fy") + (
            () if scheme.two_d else ("fz",)):
        x, y = a[k], b[k]
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        ok = bool(((x - y).abs() <= STEP_RTOL * y.abs()
                   + STEP_RTOL * scale).all())
        worst.append(f"{k} {err:.3e} (scale {scale:.3e})")
        check(ok, f"kernel step vs twin step: {k} off by {err:.3e} "
                  f"(scale {scale:.3e}, rtol {STEP_RTOL})")
    print(f"[parity] {scheme.dim}D: {COMPARE_STEPS} kernel steps vs "
          f"{COMPARE_STEPS} twin "
          f"steps, max abs diff: " + ", ".join(worst), flush=True)


# ---------------------------------------------------------------------------
# DEM
# ---------------------------------------------------------------------------

def dem_scene(dev, dim, grid="spill", n_target=100_000):
    """The bench's granular column over a floor (``bench.py``
    ``build_dem_scene`` / ``build_dem_scene_3d`` geometry at ~n_target
    grains) with grains spaced DEM_SPACING: every lattice neighbour and
    the floor under the lowest row overlap by 0.01 r at step 0."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import get_2d_block
    from rigid_body_2d_3d_pysph_tpu_torch.models import DEMScheme
    from rigid_body_2d_3d_pysph_tpu_torch.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY)

    r, s, rho = DEM_R, DEM_SPACING, 2600.0
    if dim == 2:
        k = np.sqrt(n_target / 1130.0) * s / 2.1e-3
        w, h = 0.05 * k, 0.1 * k
        xg, yg = get_2d_block(s, w, h)
        zg = np.zeros_like(xg)
        m = rho * np.pi * r**2
        xf = np.arange(-3.5 * h, 3.5 * h, 2 * r)
        zf = np.zeros_like(xf)
    else:
        k = (n_target / ((0.05 * 0.1 * 0.05) / s**3)) ** (1.0 / 3.0)
        w, h, d = 0.05 * k, 0.1 * k, 0.05 * k
        xg, yg, zg = (a.ravel() for a in np.meshgrid(
            np.arange(0.0, w, s), np.arange(0.0, h, s), np.arange(0.0, d, s)))
        m = rho * (4.0 / 3.0) * np.pi * r**3
        xf, zf = (a.ravel() for a in np.meshgrid(
            np.arange(-1.5 * w, 2.5 * w, 2 * r),
            np.arange(-1.5 * d, 2.5 * d, 2 * r)))
    yg = yg - yg.min() + (s - r)        # floor centres at -r
    grains = make_group("sand", xg, yg, z=zg, m=m, h=2 * r, rho=rho,
                        rad_s=r, role=ROLE_RIGID,
                        body_id=np.arange(len(xg), dtype=np.int32), dem_id=0)
    floor = make_group("floor", xf, np.full(len(xf), -r), z=zf, m=m,
                       h=2 * r, rho=rho, rad_s=r, role=ROLE_BOUNDARY,
                       dem_id=1)
    scene = build_scene([grains, floor], dim=dim, total_no_bodies=2,
                        spacing0=s, device=dev, dtype=config.WORK_DTYPE)
    scheme = DEMScheme(["sand"], ["floor"], kn=1e5, en=0.5, mu=0.5,
                       dim=dim, gy=-9.81, max_tng_contacts_limit=8,
                       dem_grid=grid)
    return scheme, scheme.setup(scene)


def dem_kernel_call(scheme, scene, cfg, tables):
    """The DEM kernel wrapper, its twin and their arguments for ``scene``
    with the contact ``tables`` (idx, dem, sx, sy, sz in particle order),
    built as the main path builds them; also the grid and the candidate
    lanes."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_cell as tdc
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
    from rigid_body_2d_3d_pysph_tpu_torch.ops import pack_expand as tpe
    from rigid_body_2d_3d_pysph_tpu_torch.ops.cellpairs import (
        build_cell_grid_packed)
    from rigid_body_2d_3d_pysph_tpu_torch.ops.rowwin import (
        build_row_window_grid)

    mat = tdk.material_table(scene)
    sent = torch.tensor(tdc.SENT, device=scene.device)
    spill = scheme.dem_grid == "spill"
    build = build_cell_grid_packed if spill else build_row_window_grid
    grid, pt = build(scene.x, scene.y, scene.z, scene.active, cfg,
                     tdk.dem_payload(scene))
    pack = tpe.expand_slots(pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)
    if spill:
        args = (pack, grid.nbr_slots, *tables, mat, DEM_DT, cfg)
        return (tdk.dem_cell_sums, tdk.dem_cell_sums_reference, args, grid,
                slot_lanes(pt.cnt, grid.nbr_slots))
    args = (pack, grid.nbr_runs, grid.run_cnt, *tables, mat, DEM_DT, cfg)
    lanes = slot_lanes(pt.cnt, tdk.rowwin_sources(grid.nbr_runs,
                                                  grid.run_cnt, cfg))
    return (tdk.dem_rowwin_sums, tdk.dem_rowwin_sums_reference, args, grid,
            lanes)


def dem_compare(got, ref, label):
    """Kernel output against twin output (sums [N, 8], idx, dem, sx, sy,
    sz [N, L]): table idx, dem, slot positions and counts bit for bit,
    sums and springs within tolerance.  Returns (sums max abs error,
    springs max abs error)."""
    for a in got:
        check(bool(torch.isfinite(a.float()).all()),
              f"{label}: non-finite kernel output")
    for a, b in ((got[0][:, 6:], ref[0][:, 6:]), (got[1], ref[1]),
                 (got[2], ref[2])):
        check(torch.equal(a, b), f"{label}: tables or counts != twin "
              f"({int((a != b).sum())} entries differ)")
    a, b = got[0][:, :6], ref[0][:, :6]
    err = float((a - b).abs().max())
    tol = DEM_SUM_RTOL * b.abs() + DEM_SUM_RTOL * float(b.abs().max())
    check(bool(((a - b).abs() <= tol).all()),
          f"{label}: force/torque sums off by {err:.3e}")
    spring_err = 0.0
    for a, b in zip(got[3:], ref[3:]):
        d = (a - b).abs()
        spring_err = max(spring_err, float(d.max()))
        check(bool((d <= DEM_SPRING_RTOL * b.abs()).all()),
              f"{label}: springs off by {float(d.max()):.3e}")
    return err, spring_err


def phase_dem_kernels(scheme, scene, label, timings, crowded=False):
    """A DEM kernel against its twin at the main path's shapes, with
    seeded random velocities and spins, on three contact tables: the
    setup's empty one (every contact is allocated), one filled by a twin
    pass at the same positions (the timed case: the main path's steady
    state), and one advanced by a twin pass at positions jittered by up
    to an overlap, then met at positions jittered again (contacts open
    and close: slots are freed and reallocated).  ``crowded`` adds the
    column at DEM_CROWD of its spacing (its own grid), met the same way
    as the moved table: full tables, new contacts beyond the free slots
    dropped."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(11)
    rnd = lambda a: (torch.rand(scene.n, generator=gen, device=dev) - 0.5) * a
    vel = dict(u=rnd(0.1), v=rnd(0.1), wz=rnd(100.0))
    if scheme.dim == 3:
        vel.update(w=rnd(0.1), wx=rnd(100.0), wy=rnd(100.0))
    scene = scene.replace(**vel)
    axes = ("x", "y", "z")[:scheme.dim]
    jitter = lambda sc: sc.replace(
        **{k: sc[k] + rnd(2 * DEM_OVERLAP) for k in axes})
    spill = scheme.dem_grid == "spill"
    config = lambda sch, sc: (sch.cell_config(sc) if spill
                              else sch.rowwin_config(sc))
    cfg = config(scheme, scene)
    run = (tdk.lvc_displacement_cell_kernel if spill
           else tdk.lvc_displacement_rowwin_kernel)

    def twin_pass(sc, tables, cfg=cfg):
        p = run(sc, cfg, DEM_DT, *tables, plain=True)
        check(not bool(p.overflow), f"{label}: grid overflow")
        return (p.tng_idx, p.tng_dem, p.tng_x, p.tng_y, p.tng_z)

    empty = (scene.tng_idx, scene.tng_idx_dem_id, scene.tng_x, scene.tng_y,
             scene.tng_z)
    filled = twin_pass(scene, empty)
    cases = [("empty", scene, empty, cfg), ("filled", scene, filled, cfg),
             ("moved", jitter(scene), twin_pass(jitter(scene), filled), cfg)]
    if crowded:
        # the grains squeezed towards the column's lowest corner (the
        # floor stays), on a grid sized for them with bins of the contact
        # radius (the default spill bins would need more than max_spill
        # slots a cell)
        sand = scene.meta.group("sand")
        mob = torch.zeros(scene.n, dtype=torch.bool, device=dev)
        mob[sand.start:sand.stop] = True
        lo = {k: scene[k][sand.start:sand.stop].min() for k in axes}
        crowd = scene.replace(**{k: torch.where(
            mob, lo[k] + DEM_CROWD * (scene[k] - lo[k]), scene[k])
            for k in axes})
        cscheme = copy.copy(scheme)
        cscheme.cell_factor = 1.0
        cscheme.refresh_configs(crowd)
        ccfg = config(cscheme, crowd)
        cases.append(("crowded", jitter(crowd),
                      twin_pass(jitter(crowd), empty, ccfg), ccfg))
    L = empty[0].shape[1]
    errs, lines = [], []
    for case, sc, tables, ccfg in cases:
        kern, plain, args, grid, lanes = dem_kernel_call(scheme, sc, ccfg,
                                                         tables)
        check(not bool(grid.overflow), f"{label} {case}: grid overflow")
        got = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err, spring_err = dem_compare(got, ref, f"{label} {case}")
        errs += [err, spring_err]
        gated_i, live_i = ref[0][:, 7], ref[0][:, 6]
        gated, live = int(gated_i.sum()), int(live_i.sum())
        check(gated > 0 and live > 0, f"{label} {case}: no contact")
        # table changes in particle order: a slot whose (idx, dem) the
        # pass changed was freed if it held a contact, allocated if it
        # holds one now
        changed = (ref[1] != tables[0]) | (ref[2] != tables[1])
        n_alloc = int((changed & (ref[1] >= 0)).sum())
        n_free = int((changed & (tables[0] >= 0)).sum())
        if case == "empty":
            check(n_alloc == live, f"{label} empty: {n_alloc} allocations "
                  f"for {live} live entries")
        if case in ("moved", "crowded"):
            check(n_alloc > 0 and n_free > 0, f"{label} {case}: {n_alloc} "
                  f"allocations, {n_free} frees")
        extra = ""
        if case == "crowded":
            n_over = int((gated_i > L).sum())
            n_full = int((live_i == L).sum())
            check(n_over > 0 and n_full > 0, f"{label} crowded: {n_over} "
                  f"grains with more than {L} gated partners, {n_full} "
                  "full tables")
            extra = (f" ({n_over} grains over {L} gated, {n_full} full "
                     f"tables, max {int(gated_i.max())} gated, "
                     f"{lanes} candidate lanes)")
        lines.append(f"{case}: {live} live, {n_alloc} allocated, {n_free} "
                     f"freed, {gated} gated{extra}, sums {err:.3e}, springs "
                     f"{spring_err:.3e}")
        if case == "filled":
            timed = (kern, plain, args, lanes, gated)
    kern, plain, args, lanes, gated = timed
    if spill:
        shape = f"NC={cfg.NC_max} M={cfg.M} O={cfg.O}"
    else:
        shape = f"NCW={cfg.NC_max} M={cfg.M} R={cfg.R} max_run={cfg.max_run}"
    # least time: each particle's 13 source fields and its table row
    # (idx, dem, sx, sy, sz: 5L words) read once, its 8 sums and its
    # table row written once (the pack's sentinel lanes and the stencil
    # are layout, not work); 9 f32 ops per candidate lane and the LVC
    # body per gated pair
    n_bytes = 4 * scene.n * (tdk.NF + 8 + 2 * 5 * L)
    n_ops = lanes * OPS_PER_LANE + gated * OPS_PER_DEM_PAIR
    bms, bby = bound(n_bytes, n_ops)
    t = dict(ms=cuda_ms(lambda: kern(*args)),
             plain_ms=cuda_ms(lambda: plain(*args), reps=3, warmup=1),
             err=max(errs), bound_ms=bms, bound_by=bby)
    print(f"[dem-kernels] {label}: n={scene.n} {shape} L={L} | tables, "
          f"slots and counts exact on every table; max abs errors | "
          + " | ".join(lines), flush=True)
    print(f"[dem-kernels] {label}: filled table, candidate lanes {lanes} | "
          f"kernel {t['ms']:.4f} ms, twin {t['plain_ms']:.4f} ms, bound "
          f"{bms:.4f} ms by {bby} ({n_bytes} bytes, {n_ops} ops)",
          flush=True)
    timings[label] = t


def table_overlap_max(scene):
    """Largest overlap among the live contact-table pairs."""
    live = scene.tng_idx >= 0
    j = torch.clamp(scene.tng_idx, min=0).long()
    d = [scene[k][:, None] - scene[k][j] for k in ("x", "y", "z")]
    rij = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    ov = scene.rad_s[:, None] + scene.rad_s[j] - rij
    return float(torch.where(live, ov, torch.zeros_like(ov)).max())


def phase_dem_main(scheme, scene, n_steps, label, smi):
    """The DEM step through its entry points, in chunks with the
    overflow-rebuild rule; returns (end scene, launches, steps/s)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    spill = scheme.dem_grid == "spill"
    kname = "dem_cell" if spill else "dem_rowwin"
    step = scheme.make_step(scene)
    sand = scene.meta.group("sand")
    floor = scene.meta.group("floor")
    floor_top = float((scene.y + scene.rad_s)[floor.start:floor.stop].max())
    _build.reset_launches()
    steps_run = done = rebuilds = 0
    chunk_s, lives, gateds = [], [], []
    while done < n_steps:
        chunk_start = scene
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live, gated = [], []
        for _ in range(CHUNK):
            scene = step(scene, DEM_DT)
            live.append(scene.total_tng_contacts.sum())
            gated.append(scene.n_gated)
        torch.cuda.synchronize()
        el = time.perf_counter() - t0
        steps_run += CHUNK
        if bool(scene.nbr_overflow):
            rebuilds += 1
            check(rebuilds <= 8, f"{label}: overflow persists after 8 "
                  "rebuilds")
            scheme.refresh_configs(chunk_start, grow=rebuilds > 1)
            step = scheme.make_step(chunk_start)
            scene = chunk_start
            print(f"[{label}] step {done}: capacity overflow, rebuilt "
                  f"(x{rebuilds}, boost {scheme.capacity_boost:.2f})",
                  flush=True)
            continue
        rebuilds = 0
        done += CHUNK
        lv = torch.stack(live).cpu().numpy()
        gt = torch.stack(gated).cpu().numpy()
        lives.append(lv)
        gateds.append(gt)
        chunk_s.append(el)
        print(f"[{label}] steps {done - CHUNK}-{done}: {el:.3f} s, live "
              f"table entries {lv.min()}-{lv.max()}, gated pairs/step "
              f"{gt.min()}-{gt.max()}", flush=True)
    launches = dict(_build.LAUNCHES)
    lv, gt = np.concatenate(lives), np.concatenate(gateds)
    check(launches[kname] == steps_run, f"{label}: {kname} launched "
          f"{launches[kname]} times in {steps_run} steps")
    check(launches["pack_expand"] == steps_run, f"{label}: pack_expand "
          f"launched {launches['pack_expand']} times in {steps_run} steps")
    check(bool((lv > 0).all()), f"{label}: a step had no live contact")
    for k, v in scene.fields.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{label}: non-finite {k}")
    check(not bool(scene.nbr_overflow), f"{label}: overflow at the end")
    bottom = float((scene.y - scene.rad_s)[sand.start:sand.stop].min())
    check(bottom > floor_top - DEM_R, f"{label}: a grain's bottom "
          f"{bottom:.4e} is more than r below the floor's top {floor_top:.4e}")
    ov = table_overlap_max(scene)
    check(0 < ov < 0.1 * DEM_R, f"{label}: max overlap {ov:.3e} not in "
          f"(0, 0.1 r)")
    steady = chunk_s[1:] or chunk_s
    sps = CHUNK * len(steady) / sum(steady)
    print(f"[{label}] n={scene.n} ({sand.stop - sand.start} grains) "
          f"steps={done} (run {steps_run}) launches {kname}="
          f"{launches[kname]} pack_expand={launches['pack_expand']} | live "
          f"entries/step min {lv.min()} mean {lv.mean():.1f} | gated "
          f"pairs/step mean {gt.mean():.1f} | max overlap {ov:.4e} "
          f"({ov / DEM_R:.4f} r) | lowest grain bottom {bottom:.4e} "
          f"(floor top {floor_top:.4e})", flush=True)
    print(f"[{label}] {sps:.2f} steps/s steady (chunks 2+), "
          f"{CHUNK * len(chunk_s) / sum(chunk_s):.2f} steps/s all chunks, "
          f"on {smi}", flush=True)
    return scene, launches, sps


def _sorted_tables(scene):
    """Per row, the table's (idx, dem) keys and springs sorted by key."""
    key = torch.where(scene.tng_idx >= 0,
                      scene.tng_idx.long() * 8 + scene.tng_idx_dem_id.long(),
                      torch.full_like(scene.tng_idx, 2**62, dtype=torch.long))
    key, order = torch.sort(key, 1)
    spr = torch.stack([torch.gather(scene[k], 1, order)
                       for k in ("tng_x", "tng_y", "tng_z")])
    return key, spr


def phase_dem_parity(scheme, scene):
    """20 kernel steps against 20 twin steps from one state."""
    fast = scheme.make_step(scene)
    plain = scheme.make_step(scene, plain=True)
    a = b = scene
    for _ in range(COMPARE_STEPS):
        a, b = fast(a, DEM_DT), plain(b, DEM_DT)
    torch.cuda.synchronize()
    check(not bool(a.nbr_overflow) and not bool(b.nbr_overflow),
          "overflow during the DEM step comparison")
    worst = []
    for k in ("x", "y", "u", "v", "wz", "fx", "fy", "torz"):
        # positions as displacements over the run, so the tolerance is on
        # the motion and not on the domain's size
        x = a[k] - scene[k] if k in ("x", "y") else a[k]
        y = b[k] - scene[k] if k in ("x", "y") else b[k]
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        worst.append(f"{k} {err:.3e} (scale {scale:.3e})")
        check(bool(((x - y).abs() <= STEP_RTOL * y.abs()
                    + STEP_RTOL * scale).all()),
              f"DEM kernel step vs twin step: {k} off by {err:.3e} "
              f"(scale {scale:.3e}, rtol {STEP_RTOL})")
    ka, sa = _sorted_tables(a)
    kb, sb = _sorted_tables(b)
    rows = int((ka != kb).any(1).sum())
    check(rows == 0, f"DEM kernel vs twin step: {rows} rows hold other "
          "contacts")
    d = (sa - sb).abs()
    check(bool((d <= STEP_RTOL * sb.abs()
                + STEP_RTOL * float(sb.abs().max())).all()),
          f"DEM kernel vs twin step: springs off by {float(d.max()):.3e}")
    print(f"[dem-parity] {COMPARE_STEPS} kernel steps vs {COMPARE_STEPS} "
          f"twin steps: contact tables equal as (idx, dem) -> spring maps "
          f"(springs max abs diff {float(d.max()):.3e}), max abs diff: "
          + ", ".join(worst), flush=True)


# ---------------------------------------------------------------------------
# rigid-fluid coupling
# ---------------------------------------------------------------------------

def sinking_box_scene(dev, n_target=CPL_N, floor=False, body=True,
                      rho_b=2.0):
    """``cases/rigid_body_rotating_and_sinking_in_tank_2d.py`` built with
    the port's geometry at bench.py's coupling size: a 4 x 3 fluid block
    in a 3-layer tank, a 1 x 0.5 box (rho 2) at the surface with the
    fluid void carved under it, hydrostatic pressure, the box's
    displaced-fluid shadow mass and density.  ``floor`` rests the box
    GAP dx above the tank floor's top layer instead; ``body=False``
    leaves it out (the hydrostatic tank); ``rho_b`` is the box's
    density.  Returns (scheme, scene, dt)."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import (
        get_2d_block, hydrostatic_tank_2d)
    from rigid_body_2d_3d_pysph_tpu_torch.models import (
        RigidFluidCouplingScheme)
    from rigid_body_2d_3d_pysph_tpu_torch.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY, ROLE_FLUID)

    dx = 0.02 * np.sqrt(33_000.0 / max(n_target, 2000))
    L, rho_f, gy = 1.0, 1.0, -1.0
    h = dx                                      # hdx = 1
    co = 10 * np.sqrt(2 * 9.81 * 3.0 * L)
    xf, yf, xt, yt = hydrostatic_tank_2d(4.0 * L, 3.0 * L, 5.0 * L, 3, dx, dx)
    p0 = -rho_f * gy * (yf.max() - yf)
    groups = [make_group("tank", xt, yt, m=rho_f * dx**2, h=h, rho=rho_f,
                         rad_s=dx / 2.0, role=ROLE_BOUNDARY, dem_id=1)]
    if body:
        xb, yb = get_2d_block(dx, L - dx, 0.5 * L - dx)
        xb -= xb.min() - xf.min()
        xb += 1.5 * L
        if floor:                   # the floor's top layer is at y = -dx
            yb += (-dx + GAP * dx) - yb.min()
        else:
            yb += yf.max() - yb.min() + dx
            yb -= 0.25 * L + dx / 2.0
        keep = ~((xf > xb.min() - dx) & (xf < xb.max() + dx)
                 & (yf > yb.min() - dx) & (yf < yb.max() + dx))
        xf, yf, p0 = xf[keep], yf[keep], p0[keep]
        groups.append(make_group(
            "body", xb, yb, m=rho_b * dx**2, h=h, rho=rho_b, rad_s=dx / 2.0,
            role=ROLE_RIGID, body_id=np.zeros(len(xb), np.int32),
            dem_id=np.zeros(len(xb), np.int32)))
    groups.insert(0, make_group("fluid", xf, yf, m=rho_f * dx**2, h=h,
                                rho=rho_f, role=ROLE_FLUID, p=p0))
    scene = build_scene(groups, dim=2, total_no_bodies=2, spacing0=dx,
                        device=dev, dtype=config.WORK_DTYPE)
    scheme = RigidFluidCouplingScheme(
        ["fluid"], ["tank"], ["body"] if body else [], dim=2, rho0=rho_f,
        p0=rho_f * co**2, c0=co, h=h, nu=0.0, gy=gy)
    scene = scheme.setup(scene)
    if body:
        rb = scene.is_rigid
        scene = scene.replace(
            m_fsi=torch.where(rb, scene.m_fsi + rho_f * dx**2, scene.m_fsi),
            rho_fsi=torch.where(rb, rho_f, scene.rho_fsi))
    return scheme, scene, 0.25 * dx / (co * 1.1)


def fluid_pass_work(dfT, nbr, cnt, cutoff, chunk=2048):
    """The work of the coupling passes' bodies on the pack ``dfT`` over
    the stencil rows ``nbr`` (``cnt`` live lanes per slot), by the classes
    each body runs on: the candidate lanes scanned by the query lanes of
    each destination class (``lanes_<classes>``), and the pairs in range
    by (destination, source) class: ``fl_flbd`` fluid <- fluid or wall,
    ``fl_rg`` fluid <- body, ``fl_fl`` fluid <- fluid (``visc`` those
    approaching), ``solid_fl`` wall or body <- fluid, ``rg_fl`` body <-
    fluid; ``in_range`` every live pair, ``gated`` the contact gate's."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk

    NC, O = nbr.shape
    M = dfT.shape[2]
    _, _, sb, fl, rg = (c == 1.0 for c in
                        fk.decode_flags(dfT[:NC, fk.FFLAGS]))
    ext = torch.cat([cnt, cnt.new_zeros(1)])
    src_lanes = ext[torch.clamp(nbr, 0, NC)].sum(1)
    lanes = lambda q: int((q.sum(1) * src_lanes).sum())
    work = dict(lanes_fluid=lanes(fl), lanes_solid=lanes(sb | rg),
                lanes_fluid_solid=lanes(fl | sb | rg),
                lanes_fluid_rigid=lanes(fl | rg))
    work.update(dict.fromkeys(("in_range", "gated", "fl_flbd", "fl_rg",
                               "fl_fl", "visc", "solid_fl", "rg_fl"), 0))
    for c0 in range(0, NC, chunk):
        nb = nbr[c0:c0 + chunk]
        B = nb.shape[0]
        q = dfT[c0:c0 + B]
        src = dfT[nb].permute(0, 2, 1, 3).reshape(B, dfT.shape[1], O * M)
        d = [q[:, f, :, None] - src[:, f, None, :] for f in
             (fk.FX, fk.FY, fk.FZ, fk.FU, fk.FV, fk.FW)]
        live = (q[:, fk.FFLAGS, :, None] != -16.0) & \
            (src[:, fk.FFLAGS, None] != -16.0)
        near = live & (torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
                       <= cutoff)
        q_dem, _, q_sb, q_fl, q_rg = fk.decode_flags(q[:, fk.FFLAGS, :, None])
        s_dem, s_cfib, s_sb, s_fl, s_rg = fk.decode_flags(
            src[:, fk.FFLAGS, None])
        qf, qr = q_fl == 1.0, q_rg == 1.0
        sf = s_fl == 1.0
        approach = d[3] * d[0] + d[4] * d[1] + d[5] * d[2] < 0.0
        for k, m in (("in_range", near),
                     ("gated", qr & (s_cfib == 1.0) & ~sf & (s_dem != q_dem)),
                     ("fl_flbd", qf & (sf | (s_sb == 1.0))),
                     ("fl_rg", qf & (s_rg == 1.0)), ("fl_fl", qf & sf),
                     ("visc", qf & sf & approach),
                     ("solid_fl", ((q_sb == 1.0) | qr) & sf),
                     ("rg_fl", qr & sf)):
            work[k] += int((near & m).sum())
    return work


def fluid_pass_cost(work, name, n_live, edac=True, has_rigid=True,
                    visc=True, width=0):
    """(bytes, f32 operations) the pass ``name`` needs on this data: the
    pack fields it reads and its ``width`` outputs per live lane once,
    and the operations on the candidate lanes of its destination classes
    and on the pairs its bodies run on (``fluid_pass_work``)."""
    w = work
    rates = w["fl_flbd"] + (w["fl_rg"] if has_rigid else 0)
    rates_ops = rates * (OPS_PAIR_HEAD + OPS_GRADW + OPS_CONTINUITY
                         + (OPS_EDAC if edac else 0))
    wall_ops = w["solid_fl"] * (OPS_PAIR_HEAD + OPS_W + OPS_WALL)
    force_ops = rates * (OPS_PAIR_HEAD + OPS_GRADW + OPS_PGRAD)
    if visc:
        force_ops += w["fl_fl"] * OPS_VISC_TEST + w["visc"] * OPS_VISC
    if has_rigid:
        force_ops += w["rg_fl"] * (OPS_PAIR_HEAD + OPS_GRADW + OPS_FSI)
    # fields read: x y z u v w m rho h p flags, and m_fsi rho_fsi p_fsi
    # with bodies; B6a reads p and p_fsi only for EDAC, B6b no m
    fsi = 3 if has_rigid else 0
    rates_fields = 11 + fsi - (0 if edac else 1 + (fsi > 0))
    lanes, ops, fields = {
        "fluid_rates": ("lanes_fluid", rates_ops, rates_fields),
        "wall_bc": ("lanes_solid", wall_ops, 10),
        "fluid_rates_wall": ("lanes_fluid_solid", rates_ops + wall_ops,
                             11 + fsi),
        "fluid_forces": ("lanes_fluid_rigid" if has_rigid else
                         "lanes_fluid", force_ops, 11 + fsi),
        "fluid_forces_contact": ("lanes_fluid_rigid", force_ops
                                 + w["gated"] * OPS_PER_CONTACT_PAIR,
                                 11 + fsi),
    }[name]
    return 4 * n_live * (fields + width), w[lanes] * OPS_PER_LANE + ops


def kernel_resources(template, args, helper, t):
    """ptxas's registers, static shared memory and spills of the
    ``csrc/fluid.cu`` instance ``template<args>`` (bools and ints), and
    the dynamic shared memory a block takes (the C entry ``helper``) at
    the lanes a slot and output columns of the timed pass ``t``."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    key = template + "I" + "".join(
        f"Lb{int(a)}E" if isinstance(a, bool) else f"Li{a}E"
        for a in args) + "E"
    usage = [u for e, u in _build.ptxas_usage(
        _build.BUILD_LOG.get("fluid", "")).items() if key in e]
    u = usage[0] if usage else {}
    return dict(registers=u.get("registers"), smem_static=u.get("smem"),
                smem_dynamic_per_block=_build.load(helper)(t["M"],
                                                          t["width"]),
                spill_bytes=(u["spill_stores"] + u["spill_loads"]
                             if u else None))


def forces_resources(fsi, contact, t):
    """The 2D forces_kernel instance with viscosity (``fsi``,
    ``contact``): see ``kernel_resources``."""
    return kernel_resources("forces_kernel", (True, True, fsi, contact),
                            "fluid_forces_smem", t)


def rates_resources(edac, has_rigid, mode, t):
    """The 2D rates_wall_kernel instance (``edac``, ``has_rigid``, the
    columns ``mode``: 0 B4, 1 B6a, 2 B6b): see ``kernel_resources``."""
    return kernel_resources("rates_wall_kernel", (True, edac, has_rigid,
                                                  mode),
                            "fluid_rates_wall_smem", t)


def check_fluid_columns(got, ref, cols, label, floor=0.0):
    """Each column within FLUID_SUM_RTOL of its largest magnitude (at
    least ``floor``); returns the max abs error."""
    err = 0.0
    for c in cols:
        a, b = got[..., c], ref[..., c]
        scale = max(float(b.abs().max()), floor)
        e = float((a - b).abs().max())
        check(e <= FLUID_SUM_RTOL * scale, f"{label}: column {c} off by "
              f"{e:.3e} (scale {scale:.3e})")
        err = max(err, e)
    return err


def fluid_pass_checks(calls, dfT, nbr, pt, cutoff, S, init, visc, label,
                      timed):
    """Each pass of ``calls`` ({name: (kernel wrapper, twin, arguments,
    its name for the cost, EDAC, bodies)}) against its twin on the pack
    ``dfT``: finite, two launches bit for bit, not all zero, sums within
    FLUID_SUM_RTOL of each column's largest magnitude; for B5 the contact
    picks bit for bit, the unit contact normals within FLUID_SUM_RTOL
    absolute, the contact sums as K2's.  ``timed`` also times each and
    computes its bound.  Returns ({name: numbers}, the work counts, B5's
    contact slots with a pick or None)."""
    work = fluid_pass_work(dfT, nbr, pt.cnt, cutoff)
    n_live = int(pt.n_valid)
    out, n_found = {}, None
    for name, (fast, plain, args, cost_name, edac, bodies) in calls.items():
        got = fast(*args)
        again = fast(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{label} {name}: non-finite")
        check(torch.equal(got, again), f"{label} {name}: two launches on "
              "the same inputs differ")
        check(float(ref.abs().max()) > 0, f"{label} {name}: all zero")
        W = got.shape[-1]
        if cost_name == "fluid_forces_contact":
            picks = got[..., 5 * S:12 * S], ref[..., 5 * S:12 * S]
            check(torch.equal(*picks), f"{label} {name}: contact picks != "
                  f"twin (max {float((picks[0] - picks[1]).abs().max())})")
            n_found = int((ref[..., 5 * S:6 * S] < init).sum())
            # the contact normals are unit vectors; the sums K2's way
            err = check_fluid_columns(got, ref, range(3 * S), label + " " +
                                      name, floor=1.0)
            for c in (3, 4):
                a, b = got[..., c * S:(c + 1) * S], ref[..., c * S:(c + 1) * S]
                tol = SUM_RTOL * b.abs() + SUM_RTOL * float(b.abs().max())
                check(bool(((a - b).abs() <= tol).all()), f"{label} {name}: "
                      f"contact block {c} off by {float((a - b).abs().max())}")
            err = max(err, check_fluid_columns(got, ref, range(12 * S, W),
                                               label + " " + name))
            err = max(err, float((got[..., :5 * S] - ref[..., :5 * S])
                                 .abs().max()))
        else:
            err = check_fluid_columns(got, ref, range(W), label + " " + name)
        t = dict(err=err, M=got.shape[1], width=W)
        if timed:
            t["ms"] = cuda_ms(lambda: fast(*args))
            t["plain_ms"] = cuda_ms(lambda: plain(*args), reps=3, warmup=1)
            # least time: the fields read and W outputs per live lane
            # once; the f32 operations of this data's pairs
            t["bound_ms"], t["bound_by"] = bound(*fluid_pass_cost(
                work, cost_name, n_live, edac, bodies, visc, W))
        out[name] = t
    return out, work, n_found


def print_fluid_passes(tag, label, out):
    for k, v in out.items():
        if "ms" in v:
            print(f"[{tag}] {label}: {k} {v['ms']:.4f} ms (plain "
                  f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms by "
                  f"{v['bound_by']})", flush=True)


def fluid_scene_pack(scheme, scene, label, seed, p_fsi=False):
    """This scene's coupling pack with seeded random velocities (and body
    ``p_fsi``): (kernel, cfg, grid, pack tables, dfT, S, contact init
    distance)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    cfg = scheme.cell_config(scene, kernel)
    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda a: (torch.rand(scene.n, generator=gen, device=dev) - 0.5) * a
    vel = dict(u=rnd(0.2), v=rnd(0.2))
    if scheme.dim == 3:
        vel["w"] = rnd(0.2)
    if p_fsi:
        vel["p_fsi"] = torch.where(scene.is_rigid, rnd(2.0), scene.p_fsi)
    scene = scene.replace(**vel)
    grid, pt, dfT = fk.pack_fluid_sorted(scene, cfg)
    check(not bool(grid.overflow), f"{label}: grid overflow")
    return (kernel, cfg, grid, pt, dfT, scene.meta.total_no_bodies,
            4.0 * scene.meta.spacing0)


def fluid_calls(scheme, dfT, nbr, kernel, cutoff, S, init, names):
    """{name: (wrapper, twin, arguments, cost name, EDAC, bodies)} of the
    fluid passes ``names`` on this pack: B4 and B5 as the kdkf step runs
    them (B4 without bodies and B6c for the fluid-only tank), the split
    passes of the kdk and reference orderings (B6a with EDAC and with
    Tait, B6b, B6c with bodies)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk

    has_rigid = len(scheme.rigid_bodies) > 0
    base = (dfT, nbr, kernel, cutoff)
    nu, c0, g = scheme.edac_nu, scheme.c0, (scheme.gx, scheme.gy, scheme.gz)
    alpha = scheme.fluid_alpha
    every = dict(
        fluid_rates_wall=(fk.fluid_rates_wall, fk.fluid_rates_wall_reference,
                          base + (nu, c0, scheme.edac, has_rigid, g),
                          "fluid_rates_wall", scheme.edac, has_rigid),
        fluid_forces_contact=(fk.fluid_forces_contact,
                              fk.fluid_forces_contact_reference,
                              base + (alpha, c0, S, init),
                              "fluid_forces_contact", True, True),
        fluid_forces=(fk.fluid_forces, fk.fluid_forces_reference,
                      base + (alpha, c0), "fluid_forces", True, False),
        fluid_rates=(fk.fluid_rates, fk.fluid_rates_reference,
                     base + (nu, c0, True, True), "fluid_rates", True, True),
        fluid_rates_tait=(fk.fluid_rates, fk.fluid_rates_reference,
                          base + (nu, c0, False, True), "fluid_rates", False,
                          True),
        wall_bc=(fk.wall_bc, fk.wall_bc_reference, base + (g,), "wall_bc",
                 True, True),
        fluid_forces_rigid=(fk.fluid_forces, fk.fluid_forces_reference,
                            base + (alpha, c0, True), "fluid_forces", True,
                            True))
    return {k: every[k] for k in names}


def pack_expand_check(pt, dfT, cfg, label, timings):
    """K1 on this coupling pack (F = 14) against its twin, bit for bit,
    timed, with its bound."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk
    from rigid_body_2d_3d_pysph_tpu_torch.ops import pack_expand as tpe

    sent = torch.tensor(fk.SENT, dtype=dfT.dtype, device=dfT.device)
    args = (pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)
    ref = tpe.expand_slots_reference(*args)
    torch.cuda.synchronize()
    check(torch.equal(dfT, ref), f"{label}: pack expansion != twin")
    t = dict(ms=cuda_ms(lambda: tpe.expand_slots(*args)),
             plain_ms=cuda_ms(lambda: tpe.expand_slots_reference(*args)))
    t["bound_ms"], t["bound_by"] = bound(
        nbytes(pt.sorted_fields, pt.base, pt.cnt, sent, dfT), 0)
    print(f"[fluid-kernels] {label}: K1 (F = {dfT.shape[1]}) "
          f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, bound "
          f"{t['bound_ms']:.4f} ms by {t['bound_by']}), bit for bit",
          flush=True)
    timings[label] = t


def phase_fluid_kernels(scheme, scene, label, timings, timed, k1=None):
    """The passes this scene's step runs against their twins on its pack,
    with seeded random velocities: B4 and B5 with a rigid body, B4 and
    B6c without; ``timed`` also times each and computes its bound, and K1
    on the pack into ``k1``.  Returns the gated contact pairs."""
    kernel, cfg, grid, pt, dfT, S, init = fluid_scene_pack(scheme, scene,
                                                           label, 13)
    if k1 is not None:
        pack_expand_check(pt, dfT, cfg, label, k1)
    has_rigid = len(scheme.rigid_bodies) > 0
    names = ["fluid_rates_wall",
             "fluid_forces_contact" if has_rigid else "fluid_forces"]
    out, work, n_found = fluid_pass_checks(
        fluid_calls(scheme, dfT, grid.nbr_slots, kernel, cfg.radius, S,
                    init, names),
        dfT, grid.nbr_slots, pt, cfg.radius, S, init,
        abs(scheme.fluid_alpha) > 1e-14, label, timed)
    picks = (f", contact slots with a pick {n_found}" if has_rigid else "")
    print(f"[fluid-kernels] {label}: n={scene.n} NC={cfg.NC_max} M={cfg.M} "
          f"O={cfg.O} S={S} | query lanes {int(pt.n_valid)}, {work}{picks} "
          "| max abs err " + ", ".join(
              f"{k} {v['err']:.3e}" for k, v in out.items()), flush=True)
    print_fluid_passes("fluid-kernels", label, out)
    timings[label] = out
    return work["gated"]


def phase_coupling_main(scheme, scene, dt, n_steps, label, smi, per_step):
    """The coupling step through its entry points, in chunks with the
    overflow-rebuild rule; ``per_step`` maps each kernel to its expected
    launches per step.  Returns (end scene, launches, steps/s)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    step = scheme.make_step(scene)
    fl = scene.is_fluid
    has_fluid = len(scheme.fluids) > 0
    has_body = scene.meta.nb > 0
    y0 = float(scene.xcm[0, 1]) if has_body else None
    _build.reset_launches()
    steps_run = done = rebuilds = 0
    chunk_s = []
    while done < n_steps:
        chunk_start = scene
        n = min(CHUNK, n_steps - done)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            scene = step(scene, dt)
        torch.cuda.synchronize()
        el = time.perf_counter() - t0
        steps_run += n
        if bool(scene.nbr_overflow):
            rebuilds += 1
            check(rebuilds <= 8, f"{label}: overflow persists after 8 "
                  "rebuilds")
            scheme.refresh_configs(chunk_start, grow=rebuilds > 1)
            step = scheme.make_step(chunk_start)
            scene = chunk_start
            print(f"[{label}] step {done}: capacity overflow, rebuilt "
                  f"(x{rebuilds}, boost {scheme.capacity_boost:.2f})",
                  flush=True)
            continue
        rebuilds = 0
        done += n
        chunk_s.append(el)
        if has_fluid:
            rho = scene.rho[fl]
            state = (f"fluid rho {float(rho.min()):.6f}-"
                     f"{float(rho.max()):.6f}")
            if has_body:
                state += f", box COM y {float(scene.xcm[0, 1]):.7f}"
        else:
            state = f"max overlap {float(scene.overlap.max()):.3e}"
        print(f"[{label}] steps {done - n}-{done}: {el:.3f} s, {state}",
              flush=True)
    launches = dict(_build.LAUNCHES)
    for k in launches:
        want = per_step.get(k, 0) * steps_run
        check(launches[k] == want, f"{label}: {k} launched {launches[k]} "
              f"times in {steps_run} steps, expected {want}")
    for k, v in scene.fields.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{label}: non-finite {k}")
    check(not bool(scene.nbr_overflow), f"{label}: overflow at the end")
    if has_fluid:
        dev_rho = float((scene.rho[fl] / scheme.rho0 - 1.0).abs().max())
        check(dev_rho < 0.05, f"{label}: fluid rho off rho0 by "
              f"{dev_rho:.3e}")
        msg = f" | max |rho/rho0 - 1| {dev_rho:.3e}"
    else:
        ov = float(scene.overlap.max())
        check(ov > 0, f"{label}: no overlap: the contact kernel did no work")
        msg = f" | max overlap {ov:.4e}"
    if has_body and has_fluid:
        y1 = float(scene.xcm[0, 1])
        check(y1 < y0, f"{label}: the box did not sink ({y0:.7f} -> "
              f"{y1:.7f})")
        msg += f" | box COM y {y0:.7f} -> {y1:.7f} ({y1 - y0:.3e})"
    steady = chunk_s[1:] or chunk_s
    sps = CHUNK * len(steady) / sum(steady)
    print(f"[{label}] n={scene.n} dt={dt:.6g} steps={done} (run "
          f"{steps_run}) launches " + " ".join(
              f"{k}={v}" for k, v in launches.items() if v) + msg,
          flush=True)
    print(f"[{label}] {sps:.2f} steps/s steady (chunks 2+), "
          f"{done / sum(chunk_s):.2f} steps/s all chunks, on {smi}",
          flush=True)
    return scene, launches, sps


def phase_coupling_parity(scheme, scene, dt, label="cpl-parity"):
    """20 kernel steps against 20 twin steps from one state in the
    scheme's ordering, in contact throughout: the dense box starts GAP dx
    above the floor, engaged, and moving down and sideways.  Sliding,
    because at zero tangential velocity the Coulomb friction's direction
    is the rounding noise of the tangent (the reference model's own
    discontinuity), which no summation-order tolerance holds."""
    scene = scene.replace(vcm=torch.tensor(
        [[0.05, -0.5, 0.0]], dtype=scene.dtype, device=scene.device))
    fast = scheme.make_step(scene)
    plain = scheme.make_step(scene, plain=True)
    a = b = scene
    for _ in range(COMPARE_STEPS):
        a, b = fast(a, dt), plain(b, dt)
    torch.cuda.synchronize()
    check(not bool(a.nbr_overflow) and not bool(b.nbr_overflow),
          f"{label}: overflow during the coupling step comparison")
    for c, who in ((a, "kernel"), (b, "twin")):
        check(float(c.overlap.max()) > 0 and
              float(c.delta_lt_x.abs().max()) > 0,
              f"{label}: the comparison's {who} run ended out of contact")
    worst = []
    eps = torch.finfo(scene.dtype).eps
    # the box's particle positions set the contact distances: two ulps
    # of the largest of them
    pos_ulp = 2 * eps * float(torch.stack(
        [scene.x.abs(), scene.y.abs()])[:, scene.is_rigid].max())
    # a contact force component errs by the force's size times its unit
    # normal's error, so fn_x and fn_y are held to the largest |fn|
    fn_scale = float(torch.sqrt(b.fn_x ** 2 + b.fn_y ** 2).max())
    bad = []
    for k in ("x", "y", "u", "v", "rho", "p", "p_fsi", "fx", "fy", "xcm",
              "vcm", "omega", "force", "contact_force_dist",
              "closest_point_dist_to_source", "overlap", "fn_x", "fn_y",
              "delta_lt_x"):
        x, y, tol = a[k], b[k], 0.0
        if k in ("x", "y", "xcm"):
            # positions as displacements over the run; each drift rounds
            # to the position's f32 grid, so two ulps of |x| on top (the
            # tank is 4 m wide: one ulp is 1e-7 to 5e-7 m)
            x, y, tol = x - scene[k], y - scene[k], 2 * eps * scene[k].abs()
        elif k in ("contact_force_dist", "closest_point_dist_to_source",
                   "overlap"):
            tol = pos_ulp
        err = float((x - y).abs().max())
        scale = fn_scale if k in ("fn_x", "fn_y") else float(y.abs().max())
        worst.append(f"{k} {err:.3e} (scale {scale:.3e})")
        if not bool(((x - y).abs() <= STEP_RTOL * y.abs()
                     + STEP_RTOL * scale + tol).all()):
            bad.append(f"{k} off by {err:.3e} (scale {scale:.3e})")
    check(not bad, f"{label}: coupling kernel step vs twin step (rtol "
          f"{STEP_RTOL}): " + ", ".join(bad))
    print(f"[{label}] {scheme.gtvf_ordering}: {COMPARE_STEPS} kernel steps "
          f"vs {COMPARE_STEPS} twin steps (dense box on the floor, rho "
          f"{CPL_PARITY_RHO}; end "
          f"overlap {float(b.overlap.max()):.3e}, |delta_lt_x| "
          f"{float(b.delta_lt_x.abs().max()):.3e}), max abs diff: "
          + ", ".join(worst), flush=True)


def contact_all_slots(dfT, grid, cfg, kernel, S, init, label, timed):
    """K2 on every slot of the contact pack ``dfT`` (the kdk and reference
    orderings' cell pipeline) against its twin: picks bit for bit, the
    sums as in phase 3; ``timed`` also times both and computes the bound.
    Returns (numbers, query lanes with a pick)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck

    NC = cfg.NC_max
    nbr = grid.nbr_slots
    args = (dfT, torch.arange(NC, device=dfT.device), nbr, S, cfg.radius,
            init, kernel)
    out = tck.contact_sums(*args)
    ref = tck.contact_sums_reference(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{label}: K2 non-finite output")
    check(torch.equal(out[..., 5 * S:], ref[..., 5 * S:]),
          f"{label}: K2 picks on every slot != twin (max "
          f"{float((out[..., 5 * S:] - ref[..., 5 * S:]).abs().max())})")
    for c in range(5):
        a, b = out[..., c * S:(c + 1) * S], ref[..., c * S:(c + 1) * S]
        # the normals (blocks 0-2) are unit vectors: a component near 0
        # carries the rounding of the others, so their scale is 1
        scale = max(float(b.abs().max()), 1.0 if c < 3 else 0.0)
        tol = SUM_RTOL * b.abs() + SUM_RTOL * scale
        check(bool(((a - b).abs() <= tol).all()), f"{label}: K2 block {c} "
              f"off by {float((a - b).abs().max())}")
    t = dict(err=float((out - ref).abs().max()))
    n_pick = int((ref[..., 5 * S:6 * S] < init).sum())
    if timed:
        t["ms"] = cuda_ms(lambda: tck.contact_sums(*args))
        t["plain_ms"] = cuda_ms(lambda: tck.contact_sums_reference(*args),
                                reps=3, warmup=1)
        # least time: F fields in and 12S words out per live lane; 9 ops
        # per candidate lane of the rigid query lanes (a block with none
        # writes its init row and scans nothing)
        F = dfT.shape[1]
        flags = dfT[:NC, F - 1]
        n_rigid = (tck.decode_flags(flags)[3] == 1.0).sum(1)
        cnt = (flags != -8.0).sum(1)
        ext = torch.cat([cnt, torch.zeros(1, dtype=cnt.dtype,
                                          device=cnt.device)])
        lanes = int((n_rigid * ext[torch.clamp(nbr, max=NC)].sum(1)).sum())
        t["bound_ms"], t["bound_by"] = bound(
            4 * int(cnt.sum()) * (F + 12 * S), lanes * OPS_PER_LANE)
        t["lanes"] = lanes
        t["rigid_slots"] = int((n_rigid > 0).sum())
        print(f"[{label}] K2 on all {NC} slots ({t['rigid_slots']} with a "
              f"rigid lane, {lanes} rigid candidate lanes): "
              f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']})", flush=True)
    return t, n_pick


def phase_split_kernels(scheme, scene, label, timings, timed):
    """The kdk and reference orderings' passes against their twins on this
    scene's coupling pack, with seeded random velocities and body p_fsi:
    B6a with EDAC and with Tait, B6b and B6c with rigid bodies, and K2 on
    every slot of the contact pack laid out from the pack; ``timed`` also
    times each and computes its bound.  Returns (gated contact pairs,
    query lanes with a pick)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk

    kernel, cfg, grid, pt, dfT, S, init = fluid_scene_pack(
        scheme, scene, label, 17, p_fsi=True)
    out, work, _ = fluid_pass_checks(
        fluid_calls(scheme, dfT, grid.nbr_slots, kernel, cfg.radius, S,
                    init, ["fluid_rates", "fluid_rates_tait", "wall_bc",
                           "fluid_forces_rigid"]),
        dfT, grid.nbr_slots, pt, cfg.radius, S, init,
        abs(scheme.fluid_alpha) > 1e-14, label, timed)
    out["contact_all_slots"], n_pick = contact_all_slots(
        tck.contact_pack(dfT, fk.UNION_LAYOUT, cfg.dim == 2), grid, cfg,
        kernel, S, init, label, timed)
    print(f"[split-kernels] {label}: n={scene.n} NC={cfg.NC_max} M={cfg.M} "
          f"O={cfg.O} S={S} | query lanes {int(pt.n_valid)}, {work}, K2 "
          f"query lanes with a pick {n_pick} | max abs err " + ", ".join(
              f"{k} {v['err']:.3e}" for k, v in out.items()), flush=True)
    print_fluid_passes("split-kernels", label, out)
    timings[label] = out
    return work["gated"], n_pick


def sinking_box_scene_3d(dev, n_target=CPL_N):
    """The sinking box in 3D, set up through the port's
    ``RigidFluidCouplingScheme(dim=3)``: a 1.0 x 0.6 x 0.5 fluid block
    (x, y, z) in a 3-layer hydrostatic tank (``get_fluid_tank_3d``), a
    0.3 x 0.15 x 0.3 box of rho 2 centred in x and z, dipped into the
    surface, the fluid void carved under it, hydrostatic pressure, the box's displaced-fluid shadow mass and
    density; the 2D case's h = dx, c0 = 10 sqrt(2 g H) and fluid rho 1.
    dx = 0.0175 at ~97k particles.  Returns (scheme, scene)."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import (
        get_3d_block, get_fluid_tank_3d)
    from rigid_body_2d_3d_pysph_tpu_torch.models import (
        RigidFluidCouplingScheme)
    from rigid_body_2d_3d_pysph_tpu_torch.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY, ROLE_FLUID)

    dx = 0.0175 * (96_921.0 / n_target) ** (1.0 / 3.0)
    H, rho_f, rho_b, gy = 0.6, 1.0, 2.0, -1.0
    co = 10 * np.sqrt(2 * 9.81 * H)
    xf, yf, zf, xt, yt, zt = get_fluid_tank_3d(1.0, H, 0.5, 1.0, 0.8, 3, dx,
                                               dx, hydrostatic=True)
    p0 = -rho_f * gy * (yf.max() - yf)
    xb, yb, zb = get_3d_block(dx, 0.3 - dx, 0.15 - dx, 0.3 - dx)
    xb += 0.5 * (xf.min() + xf.max()) - 0.5 * (xb.min() + xb.max())
    zb += 0.5 * (zf.min() + zf.max()) - 0.5 * (zb.min() + zb.max())
    yb += yf.max() + dx - yb.min() - 0.25 * 0.15
    keep = ~((xf > xb.min() - dx) & (xf < xb.max() + dx)
             & (yf > yb.min() - dx) & (yf < yb.max() + dx)
             & (zf > zb.min() - dx) & (zf < zb.max() + dx))
    m = dx ** 3
    groups = [
        make_group("fluid", xf[keep], yf[keep], z=zf[keep], m=rho_f * m,
                   h=dx, rho=rho_f, role=ROLE_FLUID, p=p0[keep]),
        make_group("tank", xt, yt, z=zt, m=rho_f * m, h=dx, rho=rho_f,
                   rad_s=dx / 2.0, role=ROLE_BOUNDARY, dem_id=1),
        make_group("body", xb, yb, z=zb, m=rho_b * m, h=dx, rho=rho_b,
                   rad_s=dx / 2.0, role=ROLE_RIGID,
                   body_id=np.zeros(len(xb), np.int32),
                   dem_id=np.zeros(len(xb), np.int32))]
    scene = build_scene(groups, dim=3, total_no_bodies=2, spacing0=dx,
                        device=dev, dtype=config.WORK_DTYPE)
    scheme = RigidFluidCouplingScheme(
        ["fluid"], ["tank"], ["body"], dim=3, rho0=rho_f, p0=rho_f * co**2,
        c0=co, h=dx, nu=0.0, gy=gy)
    scene = scheme.setup(scene)
    rb = scene.is_rigid
    scene = scene.replace(
        m_fsi=torch.where(rb, scene.m_fsi + rho_f * m, scene.m_fsi),
        rho_fsi=torch.where(rb, rho_f, scene.rho_fsi))
    return scheme, scene


def phase_fluid_3d(scheme, scene, timings, k1):
    """Every fluid pass on the 3D sinking box's pack against its twin
    (seeded random velocities and body p_fsi): B4 and B5 (the kdkf step),
    B6a with EDAC and with Tait, B6b, B6c with and without bodies, each
    timed with its bound; K1 on the same pack into ``k1``."""
    label = "3D box"
    kernel, cfg, grid, pt, dfT, S, init = fluid_scene_pack(
        scheme, scene, label, 19, p_fsi=True)
    pack_expand_check(pt, dfT, cfg, label, k1)
    out, work, n_found = fluid_pass_checks(
        fluid_calls(scheme, dfT, grid.nbr_slots, kernel, cfg.radius, S,
                    init, ["fluid_rates_wall", "fluid_forces_contact",
                           "fluid_rates", "fluid_rates_tait", "wall_bc",
                           "fluid_forces", "fluid_forces_rigid"]),
        dfT, grid.nbr_slots, pt, cfg.radius, S, init,
        abs(scheme.fluid_alpha) > 1e-14, label, True)
    print(f"[fluid-3d] n={scene.n} NC={cfg.NC_max} M={cfg.M} O={cfg.O} "
          f"S={S} | query lanes {int(pt.n_valid)}, {work}, contact slots "
          f"with a pick {n_found} | max abs err " + ", ".join(
              f"{k} {v['err']:.3e}" for k, v in out.items()), flush=True)
    print_fluid_passes("fluid-3d", label, out)
    timings[label] = out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from rigid_body_2d_3d_pysph_tpu_torch import config
        from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}",
              file=sys.stderr)
        return 3

    try:
        # 1. environment
        smi = smi_line()
        print(f"[env] python {sys.version.split()[0]} torch "
              f"{torch.__version__} cuda {torch.version.cuda} "
              f"devices {torch.cuda.device_count()}", flush=True)
        print(f"[env] {smi}", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = config.device()

        # 2. build: one nvcc per source, all started together
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
            built = dict(zip(_build.SOURCES,
                             pool.map(_build.build, _build.SOURCES)))
        for name, (path, sec) in built.items():
            print(f"[build] {name}: {sec:.2f} s -> "
                  f"{os.path.relpath(path, ROOT)}", flush=True)
            for line in _build.BUILD_LOG.get(name, "").splitlines():
                if "registers" in line or "spill" in line \
                        or "entry function" in line:
                    print(f"[build] {name}: {line.strip()}", flush=True)
        for k in _build.KERNELS:
            _build.load(k)
        print(f"[build] all sources in {time.perf_counter() - t0:.2f} s "
              "wall", flush=True)

        # 3. kernels against twins
        t0 = time.perf_counter()
        scheme, scene, dx = contact_scene_2d(dev)
        cfg = scheme._cell_cfg
        print(f"[setup] 2D: n={scene.n} cfg={cfg} ni_max={scheme.ni_max(cfg)} "
              f"boundary particles {int(scene.is_boundary.sum())} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        timings = {}
        phase_kernels(scheme, scene, "2D", timings)
        t0 = time.perf_counter()
        scheme3, scene3, dx3 = contact_scene_3d(dev)
        print(f"[setup] 3D: n={scene3.n} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        phase_kernels(scheme3, scene3, "3D", timings)

        # 4. the main path
        end, launches, main_stats = phase_main_path(scheme, scene, dx, smi)

        # 5. kernel steps against twin steps
        phase_step_parity(scheme, end)
        del scheme, scene, end

        # 5a. the 3D main path from the 3D scene's set-up state, 5b. its
        # kernel steps against twin steps
        end3, launches3, stats3 = phase_main_path(scheme3, scene3, dx3, smi,
                                                  "main-3d")
        phase_step_parity(scheme3, end3)
        del scheme3, scene3, end3

        # 6. DEM kernels against twins
        dem_t = {}
        for label, dim, grid in (("2D spill", 2, "spill"),
                                 ("3D spill", 3, "spill"),
                                 ("2D rowwin", 2, "rowwin"),
                                 ("3D rowwin", 3, "rowwin")):
            t0 = time.perf_counter()
            dscheme, dscene = dem_scene(dev, dim, grid)
            print(f"[dem-setup] {label}: n={dscene.n} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            phase_dem_kernels(dscheme, dscene, label, dem_t,
                              crowded=dim == 2)
            del dscheme, dscene

        # 7. the DEM main path (spill grid), 8. the row-window path
        dscheme, dscene = dem_scene(dev, 2)
        dend, dem_launches, dem_sps = phase_dem_main(
            dscheme, dscene, DEM_STEPS, "dem-main", smi)
        rscheme, rscene = dem_scene(dev, 2, "rowwin")
        _, rw_launches, rw_sps = phase_dem_main(
            rscheme, rscene, DEM_ROWWIN_STEPS, "dem-rowwin", smi)
        del rscheme, rscene

        # 9. DEM kernel steps against twin steps
        phase_dem_parity(dscheme, dend)
        del dscheme, dend

        # 10. coupling kernels against twins: the main path's scene (timed)
        # and the contact placement; 14. the split passes on the same two
        fl_t, sp_t, k1_t = {}, {}, {}
        for label, floor in (("sinking box", False), ("box on floor", True)):
            t0 = time.perf_counter()
            cscheme, cscene, cdt = sinking_box_scene(dev, floor=floor)
            print(f"[cpl-setup] {label}: n={cscene.n} dt={cdt:.6g} "
                  f"cfg={cscheme._cell_cfg} boundary particles "
                  f"{int(cscene.is_boundary.sum())} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            gated = phase_fluid_kernels(cscheme, cscene, label, fl_t,
                                        timed=not floor,
                                        k1=None if floor else k1_t)
            _, n_pick = phase_split_kernels(cscheme, cscene, label, sp_t,
                                            timed=not floor)
            if floor:
                check(gated > 0 and n_pick > 0,
                      "no gated contact pair on the floor")
            else:
                mscheme, mscene = cscheme, cscene
        del cscheme, cscene

        # 11. the coupling main path (the sinking box, fused kdkf)
        _, cpl_launches, cpl_sps = phase_coupling_main(
            mscheme, mscene, cdt, CPL_STEPS, "cpl-main", smi,
            dict(pack_expand=1, fluid_rates_wall=1, fluid_forces_contact=1))

        # 12. the fluid-only tank (no rigid body: B6c in B5's place): its
        # passes against their twins on its pack (timed), then its path
        tscheme, tscene, tdt = sinking_box_scene(dev, body=False)
        phase_fluid_kernels(tscheme, tscene, "tank", fl_t, timed=True)
        _, tank_launches, tank_sps = phase_coupling_main(
            tscheme, tscene, tdt, CPL_TANK_STEPS, "cpl-tank", smi,
            dict(pack_expand=1, fluid_rates_wall=1, fluid_forces=1))
        del tscheme, tscene

        # 13. coupling kernel steps against twin steps
        pscheme, pscene, pdt = sinking_box_scene(dev, floor=True,
                                                 rho_b=CPL_PARITY_RHO)
        phase_coupling_parity(pscheme, pscene, pdt)

        # 15. the kdk ordering, 16. the reference ordering, from the
        # sinking box's set-up state
        split = dict(fluid_rates=1, wall_bc=1, fluid_forces=1, contact=1)
        sps_by, launches_by = {}, {}
        for ordering, n_pack in (("kdk", 2), ("reference", 1)):
            mscheme.gtvf_ordering = ordering
            _, launches_by[ordering], sps_by[ordering] = phase_coupling_main(
                mscheme, mscene, cdt, CPL_STEPS, f"cpl-{ordering}", smi,
                dict(split, pack_expand=n_pack))
        del mscheme, mscene

        # 17. the no-fluid route on the resting stack
        t0 = time.perf_counter()
        nscheme, nscene, _ = contact_scene_2d(dev, coupling=True)
        print(f"[nofluid-setup] n={nscene.n} cfg={nscheme._cell_cfg} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel
        from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel
        nkernel = get_kernel(nscheme.kernel_name, 2)
        ncfg = nscheme.cell_config(nscene, nkernel)
        ngrid, _, ndfT = contact_kernel.pack_scene(nscene, ncfg)
        nf_k2, n_pick = contact_all_slots(
            ndfT, ngrid, ncfg, nkernel,
            nscene.meta.total_no_bodies, 4.0 * nscene.meta.spacing0,
            "stack (no fluid)", timed=True)
        check(n_pick > 0, "no contact pick on the stack")
        del ngrid, ndfT
        _, nf_launches, nf_sps = phase_coupling_main(
            nscheme, nscene, DT, CPL_NOFLUID_STEPS, "cpl-nofluid", smi,
            dict(pack_expand=1, contact=1))
        del nscheme, nscene

        # 18. kdk and reference kernel steps against twin steps
        for ordering in ("kdk", "reference"):
            pscheme.gtvf_ordering = ordering
            phase_coupling_parity(pscheme, pscene, pdt, f"{ordering}-parity")
        del pscheme, pscene

        # 19. every fluid pass on the 3D sinking box
        t0 = time.perf_counter()
        scheme3f, scene3f = sinking_box_scene_3d(dev)
        print(f"[cpl3d-setup] n={scene3f.n} cfg={scheme3f._cell_cfg} "
              f"boundary particles {int(scene3f.is_boundary.sum())} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        fl3_t = {}
        phase_fluid_3d(scheme3f, scene3f, fl3_t, k1_t)
        del scheme3f, scene3f
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    t2, t3 = timings["2D"], timings["3D"]
    errs = lambda k: max(timings[lab][k] for lab in timings)
    src = "rigid_body_2d_3d_pysph_tpu_torch/csrc/"
    # each path's launches, read from its own counts (reset just before it)
    by_path = lambda k: {p: c[k] for p, c in (
        ("rigid", launches), ("rigid-3d", launches3),
        ("dem-main", dem_launches),
        ("dem-rowwin", rw_launches), ("coupling", cpl_launches),
        ("coupling-tank", tank_launches),
        ("coupling-kdk", launches_by["kdk"]),
        ("coupling-reference", launches_by["reference"]),
        ("coupling-nofluid", nf_launches)) if c[k]}
    fluid_err = lambda k: max(fl_t[lab][k]["err"] for lab in fl_t
                              if k in fl_t[lab])
    split_err = lambda k: max(sp_t[lab][k]["err"] for lab in sp_t)
    sb = sp_t["sinking box"]
    k2all = sb["contact_all_slots"]
    kernels = [
        dict(name="pack_expand", route="cuda", source=src + "pack_expand.cu",
             replaces="rigid_body_2d_3d_pysph_tpu/ops/pallas_pack.py:47",
             launches=launches["pack_expand"],
             launches_by_path=by_path("pack_expand"),
             max_abs_err=errs("pack_err"),
             ms=t2["pack_ms"], plain_ms=t2["pack_plain_ms"],
             bound_ms=t2["pack_bound"], bound_by=t2["pack_bound_by"],
             library_ms=None,
             # the 3D rigid pack (F = 9); the coupling packs (F = 14) of
             # the sinking box and of the 3D box
             ms_3d=t3["pack_ms"], plain_ms_3d=t3["pack_plain_ms"],
             bound_ms_3d=t3["pack_bound"],
             coupling_ms=k1_t["sinking box"]["ms"],
             coupling_plain_ms=k1_t["sinking box"]["plain_ms"],
             coupling_bound_ms=k1_t["sinking box"]["bound_ms"],
             coupling_3d_ms=k1_t["3D box"]["ms"],
             coupling_3d_bound_ms=k1_t["3D box"]["bound_ms"]),
        dict(name="contact_sums", route="cuda", source=src + "contact.cu",
             replaces="rigid_body_2d_3d_pysph_tpu/ops/pallas_contact.py:96",
             launches=launches["contact"],
             launches_by_path=by_path("contact"),
             max_abs_err=max(errs("contact_err"), split_err(
                 "contact_all_slots"), nf_k2["err"]),
             ms=t2["contact_ms"], plain_ms=t2["contact_plain_ms"],
             bound_ms=t2["contact_bound"],
             bound_by=t2["contact_bound_by"], library_ms=None,
             # 3D: at the 3D scene's set-up ni_max, and on every
             # interesting row (the rows the 3D path runs after its
             # overflow rebuilds)
             ms_3d=t3["contact_ms"], plain_ms_3d=t3["contact_plain_ms"],
             bound_ms_3d=t3["contact_bound"],
             ms_3d_all_rows=t3["contact_all_rows_ms"],
             plain_ms_3d_all_rows=t3["contact_all_rows_plain_ms"],
             bound_ms_3d_all_rows=t3["contact_all_rows_bound"],
             rows_3d_all_rows=t3["contact_all_rows"],
             # on every slot: the coupling orderings' cell pipeline
             all_slots_ms=k2all["ms"], all_slots_plain_ms=k2all["plain_ms"],
             all_slots_bound_ms=k2all["bound_ms"],
             all_slots_bound_by=k2all["bound_by"],
             nofluid_all_slots_ms=nf_k2["ms"],
             nofluid_all_slots_bound_ms=nf_k2["bound_ms"]),
    ]
    # each timed on its main path's 2D scene, the 3D scene beside it
    for name, line, path_launches, grid in (
            ("dem_cell", 340, dem_launches, "spill"),
            ("dem_rowwin", 546, rw_launches, "rowwin")):
        d2, d3 = dem_t[f"2D {grid}"], dem_t[f"3D {grid}"]
        kernels.append(dict(
            name=name, route="cuda", source=src + "dem.cu",
            replaces=f"rigid_body_2d_3d_pysph_tpu/ops/pallas_dem.py:{line}",
            launches=path_launches[name], launches_by_path=by_path(name),
            max_abs_err=max(d2["err"], d3["err"]), ms=d2["ms"],
            plain_ms=d2["plain_ms"], bound_ms=d2["bound_ms"],
            bound_by=d2["bound_by"], library_ms=None, ms_3d=d3["ms"],
            plain_ms_3d=d3["plain_ms"], bound_ms_3d=d3["bound_ms"],
            bound_by_3d=d3["bound_by"]))
    # each timed on its first main path's scene, the 3D box beside it
    f3 = fl3_t["3D box"]
    at_3d = lambda k, pre="": {f"{pre}ms_3d": f3[k]["ms"],
                               f"{pre}plain_ms_3d": f3[k]["plain_ms"],
                               f"{pre}bound_ms_3d": f3[k]["bound_ms"],
                               f"{pre}bound_by_3d": f3[k]["bound_by"]}
    for name, line, path_launches, lab in (
            ("fluid_rates_wall", 364, cpl_launches, "sinking box"),
            ("fluid_forces_contact", 590, cpl_launches, "sinking box"),
            ("fluid_forces", 562, tank_launches, "tank")):
        fm = fl_t[lab][name]
        kernels.append(dict(
            name=name, route="cuda", source=src + "fluid.cu",
            replaces=f"rigid_body_2d_3d_pysph_tpu/ops/pallas_fluid.py:{line}",
            launches=path_launches[name], launches_by_path=by_path(name),
            max_abs_err=max(fluid_err(name), f3[name]["err"]), ms=fm["ms"],
            plain_ms=fm["plain_ms"], bound_ms=fm["bound_ms"],
            bound_by=fm["bound_by"], library_ms=None, **at_3d(name)))
    # B4's no-body instance (the fluid-only tank)
    ft = fl_t["tank"]["fluid_rates_wall"]
    kernels[-3].update(
        tank_ms=ft["ms"], tank_plain_ms=ft["plain_ms"],
        tank_bound_ms=ft["bound_ms"], tank_bound_by=ft["bound_by"])
    # B6c's rigid instance (the kdk and reference orderings) beside the
    # tank's no-body one
    fr = sb["fluid_forces_rigid"]
    kernels[-1].update(
        max_abs_err=max(kernels[-1]["max_abs_err"],
                        split_err("fluid_forces_rigid"),
                        f3["fluid_forces_rigid"]["err"]),
        rigid_ms=fr["ms"], rigid_plain_ms=fr["plain_ms"],
        rigid_bound_ms=fr["bound_ms"], rigid_bound_by=fr["bound_by"],
        **at_3d("fluid_forces_rigid", "rigid_"))
    # the templates' resources, the 2D instances these paths launch: B4
    # with and without bodies (EDAC), B5, B6c without and with bodies (with
    # viscosity)
    for k, pre, res in (
            (-3, "", rates_resources(True, True, 0,
                                     fl_t["sinking box"]["fluid_rates_wall"])),
            (-3, "tank_", rates_resources(True, False, 0, ft)),
            (-2, "", forces_resources(
                True, True, fl_t["sinking box"]["fluid_forces_contact"])),
            (-1, "", forces_resources(False, False,
                                      fl_t["tank"]["fluid_forces"])),
            (-1, "rigid_", forces_resources(True, False, fr))):
        kernels[k].update({pre + key: v for key, v in res.items()})
    for name, line, mode in (("fluid_rates", 302, 1), ("wall_bc", 460, 2)):
        fm = sb[name]
        entry = dict(
            name=name, route="cuda", source=src + "fluid.cu",
            replaces=f"rigid_body_2d_3d_pysph_tpu/ops/pallas_fluid.py:{line}",
            launches=launches_by["kdk"][name], launches_by_path=by_path(name),
            max_abs_err=max(split_err(name), f3[name]["err"]),
            ms=fm["ms"], plain_ms=fm["plain_ms"], bound_ms=fm["bound_ms"],
            bound_by=fm["bound_by"], library_ms=None, **at_3d(name),
            **rates_resources(mode == 1, mode == 1, mode, fm))
        if mode == 1:
            ft = sb["fluid_rates_tait"]
            entry.update(
                max_abs_err=max(entry["max_abs_err"],
                                split_err("fluid_rates_tait"),
                                f3["fluid_rates_tait"]["err"]),
                tait_ms=ft["ms"], tait_plain_ms=ft["plain_ms"],
                tait_bound_ms=ft["bound_ms"], tait_bound_by=ft["bound_by"],
                **at_3d("fluid_rates_tait", "tait_"),
                **{"tait_" + k: v for k, v in rates_resources(
                    False, True, 1, ft).items()})
        kernels.append(entry)
    print(f"[done] rigid {main_stats['steps_per_s']:.2f} steps/s at "
          f"n={main_stats['n']}, 3D {stats3['steps_per_s']:.2f} steps/s at "
          f"n={stats3['n']}; DEM spill {dem_sps:.2f} steps/s, row-window "
          f"{rw_sps:.2f} steps/s; coupling kdkf {cpl_sps:.2f} steps/s, "
          f"fluid-only tank {tank_sps:.2f} steps/s, kdk "
          f"{sps_by['kdk']:.2f} steps/s, reference "
          f"{sps_by['reference']:.2f} steps/s, no fluid {nf_sps:.2f} "
          f"steps/s; on {smi}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
