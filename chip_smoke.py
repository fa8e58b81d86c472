#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the
CUDA toolkit.  Phases, in order (any failure exits non-zero and prints
no result line):

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 off for matmul and cuDNN;
2. build: both hand-written kernels from ``csrc/`` (nvcc, sm_90a);
3. kernels against their plain twins on the card at the main path's
   shapes (2D, F = 7) and on a 3D case (F = 9, 27-cell stencil): pack
   expansion bit for bit, contact picks bit for bit, contact sums within
   rtol 1e-5 (f32 summation order); kernel and twin times in ms;
4. the main path: ``RigidBody2DScheme.setup`` -> ``make_step`` ->
   ``step`` for 200 steps at dt = 1e-4 on a ~105k-particle scene that is
   in contact from the first step (a resting stack of 8 blocks in two
   rows of 4 on a tank floor), in chunks with the overflow-rebuild rule;
   checks launch counts, interesting slots, overlap, finiteness,
   overflow, COM drift < 2 dx, and that no block dropped half the
   free-fall distance (the stack is carried by contact), and prints
   steps/s;
5. 20 kernel steps against 20 twin steps from one state;
6. a JSON line of per-kernel numbers, then the result line.

It imports nothing from JAX or the JAX package.
"""

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
# step-vs-step tolerance: the contact sums' f32 summation order differs
# between kernel and twin, and 20 steps of a stiff contact carry it on
STEP_RTOL = 1e-4
SUM_RTOL = 1e-5
# face gap of the resting stack in dx: a contact engages below 1 dx, and
# the 0.05 dx overlap of a 0.95 dx gap pushes a face with about the
# weight of one block (kr * 0.05 dx per face particle), so the stack
# starts near rest; the 0.3-0.4 dx overlaps of a 0.6-0.7 dx gap throw it
GAP = 0.95
G = 9.81


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
    """Mean device time of ``fn()`` in ms over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def contact_scene_2d(dev, n_target=100_000):
    """8 blocks of side 0.2 in two rows of 4 on the floor of a 3-layer
    tank (the bench's body size and count), a resting stack: the bottom
    row sits GAP dx above the floor's surface layer, neighbours GAP dx
    apart, the top row GAP dx above the bottom row.  A contact engages
    below 1 dx, so every block is in contact at once."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import (
        get_2d_block, create_tank_2d_from_block_2d)
    from rigid_body_2d_3d_pysph_tpu_torch.models import RigidBody2DScheme
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
    scheme = RigidBody2DScheme([g.name for g in bodies], ["tank"], dim=2,
                               gy=-9.81)
    return scheme, scheme.setup(scene), dx


def contact_scene_3d(dev, n_target=100_000):
    """8 cubes of side 0.2 in a 4 x 2 layout on a 3-layer floor slab, in
    contact with it and with their neighbours (the 3D bench's body size).
    The gaps are 0.95 dx: a 3.9 dx cell then never holds 5 lattice rows
    along an axis, so no cell needs more than the grid's 4 slots of 16
    (a closer 3D stack overflows ``max_spill`` in the reference too)."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import get_3d_block
    from rigid_body_2d_3d_pysph_tpu_torch.models import RigidBody3DScheme
    from rigid_body_2d_3d_pysph_tpu_torch.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY)

    n_bodies = 8
    side = max(int(round((n_target / n_bodies) ** (1 / 3))), 5)
    dx = 0.2 / (side - 1)
    xb1, yb1, zb1 = get_3d_block(dx, 0.2, 0.2, 0.2)
    gap = 0.95 * dx
    pitch = 0.2 + gap
    xs, ys, zs, bid = [], [], [], []
    for b in range(n_bodies):
        col, row = b % 4, b // 4
        xs.append(xb1 + col * pitch)
        ys.append(yb1 + 0.1 + gap)
        zs.append(zb1 + row * pitch)
        bid.append(np.full(len(xb1), b, np.int32))
    fx, fz = np.meshgrid(np.arange(-0.15, 0.8, dx), np.arange(-0.15, 0.4, dx))
    xf = np.concatenate([fx.ravel()] * 3)
    zf = np.concatenate([fz.ravel()] * 3)
    yf = np.concatenate([np.full(fx.size, -k * dx) for k in range(3)])
    m = 2000.0 * dx**3
    body = make_group("body", np.concatenate(xs), np.concatenate(ys),
                      z=np.concatenate(zs), m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_RIGID,
                      body_id=np.concatenate(bid), dem_id=np.concatenate(bid))
    floor = make_group("floor", xf, yf, z=zf, m=m, h=1.3 * dx, rho=2000.0,
                       rad_s=dx / 2, role=ROLE_BOUNDARY, dem_id=n_bodies)
    scene = build_scene([body, floor], dim=3, total_no_bodies=n_bodies + 1,
                        spacing0=dx, device=dev, dtype=config.WORK_DTYPE)
    scheme = RigidBody3DScheme(["body"], ["floor"], dim=3, gy=-9.81)
    return scheme, scheme.setup(scene), dx


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels(scheme, scene, label, timings):
    """Kernels against twins at this scene's main-path shapes (with
    seeded random velocities so the picked u/v/w are not all zero)."""
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

    grid, pt, dfT = tck.pack_scene(scene, cfg)
    sent = torch.tensor(tck.sent_fields(two_d), device=scene.device)
    k1_args = (pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)
    ref = tpe.expand_slots_reference(*k1_args)
    torch.cuda.synchronize()
    k1_err = float((dfT - ref).abs().max())
    check(torch.equal(dfT, ref), f"{label}: pack expansion != twin")

    qsel, nbr, valid, _, n_int = tck.select_queries(
        dfT, grid, pt, cfg, scheme.ni_max(cfg))
    n_int = int(n_int)
    check(n_int > 0, f"{label}: no interesting slots")
    k2_args = (dfT, qsel, nbr, S, cfg.radius, 4.0 * scene.meta.spacing0,
               kernel)
    out = tck.contact_sums(*k2_args)
    out_ref = tck.contact_sums_reference(*k2_args)
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
    k2_err = float((out - out_ref).abs().max())
    n_pairs = int(valid.sum()) * cfg.M * nbr.shape[1] * cfg.M
    print(f"[kernels] {label}: NC={cfg.NC_max} M={cfg.M} O={cfg.O} "
          f"F={dfT.shape[1]} S={S} interesting={n_int} (kernel rows "
          f"{int(valid.sum())} of ni_max {qsel.shape[0]}) "
          f"candidate_lanes={n_pairs} | pack max_abs_err={k1_err} | "
          f"contact picks exact, max_abs_err={k2_err:.3e}", flush=True)

    t = dict(
        pack_ms=cuda_ms(lambda: tpe.expand_slots(*k1_args)),
        pack_plain_ms=cuda_ms(lambda: tpe.expand_slots_reference(*k1_args)),
        contact_ms=cuda_ms(lambda: tck.contact_sums(*k2_args)),
        contact_plain_ms=cuda_ms(
            lambda: tck.contact_sums_reference(*k2_args)),
        pack_err=k1_err, contact_err=k2_err)
    print(f"[kernels] {label}: pack {t['pack_ms']:.4f} ms "
          f"(plain {t['pack_plain_ms']:.4f} ms), contact "
          f"{t['contact_ms']:.4f} ms (plain {t['contact_plain_ms']:.4f} ms)",
          flush=True)
    timings[label] = t


def phase_main_path(scheme, scene, dx, smi):
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
            print(f"[main] step {done}: capacity overflow, rebuilt "
                  f"(x{rebuilds}, boost {scheme.capacity_boost:.2f}, "
                  f"ni_max {scheme.ni_max(scheme.cell_config(scene, kernel))})",
                  flush=True)
            continue
        rebuilds = 0
        done += CHUNK
        ni = torch.stack(stats).cpu().numpy()
        n_int.append(ni)
        lanes.append(ni * cfg.M * cfg.O * cfg.M)
        chunk_s.append(el)
        ov = float(scheme.export_scene(scene).overlap.max())
        print(f"[main] steps {done - CHUNK}-{done}: {el:.3f} s, interesting "
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
    drift = float((scene.xcm[:, :2] - xcm0[:, :2]).norm(dim=1).max())
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
    print(f"[main] n={scene.n} dx={dx:.6g} steps={done} (run {steps_run}) "
          f"launches pack={launches['pack_expand']} "
          f"contact={launches['contact']} | interesting slots/step "
          f"min {n_int.min()} mean {n_int.mean():.1f} max {n_int.max()} | "
          f"candidate lanes/step mean {lanes.mean():.4g} | max overlap "
          f"{max_overlap:.4e} ({max_overlap / dx:.3f} dx) | max COM drift "
          f"{drift:.4e} ({drift / dx:.3f} dx) | max drop {drop:.4e} "
          f"(free fall {fall:.4e})", flush=True)
    print(f"[main] {sps:.2f} steps/s steady (chunks 2+), "
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
        kernel, cfg, params, True, scheme.ni_max(cfg), plain=True),
        COMPARE_STEPS)
    a, b = fast(scene, DT), plain(scene, DT)
    torch.cuda.synchronize()
    check(not bool(a.nbr_overflow) and not bool(b.nbr_overflow),
          "overflow during the step comparison")
    worst = []
    for k in ("xcm", "vcm", "omega", "fx", "fy"):
        x, y = a[k], b[k]
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        ok = bool(((x - y).abs() <= STEP_RTOL * y.abs()
                   + STEP_RTOL * scale).all())
        worst.append(f"{k} {err:.3e} (scale {scale:.3e})")
        check(ok, f"kernel step vs twin step: {k} off by {err:.3e} "
                  f"(scale {scale:.3e}, rtol {STEP_RTOL})")
    print(f"[parity] {COMPARE_STEPS} kernel steps vs {COMPARE_STEPS} twin "
          f"steps, max abs diff: " + ", ".join(worst), flush=True)


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

        # 2. build
        for name in ("pack_expand", "contact"):
            path, sec = _build.build(name)
            _build.load(name)
            print(f"[build] {name}: {sec:.2f} s -> "
                  f"{os.path.relpath(path, ROOT)}", flush=True)

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
        scheme3, scene3, _ = contact_scene_3d(dev)
        print(f"[setup] 3D: n={scene3.n} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        phase_kernels(scheme3, scene3, "3D", timings)
        del scheme3, scene3

        # 4. the main path
        end, launches, main_stats = phase_main_path(scheme, scene, dx, smi)

        # 5. kernel steps against twin steps
        phase_step_parity(scheme, end)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    t2 = timings["2D"]
    errs = lambda k: max(timings[lab][k] for lab in timings)
    kernels = [
        dict(name="pack_expand", route="cuda",
             source="rigid_body_2d_3d_pysph_tpu_torch/csrc/pack_expand.cu",
             replaces="rigid_body_2d_3d_pysph_tpu/ops/pallas_pack.py:47",
             launches=launches["pack_expand"], max_abs_err=errs("pack_err"),
             ms=t2["pack_ms"], plain_ms=t2["pack_plain_ms"]),
        dict(name="contact_sums", route="cuda",
             source="rigid_body_2d_3d_pysph_tpu_torch/csrc/contact.cu",
             replaces="rigid_body_2d_3d_pysph_tpu/ops/pallas_contact.py:96",
             launches=launches["contact"], max_abs_err=errs("contact_err"),
             ms=t2["contact_ms"], plain_ms=t2["contact_plain_ms"]),
    ]
    print(f"[done] {main_stats['steps_per_s']:.2f} steps/s at "
          f"n={main_stats['n']} on {smi}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
