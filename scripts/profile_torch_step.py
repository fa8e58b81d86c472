#!/usr/bin/env python3
"""Where the PyTorch port's step time goes on one CUDA card.

    python3 scripts/profile_torch_step.py [--steps 20]
        [--paths rigid,dem,rowwin,coupling,coupling-kdk,coupling-reference,
                 coupling-compact,coupling-full,
                 list-rigid,list-rigid-3d,list-dem,list-coupling-kdk,
                 list-coupling-reference]

Run from the repository root on the machine with the card.  For each
main path of ``chip_smoke.py`` (the 2D rigid contact step at ~105k
particles, the 2D DEM step on the spill grid and on the row-window grid
at ~104k particles, the coupling step of the sinking box at ~96.9k
particles in the fused kdkf ordering, the kdk and the reference
ordering; ``coupling-compact``: the kdkf step on the compact contact
store on phase 42's scene, 8 boxes of rho 8 in the sinking box's tank,
S = 9, and ``coupling-full``: the same scene and step on the full
``[N, S]`` schema; the ``list-`` paths: the same steps, and the 3D
cubes' GTVF step, on the ``[N, K]`` list engine), on the same scenes, it
prints:

* untraced ms/step (host clock around ``--steps`` steps ending in a
  synchronise), after a warm-up chunk;
* one ``torch.profiler`` trace of ``--steps`` steps: traced ms/step,
  kernel launches per step, the device busy share (union of kernel
  intervals over traced wall time);
* per layer span (``record_function`` around the layer's function):
  host ms/step and the device ms/step of the kernels that ran inside
  the span's device-side annotation (one stream, so these are the
  span's kernels, the hand kernels launched through ``ctypes`` too);
* the kernels by summed device time per step.

It imports nothing from JAX.
"""

import argparse
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as ck  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_fluid_coupling as cpl  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as dk  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact as cops  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import dem as dops  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid as fops  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import neighbors as nbmod  # noqa: E402

# layer spans: (module, function name, span label) per path
SPANS = {
    "rigid": [(ck, "build_cell_grid_packed", "L1 grid build"),
              (ck, "expand_slots", "K1 pack expansion"),
              (ck, "select_queries", "L2 interest cull"),
              (ck, "contact_sums", "K2 contact sums"),
              (trb, "_compact_contact_tail", "L3 Eq.-24 tail")],
    "dem": [(dk, "build_cell_grid_packed", "L1 grid build"),
            (dk, "expand_slots", "K1 pack expansion"),
            (dk, "dem_cell_sums", "K4 DEM spill pass")],
    "rowwin": [(dk, "build_row_window_grid", "L1 row-window build"),
               (dk, "expand_slots", "K1 pack expansion"),
               (dk, "dem_rowwin_sums", "K3 DEM row-window pass")],
    "coupling": [(fk, "build_cell_grid_packed", "L1 grid build"),
                 (fk, "expand_slots", "K1 pack expansion"),
                 (fk, "fluid_rates_wall", "B4 rates + wall sums"),
                 (fk, "fluid_forces_contact", "B5 forces + contact"),
                 (cpl, "unpack", "unpack"),
                 (cpl, "_contact_tail", "L3 Eq.-24 tail")],
}
# phase 42's scene: the compact store (the light cull and B5's rows at
# the culled slots, the tail on their lanes) and the full [N, S] route
_CPL_PASSES = SPANS["coupling"][:4]
SPANS["coupling-compact"] = _CPL_PASSES + [
    (cpl, "culled_lanes", "L2 light cull + lane gather"),
    (cpl, "unpack", "unpack (13 fluid columns)"),
    (cpl, "_compact_contact_tail", "L3 Eq.-24 tail (culled lanes)")]
SPANS["coupling-full"] = _CPL_PASSES + [
    (cpl, "unpack", "unpack (13 + 12 S columns)"),
    (cpl, "_contact_tail", "L3 Eq.-24 tail ([N, S])")]
# the kdk and reference orderings: the split passes and K2 on every slot
SPANS["coupling-kdk"] = SPANS["coupling-reference"] = [
    (fk, "build_cell_grid_packed", "L1 grid build"),
    (fk, "expand_slots", "K1 pack expansion"),
    (fk, "fluid_rates", "B6a rates"),
    (fk, "wall_bc", "B6b wall sums"),
    (fk, "fluid_forces", "B6c forces"),
    (ck, "contact_sums", "K2 contact sums (every slot)"),
    (cpl, "unpack", "unpack (fluid)"),
    (ck, "unpack", "unpack (contact)"),
    (cpl, "_contact_force_tail", "L3 Eq.-24 tail")]
# the list engine: the list build, the pair passes, the Eq.-24 tail
_LIST_CONTACT = [
    (cops, "contact_force_normals", "Eq.-22 normals (list)"),
    (cops, "contact_force_distance", "Eq.-21 distance + pick (list)"),
    (cops, "contact_force", "L3 Eq.-24 tail")]
_LIST_BUILD = [(nbmod, "build_neighbors", "L1 list build")]
SPANS["list-rigid"] = SPANS["list-rigid-3d"] = _LIST_BUILD + _LIST_CONTACT
SPANS["list-dem"] = _LIST_BUILD + [
    (dops, "prune_contact_table", "table prune"),
    (dops, "lvc_displacement", "LVC pass (list)")]
SPANS["list-coupling-kdk"] = SPANS["list-coupling-reference"] = (
    _LIST_BUILD + [(fops, name, f"{name} (list)") for name in (
        "continuity", "edac", "set_wall_velocity", "solid_wall_pressure_bc",
        "momentum_pressure_gradient", "momentum_artificial_viscosity",
        "force_on_fluid_due_to_rigid_body",
        "force_on_rigid_body_due_to_fluid")] + _LIST_CONTACT)


def _wrap(fn, label):
    def inner(*a, **k):
        with record_function(label):
            return fn(*a, **k)
    return inner


def _scene(path, dev):
    engine = "nklist" if path.startswith("list-") else "cell"
    base = path[5:] if engine == "nklist" else path
    if base == "rigid":
        scheme, scene, _ = cs.contact_scene_2d(dev, engine=engine)
        dt = cs.DT
    elif base == "rigid-3d":
        scheme, scene, _ = cs.contact_scene_3d(dev, engine=engine)
        dt = cs.DT
    elif base in ("coupling-compact", "coupling-full"):
        scheme, scene, dt = cs.boxes_tank_scene(dev, 2)
        if base == "coupling-full":
            scene = trb.strip_compact_fields(trb.expand_slot_scene(scene))
    elif base.startswith("coupling"):
        scheme, scene, dt = cs.sinking_box_scene(dev, engine=engine)
        if base != "coupling":
            scheme.gtvf_ordering = base.split("-")[1]
    else:
        scheme, scene = cs.dem_scene(dev, 2, "spill" if base == "dem"
                                     else "rowwin", engine=engine)
        dt = cs.DEM_DT
    return scheme, scene, dt


def _warm_step(scheme, scene, dt, n):
    """A step that has run one chunk without overflow (rebuilding as the
    smoke run does), and the state it left."""
    for attempt in range(8):
        step = scheme.make_step(scene)
        s = scene
        for _ in range(n):
            s = step(s, dt)
        torch.cuda.synchronize()
        if not bool(s.nbr_overflow):
            return step, s
        scheme.refresh_configs(scene, grow=attempt > 0)
        scene = scheme.adapt_scene(scene)
    raise RuntimeError("overflow persists")


def profile_path(path, dev, n_steps):
    spans = SPANS[path]
    saved = [(m, name, getattr(m, name)) for m, name, _ in spans]
    scheme, scene, dt = _scene(path, dev)
    step, scene = _warm_step(scheme, scene, dt, n_steps)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = scene
    for _ in range(n_steps):
        s = step(s, dt)
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) / n_steps * 1e3

    for m, name, label in spans:
        setattr(m, name, _wrap(getattr(m, name), label))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = scene
            for _ in range(n_steps):
                s = step(s, dt)
            torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) / n_steps * 1e3
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)

    events = prof.events()
    labels = {label for _, _, label in spans}
    cuda = torch.autograd.DeviceType.CUDA
    # kernels only: the spans also appear on the device timeline as
    # annotations covering their kernels
    kernels = [e for e in events
               if e.device_type == cuda and e.name not in labels]
    iv = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in iv:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    busy_ms = busy / 1e3 / n_steps
    print(f"[{path}] n={scene.n}: untraced {untraced:.3f} ms/step, traced "
          f"{traced:.3f} ms/step, {len(kernels) / n_steps:.1f} kernel "
          f"launches/step, device busy {busy_ms:.3f} ms/step = "
          f"{100 * busy_ms / traced:.1f} % of traced wall", flush=True)
    for label in [lb for _, _, lb in spans]:
        host = sum(e.cpu_time_total for e in events
                   if e.device_type != cuda and e.name == label)
        # a span's kernels run in order on one stream, inside the
        # device-side annotation of the span
        dev_us = 0.0
        for a in (e for e in events if e.device_type == cuda
                  and e.name == label):
            dev_us += sum(k.time_range.elapsed_us() for k in kernels
                          if k.time_range.start >= a.time_range.start
                          and k.time_range.end <= a.time_range.end)
        print(f"[{path}]   span {label}: host {host / 1e3 / n_steps:.3f} "
              f"ms/step, device {dev_us / 1e3 / n_steps:.4f} ms/step",
              flush=True)
    by_kernel = {}
    for e in kernels:
        by_kernel.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_kernel.items(), key=lambda kv: -sum(kv[1]))[:10]
    for name, ts in top:
        print(f"[{path}]   kernel {sum(ts) / 1e3 / n_steps:.4f} ms/step "
              f"({len(ts) / n_steps:.1f}/step, mean {sum(ts) / len(ts):.1f} "
              f"us) {name[:90]}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--paths", default="rigid,dem,rowwin,coupling")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] {cs.smi_line()}", flush=True)
    dev = torch.device("cuda", 0)
    for path in args.paths.split(","):
        profile_path(path, dev, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
