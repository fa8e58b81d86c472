#!/usr/bin/env python3
"""The pack expansion K1 against another checkout's, on one CUDA card.

    python3 scripts/pack_variants.py [--parent DIR]

Run from the repository root on the machine with the card.  It builds
``csrc/pack_expand.cu`` as it is and, with ``--parent DIR``, the
``csrc/pack_expand.cu`` of another checkout, each with ``nvcc`` into
``build/pack_variants/``, and times both on the packs ``chip_smoke.py``'s
main paths expand: the 2D rigid stack (F = 7, M = 16), the 3D rigid
scene (F = 9), the 2D DEM column (F = 13) and the sinking box's coupling
pack (F = 14).  Times are CUDA events over 50 launches into a
preallocated output, behind a device sleep so the host's enqueue is not
timed; each build's output is checked against the twin bit for bit.
Also prints each pack's byte bound (sorted fields, base and cnt in, the
slot blocks out, at 3.35 TB/s) and ptxas's registers per instance.

It imports nothing from JAX.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import _build  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import pack_expand as tpe  # noqa: E402

OUT = os.path.join(ROOT, "build", "pack_variants")
REPS = 50


def build(name, src):
    """nvcc ``src`` into OUT/<name>.so with K1's flags; returns the
    library, after printing ptxas's registers."""
    out = os.path.join(OUT, f"{name}.so")
    res = subprocess.run([_build._nvcc(), *_build.BASE_FLAGS,
                          *_build.EXTRA_FLAGS["pack_expand"], "-o", out,
                          src], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    for entry, u in _build.ptxas_usage(res.stderr).items():
        print(f"[pack-variants] {name} {entry}: {u['registers']} registers, "
              f"spills {u['spill_stores']}/{u['spill_loads']} B", flush=True)
    lib = ctypes.CDLL(out)
    fn = lib.pack_expand
    fn.argtypes = _build.KERNELS["pack_expand"][2]
    fn.restype = ctypes.c_int
    return fn


def packs(dev):
    """(label, K1's arguments) of the main paths' packs."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as dk
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk
    from rigid_body_2d_3d_pysph_tpu_torch.ops.cellpairs import (
        build_cell_grid_packed)
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    out = []
    for label, make in (("rigid 2D", cs.contact_scene_2d),
                        ("rigid 3D", cs.contact_scene_3d)):
        scheme, scene, _ = make(dev)
        cfg = scheme.cell_config(scene, get_kernel(scheme.kernel_name,
                                                   scheme.dim))
        _, pt = build_cell_grid_packed(
            scene.x, scene.y, scene.z, scene.active, cfg,
            tck.contact_payload(scene, scheme.dim == 2))
        sent = torch.tensor(tck.sent_fields(scheme.dim == 2), device=dev)
        out.append((label, (pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)))
    scheme, scene = cs.dem_scene(dev, 2)
    cfg = scheme.cell_config(scene)
    _, pt = build_cell_grid_packed(scene.x, scene.y, scene.z, scene.active,
                                   cfg, dk.dem_payload(scene))
    sent = torch.tensor(dk.SENT, dtype=scene.dtype, device=dev)
    out.append(("DEM 2D", (pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)))
    scheme, scene, _ = cs.sinking_box_scene(dev)
    cfg = scheme.cell_config(scene, get_kernel(scheme.kernel_name, 2))
    _, pt, _ = fk.pack_fluid_sorted(scene, cfg)
    sent = torch.tensor(fk.SENT, dtype=scene.dtype, device=dev)
    out.append(("coupling", (pt.sorted_fields, pt.base, pt.cnt, sent,
                             cfg.M)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose csrc/pack_expand.cu "
                    "to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pack_variants: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    libs = {"change": build("change", os.path.join(_build.CSRC,
                                                   "pack_expand.cu"))}
    if args.parent:
        libs["parent"] = build("parent", os.path.join(
            args.parent, "rigid_body_2d_3d_pysph_tpu_torch", "csrc",
            "pack_expand.cu"))
    print(f"[pack-variants] {cs.smi_line()}", flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    try:
        for label, (sf, base, cnt, sent, M) in packs(dev):
            F, n = sf.shape
            NC = base.shape[0]
            ref = tpe.expand_slots_reference(sf, base, cnt, sent, M)
            out = torch.empty_like(ref)
            t_b, _ = cs.bound(cs.nbytes(sf, base, cnt, sent, ref), 0)
            line = [f"[pack-variants] {label} (F {F}, M {M}, NC {NC}, N "
                    f"{n}): bound {t_b:.4f} ms | wrapper "
                    f"{cs.cuda_ms(lambda: tpe.expand_slots(sf, base, cnt, sent, M), reps=REPS):.4f}"]
            # parent, change, change, parent
            order = ["parent", "change", "change", "parent"] \
                if "parent" in libs else ["change", "change"]
            for name in order:
                fn = libs[name]
                call = lambda: fn(sf.data_ptr(), base.data_ptr(),
                                  cnt.data_ptr(), sent.data_ptr(),
                                  out.data_ptr(), n, NC, F, M, stream)
                out.fill_(float("nan"))
                if call() != 0:
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                cs.check(torch.equal(out, ref),
                         f"{label} {name}: output != twin")
                line.append(f"{name} {cs.cuda_ms(call, reps=REPS):.4f}")
            print(" | ".join(line), flush=True)
    except cs.PhaseError as e:
        print(f"pack_variants: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
