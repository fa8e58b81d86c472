#!/usr/bin/env python3
"""Where the contact kernel K2's time goes, on one CUDA card.

    python3 scripts/contact_variants.py [--parent DIR]

Run from the repository root on the machine with the card.  It builds
``csrc/contact.cu`` as it is and in cut-down copies, each with ``nvcc``
into ``build/contact_variants/``:

* ``init``: the init rows and the query lanes only (no stencil read);
* ``staging``: also the staging (the two walks of the stencil that sort
  the candidates by dem into shared memory), no candidate tested;
* ``test``: also each query lane's distance test of the candidates, no
  pair body;
* ``bodies``: also the pair bodies, not added up (no sums, no pick, no
  epilogue);

and, with ``--parent DIR``, the ``csrc/contact.cu`` of another checkout
(its entry point as this one's; without the ``chunk`` argument after
``S``, as before the wide instance (it then runs its narrow instance,
S <= 64); without the SPH kernel's id after ``two_d`` too, as before the
kernel family was built into its own libraries; or with the
``skip_idle`` argument after ``two_d`` of before this kernel's
redesign, set on the every-slot cases as its wrapper did).
Every build is of the quintic spline (no ``-DRB_SPH_KERNEL``).  On ``chip_smoke.py``'s scenes it prints each build's
time per launch for the four instances of the rigid and coupling paths:
the 2D culled rows (the main path), the 3D culled rows at the set-up
``ni_max`` and at every interesting row, and every slot of the sinking
box and of the no-fluid stack.  Times are CUDA events over 50 launches
into a preallocated output, behind a device sleep so the host's enqueue
is not timed.  The full build and the parent are checked against the
wrapper's output bit for bit (all three add each query lane's pairs in
stencil order); the cut-down copies compute less by design.  Also
prints ptxas's registers, shared memory and spills per kernel instance.

It imports nothing from JAX.
"""

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import _build  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck  # noqa: E402

SOURCE = os.path.join(_build.CSRC, "contact.cu")
OUT = os.path.join(ROOT, "build", "contact_variants")
REPS = 50
# variant -> the (anchor, replacement) edits of contact.cu that make it
CUTS = {
    "init": [("if (WIDE ? row_skip == NO_RIGID : row_want == 0ull)",
              "if (true)")],
    "staging": [("if (lo >= hi) continue;", "if (lo >= hi || lo >= 0) continue;")],
    "test": [("if (r2 <= thr) {", "if (r2 <= thr && k < 0) {")],
    "bodies": [("if (c == 0 && mine) {", "if (c < 0 && mine) {")],
}


def build(name, src):
    """nvcc ``src`` into OUT/<name>.so with the contact flags; returns
    (name, library path or None, ptxas report or the error)."""
    out = os.path.join(OUT, f"{name}.so")
    res = subprocess.run([_build._nvcc(), *_build.BASE_FLAGS,
                          *_build.EXTRA_FLAGS["contact"], "-I", _build.CSRC,
                          "-o", out, src], capture_output=True, text=True)
    if res.returncode:
        return name, None, res.stderr
    return name, out, "\n".join(
        ln.strip() for ln in res.stderr.splitlines()
        if "registers" in ln or "spill" in ln or "entry function" in ln)


def sources(parent):
    with open(SOURCE) as f:
        text = f.read()
    srcs = {"full": SOURCE}
    for name, edits in CUTS.items():
        cut = text
        for old, new in edits:
            if cut.count(old) != 1:
                raise RuntimeError(f"{name}: the cut's anchor is not in "
                                   "contact.cu")
            cut = cut.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(cut)
        srcs[name] = path
    if parent:
        srcs["parent"] = os.path.join(
            parent, "rigid_body_2d_3d_pysph_tpu_torch", "csrc", "contact.cu")
    return srcs


def cases(dev):
    """(label, kernel arguments, every slot?) of the four instances."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    def culled(scheme, scene, ni=None):
        kernel = get_kernel(scheme.kernel_name, scheme.dim)
        cfg = scheme.cell_config(scene, kernel)
        grid, pt, dfT = tck.pack_scene(scene, cfg)
        qsel, nbr, _, _, n_int = tck.select_queries(
            dfT, grid, pt, cfg, ni or scheme.ni_max(cfg))
        return (dfT, qsel, nbr, scene.meta.total_no_bodies, cfg.radius,
                4.0 * scene.meta.spacing0, kernel), int(n_int)

    def every(dfT, grid, cfg, kernel, scene):
        return (dfT, torch.arange(cfg.NC_max, device=dev), grid.nbr_slots,
                scene.meta.total_no_bodies, cfg.radius,
                4.0 * scene.meta.spacing0, kernel)

    out = []
    scheme, scene, _ = cs.contact_scene_2d(dev)
    out.append(("2D culled", culled(scheme, scene)[0], False))
    scheme, scene, _ = cs.contact_scene_3d(dev)
    args, n_int = culled(scheme, scene)
    out.append((f"3D culled, {args[1].shape[0]} rows", args, False))
    ni = max(scheme.ni_max(scheme.cell_config(scene, args[-1])), n_int)
    out.append((f"3D all rows, {ni}", culled(scheme, scene, ni)[0], False))
    del scheme, scene
    scheme, scene, _ = cs.sinking_box_scene(dev)
    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    cfg = scheme.cell_config(scene, kernel)
    grid, _, dfT = fk.pack_fluid_sorted(scene, cfg)
    out.append(("sinking box, every slot",
                every(tck.contact_pack(dfT, fk.UNION_LAYOUT, True), grid, cfg,
                      kernel, scene), True))
    scheme, scene, _ = cs.contact_scene_2d(dev, coupling=True)
    kernel = get_kernel(scheme.kernel_name, 2)
    cfg = scheme.cell_config(scene, kernel)
    grid, _, dfT = tck.pack_scene(scene, cfg)
    out.append(("no-fluid stack, every slot",
                every(dfT, grid, cfg, kernel, scene), True))
    return out


def holds(path, word):
    """Whether the contact.cu at ``path`` holds ``word``: ``skip_idle``
    (the entry point of before the redesign), ``sph_id`` (the SPH
    kernel's id after ``two_d``) or ``int chunk`` (the wide instance's
    argument after ``S``)."""
    with open(path) as f:
        return word in f.read()


def time_case(label, args, every_slot, libs, skip_idle=(), no_id=(),
              no_chunk=()):
    dfT, qslot, nbr, S, cutoff, init, kernel = args
    ref = tck.contact_sums(*args)
    NI, O = nbr.shape
    R, M = dfT.shape[0], dfT.shape[2]
    sig_num, sig_den = kernel.sigma_constants()
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream(dfT.device).cuda_stream
    ptrs = (dfT.data_ptr(), qslot.data_ptr(), nbr.data_ptr(), out.data_ptr())
    tail = (float(cutoff), float(init), float(sig_num), float(sig_den),
            stream)
    two_d = int(kernel.dim == 2)
    line = [f"[contact-variants] {label}: wrapper "
            f"{cs.cuda_ms(lambda: tck.contact_sums(*args), reps=REPS):.4f} ms"]
    for name, lib in libs.items():
        fn = lib.contact_sums
        if name in skip_idle:   # ... M, S, two_d, skip_idle, floats, stream
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
                [ctypes.c_float] * 4 + [ctypes.c_void_p]
            ints = (NI, O, R, M, S, two_d, int(every_slot))
        elif name in no_id:     # ... M, S, two_d, floats, stream
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
                [ctypes.c_float] * 4 + [ctypes.c_void_p]
            ints = (NI, O, R, M, S, two_d)
        elif name in no_chunk:  # ... M, S, two_d, sph_id, floats, stream
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
                [ctypes.c_float] * 4 + [ctypes.c_void_p]
            ints = (NI, O, R, M, S, two_d, kernel.device_id)
        else:
            fn.argtypes = _build.KERNELS["contact"][2]
            ints = (NI, O, R, M, S, tck.contact_instance(S)[1], two_d,
                    kernel.device_id)
        call = lambda: fn(*ptrs, *ints, *tail)
        out.fill_(float("nan"))
        if call() != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        if name in ("full", "parent"):
            cs.check(torch.equal(out, ref),
                     f"{label} {name}: output differs from the wrapper's")
        line.append(f"{name} {cs.cuda_ms(call, reps=REPS):.4f}")
    print(" | ".join(line), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose csrc/contact.cu to "
                    "time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("contact_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    srcs = sources(args.parent)
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(lambda kv: build(*kv), srcs.items()))
    libs = {}
    for name, path, report in built:
        print(f"[contact-variants] build {name}:\n{report}", flush=True)
        if path is None:
            return 1
        libs[name] = ctypes.CDLL(path)
    print(f"[contact-variants] {cs.smi_line()}", flush=True)
    dev = torch.device("cuda", 0)
    skip_idle = {name for name in ("parent",)
                 if name in srcs and holds(srcs[name], "skip_idle")}
    no_id = {name for name in srcs if name not in skip_idle
             and not holds(srcs[name], "sph_id")}
    no_chunk = {name for name in srcs if not holds(srcs[name], "int chunk")}
    try:
        for label, kargs, every_slot in cases(dev):
            time_case(label, kargs, every_slot, libs, skip_idle, no_id,
                      no_chunk)
    except cs.PhaseError as e:
        print(f"contact_variants: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
