#!/usr/bin/env python3
"""Where the fluid forces kernel's time goes, on one CUDA card.

    python3 scripts/fluid_variants.py [--parent DIR]

Run from the repository root on the machine with the card.  It builds
``csrc/fluid.cu`` as it is and in cut-down copies of its
``forces_kernel`` (the template of B5 ``fluid_forces_contact`` and B6c
``fluid_forces``), each with ``nvcc`` into ``build/fluid_variants/``:

* ``rows``: the output rows only (no stencil read, no contact pass);
* ``staging``: also the walk of the stencil and the loads of its
  candidates, no candidate tested;
* ``test``: also each query's distance test of the candidates, no force
  body;
* ``bodies``: also the force bodies (B6c whole; B5 without its contact
  part);
* ``full``: the source as it is (B5 with its contact part);

and, with ``--parent DIR``, the ``csrc/fluid.cu`` of another checkout,
whole and in the same cuts (the cuts are kept for this kernel's design
and for the one-thread-a-lane design it replaced; each source takes the
set whose anchors it holds).  On ``chip_smoke.py``'s coupling scenes
(the sinking box: B5 and B6c with bodies; the box on the tank floor: B5
with gated contact pairs; the fluid-only tank: B6c without bodies, all
at ~96.9k particles with seeded random velocities and body ``p_fsi``)
it prints each build's time per launch: CUDA events over 50 launches
into a preallocated output, behind a device sleep so the host's enqueue
is not timed.  The full build and the parent are checked against the
wrapper's output: the 12 S contact columns bit for bit, the force
columns within ``FLUID_SUM_RTOL`` of each column's largest magnitude;
the cut-down copies compute less by design.  Also prints ptxas's
registers, shared memory and spills for each ``forces_kernel`` instance.

It imports nothing from JAX.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import _build  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk  # noqa: E402

SOURCE = os.path.join(_build.CSRC, "fluid.cu")
OUT = os.path.join(ROOT, "build", "fluid_variants")
REPS = 50

# the one-thread-a-lane kernel (before the redesign): each query lane
# scans every candidate lane of its stencil, then S contact scans
_LANE_TEST = ("        const float rij = sqrtf(r2);\n"
              "        if (!(rij <= cutoff)) continue;\n"
              "        const Flags sf = decode(field(s, FFLAGS, M, k));\n"
              "        const bool src_fluid = sf.fluid == 1.0f;\n"
              "        const bool src_flbd = src_fluid || sf.sbdry == 1.0f;\n"
              "        const bool src_rigid = FSI && sf.rigid == 1.0f;\n")
_LANE_FORCES = "  if (dest_fluid || dest_rigid) {\n"
_LANE_CONTACT = "      if (qf.rigid == 1.0f && qf.dem != sf_id) {\n"
_NO_CONTACT = (_LANE_CONTACT, "      if (false) {\n")
LANE_CUTS = {
    "rows": [(_LANE_FORCES, "  if (false) {\n"), _NO_CONTACT],
    "staging": [(_LANE_TEST, "        au += xij + yij + zij;\n"
                 "        continue;\n" + _LANE_TEST), _NO_CONTACT],
    "test": [(_LANE_TEST, _LANE_TEST.replace(
        "if (!(rij <= cutoff)) continue;\n",
        "if (!(rij <= cutoff)) continue;\n        au += 1.0f;\n"
        "        continue;\n")), _NO_CONTACT],
    "bodies": [_NO_CONTACT],
}
# the one-warp-a-slot kernel: staged windows, forces over the listed
# queries, contact threads over the contact list, the block written whole
_WARP_ROWS = "  if (nq == 0) {\n"
_WARP_FORCES = "    for (int c0 = fp; fact && c0 < n; c0 += 32 * P) {\n"
_WARP_TEST = "      if (hits == 0u) continue;\n"
_WARP_CONTACT = "      if (cs >= 0) {\n        const float* cq = q + cl;\n"
# n and cn are never negative: the loops are skipped at run time
_NO_WARP_CONTACT = (_WARP_CONTACT, _WARP_CONTACT.replace(
    "cs >= 0", "cs >= 0 && cn < 0"))
WARP_CUTS = {
    "rows": [(_WARP_ROWS, "  if (true) {\n")],
    "staging": [(_WARP_FORCES, _WARP_FORCES.replace("fact &&",
                                                    "fact && n < 0 &&")),
                _NO_WARP_CONTACT],
    "test": [(_WARP_TEST, "      au += (float)__popc(hits);\n"
              "      continue;\n"), _NO_WARP_CONTACT],
    "bodies": [_NO_WARP_CONTACT],
}
DESIGNS = {"warp": WARP_CUTS, "lane": LANE_CUTS}


def build(name, src, inc):
    """nvcc ``src`` (its headers in ``inc``) into OUT/<name>.so with the
    fluid flags; returns (name, library path or None, ptxas report or
    the error)."""
    out = os.path.join(OUT, f"{name.replace(' ', '_')}.so")
    res = subprocess.run([_build._nvcc(), *_build.BASE_FLAGS,
                          *_build.EXTRA_FLAGS["fluid"], "-I", inc,
                          "-o", out, src], capture_output=True, text=True)
    if res.returncode:
        return name, None, res.stderr
    return name, out, res.stderr


def cut_sources(path, prefix):
    """{name: (source, its header directory)} for ``path`` whole and in
    the cuts of its design."""
    with open(path) as f:
        text = f.read()
    for design, cuts in DESIGNS.items():
        if all(text.count(old) == 1 for edits in cuts.values()
               for old, _ in edits):
            break
    else:
        raise RuntimeError(f"{path}: holds no design's cut anchors")
    inc = os.path.dirname(path)
    srcs = {prefix + "full": (path, inc)}
    for name, edits in cuts.items():
        cut = text
        for old, new in edits:
            cut = cut.replace(old, new)
        out = os.path.join(OUT, f"{prefix.replace(' ', '_')}{name}.cu")
        with open(out, "w") as f:
            f.write(cut)
        srcs[prefix + name] = (out, inc)
    print(f"[fluid-variants] {path}: the {design!r} design's cuts",
          flush=True)
    return srcs


def forces_usage(report):
    """ptxas's numbers for the forces_kernel instances, one line each
    (``<KDIM2, VISC, FSI, CONTACT>``)."""
    lines = []
    for entry, u in _build.ptxas_usage(report).items():
        m = re.search(r"forces_kernelI((?:Lb[01]E)+)E", entry)
        if m:
            inst = ",".join(re.findall(r"Lb([01])E", m.group(1)))
            lines.append(f"  forces_kernel<{inst}>: {u['registers']} "
                         f"registers, {u['smem']} B static smem, spills "
                         f"{u['spill_stores']}/{u['spill_loads']} B")
    return "\n".join(lines)


def cases(dev):
    """(label, instance, wrapper, wrapper args, C entry, C args after the
    sizes) for B5 and B6c on the three scenes."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    out = []
    for label, kw in (("sinking box", {}), ("box on floor", dict(floor=True)),
                      ("tank", dict(body=False))):
        scheme, scene, _ = cs.sinking_box_scene(dev, **kw)
        kernel = get_kernel(scheme.kernel_name, scheme.dim)
        cfg = scheme.cell_config(scene, kernel)
        gen = torch.Generator(device=dev).manual_seed(17)
        rnd = lambda a: (torch.rand(scene.n, generator=gen, device=dev)
                         - 0.5) * a
        scene = scene.replace(u=rnd(0.2), v=rnd(0.2), p_fsi=torch.where(
            scene.is_rigid, rnd(2.0), scene.p_fsi))
        grid, _, dfT = fk.pack_fluid_sorted(scene, cfg)
        cs.check(not bool(grid.overflow), f"{label}: grid overflow")
        nbr = grid.nbr_slots
        S = scene.meta.total_no_bodies
        init = 4.0 * scene.meta.spacing0
        sig_num, sig_den = fk._sigma_constants(kernel)
        visc = abs(scheme.fluid_alpha) > 1e-14
        kd2 = int(kernel.dim == 2)
        ac0 = float(-scheme.fluid_alpha * scheme.c0)
        base = (dfT, nbr, kernel, cfg.radius, scheme.fluid_alpha, scheme.c0)
        tail = (float(sig_num), float(sig_den))
        body = len(scheme.rigid_bodies) > 0
        if body:
            out.append((label, "B5", fk.fluid_forces_contact, base + (S, init),
                        "fluid_forces_contact",
                        (S, kd2, int(visc), float(cfg.radius), ac0,
                         float(init)) + tail, S))
        if label != "box on floor":
            out.append((label, "B6c" + (" with bodies" if body else ""),
                        fk.fluid_forces, base + (body,), "fluid_forces",
                        (kd2, int(visc), int(body), float(cfg.radius), ac0)
                        + tail, 0))
    return out


def time_case(case, libs):
    label, inst, wrapper, wargs, entry, cargs, S = case
    dfT, nbr = wargs[0], wargs[1]
    ref = wrapper(*wargs)
    NC, O = nbr.shape
    M = dfT.shape[2]
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream(dfT.device).cuda_stream
    ptrs = (dfT.data_ptr(), nbr.data_ptr(), out.data_ptr())
    line = [f"[fluid-variants] {label} {inst}: wrapper "
            f"{cs.cuda_ms(lambda: wrapper(*wargs), reps=REPS):.4f} ms"]
    for name, lib in libs.items():
        fn = getattr(lib, entry)
        fn.argtypes = _build.KERNELS[entry][2]
        fn.restype = ctypes.c_int
        call = lambda: fn(*ptrs, NC, O, M, *cargs, stream)
        out.fill_(float("nan"))
        if call() != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        if name in ("full", "parent full"):
            cs.check(torch.equal(out[..., :12 * S], ref[..., :12 * S]),
                     f"{label} {inst} {name}: contact columns differ from "
                     "the wrapper's")
            cs.check_fluid_columns(out, ref, range(12 * S, ref.shape[-1]),
                                   f"{label} {inst} {name}")
        line.append(f"{name} {cs.cuda_ms(call, reps=REPS):.4f}")
    print(" | ".join(line), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose csrc/fluid.cu to "
                    "time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fluid_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    srcs = cut_sources(SOURCE, "")
    if args.parent:
        srcs.update(cut_sources(os.path.join(
            args.parent, "rigid_body_2d_3d_pysph_tpu_torch", "csrc",
            "fluid.cu"), "parent "))
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(lambda kv: build(kv[0], *kv[1]),
                              srcs.items()))
    libs = {}
    for name, path, report in built:
        if path is None:
            print(f"[fluid-variants] build {name} failed:\n{report}",
                  file=sys.stderr)
            return 1
        print(f"[fluid-variants] build {name}:\n{forces_usage(report)}",
              flush=True)
        libs[name] = ctypes.CDLL(path)
    print(f"[fluid-variants] {cs.smi_line()}", flush=True)
    dev = torch.device("cuda", 0)
    try:
        for case in cases(dev):
            time_case(case, libs)
    except cs.PhaseError as e:
        print(f"fluid_variants: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
