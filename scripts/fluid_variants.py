#!/usr/bin/env python3
"""Where the fluid kernels' time goes, on one CUDA card.

    python3 scripts/fluid_variants.py [--parent DIR] [--kernel forces|rates]

Run from the repository root on the machine with the card.  It builds
``csrc/fluid.cu`` as it is and in cut-down copies of one of its two
templates, each with ``nvcc`` into ``build/fluid_variants/``:

* ``forces_kernel`` (B5 ``fluid_forces_contact``, B6c ``fluid_forces``):
  ``rows`` the output rows only (no stencil read, no contact pass);
  ``staging`` also the walk of the stencil and the loads of its
  candidates, no candidate tested; ``test`` also each query's distance
  test of the candidates, no force body; ``bodies`` also the force bodies
  (B6c whole; B5 without its contact part);
* ``rates_wall_kernel`` (B4 ``fluid_rates_wall``, B6a ``fluid_rates``,
  B6b ``wall_bc``): the same ``rows``, ``staging`` and ``test`` cuts (the
  bodies are the whole kernel, ``full``);

``full`` is the source as it is.  ``--kernel`` picks one template (both
by default).  With ``--parent DIR``, the ``csrc/fluid.cu`` of another
checkout is built whole and in the same cuts: the cuts are kept for each
template's one-warp-a-slot design and, for the rates/wall template, for
the one-thread-a-lane design it replaced (a thread a query lane walking
every candidate lane); each source takes the set whose anchors it holds.
On ``chip_smoke.py``'s coupling scenes (the sinking box: B4, B5, B6a with
EDAC and with Tait, B6b and B6c with bodies; the box on the tank floor:
B5 with gated contact pairs; the fluid-only tank: B4 and B6c without
bodies, all at ~96.9k particles with seeded random velocities and body
``p_fsi``) it prints each build's time per launch: CUDA events over 50
launches into a preallocated output, behind a device sleep so the host's
enqueue is not timed.  The full builds and the parent's are checked
against the wrapper's output: B5's 12 S contact columns bit for bit,
every other column within ``FLUID_SUM_RTOL`` of its largest magnitude,
and "(=)" marks an output equal to the wrapper's bit for bit; the
cut-down copies compute less by design.  Also prints ptxas's
registers, shared memory and spills for each instance of both templates,
and the dynamic shared memory a block takes at the scenes' M.  Every
build is of the quintic spline (no ``-DRB_SPH_KERNEL``); a source of
before the kernel family had its own libraries takes no SPH kernel id.

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

# forces_kernel, one warp a slot: staged windows, forces over the listed
# queries, contact threads over the contact list, the block written whole
_WARP_ROWS = "  if (nq == 0) {\n"
_WARP_FORCES = "    for (int c0 = fp; fact && c0 < n; c0 += 32 * P) {\n"
_WARP_TEST = "      if (hits == 0u) continue;\n"
_WARP_CONTACT = "      if (cs >= 0) {\n        const float* cq = q + cl;\n"
# n and cn are never negative: the loops are skipped at run time
_NO_WARP_CONTACT = (_WARP_CONTACT, _WARP_CONTACT.replace(
    "cs >= 0", "cs >= 0 && cn < 0"))
FORCES_WARP = {
    "rows": [(_WARP_ROWS, "  if (true) {\n")],
    "staging": [(_WARP_FORCES, _WARP_FORCES.replace("fact &&",
                                                    "fact && n < 0 &&")),
                _NO_WARP_CONTACT],
    "test": [(_WARP_TEST, "      au += (float)__popc(hits);\n"
              "      continue;\n"), _NO_WARP_CONTACT],
    "bodies": [_NO_WARP_CONTACT],
}
# rates_wall_kernel, one warp a slot: the query ballot, staged windows,
# range tests into a hit mask, the bodies of the hits
_RW_ROWS = "  if (amask == 0u) {\n"
_RW_SUMS = "    for (int c0 = qp; qact && c0 < n; c0 += 32 * P) {\n"
_RW_TEST = "      if (!hits) continue;\n"
RATES_WARP = {
    "rows": [(_RW_ROWS, "  if (true) {\n")],
    "staging": [(_RW_SUMS, _RW_SUMS.replace("qact &&", "qact && n < 0 &&"))],
    "test": [(_RW_TEST, "      acc[0] += (float)__popc(hits);\n"
              "      continue;\n")],
}
# rates_wall_kernel, one thread a query lane (before the redesign): each
# lane walks every candidate lane of its stencil in order
_RW_LANE_ROWS = "  if (dest_fluid || dest_solid) {\n"
_RW_LANE_TEST = "        const float rij = sqrtf(r2);\n" \
    "        if (!(rij <= cutoff)) continue;\n" \
    "        const Flags sf = decode(field(s, FFLAGS, M, k));\n"
_RW_LANE_GATE = "        if (!(rates || wall)) continue;\n"
RATES_LANE = {
    "rows": [(_RW_LANE_ROWS, "  if (false) {\n")],
    "staging": [(_RW_LANE_TEST, "        arho += xij + yij + zij;\n"
                 "        continue;\n" + _RW_LANE_TEST)],
    "test": [(_RW_LANE_GATE, _RW_LANE_GATE + "        arho += 1.0f;\n"
              "        continue;\n")],
}
DESIGNS = {"forces": {"warp": FORCES_WARP},
           "rates": {"warp": RATES_WARP, "lane": RATES_LANE}}


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


def cut_sources(path, prefix, kernels):
    """{name: (source, its header directory)} for ``path`` whole
    (``<prefix>full``) and in the cuts of each template in ``kernels``
    (``<prefix><template> <cut>``), each in the design whose anchors the
    source holds."""
    with open(path) as f:
        text = f.read()
    inc = os.path.dirname(path)
    srcs = {prefix + "full": (path, inc)}
    for kernel in kernels:
        for design, cuts in DESIGNS[kernel].items():
            if all(text.count(old) == 1 for edits in cuts.values()
                   for old, _ in edits):
                break
        else:
            raise RuntimeError(f"{path}: holds no {kernel} design's cut "
                               "anchors")
        for name, edits in cuts.items():
            cut = text
            for old, new in edits:
                cut = cut.replace(old, new)
            label = f"{prefix}{kernel} {name}"
            out = os.path.join(OUT, label.replace(" ", "_") + ".cu")
            with open(out, "w") as f:
                f.write(cut)
            srcs[label] = (out, inc)
        print(f"[fluid-variants] {path}: the {kernel} template's "
              f"{design!r} design", flush=True)
    return srcs


def usage(report):
    """ptxas's numbers for the instances of both templates, one line
    each (``<KDIM2, VISC, FSI, CONTACT>``, ``<KDIM2, EDAC, HAS_RIGID,
    MODE>``)."""
    lines = []
    for entry, u in _build.ptxas_usage(report).items():
        m = re.search(r"(forces_kernel|rates_wall_kernel)I((?:L[bi]\d+E)+)E",
                      entry)
        if m:
            inst = ",".join(re.findall(r"L[bi](\d+)E", m.group(2)))
            lines.append(f"  {m.group(1)}<{inst}>: {u['registers']} "
                         f"registers, {u['smem']} B static smem, spills "
                         f"{u['spill_stores']}/{u['spill_loads']} B")
    return "\n".join(lines)


def cases(dev, kernels):
    """(label, instance, template, wrapper, wrapper args, C entry, C args
    after the sizes, S of the contact columns) on the three scenes."""
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
        tail = tuple(float(v) for v in kernel.sigma_constants())
        visc = abs(scheme.fluid_alpha) > 1e-14
        kd2 = int(kernel.dim == 2)
        rc = float(cfg.radius)
        ac0 = float(-scheme.fluid_alpha * scheme.c0)
        nu, c0 = scheme.edac_nu, scheme.c0
        g = (scheme.gx, scheme.gy, scheme.gz)
        fg = tuple(float(v) for v in g)
        body = len(scheme.rigid_bodies) > 0
        base = (dfT, nbr, kernel, cfg.radius)
        if "forces" in kernels:
            fbase = base + (scheme.fluid_alpha, c0)
            if body:
                out.append((label, "B5", "forces", fk.fluid_forces_contact,
                            fbase + (S, init), "fluid_forces_contact",
                            (S, kd2, int(visc), rc, ac0, float(init))
                            + tail, S))
            if label != "box on floor":
                out.append((label, "B6c" + (" with bodies" if body else ""),
                            "forces", fk.fluid_forces, fbase + (body,),
                            "fluid_forces",
                            (kd2, int(visc), int(body), rc, ac0) + tail, 0))
        if "rates" in kernels and label != "box on floor":
            rates = (rc, float(2.0 * nu), float(c0 * c0))
            out.append((label, "B4" + (" with bodies" if body else ""),
                        "rates", fk.fluid_rates_wall,
                        base + (nu, c0, scheme.edac, body, g),
                        "fluid_rates_wall",
                        (kd2, int(scheme.edac), int(body)) + rates + fg
                        + tail, 0))
            if body:
                for edac in (True, False):
                    out.append((label, "B6a " + ("EDAC" if edac else "Tait"),
                                "rates", fk.fluid_rates,
                                base + (nu, c0, edac, True), "fluid_rates",
                                (kd2, int(edac), 1) + rates + tail, 0))
                out.append((label, "B6b", "rates", fk.wall_bc, base + (g,),
                            "wall_bc", (kd2, rc) + fg + tail, 0))
    return out


def with_id(entry, cargs, sph_id, takes_id):
    """The C entry's argument types and its arguments after the sizes:
    the SPH kernel's id after the leading ints where the source takes it
    (``sph_id``), none before the kernel family had its own libraries."""
    argtypes = list(_build.KERNELS[entry][2])
    n_int = next(i for i, a in enumerate(cargs) if isinstance(a, float))
    if takes_id:
        return argtypes, cargs[:n_int] + (sph_id,) + cargs[n_int:]
    del argtypes[6 + n_int]      # 3 pointers, NC, O, M, the ints
    return argtypes, cargs


def time_case(case, libs, no_id=()):
    label, inst, kernel, wrapper, wargs, entry, cargs, S = case
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
        if not (name.endswith("full") or f"{kernel} " in name):
            continue
        fn = getattr(lib, entry)
        fn.argtypes, args = with_id(entry, cargs, wargs[2].device_id,
                                    name not in no_id)
        fn.restype = ctypes.c_int
        call = lambda: fn(*ptrs, NC, O, M, *args, stream)
        out.fill_(float("nan"))
        if call() != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        same = ""
        if name.endswith("full"):
            cs.check(torch.equal(out[..., :12 * S], ref[..., :12 * S]),
                     f"{label} {inst} {name}: contact columns differ from "
                     "the wrapper's")
            cs.check_fluid_columns(out, ref, range(12 * S, ref.shape[-1]),
                                   f"{label} {inst} {name}")
            same = " (=)" if torch.equal(out, ref) else " (sums differ)"
        line.append(f"{name} {cs.cuda_ms(call, reps=REPS):.4f}{same}")
    print(" | ".join(line), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose csrc/fluid.cu to "
                    "time beside this one")
    ap.add_argument("--kernel", choices=sorted(DESIGNS),
                    help="cut and time one template (default: both)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fluid_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)
    kernels = [args.kernel] if args.kernel else sorted(DESIGNS)
    srcs = cut_sources(SOURCE, "", kernels)
    if args.parent:
        srcs.update(cut_sources(os.path.join(
            args.parent, "rigid_body_2d_3d_pysph_tpu_torch", "csrc",
            "fluid.cu"), "parent ", kernels))
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(lambda kv: build(kv[0], *kv[1]),
                              srcs.items()))
    no_id = set()
    for name, (path, _) in srcs.items():
        with open(path) as f:
            if "sph_id" not in f.read():
                no_id.add(name)
    libs = {}
    for name, path, report in built:
        if path is None:
            print(f"[fluid-variants] build {name} failed:\n{report}",
                  file=sys.stderr)
            return 1
        if name.endswith("full"):
            print(f"[fluid-variants] build {name}:\n{usage(report)}",
                  flush=True)
        libs[name] = ctypes.CDLL(path)
    smem = {k: _build.load(k) for k in _build.HELPERS}
    print("[fluid-variants] dynamic smem a block at M = 16: " + ", ".join(
        f"{k}(W={w}) {smem[k](16, w)} B" for k, w in (
            ("fluid_rates_wall_smem", 7), ("fluid_rates_wall_smem", 2),
            ("fluid_rates_wall_smem", 5), ("fluid_forces_smem", 6),
            ("fluid_forces_smem", 30))), flush=True)
    print(f"[fluid-variants] {cs.smi_line()}", flush=True)
    dev = torch.device("cuda", 0)
    try:
        for case in cases(dev, kernels):
            time_case(case, libs, no_id)
    except cs.PhaseError as e:
        print(f"fluid_variants: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
