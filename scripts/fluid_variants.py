#!/usr/bin/env python3
"""Where the fluid kernels' time goes, on one CUDA card.

    python3 scripts/fluid_variants.py [--parent DIR] [--kernel forces|rates]
                                      [--no-wide]

Run from the repository root on the machine with the card.  It builds
``csrc/fluid.cu`` as it is and in cut-down copies of one of its two
templates, each with ``nvcc`` into ``build/fluid_variants/``:

* ``forces_kernel`` (B5 ``fluid_forces_contact``, B6c ``fluid_forces``):
  ``rows`` the output rows only (no stencil read, no contact pass: B5's
  contact rows all init rows); ``staging`` also the walk of the stencil
  and the loads of its candidates, no candidate tested; ``test`` also
  each query's distance test of the candidates, no force body;
  ``bodies`` also the force bodies (B6c whole; B5 without its contact
  sums); ``nofill`` B5 whole but the init rows of its contact rows, so
  the full build's time less this one is theirs; ``nocontact`` B5
  without its contact phase (the forces and the output rows alone);
  ``lb4`` B5 whole, held to 4 blocks an SM (its registers not capped at
  96);
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
``p_fsi``; unless ``--no-wide``, the tank with 8 layers of 16 boxes, S
= 129, and with 6 layers of 50, S = 301, phase 45's scenes: B5 on the
compact store) it prints each build's time per launch: CUDA events over
50 launches into a preallocated output, behind a device sleep so the
host's enqueue is not timed.  B5 runs in the layout of the scene's kdkf
step (``chip_smoke.b5_layout``: by particle on the full route, by query
row at the light cull's slots on the compact store); a parent whose B5
writes a slot's whole ``[M, 12 S + 6]`` block (its entry takes
``gmem``) is compared at those rows (laid out by particle with
``contact_kernel.rows_by_particle``) and timed alone and with the copy
its step made after it (``+copy``: the gather of the culled rows, or
the unpack).  The full builds and the parent's are checked against the
wrapper's output: B5's 12 S contact columns bit for bit, every other
column within ``FLUID_SUM_RTOL`` of its largest magnitude, and "(=)"
marks an output equal to the wrapper's bit for bit; the cut-down copies
compute less by design.  Also prints ptxas's
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

# forces_kernel, one warp a slot, B5's contact columns written where the
# step reads them: staged windows, forces over the listed queries,
# contact threads a (rigid lane, dem with candidates) over the contact
# list
_W2_FORCES = "    for (int c0 = fp; fact && c0 < ns; c0 += 32 * P) {\n"
_W2_CONTACT = "        if (cs >= 0 && !own) {\n"
_NO_W2_CONTACT = (_W2_CONTACT, _W2_CONTACT.replace("!own", "!own && cn < 0"))
FORCES_WARP_ROWS = {
    "rows": [("  if (nq == 0) {\n", "  if (true) {\n")],
    "staging": [(_W2_FORCES, _W2_FORCES.replace("fact &&",
                                                "fact && ns < 0 &&")),
                _NO_W2_CONTACT],
    "test": [("      if (hits == 0u) continue;\n",
              "      au += (float)__popc(hits);\n      continue;\n"),
             _NO_W2_CONTACT],
    "bodies": [_NO_W2_CONTACT],
    "nofill": [("  if (!__any_sync(kFull, crow[lane] >= 0)) return;  // no row is "
                "read\n  fill_rows();\n",
                "  if (!__any_sync(kFull, crow[lane] >= 0)) return;\n"
                "  if (S < 0) fill_rows();\n")],
    # B5 without its contact phase (the register pressure it adds)
    "nocontact": [("  if (!CONTACT) return;\n", "  return;\n")],
    # B5 held to 4 blocks an SM (128 registers a thread, no spill)
    "lb4": [("__launch_bounds__(kWarps * 32, CONTACT ? 5 : 6)",
             "__launch_bounds__(kWarps * 32, CONTACT ? 4 : 6)")],
}
# forces_kernel as before: the same, the slot's whole [M, 12 S + 6] block
# written from shared memory (or in place in the output)
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
DESIGNS = {"forces": {"warp-rows": FORCES_WARP_ROWS, "warp": FORCES_WARP},
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


def scenes(dev, wide):
    """(label, scheme, set-up scene) of the timed scenes."""
    for label, kw in (("sinking box", {}), ("box on floor", dict(floor=True)),
                      ("tank", dict(body=False))):
        scheme, scene, _ = cs.sinking_box_scene(dev, **kw)
        yield label, scheme, scene
    if wide:
        for label, kw in (
                ("boxes S=129", dict(rows=cs.WIDE_BOX_129[0],
                                     cols=cs.WIDE_BOX_129[1],
                                     side=cs.WIDE_BOX_129[2])),
                ("boxes S=301", dict(rows=cs.WIDE_BOX_ROWS,
                                     cols=cs.WIDE_BOX_COLS,
                                     side=cs.WIDE_BOX_SIDE,
                                     kr=cs.WIDE_BOX_KR,
                                     min_overlap=cs.WIDE_BOX_OVERLAP))):
            scheme, scene, _ = cs.boxes_tank_scene(dev, 2, compact=None,
                                                   **kw)
            yield label, scheme, scene


def cases(dev, kernels, wide):
    """(label, instance, template, wrapper, wrapper args, C entry, C args
    after the sizes, S of the contact columns, B5's layout and the
    grid's (grid, cfg, n)) on the scenes."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    out = []
    for label, scheme, scene in scenes(dev, wide):
        kernel = get_kernel(scheme.kernel_name, scheme.dim)
        cfg = scheme.cell_config(scene, kernel)
        gen = torch.Generator(device=dev).manual_seed(17)
        rnd = lambda a: (torch.rand(scene.n, generator=gen, device=dev)
                         - 0.5) * a
        scene = scene.replace(u=rnd(0.2), v=rnd(0.2), p_fsi=torch.where(
            scene.is_rigid, rnd(2.0), scene.p_fsi))
        grid, pt, dfT = fk.pack_fluid_sorted(scene, cfg)
        cs.check(not bool(grid.overflow), f"{label}: grid overflow")
        unp = (grid, cfg, scene.n)
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
                lay = cs.b5_layout(scheme, scene, grid, pt, dfT, cfg)
                out.append((label, "B5 by " + next(iter(lay)), "forces",
                            fk.fluid_forces_contact, fbase + (S, init),
                            "fluid_forces_contact",
                            (kd2, int(visc), rc, ac0, float(init)) + tail,
                            S, lay, unp))
            if label.startswith("boxes"):
                continue
            if label != "box on floor":
                out.append((label, "B6c" + (" with bodies" if body else ""),
                            "forces", fk.fluid_forces, fbase + (body,),
                            "fluid_forces",
                            (kd2, int(visc), int(body), rc, ac0) + tail, 0,
                            None, None))
        if "rates" in kernels and label in ("sinking box", "tank"):
            rates = (rc, float(2.0 * nu), float(c0 * c0))
            out.append((label, "B4" + (" with bodies" if body else ""),
                        "rates", fk.fluid_rates_wall,
                        base + (nu, c0, scheme.edac, body, g),
                        "fluid_rates_wall",
                        (kd2, int(scheme.edac), int(body)) + rates + fg
                        + tail, 0, None, None))
            if body:
                for edac in (True, False):
                    out.append((label, "B6a " + ("EDAC" if edac else "Tait"),
                                "rates", fk.fluid_rates,
                                base + (nu, c0, edac, True), "fluid_rates",
                                (kd2, int(edac), 1) + rates + tail, 0,
                                None, None))
                out.append((label, "B6b", "rates", fk.wall_bc, base + (g,),
                            "wall_bc", (kd2, rc) + fg + tail, 0, None,
                            None))
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


# B5 of a source that writes a slot's whole [M, 12 S + 6] block: dft, nbr,
# out, NC, O, M, S, gmem, kdim2, visc, sph_id, 5 floats, stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
BLOCK_B5_ARGS = [_P] * 3 + [_I] * 8 + [_F] * 5 + [_P]


def block_gmem(M, S):
    """Whether such a source assembles the block in the output: past one
    warp's share of 227 KB of shared memory (its staging 1,984 words)."""
    return 4 * (1984 + ((M * (12 * S + 6) + 3) & ~3)) > 227 * 1024


def time_b5(case, libs, block):
    """B5 in the scene's layout: each build of the forces template, the
    parent's in its own layout compared at the same rows."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck

    label, inst, kernel, wrapper, wargs, entry, cargs, S, lay, unp = case
    dfT, nbr, kern = wargs[0], wargs[1], wargs[2]
    rf, rc = wrapper(*wargs, **lay)
    NC, O = nbr.shape
    M = dfT.shape[2]
    fout, cout = torch.empty_like(rf), torch.empty_like(rc)
    dense = torch.empty((NC, M, 12 * S + 6), dtype=torch.float32,
                        device=dfT.device)
    stream = torch.cuda.current_stream(dfT.device).cuda_stream
    rows, lanes = lay.get("rows"), lay.get("lanes")
    if rows is not None:
        ptrs, NI, n = (rows.data_ptr(), None, None), rows.shape[0], 0
        real = rows < NC
        rows_c = torch.clamp(rows, max=NC - 1)
        copy = lambda: dense[rows_c]
    else:
        ptrs = (None, lanes.lane_pid.data_ptr(), lanes.dense_pos.data_ptr())
        NI, n = 0, lanes.n
        grid, cfg, n_p = unp
        copy = lambda: tcell.unpack(grid, cfg, dense, n_p, 0.0)
    kd2, visc, floats = cargs[0], cargs[1], cargs[2:]
    line = [f"[fluid-variants] {label} {inst} ({rc.shape[0]} contact rows): "
            f"wrapper {cs.cuda_ms(lambda: wrapper(*wargs, **lay), reps=REPS):.4f} ms"]
    for name, lib in libs.items():
        if not (name.endswith("full") or f"{kernel} " in name):
            continue
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        if name in block:
            fn.argtypes = BLOCK_B5_ARGS
            gm = int(block_gmem(M, S))
            call = lambda: fn(dfT.data_ptr(), nbr.data_ptr(),
                              dense.data_ptr(), NC, O, M, S, gm, kd2, visc,
                              kern.device_id, *floats, stream)
            dense.fill_(float("nan"))
        else:
            fn.argtypes = _build.KERNELS[entry][2]
            call = lambda: fn(dfT.data_ptr(), nbr.data_ptr(),
                              fout.data_ptr(), cout.data_ptr(), *ptrs, NC, O,
                              M, S, NI, n, kd2, visc, kern.device_id,
                              *floats, stream)
            fout.fill_(float("nan"))
            cout.fill_(float("nan"))
        if call() != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        same = ""
        if name.endswith("full"):
            gf, gc, want = fout, cout, rc
            if name in block:
                gf, gc = dense[..., 12 * S:], dense[..., :12 * S]
                if rows is not None:
                    gc, want = gc[rows_c][real], rc[real]
                else:
                    gc = tck.rows_by_particle(
                        gc, torch.arange(NC, device=dfT.device), lanes)
            cs.check(torch.equal(gc[..., 5 * S:], want[..., 5 * S:]),
                     f"{label} {inst} {name}: contact picks differ from the "
                     "wrapper's")
            cs.check_fluid_columns(gf, rf, range(6), f"{label} {inst} {name}")
            same = (" (=)" if torch.equal(gc, want) and torch.equal(gf, rf)
                    else " (sums differ)")
        line.append(f"{name} {cs.cuda_ms(call, reps=REPS):.4f}{same}")
        if name in block and name.endswith("full"):
            both = lambda: (call(), copy())
            line.append(f"{name}+copy {cs.cuda_ms(both, reps=REPS):.4f}")
    print(" | ".join(line), flush=True)


def time_case(case, libs, no_id=(), block=()):
    label, inst, kernel, wrapper, wargs, entry, cargs, S, lay, _ = case
    if entry == "fluid_forces_contact":
        return time_b5(case, libs, block)
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
            cs.check_fluid_columns(out, ref, range(ref.shape[-1]),
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
    ap.add_argument("--no-wide", action="store_true",
                    help="leave out the scenes of 129 and 301 entities")
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
    no_id, block = set(), set()
    for name, (path, _) in srcs.items():
        with open(path) as f:
            text = f.read()
        if "sph_id" not in text:
            no_id.add(name)
        if "int gmem" in text:
            block.add(name)
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
            ("fluid_rates_wall_smem", 5))) + ", " + ", ".join(
        f"fluid_forces_smem(S={S}) {smem['fluid_forces_smem'](16, S)} B"
        for S in (0, 2, 129, 301)), flush=True)
    print(f"[fluid-variants] {cs.smi_line()}", flush=True)
    dev = torch.device("cuda", 0)
    try:
        for case in cases(dev, kernels, not args.no_wide):
            time_case(case, libs, no_id, block)
    except cs.PhaseError as e:
        print(f"fluid_variants: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
