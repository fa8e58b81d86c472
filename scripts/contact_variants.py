#!/usr/bin/env python3
"""Where the contact kernel K2's time goes, on one CUDA card.

    python3 scripts/contact_variants.py [--parent DIR] [--cases a,b,...]

Run from the repository root on the machine with the card.  It builds
``csrc/contact.cu`` as it is and in cut-down copies, each with ``nvcc``
into ``build/contact_variants/``:

* ``init``: the query lanes and the init row of every lane with an output
  row only (no stencil read);
* ``staging``: also the two walks of the stencil that sort the
  candidates by dem into shared memory; no candidate tested;
* ``test``: also each query lane's distance test of the candidates, no
  pair body;
* ``bodies``: also the pair bodies, not added up (no sums, no pick, no
  epilogue);
* ``nofill``: the whole kernel but the init rows (the epilogue's stores
  kept): the full build's time less this one is the init rows' stores;
* ``writeonce``: the whole kernel with each entry written once: the init
  row first only on a row with no rigid lane, the init values of the
  dems without a candidate between the two walks, the other entries at
  each dem's end (the epilogue's value or the init value);

and, with ``--parent DIR``, the ``csrc/contact.cu`` of another checkout
whose entry point writes by query row only (no ``lane_pid`` argument):
its output on every slot is laid out by particle
(``contact_kernel.rows_by_particle``, the unpack it replaces) before it
is compared, and it is timed alone and with the unpack its pipeline ran
after it (``parent+unpack``).  Every build is of the quintic spline (no
``-DRB_SPH_KERNEL``).  On ``chip_smoke.py``'s scenes it prints each
build's time per launch in the layout the main path uses: by query row
on the culled rows (2D and 3D rigid GTVF; at S = 129 and 300 the wide
instance), by particle on every slot (the sinking box's and the no-fluid
stack's cell pipeline, the 2D stacks at S = 129 and 300, the 3D cubes
at S = 65), and on 63 cubes (S = 64) the narrow instance against the
wide one on the same inputs (``full narrow`` / ``full wide``, the
parent's the same).  Times are CUDA events over 50 launches into a
preallocated output, behind a device sleep so the host's enqueue is not
timed.  The full build and the parent are checked against the wrapper's
output bit for bit (all add each query lane's pairs in stencil order);
the cut-down copies compute less by design.  Also prints ptxas's
registers, shared memory and spills per kernel instance.

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
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck  # noqa: E402

SOURCE = os.path.join(_build.CSRC, "contact.cu")
OUT = os.path.join(ROOT, "build", "contact_variants")
REPS = 50
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the entry point of a source that writes by query row only
ROWS_ONLY_ARGS = [_P] * 4 + [_I] * 8 + [_F] * 4 + [_P]
# the write-once variant's fill of a chunk's dems without a candidate: a
# warp a lane row, 16-byte words along it, a word at a time beside a dem
# with candidates
_FILL_NO_CANDIDATE = """\
    for (int li = t >> 5; li < M; li += THREADS / 32) {
      if (s_orow[li] < 0) continue;
      float* o = a.out + s_orow[li];
      int c = (4 * lane) / S, d = 4 * lane - c * S;
      for (int i = lane; i < 3 * S; i += 32) {
        float v[4];
        bool keep[4], all = true;
        int cj = c, dj = d;
        for (int j = 0; j < 4; ++j) {
          v[j] = cj == 5 ? a.init_dist : 0.0f;
          keep[j] = dj >= d0 && dj < d0 + ns &&
                    s_seg[dj - d0 + 1] == s_seg[dj - d0];
          all = all && keep[j];
          if (++dj == S) {
            dj = 0;
            ++cj;
          }
        }
        if (all)
          reinterpret_cast<float4*>(o)[i] =
              make_float4(v[0], v[1], v[2], v[3]);
        else
          for (int j = 0; j < 4; ++j)
            if (keep[j]) o[4 * i + j] = v[j];
        if (i + 32 < 3 * S) {
          d += 128;
          while (d >= S) {
            d -= S;
            ++c;
          }
        }
      }
    }
"""
# variant -> the (anchor, replacement) edits of contact.cu that make it
CUTS = {
    "init": [("if (WIDE ? row_skip == NO_RIGID : row_want == 0ull)",
              "if (true)")],
    "staging": [("if (lo >= hi) continue;",
                 "if (lo >= hi || lo >= 0) continue;")],
    "test": [("if (r2 <= thr) {", "if (r2 <= thr && k < 0) {")],
    "bodies": [("if (c == 0 && mine) {", "if (c < 0 && mine) {")],
    "nofill": [("  mofidi::fill_init_rows(a.out,",
                "  if (S < 0) mofidi::fill_init_rows(a.out,")],
    # each entry once: the init row first only where no lane is rigid,
    # the dems without a candidate between the walks, the others at each
    # dem's end (the epilogue's value or the init value)
    "writeonce": [
        ("  mofidi::fill_init_rows(a.out,",
         "  if (WIDE ? s_rowskip == NO_RIGID : s_rowwant == 0ull)\n"
         "    mofidi::fill_init_rows(a.out,"),
        ("    const int total = s_seg[ns];\n",
         "    const int total = s_seg[ns];\n" + _FILL_NO_CANDIDATE),
        ("__ldg(sb + FV * M), TWO_D ? 0.0f : __ldg(sb + FW * M));\n"
         "          }\n",
         "__ldg(sb + FV * M), TWO_D ? 0.0f : __ldg(sb + FW * M));\n"
         "          } else if (orow >= 0) {\n"
         "            for (int cc = 0; cc < 12; ++cc)\n"
         "              a.out[orow + d0 + s + cc * S] =\n"
         "                  cc == 5 ? a.init_dist : 0.0f;\n"
         "          }\n")],
}
CASES = ("2d-culled", "3d-culled", "3d-all-rows", "box-every", "stack-every",
         "s129", "s300", "3d-s65", "3d-s64")


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


def cases(dev, which):
    """(label, kernel arguments, lane map or None, (grid, cfg, n) of an
    unpack or None, chunks to run or None) of the cases in ``which``."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    def pack(scheme, scene):
        kernel = get_kernel(scheme.kernel_name, scheme.dim)
        cfg = scheme.cell_config(scene, kernel)
        scene = cs.seeded_velocities(scene, scheme.dim, 7)
        grid, pt, dfT = tck.pack_scene(scene, cfg, want_dense_pos=True)
        cs.check(not bool(grid.overflow), "grid overflow")
        return kernel, cfg, grid, pt, dfT

    def culled(scheme, scene, ni=None):
        kernel, cfg, grid, pt, dfT = pack(scheme, scene)
        qsel, nbr, _, _, n_int = tck.select_queries(
            dfT, grid, pt, cfg, ni or scheme.ni_max(cfg))
        return (dfT, qsel, nbr, scene.meta.total_no_bodies, cfg.radius,
                4.0 * scene.meta.spacing0, kernel), int(n_int)

    def every(dfT, grid, cfg, kernel, scene):
        return ((dfT, torch.arange(cfg.NC_max, device=dev), grid.nbr_slots,
                 scene.meta.total_no_bodies, cfg.radius,
                 4.0 * scene.meta.spacing0, kernel),
                tcell.lane_map(grid, cfg, scene.n), (grid, cfg, scene.n))

    if {"2d-culled"} & which:
        scheme, scene, _ = cs.contact_scene_2d(dev)
        yield "2D culled", culled(scheme, scene)[0], None, None, None
    if {"3d-culled", "3d-all-rows"} & which:
        scheme, scene, _ = cs.contact_scene_3d(dev)
        args, n_int = culled(scheme, scene)
        if "3d-culled" in which:
            yield (f"3D culled, {args[1].shape[0]} rows", args, None, None,
                   None)
        ni = max(scheme.ni_max(scheme.cell_config(scene, args[-1])), n_int)
        if "3d-all-rows" in which:
            yield (f"3D all rows, {ni}", culled(scheme, scene, ni)[0], None,
                   None, None)
        del scheme, scene
    if "box-every" in which:
        scheme, scene, _ = cs.sinking_box_scene(dev)
        kernel = get_kernel(scheme.kernel_name, scheme.dim)
        cfg = scheme.cell_config(scene, kernel)
        grid, _, dfT = fk.pack_fluid_sorted(scene, cfg)
        yield ("sinking box, every slot",
               *every(tck.contact_pack(dfT, fk.UNION_LAYOUT, True), grid,
                      cfg, kernel, scene), None)
    if "stack-every" in which:
        scheme, scene, _ = cs.contact_scene_2d(dev, coupling=True)
        kernel, cfg, grid, _, dfT = pack(scheme, scene)
        yield ("no-fluid stack, every slot",
               *every(dfT, grid, cfg, kernel, scene), None)
    for key, nb, cols in (("s129", cs.WIDE_BLOCKS, cs.WIDE_COLS),
                          ("s300", cs.WIDE_300, cs.WIDE_300_COLS)):
        if key not in which:
            continue
        scheme, scene, _ = cs.contact_scene_2d(dev, n_bodies=nb, cols=cols)
        S = scene.meta.total_no_bodies
        kernel, cfg, grid, pt, dfT = pack(scheme, scene)
        n_int = int(tck.select_queries(dfT, grid, pt, cfg, cfg.NC_max)[4])
        qsel, nbr, _, _, _ = tck.select_queries(dfT, grid, pt, cfg, n_int)
        yield (f"2D S={S}, {n_int} culled rows",
               (dfT, qsel, nbr, S, cfg.radius, 4.0 * scene.meta.spacing0,
                kernel), None, None, None)
        yield (f"2D S={S}, every slot",
               *every(dfT, grid, cfg, kernel, scene), None)
        del scheme, scene, grid, pt, dfT
    for key, layout in (("3d-s65", cs.WIDE_CUBES), ("3d-s64", (7, 3, 3))):
        if key not in which:
            continue
        scheme, scene, _ = cs.contact_scene_3d(dev, integrator="leapfrog",
                                               layout=layout)
        S = scene.meta.total_no_bodies
        kernel, cfg, grid, _, dfT = pack(scheme, scene)
        chunks = (0, S) if S <= tck.S_NARROW else None
        yield (f"3D S={S} ({layout} cubes), every slot",
               *every(dfT, grid, cfg, kernel, scene), chunks)
        del scheme, scene, grid, dfT


def time_case(label, args, lanes, unpack_of, chunks, libs, rows_only):
    dfT, qslot, nbr, S, cutoff, init, kernel = args
    ref = tck.contact_sums(*args, lanes=lanes)
    NI, O = nbr.shape
    R, M = dfT.shape[0], dfT.shape[2]
    sig_num, sig_den = kernel.sigma_constants()
    out = torch.empty_like(ref)
    rows_out = torch.empty((NI, M, 12 * S), dtype=torch.float32,
                           device=dfT.device)
    stream = torch.cuda.current_stream(dfT.device).cuda_stream
    tail = (float(cutoff), float(init), float(sig_num), float(sig_den),
            stream)
    two_d = int(kernel.dim == 2)
    line = [f"[contact-variants] {label}: wrapper "
            f"{cs.cuda_ms(lambda: tck.contact_sums(*args, lanes=lanes), reps=REPS):.4f} ms"]
    for name, lib in libs.items():
        fn = lib.contact_sums
        for chunk in chunks or (tck.contact_instance(S)[1],):
            tag = name if not chunks else \
                f"{name} {'narrow' if chunk == 0 else 'wide'}"
            if name in rows_only:
                fn.argtypes = ROWS_ONLY_ARGS
                call = lambda: fn(dfT.data_ptr(), qslot.data_ptr(),
                                  nbr.data_ptr(), rows_out.data_ptr(), NI,
                                  O, R, M, S, chunk, two_d,
                                  kernel.device_id, *tail)
                got = rows_out
            else:
                fn.argtypes = _build.KERNELS["contact"][2]
                lp = dp = None
                n = n_lanes = 0
                if lanes is not None:
                    lp, dp = lanes.lane_pid.data_ptr(), \
                        lanes.dense_pos.data_ptr()
                    n, n_lanes = lanes.n, lanes.lane_pid.shape[0]
                call = lambda: fn(dfT.data_ptr(), qslot.data_ptr(),
                                  nbr.data_ptr(), out.data_ptr(), lp, dp,
                                  NI, O, R, M, S, chunk, n, n_lanes, two_d,
                                  kernel.device_id, *tail)
                got = out
            got.fill_(float("nan"))
            if call() != 0:
                raise RuntimeError(f"{tag}: launch failed")
            torch.cuda.synchronize()
            if name in ("full", "parent"):
                cmp = got if lanes is None or name not in rows_only else \
                    tck.rows_by_particle(got, qslot, lanes)
                cs.check(torch.equal(cmp, ref),
                         f"{label} {tag}: output differs from the wrapper's")
            line.append(f"{tag} {cs.cuda_ms(call, reps=REPS):.4f}")
            if name in rows_only and unpack_of is not None:
                grid, cfg, n = unpack_of
                both = lambda: (call(), tcell.unpack(grid, cfg, rows_out, n,
                                                     0.0))
                line.append(f"{tag}+unpack {cs.cuda_ms(both, reps=REPS):.4f}")
    print(" | ".join(line), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout whose csrc/contact.cu to "
                    "time beside this one")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated cases (default: all): "
                    + ", ".join(CASES))
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
    rows_only = set()
    for name, path in srcs.items():
        with open(path) as f:
            if "lane_pid" not in f.read():
                rows_only.add(name)
    print(f"[contact-variants] {cs.smi_line()}", flush=True)
    dev = torch.device("cuda", 0)
    try:
        for case in cases(dev, set(args.cases.split(","))):
            time_case(*case, libs, rows_only)
    except cs.PhaseError as e:
        print(f"contact_variants: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
