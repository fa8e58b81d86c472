"""Steps/s of the kdkf coupling step on the compact contact store and on
the full ``[N, S]`` schema, at several body counts S, on one CUDA device.

    python3 scripts/compact_crossover.py [--steps 50] [--repeats 2]
        [--scenes 2:2x4,2:2x8,2:4x8,2:6x8,2:7x9,2:8x8@0.2,2:8x12@0.2,
                  2:8x16@0.2,3:2x4,3:2x8,3:3x8]
        [--out FILE]

Each scene ``dim:rows x cols[@side]`` is ``chip_smoke.py``'s
``boxes_tank_scene``: rows x cols boxes of rho 8 (2D: of side ``side``,
0.25 by default) in the sinking box's tank at ~10^5 particles (S = rows x
cols + 1: up to 64 the contact kernels' narrow instances, past it their
wide ones), set up on the compact store.  The full route runs the
same state expanded to the ``[N, S]`` schema, with the same scheme and
grid.  After a warm-up chunk on each route (the overflow rebuild rule
of ``Solver`` on the compact one), ``--repeats`` blocks of four timed
runs of ``--steps`` steps from that state, in the order compact, full,
full, compact, each timed on the host clock and ending in a
synchronise.  One line a scene: each run's ms/step, the routes' means
and their ratio, the interesting slots against ni_max, the largest
difference of the two routes' end states, and each route's peak device
memory; a JSON line of all of it at the end (also written to
``--out``).  Imports nothing from JAX.
"""

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb  # noqa: E402


def _warm_start(scheme, scene, dt, n):
    """The set-up state with the store (and grid) widened until ``n``
    compact steps run without overflow."""
    for attempt in range(8):
        step = scheme.make_step(scene)
        s = scene
        for _ in range(n):
            s = step(s, dt)
        torch.cuda.synchronize()
        if not bool(s.nbr_overflow):
            return scene, int(attempt)
        scheme.refresh_configs(scene, grow=attempt > 0)
        scene = scheme.adapt_scene(scene)
    raise RuntimeError("overflow persists after 8 rebuilds")


def _timed(step, start, dt, n):
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = start
    for _ in range(n):
        s = step(s, dt)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / n
    if bool(s.nbr_overflow):
        raise RuntimeError("overflow during a timed run")
    return s, ms, torch.cuda.max_memory_allocated() / 2**30


def sweep_scene(dev, dim, rows, cols, n, repeats, side=None):
    t0 = time.perf_counter()
    scheme, scene, dt = cs.boxes_tank_scene(dev, dim, rows=rows, cols=cols,
                                            side=side)
    scene, rebuilds = _warm_start(scheme, scene, dt, n)
    starts = dict(compact=scene,
                  full=trb.strip_compact_fields(trb.expand_slot_scene(scene)))
    steps = {k: scheme.make_step(v) for k, v in starts.items()}
    for k in steps:                                     # first calls
        _timed(steps[k], starts[k], dt, n)
    runs, mem, ends = {"compact": [], "full": []}, {}, {}
    for k in ("compact", "full", "full", "compact") * repeats:
        ends[k], ms, mem[k] = _timed(steps[k], starts[k], dt, n)
        runs[k].append(ms)
    a = trb.expand_slot_scene(ends["compact"])
    b = ends["full"]
    diff = max(float((a[f] - b[f]).abs().max()) for f in b.fields
               if b[f].is_floating_point())
    cfg = scheme._cell_cfg
    mean = {k: sum(v) / len(v) for k, v in runs.items()}
    row = dict(dim=dim, rows=rows, cols=cols, side=side,
               S=scene.meta.total_no_bodies, n=scene.n,
               rigid=int(scene.is_rigid.sum()), NC=cfg.NC_max, M=cfg.M,
               n_interesting=int(ends["compact"].n_interesting),
               ni_max=scheme.ni_max(cfg), rebuilds=rebuilds,
               compact_ms=runs["compact"], full_ms=runs["full"],
               compact_mean_ms=mean["compact"], full_mean_ms=mean["full"],
               compact_over_full=mean["compact"] / mean["full"],
               max_abs_diff=diff, peak_gib=mem,
               seconds=time.perf_counter() - t0)
    fmt = lambda v: "[" + ", ".join(f"{x:.3f}" for x in v) + "]"
    print(f"[crossover] {dim}D {rows}x{cols} S={row['S']} n={row['n']} "
          f"rigid {row['rigid']} NC {cfg.NC_max}: interesting "
          f"{row['n_interesting']} of ni_max {row['ni_max']} (rebuilds "
          f"{rebuilds}); ms/step compact {fmt(runs['compact'])} full "
          f"{fmt(runs['full'])}; means {mean['compact']:.4f} / "
          f"{mean['full']:.4f} (ratio {row['compact_over_full']:.4f}); "
          f"max |compact - full| {diff:.3e}; peak GiB compact "
          f"{mem['compact']:.2f} full {mem['full']:.2f} "
          f"({row['seconds']:.1f} s)", flush=True)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--scenes", default="2:2x4,2:2x8,2:4x8,2:6x8,2:7x9,"
                    "2:8x8@0.2,2:8x12@0.2,2:8x16@0.2,3:2x4,3:2x8,3:3x8")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compact_crossover: no CUDA device", file=sys.stderr)
        return 2
    smi = cs.smi_line()
    print(f"[env] {smi}", flush=True)
    dev = torch.device("cuda", 0)
    rows = []
    for spec in args.scenes.split(","):
        dim, shape = spec.split(":")
        shape, _, side = shape.partition("@")
        r, c = (int(v) for v in shape.split("x"))
        rows.append(sweep_scene(dev, int(dim), r, c, args.steps,
                                args.repeats, float(side) if side else None))
    out = dict(device=smi, steps=args.steps, repeats=args.repeats,
               scenes=rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
