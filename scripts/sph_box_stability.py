#!/usr/bin/env python3
"""The sinking box's fluid density under each SPH kernel, step by step.

    python3 scripts/sph_box_stability.py [--kernels super_gaussian,quintic]
        [--steps 30] [--n 100000] [--ordering kdkf] [--device cpu|cuda]

Sets up ``chip_smoke.py``'s sinking box (``sinking_box_scene``: the case's
tank, fluid and box at ~n particles, its dt) with each kernel and runs the
coupling step in ``--ordering``, printing the fluid's min and max rho / rho0
every 5 steps.  On the CPU the kernel wrappers run their plain versions
(which the CPU tests hold to the JAX package), on the card the kernels.
The super-Gaussian is negative beyond q = sqrt(d / 2 + 1), and the fluid
diverges under it where the other kernels hold rho within 0.1 % of rho0.

It imports nothing from JAX.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="super_gaussian,quintic")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--ordering", default="kdkf",
                    choices=("kdkf", "kdk", "reference"))
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)
    for k in args.kernels.split(","):
        scheme, scene, dt = cs.sinking_box_scene(dev, n_target=args.n,
                                                 kernel=k)
        scheme.gtvf_ordering = args.ordering
        step = scheme.make_step(scene)
        fl = scene.is_fluid
        out = []
        for i in range(args.steps):
            scene = step(scene, dt)
            if (i + 1) % 5 == 0:
                r = scene.rho[fl] / scheme.rho0
                out.append(f"{i + 1}: {float(r.min()):.4f}-"
                           f"{float(r.max()):.4f}")
        print(f"{k} {args.ordering} n={scene.n} dt={dt:.4g} on {dev}: "
              + "; ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
