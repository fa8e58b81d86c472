"""The sinking box under the super-Gaussian kernel in both packages, f64.

    JAX_PLATFORMS=cpu python scripts/check_super_gaussian_ref.py \
        [--n 20000] [--steps 60] [--kernels super_gaussian,quintic]

Builds ``chip_smoke.py``'s sinking box (``sinking_box_scene``: the case's
4 x 3 fluid block in a 3-layer tank, a 1 x 0.5 box of rho 2 at the
surface, hydrostatic pressure, the box's displaced-fluid shadow mass and
density, h = dx, dt = 0.25 dx / (1.1 c0)) with the JAX package at ~n
particles, sets it up there on the cell engine with each kernel, carries
the set-up state to the port (``state.convert.scene_from_numpy``, the
reference's grid configuration) and runs the fused kdkf step of both
packages in float64 on the CPU: the JAX package's XLA cell branch, the
port's plain versions of B4 and B5.  Every 5 steps it prints both
fluids' rho / rho0 range and the largest difference of rho, x and y
between the packages.

The super-Gaussian is negative past q = sqrt(d / 2 + 1); on the port the
fluid's density diverges under it (``scripts/sph_box_stability.py``).
If the JAX package's step diverges the same way, step for step, the
kernel's negative tail is the cause and not the port.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
os.environ["RB_TPU_X64"] = "1"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

from rigid_body_2d_3d_pysph_tpu import geom as jgeom  # noqa: E402
from rigid_body_2d_3d_pysph_tpu.models.rigid_fluid_coupling import (  # noqa: E402,E501
    RigidFluidCouplingScheme as JRFC)
from rigid_body_2d_3d_pysph_tpu.state import (  # noqa: E402
    make_group, build_scene)

from test_torch_coupling_step import port_twin  # noqa: E402


def sinking_box(n_target, kernel):
    """The JAX scheme and set-up scene of ``chip_smoke.sinking_box_scene``
    at ~n_target particles, and its dt."""
    dx = 0.02 * np.sqrt(33_000.0 / max(n_target, 2000))
    L, rho_f, gy = 1.0, 1.0, -1.0
    co = 10 * np.sqrt(2 * 9.81 * 3.0 * L)
    xf, yf, xt, yt = jgeom.hydrostatic_tank_2d(4.0 * L, 3.0 * L, 5.0 * L,
                                               3, dx, dx)
    p0 = -rho_f * gy * (yf.max() - yf)
    xb, yb = jgeom.get_2d_block(dx, L - dx, 0.5 * L - dx)
    xb = xb - (xb.min() - xf.min()) + 1.5 * L
    yb = yb + yf.max() - yb.min() + dx - (0.25 * L + dx / 2.0)
    keep = ~((xf > xb.min() - dx) & (xf < xb.max() + dx)
             & (yf > yb.min() - dx) & (yf < yb.max() + dx))
    groups = [
        make_group("fluid", xf[keep], yf[keep], m=rho_f * dx**2, h=dx,
                   rho=rho_f, role="fluid", p=p0[keep]),
        make_group("tank", xt, yt, m=rho_f * dx**2, h=dx, rho=rho_f,
                   rad_s=dx / 2.0, role="boundary", dem_id=1),
        make_group("body", xb, yb, m=2.0 * dx**2, h=dx, rho=2.0,
                   rad_s=dx / 2.0, role="rigid",
                   body_id=np.zeros(len(xb), np.int32),
                   dem_id=np.zeros(len(xb), np.int32))]
    scene = build_scene(groups, dim=2, total_no_bodies=2, spacing0=dx)
    scheme = JRFC(fluids=["fluid"], boundaries=["tank"],
                  rigid_bodies=["body"], dim=2, rho0=rho_f,
                  p0=rho_f * co**2, c0=co, h=dx, nu=0.0, gy=gy)
    scheme.engine, scheme.kernel_name = "cell", kernel
    scene = scheme.setup(scene)
    rb = np.asarray(scene.is_rigid)
    scene = scene.replace(
        m_fsi=jnp.asarray(np.where(rb, np.asarray(scene.m_fsi)
                                   + rho_f * dx**2, np.asarray(scene.m_fsi))),
        rho_fsi=jnp.asarray(np.where(rb, rho_f, np.asarray(scene.rho_fsi))))
    return scheme, scene, 0.25 * dx / (co * 1.1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--kernels", default="super_gaussian")
    args = ap.parse_args()
    torch.set_num_threads(4)
    for kernel in args.kernels.split(","):
        t0 = time.perf_counter()
        jsch, jscene, dt = sinking_box(args.n, kernel)
        tsch, tscene = port_twin(jsch, jscene, torch.float64)
        tsch.kernel_name = kernel
        jstep, tstep = jsch.make_step(jscene), tsch.make_step(tscene)
        fl = np.asarray(jscene.is_fluid)
        print(f"{kernel}: n={jscene.n} dt={dt:.4g} kdkf, f64 on the CPU "
              f"(set-up {time.perf_counter() - t0:.1f} s)", flush=True)
        for i in range(args.steps):
            jscene = jstep(jscene, jnp.asarray(dt))
            tscene = tstep(tscene, dt)
            if (i + 1) % 5:
                continue
            jr = np.asarray(jscene.rho)[fl] / jsch.rho0
            tr = tscene.rho.numpy()[fl] / tsch.rho0
            diff = {k: float(np.abs(np.asarray(jscene[k])
                                    - tscene[k].numpy()).max())
                    for k in ("rho", "x", "y")}
            print(f"  step {i + 1}: JAX rho/rho0 {jr.min():.6f}-"
                  f"{jr.max():.6f}, port {tr.min():.6f}-{tr.max():.6f}; "
                  "max |JAX - port| " + ", ".join(
                      f"{k} {v:.3e}" for k, v in diff.items()), flush=True)
        print(f"{kernel}: {args.steps} steps in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
