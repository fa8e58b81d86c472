"""Snapshot viewer: render a port run's output frames to PNGs (and
optionally an animated GIF).

The counterpart of the repository's ``view_snapshots.py`` (same options,
same output), reading the snapshots through this package's
``app/output.py``, so it needs neither JAX nor the JAX package.  A host
tool: it needs ``matplotlib`` (and Pillow for ``--gif``), imported only
when it draws.

Usage:
  python -m rigid_body_2d_3d_pysph_tpu_torch.tools.view_snapshots \\
      benchmark_3_output                          # every 10th snapshot
  python -m rigid_body_2d_3d_pysph_tpu_torch.tools.view_snapshots \\
      sinking_box_output --every 50 --field p
  python -m rigid_body_2d_3d_pysph_tpu_torch.tools.view_snapshots \\
      stack_of_cylinders_output --gif

Frames land in ``<output_dir>/frames/``, the GIF in
``<output_dir>/animation.gif``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..app import output as out_mod


def render(output_dir: str, every: int = 10, field: str | None = None,
           gif: bool = False, size: float = 2.0) -> list:
    """One scatter plot a snapshot (every ``every``-th), coloured by
    group or by ``field``; returns the PNG paths."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    files = out_mod.get_files(output_dir)[::every]
    if not files:
        print(f"no snapshots in {output_dir}")
        return []
    frame_dir = os.path.join(output_dir, "frames")
    os.makedirs(frame_dir, exist_ok=True)

    # fixed axes from the first + last frame extents
    _, g0 = out_mod.load(files[0])
    _, gl = out_mod.load(files[-1])
    xs = np.concatenate([np.concatenate([g.x for g in gs.values()])
                         for gs in (g0, gl)])
    ys = np.concatenate([np.concatenate([g.y for g in gs.values()])
                         for gs in (g0, gl)])
    pad = 0.05 * max(np.ptp(xs), np.ptp(ys))
    xlim = (xs.min() - pad, xs.max() + pad)
    ylim = (ys.min() - pad, ys.max() + pad)

    paths = []
    for f in files:
        sd, groups = out_mod.load(f)
        fig, ax = plt.subplots(figsize=(6, 6 * (ylim[1] - ylim[0])
                                        / max(xlim[1] - xlim[0], 1e-9)))
        for name, g in sorted(groups.items()):
            if field and hasattr(g, field):
                sc = ax.scatter(g.x, g.y, c=getattr(g, field), s=size,
                                cmap="viridis")
            else:
                ax.scatter(g.x, g.y, s=size, label=name)
        if field:
            fig.colorbar(sc, ax=ax, label=field)
        else:
            ax.legend(loc="upper right", markerscale=4)
        ax.set_xlim(*xlim)
        ax.set_ylim(*ylim)
        ax.set_aspect("equal")
        ax.set_title(f"t = {float(sd['t']):.4f} s")
        p = os.path.join(frame_dir,
                         os.path.basename(f).replace(".npz", ".png"))
        fig.savefig(p, dpi=110)
        plt.close(fig)
        paths.append(p)
    print(f"rendered {len(paths)} frames -> {frame_dir}")

    if gif:
        try:
            from PIL import Image
            imgs = [Image.open(p) for p in paths]
            gp = os.path.join(output_dir, "animation.gif")
            imgs[0].save(gp, save_all=True, append_images=imgs[1:],
                         duration=80, loop=0)
            print(f"gif -> {gp}")
        except ImportError:
            print("PIL not available; skipped gif")
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m rigid_body_2d_3d_pysph_tpu_torch.tools."
             "view_snapshots", description=__doc__.splitlines()[0])
    p.add_argument("output_dir")
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--field", default=None)
    p.add_argument("--gif", action="store_true")
    p.add_argument("--size", type=float, default=2.0)
    a = p.parse_args(argv)
    render(a.output_dir, a.every, a.field, a.gif, a.size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
