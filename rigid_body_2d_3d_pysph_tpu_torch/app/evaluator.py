"""One-shot evaluation of pair passes outside the solver loop.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/app/evaluator.py`` (the
reference's ``SPHEvaluator``): ``evaluate_once`` builds a neighbour list
at the scene's current positions and runs ``fn(scene, nbrs, kernel)``
once; ``fn`` returns a dict of fields to set, or a scene.
"""

from __future__ import annotations

from ..ops import neighbors as nbmod
from ..ops.kernels import get_kernel
from ..state.scene import Scene


def evaluate_once(scene: Scene, fn, kernel_name: str = "quintic",
                  dim: int | None = None,
                  cfg: nbmod.NeighborConfig | None = None) -> Scene:
    dim = dim or scene.meta.dim
    kernel = get_kernel(kernel_name, dim)
    if cfg is None:
        host = lambda k: scene[k].detach().cpu().numpy()
        cutoff = float(kernel.radius_scale * host("h").max())
        m, k = nbmod.estimate_capacities(host("x"), host("y"), host("z"),
                                         cutoff, dim)
        cfg = nbmod.default_config(dim, cutoff, scene.n, max_neighbors=k,
                                   max_per_cell=m)
    nbrs = nbmod.build_neighbors(scene.x, scene.y, scene.z, scene.active, cfg)
    updates = fn(scene, nbrs, kernel)
    return scene.replace(**updates) if isinstance(updates, dict) else updates
