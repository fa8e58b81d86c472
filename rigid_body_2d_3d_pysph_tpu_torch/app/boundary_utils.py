"""One-shot surface identification of a template lattice.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/app/boundary_utils.py``.
Cases with several identical bodies identify the surface particles of
one standalone body and tile the flags across the bodies, because
identifying a packed stack at once reads the touching faces as interior.
The reference runs the three identification passes on its ``[N, K]``
neighbour-list engine; the port runs them on its cell engine
(``run_boundary_identification_cell``), on the host in float64 (the
template is one body's lattice), whatever device the run uses.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.rigid_body import (_attach_contact_fields,
                                 run_boundary_identification_cell)
from ..ops import cellpairs as cellmod
from ..ops.kernels import get_kernel
from ..state.scene import ROLE_RIGID, build_scene, make_group


def _identify(x, y, z, m, h, rho, dim, kernel_name):
    n = len(np.atleast_1d(x))
    g = make_group("tpl", x, y, z, m=m, h=h, rho=rho, rad_s=0.0,
                   role=ROLE_RIGID, body_id=np.zeros(n, np.int32),
                   dem_id=np.zeros(n, np.int32))
    scene = build_scene([g], dim=dim, total_no_bodies=1, spacing0=0.0,
                        device=torch.device("cpu"), dtype=torch.float64)
    scene = _attach_contact_fields(scene)
    kernel = get_kernel(kernel_name, dim)
    host = lambda k: scene[k].numpy()
    cfg = cellmod.config_from_positions(
        host("x"), host("y"), host("z"),
        float(kernel.radius_scale * host("h").max()), dim)
    scene = run_boundary_identification_cell(scene, kernel, cfg, ["tpl"])
    return scene.normal.numpy(), scene.is_boundary.numpy()


def identify_template(x, y, z=None, m=1.0, h=1.0, rho=1.0, dim=2,
                      kernel_name: str = "quintic") -> np.ndarray:
    """Surface flags (int 0/1) of a standalone particle lattice."""
    return _identify(x, y, z, m, h, rho, dim, kernel_name)[1]


def identify_normals_template(x, y, z=None, m=1.0, h=1.0, rho=1.0, dim=2,
                              kernel_name: str = "quintic"):
    """Like :func:`identify_template`, with the normals first."""
    return _identify(x, y, z, m, h, rho, dim, kernel_name)
