"""The hand-written CUDA kernels against their plain PyTorch twins, on
the card.  Every test here needs an NVIDIA card and ``nvcc``; without a
card they skip.  This file imports no JAX, so on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances: the pack expansion is a copy (bit-exact); the contact
kernel's pick columns (closest distance, picked source fields) are a
minimum and copies (bit-exact, the kernel is built without FMA
contraction); its sum-derived columns differ from the twin's only by
summation order (f32: rtol 1e-5, absolute floor 1e-5 of the column's
largest magnitude).
"""

import numpy as np
import pytest
import torch

from rigid_body_2d_3d_pysph_tpu_torch.geom import get_2d_block, get_3d_block
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
from rigid_body_2d_3d_pysph_tpu_torch.ops import pack_expand as tpe
from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import QuinticSpline
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group, build_scene, rigid_setup, ROLE_RIGID, ROLE_BOUNDARY)

pytestmark = pytest.mark.cuda
PARAMS = dict(kr=1e5, kf=1e3, fric_coeff=0.5, gx=0.0, gy=-9.81, gz=0.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _scene(dim, dev, dx=0.02):
    """Two touching blocks just above a wall/floor, random velocities."""
    rng = np.random.default_rng(3)
    if dim == 2:
        xb, yb = get_2d_block(dx, 0.2, 0.2)
        zb = np.zeros_like(xb)
        xw = np.arange(-10, 30) * dx
        zw = np.zeros_like(xw)
    else:
        xb, yb, zb = get_3d_block(dx, 0.1, 0.1, 0.1)
        xw, zw = (a.ravel() for a in np.meshgrid(np.arange(-5, 15) * dx,
                                                 np.arange(-5, 10) * dx))
    width = xb.max() - xb.min()
    x = np.concatenate([xb, xb + width + 0.6 * dx])
    y = np.concatenate([yb, yb])
    z = np.concatenate([zb, zb])
    bid = np.repeat(np.arange(2, dtype=np.int32), len(xb))
    yw = np.full(len(xw), yb.min() - 0.7 * dx)
    m = 2000 * dx**dim
    body = make_group("body", x, y, z=z, m=m, h=1.3 * dx, rho=2000.0,
                      role=ROLE_RIGID, body_id=bid, dem_id=bid)
    wall = make_group("wall", xw, yw, z=zw, m=m, h=1.3 * dx, rho=2000.0,
                      role=ROLE_BOUNDARY, dem_id=2)
    scene = build_scene([body, wall], dim=dim, total_no_bodies=3,
                        spacing0=dx, device=dev, dtype=torch.float32)
    scene = trb._attach_contact_fields(rigid_setup.setup_body_state(scene))
    n = scene.n
    vel = lambda: torch.as_tensor(rng.uniform(-1, 1, n), dtype=torch.float32,
                                  device=dev)
    scene = scene.replace(contact_force_is_boundary=torch.ones(
        n, dtype=torch.float32, device=dev), u=vel(), v=vel())
    if dim == 3:
        scene = scene.replace(w=vel())
    host = lambda k: scene[k].cpu().numpy()
    cfg = tcell.config_from_positions(host("x"), host("y"), host("z"),
                                      3 * 1.3 * dx, dim)
    return scene, cfg


@pytest.mark.parametrize("dim", [2, 3])
def test_pack_expand_kernel_is_bitwise_twin(dev, dim):
    scene, cfg = _scene(dim, dev)
    _, pt = tcell.build_cell_grid_packed(
        scene.x, scene.y, scene.z, scene.active, cfg,
        tck.contact_payload(scene, dim == 2))
    sent = torch.tensor(tck.sent_fields(dim == 2), device=dev)
    before = _build.LAUNCHES["pack_expand"]
    got = tpe.expand_slots(pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pack_expand"] == before + 1
    ref = tpe.expand_slots_reference(pt.sorted_fields, pt.base, pt.cnt,
                                      sent, cfg.M)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dim", [2, 3])
def test_contact_kernel_matches_twin(dev, dim):
    scene, cfg = _scene(dim, dev)
    kernel = QuinticSpline(dim=dim)
    S = scene.meta.total_no_bodies
    grid, pt, dfT = tck.pack_scene(scene, cfg)
    qsel, nbr, valid, _, n_int = tck.select_queries(dfT, grid, pt, cfg,
                                                    cfg.NC_max)
    assert int(n_int) > 0
    args = (dfT, qsel, nbr, S, cfg.radius, 4.0 * scene.meta.spacing0,
            kernel)
    before = _build.LAUNCHES["contact"]
    got = tck.contact_sums(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["contact"] == before + 1
    ref = tck.contact_sums_reference(*args)
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    assert (ref[..., 5 * S:6 * S] < 4.0 * scene.meta.spacing0).any()
    np.testing.assert_array_equal(got[..., 5 * S:], ref[..., 5 * S:])
    for c in range(5):
        a, b = got[..., c * S:(c + 1) * S], ref[..., c * S:(c + 1) * S]
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30),
                                   err_msg=f"block {c}")


def test_kernel_step_matches_plain_step(dev):
    scene, cfg = _scene(2, dev)
    ni = cfg.NC_max
    scene = trb.compact_slot_scene(scene, ni * cfg.M)
    kernel = QuinticSpline(dim=2)
    fast = trb.build_rigid_gtvf_step_cell(kernel, cfg, PARAMS, True, ni)
    plain = trb.build_rigid_gtvf_step_cell(kernel, cfg, PARAMS, True, ni,
                                           plain=True)
    a = b = scene
    for _ in range(3):
        a, b = fast(a, 1e-4), plain(b, 1e-4)
    assert not bool(a.nbr_overflow)
    for k in ("x", "y", "u", "v", "fx", "fy", "xcm", "vcm", "omega"):
        x, y = a[k].cpu().numpy(), b[k].cpu().numpy()
        np.testing.assert_allclose(x, y, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(y).max(), 1.0),
                                   err_msg=k)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    scene, cfg = _scene(2, dev)
    _, pt = tcell.build_cell_grid_packed(
        scene.x, scene.y, scene.z, scene.active, cfg,
        tck.contact_payload(scene, True))
    sent = torch.tensor(tck.sent_fields(True), device=dev)
    with pytest.raises(ValueError):
        tpe.expand_slots(pt.sorted_fields.double(), pt.base, pt.cnt,
                         sent.double(), cfg.M)
    with pytest.raises(ValueError):
        tpe.expand_slots(pt.sorted_fields, pt.base.int(), pt.cnt.int(),
                         sent, cfg.M)
    dfT = torch.zeros((4, 7, 16), device=dev)
    q = torch.zeros(2, dtype=torch.int64, device=dev)
    nbr = torch.zeros((2, 9), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        tck.contact_sums(dfT, q, nbr, 65, 0.1, 0.2, QuinticSpline(dim=2))
    with pytest.raises(ValueError):
        tck.contact_sums(dfT, q.int(), nbr.int(), 3, 0.1, 0.2,
                         QuinticSpline(dim=2))
