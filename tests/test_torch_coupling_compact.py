"""Port vs reference: the kdkf coupling step's compact contact store, the
route the reference takes on its TPU when a scene has S >= 8 entities
(``models/rigid_fluid_coupling.py`` :196-205, :549-579, :716-724).  The
port takes it from ``compact_min_bodies`` entities, off by default; the
tests set the reference's 8.

The scene: a hydrostatic tank with 8 boxes of rho 8 (4 resting GAP dx
above the floor's top layer, 4 on top of them at the same gap,
neighbours GAP dx apart), S = 9, each box moving down and sideways at its
own velocity so that every contact slides (at zero tangential velocity
the Coulomb friction's direction is rounding noise).

* (a) The reference's compact branch (its Pallas fluid kernels in
  interpret mode, ``_compact_enabled`` patched on the instance), 3 f32
  steps, against its full route on the XLA cell branch in f64; tolerance
  5e-5 x max(|field|, 1): f32 against f64, and two f32 ulps of a box
  particle's height (~1.5e-8 m) are ~3e-5 of the largest overlap
  (~5.7e-4 m), which the contact forces and the body sums carry.
  ``scripts/check_coupling_compact_ref.py`` holds the branch to the
  full route on the same interpret kernels bit for bit: a second
  interpret-mode step compile, ~66 s whatever the tank's size, kept out
  of this file for its time.
* (b) The port's compact route (the kernels' plain versions, f32)
  against (a)'s compact branch: the store's lanes (``cl_pid``) equal,
  the fluid, body and expanded slot fields at 2e-5 x max(|field|, 1).
* (c) The port's compact route against the reference's full XLA cell
  route in f64 over 20 steps in sliding contact, tangential springs
  non-zero: rtol 1e-10, atol 1e-10 x max(|field|, 1).
* (d) The port's compact route against its full route in f64: bit for
  bit (the tail runs the same elementwise ops on the same values and the
  body sums are unchanged).
* (e) Routing: with the threshold at 8, S = 7, S = 2, kdk, reference,
  RK2, the list engine and no fluid keep the full schema, and so does
  S = 9 at the default threshold; ``plain=True`` takes the compact
  route; ``ni_max`` is the reference's; a compact scene under another
  route raises.
* (f) An overflow rebuild: the store's capacity below the interesting
  slots, the Solver widens it and goes on, equal to the full route bit
  for bit; a checkpoint resume after the store grew equals the
  uninterrupted run bit for bit.
* (g) A compact scene through ``slab_decompose`` and
  ``make_slab_coupling_step`` (kdkf, 2 slabs) against the single-device
  full route, rtol 1e-10.

On CPU tensors the kernel wrappers run their plain versions.
"""

import copy
import dataclasses
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu import geom as jgeom
from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.models.rigid_fluid_coupling import (
    RigidFluidCouplingScheme as JRFC)
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)

from rigid_body_2d_3d_pysph_tpu_torch import geom as tgeom
from rigid_body_2d_3d_pysph_tpu_torch.app.application import Solver
from rigid_body_2d_3d_pysph_tpu_torch.models import (
    RigidFluidCouplingScheme as TRFC)
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.models import (
    rigid_fluid_coupling as tcpl)
from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as tslab
from rigid_body_2d_3d_pysph_tpu_torch.parallel.mesh import make_mesh
from rigid_body_2d_3d_pysph_tpu_torch.state import (
    make_group as tmake_group, build_scene as tbuild_scene)

from test_pallas_fluid import _f32
from test_torch_coupling_step import GAP, coupling_scene, port_twin

CPU = torch.device("cpu")
DX = 0.01
BOX = 6            # particles along a box's side
DT = 2e-5
STEPS = 20
FLUID = ("x", "y", "u", "v", "rho", "p", "p_fsi", "arho", "ap", "au",
         "av", "uf", "vf", "wij_adami", "vol")
BODY = ("fx", "fy", "xcm", "vcm", "omega", "force", "torque")
SLOTS = ("contact_force_normal_x", "contact_force_normal_y",
         "contact_force_dist", "closest_point_dist_to_source", "x_source",
         "y_source", "vx_source", "vy_source", "overlap", "fn_x", "fn_y",
         "delta_lt_x", "delta_lt_y")


def boxes_scene(make_group, build_scene, geom, scheme_cls, n_boxes=8,
                **build_kw):
    """The tank and its ``n_boxes`` boxes of rho 8 (two rows of up to 4)
    with either package; the fluid carved a dx around each box.  Returns
    (scheme, unset-up scene)."""
    gy, rho0 = -1.0, 1.0
    span = (BOX - 1) * DX
    pitch = span + GAP * DX
    xf, yf, xt, yt = geom.hydrostatic_tank_2d(
        4 * pitch + 8 * DX, 2 * pitch + 10 * DX, 2 * pitch + 16 * DX, 3,
        DX, DX)
    p0 = -rho0 * gy * (yf.max() - yf)
    xb, yb = geom.get_2d_block(DX, span, span)
    xb, yb = xb - xb.min() + xf.min() + 4 * DX, yb - yb.min()
    boxes = [(xb + (b % 4) * pitch, yb - DX + GAP * DX + (b // 4) * pitch)
             for b in range(n_boxes)]
    keep = np.ones(len(xf), bool)
    for bx, by in boxes:   # the floor's top layer is at y = -dx
        keep &= ~((xf > bx.min() - DX) & (xf < bx.max() + DX)
                  & (yf > by.min() - DX) & (yf < by.max() + DX))
    m = rho0 * DX * DX
    # one group a box: surface identification runs per group
    groups = [make_group("fluid", xf[keep], yf[keep], m=m, h=DX, rho=rho0,
                         role="fluid", p=p0[keep]),
              make_group("tank", xt, yt, m=m, h=DX, rho=rho0, rad_s=DX / 2,
                         role="boundary", dem_id=n_boxes)]
    groups += [make_group(f"box{b}", bx, by, m=8.0 * m, h=DX, rho=8.0 * rho0,
                          rad_s=DX / 2, role="rigid",
                          body_id=np.zeros(len(bx), np.int32),
                          dem_id=np.full(len(bx), b, np.int32))
               for b, (bx, by) in enumerate(boxes)]
    scene = build_scene(groups, dim=2, total_no_bodies=n_boxes + 1,
                        spacing0=DX, **build_kw)
    c0 = 10 * np.sqrt(2 * abs(gy) * (yf.max() - yf.min()))
    scheme = scheme_cls(
        rigid_bodies=[f"box{b}" for b in range(n_boxes)], fluids=["fluid"],
        boundaries=["tank"], dim=2, rho0=rho0, p0=rho0 * c0**2, c0=c0,
        gy=gy, nu=0.0, h=DX)
    return scheme, scene


def forcing(scene, to):
    """The displaced fluid's shadow mass and density on the boxes, and
    each box's own velocity, down and sideways (``to``: host array ->
    the package's array)."""
    rb = np.asarray(scene.is_rigid)
    nb = scene.meta.nb
    vcm = np.array([[0.05 if b < 4 else -0.05, -0.3 - 0.05 * b, 0.0]
                    for b in range(nb)])
    return scene.replace(
        m_fsi=to(np.where(rb, DX * DX, np.asarray(scene.m_fsi))),
        rho_fsi=to(np.where(rb, 1.0, np.asarray(scene.rho_fsi))),
        vcm=to(vcm))


def port_scene(n_boxes=8, dtype=torch.float64, **attrs):
    """The port's scheme (``attrs`` set before the set-up, the compact
    threshold at the reference's 8 unless given) and set-up scene with
    the forcing."""
    scheme, scene = boxes_scene(tmake_group, tbuild_scene, tgeom, TRFC,
                                n_boxes, device=CPU, dtype=dtype)
    attrs.setdefault("compact_min_bodies", 8)
    for k, v in attrs.items():
        setattr(scheme, k, v)
    scene = scheme.setup(scene)
    return scheme, forcing(scene, lambda a: torch.as_tensor(a, dtype=dtype))


def _full(scene):
    """The [N, S] schema of a compact scene (the port's or the
    reference's)."""
    if isinstance(scene.cl_pid, torch.Tensor):
        return trb.strip_compact_fields(trb.expand_slot_scene(scene))
    scene = jrb.expand_slot_scene(scene)
    return type(scene)({k: v for k, v in scene.fields.items()
                        if k not in ("cl_pid", "cl_state")}, scene.meta)


def _twin(jsch, jscene, dtype):
    tsch, tscene = port_twin(jsch, jscene, dtype)
    if "cl_pid" in tscene:
        tscene = tscene.replace(cl_pid=tscene.cl_pid.to(torch.int64))
    return tsch, tscene


def _run(step, scene, n, dt, keep=()):
    """``n`` steps; the states after the steps in ``keep`` as well."""
    kept = {}
    for i in range(1, n + 1):
        scene = step(scene, dt)
        if i in keep:
            kept[i] = scene
    return scene, kept


def _compare(ref, got, names, rtol, floor=1.0):
    """``got`` (the port's) against ``ref`` at rtol, atol rtol x
    max(|ref|, floor); compact scenes are expanded first."""
    if "cl_pid" in ref.fields:
        ref = _full(ref)
    if "cl_pid" in got:
        got = _full(got)
    assert not bool(ref.nbr_overflow) and not bool(got.nbr_overflow)
    for name in names:
        a = np.asarray(ref.fields[name], np.float64)
        b = got[name].double().numpy()
        assert np.isfinite(b).all(), name
        scale = max(np.abs(a).max(), floor)
        np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale,
                                   err_msg=name)


def _in_sliding_contact(scene):
    full = _full(scene) if "cl_pid" in scene.fields else scene
    assert float(np.asarray(full.overlap).max()) > 0
    assert float(np.abs(np.asarray(full.delta_lt_x)).max()) > 0
    assert float(np.abs(np.asarray(full.delta_lt_y)).max()) > 0


# ---------------------------------------------------------------------------
# the reference: its compact branch (interpret mode) and its full route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    """The reference's set-up (compact, through the patched gate), its
    compact branch's 3 f32 steps (interpret mode), its XLA full route's 3
    f32 steps and 20 f64 steps from the same state."""
    jsch, jscene = boxes_scene(jmake_group, jbuild_scene, jgeom, JRFC)
    jsch.engine = "cell"
    jsch.fluid_pallas_interpret = True
    jsch._compact_enabled = lambda: True
    jscene = forcing(jsch.setup(jscene), jnp.asarray)
    assert "cl_pid" in jscene.fields
    start32 = _f32(jscene)
    compact32, _ = _run(jsch.make_step(start32), start32, 3,
                        jnp.float32(DT))
    full = _full(jscene)
    jsch.fluid_pallas_interpret = False        # the XLA cell branch
    full64, at = _run(jsch.make_step(full), full, STEPS, DT, (3,))
    return dict(jsch=jsch, start=jscene, start32=start32,
                compact32=compact32, full3=at[3], full64=full64)


def test_a_reference_compact_branch_matches_its_full_route(reference):
    r = reference
    assert not bool(r["compact32"].nbr_overflow)
    _in_sliding_contact(r["full3"])
    assert float(np.abs(np.asarray(r["full3"].fx)).max()) > 0
    full = jrb.expand_slot_scene(r["compact32"])
    for name in FLUID + BODY + SLOTS:
        a = np.asarray(r["full3"].fields[name], np.float64)
        b = np.asarray(full.fields[name], np.float64)
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b, a, rtol=5e-5, atol=5e-5 * scale,
                                   err_msg=name)


def test_b_port_compact_f32_matches_reference_compact_branch(reference):
    r = reference
    tsch, tscene = _twin(r["jsch"], r["start32"], torch.float32)
    assert tsch.ni_max(tsch._cell_cfg) * tsch._cell_cfg.M \
        == tscene.cl_pid.shape[0]
    end, _ = _run(tsch.make_step(tscene), tscene, 3, DT)
    assert torch.equal(end.cl_pid, torch.as_tensor(
        np.array(r["compact32"].cl_pid), dtype=torch.int64))
    assert 0 < int(end.n_interesting) <= tsch.ni_max(tsch._cell_cfg)
    _compare(r["compact32"], end, FLUID + BODY + SLOTS, rtol=2e-5)


# ---------------------------------------------------------------------------
# f64: the port's compact route against the reference and its full route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_runs(reference):
    """The port's compact route (20 steps) and full route (10 steps) in
    f64 from the reference's start state, with the states after 3 and
    10 steps."""
    tsch, tscene = _twin(reference["jsch"], _full(reference["start"]),
                         torch.float64)
    cfg = tsch._cell_cfg
    compact = trb.compact_slot_scene(tscene, tsch.ni_max(cfg) * cfg.M)
    c_end, c_at = _run(tsch.make_step(compact), compact, STEPS, DT, (3, 10))
    f_end, f_at = _run(tsch.make_step(tscene), tscene, 10, DT, (3,))
    f_at[10] = f_end
    return dict(tsch=tsch, full_start=tscene, compact=c_at, full=f_at,
                compact_end=c_end)


def test_c_port_compact_f64_matches_reference_full_route(reference,
                                                         port_runs):
    _in_sliding_contact(reference["full64"])
    _in_sliding_contact(port_runs["compact_end"])
    _compare(reference["full64"], port_runs["compact_end"],
             FLUID + BODY + SLOTS, rtol=1e-10)


@pytest.mark.parametrize("steps", [3, 10])
def test_d_port_compact_equals_port_full_route(port_runs, steps):
    a = _full(port_runs["compact"][steps])
    b = port_runs["full"][steps]
    assert set(a.fields) - {"n_interesting"} == set(b.fields)
    for k in b.fields:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["S7", "S2", "kdk", "reference", "rk2",
                                  "nklist", "no_fluid", "default"])
def test_e_full_schema_elsewhere(case):
    """With the threshold at 8, the compact store only where the
    reference's TPU takes it; at the default threshold, nowhere."""
    attrs = dict(kdk=dict(gtvf_ordering="kdk"),
                 reference=dict(gtvf_ordering="reference"),
                 rk2=dict(fluid_stepper="rk2", edac=False),
                 nklist=dict(engine="nklist"),
                 default=dict(compact_min_bodies=tcpl.COMPACT_MIN_BODIES)
                 ).get(case, {})
    if case in ("S2", "no_fluid"):
        if case == "S2":
            scheme, scene, _, _ = coupling_scene(
                tmake_group, tbuild_scene, tgeom, TRFC, True, floor=True,
                device=CPU, dtype=torch.float64)
        else:
            scheme, scene = boxes_scene(tmake_group, tbuild_scene, tgeom,
                                        TRFC, device=CPU,
                                        dtype=torch.float64)
            scheme.fluids = []
        scheme.compact_min_bodies = 8
        scene = scheme.setup(scene)
    else:
        scheme, scene = port_scene(6 if case == "S7" else 8, **attrs)
    assert "cl_pid" not in scene and "contact_force_normal_x" in scene
    if case == "default":
        assert scheme.compact_min_bodies is None and scheme._compact_enabled()
    else:
        assert not scheme._compact_enabled() \
            or scene.meta.total_no_bodies < 8


def test_e_compact_gate_plain_and_guards():
    scheme, scene = port_scene()
    assert scheme._compact_enabled() and "cl_pid" in scene
    assert "contact_force_normal_x" not in scene
    cfg = scheme._cell_cfg
    assert scene.cl_pid.shape[0] == scheme.ni_max(cfg) * cfg.M
    # the reference's capacity formula on the same grid and boosts
    jsch = JRFC(["fluid"], ["tank"], ["box0"], dim=2, rho0=1.0, p0=1.0,
                c0=1.0, h=DX, nu=0.0)
    for boost in (0.01, 0.5, 1.0, 3.375):
        scheme.capacity_boost = jsch.capacity_boost = boost
        for nc in (64, 5000, cfg.NC_max, 20000):
            c = dataclasses.replace(cfg, NC_max=nc)
            assert scheme.ni_max(c) == jsch.ni_max(c)
    scheme.capacity_boost = 1.0
    # plain=True keeps the compact route
    end = scheme.make_step(scene, plain=True)(scene, DT)
    assert "cl_pid" in end and "contact_force_normal_x" not in end
    assert int(end.n_interesting) > 0 and not bool(end.nbr_overflow)
    # a compact scene under a route that reads the [N, S] fields
    scheme.gtvf_ordering = "kdk"
    with pytest.raises(ValueError, match="compact"):
        scheme.make_step(scene)


# ---------------------------------------------------------------------------
# the overflow rebuild and a checkpoint resume after the store grew
# ---------------------------------------------------------------------------

def test_f_overflow_rebuild_and_resume(tmp_path, monkeypatch):
    """The capacity floor lowered to 30 slots (a CPU-sized grid has far
    fewer slots than the floor of 512, and then ni_max = NC): at capacity
    boost 1 the store holds 30 of the scene's 40 interesting slots, so
    the first chunk overflows, and the Solver's second rebuild widens it
    (boost 1.5).  The run equals the full route on the final grid bit for
    bit; a resume from the checkpoint after the first chunk (the store
    grown) equals the uninterrupted run bit for bit, and so do their last
    snapshots."""
    monkeypatch.setattr(trb, "NI_MAX_FLOOR", 30)
    scheme, scene = port_scene()
    L0 = scene.cl_pid.shape[0]
    assert L0 == 30 * scheme._cell_cfg.M
    full_dir, res_dir = tmp_path / "full", tmp_path / "res"
    res_dir.mkdir()
    solver = Solver(scheme, scene, DT, 4 * DT, pfreq=2,
                    output_dir=str(full_dir), checkpoint_every=1)

    def keep_first_checkpoint(s):
        if s.count == 2:
            shutil.copy(full_dir / "checkpoint.npz", res_dir)

    solver.callbacks_post_chunk.append(keep_first_checkpoint)
    end = solver.solve(quiet=True)
    assert solver.rebuilds_total == 2 and solver.steps_run == 8
    assert end.cl_pid.shape[0] > L0 and not bool(end.nbr_overflow)
    assert 30 < int(end.n_interesting) <= scheme.ni_max(scheme._cell_cfg)
    boost, cfg = scheme.capacity_boost, scheme._cell_cfg
    assert boost == 1.5

    # the full route on the final grid from the same start
    ref = copy.copy(scheme)
    fscene = _full(scene)
    fend, _ = _run(ref.make_step(fscene), fscene, 4, DT)
    got = _full(end)
    assert set(got.fields) - {"n_interesting"} == set(fend.fields)
    for k in fend.fields:
        assert torch.equal(got[k], fend[k]), k

    # a fresh set-up resumed from the step-2 checkpoint
    scheme, scene = port_scene()
    assert scene.cl_pid.shape[0] == L0
    resumed = Solver(scheme, scene, DT, 4 * DT, pfreq=2,
                     output_dir=str(res_dir))
    end2 = resumed.solve(quiet=True, resume=True)
    assert resumed.rebuilds_total == 0 and resumed.steps_run == 2
    assert scheme.capacity_boost == boost and scheme._cell_cfg == cfg
    assert set(end.fields) == set(end2.fields)
    for k in end.fields:
        assert torch.equal(end[k], end2[k]), k
    with np.load(str(full_dir / "snapshot_000004.npz")) as a, \
            np.load(str(res_dir / "snapshot_000004.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the slab step on a compact scene
# ---------------------------------------------------------------------------

def test_g_compact_scene_through_the_slab_step(port_runs):
    """The compact start state (expanded by ``slab_decompose``) on 2
    slabs, kdkf, 3 steps, against 3 single-device full-route steps; the
    face runs between the box columns 2 and 3, so contact pairs cross
    it."""
    tsch = port_runs["tsch"]
    tsch.gtvf_ordering = "kdkf"
    start = port_runs["full_start"]
    cfg_c = tsch._cell_cfg
    compact = trb.compact_slot_scene(start, tsch.ni_max(cfg_c) * cfg_c.M)
    cfg = tslab.make_slab_config(compact, cfg_c, 2)
    mesh = make_mesh(2, [CPU, CPU])
    parts = tslab.shard_slab_scene(
        tslab.slab_decompose(compact, cfg, use_blob=False), mesh)
    assert all("cl_pid" not in p for p in parts)
    step = tslab.make_slab_coupling_step(tsch, parts, mesh, cfg)
    for _ in range(3):
        parts = step(parts, DT)
    g = tslab.gather_slab_scene(parts)
    ref = port_runs["full"][3]
    assert not bool(g.nbr_overflow)
    assert all(bool((p.is_rigid & p.active).any()) for p in parts)
    assert float(g.overlap.max()) > 0
    act = g.active.numpy()
    rows = np.nonzero(act)[0]
    ks = rows[np.lexsort((g.y.numpy()[act], g.x.numpy()[act]))]
    kr = np.lexsort((ref.y.numpy(), ref.x.numpy()))
    assert len(ks) == ref.n
    for k in ("x", "y", "u", "v", "rho", "p", "p_fsi", "arho", "au", "av",
              "fx", "fy"):
        a, b = ref[k].numpy()[kr], g[k].numpy()[ks]
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-10 * scale,
                                   err_msg=k)
    for k in ("xcm", "vcm", "force", "torque"):
        a, b = ref[k].numpy(), g[k].numpy()
        np.testing.assert_allclose(b, a, rtol=1e-10,
                                   atol=1e-10 * max(np.abs(a).max(), 1.0),
                                   err_msg=k)
