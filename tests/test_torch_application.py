"""The port's application layer: snapshots, checkpoints, the Solver's
chunk loop and overflow rule, SchemeChooser and the velocity setters.

* A snapshot the port writes of a set-up coupling scene loads through the
  reference's ``app/output.load`` with the keys, shapes and values (bit
  for bit) of the reference writer's snapshot of the same scene.
* The Solver's boundaries: snapshots at step 0, every ``pfreq`` steps and
  at the end; an event applied once at its step; post-chunk callbacks.
* Resume from a checkpoint equals the uninterrupted run bit for bit in
  float64, also after an overflow rebuild widened the rigid compact store
  (the reference raises a shape mismatch there), and on the list engine
  after an overflow rebuild re-sized the neighbour list (the checkpoint
  holds the list's config).
* Case scripts take ``--engine nklist`` (the scheme's engine; ``cell``
  by default).
* The overflow rule on a block that leaves its grid's domain within a
  chunk: rebuilds from the chunk's start state, the slack grows 1.5x from
  the second rebuild of a chunk on, and the Solver raises after 8.
* The background writer writes the state at its step although the
  tensors change afterwards; a failed write leaves no partial
  ``snapshot_*.npz``.
* ``SchemeChooser`` parses the reference's option set to the same
  options; ``set_linear_velocity`` / ``set_angular_velocity`` give the
  reference's particle velocities.

Everything runs on CPU tensors (``torch.device("cpu")``); the only JAX
work is the reference's set-up of one small scene.
"""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu import geom as jgeom
from rigid_body_2d_3d_pysph_tpu.app import output as jout
from rigid_body_2d_3d_pysph_tpu.models import base as jbase
from rigid_body_2d_3d_pysph_tpu.models import dem as jdem
from rigid_body_2d_3d_pysph_tpu.models import rigid_body as jrb
from rigid_body_2d_3d_pysph_tpu.models.rigid_fluid_coupling import (
    RigidFluidCouplingScheme as JRFC)
from rigid_body_2d_3d_pysph_tpu.state import (
    make_group as jmake_group, build_scene as jbuild_scene)
from rigid_body_2d_3d_pysph_tpu.state import rigid_setup as jrs

from rigid_body_2d_3d_pysph_tpu_torch.app import checkpoint as tckpt
from rigid_body_2d_3d_pysph_tpu_torch.app import output as tout
from rigid_body_2d_3d_pysph_tpu_torch.app.application import Solver
from rigid_body_2d_3d_pysph_tpu_torch.geom import get_2d_block
from rigid_body_2d_3d_pysph_tpu_torch.models import base as tbase
from rigid_body_2d_3d_pysph_tpu_torch.models import dem as tdem
from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
from rigid_body_2d_3d_pysph_tpu_torch.models import (
    RigidFluidCouplingScheme as TRFC)
from rigid_body_2d_3d_pysph_tpu_torch.state import make_group, build_scene
from rigid_body_2d_3d_pysph_tpu_torch.state import rigid_setup as trs
from rigid_body_2d_3d_pysph_tpu_torch.state.convert import scene_from_numpy

from test_torch_coupling_step import coupling_scene

CPU = torch.device("cpu")
DX = 0.025
DT = 1e-3
BAR = (2.0, 0.1)
V_FAST = -66.0


def _block_scene(length=0.2, height=0.2, v=0.0, dtype=torch.float64,
                 engine="cell"):
    """One 2D block (spacing DX, no walls) under gravity, moving at ``v``
    in y.  Its grid's domain is its bounding box widened by 0.75 x its
    extent on each axis and two cutoffs: the 2 x 0.1 bar at -66 m/s
    leaves it within a chunk of 5 steps until the slack has grown twice,
    and its ~42 occupied cells make the grown grid (and the compact
    store) wider than the set-up one."""
    x, y = get_2d_block(DX, length, height)
    g = make_group("body", x, y, m=2000 * DX * DX, h=1.3 * DX, rho=2000.0,
                   rad_s=DX / 2, role="rigid",
                   body_id=np.zeros(len(x), np.int32), dem_id=0)
    scene = build_scene([g], dim=2, total_no_bodies=1, spacing0=DX,
                        device=CPU, dtype=dtype)
    scheme = trb.RigidBody2DScheme(["body"], [], dim=2, gy=-9.81)
    scheme.engine = engine
    scene = scheme.setup(scene)
    return scheme, scheme.set_linear_velocity(scene, [0.0, v, 0.0])


def _record_rebuilds(scheme):
    """Wrap ``refresh_configs`` to record (grow, capacity boost after)."""
    log = []
    orig = scheme.refresh_configs

    def refresh(scene, grow=False):
        orig(scene, grow=grow)
        log.append((grow, scheme.capacity_boost))

    scheme.refresh_configs = refresh
    return log


def _assert_scenes_equal(a, b):
    assert set(a.fields) == set(b.fields)
    for k in a.fields:
        assert torch.equal(a[k], b[k]), k


def _assert_npz_equal(p, q):
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def test_snapshot_layout_matches_reference_writer(tmp_path):
    jsch, jscene, dx, _ = coupling_scene(jmake_group, jbuild_scene, jgeom,
                                         JRFC, True)
    jsch.engine = "cell"
    jscene = jsch.setup(jscene)
    rng = np.random.default_rng(4)
    jscene = jscene.replace(
        xcm=jscene.xcm + rng.uniform(-0.1, 0.1, jscene.xcm.shape),
        vcm=jscene.vcm + rng.uniform(-0.1, 0.1, jscene.vcm.shape))
    fields = {k: np.asarray(v) for k, v in jscene.fields.items()}
    tscene = scene_from_numpy(fields, jscene.meta, CPU, torch.float64)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "snapshot_000007.npz")
    jout.write_snapshot(pj, jscene, 0.125, 1e-4, 7)
    tout.write_snapshot(pt, tscene, 0.125, 1e-4, 7)
    assert os.listdir(tmp_path) and not [
        f for f in os.listdir(tmp_path) if f.startswith(".")]
    sdj, gj = jout.load(pj)
    sdt, gt = jout.load(pt)
    assert sdj.keys() == sdt.keys()
    for k in sdj:
        assert sdj[k] == sdt[k] and sdj[k].dtype == sdt[k].dtype, k
    assert gj.keys() == gt.keys() == {"fluid", "tank", "body"}
    for g in gj:
        a, b = vars(gj[g]), vars(gt[g])
        assert a.keys() == b.keys(), g
        for k in a:
            assert a[k].dtype == b[k].dtype, (g, k)
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{g}/{k}")
    assert gt["body"].xcm_mat.shape == (1, 3) and int(gt["body"].nb[0]) == 1
    # the port's loader reads both the same way
    for p in (pj, pt):
        sd, gs = tout.load(p)
        np.testing.assert_array_equal(gs["fluid"].x, gj["fluid"].x)
        assert float(sd["t"]) == 0.125


def test_failed_write_leaves_no_partial_snapshot(tmp_path, monkeypatch):
    _, scene = _block_scene()
    path = str(tmp_path / "snapshot_000010.npz")

    def broken(fh, **data):
        fh.write(b"PK\x03\x04 half an archive")
        raise OSError("disk full")

    monkeypatch.setattr(tout.np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        tout.write_snapshot(path, scene, 0.0, DT, 10)
    writer = tout.AsyncSnapshotWriter()
    writer.submit(path, scene, 0.0, DT, 10)
    with pytest.raises(RuntimeError, match="async snapshot write failed"):
        writer.close()
    assert os.listdir(tmp_path) == []
    assert tout.get_files(str(tmp_path)) == []


def test_async_writer_keeps_the_state_at_its_step(tmp_path):
    """The tensors change in place after ``submit``: the file holds the
    values they had at ``submit``."""
    _, scene = _block_scene(v=-0.5)
    want = str(tmp_path / "want.npz")
    tout.write_snapshot(want, scene, 0.5, DT, 3)
    writer = tout.AsyncSnapshotWriter()
    path = str(tmp_path / "snapshot_000003.npz")
    writer.submit(path, scene, 0.5, DT, 3)
    for k in ("x", "y", "v", "xcm", "vcm"):
        scene[k].add_(1.0)
    writer.close()
    _assert_npz_equal(path, want)


# ---------------------------------------------------------------------------
# the Solver
# ---------------------------------------------------------------------------

def test_solver_chunks_events_and_snapshots(tmp_path):
    scheme, scene = _block_scene()
    seen_events, chunks = [], []

    def kick(scene):
        seen_events.append(1)
        return scheme.set_linear_velocity(scene, [0.25, 0.0, 0.0])

    solver = Solver(scheme, scene, DT, 12 * DT, pfreq=5,
                    output_dir=str(tmp_path), events=[(7 * DT, kick)],
                    checkpoint_every=2)
    solver.callbacks_post_chunk.append(lambda s: chunks.append(s.count))
    end = solver.solve(quiet=True)
    assert seen_events == [1]
    assert chunks == [5, 10, 12]
    assert solver.count == solver.steps_run == 12
    assert solver.t == pytest.approx(12 * DT)
    names = [os.path.basename(f) for f in tout.get_files(str(tmp_path))]
    assert names == [f"snapshot_{c:06d}.npz" for c in (0, 5, 10, 12)]
    assert solver.output_files == [str(tmp_path / n) for n in names]
    # the kick at step 7: 6 steps at rest (vx = 0), then vx = 0.25
    assert float(end.vcm[0, 0]) == 0.25
    sd, g = tout.load(str(tmp_path / "snapshot_000005.npz"))
    assert int(sd["count"]) == 5 and float(g["body"].vcm_mat[0, 0]) == 0.0
    assert tckpt.latest_checkpoint(str(tmp_path)) is not None


def _run(scheme, scene, n, out, resume=False, pfreq=10):
    solver = Solver(scheme, scene, DT, n * DT, pfreq=pfreq, output_dir=out)
    return solver, solver.solve(quiet=True, resume=resume)


@pytest.mark.parametrize("v", [-0.5, V_FAST])
def test_resume_equals_uninterrupted_f64(tmp_path, v):
    """10 steps in chunks of 5, against 5 steps and a resumed run to 10.
    At -0.5 m/s nothing is rebuilt; at V_FAST the first chunk rebuilds
    three times and the compact store widens before the checkpoint at
    step 5 (the resumed run starts from a template of the set-up
    width)."""
    scheme, scene = _block_scene(*BAR, v=v)
    L0 = scene.cl_pid.shape[0]
    full, end = _run(scheme, scene, 10, str(tmp_path / "full"), pfreq=5)
    scheme, scene = _block_scene(*BAR, v=v)
    half, mid = _run(scheme, scene, 5, str(tmp_path / "res"), pfreq=5)
    scheme, scene = _block_scene(*BAR, v=v)
    assert scene.cl_pid.shape[0] == L0
    resumed, end2 = _run(scheme, scene, 10, str(tmp_path / "res"),
                         resume=True, pfreq=5)
    assert resumed.count == 10
    assert resumed.steps_run == 5 * (1 + resumed.rebuilds_total)
    _assert_scenes_equal(end, end2)
    _assert_npz_equal(str(tmp_path / "full" / "snapshot_000010.npz"),
                      str(tmp_path / "res" / "snapshot_000010.npz"))
    if v < -1.0:
        assert half.rebuilds_total >= 2
        assert mid.cl_pid.shape[0] > L0 and end2.cl_pid.shape[0] > L0
    else:
        assert full.rebuilds_total == 0 and end.cl_pid.shape[0] == L0


def _list_block_scene(m=2):
    """``_block_scene`` on the list engine, its list's per-cell cap set to
    ``m`` (a rebuild's first chunk overflows it)."""
    scheme, scene = _block_scene(*BAR, v=-0.5, engine="nklist")
    scheme._nbr_cfg = dataclasses.replace(scheme._nbr_cfg, max_per_cell=m)
    return scheme, scene


def test_resume_on_the_list_after_a_rebuild_f64(tmp_path):
    scheme, scene = _list_block_scene()
    full, end = _run(scheme, scene, 10, str(tmp_path / "full"), pfreq=5)
    assert full.rebuilds_total == 1
    scheme, scene = _list_block_scene()
    half, _ = _run(scheme, scene, 5, str(tmp_path / "res"), pfreq=5)
    assert half.rebuilds_total == 1
    rebuilt = scheme._nbr_cfg
    scheme, scene = _list_block_scene()
    resumed, end2 = _run(scheme, scene, 10, str(tmp_path / "res"),
                         resume=True, pfreq=5)
    # the checkpoint held the rebuilt list: no overflow, no rebuild
    assert scheme._nbr_cfg == rebuilt and rebuilt.max_per_cell > 2
    assert resumed.rebuilds_total == 0 and resumed.steps_run == 5
    _assert_scenes_equal(end, end2)
    _assert_npz_equal(str(tmp_path / "full" / "snapshot_000010.npz"),
                      str(tmp_path / "res" / "snapshot_000010.npz"))


@pytest.mark.parametrize("case", ("rigid", "dem", "coupling"))
def test_case_scripts_take_the_engine_flag(tmp_path, case):
    from rigid_body_2d_3d_pysph_tpu_torch.cases import (
        benchmark_5_steady_cubes_on_a_wall_2d as b5,
        dem_granular_column_collapse as dem,
        rigid_body_rotating_and_sinking_in_tank_2d as sink)

    app, argv = dict(
        rigid=(b5.Benchmark5_2D, ["--two-cubes"]),
        dem=(dem.GranularColumnCollapse, ["--column-scale", "0.3"]),
        coupling=(sink.SinkingBox, []))[case]
    app = app()
    if case == "coupling":
        app.initialize(spacing=0.1)
    app.run(["-d", str(tmp_path), "--max-steps", "2", "--pfreq", "1",
             "--quiet", "--device", "cpu", "--engine", "nklist"] + argv)
    assert app.scheme.engine == "nklist" and app.solver.count == 2
    assert "cl_pid" not in app.scene
    assert bool(torch.isfinite(app.scene.x).all())
    assert not bool(app.scene.nbr_overflow)


def test_overflow_rule_rebuilds_grows_and_gives_up(tmp_path):
    scheme, scene = _block_scene(*BAR, v=V_FAST)
    log = _record_rebuilds(scheme)
    solver, end = _run(scheme, scene, 5, str(tmp_path / "a"), pfreq=5)
    # the chunk re-ran from its start: 5 steps done, more taken
    assert solver.count == 5 and solver.steps_run == 5 * (len(log) + 1)
    assert len(log) >= 3
    assert [g for g, _ in log] == [False] + [True] * (len(log) - 1)
    assert [b for _, b in log] == [1.5 ** i for i in range(len(log))]
    assert not bool(end.nbr_overflow)

    scheme, scene = _block_scene(v=-1e4)
    log = _record_rebuilds(scheme)
    with pytest.raises(RuntimeError, match="after 8 grid rebuilds"):
        _run(scheme, scene, 4, str(tmp_path / "b"), pfreq=2)
    assert len(log) == 8
    assert [b for _, b in log] == [1.5 ** i for i in range(8)]


# ---------------------------------------------------------------------------
# the scheme surface
# ---------------------------------------------------------------------------

def _choosers(mod_rb, mod_dem, base):
    kw = dict(rigid_bodies=["body"], boundaries=["tank"], dim=2)
    return base.SchemeChooser(
        default="rb2d", rb2d=mod_rb.RigidBody2DScheme(**kw),
        rb3d=mod_rb.RigidBody3DScheme(**kw),
        dem=mod_dem.DEMScheme(["body"], ["tank"], dim=2))


def _parse(chooser, argv):
    p = argparse.ArgumentParser()
    chooser.add_user_options(p.add_argument_group("scheme options"))
    opts = p.parse_args(argv)
    chooser.consume_user_options(opts)
    return p, opts


@pytest.mark.parametrize("argv", [
    [], ["--scheme", "rb3d", "--kr-stiffness", "2e5", "--fric-coeff", "0.3"],
    ["--scheme", "dem", "--contact-model", "LVCDisplacement"],
    ["--scheme", "dem", "--contact-model", "LVCForce"]])
def test_scheme_chooser_parses_the_reference_options(argv):
    jc, tc = _choosers(jrb, jdem, jbase), _choosers(trb, tdem, tbase)
    pj, oj = _parse(jc, argv)
    pt, ot = _parse(tc, argv)
    assert set(pj._option_string_actions) == set(pt._option_string_actions)
    assert vars(oj) == vars(ot)
    assert type(jc.scheme).__name__ == type(tc.scheme).__name__
    for k in ("kr", "kf", "fric_coeff", "kn", "mu", "contact_model"):
        if hasattr(jc.scheme, k):
            assert getattr(tc.scheme, k) == getattr(jc.scheme, k), k
    # solver settings and options reach the selected scheme
    tc.configure_solver(dt=2e-4, tf=0.1, pfreq=50)
    tc.dt = 1e-4
    assert (tc.scheme.dt, tc.scheme.tf, tc.scheme.pfreq) == (1e-4, 0.1, 50)
    assert tc.capacity_boost == tc.scheme.capacity_boost


def test_coupling_options_match_the_reference():
    mk = lambda cls: cls(fluids=["fluid"], boundaries=["tank"],
                         rigid_bodies=["body"], dim=2, rho0=1.0, p0=100.0,
                         c0=10.0, h=0.05, nu=0.0)
    argv = ["--no-edac", "--gtvf-ordering", "kdk", "--fluid-alpha", "0.2"]
    _, oj = _parse(jbase.SchemeChooser(default="rfc", rfc=mk(JRFC)), argv)
    tc = tbase.SchemeChooser(default="rfc", rfc=mk(TRFC))
    _, ot = _parse(tc, argv)
    assert vars(oj) == vars(ot)
    assert (tc.edac, tc.gtvf_ordering, tc.fluid_alpha) == (False, "kdk", 0.2)


def test_velocity_setters_match_reference():
    x, y = get_2d_block(DX, 0.2, 0.1)
    bid = (x > 0).astype(np.int32)
    args = dict(m=2000 * DX * DX, h=1.3 * DX, rho=2000.0, rad_s=DX / 2,
                role="rigid", body_id=bid, dem_id=bid)
    jscene = jrs.setup_body_state(jbuild_scene(
        [jmake_group("body", x, y, **args)], dim=2, total_no_bodies=2,
        spacing0=DX))
    tscene = trs.setup_body_state(build_scene(
        [make_group("body", x, y, **args)], dim=2, total_no_bodies=2,
        spacing0=DX, device=CPU, dtype=torch.float64))
    for fn, val in (("set_linear_velocity", [0.5, -0.25, 0.0]),
                    ("set_angular_velocity", [[0.0, 0.0, 1.5],
                                              [0.0, 0.0, -2.0]])):
        jscene = getattr(jrs, fn)(jscene, val)
        tscene = getattr(trs, fn)(tscene, val)
        for k in ("u", "v", "w", "vcm", "omega", "ang_mom"):
            np.testing.assert_allclose(tscene[k].numpy(),
                                       np.asarray(jscene[k]), rtol=1e-14,
                                       atol=1e-15, err_msg=f"{fn} {k}")


def test_application_needs_a_card_unless_told(tmp_path, monkeypatch):
    """``--device`` defaults to the first CUDA card, and a run without one
    raises before it builds or writes anything (no fallback to the
    CPU)."""
    from rigid_body_2d_3d_pysph_tpu_torch.cases import (
        benchmark_5_steady_cubes_on_a_wall_2d as b5)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    app = b5.Benchmark5_2D()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.run(["--two-cubes", "-d", str(out), "--max-steps", "1",
                 "--quiet"])
    assert app.scene is None and not out.exists()
