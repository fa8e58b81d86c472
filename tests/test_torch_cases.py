"""The port's case applications against the reference's case scripts.

* Benchmark 5 (2D, two cubes) and benchmark 2 (two cubes colliding
  head-on with no boundary, ``RigidBody3DScheme`` on the 2D scene)
  through both ``Application``s in float64 for 20 steps in chunks of 10
  (the reference on its XLA cell engine, ``RB_TPU_ENGINE=cell``): every
  snapshot's arrays at rtol 1e-10, read by the reference's ``load``.
* ``identify_template``: the port's flags (cell engine) equal the
  reference's (``[N, K]`` list engine) bit for bit on every template the
  ported cases build.
* The set-up scenes of the other cases (benchmarks 1-4, benchmark 5 in
  3D, the sinking box at spacing 0.1, the column collapse at column
  scale 0.3, the stack of cylinders and its two-cylinder test through
  the coupling scheme with no fluid) equal the reference cases' field
  for field, before any step.
* The port's ``validate`` checks give the dicts of the root
  ``validate.py``'s checks on the same output directories (a few steps
  of each ported case).
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "cases"))

import validate as jvalidate  # noqa: E402
from rigid_body_2d_3d_pysph_tpu.app import boundary_utils as jbu  # noqa: E402
from rigid_body_2d_3d_pysph_tpu.app import output as jout  # noqa: E402

from rigid_body_2d_3d_pysph_tpu_torch import validate as tvalidate  # noqa
from rigid_body_2d_3d_pysph_tpu_torch.app import boundary_utils as tbu  # noqa
from rigid_body_2d_3d_pysph_tpu_torch.cases import (  # noqa: E402
    benchmark_1_rigid_body_rotating_and_translating_freely as tb1,
    benchmark_2_multiple_rigid_bodies_colliding as tb2,
    benchmark_2_multiple_rigid_bodies_colliding_same_particle_array as tb2s,
    benchmark_3_multiple_rigid_bodies_colliding_same_particle_array as tb3,
    benchmark_4_rigid_cube_bouncing_on_a_wall as tb4,
    stack_of_cylinders_test_1 as tstack1,
    benchmark_5_steady_cubes_on_a_wall_2d as tb5_2d,
    benchmark_5_steady_cubes_on_a_wall_3d as tb5_3d,
    dem_granular_column_collapse as tdem,
    rigid_body_rotating_and_sinking_in_tank_2d as tsink,
    stack_of_cylinders as tstack)
from rigid_body_2d_3d_pysph_tpu_torch.geom import (  # noqa: E402
    create_circle_1, get_2d_block, get_3d_block)

CPU_ARGS = ["--device", "cpu"]
# the reference's RK2 saved state (the port's coupling set-up carries it
# too, as of the RK2 step's port)
RK2_FIELDS = {"x0", "y0", "z0", "u0", "v0", "w0", "rho0_rk"}


@pytest.fixture
def cell_engine(monkeypatch):
    """The reference's schemes on their XLA cell engine (the port's
    counterpart; on the CPU the reference defaults to its list engine)."""
    monkeypatch.setenv("RB_TPU_ENGINE", "cell")


def _app_snapshots_match(tmp_path, japp, tapp, argv, steps=20, pfreq=10):
    """Run both ``Application``s for ``steps`` steps (snapshots every
    ``pfreq``) and hold every snapshot's arrays to each other at rtol
    1e-10; returns the port's snapshot files."""
    argv = argv + ["--max-steps", str(steps), "--pfreq", str(pfreq),
                   "--quiet"]
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    japp.run(["-d", dj] + argv)
    tapp.dtype = torch.float64
    tapp.run(["-d", dt] + argv + CPU_ARGS)
    assert tapp.solver.count == steps and tapp.solver.rebuilds_total == 0
    fj, ft = jout.get_files(dj), jout.get_files(dt)
    assert [os.path.basename(f) for f in fj] == \
        [os.path.basename(f) for f in ft] == \
        [f"snapshot_{c:06d}.npz" for c in range(0, steps + 1, pfreq)]
    for a, b in zip(fj, ft):
        sdj, gj = jout.load(a)
        sdt, gt = jout.load(b)
        assert sdj.keys() == sdt.keys() and gj.keys() == gt.keys()
        assert float(sdj["t"]) == float(sdt["t"])
        for g in gj:
            vj, vt = vars(gj[g]), vars(gt[g])
            assert vj.keys() == vt.keys(), g
            for k in vj:
                x, y = np.asarray(vj[k]), np.asarray(vt[k])
                assert x.shape == y.shape and x.dtype == y.dtype, (g, k)
                scale = max(float(np.abs(x).max(initial=0.0)), 1.0)
                np.testing.assert_allclose(y, x, rtol=1e-10,
                                           atol=1e-10 * scale,
                                           err_msg=f"{b}: {g}/{k}")
    return ft


def test_benchmark_5_2d_app_matches_reference_f64(tmp_path, cell_engine):
    import benchmark_5_steady_cubes_on_a_wall_2d as jb5

    ft = _app_snapshots_match(
        tmp_path, jb5.Benchmark5_2D(fname="benchmark_5_2d"),
        tb5_2d.Benchmark5_2D(fname="benchmark_5_2d"), ["--two-cubes"])
    # the cubes are in contact with the floor and each other
    sd, g = jout.load(ft[-1])
    assert np.abs(g["body"].fy).max() > 0


def test_benchmark_2_app_matches_reference_f64(tmp_path, cell_engine):
    """The no-boundary path, the 3D body update on a 2D scene: the cubes
    start 0.2 apart, so no slot is interesting for the whole run (the
    interest cull finds none and the contact pass writes init rows)."""
    import benchmark_2_multiple_rigid_bodies_colliding as jb2

    ft = _app_snapshots_match(
        tmp_path, jb2.Benchmark2(fname="benchmark_2"),
        tb2.Benchmark2(fname="benchmark_2"), [])
    # no contact yet: the cubes coast at their initial velocities
    sd, g = jout.load(ft[-1])
    np.testing.assert_allclose(g["body1"].vcm_mat[0], [0.5, 0.0, 0.0],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(g["body2"].vcm_mat[0], [-0.5, 0.0, 0.0],
                               rtol=0, atol=1e-12)


# benchmark 2's second cube started this much closer (x), so the cubes
# meet within the first steps (at the case's 0.2 gap, after ~1,050)
B2_SHIFT = -0.17


def _closer_b2(jb2):
    """The two packages' benchmark 2 with the second cube moved by
    B2_SHIFT after the set-up (particles and centre of mass alike)."""

    class J(jb2.Benchmark2):
        def create_particles(self):
            scene = super().create_particles()
            g = scene.meta.group("body2")
            return scene.replace(
                x=scene.x.at[g.start:g.stop].add(B2_SHIFT),
                xcm=scene.xcm.at[1, 0].add(B2_SHIFT))

    class T(tb2.Benchmark2):
        def create_particles(self):
            scene = super().create_particles()
            g = scene.meta.group("body2")
            x, xcm = scene.x.clone(), scene.xcm.clone()
            x[g.start:g.stop] += B2_SHIFT
            xcm[1, 0] += B2_SHIFT
            return scene.replace(x=x, xcm=xcm)

    return J(fname="benchmark_2"), T(fname="benchmark_2")


def test_benchmark_2_app_past_the_collision_f64(tmp_path, cell_engine):
    """The head-on collision through both ``Application``s in float64:
    the second cube starts 0.17 closer, so the faces meet at ~step 30
    and the cubes have rebounded by step 200; every snapshot (each 50
    steps) at rtol 1e-10.  At the case's own gap the f64 runs of both
    packages agree to 7e-14 through tf (2,998 steps)."""
    import benchmark_2_multiple_rigid_bodies_colliding as jb2

    ft = _app_snapshots_match(tmp_path, *_closer_b2(jb2), [], steps=200,
                              pfreq=50)
    sd, g = jout.load(ft[-1])
    v1, v2 = g["body1"].vcm_mat[0], g["body2"].vcm_mat[0]
    assert v1[0] < -0.4 and v2[0] > 0.4            # rebounded
    assert np.abs(v1 + v2).max() < 1e-10           # momentum


# benchmark 3's bodies moved down by B3_DROP (y) and started at B3_VY, the
# speed the case's 0.4 m drop reaches (2.354 m/s at step 2,400), so both
# hit the tank floor at about step 30
B3_DROP, B3_VY = -0.29, -2.354


def _lower_b3(jb3):
    """The two packages' benchmark 3 with both bodies moved by B3_DROP and
    moving down at B3_VY after the set-up."""

    def lowered(scene, copy):
        g = scene.meta.group("body")
        y = copy(scene.y)
        y[g.start:g.stop] += B3_DROP
        xcm, vcm = copy(scene.xcm), copy(scene.vcm)
        xcm[:, 1] += B3_DROP
        vcm[:, 1] = B3_VY
        return dict(y=y, xcm=xcm, vcm=vcm)

    class J(jb3.Benchmark3):
        def create_particles(self):
            import jax.numpy as jnp
            scene = super().create_particles()
            upd = lowered(scene, np.array)
            return scene.replace(**{k: jnp.asarray(v)
                                    for k, v in upd.items()})

    class T(tb3.Benchmark3):
        def create_particles(self):
            scene = super().create_particles()
            return scene.replace(**lowered(scene, torch.clone))

    return J(fname="benchmark_3"), T(fname="benchmark_3")


def test_benchmark_3_app_through_the_first_impacts_f64(tmp_path,
                                                       cell_engine):
    """Both bodies hit the tank floor at ~2.35 m/s near step 30 and are
    in contact to step 150 (their fall slowed to ~1.36 m/s): every snapshot (each 50 steps) at rtol
    1e-10.  At the case's own height the f64 runs of both packages agree
    to 1e-13 through the first impact (step ~2,450) and part ways after
    it, as two runs of one package do (ROADMAP, Faults, benchmark 3)."""
    import benchmark_3_multiple_rigid_bodies_colliding_same_particle_array \
        as jb3

    ft = _app_snapshots_match(tmp_path, *_lower_b3(jb3), [], steps=150,
                              pfreq=50)
    sd, g = jout.load(ft[-1])
    # the floor slows both bodies (gravity alone would speed them up)
    assert (g["body"].vcm_mat[:, 1] > B3_VY + 0.5).all()


def _templates():
    s2, s3 = 0.025, 0.05
    x2, y2 = get_2d_block(s2, 0.2, 0.2)
    x3, y3, z3 = get_3d_block(s3, 0.2, 0.2, 0.2)
    d, s, r = 1e-2, 1e-3, 0.5e-2
    xc, yc = create_circle_1(d, s, [r, r + s / 2.0])
    return {
        "benchmark_5_2d": ((x2, y2), dict(m=2000.0 * s2**2, h=1.3 * s2,
                                          rho=2000.0, dim=2)),
        "benchmark_5_3d": ((x3, y3, z3), dict(m=2000.0 * s3**3, h=s3,
                                              rho=2000.0, dim=3)),
        "stack_of_cylinders": ((xc, yc), dict(m=2700.0 * s**2, h=s,
                                              rho=2700.0, dim=2)),
    }


@pytest.mark.parametrize("name", sorted(_templates()))
def test_identify_template_flags_bit_for_bit(name):
    args, kw = _templates()[name]
    want = np.asarray(jbu.identify_template(*args, **kw))
    got = tbu.identify_template(*args, **kw)
    assert got.dtype == want.dtype == np.int32
    assert 0 < int(got.sum()) < len(got)
    np.testing.assert_array_equal(got, want)
    _, isb = tbu.identify_normals_template(*args, **kw)
    np.testing.assert_array_equal(isb, want)


def _setup_pair(jmod, tmod, cls, argv, spacing=None):
    import importlib
    jm = importlib.import_module(jmod)
    japp, tapp = getattr(jm, cls)(), getattr(tmod, cls)()
    tapp.dtype = torch.float64
    if spacing is not None:
        japp.initialize(spacing=spacing)
        tapp.initialize(spacing=spacing)
    japp._parse(argv)
    tapp._parse(argv + CPU_ARGS)
    return japp, japp.create_particles(), tapp, tapp.create_particles()


SETUPS = {
    "benchmark_5_3d": ("benchmark_5_steady_cubes_on_a_wall_3d", tb5_3d,
                       "Benchmark5_3D", ["--one-cube"], None),
    "sinking_box": ("rigid_body_rotating_and_sinking_in_tank_2d", tsink,
                    "SinkingBox", [], 0.1),
    "dem_column_collapse": ("dem_granular_column_collapse", tdem,
                            "GranularColumnCollapse",
                            ["--column-scale", "0.3"], None),
    "stack_of_cylinders": ("stack_of_cylinders", tstack,
                           "ZhangStackOfCylinders", [], None),
    "benchmark_1": ("benchmark_1_rigid_body_rotating_and_translating_freely",
                    tb1, "Case0", [], None),
    "benchmark_2": ("benchmark_2_multiple_rigid_bodies_colliding", tb2,
                    "Benchmark2", [], None),
    "benchmark_2_same_array": (
        "benchmark_2_multiple_rigid_bodies_colliding_same_particle_array",
        tb2s, "Benchmark2SameArray", [], None),
    "benchmark_3": (
        "benchmark_3_multiple_rigid_bodies_colliding_same_particle_array",
        tb3, "Benchmark3", [], None),
    "benchmark_4": ("benchmark_4_rigid_cube_bouncing_on_a_wall", tb4,
                    "Benchmark4", ["--coeff-of-restitution", "0.8"], None),
    "stack_of_cylinders_test_1": ("stack_of_cylinders_test_1", tstack1,
                                  "StackOfCylindersTest1", [], None),
}


@pytest.mark.parametrize("case", sorted(SETUPS))
def test_case_setup_matches_reference_f64(case, cell_engine):
    japp, jscene, tapp, tscene = _setup_pair(*SETUPS[case])
    view = tapp.scheme.export_scene(tscene)
    assert view.n == jscene.n
    for g in jscene.meta.groups:
        tg = view.meta.group(g.name)
        assert (tg.start, tg.stop, tg.role) == (g.start, g.stop, g.role)
    assert set(jscene.fields) - set(view.fields) <= RK2_FIELDS
    assert set(view.fields) - set(jscene.fields) <= {"cl_pid", "cl_state"}
    assert len(japp.events) == len(tapp.events)
    for k in sorted(set(jscene.fields) & set(view.fields)):
        a, b = np.asarray(jscene[k]), view[k].numpy()
        if k == "closest_point_dist_to_source":
            # before the first contact evaluation an [N, S] schema holds
            # 0, the compact store's uncovered rows the init distance
            # 4 spacing0: both mean "no source yet"
            init = 4.0 * jscene.meta.spacing0
            a, b = (np.where(v == 0.0, init, v) for v in (a, b))
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
    if "is_boundary" in jscene.fields:
        assert int(np.asarray(jscene.is_boundary).sum()) > 0


def _short_runs(root):
    """A few steps of each ported case into ``root/<name>_output`` (and
    its results.npz where the case has a post-processing step); benchmark
    5 in 2D only, the 3D runs' check being the same function."""
    def run(mod, cls, name, argv, spacing=None):
        app = getattr(mod, cls)()
        if spacing is not None:
            app.initialize(spacing=spacing)
        app.run(["-d", os.path.join(root, f"{name}_output"), "--max-steps",
                 "3", "--pfreq", "1", "--quiet"] + argv + CPU_ARGS)
        app.post_process()

    run(tb5_2d, "Benchmark5_2D", "benchmark_5_2d_two", ["--two-cubes"])
    run(tsink, "SinkingBox", "sinking_box", [], spacing=0.1)
    run(tdem, "GranularColumnCollapse", "dem_column_collapse",
        ["--column-scale", "0.3"])
    run(tstack, "ZhangStackOfCylinders", "stack_of_cylinders", [])
    run(tb1, "Case0", "benchmark_1", [])
    run(tb2, "Benchmark2", "benchmark_2", [])
    run(tb2s, "Benchmark2SameArray", "benchmark_2_same_array", [])
    run(tb3, "Benchmark3", "benchmark_3", [])
    run(tb4, "Benchmark4", "benchmark_4_en_0.8",
        ["--coeff-of-restitution", "0.8"])


def test_validate_checks_match_the_root_validate(tmp_path, monkeypatch):
    root = str(tmp_path)
    _short_runs(root)
    monkeypatch.setattr(jvalidate, "HERE", root)
    # the root check reads benchmark 4's oracle data under its HERE
    os.makedirs(os.path.join(root, "cases", "data"))
    shutil.copy(os.path.join(ROOT, "cases", "data",
                             "benchmark_4_oracle.json"),
                os.path.join(root, "cases", "data"))
    seen = 0
    for name, check in tvalidate.CHECKS.items():
        got, want = check(root), jvalidate.CHECKS[name]()
        assert got == want, name
        seen += got is not None
    assert seen == 9
    # the CLI's exit code and JSON agree with the checks
    out = str(tmp_path / "v.json")
    rc = tvalidate.main(["--root", root, "--json", out,
                         "benchmark_5_2d_two", "sinking_box"])
    assert rc == (0 if tvalidate.CHECKS["benchmark_5_2d_two"](root)["ok"]
                  and tvalidate.CHECKS["sinking_box"](root)["ok"] else 1)
    assert os.path.exists(out)
