"""Port vs reference: the small modules the port carries beside its
schemes.

* ``geom.rotate_2d`` equals the JAX package's bit for bit (both numpy);
* ``utils.profiling``: ``PhaseTimer`` accumulates and reports phases,
  ``Throughput`` counts steps and particle-steps, as the reference's;
  ``device_trace`` writes a Chrome trace of the block (host activity on
  the CPU);
* ``Application.customize_output`` is the reference's no-op hook.
"""

import json
import time

import numpy as np
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu import geom as jgeom
from rigid_body_2d_3d_pysph_tpu.utils import profiling as jprof

from rigid_body_2d_3d_pysph_tpu_torch import geom as tgeom
from rigid_body_2d_3d_pysph_tpu_torch.app.application import Application
from rigid_body_2d_3d_pysph_tpu_torch.utils import profiling as tprof


def test_rotate_2d_matches_reference():
    x, y = jgeom.get_2d_block(0.05, 0.4, 0.2)
    for angle, about in ((30.0, (0.0, 0.0)), (-117.5, (0.1, -0.3)),
                         (90.0, (0.25, 0.25))):
        jx, jy = jgeom.rotate_2d(x, y, angle, about)
        tx, ty = tgeom.rotate_2d(x, y, angle, about)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    # a quarter turn about the origin maps (x, y) to (-y, x)
    tx, ty = tgeom.rotate_2d(np.array([1.0]), np.array([0.0]), 90.0)
    np.testing.assert_allclose([tx[0], ty[0]], [0.0, 1.0], atol=1e-15)


def test_phase_timer_and_throughput():
    for mod in (jprof, tprof):
        t = mod.PhaseTimer()
        for _ in range(3):
            with t.phase("a"):
                time.sleep(0.001)
        with t.phase("b"):
            pass
        try:
            with t.phase("c"):
                raise ValueError
        except ValueError:
            pass
        assert dict(t.counts) == {"a": 3, "b": 1, "c": 1}
        assert t.totals["a"] >= 0.003 and t.totals["b"] >= 0.0
        lines = t.report().splitlines()
        assert lines[0].startswith("a") and len(lines) == 3
        assert lines[0].rstrip().endswith("x3")

        m = mod.Throughput(1000)
        m.add(5)
        m.add(7)
        assert m.steps == 12
        sps = m.steps_per_sec
        assert sps > 0
        assert m.particle_steps_per_sec >= 1000 * sps * 0.5


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path)):
        torch.ones(64).cumsum(0)
    with open(tmp_path / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_customize_output_is_a_no_op():
    assert Application.customize_output(object()) is None
