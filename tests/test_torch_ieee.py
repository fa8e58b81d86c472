"""The plain fluid versions give the same bits on their first call in a
process as on the second, with several torch threads.

On CPU tensors ``torch.sqrt`` (torch 2.13.0+cpu) runs MKL VML on each
OpenMP worker thread's share of the tensor, and the first call on a
fresh worker thread could return a ~12-bit approximation for that share:
``fluid_rates_wall_reference`` differed on its first call in one fresh
process in 6 to 40 (4 or 8 threads, a random pack; the rate moves with
the machine's load).  The port's plain versions take their square roots
from ``ops.ieee.sqrt`` instead.  The first-call check runs in six fresh
processes at once, so it catches the fault only now and then; the
deterministic checks are that no plain fluid or contact version calls
``torch.sqrt`` on a CPU tensor, and that ``ieee.sqrt`` rounds correctly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # the suite runs one worker process a core

from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk
from rigid_body_2d_3d_pysph_tpu_torch.ops import ieee

from test_torch_cuda_kernels import _fluid_pack_args

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
sys.path[:0] = [{root!r}, {tests!r}]
import torch
torch.set_num_threads(4)
from test_torch_cuda_kernels import _fluid_pack_args
from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk

dfT, nbr, kernel, cutoff = _fluid_pack_args(
    2, 3, torch.device("cpu"), seed=302)[:4]
g = (0.0, -1.0, 0.0)
calls = dict(
    rates_wall=lambda: fk.fluid_rates_wall_reference(
        dfT, nbr, kernel, cutoff, 0.1, 10.0, True, True, g),
    rates=lambda: fk.fluid_rates_reference(
        dfT, nbr, kernel, cutoff, 0.1, 10.0, True, True),
    wall=lambda: fk.wall_bc_reference(dfT, nbr, kernel, cutoff, g))
for name, fn in calls.items():
    first, second = fn(), fn()
    assert bool(second.abs().max() > 0), name
    print(name, torch.equal(first, second))
"""


def test_plain_fluid_versions_first_call_bits():
    code = _SCRIPT.format(root=ROOT, tests=os.path.join(ROOT, "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        lines = out.split()
        assert lines == ["rates_wall", "True", "rates", "True", "wall",
                         "True"], out


def test_sqrt_is_correctly_rounded():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0.0, 4.0, 4096),
                        2.0 ** rng.integers(-60, 60, 512),
                        rng.uniform(0.0, 1e18, 512)])
    got = ieee.sqrt(torch.as_tensor(x, dtype=torch.float32))
    # f32: the square root in f64 rounded once to f32 is the correctly
    # rounded one
    want = np.sqrt(x.astype(np.float32).astype(np.float64)).astype(
        np.float32)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    got64 = ieee.sqrt(torch.as_tensor(x))
    np.testing.assert_array_equal(got64.numpy(), np.sqrt(x))
    assert bool(torch.isnan(ieee.sqrt(torch.tensor([-1.0]))).all())


def test_plain_versions_take_no_torch_sqrt(monkeypatch):
    dfT, nbr, kernel, cutoff, alpha, c0, S, init = _fluid_pack_args(
        2, 3, torch.device("cpu"), seed=7, NC=24)
    g = (0.0, -1.0, 0.0)
    calls = [
        lambda: fk.fluid_rates_wall_reference(dfT, nbr, kernel, cutoff, 0.1,
                                              c0, True, True, g),
        lambda: fk.fluid_rates_reference(dfT, nbr, kernel, cutoff, 0.1, c0,
                                         True, True),
        lambda: fk.wall_bc_reference(dfT, nbr, kernel, cutoff, g),
        lambda: fk.fluid_forces_reference(dfT, nbr, kernel, cutoff, alpha,
                                          c0, True),
        lambda: torch.cat(fk.fluid_forces_contact_reference(
            dfT, nbr, kernel, cutoff, alpha, c0, S, init), -1)]
    want = [fn() for fn in calls]

    def cpu_sqrt(t, *a, **k):
        raise AssertionError("torch.sqrt on a CPU tensor")

    monkeypatch.setattr(torch, "sqrt", cpu_sqrt)
    for fn, w in zip(calls, want):
        assert torch.equal(fn(), w)
    with pytest.raises(AssertionError):
        torch.sqrt(dfT)
