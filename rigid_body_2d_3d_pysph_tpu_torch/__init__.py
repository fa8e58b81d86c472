"""PyTorch/CUDA port of ``rigid_body_2d_3d_pysph_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here has
a counterpart of the same name there (``state/``, ``geom/``, ``ops/``,
``models/``, ``app/``; ``cases/``, ``validate.py`` and ``run_suite.py``
mirror the repository's case scripts and harnesses) and the tests hold
the two against each other.  This package imports ``torch`` and never
``jax``.

The hand-written CUDA kernels live in ``csrc/`` and are built on first
use by ``ops/_build.py``; on CPU tensors every kernel wrapper runs its
plain PyTorch twin instead.
"""
