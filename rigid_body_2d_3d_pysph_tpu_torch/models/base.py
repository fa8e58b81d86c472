"""Scheme base class and SchemeChooser.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/models/base.py``.  A scheme
owns its CLI options (``add_user_options`` / ``consume_user_options``),
``configure`` / ``configure_solver``, ``setup(scene)`` (host-side state
attachment), ``make_step(scene)`` (an eager ``step(scene, dt)`` for one
integrator timestep) and the capacity bookkeeping of the
overflow-rebuild rule.  ``SchemeChooser`` selects one of several schemes
by the ``--scheme`` flag.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

from ..state.scene import Scene


class Scheme:
    name = "scheme"

    #: slack multiplier applied to every measured-occupancy capacity
    #: (cell slots, spill stencil width, interesting-slot capacity); the
    #: overflow-rebuild rule raises it when a capacity sized from one
    #: snapshot overflows as the simulation spreads
    capacity_boost = 1.0

    # the solver's settings (``configure_solver``)
    dt: Optional[float] = None
    tf: Optional[float] = None
    pfreq = 100

    def add_user_options(self, group: argparse._ArgumentGroup) -> None:
        pass

    def consume_user_options(self, options: argparse.Namespace) -> None:
        pass

    def configure(self, **kw) -> None:
        for k, v in kw.items():
            if not hasattr(self, k):
                raise AttributeError(
                    f"{type(self).__name__} has no option {k!r}")
            setattr(self, k, v)

    def configure_solver(self, dt: float, tf: float, pfreq: int = 100,
                         **kw) -> None:
        """The solver's dt, tf and output frequency (and any further
        solver attributes)."""
        self.dt = float(dt)
        self.tf = float(tf)
        self.pfreq = int(pfreq)
        for k, v in kw.items():
            setattr(self, k, v)

    def setup(self, scene: Scene, **kw) -> Scene:
        raise NotImplementedError

    def make_step(self, scene: Scene):
        raise NotImplementedError

    def adapt_scene(self, scene: Scene) -> Scene:
        """Align scheme-owned, capacity-shaped scene state with the
        current configs after a rebuild (identity by default)."""
        return scene

    def export_scene(self, scene: Scene) -> Scene:
        """IO view of the scene (identity by default)."""
        return scene

    def refresh_configs(self, scene: Scene, grow: bool = False) -> None:
        """Drop the cached cell-grid config so the next ``make_step``
        re-sizes capacities from the current positions; ``grow=True``
        also widens every slack factor 1.5x (a rebuild from the same
        snapshot overflowed again)."""
        if grow:
            self.capacity_boost = float(self.capacity_boost) * 1.5
        self._cell_cfg = None


class _Dedup:
    """An argument group that adds each flag once: schemes share option
    names (``--kr-stiffness`` in both rigid schemes)."""

    def __init__(self, group):
        self._g = group
        self._seen = set()

    def add_argument(self, *a, **kw):
        if a and a[0] in self._seen:
            return None
        self._seen.add(a[0] if a else None)
        return self._g.add_argument(*a, **kw)


class SchemeChooser(Scheme):
    """Selects one of several schemes by the ``--scheme`` flag and
    delegates the solver-facing surface to the selected one."""

    def __init__(self, default: str, **schemes: Scheme):
        self.schemes: Dict[str, Scheme] = dict(schemes)
        self.default = default
        self.scheme: Scheme = self.schemes[default]

    def select(self, name: Optional[str]) -> Scheme:
        if name:
            self.scheme = self.schemes[name]
        return self.scheme

    def add_user_options(self, group) -> None:
        group.add_argument("--scheme", default=self.default,
                           choices=sorted(self.schemes.keys()),
                           help="Scheme to use")
        dg = _Dedup(group)
        for s in self.schemes.values():
            s.add_user_options(dg)

    def consume_user_options(self, options) -> None:
        self.select(getattr(options, "scheme", None))
        self.scheme.consume_user_options(options)

    # explicit delegation: an inherited method would act on the chooser
    # (refresh_configs would clear the chooser's config while the
    # selected scheme kept its overflowing one)
    def setup(self, scene, **kw):
        return self.scheme.setup(scene, **kw)

    def make_step(self, scene, **kw):
        return self.scheme.make_step(scene, **kw)

    def refresh_configs(self, scene, grow: bool = False):
        return self.scheme.refresh_configs(scene, grow=grow)

    def adapt_scene(self, scene):
        return self.scheme.adapt_scene(scene)

    def export_scene(self, scene):
        return self.scheme.export_scene(scene)

    # class attributes on Scheme, so __getattr__ never sees them
    @property
    def capacity_boost(self):
        return self.scheme.capacity_boost

    def _delegated(name):
        return property(lambda self: getattr(self.scheme, name),
                        lambda self, v: setattr(self.scheme, name, v))

    dt = _delegated("dt")
    tf = _delegated("tf")
    pfreq = _delegated("pfreq")
    del _delegated

    def configure(self, **kw) -> None:
        self.scheme.configure(**kw)

    def configure_solver(self, dt, tf, pfreq=100, **kw):
        self.scheme.configure_solver(dt, tf, pfreq, **kw)

    def __getattr__(self, k):
        # everything else from the selected scheme
        return getattr(self.__dict__["scheme"], k)
