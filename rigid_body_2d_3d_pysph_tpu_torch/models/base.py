"""Scheme base class.

Counterpart of ``Scheme`` in ``rigid_body_2d_3d_pysph_tpu/models/base.py``.
A scheme owns ``setup(scene)`` (host-side state attachment),
``make_step(scene)`` (an eager ``step(scene, dt)`` for one integrator
timestep) and the capacity bookkeeping of the overflow-rebuild rule.
"""

from __future__ import annotations

from ..state.scene import Scene


class Scheme:
    name = "scheme"

    #: slack multiplier applied to every measured-occupancy capacity
    #: (cell slots, spill stencil width, interesting-slot capacity); the
    #: overflow-rebuild rule raises it when a capacity sized from one
    #: snapshot overflows as the simulation spreads
    capacity_boost = 1.0

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
