"""Host-side particle lattice generators (numpy, float64).

A copy of the lattice builders the rigid-contact slice needs from
``rigid_body_2d_3d_pysph_tpu/geom/geometry.py`` (importing that module
would import ``jax`` through the reference package's ``__init__``).
Semantics follow PySPH's ``get_2d_block`` / ``get_3d_block`` /
``get_2d_tank``; ``get_fluid_tank_3d`` follows the reference's 3D tank
(``code/geometry.py:27-102``).
"""

from __future__ import annotations

import numpy as np


def get_2d_block(dx: float, length: float, height: float, center=(0.0, 0.0)):
    """Regular 2D lattice spanning [-L/2, L/2] x [-H/2, H/2] + center,
    ``int(length/dx) + 1`` points per axis, endpoints inclusive."""
    n1 = int(round(length / dx)) + 1
    n2 = int(round(height / dx)) + 1
    xs = np.linspace(-length / 2.0, length / 2.0, n1)
    ys = np.linspace(-height / 2.0, height / 2.0, n2)
    x, y = np.meshgrid(xs, ys, indexing="ij")
    return x.ravel() + center[0], y.ravel() + center[1]


def get_3d_block(dx: float, length: float, height: float, depth: float,
                 center=(0.0, 0.0, 0.0)):
    """Regular 3D lattice, endpoints inclusive."""
    n1 = int(round(length / dx)) + 1
    n2 = int(round(height / dx)) + 1
    n3 = int(round(depth / dx)) + 1
    xs = np.linspace(-length / 2.0, length / 2.0, n1)
    ys = np.linspace(-height / 2.0, height / 2.0, n2)
    zs = np.linspace(-depth / 2.0, depth / 2.0, n3)
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    return (
        x.ravel() + center[0],
        y.ravel() + center[1],
        z.ravel() + center[2],
    )


def get_2d_tank(dx: float, length: float, height: float, num_layers: int = 1):
    """Open U-shaped 2D tank: the inner region spans
    ``[-length/2, length/2] x [0, height]`` with ``num_layers`` wall rows
    outside it."""
    L, H, k = length, height, num_layers
    x0 = -L / 2.0
    xb, yb = _grid(x0 - k * dx, L + x0 + k * dx, -k * dx, -dx, dx)
    xl, yl = _grid(x0 - k * dx, x0 - dx, 0.0, H, dx)
    xr, yr = _grid(L + x0 + dx, L + x0 + k * dx, 0.0, H, dx)
    x = np.concatenate([xl, xr, xb])
    y = np.concatenate([yl, yr, yb])
    return x, y


def _grid(x0, x1, y0, y1, dx):
    nx = int(round((x1 - x0) / dx)) + 1
    ny = int(round((y1 - y0) / dx)) + 1
    xs = np.linspace(x0, x1, nx)
    ys = np.linspace(y0, y1, ny)
    x, y = np.meshgrid(xs, ys, indexing="ij")
    return x.ravel(), y.ravel()


def hydrostatic_tank_2d(fluid_length, fluid_height, tank_height, tank_layers,
                        fluid_spacing, tank_spacing):
    """2D tank + fluid block, the fluid aligned inside the tank."""
    xt, yt = get_2d_tank(
        dx=tank_spacing,
        length=fluid_length + 2.0 * tank_spacing,
        height=tank_height,
        num_layers=tank_layers,
    )
    xf, yf = get_2d_block(fluid_spacing, fluid_length, fluid_height)
    xf += np.min(xt) - np.min(xf)
    yf -= np.min(yf) - np.min(yt)
    xf += tank_spacing * tank_layers
    yf += tank_spacing * tank_layers
    return xf, yf, xt, yt


def create_tank_2d_from_block_2d(xf, yf, tank_length, tank_height,
                                 tank_spacing, tank_layers):
    """Tank walls (left, right, bottom) around an existing block."""
    dx, k = tank_spacing, tank_layers
    xl, yl = get_2d_block(dx, (k - 1) * dx, tank_height)
    xl += np.min(xf) - np.max(xl) - dx
    yl += np.min(yf) - np.min(yl)

    xr = xl + abs(np.min(xl)) + tank_length + dx
    yr = np.array(yl)

    xb, yb = get_2d_block(dx, np.max(xr) - np.min(xl), (k - 1) * dx)
    xb += np.min(xl) - np.min(xb)
    yb += np.min(yl) - np.max(yb) - dx

    return np.concatenate([xl, xr, xb]), np.concatenate([yl, yr, yb])


def _abut(a, to, at_max=False, gap=0.0):
    """``a`` shifted so that its lowest (``at_max``: highest) value sits at
    ``to + gap``."""
    edge = np.max(a) if at_max else np.min(a)
    return a + ((to - edge) + gap)


def get_fluid_tank_3d(fluid_length, fluid_height, fluid_depth, tank_length,
                      tank_height, tank_layers, fluid_spacing, tank_spacing,
                      hydrostatic=False):
    """A 3D fluid block (length along x, height along y, depth along z) in
    an open five-sided tank: ``(xf, yf, zf, xt, yt, zt)``.

    The fluid block stays where ``get_3d_block`` puts it (centred on the
    origin) and the walls are placed around it.  Every wall is a lattice
    of the fluid spacing, ``tank_spacing * (tank_layers - 1)`` thick, one
    ``tank_spacing`` off what it faces: a left and a right wall as deep as
    the fluid and standing on its bottom level, a front and a back wall
    over the side walls' x extent, and a floor slab under all four.  The
    right wall stands ``tank_length - fluid_length`` further out unless
    ``hydrostatic``."""
    dx, gap = fluid_spacing, tank_spacing
    thick = tank_spacing * (tank_layers - 1)
    xf, yf, zf = get_3d_block(dx, fluid_length, fluid_height, fluid_depth)
    y_base = np.min(yf)

    # the side walls, one gap off the fluid's x faces
    xl, yl, zl = get_3d_block(dx, thick, tank_height, fluid_depth)
    xl = _abut(xl, np.min(xf), at_max=True, gap=-gap)
    yl = _abut(yl, y_base)
    xr, yr, zr = get_3d_block(dx, thick, tank_height, fluid_depth)
    xr = _abut(xr, np.max(xf), gap=gap)
    if not hydrostatic:
        xr = xr + (tank_length - fluid_length)
    yr = _abut(yr, y_base)

    # the front (+z) and back (-z) walls across the side walls' x span
    span = np.max(xr) - np.min(xl)
    walls = []
    for front in (True, False):
        xw, yw, zw = get_3d_block(dx, span, tank_height, thick)
        xw = _abut(xw, np.min(xl))
        yw = _abut(yw, y_base)
        zw = (_abut(zw, np.max(zl), gap=gap) if front else
              _abut(zw, np.min(zl), at_max=True, gap=-gap))
        walls.append((xw, yw, zw))
    (xfr, yfr, zfr), (xbk, ybk, zbk) = walls

    # the floor slab under all four walls
    xs, ys, zs = get_3d_block(dx, span, thick, np.max(zfr) - np.min(zbk))
    xs = _abut(xs, np.min(xl))
    ys = _abut(ys, np.min(yl), at_max=True, gap=-gap)

    parts = [(xl, yl, zl), (xr, yr, zr), (xfr, yfr, zfr), (xbk, ybk, zbk),
             (xs, ys, zs)]
    xt, yt, zt = (np.concatenate([p[i] for p in parts]) for i in range(3))
    return xf, yf, zf, xt, yt, zt


def create_circle_1(diameter=1.0, spacing=0.05, center=None):
    """Concentric-ring circle fill (the stack of cylinders' cylinder; its
    particle count sizes the cylinders' body-id blocks)."""
    radius = diameter / 2.0
    xs, ys = [0.0], [0.0]
    ring_r = radius - spacing / 2.0
    i = 0
    while ring_r > spacing / 2.0:
        perimeter = 2.0 * np.pi * ring_r
        n_pts = int(perimeter / spacing) + 1
        theta = np.linspace(0.0, 2.0 * np.pi, n_pts)
        for t in theta[:-1]:
            xs.append(ring_r * np.cos(t))
            ys.append(ring_r * np.sin(t))
        i += 1
        ring_r = radius - spacing / 2.0 - i * spacing
    x = np.asarray(xs)
    y = np.asarray(ys)
    if center is not None:
        x = x + center[0]
        y = y + center[1]
    return x, y


def create_circle(diameter=1.0, spacing=0.05, center=None):
    """Block-masked circle fill."""
    radius = diameter / 2.0
    xt, yt = get_2d_block(spacing, diameter + spacing, diameter + spacing)
    keep = xt**2 + yt**2 < radius**2
    x, y = xt[keep], yt[keep]
    if center is not None:
        x = x + center[0]
        y = y + center[1]
    return x, y


def rotate_2d(x, y, angle_deg: float, about=(0.0, 0.0)):
    """Rotate a lattice about a point by ``angle_deg`` degrees."""
    a = np.deg2rad(angle_deg)
    cx, cy = about
    dx, dy = x - cx, y - cy
    return (
        cx + dx * np.cos(a) - dy * np.sin(a),
        cy + dx * np.sin(a) + dy * np.cos(a),
    )
