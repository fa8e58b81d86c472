#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the
CUDA toolkit.  Phases, in order (any failure exits non-zero and prints
no result line):

1. environment: torch/CUDA versions, the card's name and power limit;
   TF32 off for matmul and cuDNN;
2. build: every hand-written kernel source in ``csrc/`` (one nvcc each,
   all started together; sm_90a), with seconds and register reports;
3. rigid kernels against their plain twins on the card at the main
   path's shapes (2D, F = 7) and on phase 5a's 3D scene (F = 9, 27-cell
   stencil): pack expansion bit for bit, contact picks bit for bit,
   contact sums within rtol 1e-5 (f32 summation order), K2 on every slot
   equal bit for bit to K2 on the culled rows at their slots; kernel and
   twin times in ms; in 3D K2 on every slot against its twin, timed
   with its bound (the leapfrog path's launch), and
   K2 also on every interesting row (the rows the 3D path runs once its
   overflow rebuilds have raised ``ni_max``), timed with its bound;
4. the rigid main path: ``RigidBody2DScheme.setup`` -> ``make_step`` ->
   ``step`` for 150 steps at dt = 1e-4 on a ~105k-particle scene that is
   in contact from the first step (a resting stack of 8 blocks in two
   rows of 4 on a tank floor), in chunks with the overflow-rebuild rule;
   checks launch counts, interesting slots, overlap, finiteness,
   overflow, COM drift < 2 dx, and that no block dropped half the
   free-fall distance (the stack is carried by contact), and prints
   steps/s;
5. 20 rigid kernel steps against 20 twin steps from one state;
5a. the 3D main path: ``RigidBody3DScheme.setup`` -> ``make_step`` ->
   ``step`` for 150 steps at dt = 1e-4 on 8 cubes at rest on a floor slab
   (~116.5k particles, S = 9), in chunks with the overflow-rebuild rule
   (each rebuild and the final ``ni_max``, NC and O printed), under
   phase 4's gates (COM drift over x, y and z); prints steps/s;
5b. 20 3D kernel steps against 20 twin steps from 5a's end state;
6. DEM kernels against their twins on ~100k grains in contact (2D spill
   grid, 3D spill grid, 2D row-window grid, 3D row-window grid), each
   from an empty contact table (every contact allocated), a filled one,
   and one whose contacts open and close (positions jittered by up to an
   overlap: slots freed and reallocated); the 2D grids also on a crowded
   column (grains at half the spacing, so each has ~12 gated partners
   for its 8 slots: full tables, new contacts dropped, pair lists
   emptied many times a warp): tables, slot positions and counts bit for
   bit, force and torque sums within 2e-5 |ref| + 2e-5 max |ref|,
   springs within rtol 1e-4; times, gated pairs, candidate lanes;
7. the DEM main path (``DEMScheme`` LVC displacement, spill grid): 200
   steps at dt = 5e-6 of a granular column whose grains start 0.5 %
   overlapped, in chunks with the overflow-rebuild rule; checks one
   kernel launch per step, live contacts every step, finiteness,
   overflow, the floor and the overlap; prints steps/s;
8. the same on the row-window grid for 100 steps (one DEM launch and one
   pack expansion per step);
9. 20 DEM kernel steps against 20 twin steps from one state;
10. the coupling fluid kernels (B4 rates + wall sums, B5 forces +
    contact) against their twins on the sinking box of
    ``cases/rigid_body_rotating_and_sinking_in_tank_2d.py`` at bench.py's
    coupling size (~96.9k particles, seeded random velocities) and on a
    placement with the box resting 0.95 dx above the tank floor (gated
    contact pairs > 0): sums within 2e-5 of each column's largest
    magnitude (f32 summation order; the unit contact normals 2e-5
    absolute), contact picks bit for bit, two launches on the same
    inputs bit for bit; times, lanes and pairs; K1 on the sinking box's
    coupling pack (F = 14) bit for bit, timed with its bound;
11. the coupling main path: ``RigidFluidCouplingScheme.setup`` ->
    ``make_step`` -> ``step``, 150 fused kdkf steps of the sinking box at
    the case's dt = 0.25 dx / (1.1 c0), in chunks with the
    overflow-rebuild rule; checks one K1, one B4 and one B5 launch per
    step and no K2, finiteness, overflow, fluid rho within 5 % of rho0
    and the box's COM lower at the end; prints steps/s;
12. the fluid-only tank (the same tank without the box): B4 (no rigid
    body) and B6c against their twins on its pack as in phase 10, timed,
    then 50 steps:
    one K1, one B4 and one B6c launch per step;
13. 20 coupling kernel steps against 20 twin steps on the contact
    placement with a box of 8 times the fluid's density, in contact to
    the end (overlap and tangential springs nonzero in both runs); the
    fluid, body and contact-slot fields within rtol 1e-4;
14. (run beside phase 10, on its two scenes) the split fluid passes of
    the kdk and reference orderings (B6a with EDAC and with Tait, B6b,
    B6c with rigid bodies) and K2 on every slot of the contact pack laid
    out from the coupling pack, against their twins on the sinking box
    (timed) and with the box on the floor (contact picks > 0): sums as
    in phase 10 (two launches bit for bit), K2's picks bit for bit;
    times, lanes and pairs;
15. the kdk ordering: ``gtvf_ordering="kdk"``, 150 steps of the sinking
    box as in phase 11; checks two K1, one B6a, one B6b, one B6c and one
    K2 launch per step and nothing else, and the gates of phase 11;
16. the reference ordering, the same with one K1 launch per step;
17. the no-fluid route: an RFC scheme with ``fluids=[]`` on phase 4's
    resting stack, 50 steps at dt = 1e-4 (kdkf routed to kdk): K2 on
    every slot of its pack against its twin, then one K1 and one K2
    launch per step and nothing else, overlap > 0, finite fields;
18. 20 kdk and 20 reference kernel steps against as many twin steps on
    phase 13's placement, in contact to the end, as in phase 13;
19. the sinking box in 3D (``RigidFluidCouplingScheme(dim=3)`` set-up,
    ~97k particles): every fluid pass (B4, B5, B6a with EDAC and with
    Tait, B6b, B6c with and without bodies) and K1 on its pack against
    their twins as in phase 10, each timed with its bound;
20. the 3D coupling main path: phase 19's box through ``make_step``,
    driven by the port's ``Solver`` (chunks of 50, the overflow rule,
    snapshots): 150 fused kdkf steps under phase 11's gates (one K1, B4
    and B5 launch a step and nothing else); then 20 kernel steps against
    20 twin steps (rtol 1e-4); prints steps/s;
21. benchmark 5 in 2D with two cubes, run to half its tf (2,500 steps)
    through the port's ``Application``, gated by the port's
    ``check_benchmark_5`` (COM displacement < 2 spacings); one K1 and
    one K2 launch a step; prints steps/s and the displacement;
22. the sinking box at the case's size (spacing 0.02) through the
    port's ``Application``: 1,000 steps with a snapshot every 100 and a
    checkpoint; 500 steps in a second directory, then a third run
    resumed there to 1,000: its last snapshot equals the uninterrupted
    run's bit for bit; the uninterrupted run's step-500 snapshot, written
    by the background writer while the steps went on, equals the second
    run's step-500 state written synchronously;
23. the rigid RK2 step (``integrator="rk2"``, full ``[N, S]`` schema)
    on phase 4's resting stack: 100 steps in chunks with the overflow
    rule, two K1 and two K2 launches (every slot) a step and nothing
    else, no compact store, phase 4's gates (overlap, finiteness,
    overflow, COM drift, no free fall); prints steps/s; then 20 kernel
    steps against 20 twin steps as in phase 5;
24. the leapfrog step (``integrator="leapfrog"``) on phase 5a's 3D
    cubes, the same way with one K1 and one K2 launch a step;
25. the RK2 coupling step (``fluid_stepper="rk2"``, Tait) on the sinking
    box of phase 11: 150 steps (as phase 11: at y = 3 the box's f32 COM
    moves only once a step's displacement passes half an ulp, after
    ~100 steps from rest), two K1, B6a, B6b, B6c and K2 launches a step
    and nothing else, phase 11's gates; then 20 kernel steps against 20
    twin steps on phase 13's placement as in phase 13;
26. the DEM step with ``contact_model="LVCForce"`` (no kernel: the
    reference runs it in XLA only) on phase 7's column for 50 steps at
    dt = 5e-6: live contacts every step, finiteness, no overflow, the
    floor holds, overlap < 0.1 r, no kernel launched; prints steps/s;
27. benchmark 2 (two cubes colliding head-on, no boundary,
    ``RigidBody3DScheme`` on the 2D scene) to its own tf (~3,000 steps)
    through the port's ``Application``, gated by the port's
    ``check_benchmark_2`` (momentum < 1e-2, both cubes rebound); one K1
    and one K2 launch a step; prints steps/s;
28. the rigid slab step (``parallel/slab.py``) on phase 4's stack,
    SLAB_P = 4 slabs on the card, blob route: 10 slab steps against 10
    single-device steps and against 10 slab steps on the kernels'
    plain versions (10 in phases 28-33, 20 elsewhere), from one state with the blocks sliding (velocities
    and the bodies' state within STEP_RTOL, positions as their change
    over the steps, by gid); 4 K1 and 4 K2 launches a step and nothing
    else; some slab with interesting slots; K1 and K2 on each slab's
    extended scene against their twins, timed; then 150 steps with an
    on-device redistribution every 50 under phase 4's gates, and the
    steps/s of 4 slabs and of one;
29. the 3D cubes of phase 5a on the most slabs of at least 2 cell
    columns each, on the blob and the full ``[N, S]`` routes (K2 on
    every slot of each slab), each route's 10-step comparisons (against
    the slab step on one slab in place of the single-device step) and
    per-slab K2 as in phase 28;
30. the DEM slab step on phase 7's column, 4 slabs on the card: 10
    steps against 10 single-device and 10 plain slab steps (the tables
    as gid-keyed maps), 4 K1 and 4 K4 launches a step, live contacts
    every step, the tables unchanged by an on-device redistribution,
    K4 on each slab's extended scene against its twin, timed, and 100
    steps with a redistribution every 50;
31. with 2 or more cards, phase 28's comparisons with one slab a card
    (on one card it prints that it did not run);
32. the coupling slab step (``make_slab_coupling_step``) on phase 13's
    placement (the box of rho 8 on the floor, pushed down and sideways),
    the grid cut to the tank in x so that each of SLAB_P slabs on the
    card holds fluid, in the kdk and then the kdkf ordering: 10 slab
    steps against 10 single-device steps of the ordering and 10 plain
    slab steps (positions as their change, velocities, rho, p and the
    body state within STEP_RTOL, by gid; overlap > 0 at the end); SLAB_P
    x the ordering's kernels a step and nothing else (kdk: 2 K1, B6a,
    B6b, B6c, K2; kdkf: K1, B4, B6c, K2); on each slab's extended scene
    K1, the ordering's fluid passes and K2 on every slot against their
    plain versions, timed with their bounds, and some slab with rigid
    ghost rows; then 150 steps of the sinking box (phase 11's) with an
    on-device redistribution every 50 under phase 11's gates, and the
    steps/s of SLAB_P slabs and (kdkf) of one;
33. the 3D box of phase 19 on SLAB_P slabs, kdkf, as phase 32 without
    the long run (the box does not turn: its omega is printed, not
    gated);
34. (beside phases 5, 9 and 18, on their states) the list engine
    against the cell engine: 20 list steps against 20 kernel steps of
    the 2D GTVF stack (phase 5's state; the list step on its full
    ``[N, S]`` view), of the DEM column (phase 9's; the tables as (idx,
    dem) -> spring maps) and of the rho 8 box on the floor in the kdk
    and reference orderings (phase 18's), each within STEP_RTOL as its
    kernel-vs-twin parity;
35. the ``[N, K]`` list engine (``engine="nklist"``) on phase 4's stack,
    set up on lists: 100 GTVF steps under phase 4's gates, no kernel
    launched, K, the gated contact pairs and the peak device memory
    printed, steps/s;
36. the same on phase 5a's 3D cubes: 10 GTVF steps, then 10 leapfrog
    steps from a fresh set-up;
37. the DEM column on lists: 100 LVCDisplacement steps under phase 7's
    gates and 20 LVCForce steps, no kernel launched, K printed;
38. the sinking box on lists: 150 kdk and 150 reference steps under
    phase 11's gates, no kernel launched, K and the peak memory printed;
39. the five non-quintic SPH kernels (cubic, Wendland C2 and C4,
    Gaussian, super-Gaussian): their ``contact.cu`` and ``fluid.cu``
    libraries (one per kernel, ``-DRB_SPH_KERNEL``) built together, with
    seconds and ptxas's registers and spills; then for each, on scenes
    set up with it (the grid of its cutoff), K2 on the 2D stack's culled
    rows and on every slot of the 3D cubes, and B4, B5, B6a (EDAC), B6b
    and B6c (bodies) on the 2D sinking box's pack, against their plain
    versions as in phases 3, 10 and 14, each timed with its bound (W and
    dW/dr / r counted per kernel, expf as OPS_EXPF operations), and B5
    on the box on the floor (contact picks > 0);
40. the main paths with each of them: the 2D resting stack under GTVF,
    100 steps under phase 4's gates, one K1 and one K2 of the kernel's
    library a step; the sinking box under kdkf (one K1, B4 and B5 a
    step; 150 steps under phase 11's gates with the cubic, 50 with the
    others) and kdk (two K1, B6a, B6b, B6c and K2 a step, 50 steps), the
    short runs without the gate on the box's sinking, the
    super-Gaussian's 10 steps (its negative tail makes the fluid
    diverge: rho 1.47 rho0 at step 20 on the plain passes); every launch
    of K2 and the fluid passes checked to be the kernel's own instance;
    then 20 kernel steps against 20 plain steps
    (STEP_RTOL) of the stack (Wendland C2) and of the dense box on the
    floor under kdkf (cubic);
41. the Verlet skin: the 2D stack with ``skin_factor = 0.3``, 100 GTVF
    steps under phase 4's gates, one K2 on every slot (the pack gathered
    through the carried grid) and no K1 a step, the grid's rebuilds
    counted; then 20 skin steps against 20 steps of the compact no-skin
    kernel step from the same state (STEP_RTOL);
42. the kdkf step on the compact contact store (S >= 8): the sinking
    box's tank at phase 11's size with 8 boxes of rho 8 (0.25 x 0.25, 4
    on the floor, 4 on top of them, sliding; S = 9;
    ``boxes_tank_scene``), set up onto the store, 200 steps through
    ``make_step`` -> ``step`` in chunks with the overflow rule (which
    widens the store through ``adapt_scene``) under phase 11's gates but
    the sinking: one K1, one B4 and one B5 launch a step and no K2,
    engaged contact slots and tangential springs in ``cl_state`` at the
    end, n_interesting, ni_max and the rebuilds printed; then from the
    set-up state, the boxes pushed down at 0.5 m/s (the top row at 1),
    20 kernel steps against 20 plain steps (STEP_RTOL) and 20 compact
    against 20 full-route kernel steps (COMPACT_RTOL, the largest
    differences printed), with both routes' steps/s;
43. the same in 3D on ``sinking_box_scene_3d``'s tank with 8 cubes of
    0.15 (2 x 2 a layer): 50 steps under the same gates, 20 kernel
    against 20 plain steps (STEP_RTOL) and 20 compact against 20
    full-route steps;
44. the kernels' wide instances on many bodies: a 2D resting stack of
    128 blocks of ~27 x 27 (32 columns x 4 rows, S = 129, ~93k
    particles in the blocks): K2's wide instance (S > 64: no 64-bit
    masks, dynamic count tables) on every interesting row and on every
    slot (by particle, the cell pipeline's layout) against its plain
    version (picks bit for bit, sums at phase 3's tolerance, picks from
    entities past 64 present), timed with the bytes and operations of
    the output the step reads, the query-row layout and its unpack
    beside; 800 GTVF
    steps through ``make_multi_step`` in chunks of 50 under phase 4's
    gates, every K2 launch the wide instance, steps/s; 20 kernel steps
    against 20 plain steps from its end (STEP_RTOL, one K1 and one wide
    K2 a kernel step); then K2 at S = 300 (299 blocks of ~18 x 18, RK2
    set-up) on every interesting row and every slot the same way;
45. K2's wide instance on every slot of 64 cubes of 12^3 stacked 4 x 4 x
    4 on the floor slab (S = 65, the leapfrog step's launch), timed;
    B5 on the sinking box's tank with 6 layers of 50 boxes of rho 8 (S =
    301, the compact store: its contact columns by query row at the
    light cull's slots) against its plain version as in phase 10, timed,
    and the same with 8 layers of 16 boxes of 0.2 (S = 129); 50 kdkf
    steps at S = 301, then 20 kdkf kernel steps against 20 plain steps
    from the boxes pushed down (STEP_RTOL; one K1, B4 and B5 a kernel
    step, every B5 launch by query row);
46. the DEM kernels on the 3D column at table widths 8 (the narrow
    instance, timed so that each wide width's increment over it is
    measured in the same call) and 12, 16, 32 and 40 (the wide
    instance), on both grids: against their plain versions under phase
    6's gates (the filled table at every width, the empty and moved ones
    at 12 and 40, the moved one on the row-window grid; at 12 on the
    spill grid also the crowded column: more gated partners than
    slots), timed; each
    through a 50-step main path at dt 5e-7 under phase 7's gates (every
    launch the width's instance); at 12 on the spill grid 20 kernel
    steps against 20 plain steps (one K4 a kernel step);
47. the classic cell grid (one slot a cell, lanes from occupancy, set as
    the scheme's config before the set-up): the 2D stack's (M 32, O 9),
    its sub = 2 stencil's (M 8, O 25) and the 3D cubes' (M 104, O 27):
    K2 on every slot of the gathered pack against its plain version
    (picks bit for bit, sums at phase 3's tolerance), timed with its
    bound; 100 GTVF steps under phase 4's gates (one K2 a step at the
    grid's width, no K1, the full [N, S] schema, no overflow); 20 kernel
    steps against 20 plain steps (10 for the 3D cubes);
48. the kdk and kdkf coupling orderings on the sinking box's classic
    grid of 48 lanes: B6a (EDAC and Tait), B6b, B6c and K2 on every slot
    against their plain versions, timed; 150 kdk steps under phase 11's
    gates (B6a, B6b, B6c and K2 a step at 48 lanes, no K1) and 150 kdkf
    steps (B4 and B5 a step at 48 lanes, B5's contact columns by
    particle, no K1); 20 kdk kernel steps against 20 plain steps with the
    dense box on the floor, B4 and B5 on that box's pack against their
    plain versions, timed (gated pairs and picks required), and 10 kdkf
    kernel steps against 10 plain steps; 49. the same orderings on the
    3D sinking box's own classic grid (the coupling's lane rule: M 80,
    O 27): B6a, B6b, B6c, K2, B4 and B5 on its pack against their plain
    versions, timed; 100 kdk and 100 kdkf steps under phase 11's gates
    (each a step at 80 lanes, no K1), each with 10 kernel steps against
    10 plain steps; then at 176 lanes a slot on the same box: the split
    passes, B4 and B5 against their plain versions, timed, K2 refusing
    that width, and 50 kdkf steps (B5 carries the contact) under phase
    11's gates, 2 of them against 2 plain steps;
50. every lane width of the DEM kernels: the 2D column on the spill grid
    at (cell_factor, cell_M) = (8, 32), K4 and K1 against their plain
    versions, timed, 100 steps under phase 7's gates, 20 kernel steps
    against 20 plain steps; K4 and K3 at 4, 24, 64 and 128 lanes against
    their plain versions, timed, and 50 steps on row windows of 24;
51. B4 and B5 past one warp: the kdkf step on a spill grid of 48 lanes
    set before the set-up (B4 and B5 against their plain versions on the
    dense box resting on the tank floor, gated contact pairs and picks
    required, timed, and 20 kernel steps against 20 plain steps from
    there; 150 steps of the sinking box under phase 11's gates), its
    compact store at 48 lanes (20 kernel steps of the boxes against 20
    plain steps), B4 and B5 at 64 lanes on the 3D boxes resting on the
    tank floor against their plain versions, timed, with contact picks;
52. the slab steps on classic bases, 4 slabs of the card, 20 steps each:
    the stack's GTVF and the DEM column against single-device steps on
    the same grid, the sinking box's kdk and kdkf against single-device
    steps of the ordering, with the launches a slab a step;
53. the row-sharded step (``parallel/sharded.py``) on 4 row blocks of
    the card: the 2D stack (compact route, its bodies sliding), the DEM
    column and the sinking box in kdkf, 10 sharded steps each against 10
    single-device steps on the padded scene, the launches a block a step
    and both steps/s;
54. a JSON line of per-kernel numbers (``launches`` from the kernel's
    first main path, ``launches_by_path`` from every path it ran on,
    ``rigid-3d``, ``coupling-3d``, ``benchmark-5-2d``,
    ``sinking-box-case``, ``rigid-rk2``, ``rigid-leapfrog``,
    ``coupling-rk2``, ``benchmark-2``, ``slab-rigid-2d``,
    ``slab-rigid-3d``, ``slab-dem-2d``, ``slab-coupling-kdk-2d``,
    ``slab-coupling-kdkf-2d``, ``slab-coupling-kdkf-3d``,
    ``coupling-compact-2d``, ``coupling-compact-3d``, the classic kdkf
    paths and the sharded paths among them,
    with each slab's K1, K2, K4 and fluid pass times; K2's 3D times at
    the set-up ``ni_max`` and on every interesting row beside its 2D
    time; K1 on the 3D rigid pack and on the 2D and 3D coupling packs;
    every fluid pass's 3D time; ptxas's registers, static and dynamic
    shared memory and spills of every rates/wall and forces instance the
    paths launch; an entry ``<kernel>[<SPH kernel>]`` for each
    non-quintic instance, with its launches from phase 40's paths and
    its times from phase 39; an entry for each wide instance,
    ``contact_sums/wide``, ``fluid_forces_contact/rows`` (the main
    ``fluid_forces_contact`` entry is the full route's, by particle),
    ``dem_cell/wide`` and ``dem_rowwin/wide`` (every width of phase 46,
    each beside the narrow instance at L = 8 on the same column), with
    its launches from its phase 44-46 main path), and for each classic
    instance, ``contact_sums/narrow/lanes<M>`` (K2 at each grid's width)
    and ``fluid_rates``, ``wall_bc``, ``fluid_forces`` ``/lanes48`` and
    ``/lanes80`` (the 80-lane ones with their times at 176 lanes
    beside), with its launches from its phase 47-49 main path, and for
    the lane-width instances ``dem_cell/lanes`` and ``dem_rowwin/lanes``
    (the runtime-width instance, every width of phase 50 beside), K1 at
    32 lanes, ``fluid_rates_wall/lanes48`` and
    ``fluid_forces_contact/lanes/lanes48`` (the 3D boxes' 64-lane times
    and the classic 2D box's 48-lane times beside), with their launches
    from their phase 50-51 main paths (and phase 48's), and B4's and
    B5's classic instances at 80 and 176 lanes with their launches from
    their phase 49 main paths; the shared scene builds' count and
    seconds (each scene builder runs once for each set of arguments),
    the script's seconds, then the result line.

It imports nothing from JAX or the JAX package.
"""

import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import types
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DT = 1e-4
N_STEPS = 150
CHUNK = 50
COMPARE_STEPS = 20
# the earlier paths whose plain versions take the most time hold their
# kernel steps against plain steps over fewer steps (the 3D classic
# parities of phases 47 and 49, the slab phases 28-33), so that the script
# stays near 900 s as phases are added
SHORT_CMP = 10
REPS = 20
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's ~2 GHz: REPS launches queue
# step-vs-step tolerance: the contact sums' f32 summation order differs
# between kernel and twin, and 20 steps of a stiff contact carry it on
STEP_RTOL = 1e-4
SUM_RTOL = 1e-5
# DEM: the bench's grains (radius 1e-3, rho 2600) spaced 0.5 % under a
# diameter, so every lattice neighbour overlaps by 1e-5 m at step 0; the
# column case's dt
DEM_R = 1e-3
DEM_SPACING = 2 * DEM_R * (1 - 0.005)
DEM_OVERLAP = 2 * DEM_R - DEM_SPACING
DEM_DT = 5e-6
# the 3D column's steps (phase 46): its grains weigh ~1e-5 kg, so a
# contact of kn = 1e5 lasts ~1e-5 s and DEM_DT would take half of it
DEM_DT_3D = 5e-7
DEM_STEPS = 200
DEM_ROWWIN_STEPS = 100
# the LVCForce path in torch ops (~4.6 steps/s at ~104k grains): a
# quarter of the spill path's depth keeps the script inside its time
LVCF_STEPS = 50
DEM_SUM_RTOL = 2e-5        # summation order (tests/test_pallas_dem.py)
DEM_SPRING_RTOL = 1e-4     # operation order
# the crowded column: grains at this fraction of DEM_SPACING (0.995 r),
# so the 4 axial, 4 diagonal and 4 second axial lattice neighbours all
# overlap: 12 gated partners for an L = 8 table
DEM_CROWD = 0.5
# the least time a kernel could take: H100 SXM HBM rate and f32 peak
# outside the tensor cores (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
OPS_PER_LANE = 9           # any candidate lane: 3 sub, 3 mul, 2 add, sqrt
OPS_PER_DEM_PAIR = 140     # the LVC body per gated pair (csrc/dem.cu)
# face gap of the resting stack in dx: a contact engages below 1 dx, and
# the 0.05 dx overlap of a 0.95 dx gap pushes a face with about the
# weight of one block (kr * 0.05 dx per face particle), so the stack
# starts near rest; the 0.3-0.4 dx overlaps of a 0.6-0.7 dx gap throw it
GAP = 0.95
G = 9.81
# the 3D scene's cube faces over the 3-layer floor slab: their Eq.-21
# contact distance exceeds the gap by this many dx near a gap of dx (the
# lower layers' share of the weighted sums; 0.99819 dx at a gap of
# 0.99341 dx, at dx = 0.025 and 0.0154 alike, as the sums scale with dx)
FLOOR_EPS = 0.00478
# coupling: bench.py's coupling workload at BENCH_N = 100000 (the sinking
# box with its spacing scaled from 0.02 at ~33k particles)
CPL_N = 100_000
CPL_STEPS = 150
# benchmark 5 2D (phase 21): half the case's tf, at its dt of 1e-4
B5_TF, B5_STEPS = 0.25, 2500
CPL_TANK_STEPS = 50
CPL_NOFLUID_STEPS = 50
# the rigid steppers' main paths (phases 23-24)
STEPPER_STEPS = 100
# the list engine's paths (phases 35-38): the 2D stack and the DEM
# column; the 3D cubes (K ~ 3,500 at 116.5k particles: each [N, K] f32
# field ~1.6 GB)
LIST_STEPS = 100
# (the cubes at rest drop ~5e-7 m in 50 steps: half a 10-step free fall
# is 2.5e-6 m)
LIST_3D_STEPS = 10
# the slab phases (28-31): slabs on the card (2D rigid, DEM); the 3D
# phase takes the most slabs of at least 2 cell columns each
SLAB_P = 4
# the slab comparisons' bodies slide: each gets a seeded velocity of up
# to this (m/s) in each axis of the plane (as the coupling comparisons'
# box slides: at zero tangential velocity the Coulomb friction's
# direction is the rounding noise of the tangent, and the kernels' sums
# round apart from their plain versions')
SLAB_SLIDE = 0.01
# the rigid slab comparisons hold positions and xcm as the change over
# the 20 steps (~SLAB_SLIDE x 20 DT = 2e-5 m), which float32 positions
# of up to ~1 m resolve only to ~1e-7 m: a floor of 2 ulp of the largest
SLAB_ULPS = 2
FLUID_SUM_RTOL = 2e-5      # f32 summation order of the fluid sums
# the step comparison's box: 8 times the fluid's density (steel in
# water), so the floor contact it starts in lasts the 20 steps (the
# case's box, rho 2, is thrown off the floor within them)
CPL_PARITY_RHO = 8.0
# f32 operations of the fluid pair bodies (csrc/fluid.cu), counted from
# the source (an add, mul, div, sqrt, floor, min or max is one): per
# in-range pair of the classes a body runs on, the flags decode and h_ij,
# the spline's gradient or W, then the body's own terms; per gated
# contact pair, W and the Mofidi accumulation
OPS_PAIR_HEAD = 18         # flags decode (16), h_ij (2)
# W and dW/dr / r of each SPH kernel in 2D (csrc/sph_kernels.cuh, counted
# the same way: q, the clamps, the power chains, the selects, sigma, the
# guarded 1/r), expf counted as OPS_EXPF (the CUDA math library's expf:
# range reduction by multiply-adds, the hardware 2^x, the scaling)
OPS_EXPF = 8
OPS_W_OF = {"quintic": 24, "cubic": 19, "wendland": 14, "wendland_c4": 18,
            "gaussian": 10 + OPS_EXPF, "super_gaussian": 13 + OPS_EXPF}
OPS_GRADW_OF = {"quintic": 27, "cubic": 21, "wendland": 18,
                "wendland_c4": 22, "gaussian": 17 + OPS_EXPF,
                "super_gaussian": 21 + OPS_EXPF}
OPS_CONTINUITY = 15        # dW vector, v_ij . dW, rho_i m_j / rho_j term
OPS_EDAC = 28              # the EDAC pressure rate's further terms
OPS_WALL = 16              # g . x_ij and the five Shepard sums
OPS_PGRAD = 13             # dW vector, p_i/rho_i^2 + p_j/rho_j^2, 3 sums
OPS_VISC_TEST = 9          # v_ij . x_ij and its sign (fluid sources)
OPS_VISC = 16              # the viscous term where v_ij . x_ij < 0
OPS_FSI = 14               # dW vector, the fluid -> rigid term, 3 sums
OPS_CONTACT_SUMS = 11      # the Mofidi accumulation of a gated pair
# the SPH kernel family (phases 39-40): the non-quintic kernels, each with
# its own K2 and fluid libraries; the stack's GTVF path runs SPH_STEPS
# steps with each (50 read a settling block's drop against half of a
# 50-step free fall), the sinking box's kdkf CPL_STEPS with the cubic
# (phase 11's gates: the box's f32 COM moves after ~100 steps) and
# SPH_SHORT_STEPS with the others, and its kdk SPH_SHORT_STEPS with each
# (the box's sinking not gated: those runs give each instance its
# launches); the super-Gaussian is negative beyond q = sqrt(d / 2 + 1),
# and the sinking box's fluid diverges under it (rho up to 1.47 rho0 at
# step 20, 2.16 at 30, on the plain passes), so its coupling runs take
# SPH_UNSTABLE_STEPS
SPH_NAMES = ("cubic", "wendland", "wendland_c4", "gaussian",
             "super_gaussian")
SPH_STEPS = 100
SPH_SHORT_STEPS = 50
SPH_UNSTABLE_STEPS = 10
# the Verlet skin of phase 41, as a fraction of the cutoff
SKIN = 0.3
# the compact coupling route (phases 42-43): 8 boxes of rho 8 (S = 9) in
# the sinking box's tank, 4 on its floor and 4 on top of them, sides of
# CPL_BOX_SIDE L in 2D and CPL_CUBE_SIDE in 3D (2 x 2 cubes a layer in
# the 3D tank's 1 x 0.5 floor); columns CPL_BOX_COL_GAP dx apart (no side
# contact); each face placed CPL_BOX_GAP dx over what it rests on, then
# moved so that its Eq.-21 contact distance leaves an overlap of half
# what its load in the fluid presses (``settle_boxes``): a box of rho 8
# weighs ~5e-5 of kr x dx on its face particles, so GAP's 0.05 dx throws
# it off, and one that starts under its load stays engaged; the 3D cubes
# take CPL_CUBE_KR (a cube of 0.15 on kr = 1e5 rings at ~6 rad a step of
# the fluid's dt: the explicit step diverges); the bottom row slides at
# +CPL_BOX_SLIDE m/s in x (and z in 3D), the top row at -CPL_BOX_SLIDE,
# so every contact slides
CPL_BOX_SIDE = 0.25
CPL_CUBE_SIDE = 0.15
CPL_BOX_RHO = 8.0
CPL_BOX_COL_GAP = 2.0
CPL_BOX_GAP = 0.99
CPL_CUBE_KR = 1e3
CPL_BOX_SLIDE = 0.05
CPL_BOXES_STEPS = 200
CPL_BOXES_3D_STEPS = 50
# the wide kernel instances (phases 44-46): K2 past 64 entities on the
# 2D stack of WIDE_BLOCKS blocks in rows of WIDE_COLS (S = 129: more than
# two 64-bit mask words) through WIDE_STEPS GTVF steps (4 rows: a stack's
# top block settles by the sum of its rows' compressions, ~1.4 dx for 8
# rows, more than half the free fall of any run short of ~1,000 steps,
# so phase 4's "carried" gate needs a lower stack), and at S = 300
# (WIDE_300 blocks of ~18 x 18 in rows of WIDE_300_COLS); on every slot
# of 64 cubes of 12^3 stacked 4 x 4 x 4 (S = 65); B5 past one warp's
# shared memory on the sinking box's tank with WIDE_BOX_ROWS layers of
# WIDE_BOX_COLS boxes of side WIDE_BOX_SIDE and rho CPL_BOX_RHO (S =
# 301); the DEM kernels on the 3D column at table widths WIDE_L (16 and
# 32 in shared memory, 40 in global memory), each through a DEM_CHUNK-
# step main path
WIDE_BLOCKS, WIDE_COLS = 128, 32
WIDE_STEPS = 800
WIDE_300, WIDE_300_COLS = 299, 23
WIDE_CUBES = (4, 4, 4)
WIDE_BOX_ROWS, WIDE_BOX_COLS, WIDE_BOX_SIDE = 6, 50, 0.064
# the small boxes' contact: kr 1e3 and pressed 0.02 dx from the start
# (at kr 1e5 a box of 5 x 5 particles settles at ~1e-5 dx of overlap,
# where one ulp of the Eq.-21 distance is ~1e-3 of the force: the 20-step
# comparison then reads the model's conditioning, not the kernels)
WIDE_BOX_KR, WIDE_BOX_OVERLAP = 1e3, 0.02
# B5 at S = 129 (phase 45): 8 layers of 16 boxes of side 0.2, the
# compact store's sweep scene (scripts/compact_crossover.py 2:8x16@0.2)
WIDE_BOX_129 = (8, 16, 0.2)
# (grid, L, the tables compared): the 16-slot instance at 12 and 16, the
# 32-slot one at 32, the global rows at 40 (the 3D twin takes 0.75-3.6 s
# a call, so each width compares the tables that reach its new code)
WIDE_DEM = (("spill", 8, ("filled",)),
            ("spill", 12, ("empty", "filled", "moved")),
            ("spill", 16, ("filled",)), ("spill", 32, ("filled",)),
            ("spill", 40, ("empty", "filled", "moved")),
            ("rowwin", 8, ("filled",)),
            ("rowwin", 12, ("filled", "moved")),
            ("rowwin", 16, ("filled",)), ("rowwin", 32, ("filled",)),
            ("rowwin", 40, ("filled", "moved")))
# compact against full route on the same kernels: the same elementwise
# ops on the same values; the body sums' atomic adds on the card may add
# in another order
COMPACT_RTOL = 1e-5


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def smi_line():
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    lines = res.stdout.strip().splitlines()
    return lines[0] if res.returncode == 0 and lines else \
        f"nvidia-smi failed: {res.stderr.strip()}"


def cuda_ms(fn, reps=REPS, warmup=3):
    """Mean device time of ``fn()`` in ms over ``reps`` calls.  The card
    first spins for SLEEP_CYCLES while the host queues the calls, so a
    call whose host side (checks, allocations, the launch) outlasts its
    kernels is not timed as host time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_call(fn):
    """``fn()`` and the ms of that one call between two CUDA events (for
    the plain versions, whose calls take 10^2-10^3 ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """(least ms, what bounds it) for this many bytes and f32 ops."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def slot_lanes(cnt, nbr):
    """Live (query, source) lane pairs of slots with ``cnt`` live lanes
    whose sources are the slots ``nbr`` lists (>= len(cnt) = none)."""
    ext = torch.cat([cnt, torch.zeros(1, dtype=cnt.dtype,
                                      device=cnt.device)])
    src = ext[torch.clamp(nbr, 0, cnt.shape[0])].sum(1)
    return int((cnt[:nbr.shape[0]] * src).sum())


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

# each shared sinking-box build: {key: [seconds, calls]}
SCENE_BUILDS = {}
_SCENES = {}


def _key_part(v):
    return tuple(sorted(v.items())) if isinstance(v, dict) else v


def shared_build(fn):
    """The scene builder ``fn`` (``sinking_box_scene``, which 17 calls
    of the coupling phases take) built once for each set of arguments:
    every call returns that build's scene (a value: no step writes into
    its tensors) with a fresh shallow copy of its scheme (the phases set
    the scheme's ordering, stepper, grid and capacity), so phases that
    take the same scene pay for one build.  The cached scenes stay on
    the device for the rest of the run, so the later phases' "peak
    device memory" includes them.  ``SCENE_BUILDS`` keeps each build's
    seconds and calls."""
    def build(*args, **kw):
        key = (fn.__name__, tuple(_key_part(a) for a in args),
               tuple(sorted((k, _key_part(v)) for k, v in kw.items())))
        if key not in _SCENES:
            t0 = time.perf_counter()
            _SCENES[key] = fn(*args, **kw)
            SCENE_BUILDS[key] = [time.perf_counter() - t0, 0]
        SCENE_BUILDS[key][1] += 1
        scheme, *rest = _SCENES[key]
        return (copy.copy(scheme), *rest)

    build.__doc__, build.__name__ = fn.__doc__, fn.__name__
    return build


def scene_build_line():
    """The shared scene builds: their count and seconds, the calls they
    served, the seconds the repeated calls would have taken and the
    device memory the cached scenes hold."""
    built = sum(t for t, _ in SCENE_BUILDS.values())
    calls = sum(c for _, c in SCENE_BUILDS.values())
    saved = sum(t * (c - 1) for t, c in SCENE_BUILDS.values())
    held = sum(v.numel() * v.element_size() for _, scene, _ in
               _SCENES.values() for v in scene.fields.values()
               if torch.is_tensor(v))
    slow = sorted(((t, c, k[0]) for k, (t, c) in SCENE_BUILDS.items()),
                  reverse=True)[:6]
    return (f"{len(SCENE_BUILDS)} scene builds in {built:.1f} s served "
            f"{calls} calls ({saved:.1f} s of repeated builds saved; "
            f"the cached scenes hold {held / 2**30:.2f} GiB); "
            "slowest: " + ", ".join(f"{n} {t:.1f} s x{c}"
                                    for t, c, n in slow))


def classic_config(scheme, scene, **grid):
    """A classic cell grid config (``cellpairs.config_from_positions``
    with ``grid``: ``spill=False``, ``sub=2`` or an explicit ``M``) of the
    scene's positions at the scheme's cutoff (radius scale x max h); with
    ``spill=True`` in ``grid``, the spill grid of that M (phase 51)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    host = lambda k: scene[k].detach().cpu().numpy()
    cutoff = float(get_kernel(scheme.kernel_name, scheme.dim).radius_scale
                   * host("h").max())
    cfg = tcell.config_from_positions(host("x"), host("y"), host("z"),
                                      cutoff, scheme.dim, **grid)
    check(cfg.spill == bool(grid.get("spill")), f"{grid}: not the grid "
          "asked for")
    return cfg


def contact_scene_2d(dev, n_target=100_000, coupling=False,
                     integrator="gtvf", engine="cell", kernel="quintic",
                     skin=0.0, n_bodies=8, cols=4, grid=None):
    """8 blocks of side 0.2 in two rows of 4 on the floor of a 3-layer
    tank (the bench's body size and count), a resting stack: the bottom
    row sits GAP dx above the floor's surface layer, neighbours GAP dx
    apart, the top row GAP dx above the bottom row.  A contact engages
    below 1 dx, so every block is in contact at once.  ``n_bodies``
    blocks in rows of ``cols`` make a wider stack (S = n_bodies + 1) in a
    tank widened and heightened to hold it, ~n_target particles in all.  ``coupling`` sets
    it up under a rigid-fluid coupling scheme with no fluid group (the
    reference's stack-of-cylinders setup) instead of the rigid scheme;
    ``integrator`` is the rigid scheme's stepper, ``engine`` its pair
    engine, ``kernel`` its SPH kernel and ``skin`` its Verlet skin factor
    (set before the set-up, which identifies the surfaces on them);
    ``grid`` (``classic_config``'s arguments) sets a classic cell grid as
    the scheme's config before the set-up."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import (
        get_2d_block, create_tank_2d_from_block_2d)
    from rigid_body_2d_3d_pysph_tpu_torch.models import (
        RigidBody2DScheme, RigidFluidCouplingScheme)
    from rigid_body_2d_3d_pysph_tpu_torch.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY)

    side = max(int(np.sqrt(n_target / n_bodies)), 12)
    dx = 0.2 / (side - 1)
    xb1, yb1 = get_2d_block(dx, 0.2, 0.2)
    floor_top = -dx                      # the tank's surface layer
    pitch = 0.2 + GAP * dx
    m = 2000.0 * dx * dx
    # one group per block: surface identification runs per group, and in
    # one shared group the faces that touch a neighbour would read as
    # interior and carry no contact
    bodies = []
    for b in range(n_bodies):
        col, row = b % cols, b // cols
        bodies.append(make_group(
            f"body{b}", xb1 + 0.1 + col * pitch,
            yb1 + 0.1 + floor_top + GAP * dx + row * pitch, m=m,
            h=1.3 * dx, rho=2000.0, rad_s=dx / 2, role=ROLE_RIGID,
            dem_id=np.full(len(xb1), b, np.int32)))
    rows = -(-n_bodies // cols)
    length = max(1.25, 0.35 + cols * pitch)
    height = max(1.2, 0.4 + rows * pitch)
    xt, yt = create_tank_2d_from_block_2d(
        np.array([-0.15, length - 0.15]), np.array([0.0, height]), length,
        height, dx, 3)
    tank = make_group("tank", xt, yt, m=m, h=1.3 * dx, rho=2000.0,
                      rad_s=dx / 2, role=ROLE_BOUNDARY, dem_id=n_bodies)
    scene = build_scene(bodies + [tank], dim=2,
                        total_no_bodies=n_bodies + 1, spacing0=dx,
                        device=dev, dtype=config.WORK_DTYPE)
    names = [g.name for g in bodies]
    if coupling:
        scheme = RigidFluidCouplingScheme(
            [], ["tank"], names, dim=2, rho0=2000.0, p0=0.0, c0=1.0,
            h=1.3 * dx, nu=0.0, gy=-9.81)
    else:
        scheme = RigidBody2DScheme(names, ["tank"], dim=2, gy=-9.81)
        scheme.integrator = integrator
        scheme.skin_factor = skin
    scheme.engine = engine
    scheme.kernel_name = kernel
    if grid is not None:
        scheme._cell_cfg = classic_config(scheme, scene, **grid)
    return scheme, scheme.setup(scene), dx


def contact_scene_3d(dev, n_target=100_000, integrator="gtvf",
                     engine="cell", kernel="quintic", layout=(4, 2, 1),
                     grid=None):
    """8 cubes of side 0.2 in a 4 x 2 layout on a 3-layer floor slab, at
    rest on it (the 3D bench's body size).  Each cube's bottom face sits
    where the floor carries its weight: the face's overlap is m g / (kr
    n_face), a few 1e-4 dx, and the gap is dx less that overlap and
    FLOOR_EPS (the Eq.-21 distance of a face over the slab exceeds the gap
    by that much, the lower layers' share of the sums).  Neighbours stand
    0.95 dx apart: a 3.9 dx cell then never holds 5 lattice rows along an
    axis, so no cell needs more than the grid's 4 slots of 16 (a closer 3D
    stack overflows ``max_spill`` in the reference too); the cubes are one
    group, so the faces between neighbours are interior to the surface
    identification and carry no contact.  ``integrator`` is the scheme's
    stepper, ``engine`` its pair engine, ``kernel`` its SPH kernel.
    ``layout`` (cubes along x, z and y) other than the default stacks
    ``layout`` cubes, the layers 0.95 dx apart too, on a floor widened to
    hold them, each cube a group of its own (its faces to its neighbours
    then carry contact), ~n_target particles in the cubes.  ``grid`` as
    in ``contact_scene_2d``."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import get_3d_block
    from rigid_body_2d_3d_pysph_tpu_torch.models import RigidBody3DScheme
    from rigid_body_2d_3d_pysph_tpu_torch.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY)

    gx, gz, gy = layout
    n_bodies = gx * gz * gy
    own_groups = layout != (4, 2, 1)
    side = max(int(round((n_target / n_bodies) ** (1 / 3))), 5)
    dx = 0.2 / (side - 1)
    xb1, yb1, zb1 = get_3d_block(dx, 0.2, 0.2, 0.2)
    names = ([f"body{b}" for b in range(n_bodies)] if own_groups
             else ["body"])
    scheme = RigidBody3DScheme(names, ["floor"], dim=3, gy=-G)
    scheme.integrator = integrator
    scheme.engine = engine
    scheme.kernel_name = kernel
    m = 2000.0 * dx**3
    n_face = side * side
    rest = m * len(xb1) * G / (scheme.kr * n_face)
    floor_gap = dx - rest - FLOOR_EPS * dx
    pitch = 0.2 + 0.95 * dx
    xs, ys, zs, bid = [], [], [], []
    for b in range(n_bodies):
        col, row, layer = b % gx, (b // gx) % gz, b // (gx * gz)
        xs.append(xb1 + col * pitch)
        ys.append(yb1 + 0.1 + floor_gap + layer * pitch)
        zs.append(zb1 + row * pitch)
        bid.append(np.full(len(xb1), b, np.int32))
    fx, fz = np.meshgrid(np.arange(-0.15, max(0.8, gx * pitch - 0.05), dx),
                         np.arange(-0.15, max(0.4, gz * pitch - 0.05), dx))
    xf = np.concatenate([fx.ravel()] * 3)
    zf = np.concatenate([fz.ravel()] * 3)
    yf = np.concatenate([np.full(fx.size, -k * dx) for k in range(3)])
    if own_groups:
        bodies = [make_group(names[b], xs[b], ys[b], z=zs[b], m=m,
                             h=1.3 * dx, rho=2000.0, rad_s=dx / 2,
                             role=ROLE_RIGID, dem_id=bid[b])
                  for b in range(n_bodies)]
    else:
        bodies = [make_group("body", np.concatenate(xs), np.concatenate(ys),
                             z=np.concatenate(zs), m=m, h=1.3 * dx,
                             rho=2000.0, rad_s=dx / 2, role=ROLE_RIGID,
                             body_id=np.concatenate(bid),
                             dem_id=np.concatenate(bid))]
    floor = make_group("floor", xf, yf, z=zf, m=m, h=1.3 * dx, rho=2000.0,
                       rad_s=dx / 2, role=ROLE_BOUNDARY, dem_id=n_bodies)
    scene = build_scene(bodies + [floor], dim=3,
                        total_no_bodies=n_bodies + 1, spacing0=dx,
                        device=dev, dtype=config.WORK_DTYPE)
    if grid is not None:
        scheme._cell_cfg = classic_config(scheme, scene, **grid)
    return scheme, scheme.setup(scene), dx


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def contact_rows(dfT, grid, pt, cfg, kernel, S, init, ni, label,
                 plain_reps=0):
    """K2 on the first ``ni`` interesting rows against its twin (picks
    bit for bit, sums within SUM_RTOL), timed (the twin over
    ``plain_reps`` calls; 0: on its one checking call), with its bound.
    Returns the numbers (with the rows' interesting-slot count), the
    output and the rows' slots and validity."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck

    qsel, nbr, valid, _, n_int = tck.select_queries(dfT, grid, pt, cfg, ni)
    n_int = int(n_int)
    check(n_int > 0, f"{label}: no interesting slots")
    args = (dfT, qsel, nbr, S, cfg.radius, init, kernel)
    out = tck.contact_sums(*args)
    out_ref, plain_once = timed_call(
        lambda: tck.contact_sums_reference(*args))
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    check(torch.equal(out[..., 5 * S:], out_ref[..., 5 * S:]),
          f"{label}: contact picks != twin (max "
          f"{float((out[..., 5 * S:] - out_ref[..., 5 * S:]).abs().max())})")
    for c in range(5):
        a, b = out[..., c * S:(c + 1) * S], out_ref[..., c * S:(c + 1) * S]
        tol = SUM_RTOL * b.abs() + SUM_RTOL * float(b.abs().max())
        check(bool(((a - b).abs() <= tol).all()),
              f"{label}: contact block {c} off by "
              f"{float((a - b).abs().max())}")
    rows = int(valid.sum())
    t = dict(err=float((out - out_ref).abs().max()), rows=rows,
             ni=qsel.shape[0], n_int=n_int,
             ms=cuda_ms(lambda: tck.contact_sums(*args)),
             plain_ms=cuda_ms(lambda: tck.contact_sums_reference(*args),
                              reps=plain_reps, warmup=min(3, plain_reps))
             if plain_reps else plain_once)
    # least time: K2 needs the F fields of the particles in the slots that
    # the rows' stencils reach, the rows' slots and stencil rows, and
    # writes 12S values for every lane of every row (the Eq.-24 tail
    # reads them all: contact_force_core runs on every lane, and cl_state
    # keeps them), and tests every live candidate lane of a live query
    # lane; the count before the redesign wrote 12S values per live
    # query lane only (old_bound)
    NC = cfg.NC_max
    cnt_ext = torch.cat([pt.cnt, torch.zeros(1, dtype=pt.cnt.dtype,
                                             device=pt.cnt.device)])
    t["lanes"] = int((cnt_ext[torch.clamp(qsel, max=NC)]
                      * cnt_ext[torch.clamp(nbr, max=NC)].sum(1)).sum())
    reached = torch.zeros(NC + 1, dtype=torch.bool, device=dfT.device)
    reached[nbr[valid].reshape(-1)] = True
    n_src = int(pt.cnt[reached[:NC]].sum())
    n_query = int(pt.cnt[qsel[valid]].sum())
    NI = qsel.shape[0]
    t["bound"], t["bound_by"] = bound(
        4 * (n_src * dfT.shape[1] + NI * cfg.M * 12 * S)
        + 8 * NI * (1 + nbr.shape[1]), t["lanes"] * OPS_PER_LANE)
    t["old_bound"] = bound(4 * (n_src * dfT.shape[1] + n_query * 12 * S),
                           t["lanes"] * OPS_PER_LANE)[0]
    print(f"[kernels] {label}: K2 on {rows} rows (ni {t['ni']}, interesting "
          f"{n_int}, O {nbr.shape[1]}): {t['ms']:.4f} ms (plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound']:.4f} ms by "
          f"{t['bound_by']}, before the redesign's count "
          f"{t['old_bound']:.4f} ms; {t['lanes']} live candidate lanes, {n_src} "
          f"source and {n_query} query particles); picks exact, max_abs_err "
          f"{t['err']:.3e}", flush=True)
    return t, out, qsel, valid


def phase_kernels(scheme, scene, label, timings):
    """Kernels against twins at this scene's main-path shapes (with
    seeded random velocities so the picked u/v/w are not all zero); in
    3D, K2 also on every interesting row, as the 3D path runs it once
    its overflow rebuilds have raised ``ni_max``."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    from rigid_body_2d_3d_pysph_tpu_torch.ops import pack_expand as tpe
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    cfg = scheme.cell_config(scene, kernel)
    scene = seeded_velocities(scene, scheme.dim, 7)
    S = scene.meta.total_no_bodies
    two_d = scheme.dim == 2
    init = 4.0 * scene.meta.spacing0

    grid, pt, dfT = tck.pack_scene(scene, cfg, want_dense_pos=True)
    sent = torch.tensor(tck.sent_fields(two_d), device=scene.device)
    k1_args = (pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)
    ref = tpe.expand_slots_reference(*k1_args)
    torch.cuda.synchronize()
    k1_err = float((dfT - ref).abs().max())
    check(torch.equal(dfT, ref), f"{label}: pack expansion != twin")
    print(f"[kernels] {label}: NC={cfg.NC_max} M={cfg.M} O={cfg.O} "
          f"F={dfT.shape[1]} S={S} | pack max_abs_err={k1_err}", flush=True)

    k2, culled, qsel, valid = contact_rows(dfT, grid, pt, cfg, kernel, S,
                                           init, scheme.ni_max(cfg), label)
    # the every-slot launch (the cell pipeline's) at the culled rows: the
    # same output bit for bit
    every = tck.contact_sums(dfT, torch.arange(cfg.NC_max, device=dfT.device),
                             grid.nbr_slots, S, cfg.radius, init, kernel)
    torch.cuda.synchronize()
    check(torch.equal(culled[valid], every[qsel[valid]]),
          f"{label}: K2 on every slot != K2 on the culled rows")
    del every, culled
    t = dict(
        pack_ms=cuda_ms(lambda: tpe.expand_slots(*k1_args)),
        pack_plain_ms=cuda_ms(lambda: tpe.expand_slots_reference(*k1_args)),
        contact_ms=k2["ms"], contact_plain_ms=k2["plain_ms"],
        contact_bound=k2["bound"], contact_bound_by=k2["bound_by"],
        contact_old_bound=k2["old_bound"], pack_err=k1_err,
        contact_err=k2["err"])
    t["pack_bound"], t["pack_bound_by"] = bound(
        nbytes(pt.sorted_fields, pt.base, pt.cnt, sent, dfT), 0)
    if not two_d:
        # on every slot: the leapfrog path's K2 (phase 24)
        k2slots, _ = contact_all_slots(dfT, grid, cfg, kernel, S, init,
                                       f"{label} every slot", timed=True)
        t.update(contact_all_slots_ms=k2slots["ms"],
                 contact_all_slots_plain_ms=k2slots["plain_ms"],
                 contact_all_slots_bound=k2slots["bound_ms"],
                 contact_all_slots_bound_by=k2slots["bound_by"])
        k2all, _, _, _ = contact_rows(
            dfT, grid, pt, cfg, kernel, S, init,
            max(scheme.ni_max(cfg), k2["n_int"]), f"{label} all rows")
        t.update(contact_all_rows_ms=k2all["ms"],
                 contact_all_rows_plain_ms=k2all["plain_ms"],
                 contact_all_rows_bound=k2all["bound"],
                 contact_all_rows_bound_by=k2all["bound_by"],
                 contact_all_rows=k2all["rows"],
                 contact_err=max(k2["err"], k2all["err"], k2slots["err"]))
    print(f"[kernels] {label}: pack {t['pack_ms']:.4f} ms "
          f"(plain {t['pack_plain_ms']:.4f} ms, bound "
          f"{t['pack_bound']:.4f} ms by {t['pack_bound_by']})", flush=True)
    timings[label] = t


def config_line(scheme, scene, kernel):
    """The capacities the scheme's step runs on: the list's K and M on
    the list engine, the grid's ni_max, NC and O on the cell engine."""
    if scheme.engine == "nklist":
        lc = scheme.list_config(scene, kernel.radius_scale)
        n_off = len(lc.stencil)
        return (f"list K {n_off * lc.max_per_cell} ({n_off} stencil cells "
                f"x M {lc.max_per_cell}), cutoff {lc.cutoff:.6g}, "
                f"{lc.n_buckets} buckets")
    cfg = scheme.cell_config(scene, kernel)
    return f"ni_max {scheme.ni_max(cfg)}, NC {cfg.NC_max}, O {cfg.O}"


def list_contact_pairs(scheme, scene):
    """The gated contact pairs of ``scene`` on the scheme's list (the
    Eq.-21/22 gate: rigid query, surface source of another entity)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact as cops
    from rigid_body_2d_3d_pysph_tpu_torch.ops import neighbors as nbmod
    from rigid_body_2d_3d_pysph_tpu_torch.ops.pairs import pair_data

    nbrs = nbmod.build_neighbors(scene.x, scene.y, scene.z, scene.active,
                                 scheme._nbr_cfg)
    return int(cops._contact_gate(scene, pair_data(scene, nbrs)).sum())


def phase_main_path(scheme, scene, dx, smi, label="main", n_steps=N_STEPS,
                    evals=1, multi=False):
    """The rigid step through its entry points for ``n_steps`` steps in
    chunks with the overflow-rebuild rule, under phase 4's gates.  GTVF
    on the cell engine runs the compact path (interesting slots counted);
    RK2 and leapfrog the full [N, S] schema (no compact store) with
    ``evals`` force evaluations a step, each launching one K1 and one K2
    and nothing else.  With a Verlet skin every stepper keeps the full
    schema and launches one K2 (every slot) and no K1 a force evaluation;
    the grid's rebuilds are counted.  K2 runs the library of the
    scheme's SPH kernel.  On the list engine every stepper keeps the full
    schema and launches no kernel; K, the gated contact pairs and the
    peak device memory are printed.  ``multi`` runs each chunk through
    ``make_multi_step`` (the interesting slots then read once a chunk).
    Returns (end scene, launches with the per-instance counts, stats)."""
    from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    listed = scheme.engine == "nklist"
    skin = scheme.uses_skin
    # the classic grid: K2 on every slot of a gathered pack, no K1
    classic = not listed and not scheme.cell_config(scene, kernel).spill
    compact = not listed and scheme.uses_compact(scene, kernel)
    check(compact == ("cl_pid" in scene), f"{label}: the compact slot "
          f"store is {'missing' if compact else 'there'}")
    step = scheme.make_step(scene)
    xcm0 = scene.xcm.clone()
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    steps_run = done = rebuilds = grid_builds = 0
    chunk_s, chunk_n, n_int, lanes = [], [], [], []
    while done < n_steps:
        chunk_start = scene
        n = min(CHUNK, n_steps - done)
        cfg = None if listed else scheme.cell_config(scene, kernel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, builds = [], 0
        if multi:
            scene = trb.make_multi_step(step, n)(scene, DT)
            if compact:
                stats.append(scene.n_interesting)
        for _ in range(0 if multi else n):
            prev = scene.g_xb if skin else None
            scene = step(scene, DT)
            if compact:
                stats.append(scene.n_interesting)
            if skin:
                # a skin rebuild attaches the current positions as g_xb
                builds += int(scene.g_xb is not prev)
        torch.cuda.synchronize()
        el = time.perf_counter() - t0
        steps_run += n
        if bool(scene.nbr_overflow):
            # the reference Solver's rule: re-size from the chunk's start
            # state (1.5x slack from the second try on) and re-run it; a
            # rebuild re-sizes a spill grid, on whose route the run goes
            # on, so a classic phase that overflows measures another route
            check(not classic, f"{label}: the classic grid overflowed")
            rebuilds += 1
            check(rebuilds <= 8, "overflow persists after 8 rebuilds")
            scheme.refresh_configs(chunk_start, grow=rebuilds > 1)
            chunk_start = scheme.adapt_scene(chunk_start)
            step = scheme.make_step(chunk_start)
            scene = chunk_start
            print(f"[{label}] step {done}: capacity overflow, rebuilt "
                  f"(x{rebuilds}, boost {scheme.capacity_boost:.2f}, "
                  f"{config_line(scheme, scene, kernel)})", flush=True)
            continue
        rebuilds = 0
        done += n
        grid_builds += builds
        chunk_s.append(el)
        chunk_n.append(n)
        ov = float(scheme.export_scene(scene).overlap.max())
        msg = f"max overlap {ov:.3e}"
        if skin:
            msg += f", skin grid rebuilds {builds}"
        if compact:
            ni = torch.stack(stats).cpu().numpy()
            n_int.append(ni)
            lanes.append(ni * cfg.M * cfg.O * cfg.M)
            msg = f"interesting slots {ni.min()}-{ni.max()}, " + msg
        print(f"[{label}] steps {done - n}-{done}: {el:.3f} s, {msg}",
              flush=True)

    launches = dict(_build.LAUNCHES)
    for k, v in launches.items():
        want = (evals * steps_run if not listed and (
            k == "contact" or (k == "pack_expand" and not skin
                               and not classic)) else 0)
        check(v == want, f"{label}: {k} launched {v} times in {steps_run} "
              f"steps, expected {want}")
    launches = check_instances(label, scheme.kernel_name, launches)
    check(compact == ("cl_pid" in scene), f"{label}: the step changed the "
          "slot schema")
    full = scheme.export_scene(scene)
    max_overlap = float(full.overlap.max())
    check(max_overlap > 0, "no overlap: the contact did no work")
    for k, v in full.fields.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"non-finite field {k}")
    check(not bool(scene.nbr_overflow), "overflow at the end")
    dim = scheme.dim
    drift = float((scene.xcm[:, :dim] - xcm0[:, :dim]).norm(dim=1).max())
    check(drift < 2 * dx, f"COM drift {drift:.3e} >= 2 dx = {2 * dx:.3e}")
    # static stack: with no contact force every block would have dropped
    # the free-fall distance g t^2 / 2 (GTVF is exact for constant force);
    # resting, none may have dropped half of it
    fall = 0.5 * G * (done * DT) ** 2
    drop = float((xcm0[:, 1] - scene.xcm[:, 1]).max())
    check(drop < 0.5 * fall, f"a block dropped {drop:.3e}, >= half the "
          f"free-fall distance {fall:.3e}: the stack is not carried")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if compact:
        cfg = scheme.cell_config(scene, kernel)
        n_int, lanes = np.concatenate(n_int), np.concatenate(lanes)
        check(bool((n_int > 0).all()), "a step had no interesting slot")
        work = (f"interesting slots/step min {n_int.min()} mean "
                f"{n_int.mean():.1f} max {n_int.max()} | candidate "
                f"lanes/step mean {lanes.mean():.4g}")
    elif listed:
        pairs = list_contact_pairs(scheme, scene)
        check(pairs > 0, f"{label}: no gated contact pair at the end")
        work = (f"{evals} list evaluation(s) a step | gated contact pairs "
                f"at the end {pairs}")
    else:
        cfg = scheme.cell_config(scene, kernel)
        work = (f"{evals} evaluation(s) a step, K2 on all {cfg.NC_max} "
                f"slots (M {cfg.M}, O {cfg.O}"
                + (", classic grid, no K1)" if classic else ")"))
        if skin:
            work += (f", skin {cfg.skin:.4g} (bins {cfg.cell:.4g}), grid "
                     f"rebuilds {grid_builds} in {done} steps")
    steady = chunk_s[1:] or chunk_s
    sps = (sum(chunk_n[1:]) or sum(chunk_n)) / sum(steady)
    print(f"[{label}] n={scene.n} dx={dx:.6g} {scheme.integrator} on "
          f"{scheme.engine} ({scheme.kernel_name}) steps={done} (run "
          f"{steps_run}) launches pack="
          f"{launches['pack_expand']} contact={launches['contact']} | "
          f"{work} | max overlap {max_overlap:.4e} ({max_overlap / dx:.3f} "
          f"dx) | max COM drift {drift:.4e} ({drift / dx:.3f} dx) | max "
          f"drop {drop:.4e} (free fall {fall:.4e})", flush=True)
    print(f"[{label}] final config: {config_line(scheme, scene, kernel)}, "
          f"capacity boost {scheme.capacity_boost:.4g}; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    print(f"[{label}] {sps:.2f} steps/s steady (chunks 2+), "
          f"{done / sum(chunk_s):.2f} steps/s all chunks, on {smi}",
          flush=True)
    return scene, launches, dict(steps_per_s=sps, n=scene.n, peak_gib=peak,
                                 grid_builds=grid_builds, steps=done)


def check_instances(label, sph, launches):
    """Every launch of a kernel that evaluates an SPH kernel (K2 and the
    fluid passes) ran the library of ``sph``, the scheme's; returns
    ``launches`` with the per-library counts ("contact[cubic]", ...) and
    the per-size-instance ones ("contact/wide", ...) beside the
    per-kernel ones."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    for key, v in _build.LAUNCHES_SPH.items():
        kname, inst = key[:-1].split("[")
        if _build.KERNELS[kname][0] in _build.SPH_SOURCES:
            check(inst == sph, f"{label}: {v} launches of {key}; the "
                  f"scheme's SPH kernel is {sph}")
    return {**launches, **_build.LAUNCHES_SPH, **_build.LAUNCHES_INSTANCE}


def phase_step_parity(scheme, scene, label="parity", n=COMPARE_STEPS):
    """``n`` kernel steps of the scheme's stepper against ``n`` steps of
    its twin (the kernels' plain versions) from one state."""
    from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb

    fast = trb.make_multi_step(scheme.make_step(scene), n)
    plain = trb.make_multi_step(scheme.make_step(scene, plain=True), n)
    a, b = fast(scene, DT), plain(scene, DT)
    torch.cuda.synchronize()
    check(not bool(a.nbr_overflow) and not bool(b.nbr_overflow),
          "overflow during the step comparison")
    worst = []
    for k in ("xcm", "vcm", "omega", "fx", "fy") + (
            () if scheme.two_d else ("fz",)):
        x, y = a[k], b[k]
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        ok = bool(((x - y).abs() <= STEP_RTOL * y.abs()
                   + STEP_RTOL * scale).all())
        worst.append(f"{k} {err:.3e} (scale {scale:.3e})")
        check(ok, f"kernel step vs twin step: {k} off by {err:.3e} "
                  f"(scale {scale:.3e}, rtol {STEP_RTOL})")
    print(f"[{label}] {scheme.dim}D {scheme.integrator}: {n} kernel steps "
          f"vs {n} twin steps, max abs diff: " + ", ".join(worst),
          flush=True)


def list_twin(scheme):
    """A copy of ``scheme`` on the list engine (its list sized at its
    first step)."""
    twin = copy.copy(scheme)
    twin.engine = "nklist"
    twin._nbr_cfg = None
    return twin


def phase_engine_parity_rigid(scheme, scene, label="engine-parity"):
    """20 steps of the scheme's stepper on the list engine against 20
    kernel steps on the cell engine from one state (the list step takes
    the state's full [N, S] view)."""
    from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb

    lscheme = list_twin(scheme)
    lscene = trb.strip_compact_fields(trb.expand_slot_scene(scene))
    a = trb.make_multi_step(scheme.make_step(scene), COMPARE_STEPS)(
        scene, DT)
    b = trb.make_multi_step(lscheme.make_step(lscene), COMPARE_STEPS)(
        lscene, DT)
    torch.cuda.synchronize()
    check(not bool(a.nbr_overflow) and not bool(b.nbr_overflow),
          f"{label}: overflow during the engine comparison")
    check(float(b.overlap.max()) > 0, f"{label}: the list run ended out "
          "of contact")
    worst = []
    for k in ("xcm", "vcm", "omega", "fx", "fy") + (
            () if scheme.two_d else ("fz",)):
        x, y = a[k], b[k]
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        worst.append(f"{k} {err:.3e} (scale {scale:.3e})")
        check(bool(((x - y).abs() <= STEP_RTOL * y.abs()
                    + STEP_RTOL * scale).all()),
              f"{label}: cell kernel step vs list step: {k} off by "
              f"{err:.3e} (scale {scale:.3e}, rtol {STEP_RTOL})")
    print(f"[{label}] {scheme.dim}D {scheme.integrator}: {COMPARE_STEPS} "
          f"list steps vs {COMPARE_STEPS} cell kernel steps, max abs "
          "diff: " + ", ".join(worst), flush=True)


# ---------------------------------------------------------------------------
# DEM
# ---------------------------------------------------------------------------

def dem_scene(dev, dim, grid="spill", n_target=100_000,
              contact_model="LVCDisplacement", engine="cell", L=8):
    """The bench's granular column over a floor (``bench.py``
    ``build_dem_scene`` / ``build_dem_scene_3d`` geometry at ~n_target
    grains) with grains spaced DEM_SPACING: every lattice neighbour and
    the floor under the lowest row overlap by 0.01 r at step 0; contact
    tables of L slots (``max_tng_contacts_limit``)."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import get_2d_block
    from rigid_body_2d_3d_pysph_tpu_torch.models import DEMScheme
    from rigid_body_2d_3d_pysph_tpu_torch.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY)

    r, s, rho = DEM_R, DEM_SPACING, 2600.0
    if dim == 2:
        k = np.sqrt(n_target / 1130.0) * s / 2.1e-3
        w, h = 0.05 * k, 0.1 * k
        xg, yg = get_2d_block(s, w, h)
        zg = np.zeros_like(xg)
        m = rho * np.pi * r**2
        xf = np.arange(-3.5 * h, 3.5 * h, 2 * r)
        zf = np.zeros_like(xf)
    else:
        k = (n_target / ((0.05 * 0.1 * 0.05) / s**3)) ** (1.0 / 3.0)
        w, h, d = 0.05 * k, 0.1 * k, 0.05 * k
        xg, yg, zg = (a.ravel() for a in np.meshgrid(
            np.arange(0.0, w, s), np.arange(0.0, h, s), np.arange(0.0, d, s)))
        m = rho * (4.0 / 3.0) * np.pi * r**3
        xf, zf = (a.ravel() for a in np.meshgrid(
            np.arange(-1.5 * w, 2.5 * w, 2 * r),
            np.arange(-1.5 * d, 2.5 * d, 2 * r)))
    yg = yg - yg.min() + (s - r)        # floor centres at -r
    grains = make_group("sand", xg, yg, z=zg, m=m, h=2 * r, rho=rho,
                        rad_s=r, role=ROLE_RIGID,
                        body_id=np.arange(len(xg), dtype=np.int32), dem_id=0)
    floor = make_group("floor", xf, np.full(len(xf), -r), z=zf, m=m,
                       h=2 * r, rho=rho, rad_s=r, role=ROLE_BOUNDARY,
                       dem_id=1)
    scene = build_scene([grains, floor], dim=dim, total_no_bodies=2,
                        spacing0=s, device=dev, dtype=config.WORK_DTYPE)
    scheme = DEMScheme(["sand"], ["floor"], kn=1e5, en=0.5, mu=0.5,
                       dim=dim, gy=-9.81, max_tng_contacts_limit=L,
                       dem_grid=grid, contact_model=contact_model)
    scheme.engine = engine
    return scheme, scheme.setup(scene)


def dem_kernel_call(scheme, scene, cfg, tables):
    """The DEM kernel wrapper, its twin and their arguments for ``scene``
    with the contact ``tables`` (idx, dem, sx, sy, sz in particle order),
    built as the main path builds them; also the grid and the candidate
    lanes."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_cell as tdc
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
    from rigid_body_2d_3d_pysph_tpu_torch.ops import pack_expand as tpe
    from rigid_body_2d_3d_pysph_tpu_torch.ops.cellpairs import (
        build_cell_grid_packed)
    from rigid_body_2d_3d_pysph_tpu_torch.ops.rowwin import (
        build_row_window_grid)

    mat = tdk.material_table(scene)
    sent = torch.tensor(tdc.SENT, device=scene.device)
    spill = scheme.dem_grid == "spill"
    build = build_cell_grid_packed if spill else build_row_window_grid
    grid, pt = build(scene.x, scene.y, scene.z, scene.active, cfg,
                     tdk.dem_payload(scene))
    pack = tpe.expand_slots(pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)
    if spill:
        args = (pack, grid.nbr_slots, *tables, mat, DEM_DT, cfg)
        return (tdk.dem_cell_sums, tdk.dem_cell_sums_reference, args, grid,
                slot_lanes(pt.cnt, grid.nbr_slots))
    args = (pack, grid.nbr_runs, grid.run_cnt, *tables, mat, DEM_DT, cfg)
    lanes = slot_lanes(pt.cnt, tdk.rowwin_sources(grid.nbr_runs,
                                                  grid.run_cnt, cfg))
    return (tdk.dem_rowwin_sums, tdk.dem_rowwin_sums_reference, args, grid,
            lanes)


def dem_compare(got, ref, label):
    """Kernel output against twin output (sums [N, 8], idx, dem, sx, sy,
    sz [N, L]): table idx, dem, slot positions and counts bit for bit,
    sums and springs within tolerance.  Returns (sums max abs error,
    springs max abs error)."""
    for a in got:
        check(bool(torch.isfinite(a.float()).all()),
              f"{label}: non-finite kernel output")
    for a, b in ((got[0][:, 6:], ref[0][:, 6:]), (got[1], ref[1]),
                 (got[2], ref[2])):
        check(torch.equal(a, b), f"{label}: tables or counts != twin "
              f"({int((a != b).sum())} entries differ)")
    a, b = got[0][:, :6], ref[0][:, :6]
    err = float((a - b).abs().max())
    tol = DEM_SUM_RTOL * b.abs() + DEM_SUM_RTOL * float(b.abs().max())
    check(bool(((a - b).abs() <= tol).all()),
          f"{label}: force/torque sums off by {err:.3e}")
    spring_err = 0.0
    for a, b in zip(got[3:], ref[3:]):
        d = (a - b).abs()
        spring_err = max(spring_err, float(d.max()))
        check(bool((d <= DEM_SPRING_RTOL * b.abs()).all()),
              f"{label}: springs off by {float(d.max()):.3e}")
    return err, spring_err


def phase_dem_kernels(scheme, scene, label, timings, crowded=False,
                      cases_run=("empty", "filled", "moved"), plain_reps=3):
    """A DEM kernel against its twin at the main path's shapes, with
    seeded random velocities and spins, on three contact tables: the
    setup's empty one (every contact is allocated), one filled by a twin
    pass at the same positions (the timed case: the main path's steady
    state), and one advanced by a twin pass at positions jittered by up
    to an overlap, then met at positions jittered again (contacts open
    and close: slots are freed and reallocated).  ``crowded`` adds the
    column at DEM_CROWD of its spacing (its own grid), met the same way
    as the moved table: full tables, new contacts beyond the free slots
    dropped.  ``cases_run`` picks among the three tables (the filled one,
    the timed case, always runs); the twin is timed over
    ``plain_reps`` calls."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(11)
    rnd = lambda a: (torch.rand(scene.n, generator=gen, device=dev) - 0.5) * a
    vel = dict(u=rnd(0.1), v=rnd(0.1), wz=rnd(100.0))
    if scheme.dim == 3:
        vel.update(w=rnd(0.1), wx=rnd(100.0), wy=rnd(100.0))
    scene = scene.replace(**vel)
    axes = ("x", "y", "z")[:scheme.dim]
    jitter = lambda sc: sc.replace(
        **{k: sc[k] + rnd(2 * DEM_OVERLAP) for k in axes})
    spill = scheme.dem_grid == "spill"
    config = lambda sch, sc: (sch.cell_config(sc) if spill
                              else sch.rowwin_config(sc))
    cfg = config(scheme, scene)
    run = (tdk.lvc_displacement_cell_kernel if spill
           else tdk.lvc_displacement_rowwin_kernel)

    def twin_pass(sc, tables, cfg=cfg):
        p = run(sc, cfg, DEM_DT, *tables, plain=True)
        check(not bool(p.overflow), f"{label}: grid overflow")
        return (p.tng_idx, p.tng_dem, p.tng_x, p.tng_y, p.tng_z)

    empty = (scene.tng_idx, scene.tng_idx_dem_id, scene.tng_x, scene.tng_y,
             scene.tng_z)
    filled = twin_pass(scene, empty)
    cases = [("empty", scene, empty, cfg), ("filled", scene, filled, cfg)]
    if "moved" in cases_run:
        cases.append(("moved", jitter(scene),
                      twin_pass(jitter(scene), filled), cfg))
    cases = [c for c in cases if c[0] in cases_run or c[0] == "filled"]
    if crowded:
        # the grains squeezed towards the column's lowest corner (the
        # floor stays), on a grid sized for them with bins of the contact
        # radius (the default spill bins would need more than max_spill
        # slots a cell)
        sand = scene.meta.group("sand")
        mob = torch.zeros(scene.n, dtype=torch.bool, device=dev)
        mob[sand.start:sand.stop] = True
        lo = {k: scene[k][sand.start:sand.stop].min() for k in axes}
        crowd = scene.replace(**{k: torch.where(
            mob, lo[k] + DEM_CROWD * (scene[k] - lo[k]), scene[k])
            for k in axes})
        cscheme = copy.copy(scheme)
        cscheme.cell_factor = 1.0
        cscheme.refresh_configs(crowd)
        ccfg = config(cscheme, crowd)
        cases.append(("crowded", jitter(crowd),
                      twin_pass(jitter(crowd), empty, ccfg), ccfg))
    L = empty[0].shape[1]
    errs, lines = [], []
    for case, sc, tables, ccfg in cases:
        kern, plain, args, grid, lanes = dem_kernel_call(scheme, sc, ccfg,
                                                         tables)
        check(not bool(grid.overflow), f"{label} {case}: grid overflow")
        got = kern(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        err, spring_err = dem_compare(got, ref, f"{label} {case}")
        errs += [err, spring_err]
        gated_i, live_i = ref[0][:, 7], ref[0][:, 6]
        gated, live = int(gated_i.sum()), int(live_i.sum())
        check(gated > 0 and live > 0, f"{label} {case}: no contact")
        # table changes in particle order: a slot whose (idx, dem) the
        # pass changed was freed if it held a contact, allocated if it
        # holds one now
        changed = (ref[1] != tables[0]) | (ref[2] != tables[1])
        n_alloc = int((changed & (ref[1] >= 0)).sum())
        n_free = int((changed & (tables[0] >= 0)).sum())
        if case == "empty":
            check(n_alloc == live, f"{label} empty: {n_alloc} allocations "
                  f"for {live} live entries")
        if case in ("moved", "crowded"):
            check(n_alloc > 0 and n_free > 0, f"{label} {case}: {n_alloc} "
                  f"allocations, {n_free} frees")
        extra = ""
        if case == "crowded":
            n_over = int((gated_i > L).sum())
            n_full = int((live_i == L).sum())
            check(n_over > 0 and n_full > 0, f"{label} crowded: {n_over} "
                  f"grains with more than {L} gated partners, {n_full} "
                  "full tables")
            extra = (f" ({n_over} grains over {L} gated, {n_full} full "
                     f"tables, max {int(gated_i.max())} gated, "
                     f"{lanes} candidate lanes)")
        lines.append(f"{case}: {live} live, {n_alloc} allocated, {n_free} "
                     f"freed, {gated} gated{extra}, sums {err:.3e}, springs "
                     f"{spring_err:.3e}")
        if case == "filled":
            timed = (kern, plain, args, lanes, gated)
    kern, plain, args, lanes, gated = timed
    if spill:
        shape = f"NC={cfg.NC_max} M={cfg.M} O={cfg.O}"
    else:
        shape = f"NCW={cfg.NC_max} M={cfg.M} R={cfg.R} max_run={cfg.max_run}"
    # least time: each particle's 13 source fields and its table row
    # (idx, dem, sx, sy, sz: 5L words) read once, its 8 sums and its
    # table row written once (the pack's sentinel lanes and the stencil
    # are layout, not work); 9 f32 ops per candidate lane and the LVC
    # body per gated pair
    n_bytes = 4 * scene.n * (tdk.NF + 8 + 2 * 5 * L)
    n_ops = lanes * OPS_PER_LANE + gated * OPS_PER_DEM_PAIR
    bms, bby = bound(n_bytes, n_ops)
    t = dict(ms=cuda_ms(lambda: kern(*args)),
             plain_ms=cuda_ms(lambda: plain(*args), reps=plain_reps,
                              warmup=1 if plain_reps > 1 else 0),
             err=max(errs), bound_ms=bms, bound_by=bby, L=L)
    print(f"[dem-kernels] {label}: n={scene.n} {shape} L={L} | tables, "
          f"slots and counts exact on every table; max abs errors | "
          + " | ".join(lines), flush=True)
    print(f"[dem-kernels] {label}: filled table, candidate lanes {lanes} | "
          f"kernel {t['ms']:.4f} ms, twin {t['plain_ms']:.4f} ms, bound "
          f"{bms:.4f} ms by {bby} ({n_bytes} bytes, {n_ops} ops)",
          flush=True)
    timings[label] = t


def table_overlap_max(scene):
    """Largest overlap among the live contact-table pairs."""
    live = scene.tng_idx >= 0
    j = torch.clamp(scene.tng_idx, min=0).long()
    d = [scene[k][:, None] - scene[k][j] for k in ("x", "y", "z")]
    rij = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    ov = scene.rad_s[:, None] + scene.rad_s[j] - rij
    return float(torch.where(live, ov, torch.zeros_like(ov)).max())


def phase_dem_main(scheme, scene, n_steps, label, smi, dt=DEM_DT):
    """The DEM step through its entry points, in chunks with the
    overflow-rebuild rule, at time step ``dt``; returns (end scene,
    launches, steps/s)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    # LVCForce launches no kernel (the reference runs it in XLA only),
    # nor does the list engine
    listed = scheme.engine == "nklist"
    no_kernel = scheme.contact_model == "LVCForce" or listed
    spill = scheme.dem_grid == "spill"
    kname = "dem_cell" if spill else "dem_rowwin"
    step = scheme.make_step(scene)
    sand = scene.meta.group("sand")
    floor = scene.meta.group("floor")
    floor_top = float((scene.y + scene.rad_s)[floor.start:floor.stop].max())
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    steps_run = done = rebuilds = 0
    chunk_s, chunk_n, lives, gateds = [], [], [], []
    while done < n_steps:
        chunk_start = scene
        n = min(CHUNK, n_steps - done)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        live, gated = [], []
        for _ in range(n):
            scene = step(scene, dt)
            live.append(scene.total_tng_contacts.sum())
            gated.append(scene.n_gated)
        torch.cuda.synchronize()
        el = time.perf_counter() - t0
        steps_run += n
        if bool(scene.nbr_overflow):
            rebuilds += 1
            check(rebuilds <= 8, f"{label}: overflow persists after 8 "
                  "rebuilds")
            scheme.refresh_configs(chunk_start, grow=rebuilds > 1)
            step = scheme.make_step(chunk_start)
            scene = chunk_start
            print(f"[{label}] step {done}: capacity overflow, rebuilt "
                  f"(x{rebuilds}, boost {scheme.capacity_boost:.2f})",
                  flush=True)
            continue
        rebuilds = 0
        done += n
        lv = torch.stack(live).cpu().numpy()
        gt = torch.stack(gated).cpu().numpy()
        lives.append(lv)
        gateds.append(gt)
        chunk_s.append(el)
        chunk_n.append(n)
        print(f"[{label}] steps {done - n}-{done}: {el:.3f} s, live "
              f"table entries {lv.min()}-{lv.max()}, gated pairs/step "
              f"{gt.min()}-{gt.max()}", flush=True)
    launches = dict(_build.LAUNCHES)
    lv, gt = np.concatenate(lives), np.concatenate(gateds)
    for k, v in launches.items():
        want = steps_run if k in (kname, "pack_expand") and not no_kernel \
            else 0
        check(v == want, f"{label}: {k} launched {v} times in {steps_run} "
              f"steps, expected {want}")
    launches.update(_build.LAUNCHES_INSTANCE)
    check(bool((lv > 0).all()), f"{label}: a step had no live contact")
    for k, v in scene.fields.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{label}: non-finite {k}")
    check(not bool(scene.nbr_overflow), f"{label}: overflow at the end")
    bottom = float((scene.y - scene.rad_s)[sand.start:sand.stop].min())
    check(bottom > floor_top - DEM_R, f"{label}: a grain's bottom "
          f"{bottom:.4e} is more than r below the floor's top {floor_top:.4e}")
    ov = table_overlap_max(scene)
    check(0 < ov < 0.1 * DEM_R, f"{label}: max overlap {ov:.3e} not in "
          f"(0, 0.1 r)")
    steady = chunk_s[1:] or chunk_s
    sps = (sum(chunk_n[1:]) or sum(chunk_n)) / sum(steady)
    if listed:
        lc = scheme._nbr_cfg
        print(f"[{label}] list K {len(lc.stencil) * lc.max_per_cell} (M "
              f"{lc.max_per_cell}), cutoff {lc.cutoff:.6g}", flush=True)
    print(f"[{label}] n={scene.n} ({sand.stop - sand.start} grains) "
          f"{scheme.contact_model} on {scheme.engine} steps={done} (run "
          f"{steps_run}) launches "
          f"{kname}={launches[kname]} pack_expand="
          f"{launches['pack_expand']} | live "
          f"entries/step min {lv.min()} mean {lv.mean():.1f} | gated "
          f"pairs/step mean {gt.mean():.1f} | max overlap {ov:.4e} "
          f"({ov / DEM_R:.4f} r) | lowest grain bottom {bottom:.4e} "
          f"(floor top {floor_top:.4e})", flush=True)
    print(f"[{label}] {sps:.2f} steps/s steady (chunks 2+), "
          f"{done / sum(chunk_s):.2f} steps/s all chunks, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB, on {smi}", flush=True)
    return scene, launches, sps


def _sorted_tables(scene):
    """Per row, the table's (idx, dem) keys and springs sorted by key."""
    key = torch.where(scene.tng_idx >= 0,
                      scene.tng_idx.long() * 8 + scene.tng_idx_dem_id.long(),
                      torch.full_like(scene.tng_idx, 2**62, dtype=torch.long))
    key, order = torch.sort(key, 1)
    spr = torch.stack([torch.gather(scene[k], 1, order)
                       for k in ("tng_x", "tng_y", "tng_z")])
    return key, spr


def phase_dem_parity(scheme, scene, other=None, label="dem-parity",
                     dt=DEM_DT):
    """20 kernel steps against 20 twin steps from one state, or with
    ``other`` (a scheme) against 20 of its steps, at time step ``dt``."""
    fast = scheme.make_step(scene)
    plain = (other.make_step(scene) if other is not None
             else scheme.make_step(scene, plain=True))
    ref = "twin" if other is None else f"{other.engine}"
    a = b = scene
    for _ in range(COMPARE_STEPS):
        a, b = fast(a, dt), plain(b, dt)
    torch.cuda.synchronize()
    check(not bool(a.nbr_overflow) and not bool(b.nbr_overflow),
          f"{label}: overflow during the DEM step comparison")
    worst = []
    keys = ("x", "y", "u", "v", "wz", "fx", "fy", "torz")
    if scheme.dim == 3:
        keys += ("z", "w", "wx", "wy", "fz", "torx", "tory")
    for k in keys:
        # positions as displacements over the run, so the tolerance is on
        # the motion and not on the domain's size
        x = a[k] - scene[k] if k in ("x", "y", "z") else a[k]
        y = b[k] - scene[k] if k in ("x", "y", "z") else b[k]
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        worst.append(f"{k} {err:.3e} (scale {scale:.3e})")
        check(bool(((x - y).abs() <= STEP_RTOL * y.abs()
                    + STEP_RTOL * scale).all()),
              f"{label}: DEM kernel step vs {ref} step: {k} off by "
              f"{err:.3e} "
              f"(scale {scale:.3e}, rtol {STEP_RTOL})")
    ka, sa = _sorted_tables(a)
    kb, sb = _sorted_tables(b)
    rows = int((ka != kb).any(1).sum())
    check(rows == 0, f"{label}: DEM kernel vs {ref} step: {rows} rows hold "
          "other contacts")
    d = (sa - sb).abs()
    check(bool((d <= STEP_RTOL * sb.abs()
                + STEP_RTOL * float(sb.abs().max())).all()),
          f"{label}: DEM kernel vs {ref} step: springs off by "
          f"{float(d.max()):.3e}")
    print(f"[{label}] {COMPARE_STEPS} kernel steps vs {COMPARE_STEPS} "
          f"{ref} steps: contact tables equal as (idx, dem) -> spring maps "
          f"(springs max abs diff {float(d.max()):.3e}), max abs diff: "
          + ", ".join(worst), flush=True)


# ---------------------------------------------------------------------------
# rigid-fluid coupling
# ---------------------------------------------------------------------------

@shared_build
def sinking_box_scene(dev, n_target=CPL_N, floor=False, body=True,
                      rho_b=2.0, engine="cell", kernel="quintic", grid=None):
    """``cases/rigid_body_rotating_and_sinking_in_tank_2d.py`` built with
    the port's geometry at bench.py's coupling size: a 4 x 3 fluid block
    in a 3-layer tank, a 1 x 0.5 box (rho 2) at the surface with the
    fluid void carved under it, hydrostatic pressure, the box's
    displaced-fluid shadow mass and density.  ``floor`` rests the box
    GAP dx above the tank floor's top layer instead; ``body=False``
    leaves it out (the hydrostatic tank); ``rho_b`` is the box's
    density, ``engine`` the scheme's pair engine, ``kernel`` its SPH
    kernel, ``grid`` as in ``contact_scene_2d``.  Returns (scheme, scene,
    dt)."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import (
        get_2d_block, hydrostatic_tank_2d)
    from rigid_body_2d_3d_pysph_tpu_torch.models import (
        RigidFluidCouplingScheme)
    from rigid_body_2d_3d_pysph_tpu_torch.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY, ROLE_FLUID)

    dx = 0.02 * np.sqrt(33_000.0 / max(n_target, 2000))
    L, rho_f, gy = 1.0, 1.0, -1.0
    h = dx                                      # hdx = 1
    co = 10 * np.sqrt(2 * 9.81 * 3.0 * L)
    xf, yf, xt, yt = hydrostatic_tank_2d(4.0 * L, 3.0 * L, 5.0 * L, 3, dx, dx)
    p0 = -rho_f * gy * (yf.max() - yf)
    groups = [make_group("tank", xt, yt, m=rho_f * dx**2, h=h, rho=rho_f,
                         rad_s=dx / 2.0, role=ROLE_BOUNDARY, dem_id=1)]
    if body:
        xb, yb = get_2d_block(dx, L - dx, 0.5 * L - dx)
        xb -= xb.min() - xf.min()
        xb += 1.5 * L
        if floor:                   # the floor's top layer is at y = -dx
            yb += (-dx + GAP * dx) - yb.min()
        else:
            yb += yf.max() - yb.min() + dx
            yb -= 0.25 * L + dx / 2.0
        keep = ~((xf > xb.min() - dx) & (xf < xb.max() + dx)
                 & (yf > yb.min() - dx) & (yf < yb.max() + dx))
        xf, yf, p0 = xf[keep], yf[keep], p0[keep]
        groups.append(make_group(
            "body", xb, yb, m=rho_b * dx**2, h=h, rho=rho_b, rad_s=dx / 2.0,
            role=ROLE_RIGID, body_id=np.zeros(len(xb), np.int32),
            dem_id=np.zeros(len(xb), np.int32)))
    groups.insert(0, make_group("fluid", xf, yf, m=rho_f * dx**2, h=h,
                                rho=rho_f, role=ROLE_FLUID, p=p0))
    scene = build_scene(groups, dim=2, total_no_bodies=2, spacing0=dx,
                        device=dev, dtype=config.WORK_DTYPE)
    scheme = RigidFluidCouplingScheme(
        ["fluid"], ["tank"], ["body"] if body else [], dim=2, rho0=rho_f,
        p0=rho_f * co**2, c0=co, h=h, nu=0.0, gy=gy)
    scheme.engine = engine
    scheme.kernel_name = kernel
    if grid is not None:
        scheme._cell_cfg = classic_config(scheme, scene, **grid)
    scene = scheme.setup(scene)
    if body:
        rb = scene.is_rigid
        scene = scene.replace(
            m_fsi=torch.where(rb, scene.m_fsi + rho_f * dx**2, scene.m_fsi),
            rho_fsi=torch.where(rb, rho_f, scene.rho_fsi))
    return scheme, scene, 0.25 * dx / (co * 1.1)


def fluid_pass_work(dfT, nbr, cnt, cutoff, pair_lanes=1 << 26):
    """The work of the coupling passes' bodies on the pack ``dfT`` over
    the stencil rows ``nbr`` (``cnt`` live lanes per slot), by the classes
    each body runs on: the candidate lanes scanned by the query lanes of
    each destination class (``lanes_<classes>``), and the pairs in range
    by (destination, source) class: ``fl_flbd`` fluid <- fluid or wall,
    ``fl_rg`` fluid <- body, ``fl_fl`` fluid <- fluid (``visc`` those
    approaching), ``solid_fl`` wall or body <- fluid, ``rg_fl`` body <-
    fluid; ``in_range`` every live pair, ``gated`` the contact gate's."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk

    NC, O = nbr.shape
    M = dfT.shape[2]
    _, _, sb, fl, rg = (c == 1.0 for c in
                        fk.decode_flags(dfT[:NC, fk.FFLAGS]))
    ext = torch.cat([cnt, cnt.new_zeros(1)])
    src_lanes = ext[torch.clamp(nbr, 0, NC)].sum(1)
    lanes = lambda q: int((q.sum(1) * src_lanes).sum())
    work = dict(lanes_fluid=lanes(fl), lanes_solid=lanes(sb | rg),
                lanes_fluid_solid=lanes(fl | sb | rg),
                lanes_fluid_rigid=lanes(fl | rg))
    work.update(dict.fromkeys(("in_range", "gated", "fl_flbd", "fl_rg",
                               "fl_fl", "visc", "solid_fl", "rg_fl"), 0))
    # slots a chunk: at most pair_lanes (query, candidate) lanes
    chunk = max(1, min(2048, pair_lanes // (M * O * M)))
    for c0 in range(0, NC, chunk):
        nb = nbr[c0:c0 + chunk]
        B = nb.shape[0]
        q = dfT[c0:c0 + B]
        src = dfT[nb].permute(0, 2, 1, 3).reshape(B, dfT.shape[1], O * M)
        d = [q[:, f, :, None] - src[:, f, None, :] for f in
             (fk.FX, fk.FY, fk.FZ, fk.FU, fk.FV, fk.FW)]
        live = (q[:, fk.FFLAGS, :, None] != -16.0) & \
            (src[:, fk.FFLAGS, None] != -16.0)
        near = live & (torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
                       <= cutoff)
        q_dem, _, q_sb, q_fl, q_rg = fk.decode_flags(q[:, fk.FFLAGS, :, None])
        s_dem, s_cfib, s_sb, s_fl, s_rg = fk.decode_flags(
            src[:, fk.FFLAGS, None])
        qf, qr = q_fl == 1.0, q_rg == 1.0
        sf = s_fl == 1.0
        approach = d[3] * d[0] + d[4] * d[1] + d[5] * d[2] < 0.0
        for k, m in (("in_range", near),
                     ("gated", qr & (s_cfib == 1.0) & ~sf & (s_dem != q_dem)),
                     ("fl_flbd", qf & (sf | (s_sb == 1.0))),
                     ("fl_rg", qf & (s_rg == 1.0)), ("fl_fl", qf & sf),
                     ("visc", qf & sf & approach),
                     ("solid_fl", ((q_sb == 1.0) | qr) & sf),
                     ("rg_fl", qr & sf)):
            work[k] += int((near & m).sum())
    return work


def fluid_pass_cost(work, name, n_live, edac=True, has_rigid=True,
                    visc=True, width=0, sph="quintic", extra_bytes=0):
    """(bytes, f32 operations) the pass ``name`` needs on this data: the
    pack fields it reads and its ``width`` outputs per live lane once,
    ``extra_bytes`` more (B5's contact rows and their index maps), and
    the operations on the candidate lanes of its destination classes and
    on the pairs its bodies run on (``fluid_pass_work``), with the SPH
    kernel ``sph``'s W and gradient."""
    w = work
    ops_w, ops_gradw = OPS_W_OF[sph], OPS_GRADW_OF[sph]
    rates = w["fl_flbd"] + (w["fl_rg"] if has_rigid else 0)
    rates_ops = rates * (OPS_PAIR_HEAD + ops_gradw + OPS_CONTINUITY
                         + (OPS_EDAC if edac else 0))
    wall_ops = w["solid_fl"] * (OPS_PAIR_HEAD + ops_w + OPS_WALL)
    force_ops = rates * (OPS_PAIR_HEAD + ops_gradw + OPS_PGRAD)
    if visc:
        force_ops += w["fl_fl"] * OPS_VISC_TEST + w["visc"] * OPS_VISC
    if has_rigid:
        force_ops += w["rg_fl"] * (OPS_PAIR_HEAD + ops_gradw + OPS_FSI)
    # fields read: x y z u v w m rho h p flags, and m_fsi rho_fsi p_fsi
    # with bodies; B6a reads p and p_fsi only for EDAC, B6b no m
    fsi = 3 if has_rigid else 0
    rates_fields = 11 + fsi - (0 if edac else 1 + (fsi > 0))
    lanes, ops, fields = {
        "fluid_rates": ("lanes_fluid", rates_ops, rates_fields),
        "wall_bc": ("lanes_solid", wall_ops, 10),
        "fluid_rates_wall": ("lanes_fluid_solid", rates_ops + wall_ops,
                             11 + fsi),
        "fluid_forces": ("lanes_fluid_rigid" if has_rigid else
                         "lanes_fluid", force_ops, 11 + fsi),
        "fluid_forces_contact": ("lanes_fluid_rigid", force_ops
                                 + w["gated"] * (ops_w + OPS_CONTACT_SUMS),
                                 11 + fsi),
    }[name]
    return (4 * n_live * (fields + width) + extra_bytes,
            w[lanes] * OPS_PER_LANE + ops)


def kernel_resources(template, args, helper, t, sph="quintic"):
    """ptxas's registers, static shared memory and spills of the
    ``csrc/fluid.cu`` instance ``template<args>`` (bools and ints) in the
    library of SPH kernel ``sph``, and the dynamic shared memory a block
    takes (the C entry ``helper``) at the lanes a slot and output columns
    of the timed pass ``t`` (the forces template: at its entity slots,
    0 for B6c); the instance of a slot wider than a warp where ``t``'s
    slots are."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    args = tuple(args) + (t["M"] > 32,)
    key = template + "I" + "".join(
        f"Lb{int(a)}E" if isinstance(a, bool) else f"Li{a}E"
        for a in args) + "E"
    usage = [u for e, u in _build.ptxas_usage(_build.BUILD_LOG.get(
        _build.instance("fluid", sph), "")).items() if key in e]
    u = usage[0] if usage else {}
    return dict(registers=u.get("registers"), smem_static=u.get("smem"),
                smem_dynamic_per_block=_build.load(helper)(
                    t["M"], t["S"] if "forces" in helper else t["width"]),
                spill_bytes=(u["spill_stores"] + u["spill_loads"]
                             if u else None))


def forces_resources(fsi, contact, t, sph="quintic"):
    """The 2D forces_kernel instance with viscosity (``fsi``,
    ``contact``): see ``kernel_resources``."""
    return kernel_resources("forces_kernel", (True, True, fsi, contact),
                            "fluid_forces_smem", t, sph)


def rates_resources(edac, has_rigid, mode, t, sph="quintic"):
    """The 2D rates_wall_kernel instance (``edac``, ``has_rigid``, the
    columns ``mode``: 0 B4, 1 B6a, 2 B6b): see ``kernel_resources``."""
    return kernel_resources("rates_wall_kernel", (True, edac, has_rigid,
                                                  mode),
                            "fluid_rates_wall_smem", t, sph)


def check_fluid_columns(got, ref, cols, label, floor=0.0):
    """Each column within FLUID_SUM_RTOL of its largest magnitude (at
    least ``floor``); returns the max abs error."""
    err = 0.0
    for c in cols:
        a, b = got[..., c], ref[..., c]
        scale = max(float(b.abs().max()), floor)
        e = float((a - b).abs().max())
        check(e <= FLUID_SUM_RTOL * scale, f"{label}: column {c} off by "
              f"{e:.3e} (scale {scale:.3e})")
        err = max(err, e)
    return err


def fluid_pass_checks(calls, dfT, nbr, pt, cutoff, S, init, visc, label,
                      timed, plain_reps=0):
    """Each pass of ``calls`` ({name: (kernel wrapper, twin, arguments,
    its name for the cost, EDAC, bodies)}) against its twin on the pack
    ``dfT``: finite, two launches bit for bit, not all zero, sums within
    FLUID_SUM_RTOL of each column's largest magnitude; for B5, whose
    output is (forces [NC, M, 6], contact rows) in the layout the calls
    give it (``fluid_calls``' ``b5``), the contact picks bit for bit, the
    unit contact normals within FLUID_SUM_RTOL absolute, the contact sums
    as K2's.  ``timed`` also times each and computes its bound (B5 also
    by the count before the redesign, ``old_bound_ms``: 12 S + 6 words
    out per live lane; ``plain_reps`` 0: the plain version timed on its
    one checking call).  Returns ({name: numbers}, the work counts, B5's
    contact rows with a pick or None)."""
    work = fluid_pass_work(dfT, nbr, pt.cnt, cutoff)
    n_live = int(pt.n_valid)
    out, n_found = {}, None
    for name, (fast, plain, args, cost_name, edac, bodies) in calls.items():
        got = fast(*args)
        again = fast(*args)
        ref, plain_once = timed_call(lambda: plain(*args))
        b5 = cost_name == "fluid_forces_contact"
        extra = 0
        if b5:
            (got, gc), (again, ac), (ref, rc) = got, again, ref
            check(bool(torch.isfinite(gc).all()), f"{label} {name}: "
                  "contact rows non-finite")
            check(torch.equal(gc, ac), f"{label} {name}: two launches on the "
                  "same inputs differ (contact rows)")
            del ac
            # the contact rows and their index maps (8 bytes an entry)
            NC, M = dfT.shape[0] - 1, dfT.shape[2]
            extra = 4 * gc.numel() + 8 * (gc.shape[0] if gc.dim() == 3
                                          else NC * M + gc.shape[0])
            layout = "rows" if gc.dim() == 3 else "lanes"
            gc, rc = gc.reshape(-1, 12 * S), rc.reshape(-1, 12 * S)
        check(bool(torch.isfinite(got).all()), f"{label} {name}: non-finite")
        check(torch.equal(got, again), f"{label} {name}: two launches on "
              "the same inputs differ")
        check(float(ref.abs().max()) > 0, f"{label} {name}: all zero")
        W = got.shape[-1]
        if b5:
            picks = gc[:, 5 * S:], rc[:, 5 * S:]
            check(torch.equal(*picks), f"{label} {name}: contact picks != "
                  f"twin (max {float((picks[0] - picks[1]).abs().max())})")
            n_found = int((rc[:, 5 * S:6 * S] < init).any(1).sum())
            # the contact normals are unit vectors; the sums K2's way
            err = check_fluid_columns(gc, rc, range(3 * S), label + " " +
                                      name, floor=1.0)
            for c in (3, 4):
                a, b = gc[:, c * S:(c + 1) * S], rc[:, c * S:(c + 1) * S]
                tol = SUM_RTOL * b.abs() + SUM_RTOL * float(b.abs().max())
                check(bool(((a - b).abs() <= tol).all()), f"{label} {name}: "
                      f"contact block {c} off by {float((a - b).abs().max())}")
            err = max(err, check_fluid_columns(got, ref, range(W),
                                               label + " " + name))
            err = max(err, float((gc[:, :5 * S] - rc[:, :5 * S])
                                 .abs().max()))
            del gc, rc
        else:
            err = check_fluid_columns(got, ref, range(W), label + " " + name)
        t = dict(err=err, M=got.shape[1], width=W)
        if b5:
            t.update(S=S, layout=layout)
        elif name.startswith("fluid_forces"):
            t.update(S=0)
        del got, again, ref
        if timed:
            t["ms"] = cuda_ms(lambda: fast(*args))
            t["plain_ms"] = (cuda_ms(lambda: plain(*args), reps=plain_reps,
                                     warmup=1) if plain_reps else plain_once)
            # least time: the fields read and W outputs per live lane
            # once (and B5's contact rows, each read by the step); the
            # f32 operations of this data's pairs
            t["bound_ms"], t["bound_by"] = bound(*fluid_pass_cost(
                work, cost_name, n_live, edac, bodies, visc, W,
                args[2].name, extra))
            if b5:
                t["old_bound_ms"] = bound(*fluid_pass_cost(
                    work, cost_name, n_live, edac, bodies, visc,
                    12 * S + 6, args[2].name))[0]
        out[name] = t
    return out, work, n_found


def print_fluid_passes(tag, label, out):
    for k, v in out.items():
        if "ms" in v:
            print(f"[{tag}] {label}: {k} {v['ms']:.4f} ms (plain "
                  f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms by "
                  f"{v['bound_by']})", flush=True)


def classic_tables(grid, cfg, n):
    """The pack tables ``fluid_pass_checks`` reads (live lanes a slot,
    live lanes in all) of a classic grid, whose pack is gathered."""
    cnt = (grid.slot2p < n).reshape(cfg.NC_max, cfg.M).sum(1)
    return types.SimpleNamespace(cnt=cnt, n_valid=cnt.sum())


def fluid_scene_pack(scheme, scene, label, seed, p_fsi=False, cfg=None):
    """This scene's coupling pack with seeded random velocities (and body
    ``p_fsi``): (kernel, cfg, grid, pack tables, dfT, S, contact init
    distance); ``cfg`` a classic grid in place of the scheme's (its pack
    gathered, its tables ``classic_tables``)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    cfg = cfg or scheme.cell_config(scene, kernel)
    dev = scene.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda a: (torch.rand(scene.n, generator=gen, device=dev) - 0.5) * a
    vel = dict(u=rnd(0.2), v=rnd(0.2))
    if scheme.dim == 3:
        vel["w"] = rnd(0.2)
    if p_fsi:
        vel["p_fsi"] = torch.where(scene.is_rigid, rnd(2.0), scene.p_fsi)
    scene = scene.replace(**vel)
    if cfg.spill:
        grid, pt, dfT = fk.pack_fluid_sorted(scene, cfg)
    else:
        grid, dfT = fk.pack_fluid_classic(scene, cfg)
        pt = classic_tables(grid, cfg, scene.n)
    check(not bool(grid.overflow), f"{label}: grid overflow")
    return (kernel, cfg, grid, pt, dfT, scene.meta.total_no_bodies,
            4.0 * scene.meta.spacing0)


def b5_layout(scheme, scene, grid, pt, dfT, cfg):
    """B5's contact layout on this scene's kdkf step: by query row at the
    light cull's slots on the compact store (``rows``), else by particle
    (``lanes``)."""
    from rigid_body_2d_3d_pysph_tpu_torch.models import (
        rigid_fluid_coupling as rfc)
    from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell

    if "cl_pid" in scene:
        # the step's capacity, or every culled slot where the step's
        # overflow rebuilds would raise it
        rows, cc = rfc.culled_lanes(scene, dfT, pt, cfg, scheme.ni_max(cfg))
        n_int = int(cc.n_interesting)
        if n_int > rows.shape[0]:
            rows, _ = rfc.culled_lanes(scene, dfT, pt, cfg, n_int)
        print(f"[b5-layout] by query row: {rows.shape[0]} rows, {n_int} "
              "slots with a rigid lane", flush=True)
        return dict(rows=rows)
    return dict(lanes=tcell.lane_map(grid, cfg, scene.n))


def fluid_calls(scheme, dfT, nbr, kernel, cutoff, S, init, names, b5=None):
    """{name: (wrapper, twin, arguments, cost name, EDAC, bodies)} of the
    fluid passes ``names`` on this pack: B4 and B5 as the kdkf step runs
    them (B4 without bodies and B6c for the fluid-only tank), the split
    passes of the kdk and reference orderings (B6a with EDAC and with
    Tait, B6b, B6c with bodies).  ``b5``: B5's contact layout
    (``b5_layout``; None: by query row at every slot)."""
    from functools import partial

    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk

    has_rigid = len(scheme.rigid_bodies) > 0
    base = (dfT, nbr, kernel, cutoff)
    nu, c0, g = scheme.edac_nu, scheme.c0, (scheme.gx, scheme.gy, scheme.gz)
    alpha = scheme.fluid_alpha
    every = dict(
        fluid_rates_wall=(fk.fluid_rates_wall, fk.fluid_rates_wall_reference,
                          base + (nu, c0, scheme.edac, has_rigid, g),
                          "fluid_rates_wall", scheme.edac, has_rigid),
        fluid_forces_contact=(partial(fk.fluid_forces_contact, **(b5 or {})),
                              partial(fk.fluid_forces_contact_reference,
                                      **(b5 or {})),
                              base + (alpha, c0, S, init),
                              "fluid_forces_contact", True, True),
        fluid_forces=(fk.fluid_forces, fk.fluid_forces_reference,
                      base + (alpha, c0), "fluid_forces", True, False),
        fluid_rates=(fk.fluid_rates, fk.fluid_rates_reference,
                     base + (nu, c0, True, True), "fluid_rates", True, True),
        fluid_rates_tait=(fk.fluid_rates, fk.fluid_rates_reference,
                          base + (nu, c0, False, True), "fluid_rates", False,
                          True),
        wall_bc=(fk.wall_bc, fk.wall_bc_reference, base + (g,), "wall_bc",
                 True, True),
        fluid_forces_rigid=(fk.fluid_forces, fk.fluid_forces_reference,
                            base + (alpha, c0, True), "fluid_forces", True,
                            True))
    return {k: every[k] for k in names}


def pack_expand_check(pt, dfT, cfg, label, timings):
    """K1 on this coupling pack (F = 14) against its twin, bit for bit,
    timed, with its bound."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk
    from rigid_body_2d_3d_pysph_tpu_torch.ops import pack_expand as tpe

    sent = torch.tensor(fk.SENT, dtype=dfT.dtype, device=dfT.device)
    args = (pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)
    ref = tpe.expand_slots_reference(*args)
    torch.cuda.synchronize()
    check(torch.equal(dfT, ref), f"{label}: pack expansion != twin")
    t = dict(ms=cuda_ms(lambda: tpe.expand_slots(*args)),
             plain_ms=cuda_ms(lambda: tpe.expand_slots_reference(*args)))
    t["bound_ms"], t["bound_by"] = bound(
        nbytes(pt.sorted_fields, pt.base, pt.cnt, sent, dfT), 0)
    print(f"[fluid-kernels] {label}: K1 (F = {dfT.shape[1]}) "
          f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, bound "
          f"{t['bound_ms']:.4f} ms by {t['bound_by']}), bit for bit",
          flush=True)
    timings[label] = t


def phase_fluid_kernels(scheme, scene, label, timings, timed, k1=None):
    """The passes this scene's step runs against their twins on its pack,
    with seeded random velocities: B4 and B5 with a rigid body, B4 and
    B6c without; ``timed`` also times each and computes its bound, and K1
    on the pack into ``k1``.  Returns the gated contact pairs and B5's
    contact rows with a pick (None without a body)."""
    kernel, cfg, grid, pt, dfT, S, init = fluid_scene_pack(scheme, scene,
                                                           label, 13)
    if k1 is not None:
        pack_expand_check(pt, dfT, cfg, label, k1)
    has_rigid = len(scheme.rigid_bodies) > 0
    names = ["fluid_rates_wall",
             "fluid_forces_contact" if has_rigid else "fluid_forces"]
    out, work, n_found = fluid_pass_checks(
        fluid_calls(scheme, dfT, grid.nbr_slots, kernel, cfg.radius, S,
                    init, names,
                    b5_layout(scheme, scene, grid, pt, dfT, cfg)),
        dfT, grid.nbr_slots, pt, cfg.radius, S, init,
        abs(scheme.fluid_alpha) > 1e-14, label, timed)
    picks = (f", contact rows with a pick {n_found}" if has_rigid else "")
    print(f"[fluid-kernels] {label}: n={scene.n} NC={cfg.NC_max} M={cfg.M} "
          f"O={cfg.O} S={S} | query lanes {int(pt.n_valid)}, {work}{picks} "
          "| max abs err " + ", ".join(
              f"{k} {v['err']:.3e}" for k, v in out.items()), flush=True)
    print_fluid_passes("fluid-kernels", label, out)
    timings[label] = out
    return work["gated"], n_found


def phase_coupling_main(scheme, scene, dt, n_steps, label, smi, per_step,
                        sink=True, stats=None):
    """The coupling step through its entry points, in chunks with the
    overflow-rebuild rule (``refresh_configs``, then ``adapt_scene``
    widens a compact store); ``per_step`` maps each kernel to its
    expected launches per step (none on the list engine); ``sink=False``
    leaves out the gate on the box's COM (its f32 value moves only after
    ~100 steps from rest); ``stats`` (a dict) receives the rebuilds and
    the steps run.  Returns (end scene, launches, steps/s)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    step = scheme.make_step(scene)
    fl = scene.is_fluid
    has_fluid = len(scheme.fluids) > 0
    has_body = scene.meta.nb > 0
    y0 = float(scene.xcm[0, 1]) if has_body else None
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    steps_run = done = rebuilds = rebuilds_total = 0
    chunk_s, chunk_n = [], []
    while done < n_steps:
        chunk_start = scene
        n = min(CHUNK, n_steps - done)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            scene = step(scene, dt)
        torch.cuda.synchronize()
        el = time.perf_counter() - t0
        steps_run += n
        if bool(scene.nbr_overflow):
            rebuilds += 1
            rebuilds_total += 1
            check(rebuilds <= 8, f"{label}: overflow persists after 8 "
                  "rebuilds")
            scheme.refresh_configs(chunk_start, grow=rebuilds > 1)
            chunk_start = scheme.adapt_scene(chunk_start)
            step = scheme.make_step(chunk_start)
            scene = chunk_start
            print(f"[{label}] step {done}: capacity overflow, rebuilt "
                  f"(x{rebuilds}, boost {scheme.capacity_boost:.2f})",
                  flush=True)
            continue
        rebuilds = 0
        done += n
        chunk_s.append(el)
        chunk_n.append(n)
        if has_fluid:
            rho = scene.rho[fl]
            state = (f"fluid rho {float(rho.min()):.6f}-"
                     f"{float(rho.max()):.6f}")
            if has_body:
                state += f", box COM y {float(scene.xcm[0, 1]):.7f}"
        else:
            state = f"max overlap {float(scene.overlap.max()):.3e}"
        print(f"[{label}] steps {done - n}-{done}: {el:.3f} s, {state}",
              flush=True)
    launches = dict(_build.LAUNCHES)
    for k in launches:
        want = per_step.get(k, 0) * steps_run
        check(launches[k] == want, f"{label}: {k} launched {launches[k]} "
              f"times in {steps_run} steps, expected {want}")
    launches = check_instances(label, scheme.kernel_name, launches)
    for k, v in scene.fields.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{label}: non-finite {k}")
    check(not bool(scene.nbr_overflow), f"{label}: overflow at the end")
    if has_fluid:
        dev_rho = float((scene.rho[fl] / scheme.rho0 - 1.0).abs().max())
        check(dev_rho < 0.05, f"{label}: fluid rho off rho0 by "
              f"{dev_rho:.3e}")
        msg = f" | max |rho/rho0 - 1| {dev_rho:.3e}"
    else:
        ov = float(scene.overlap.max())
        check(ov > 0, f"{label}: no overlap: the contact kernel did no work")
        msg = f" | max overlap {ov:.4e}"
    if has_body and has_fluid:
        y1 = float(scene.xcm[0, 1])
        check(y1 < y0 or not sink, f"{label}: the box did not sink "
              f"({y0:.7f} -> {y1:.7f})")
        msg += f" | box COM y {y0:.7f} -> {y1:.7f} ({y1 - y0:.3e})"
    steady = chunk_s[1:] or chunk_s
    sps = (sum(chunk_n[1:]) or sum(chunk_n)) / sum(steady)
    print(f"[{label}] n={scene.n} dt={dt:.6g} ({scheme.kernel_name}) "
          f"steps={done} (run {steps_run}) launches " + " ".join(
              f"{k}={v}" for k, v in launches.items() if v and "[" not in k)
          + msg, flush=True)
    if stats is not None:
        stats.update(rebuilds=rebuilds_total, steps_run=steps_run)
    if scheme.engine == "nklist":
        lc = scheme._nbr_cfg
        print(f"[{label}] list K {len(lc.stencil) * lc.max_per_cell} (M "
              f"{lc.max_per_cell}), cutoff {lc.cutoff:.6g}", flush=True)
    print(f"[{label}] {sps:.2f} steps/s steady (chunks 2+), "
          f"{done / sum(chunk_s):.2f} steps/s all chunks, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on "
          f"{smi}", flush=True)
    return scene, launches, sps


def phase_coupling_parity(scheme, scene, dt, label="cpl-parity",
                          other=None, push=True, full=False,
                          rtol=STEP_RTOL, n=COMPARE_STEPS):
    """``n`` kernel steps against ``n`` twin steps from one state in the
    scheme's ordering, in contact throughout: the dense box starts GAP dx
    above the floor, engaged, and moving down and sideways.  Sliding,
    because at zero tangential velocity the Coulomb friction's direction
    is the rounding noise of the tangent (the reference model's own
    discontinuity), which no summation-order tolerance holds.  With
    ``other`` (a scheme), its steps take the twin's place; ``push`` a
    tensor sets the bodies' velocities to it in place of the box's; with
    ``full`` the kernel steps of the compact store are held against
    kernel steps of the full route from the same state (at ``rtol``),
    each run timed, and the steps/s of both are returned.  A compact
    store is compared through its [N, S] view."""
    from rigid_body_2d_3d_pysph_tpu_torch.models.rigid_body import (
        expand_slot_scene, strip_compact_fields)

    if isinstance(push, torch.Tensor):
        scene = scene.replace(vcm=push)
    elif push:
        scene = scene.replace(vcm=torch.tensor(
            [[0.05, -0.5, 0.0]], dtype=scene.dtype, device=scene.device))
    fast = scheme.make_step(scene)
    start_b = scene
    if full:
        start_b = strip_compact_fields(expand_slot_scene(scene))
        plain, ref = scheme.make_step(start_b), "full-route"
    elif other is not None:
        plain, ref = other.make_step(scene), other.engine
    else:
        plain, ref = scheme.make_step(scene, plain=True), "twin"
    sps = {}
    if full:
        # one step each first, so neither timed run pays a first call
        fast(scene, dt), plain(start_b, dt)
        ends = []
        for fn, c in ((fast, scene), (plain, start_b)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                c = fn(c, dt)
            torch.cuda.synchronize()
            ends.append((c, n / (time.perf_counter() - t0)))
        (a, sps["compact"]), (b, sps["full"]) = ends
    else:
        a = b = scene
        for _ in range(n):
            a, b = fast(a, dt), plain(b, dt)
    torch.cuda.synchronize()
    check(not bool(a.nbr_overflow) and not bool(b.nbr_overflow),
          f"{label}: overflow during the coupling step comparison")
    a, b = expand_slot_scene(a), expand_slot_scene(b)
    for c, who in ((a, "kernel"), (b, ref)):
        check(float(c.overlap.max()) > 0 and
              float(c.delta_lt_x.abs().max()) > 0,
              f"{label}: the comparison's {who} run ended out of contact")
    worst = []
    eps = torch.finfo(scene.dtype).eps
    # the box's particle positions set the contact distances: two ulps
    # of the largest of them
    pos_ulp = 2 * eps * float(torch.stack(
        [scene.x.abs(), scene.y.abs()])[:, scene.is_rigid].max())
    # a contact force component errs by the force's size times its unit
    # normal's error, so fn_x and fn_y are held to the largest |fn|
    fn_scale = float(torch.sqrt(b.fn_x ** 2 + b.fn_y ** 2).max())
    bad = []
    keys = ("x", "y", "u", "v", "rho", "p", "p_fsi", "fx", "fy", "xcm",
            "vcm", "omega", "force", "contact_force_dist",
            "closest_point_dist_to_source", "overlap", "fn_x", "fn_y",
            "delta_lt_x")
    if scene.meta.dim == 3:
        keys += ("z", "w", "fz", "torque", "delta_lt_z")
    for k in keys:
        x, y, tol = a[k], b[k], 0.0
        if k in ("x", "y", "z", "xcm"):
            # positions as displacements over the run; each drift rounds
            # to the position's f32 grid, so two ulps of |x| on top (the
            # tank is 4 m wide: one ulp is 1e-7 to 5e-7 m)
            x, y, tol = x - scene[k], y - scene[k], 2 * eps * scene[k].abs()
        elif k in ("contact_force_dist", "closest_point_dist_to_source",
                   "overlap"):
            tol = pos_ulp
        elif k == "p" and not scheme.edac:
            # Tait: a fluid particle's p = c0^2 rho0 / gamma ((rho /
            # rho0)^gamma - 1) is a function of its rho, so the two runs'
            # rho difference (held above) reaches p times dp/drho = c0^2
            # (rho / rho0)^(gamma - 1), ~590 here: one f32 ulp of rho is
            # ~7e-5 of p
            dpdrho = scheme.c0 ** 2 * (b.rho / scheme.rho0) ** (
                scheme.gamma - 1.0)
            tol = torch.where(b.is_fluid, dpdrho * (a.rho - b.rho).abs(),
                              torch.zeros_like(dpdrho))
        err = float((x - y).abs().max())
        scale = fn_scale if k in ("fn_x", "fn_y") else float(y.abs().max())
        worst.append(f"{k} {err:.3e} (scale {scale:.3e})")
        if not bool(((x - y).abs() <= rtol * y.abs()
                     + rtol * scale + tol).all()):
            bad.append(f"{k} off by {err:.3e} (scale {scale:.3e})")
    check(not bad, f"{label}: coupling kernel step vs {ref} step (rtol "
          f"{rtol}): " + ", ".join(bad))
    stepper = (scheme.gtvf_ordering if scheme.fluid_stepper == "gtvf"
               else scheme.fluid_stepper)
    what = (f"{scene.meta.nb} boxes of rho {CPL_BOX_RHO:g}"
            if scene.meta.nb > 1
            else f"dense box on the floor, rho {CPL_PARITY_RHO}")
    print(f"[{label}] {stepper}: {n} kernel steps "
          f"vs {n} {ref} steps ({what}; end "
          f"overlap {float(b.overlap.max()):.3e}, |delta_lt_x| "
          f"{float(b.delta_lt_x.abs().max()):.3e}), max abs diff: "
          + ", ".join(worst), flush=True)
    if full:
        print(f"[{label}] steps/s over {n} steps: compact "
              f"{sps['compact']:.2f}, full route {sps['full']:.2f}",
              flush=True)
    return sps


def contact_all_slots(dfT, grid, cfg, kernel, S, init, label, timed,
                      plain_reps=0):
    """K2 on every slot of the contact pack ``dfT`` (the cell pipeline of
    the kdk, reference and RK2 coupling orderings, the rigid RK2,
    leapfrog and skin steps) as the pipeline runs it, by particle (the
    grid keeps ``dense_pos``), against its twin: picks bit for bit, the
    sums as in phase 3; ``timed`` also times both, the query-row layout
    and that layout unpacked (the pipeline before the redesign), and
    computes the bound (``plain_reps`` 0: the twin timed on its one
    checking call).  Returns (numbers, particles with a pick)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck

    NC = cfg.NC_max
    nbr = grid.nbr_slots
    n = grid.dense_pos.shape[0]
    check(n > 0, f"{label}: the grid keeps no dense_pos")
    lanes = tcell.lane_map(grid, cfg, n)
    args = (dfT, torch.arange(NC, device=dfT.device), nbr, S, cfg.radius,
            init, kernel)
    out = tck.contact_sums(*args, lanes=lanes)
    ref, plain_once = timed_call(
        lambda: tck.contact_sums_reference(*args, lanes=lanes))
    check(bool(torch.isfinite(out).all()), f"{label}: K2 non-finite output")
    check(torch.equal(out[..., 5 * S:], ref[..., 5 * S:]),
          f"{label}: K2 picks on every slot != twin (max "
          f"{float((out[..., 5 * S:] - ref[..., 5 * S:]).abs().max())})")
    for c in range(5):
        a, b = out[..., c * S:(c + 1) * S], ref[..., c * S:(c + 1) * S]
        # the normals (blocks 0-2) are unit vectors: a component near 0
        # carries the rounding of the others, so their scale is 1
        scale = max(float(b.abs().max()), 1.0 if c < 3 else 0.0)
        tol = SUM_RTOL * b.abs() + SUM_RTOL * scale
        check(bool(((a - b).abs() <= tol).all()), f"{label}: K2 block {c} "
              f"off by {float((a - b).abs().max())}")
    t = dict(err=float((out - ref).abs().max()))
    n_pick = int((ref[:, 5 * S:6 * S] < init).any(1).sum())
    del out, ref
    if timed:
        t["ms"] = cuda_ms(lambda: tck.contact_sums(*args, lanes=lanes))
        t["plain_ms"] = cuda_ms(
            lambda: tck.contact_sums_reference(*args, lanes=lanes),
            reps=plain_reps, warmup=1) if plain_reps else plain_once
        # the layout before the redesign: by query row, then unpacked
        t["rows_ms"] = cuda_ms(lambda: tck.contact_sums(*args))
        t["rows_unpack_ms"] = cuda_ms(lambda: tcell.unpack(
            grid, cfg, tck.contact_sums(*args), n, 0.0))
        # least time: F fields in per live lane, the lane map, 12S words
        # out per particle; 9 ops per candidate lane of the rigid query
        # lanes (a block with none writes its init rows and scans
        # nothing); before the redesign's count (old_bound_ms): F + 12S
        # words per live lane
        F = dfT.shape[1]
        flags = dfT[:NC, F - 1]
        n_rigid = (tck.decode_flags(flags)[3] == 1.0).sum(1)
        cnt = (flags != -8.0).sum(1)
        ext = torch.cat([cnt, torch.zeros(1, dtype=cnt.dtype,
                                          device=cnt.device)])
        nlanes = int((n_rigid * ext[torch.clamp(nbr, max=NC)].sum(1)).sum())
        t["bound_ms"], t["bound_by"] = bound(
            4 * (int(cnt.sum()) * F + n * 12 * S) + 8 * (NC * cfg.M + n),
            nlanes * OPS_PER_LANE)
        t["old_bound_ms"] = bound(4 * int(cnt.sum()) * (F + 12 * S),
                                  nlanes * OPS_PER_LANE)[0]
        t["lanes"] = nlanes
        t["rigid_slots"] = int((n_rigid > 0).sum())
        print(f"[{label}] K2 on all {NC} slots by particle "
              f"({t['rigid_slots']} with a rigid lane, {nlanes} rigid "
              f"candidate lanes): {t['ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']}, before the redesign's count "
              f"{t['old_bound_ms']:.4f} ms); by query row "
              f"{t['rows_ms']:.4f} ms, unpacked {t['rows_unpack_ms']:.4f} ms",
              flush=True)
    return t, n_pick


def phase_split_kernels(scheme, scene, label, timings, timed):
    """The kdk and reference orderings' passes against their twins on this
    scene's coupling pack, with seeded random velocities and body p_fsi:
    B6a with EDAC and with Tait, B6b and B6c with rigid bodies, and K2 on
    every slot of the contact pack laid out from the pack; ``timed`` also
    times each and computes its bound.  Returns (gated contact pairs,
    query lanes with a pick)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk

    kernel, cfg, grid, pt, dfT, S, init = fluid_scene_pack(
        scheme, scene, label, 17, p_fsi=True)
    out, work, _ = fluid_pass_checks(
        fluid_calls(scheme, dfT, grid.nbr_slots, kernel, cfg.radius, S,
                    init, ["fluid_rates", "fluid_rates_tait", "wall_bc",
                           "fluid_forces_rigid"]),
        dfT, grid.nbr_slots, pt, cfg.radius, S, init,
        abs(scheme.fluid_alpha) > 1e-14, label, timed)
    out["contact_all_slots"], n_pick = contact_all_slots(
        tck.contact_pack(dfT, fk.UNION_LAYOUT, cfg.dim == 2), grid, cfg,
        kernel, S, init, label, timed)
    print(f"[split-kernels] {label}: n={scene.n} NC={cfg.NC_max} M={cfg.M} "
          f"O={cfg.O} S={S} | query lanes {int(pt.n_valid)}, {work}, K2 "
          f"query lanes with a pick {n_pick} | max abs err " + ", ".join(
              f"{k} {v['err']:.3e}" for k, v in out.items()), flush=True)
    print_fluid_passes("split-kernels", label, out)
    timings[label] = out
    return work["gated"], n_pick


def sinking_box_scene_3d(dev, n_target=CPL_N, grid=None):
    """The sinking box in 3D, set up through the port's
    ``RigidFluidCouplingScheme(dim=3)``: a 1.0 x 0.6 x 0.5 fluid block
    (x, y, z) in a 3-layer hydrostatic tank (``get_fluid_tank_3d``), a
    0.3 x 0.15 x 0.3 box of rho 2 centred in x and z, dipped into the
    surface, the fluid void carved under it, hydrostatic pressure, the box's displaced-fluid shadow mass and
    density; the 2D case's h = dx, c0 = 10 sqrt(2 g H) and fluid rho 1.
    dx = 0.0175 at ~97k particles.  ``grid`` as in ``contact_scene_2d``.
    Returns (scheme, scene)."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import (
        get_3d_block, get_fluid_tank_3d)
    from rigid_body_2d_3d_pysph_tpu_torch.models import (
        RigidFluidCouplingScheme)
    from rigid_body_2d_3d_pysph_tpu_torch.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY, ROLE_FLUID)

    dx = 0.0175 * (96_921.0 / n_target) ** (1.0 / 3.0)
    H, rho_f, rho_b, gy = 0.6, 1.0, 2.0, -1.0
    co = 10 * np.sqrt(2 * 9.81 * H)
    xf, yf, zf, xt, yt, zt = get_fluid_tank_3d(1.0, H, 0.5, 1.0, 0.8, 3, dx,
                                               dx, hydrostatic=True)
    p0 = -rho_f * gy * (yf.max() - yf)
    xb, yb, zb = get_3d_block(dx, 0.3 - dx, 0.15 - dx, 0.3 - dx)
    xb += 0.5 * (xf.min() + xf.max()) - 0.5 * (xb.min() + xb.max())
    zb += 0.5 * (zf.min() + zf.max()) - 0.5 * (zb.min() + zb.max())
    yb += yf.max() + dx - yb.min() - 0.25 * 0.15
    keep = ~((xf > xb.min() - dx) & (xf < xb.max() + dx)
             & (yf > yb.min() - dx) & (yf < yb.max() + dx)
             & (zf > zb.min() - dx) & (zf < zb.max() + dx))
    m = dx ** 3
    groups = [
        make_group("fluid", xf[keep], yf[keep], z=zf[keep], m=rho_f * m,
                   h=dx, rho=rho_f, role=ROLE_FLUID, p=p0[keep]),
        make_group("tank", xt, yt, z=zt, m=rho_f * m, h=dx, rho=rho_f,
                   rad_s=dx / 2.0, role=ROLE_BOUNDARY, dem_id=1),
        make_group("body", xb, yb, z=zb, m=rho_b * m, h=dx, rho=rho_b,
                   rad_s=dx / 2.0, role=ROLE_RIGID,
                   body_id=np.zeros(len(xb), np.int32),
                   dem_id=np.zeros(len(xb), np.int32))]
    scene = build_scene(groups, dim=3, total_no_bodies=2, spacing0=dx,
                        device=dev, dtype=config.WORK_DTYPE)
    scheme = RigidFluidCouplingScheme(
        ["fluid"], ["tank"], ["body"], dim=3, rho0=rho_f, p0=rho_f * co**2,
        c0=co, h=dx, nu=0.0, gy=gy)
    if grid is not None:
        scheme._cell_cfg = classic_config(scheme, scene, **grid)
    scene = scheme.setup(scene)
    rb = scene.is_rigid
    scene = scene.replace(
        m_fsi=torch.where(rb, scene.m_fsi + rho_f * m, scene.m_fsi),
        rho_fsi=torch.where(rb, rho_f, scene.rho_fsi))
    return scheme, scene


def phase_fluid_3d(scheme, scene, timings, k1):
    """Every fluid pass on the 3D sinking box's pack against its twin
    (seeded random velocities and body p_fsi): B4 and B5 (the kdkf step),
    B6a with EDAC and with Tait, B6b, B6c with and without bodies, each
    timed with its bound; K1 on the same pack into ``k1``."""
    label = "3D box"
    kernel, cfg, grid, pt, dfT, S, init = fluid_scene_pack(
        scheme, scene, label, 19, p_fsi=True)
    pack_expand_check(pt, dfT, cfg, label, k1)
    out, work, n_found = fluid_pass_checks(
        fluid_calls(scheme, dfT, grid.nbr_slots, kernel, cfg.radius, S,
                    init, ["fluid_rates_wall", "fluid_forces_contact",
                           "fluid_rates", "fluid_rates_tait", "wall_bc",
                           "fluid_forces", "fluid_forces_rigid"],
                    b5_layout(scheme, scene, grid, pt, dfT, cfg)),
        dfT, grid.nbr_slots, pt, cfg.radius, S, init,
        abs(scheme.fluid_alpha) > 1e-14, label, True)
    print(f"[fluid-3d] n={scene.n} NC={cfg.NC_max} M={cfg.M} O={cfg.O} "
          f"S={S} | query lanes {int(pt.n_valid)}, {work}, contact slots "
          f"with a pick {n_found} | max abs err " + ", ".join(
              f"{k} {v['err']:.3e}" for k, v in out.items()), flush=True)
    print_fluid_passes("fluid-3d", label, out)
    timings[label] = out


def phase_coupling_3d(scheme, scene, tmp, smi):
    """The 3D coupling main path: phase 19's box through ``make_step``,
    driven by the port's ``Solver`` (chunks of CHUNK steps, the overflow
    rule, snapshots), CPL_STEPS fused kdkf steps at dt = 0.25 dx / (1.1
    c0) under phase 11's gates; then 20 kernel steps against 20 twin
    steps from the end state.  Returns (launches, steps/s)."""
    from rigid_body_2d_3d_pysph_tpu_torch.app.application import Solver
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    label = "cpl-3d"
    dt = 0.25 * scheme.h / (1.1 * scheme.c0)
    fl = scene.is_fluid
    y0 = float(scene.xcm[0, 1])
    solver = Solver(scheme, scene, dt, CPL_STEPS * dt, pfreq=CHUNK,
                    output_dir=os.path.join(tmp, "cpl3d"))
    _build.reset_launches()
    t0 = time.perf_counter()
    end = solver.solve(quiet=True)
    el = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    per_step = dict(pack_expand=1, fluid_rates_wall=1, fluid_forces_contact=1)
    for k in launches:
        want = per_step.get(k, 0) * solver.steps_run
        check(launches[k] == want, f"{label}: {k} launched {launches[k]} "
              f"times in {solver.steps_run} steps, expected {want}")
    check(solver.count == CPL_STEPS, f"{label}: {solver.count} steps done")
    for k, v in end.fields.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{label}: non-finite {k}")
    check(not bool(end.nbr_overflow), f"{label}: overflow at the end")
    dev_rho = float((end.rho[fl] / scheme.rho0 - 1.0).abs().max())
    check(dev_rho < 0.05, f"{label}: fluid rho off rho0 by {dev_rho:.3e}")
    y1 = float(end.xcm[0, 1])
    check(y1 < y0, f"{label}: the box did not sink ({y0:.7f} -> {y1:.7f})")
    check(len(solver.output_files) == CPL_STEPS // CHUNK + 1 and all(
        os.path.exists(p) for p in solver.output_files),
        f"{label}: snapshots missing")
    print(f"[{label}] n={end.n} dt={dt:.6g} steps={solver.count} (run "
          f"{solver.steps_run}, rebuilds {solver.rebuilds_total}) launches "
          + " ".join(f"{k}={v}" for k, v in launches.items() if v)
          + f" | max |rho/rho0 - 1| {dev_rho:.3e} | box COM y {y0:.7f} -> "
          f"{y1:.7f} ({y1 - y0:.3e})", flush=True)
    print(f"[{label}] {solver.steps_per_sec:.2f} steps/s through the Solver "
          f"(snapshots every {CHUNK} steps; {el:.2f} s in all), on {smi}",
          flush=True)

    phase_coupling_3d_parity(scheme, end, dt, label)
    return launches, solver.steps_per_sec


def phase_coupling_3d_parity(scheme, end, dt, label, n=COMPARE_STEPS):
    """``n`` kernel steps against ``n`` twin steps of the 3D sinking box
    from ``end``, in the scheme's ordering (STEP_RTOL)."""
    fast, plain = scheme.make_step(end), scheme.make_step(end, plain=True)
    a = b = end
    for _ in range(n):
        a, b = fast(a, dt), plain(b, dt)
    torch.cuda.synchronize()
    check(not bool(a.nbr_overflow) and not bool(b.nbr_overflow),
          f"{label}: overflow during the step comparison")
    eps = torch.finfo(end.dtype).eps
    # the box is symmetric: its spin and torque are rounding noise, held
    # to the scale a spin or torque of the box's own motion would have
    # (|force| x its half extent, |vcm| / its half extent)
    rb = end.is_rigid
    half = 0.5 * float(max(float(end[k][rb].max() - end[k][rb].min())
                           for k in ("x", "y", "z")))
    floor = dict(omega=float(b.vcm.abs().max()) / half,
                 torque=float(b.force.abs().max()) * half)
    worst, bad = [], []
    for k in ("x", "y", "z", "u", "v", "w", "rho", "p", "p_fsi", "fx", "fy",
              "fz", "xcm", "vcm", "omega", "force", "torque"):
        x, y, tol = a[k], b[k], 0.0
        if k in ("x", "y", "z", "xcm"):
            # displacements over the run, two ulps of |x| on top (each
            # drift rounds to the position's f32 grid)
            x, y, tol = x - end[k], y - end[k], 2 * eps * end[k].abs()
        err = float((x - y).abs().max())
        scale = max(float(y.abs().max()), floor.get(k, 0.0))
        worst.append(f"{k} {err:.3e} (scale {scale:.3e})")
        if not bool(((x - y).abs() <= STEP_RTOL * y.abs()
                     + STEP_RTOL * scale + tol).all()):
            bad.append(f"{k} off by {err:.3e} (scale {scale:.3e})")
    check(not bad, f"{label}: kernel step vs twin step (rtol {STEP_RTOL}): "
          + ", ".join(bad))
    print(f"[{label}-parity] {n} kernel steps vs {n} twin steps, max abs "
          "diff: " + ", ".join(worst), flush=True)


def boxes_tank_scene(dev, dim=2, n_target=CPL_N, rows=2, cols=4,
                     side=None, compact=True, kr=None, min_overlap=0.0,
                     grid=None):
    """The compact route's scene: the sinking box's tank at bench.py's
    coupling size (2D: ``sinking_box_scene``'s 4 x 3 fluid block; 3D:
    ``sinking_box_scene_3d``'s 1.0 x 0.6 x 0.5 one) with ``rows`` layers
    of ``cols`` boxes of CPL_BOX_RHO in place of the box, one group each
    (surface identification runs per group), S = rows x cols + 1 (9 by
    default): the first layer on the tank floor (a row in 2D, cols / 2 x
    2 in 3D), each next one on top of the last, each face CPL_BOX_GAP dx
    over what it rests on, columns CPL_BOX_COL_GAP dx apart; the fluid
    carved a dx around each box, hydrostatic pressure, the boxes' shadow
    mass and density; the even layers sliding at +CPL_BOX_SLIDE (x, and z
    in 3D), the odd ones at -CPL_BOX_SLIDE.  Set up through the scheme
    on the compact store (its threshold set to the reference's 8
    entities; ``compact=False`` sets no threshold, the full route;
    ``compact=None`` leaves the scheme's default).  ``side`` sets the
    boxes' side (2D; CPL_BOX_SIDE by default), ``kr`` the contact
    stiffness (the scheme's, or CPL_CUBE_KR in 3D, by default) and
    ``min_overlap`` (in dx) the least overlap ``settle_boxes`` leaves;
    ``grid`` as in ``classic_config`` (phase 51: a spill grid of more
    lanes).  Returns (scheme, scene, dt)."""
    from rigid_body_2d_3d_pysph_tpu_torch import config
    from rigid_body_2d_3d_pysph_tpu_torch.geom import (
        get_2d_block, get_3d_block, get_fluid_tank_3d, hydrostatic_tank_2d)
    from rigid_body_2d_3d_pysph_tpu_torch.models import (
        RigidFluidCouplingScheme)
    from rigid_body_2d_3d_pysph_tpu_torch.state import (
        make_group, build_scene, ROLE_RIGID, ROLE_BOUNDARY, ROLE_FLUID)

    rho_f, gy, n_boxes = 1.0, -1.0, rows * cols
    if dim == 2:
        dx = 0.02 * np.sqrt(33_000.0 / max(n_target, 2000))
        H = 3.0
        xf, yf, xt, yt = hydrostatic_tank_2d(4.0, H, 5.0, 3, dx, dx)
        zf, zt = np.zeros_like(xf), np.zeros_like(xt)
        bs = CPL_BOX_SIDE if side is None else side
        xb, yb = get_2d_block(dx, bs - dx, bs - dx)
        zb = np.zeros_like(xb)
        cells = [(i, 0) for i in range(cols)]
    else:
        dx = 0.0175 * (96_921.0 / n_target) ** (1.0 / 3.0)
        H = 0.6
        xf, yf, zf, xt, yt, zt = get_fluid_tank_3d(
            1.0, H, 0.5, 1.0, 0.8, 3, dx, dx, hydrostatic=True)
        side = CPL_CUBE_SIDE - dx
        xb, yb, zb = get_3d_block(dx, side, side, side)
        cells = [(i, k) for k in range(2) for i in range(cols // 2)]
    co = 10 * np.sqrt(2 * 9.81 * H)
    p0 = -rho_f * gy * (yf.max() - yf)
    xb, yb, zb = xb - xb.min(), yb - yb.min(), zb - zb.min()
    span = float(xb.max())
    pitch = span + CPL_BOX_COL_GAP * dx
    nx = max(i for i, _ in cells) + 1
    nz = max(k for _, k in cells) + 1
    x0 = 0.5 * (xf.min() + xf.max()) - 0.5 * (nx * pitch - pitch + span)
    z0 = 0.5 * (zf.min() + zf.max()) - 0.5 * (nz * pitch - pitch + span)
    floor_top = float(yt[yt < yf.min() - 0.5 * dx].max())
    boxes = []
    for row in range(rows):
        y0 = floor_top + CPL_BOX_GAP * dx + row * (span + CPL_BOX_GAP * dx)
        for i, k in cells:
            boxes.append((xb + x0 + i * pitch, yb + y0,
                          zb + z0 + k * pitch if dim == 3 else zb))
    keep = np.ones(len(xf), bool)
    for bx, by, bz in boxes:
        cut = ((xf > bx.min() - dx) & (xf < bx.max() + dx)
               & (yf > by.min() - dx) & (yf < by.max() + dx))
        if dim == 3:
            cut &= (zf > bz.min() - dx) & (zf < bz.max() + dx)
        keep &= ~cut
    m = dx ** dim
    zk = dict(z=zf[keep]) if dim == 3 else {}
    groups = [make_group("fluid", xf[keep], yf[keep], m=rho_f * m, h=dx,
                         rho=rho_f, role=ROLE_FLUID, p=p0[keep], **zk),
              make_group("tank", xt, yt, m=rho_f * m, h=dx, rho=rho_f,
                         rad_s=dx / 2.0, role=ROLE_BOUNDARY, dem_id=n_boxes,
                         **(dict(z=zt) if dim == 3 else {}))]
    names = []
    for b, (bx, by, bz) in enumerate(boxes):
        names.append(f"box{b}")
        groups.append(make_group(
            names[-1], bx, by, m=CPL_BOX_RHO * m, h=dx, rho=CPL_BOX_RHO,
            rad_s=dx / 2.0, role=ROLE_RIGID,
            body_id=np.zeros(len(bx), np.int32),
            dem_id=np.full(len(bx), b, np.int32),
            **(dict(z=bz) if dim == 3 else {})))
    scene = build_scene(groups, dim=dim, total_no_bodies=n_boxes + 1,
                        spacing0=dx, device=dev, dtype=config.WORK_DTYPE)
    scheme = RigidFluidCouplingScheme(
        ["fluid"], ["tank"], names, dim=dim, rho0=rho_f, p0=rho_f * co**2,
        c0=co, h=dx, nu=0.0, gy=gy)
    if dim == 3:
        scheme.kr = CPL_CUBE_KR
    if kr is not None:
        scheme.kr = kr
    if compact is not None:
        scheme.compact_min_bodies = 8 if compact else None
    if grid is not None:
        scheme._cell_cfg = classic_config(scheme, scene, **grid)
    scene = scheme.setup(scene)
    check(compact is None or ("cl_pid" in scene) == compact, "the boxes' "
          f"coupling scene was {'not ' if compact else ''}set up on the "
          "compact store")
    rb = scene.is_rigid
    sign = [1.0 - 2.0 * ((b // cols) % 2) for b in range(n_boxes)]
    slide = [[CPL_BOX_SLIDE * sg, 0.0, CPL_BOX_SLIDE * sg * (dim == 3)]
             for sg in sign]
    scene = scene.replace(
        m_fsi=torch.where(rb, scene.m_fsi + rho_f * m, scene.m_fsi),
        rho_fsi=torch.where(rb, rho_f, scene.rho_fsi),
        vcm=torch.tensor(slide, dtype=scene.dtype, device=scene.device))
    scene = settle_boxes(scheme, scene, abs(gy) * (1.0 - rho_f
                                                   / CPL_BOX_RHO), cols,
                         min_overlap)
    return scheme, scene, 0.25 * dx / (co * 1.1)


def settle_boxes(scheme, scene, g_eff, cols, min_overlap=0.0):
    """Move each box of ``boxes_tank_scene`` (layers of ``cols``) in y so
    that it starts pressed by half its load: the contact pass on the
    set-up state gives the Eq.-21 distance of its bottom face to what it
    rests on (the median over the face's particles: those within half a
    dx of the least distance); the overlap it is left with is half of
    load / (kr n_face), the load (``g_eff`` = g less the buoyancy) its
    own and that of the boxes stacked on it, or ``min_overlap`` dx if
    that is more.  A box above moves with the box under it first.
    Returns the scene moved."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    dim, dx = scene.meta.dim, scene.meta.spacing0
    S, nb = scene.meta.total_no_bodies, scene.meta.nb
    cfg = scheme._cell_cfg
    kernel = get_kernel(scheme.kernel_name, dim)
    grid, _, dfT = fk.pack_fluid_sorted(scene, cfg)
    cp = tck.contact_pipeline_cell(
        tck.contact_pack(dfT, fk.UNION_LAYOUT, dim == 2), grid, cfg, kernel,
        S, 4.0 * dx, scene.n)
    bid = torch.where(scene.is_rigid, scene.body_id.to(torch.int64), -1)
    mass = scene.total_mass.reshape(-1).double().cpu().numpy()
    shift = np.zeros(nb)
    for b in range(nb):
        below = S - 1 if b < cols else b - cols
        d = cp[bid == b, 4, below]
        d = d[d > 0].double().cpu()
        check(len(d) > 0, f"box {b} has no contact with what it rests on")
        d = d[d < d.min() + 0.5 * dx]          # the bottom face's lanes
        load = float(mass[b::cols].sum())      # itself and its stack
        target = max(0.5 * load * g_eff / (scheme.kr * len(d)),
                     min_overlap * dx)
        shift[b] = (dx - target) - float(d.median())
        if b >= cols:
            shift[b] += shift[below]
    sh = torch.as_tensor(shift, dtype=scene.dtype, device=scene.device)
    dy = torch.where(scene.is_rigid, sh[torch.clamp(bid, min=0)],
                     torch.zeros_like(scene.y))
    xcm = scene.xcm.clone()
    xcm[:, 1] += sh
    print(f"[settle] box y moves (dx): " + " ".join(
        f"{v / dx:+.2e}" for v in shift), flush=True)
    return scene.replace(y=scene.y + dy, xcm=xcm)


def phase_coupling_compact(dev, dim, n_steps, smi, n_target=CPL_N):
    """The kdkf step on the compact store (phases 42-43): the boxes' scene
    set up (the compact store, S = 9), then ``make_step`` -> ``step`` for
    ``n_steps`` in chunks with the overflow-rebuild rule under phase 11's
    gates but the sinking (one K1, B4 and B5 launch a step, no K2); the
    end state in contact (engaged slots) with tangential springs in
    ``cl_state``; n_interesting, ni_max and the rebuilds printed; then
    from the set-up state, the boxes pushed down (the top row at twice
    the speed), 20 kernel steps against 20 plain steps
    (STEP_RTOL) and 20 compact against 20 full-route
    kernel steps (COMPACT_RTOL), with both routes' steps/s.  Returns
    (launches, stats)."""
    from rigid_body_2d_3d_pysph_tpu_torch.models.rigid_body import (
        expand_slot_scene)

    label = f"cpl-compact-{dim}d"
    t0 = time.perf_counter()
    scheme, scene, dt = boxes_tank_scene(dev, dim, n_target)
    cfg = scheme._cell_cfg
    S = scene.meta.total_no_bodies
    ni0 = scheme.ni_max(cfg)
    print(f"[{label}-setup] n={scene.n} rigid {int(scene.is_rigid.sum())} "
          f"S={S} dt={dt:.6g} NC={cfg.NC_max} M={cfg.M} O={cfg.O} "
          f"ni_max={ni0} store L={scene.cl_pid.shape[0]} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    stats = {}
    end, launches, sps = phase_coupling_main(
        scheme, scene, dt, n_steps, label, smi,
        dict(pack_expand=1, fluid_rates_wall=1, fluid_forces_contact=1),
        sink=False, stats=stats)
    check("cl_pid" in end and "contact_force_normal_x" not in end,
          f"{label}: the run left the compact store")
    full = expand_slot_scene(end)
    engaged = int((full.overlap > 0).sum())
    spr = end.cl_state[:, 12 * S:15 * S]        # delta_lt x, y, z blocks
    n_spr = int((spr != 0).any(1).sum())
    n_int = int(end.n_interesting)
    ni = scheme.ni_max(scheme._cell_cfg)
    check(engaged > 0, f"{label}: no engaged contact at the end")
    check(n_spr > 0, f"{label}: no tangential spring in cl_state at the "
          "end")
    check(n_int <= ni, f"{label}: {n_int} interesting slots > ni_max {ni}")
    ov = float(full.overlap.max())
    print(f"[{label}] n_interesting {n_int}, ni_max {ni} (set-up {ni0}), "
          f"store L {end.cl_pid.shape[0]}, rebuilds {stats['rebuilds']} "
          f"(boost {scheme.capacity_boost:.3f}); at the end {engaged} "
          f"engaged contact slots, {n_spr} store lanes with a tangential "
          f"spring, max overlap {ov:.3e}, max |delta_lt_x| "
          f"{float(full.delta_lt_x.abs().max()):.3e}", flush=True)
    stats.update(n=end.n, n_interesting=n_int, ni_max=ni, engaged=engaged,
                 springs=n_spr, steps_per_s=sps)
    # the comparisons push the boxes down as phase 13 does its box (the
    # top row at twice the speed): at the settled overlap, a face's edge
    # lanes sit at the engagement threshold, and kernel and twin part
    # ways where their sums' rounding puts one lane on either side
    push = scene.vcm.clone()
    push[:, 1] -= 0.5 * (1 + (torch.arange(scene.meta.nb, device=push.device)
                              >= scene.meta.nb // 2).to(push.dtype))
    phase_coupling_parity(scheme, scene, dt, f"{label}-parity", push=push)
    stats["route_sps"] = phase_coupling_parity(
        scheme, scene, dt, f"{label}-vs-full", push=push, full=True,
        rtol=COMPACT_RTOL)
    return launches, stats


def phase_benchmark_5(tmp, smi):
    """Benchmark 5 in 2D with two cubes, run to half its tf (0.25 s at dt
    1e-4: 2,500 steps; the whole case, 5,000 steps, runs through
    ``run_suite.py``) through the port's ``Application``, then the port's
    ``check_benchmark_5`` on its snapshots: COM displacement < 2 spacings.
    Returns (launches, steps/s)."""
    from rigid_body_2d_3d_pysph_tpu_torch import validate as tval
    from rigid_body_2d_3d_pysph_tpu_torch.cases import (
        benchmark_5_steady_cubes_on_a_wall_2d as b5)
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    label = "b5-2d"
    app = b5.Benchmark5_2D(fname="benchmark_5_2d")
    _build.reset_launches()
    t0 = time.perf_counter()
    app.run(["--two-cubes", "--tf", str(B5_TF), "-d",
             os.path.join(tmp, "benchmark_5_2d_two_output"), "--quiet"])
    el = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    steps = app.solver.steps_run
    check(app.solver.count == B5_STEPS,
          f"{label}: {app.solver.count} steps")
    for k in launches:
        want = steps if k in ("pack_expand", "contact") else 0
        check(launches[k] == want, f"{label}: {k} launched {launches[k]} "
              f"times in {steps} steps, expected {want}")
    res = tval.check_benchmark_5(tmp, "benchmark_5_2d_two")
    check(res is not None and res["ok"], f"{label}: validation {res}")
    print(f"[{label}] n={app.scene.n} steps={app.solver.count} (run {steps}, "
          f"rebuilds {app.solver.rebuilds_total}) launches " + " ".join(
              f"{k}={v}" for k, v in launches.items() if v)
          + f" | check_benchmark_5: {json.dumps(res)}", flush=True)
    print(f"[{label}] {app.solver.steps_per_sec:.2f} steps/s through the "
          f"Application ({el:.2f} s with set-up), COM displacement "
          f"{res['max_com_displacement']:.4e} (limit 0.05), on {smi}",
          flush=True)
    return launches, app.solver.steps_per_sec


def phase_benchmark_2(tmp, smi):
    """Benchmark 2 (two cubes colliding head-on, no boundary,
    ``RigidBody3DScheme`` on the 2D scene) to its own tf through the
    port's ``Application``, then the port's ``check_benchmark_2``.
    Returns (launches, steps/s)."""
    from rigid_body_2d_3d_pysph_tpu_torch import validate as tval
    from rigid_body_2d_3d_pysph_tpu_torch.cases import (
        benchmark_2_multiple_rigid_bodies_colliding as b2)
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    label = "b2"
    app = b2.Benchmark2(fname="benchmark_2")
    _build.reset_launches()
    t0 = time.perf_counter()
    app.run(["-d", os.path.join(tmp, "benchmark_2_output"), "--quiet"])
    el = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    steps = app.solver.steps_run
    want_count = int(round(app.solver.tf / app.solver.dt))
    check(app.solver.count == want_count,
          f"{label}: {app.solver.count} steps, expected {want_count}")
    for k in launches:
        want = steps if k in ("pack_expand", "contact") else 0
        check(launches[k] == want, f"{label}: {k} launched {launches[k]} "
              f"times in {steps} steps, expected {want}")
    res = tval.check_benchmark_2(tmp)
    check(res is not None and res["ok"], f"{label}: validation {res}")
    print(f"[{label}] n={app.scene.n} steps={app.solver.count} (run {steps}, "
          f"rebuilds {app.solver.rebuilds_total}) launches " + " ".join(
              f"{k}={v}" for k, v in launches.items() if v)
          + f" | check_benchmark_2: {json.dumps(res)}", flush=True)
    print(f"[{label}] {app.solver.steps_per_sec:.2f} steps/s through the "
          f"Application ({el:.2f} s with set-up), on {smi}", flush=True)
    return launches, app.solver.steps_per_sec


def _npz_equal(p, q):
    """Names of the arrays that differ (bits, shape or dtype) between two
    npz files, and of those only one of them holds."""
    with np.load(p) as a, np.load(q) as b:
        diff = sorted(set(a.files) ^ set(b.files))
        for k in set(a.files) & set(b.files):
            x, y = a[k], b[k]
            if x.dtype != y.dtype or x.shape != y.shape or \
                    x.tobytes() != y.tobytes():
                diff.append(k)
    return diff


def phase_sinking_box_resume(tmp, smi):
    """The sinking box at the case's own size (spacing 0.02) through the
    port's ``Application``: 1,000 steps with snapshots every 100 and a
    checkpoint; a second run of 500 steps and a third resumed from its
    checkpoint to 1,000; the resumed run's last snapshot equals the
    uninterrupted one's bit for bit, and the uninterrupted run's snapshot
    at step 500 (written by the background writer while the steps went
    on) equals the second run's state at step 500 written synchronously.
    Returns (launches, steps/s)."""
    from rigid_body_2d_3d_pysph_tpu_torch.app import output as out_mod
    from rigid_body_2d_3d_pysph_tpu_torch.cases import (
        rigid_body_rotating_and_sinking_in_tank_2d as sb)
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    label = "sinking-box"
    d_full = os.path.join(tmp, "sb_full")
    d_res = os.path.join(tmp, "sb_resumed")
    full = sb.SinkingBox(fname="sinking_box")
    _build.reset_launches()
    t0 = time.perf_counter()
    full.run(["-d", d_full, "--max-steps", "1000", "--pfreq", "100",
              "--quiet"])
    el = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    steps = full.solver.steps_run
    per_step = dict(pack_expand=1, fluid_rates_wall=1, fluid_forces_contact=1)
    for k in launches:
        want = per_step.get(k, 0) * steps
        check(launches[k] == want, f"{label}: {k} launched {launches[k]} "
              f"times in {steps} steps, expected {want}")
    files = out_mod.get_files(d_full)
    check(len(files) == 11, f"{label}: {len(files)} snapshots, expected 11")
    check(os.path.exists(os.path.join(d_full, "checkpoint.npz")),
          f"{label}: no checkpoint")
    fl = full.scene.is_fluid
    dev_rho = float((full.scene.rho[fl] - 1.0).abs().max())
    check(bool(torch.isfinite(full.scene.x).all()) and dev_rho < 0.05,
          f"{label}: fluid rho off rho0 by {dev_rho:.3e}")
    print(f"[{label}] n={full.scene.n} dt={full.solver.dt:.6g} steps "
          f"{full.solver.count} (run {steps}, rebuilds "
          f"{full.solver.rebuilds_total}) launches " + " ".join(
              f"{k}={v}" for k, v in launches.items() if v)
          + f" | max |rho/rho0 - 1| {dev_rho:.3e}", flush=True)
    print(f"[{label}] {full.solver.steps_per_sec:.2f} steps/s through the "
          f"Application ({el:.2f} s with set-up), on {smi}", flush=True)

    half = sb.SinkingBox(fname="sinking_box")
    half.run(["-d", d_res, "--max-steps", "500", "--pfreq", "100",
              "--quiet"])
    sync_path = os.path.join(tmp, "sync_000500.npz")
    out_mod.write_snapshot(sync_path, half.scheme.export_scene(half.scene),
                           half.solver.t, half.solver.dt, half.solver.count)
    diff = _npz_equal(os.path.join(d_full, "snapshot_000500.npz"), sync_path)
    check(not diff, f"{label}: the background writer's snapshot at step 500 "
          f"differs from the state written synchronously in {diff}")
    resumed = sb.SinkingBox(fname="sinking_box")
    resumed.run(["-d", d_res, "--max-steps", "1000", "--pfreq", "100",
                 "--quiet", "--resume"])
    check(resumed.solver.steps_run == 500, f"{label}: the resumed run took "
          f"{resumed.solver.steps_run} steps")
    diff = _npz_equal(os.path.join(d_full, "snapshot_001000.npz"),
                      os.path.join(d_res, "snapshot_001000.npz"))
    check(not diff, f"{label}: the resumed run's last snapshot differs from "
          f"the uninterrupted run's in {diff}")
    with np.load(os.path.join(d_full, "snapshot_001000.npz")) as z:
        n_keys = len(z.files)
    print(f"[{label}] resumed at step 500 to 1000: the last snapshot equals "
          f"the uninterrupted run's bit for bit ({n_keys} arrays); the "
          f"background writer's step-500 snapshot equals the synchronous "
          f"write of the same state", flush=True)
    return launches, full.solver.steps_per_sec


# ---------------------------------------------------------------------------
# the SPH kernel family on the hand kernels (phases 39-40) and the Verlet
# skin (phase 41)
# ---------------------------------------------------------------------------

def sph_jobs():
    """The non-quintic libraries: (source, SPH kernel) for ``contact.cu``
    and ``fluid.cu`` with each of SPH_NAMES (``-DRB_SPH_KERNEL``)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    return [(src, k) for src in _build.SPH_SOURCES for k in SPH_NAMES]


def build_sph_instances(built=None, wall=None):
    """39 (build): the non-quintic libraries (``sph_jobs``), one nvcc
    each, all started together, unless ``built`` holds each one's (path,
    seconds) from phase 2's build (which starts them beside the quintic
    sources) and ``wall`` that build's seconds; prints each one's seconds
    and ptxas's registers and spills.  Returns ({library: numbers}, wall
    seconds)."""
    from concurrent.futures import ThreadPoolExecutor
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    jobs = sph_jobs()
    where = " with the quintic sources" if built is not None else ""
    if built is None:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(lambda j: _build.build(*j), jobs))
        wall = time.perf_counter() - t0
    out = {}
    for (src, k), (path, sec) in zip(jobs, built):
        key = _build.instance(src, k)
        use = _build.ptxas_usage(_build.BUILD_LOG.get(key, ""))
        check(len(use) > 0, f"{key}: no ptxas report")
        regs = sorted({(u["registers"], u["spill_stores"] + u["spill_loads"])
                       for u in use.values()})
        # the instances that spill, as template<arguments>
        spills = ["{}<{}>: {} B".format(
            m.group(1), ",".join(re.findall(r"L[bi](\d+)E", m.group(2))),
            u["spill_stores"] + u["spill_loads"])
            for e, u in use.items() if u["spill_stores"] + u["spill_loads"]
            for m in [re.search(r"(forces_kernel|rates_wall_kernel|"
                                r"contact_kernel)I((?:L[bi]\d+E)+)E", e)]
            if m]
        out[key] = dict(seconds=sec, entries=len(use),
                        max_registers=max(r for r, _ in regs),
                        spill_bytes=sum(u["spill_stores"] + u["spill_loads"]
                                        for u in use.values()))
        print(f"[sph-build] {key}: {sec:.2f} s -> "
              f"{os.path.relpath(path, ROOT)}; {len(use)} entry functions, "
              f"(registers, spill bytes) {regs}; spilling: "
              f"{', '.join(spills) or 'none'}", flush=True)
    for kname, (src, _, _) in _build.KERNELS.items():
        if src in _build.SPH_SOURCES:
            for k in SPH_NAMES:
                _build.load(kname, k)
    print(f"[sph-build] {len(jobs)} libraries in {wall:.2f} s wall{where}",
          flush=True)
    return out, wall


def contact_resources(sph, two_d=True):
    """ptxas's registers and spill bytes of K2's 2D (or 3D) narrow
    instance at the spill grids' 16 lanes in the library of SPH kernel
    ``sph``."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    usage = [u for e, u in _build.ptxas_usage(_build.BUILD_LOG.get(
        _build.instance("contact", sph), "")).items()
        if f"contact_kernelILb{int(two_d)}ELb0ELb0EE" in e]
    u = usage[0] if usage else {}
    return dict(registers=u.get("registers"), smem_static=u.get("smem"),
                spill_bytes=(u["spill_stores"] + u["spill_loads"]
                             if u else None))


def seeded_velocities(scene, dim, seed):
    """``scene`` with seeded random u, v (and w) in [-0.5, 0.5), so the
    picked source velocities are not all zero."""
    gen = torch.Generator(device=scene.device).manual_seed(seed)
    rnd = lambda: torch.rand(scene.n, generator=gen,
                             device=scene.device) - 0.5
    vel = dict(u=rnd(), v=rnd())
    if dim == 3:
        vel["w"] = rnd()
    return scene.replace(**vel)


SPH_PASSES = ["fluid_rates_wall", "fluid_forces_contact", "fluid_rates",
              "wall_bc", "fluid_forces_rigid"]


def phase_sph_kernels(dev, timings):
    """39. For each non-quintic SPH kernel, at the main paths' shapes
    (each scene set up with the kernel, so its grid has the kernel's
    cutoff): K2 on the 2D stack's culled rows and on every slot of the 3D
    cubes, and the five fluid passes (B4, B5, B6a with EDAC, B6b, B6c
    with bodies) on the 2D sinking box's pack, against their plain
    versions (picks bit for bit, sums within the tolerances of phases 3,
    10 and 14), each timed with its bound; B5 also on the box resting on
    the floor (contact picks > 0), untimed."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    for k in SPH_NAMES:
        t0 = time.perf_counter()
        t = {}
        scheme, scene, _ = contact_scene_2d(dev, kernel=k)
        kern = get_kernel(k, 2)
        cfg = scheme.cell_config(scene, kern)
        scene = seeded_velocities(scene, 2, 7)
        grid, pt, dfT = tck.pack_scene(scene, cfg, want_dense_pos=True)
        S, init = scene.meta.total_no_bodies, 4.0 * scene.meta.spacing0
        t["k2"] = contact_rows(dfT, grid, pt, cfg, kern, S, init,
                               scheme.ni_max(cfg), f"{k} 2D")[0]
        del scheme, scene, grid, pt, dfT

        scheme, scene, _ = contact_scene_3d(dev, kernel=k)
        kern = get_kernel(k, 3)
        cfg = scheme.cell_config(scene, kern)
        scene = seeded_velocities(scene, 3, 7)
        grid, _, dfT = tck.pack_scene(scene, cfg, want_dense_pos=True)
        t["k2_3d"], _ = contact_all_slots(
            dfT, grid, cfg, kern, scene.meta.total_no_bodies,
            4.0 * scene.meta.spacing0, f"{k} 3D every slot", timed=True)
        del scheme, scene, grid, dfT

        for floor in (False, True):
            label = f"{k} {'box on floor' if floor else 'sinking box'}"
            cscheme, cscene, _ = sinking_box_scene(dev, floor=floor,
                                                   kernel=k)
            kern, cfg, grid, pt, dfT, S, init = fluid_scene_pack(
                cscheme, cscene, label, 13, p_fsi=True)
            names = ["fluid_forces_contact"] if floor else SPH_PASSES
            out, work, n_found = fluid_pass_checks(
                fluid_calls(cscheme, dfT, grid.nbr_slots, kern, cfg.radius,
                            S, init, names,
                            b5_layout(cscheme, cscene, grid, pt, dfT, cfg)),
                dfT, grid.nbr_slots, pt, cfg.radius, S, init,
                abs(cscheme.fluid_alpha) > 1e-14, label, timed=not floor)
            if floor:
                check(work["gated"] > 0 and n_found > 0,
                      f"{label}: no gated contact pair")
                t["floor_err"] = out["fluid_forces_contact"]["err"]
            else:
                t["fluid"] = out
            print(f"[sph-kernels] {label}: n={cscene.n} NC={cfg.NC_max} "
                  f"O={cfg.O} cutoff {cfg.radius:.6g} | {work}, contact "
                  f"slots with a pick {n_found} | max abs err " + ", ".join(
                      f"{n} {v['err']:.3e}" for n, v in out.items()),
                  flush=True)
            print_fluid_passes("sph-kernels", label, out)
            del cscheme, cscene, grid, pt, dfT
        print(f"[sph-kernels] {k}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        timings[k] = t


def phase_sph_main_paths(dev, smi):
    """40. The main paths with each non-quintic SPH kernel, through the
    entry points: the 2D resting stack under GTVF, SPH_STEPS steps under
    phase 4's gates, one K1 and one K2 of the kernel a step; the sinking
    box under kdkf (one K1, B4 and B5 a step; CPL_STEPS under phase 11's
    gates with the cubic, SPH_SHORT_STEPS with the others) and kdk (two
    K1, B6a, B6b, B6c and K2 a step; SPH_SHORT_STEPS), the box's sinking
    gated on the CPL_STEPS run only; then 20 kernel steps against 20
    plain steps (STEP_RTOL) of the stack with the Wendland kernel and of
    the dense box on the floor under kdkf with the cubic.  Returns
    {kernel: {path: launches, "sps": ...}}."""
    out = {}
    for k in SPH_NAMES:
        scheme, scene, dx = contact_scene_2d(dev, kernel=k)
        end, rigid, st = phase_main_path(scheme, scene, dx, smi,
                                         f"rigid-{k}", SPH_STEPS)
        if k == "wendland":
            phase_step_parity(scheme, end, f"{k}-parity")
        del scheme, scene, end
        cscheme, cscene, cdt = sinking_box_scene(dev, kernel=k)
        full = k == "cubic"
        short = (SPH_UNSTABLE_STEPS if k == "super_gaussian"
                 else SPH_SHORT_STEPS)
        _, kdkf, kdkf_sps = phase_coupling_main(
            cscheme, cscene, cdt, CPL_STEPS if full else short,
            f"cpl-{k}", smi,
            dict(pack_expand=1, fluid_rates_wall=1, fluid_forces_contact=1),
            sink=full)
        cscheme.gtvf_ordering = "kdk"
        _, kdk, kdk_sps = phase_coupling_main(
            cscheme, cscene, cdt, short, f"cpl-kdk-{k}", smi,
            dict(pack_expand=2, fluid_rates=1, wall_bc=1, fluid_forces=1,
                 contact=1), sink=False)
        del cscheme, cscene
        if k == "cubic":
            pscheme, pscene, pdt = sinking_box_scene(
                dev, floor=True, rho_b=CPL_PARITY_RHO, kernel=k)
            phase_coupling_parity(pscheme, pscene, pdt, f"{k}-cpl-parity")
            del pscheme, pscene
        out[k] = dict(rigid=rigid, kdkf=kdkf, kdk=kdk,
                      sps=dict(rigid=st["steps_per_s"], kdkf=kdkf_sps,
                               kdk=kdk_sps))
    print("[sph-main] " + "; ".join(
        f"{k}: stack GTVF {v['sps']['rigid']:.2f}, kdkf "
        f"{v['sps']['kdkf']:.2f}, kdk {v['sps']['kdk']:.2f} steps/s"
        for k, v in out.items()) + f"; on {smi}", flush=True)
    return out


def strip_grid_fields(scene):
    """``scene`` without the carried skin grid's fields."""
    from rigid_body_2d_3d_pysph_tpu_torch.state.scene import Scene

    return Scene({k: v for k, v in scene.fields.items()
                  if not k.startswith("g_")}, scene.meta)


def phase_skin(dev, smi):
    """41. The 2D resting stack with ``skin_factor = SKIN``: SPH_STEPS
    GTVF steps under phase 4's gates, one K2 (every slot, on the pack
    gathered through the carried grid) and no K1 a step, the grid's
    rebuilds counted; then 20 skin steps against 20 steps of the compact
    no-skin kernel step from the same state (STEP_RTOL).  Returns
    (launches, stats)."""
    from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    scheme, scene, dx = contact_scene_2d(dev, skin=SKIN)
    cfg = scheme._cell_cfg
    print(f"[rigid-skin] skin {cfg.skin:.6g} (factor {SKIN}), bins "
          f"{cfg.cell:.6g} for the cutoff {cfg.radius:.6g}, NC {cfg.NC_max}, "
          f"O {cfg.O}", flush=True)
    end, launches, st = phase_main_path(scheme, scene, dx, smi,
                                        "rigid-skin", SPH_STEPS)
    # the same state on the compact no-skin step
    nscheme = copy.copy(scheme)
    nscheme.skin_factor, nscheme._cell_cfg, nscheme._grid_cfg = 0.0, None, None
    base = strip_grid_fields(end)
    kernel = get_kernel(scheme.kernel_name, 2)
    skin_run = trb.make_multi_step(scheme.make_step(end), COMPARE_STEPS)
    a = skin_run(end, DT)
    for attempt in range(4):
        ncfg = nscheme.cell_config(base, kernel)
        nscene = trb.compact_slot_scene(base, nscheme.ni_max(ncfg) * ncfg.M)
        b = trb.make_multi_step(nscheme.make_step(nscene), COMPARE_STEPS)(
            nscene, DT)
        if not bool(b.nbr_overflow):
            break
        nscheme.refresh_configs(base, grow=True)
    torch.cuda.synchronize()
    check(not bool(a.nbr_overflow) and not bool(b.nbr_overflow),
          "skin-parity: overflow during the comparison")
    worst = []
    for k in ("xcm", "vcm", "omega", "fx", "fy"):
        x, y = a[k], b[k]
        err = float((x - y).abs().max())
        scale = float(y.abs().max())
        worst.append(f"{k} {err:.3e} (scale {scale:.3e})")
        check(bool(((x - y).abs() <= STEP_RTOL * y.abs()
                    + STEP_RTOL * scale).all()),
              f"skin-parity: skin step vs no-skin step: {k} off by "
              f"{err:.3e} (scale {scale:.3e}, rtol {STEP_RTOL})")
    print(f"[skin-parity] {COMPARE_STEPS} skin steps vs {COMPARE_STEPS} "
          "no-skin kernel steps (compact), max abs diff: "
          + ", ".join(worst), flush=True)
    return launches, st


# ---------------------------------------------------------------------------
# slab decomposition (parallel/slab.py): P slabs on a list of devices
# ---------------------------------------------------------------------------

def _slab_gathered(parts):
    """The slabs gathered on slab 0's device, and its active rows in gid
    order."""
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as sl

    g = sl.gather_slab_scene(parts)
    rows = torch.nonzero(g.active).squeeze(1)
    return g, rows[torch.argsort(g.gid[rows])]


def _slab_close(label, what, a, b, floor=0.0, gate=True):
    """a within STEP_RTOL of b (|a - b| <= rtol |b| + rtol max |b|
    + floor), checked if ``gate``; returns the largest difference."""
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    if gate:
        check(bool(((a - b).abs() <= STEP_RTOL * b.abs()
                    + STEP_RTOL * scale + floor).all()),
              f"{label}: {what} off by {err:.3e} (scale {scale:.3e}, rtol "
              f"{STEP_RTOL})")
    return f"{what} {err:.3e} (scale {scale:.3e})"


def _slab_compare(label, a, ra, b, rb, keys, body_keys=(), x0=None,
                  ulps=0, gate=True):
    """The rows ``ra`` of the gathered slab state ``a`` against the rows
    ``rb`` of ``b`` (another gathered slab state or a single-device
    scene), and the body fields.  A field in ``x0`` (the start state: by
    gid for a row field) is compared as the change from it, within
    STEP_RTOL of the change plus ``ulps`` x eps x max |start value|:
    a particle's position is its body's xcm plus its rotated offset, so
    a float32 position resolves the change of a few steps only to the
    ulp of the largest coordinates.  ``gate=False`` only reports."""
    x0 = x0 or {}

    def one(k, x, y):
        floor = 0.0
        if k in x0:
            x, y = x - x0[k], y - x0[k]
            floor = ulps * torch.finfo(x.dtype).eps * float(
                x0[k].abs().max())
        return _slab_close(label, k, x, y, floor, gate)

    out = [one(k, a[k][ra], b[k][rb]) for k in keys]
    out += [one(k, a[k], b[k]) for k in body_keys]
    return out


def _slab_launch_gate(label, launches, want):
    for k, v in launches.items():
        check(v == want.get(k, 0), f"{label}: {k} launched {v} times, "
              f"expected {want.get(k, 0)}")


def _slab_stat(p):
    """A slab's work a step: interesting slots (rigid blob route), live
    contacts (DEM), else 0."""
    if "n_interesting" in p:
        return p.n_interesting
    if "total_tng_contacts" in p:
        return p.total_tng_contacts.sum()
    return torch.zeros((), dtype=torch.int64, device=p.device)


def _slab_steps(make, parts, n, dt, label, scheme=None):
    """``n`` steps of ``make()``'s step from ``parts``; on an overflow
    (the cull's row capacity, the halo or the local grid) the rigid
    scheme's capacity boost is raised 1.5x and the run repeated, as the
    Solver's rule does.  Returns (end parts, launches, per-step n_interesting
    or live contacts as tensors, seconds)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    for attempt in range(5):
        step = make()
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a, stats = parts, []
        for _ in range(n):
            a = step(a, dt)
            stats.append(torch.stack([_slab_stat(p).to(a[0].device)
                                      for p in a]))
        torch.cuda.synchronize()
        el = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        if not any(bool(p.nbr_overflow) for p in a):
            return a, launches, torch.stack(stats).cpu().numpy(), el
        check(scheme is not None and attempt < 4,
              f"{label}: overflow in the slab steps")
        scheme.capacity_boost = float(scheme.capacity_boost) * 1.5
        print(f"[{label}] overflow: capacity boost raised to "
              f"{scheme.capacity_boost:.3g}, steps repeated", flush=True)


def _single_steps(scheme, scene, label, n=SHORT_CMP):
    """``n`` single-device steps from ``scene`` under the overflow-rebuild
    rule of phase 4 (from the same start)."""
    from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb

    start = scene
    for rebuilds in range(5):
        out = trb.make_multi_step(scheme.make_step(start), n)(start, DT)
        if not bool(out.nbr_overflow):
            return out
        check(rebuilds < 4, f"{label}: single-device overflow persists")
        scheme.refresh_configs(start, grow=rebuilds > 0)
        start = scheme.adapt_scene(start)
        print(f"[{label}] single-device steps: capacity overflow, rebuilt "
              f"(x{rebuilds + 1})", flush=True)


def slab_config_for(scene, base, P, label):
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as sl

    cfg = sl.make_slab_config(scene, base, P)
    interior = base.dims[0] - 2 * base.sub
    last = interior - (P - 1) * cfg.slab_cells
    check(cfg.slab_cells >= 2 and last >= 2, f"{label}: a slab under 2 "
          f"cells wide (slab_cells {cfg.slab_cells}, last {last})")
    print(f"[{label}] P={P}: slab_cells {cfg.slab_cells} of {interior} "
          f"interior columns (last slab {last}), n_cap {cfg.n_cap}, "
          f"halo_cap {cfg.halo_cap}, nc_max_local {cfg.nc_max_local}, "
          f"O {base.O}", flush=True)
    return cfg


def largest_slab_count(base):
    """The most slabs with every slab at least 2 interior cell columns."""
    interior = base.dims[0] - 2 * base.sub
    for P in range(interior // 2, 0, -1):
        w = -(-interior // P)
        if w >= 2 and interior - (P - 1) * w >= 2:
            return P
    return 1


def slab_k2_per_slab(step, parts, cfg, scheme, label, every_slot=False):
    """K1 and K2 on each slab's extended scene (the slab step's own
    exchange), against their twins, timed: the culled rows of a slab
    with interesting slots, or every slot.  Returns per-slab numbers."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as sl

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    lcfg = sl.local_grid_config(cfg)
    _, exts, _ = step.exchange(parts, DT)
    out = []
    for d, e in enumerate(exts):
        with sl.on_device(e.device):
            t = _slab_k2(e, d, lcfg, kernel, scheme, label, every_slot)
        if t is not None:
            out.append(t)
    check(len(out) > 0, f"{label}: no slab with interesting slots")
    return out


def _slab_k2(e, d, lcfg, kernel, scheme, label, every_slot):
    """K1 and K2 on slab d's extended scene ``e`` (None: no interesting
    slot)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    from rigid_body_2d_3d_pysph_tpu_torch.ops import pack_expand as tpe

    S = e.meta.total_no_bodies
    init = 4.0 * e.meta.spacing0
    grid, pt, dfT = tck.pack_scene(e, lcfg, want_dense_pos=True)
    sent = torch.tensor(tck.sent_fields(scheme.dim == 2),
                        device=e.device)
    k1 = (pt.sorted_fields, pt.base, pt.cnt, sent, lcfg.M)
    check(torch.equal(dfT, tpe.expand_slots_reference(*k1)),
          f"{label} slab {d}: pack expansion != twin")
    check(not bool(grid.overflow), f"{label} slab {d}: grid overflow")
    n_int = int(tck.select_queries(dfT, grid, pt, lcfg,
                                   scheme.ni_max(lcfg))[4])
    if n_int == 0:
        return None
    if every_slot:
        t, _ = contact_all_slots(dfT, grid, lcfg, kernel, S, init,
                                 f"{label} slab {d} every slot",
                                 timed=True)
        t["bound"] = t["bound_ms"]
    else:
        t = contact_rows(dfT, grid, pt, lcfg, kernel, S, init,
                         scheme.ni_max(lcfg), f"{label} slab {d}")[0]
    t.update(slab=d, n=int(e.active.sum()), n_int=n_int,
             pack_ms=cuda_ms(lambda: tpe.expand_slots(*k1)))
    return t


def phase_slab_rigid(scheme, scene, dx, smi, label, P, devices=None,
                     routes=("blob",), long_steps=0, single_steps=0,
                     one_slab_ref=False):
    """The rigid slab step (``parallel/slab.py``) on ``P`` slabs of
    ``devices`` (default: P slabs on the first card): for each route,
    SHORT_CMP kernel steps against as many single-device steps and
    steps of the slab step on the kernels' plain versions, from one state with
    the bodies sliding (SLAB_SLIDE; particle and body velocities within
    STEP_RTOL, positions and xcm as the change from the start state
    within STEP_RTOL of it plus SLAB_ULPS ulp, by gid); P x (K1, K2)
    launches a step and nothing else; K1 and K2 on
    each slab's extended scene against their twins, timed.  The
    single-device steps are the scheme's ``make_step``, or with
    ``one_slab_ref`` the slab step on one slab of one device (the same
    float64 body sums: ``make_step`` sums in float32, whose rounding the
    3D cubes' contact amplifies past STEP_RTOL in 20 steps; its numbers
    are printed, not gated).  Then, with
    ``long_steps``, that many blob steps in chunks of 50 with an
    on-device redistribution after each, under phase 4's gates, and the
    steps/s of P slabs and (``single_steps``) of one slab.  Returns the
    numbers."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as sl
    from rigid_body_2d_3d_pysph_tpu_torch.parallel.mesh import make_mesh

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    base = scheme.cell_config(scene, kernel)
    scene = sl.attach_gids(scene)
    cfg = slab_config_for(scene, base, P, label)
    mesh = make_mesh(P, devices or [scene.device] * P)
    dim = scheme.dim
    keys = ("x", "y", "z")[:dim] + ("u", "v", "w")[:dim]
    body = ("xcm", "vcm", "omega")
    # the start state (rows in gid order): positions and xcm compared as
    # their change from it
    x0 = {k: scene[k].clone() for k in ("x", "y", "z")[:dim] + ("xcm",)}
    rng = np.random.default_rng(17)
    slide = rng.uniform(-SLAB_SLIDE, SLAB_SLIDE, (scene.meta.nb, 3))
    slide[:, 2 if dim == 2 else 1] = 0.0   # 3D: sliding on the floor
    rest, scene = scene, scheme.set_linear_velocity(scene, slide)
    res = dict(P=P, slab_cells=cfg.slab_cells, launches={}, k2={})
    single = None
    for route in routes:
        rl = f"{label} {route}"
        parts0 = sl.shard_slab_scene(
            sl.slab_decompose(scene, cfg, use_blob=route == "blob"), mesh)
        a, launches, stats, _ = _slab_steps(
            lambda: sl.make_slab_step(scheme, parts0, mesh, cfg), parts0,
            SHORT_CMP, DT, rl, scheme)
        _slab_launch_gate(rl, launches, dict(
            pack_expand=P * SHORT_CMP, contact=P * SHORT_CMP))
        res["launches"][route] = launches
        if route == "blob":
            check(bool((stats.max(1) > 0).all()), f"{rl}: a step with no "
                  "interesting slot on any slab")
        b, _, _, _ = _slab_steps(
            lambda: sl.make_slab_step(scheme, parts0, mesh, cfg,
                                      plain=True), parts0, SHORT_CMP,
            DT, rl + " plain")
        if single is None:
            single = _single_steps(scheme, scene, label)
        ga, ra = _slab_gathered(a)
        gb, rb = _slab_gathered(b)
        check(ra.shape[0] == scene.n, f"{rl}: {ra.shape[0]} active rows "
              f"for {scene.n} particles")
        all_rows = torch.arange(scene.n, device=scene.device)
        ref, ref_rows, ref_name = single, all_rows, "single-device steps"
        if one_slab_ref:
            print(f"[{label}] {route} route: vs make_step (float32 body "
                  f"sums; not gated): " + ", ".join(_slab_compare(
                      rl, ga, ra, single, all_rows, keys, body, x0,
                      gate=False)), flush=True)
            cfg1 = slab_config_for(scene, base, 1, f"{rl} P=1")
            mesh1 = make_mesh(1, [scene.device])
            parts1 = sl.shard_slab_scene(sl.slab_decompose(
                scene, cfg1, use_blob=route == "blob"), mesh1)
            # one slab culls more rows than any of the P: its overflow
            # boost stays out of the P-slab measurements that follow
            boost = scheme.capacity_boost
            one, _, _, _ = _slab_steps(
                lambda: sl.make_slab_step(scheme, parts1, mesh1, cfg1),
                parts1, SHORT_CMP, DT, rl + " P=1", scheme)
            scheme.capacity_boost = boost
            ref, ref_rows = _slab_gathered(one)
            ref_name = "steps of one slab"
        w1 = _slab_compare(f"{rl} vs {ref_name}", ga, ra, ref, ref_rows,
                           keys, body, x0, SLAB_ULPS)
        w2 = _slab_compare(f"{rl} vs plain", ga, ra, gb, rb, keys, body, x0,
                           SLAB_ULPS)
        print(f"[{label}] {route} route: {SHORT_CMP} slab steps "
              f"(interesting slots a slab a step max "
              f"{int(stats.max()) if route == 'blob' else '-'}) vs "
              f"{SHORT_CMP} {ref_name}: " + ", ".join(w1), flush=True)
        print(f"[{label}] {route} route: {SHORT_CMP} kernel slab steps "
              f"vs {SHORT_CMP} plain slab steps: " + ", ".join(w2),
              flush=True)
        step = sl.make_slab_step(scheme, a, mesh, cfg)
        res["k2"][route] = slab_k2_per_slab(step, a, cfg, scheme, rl,
                                            every_slot=route == "full")
        del a, b, ga, gb, parts0
    if long_steps:
        res.update(slab_rigid_long(scheme, rest, dx, smi, label, cfg, mesh,
                                   long_steps))
    if single_steps:
        cfg1 = slab_config_for(rest, base, 1, f"{label} P=1")
        mesh1 = make_mesh(1, [rest.device])
        res["sps_p1"] = slab_rigid_long(
            scheme, rest, dx, smi, f"{label} P=1", cfg1, mesh1,
            single_steps)["sps"]
    return res


def slab_rigid_long(scheme, scene, dx, smi, label, cfg, mesh, n_steps):
    """``n_steps`` blob slab steps in chunks of CHUNK with an on-device
    redistribution after each chunk (the overflow rule on a chunk that
    overflows), under phase 4's gates.  Returns launches and steps/s."""
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as sl

    P = mesh.size
    parts = sl.shard_slab_scene(sl.slab_decompose(scene, cfg, True), mesh)
    redis = sl.make_slab_redistribute(parts, mesh, cfg)
    done, chunk_s, launches = 0, [], {}
    xcm0 = scene.xcm.clone()
    n_int = []
    while done < n_steps:
        start = parts
        parts, lc, stats, el = _slab_steps(
            lambda: sl.make_slab_step(scheme, start, mesh, cfg), start,
            CHUNK, DT, label, scheme)
        _slab_launch_gate(label, lc, dict(pack_expand=P * CHUNK,
                                          contact=P * CHUNK))
        for k, v in lc.items():
            launches[k] = launches.get(k, 0) + v
        t0 = time.perf_counter()
        parts = redis(parts)
        torch.cuda.synchronize()
        el_r = time.perf_counter() - t0
        check(not any(bool(p.nbr_overflow) for p in parts),
              f"{label}: overflow in the redistribution")
        chunk_s.append(el + el_r)
        n_int.append(stats.max(1))
        done += CHUNK
        print(f"[{label}] steps {done - CHUNK}-{done}: {el:.3f} s + "
              f"redistribution {el_r * 1e3:.2f} ms, interesting slots a "
              f"step (max over slabs) {int(stats.max(1).min())}-"
              f"{int(stats.max(1).max())}", flush=True)
    g, _ = _slab_gathered(parts)
    S = g.meta.total_no_bodies
    for k, v in g.fields.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{label}: non-finite {k}")
    ov = float(g.slot_blob[:, 21 * S:22 * S].max())
    check(ov > 0, f"{label}: no overlap: the contact kernel did no work")
    d = scheme.dim
    drift = float((g.xcm[:, :d] - xcm0[:, :d]).norm(dim=1).max())
    check(drift < 2 * dx, f"{label}: COM drift {drift:.3e} >= 2 dx")
    fall = 0.5 * G * (done * DT) ** 2
    drop = float((xcm0[:, 1] - g.xcm[:, 1]).max())
    check(drop < 0.5 * fall, f"{label}: a block dropped {drop:.3e}, >= "
          f"half the free-fall distance {fall:.3e}")
    steady = chunk_s[1:] or chunk_s
    sps = CHUNK * len(steady) / sum(steady)
    print(f"[{label}] P={P} n={scene.n} steps={done} launches "
          f"pack={launches['pack_expand']} contact={launches['contact']} "
          f"({P} each a step) | max overlap {ov:.4e} ({ov / dx:.3f} dx) | "
          f"max COM drift {drift:.4e} | max drop {drop:.4e} (free fall "
          f"{fall:.4e}) | {sps:.2f} steps/s steady (chunks 2+, with the "
          f"redistributions), on {smi}", flush=True)
    return dict(launches_long=launches, sps=sps)


def phase_slab_dem(smi, P, dev, timings):
    """The DEM slab step on phase 7's column, P slabs on ``dev``:
    SHORT_CMP kernel steps against as many single-device steps and plain
    slab steps
    (positions as displacements, velocities, spin, force and torque
    within STEP_RTOL; the tables equal as gid-keyed (partner, dem) ->
    spring maps); P x (K1, K4) launches a step; live contacts every step;
    an on-device redistribution keeps the tables; K4 on each slab's
    extended scene against its twin, timed; then 100 steps in chunks of
    50 with a redistribution after each.  Returns the numbers."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as sl
    from rigid_body_2d_3d_pysph_tpu_torch.parallel.mesh import make_mesh

    label = "slab-dem-2d"
    scheme, scene = dem_scene(dev, 2)
    scene = sl.attach_gids(scene)
    n = scene.n
    cfg = slab_config_for(scene, scheme.cell_config(scene), P, label)
    mesh = make_mesh(P, [dev] * P)
    parts0 = sl.shard_slab_scene(sl.slab_decompose(scene, cfg), mesh)
    make = lambda plain=False: (
        lambda: sl.make_slab_dem_step(scheme, parts0, mesh, cfg, n,
                                      plain=plain))
    a, launches, live, el = _slab_steps(make(), parts0, SHORT_CMP,
                                        DEM_DT, label)
    _slab_launch_gate(label, launches, dict(pack_expand=P * SHORT_CMP,
                                            dem_cell=P * SHORT_CMP))
    check(bool((live.sum(1) > 0).all()), f"{label}: a step with no live "
          "contact")
    b, _, _, _ = _slab_steps(make(True), parts0, SHORT_CMP, DEM_DT,
                             label + " plain")
    single = scene
    sstep = scheme.make_step(scene)
    for _ in range(SHORT_CMP):
        single = sstep(single, DEM_DT)
    torch.cuda.synchronize()
    check(not bool(single.nbr_overflow), f"{label}: single-device overflow")
    ga, ra = _slab_gathered(a)
    gb, rb = _slab_gathered(b)
    check(ra.shape[0] == n, f"{label}: {ra.shape[0]} active rows for {n}")
    keys = ("x", "y", "u", "v", "wz", "fx", "fy", "torz")
    x0 = {k: scene[k] for k in ("x", "y")}
    all_rows = torch.arange(n, device=dev)
    w1 = _slab_compare(f"{label} vs single device", ga, ra, single,
                       all_rows, keys, x0=x0)
    w2 = _slab_compare(f"{label} vs plain", ga, ra, gb, rb, keys, x0=x0)

    def tables(sc, rows):
        t = sc.with_fields(**{k: sc[k][rows] for k in (
            "tng_idx", "tng_idx_dem_id", "tng_x", "tng_y", "tng_z")})
        return _sorted_tables(t)

    def same_tables(what, p, q):
        (ka, sa), (kb, sb) = p, q
        rows = int((ka != kb).any(1).sum())
        check(rows == 0, f"{label}: {what}: {rows} rows hold other "
              "contacts")
        d = (sa - sb).abs()
        check(bool((d <= STEP_RTOL * sb.abs()
                    + STEP_RTOL * float(sb.abs().max())).all()),
              f"{label}: {what}: springs off by {float(d.max()):.3e}")
        return float(d.max())

    ta = tables(ga, ra)
    e1 = same_tables("vs single device", ta, tables(single, all_rows))
    e2 = same_tables("vs plain", ta, tables(gb, rb))
    redis = sl.make_slab_redistribute(a, mesh, cfg)
    a2 = redis(a)
    check(not any(bool(p.nbr_overflow) for p in a2),
          f"{label}: overflow in the redistribution")
    g2, r2 = _slab_gathered(a2)
    same_tables("after the redistribution", tables(g2, r2), ta)
    print(f"[{label}] {SHORT_CMP} slab steps vs {SHORT_CMP} "
          f"single-device steps: " + ", ".join(w1) + f"; tables equal as "
          f"gid-keyed maps (springs {e1:.3e})", flush=True)
    print(f"[{label}] {SHORT_CMP} kernel slab steps vs {SHORT_CMP} "
          f"plain slab steps: " + ", ".join(w2) + f"; tables equal (springs "
          f"{e2:.3e}); after an on-device redistribution the tables are "
          "the same gid-keyed maps", flush=True)

    # K4 on each slab's extended scene (tables translated to rows, as
    # the step does), against its twin, timed
    step = make()()
    _, exts, _ = step.exchange(a2, DEM_DT)
    lcfg = sl.local_grid_config(cfg)
    per = []
    for d, e in enumerate(exts):
        if int(e.is_rigid.sum()) == 0:
            continue
        row = tdk.gid_rows(e, n)[torch.clamp(e.tng_idx.long(), 0, n)]
        idx = torch.where((e.tng_idx >= 0) & (row < e.n), row,
                          -1).to(torch.int32)
        tabs = (idx, e.tng_idx_dem_id, e.tng_x, e.tng_y, e.tng_z)
        kern, plain, args, grid, lanes = dem_kernel_call(scheme, e, lcfg,
                                                         tabs)
        check(not bool(grid.overflow), f"{label} slab {d}: grid overflow")
        got, ref = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err, spring_err = dem_compare(got, ref, f"{label} slab {d}")
        gated = int(ref[0][:, 7].sum())
        L = idx.shape[1]
        n_bytes = 4 * int(e.active.sum()) * (tdk.NF + 8 + 2 * 5 * L)
        bms, bby = bound(n_bytes, lanes * OPS_PER_LANE
                         + gated * OPS_PER_DEM_PAIR)
        t = dict(slab=d, n=int(e.active.sum()), gated=gated, lanes=lanes,
                 err=max(err, spring_err), ms=cuda_ms(lambda: kern(*args)),
                 plain_ms=cuda_ms(lambda: plain(*args), reps=3, warmup=1),
                 bound_ms=bms, bound_by=bby)
        print(f"[{label}] slab {d}: K4 on {t['n']} rows with ghosts, "
              f"{gated} gated pairs, {lanes} candidate lanes: "
              f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, bound "
              f"{bms:.4f} ms by {bby}); tables exact, max abs err "
              f"{t['err']:.3e}", flush=True)
        per.append(t)
    check(len(per) > 0, f"{label}: no slab holds grains")
    timings[label] = per

    # 100 steps in chunks of 50, a redistribution after each
    parts, done, chunk_s, tot = a2, 0, [], {}
    while done < 2 * CHUNK:
        start = parts
        parts, lc, live, el = _slab_steps(
            lambda: sl.make_slab_dem_step(scheme, start, mesh, cfg, n),
            start, CHUNK, DEM_DT, label)
        _slab_launch_gate(label, lc, dict(pack_expand=P * CHUNK,
                                          dem_cell=P * CHUNK))
        check(bool((live.sum(1) > 0).all()), f"{label}: a step with no "
              "live contact")
        for k, v in lc.items():
            tot[k] = tot.get(k, 0) + v
        t0 = time.perf_counter()
        parts = redis(parts)
        torch.cuda.synchronize()
        chunk_s.append(el + time.perf_counter() - t0)
        check(not any(bool(p.nbr_overflow) for p in parts),
              f"{label}: overflow in the redistribution")
        done += CHUNK
    g, _ = _slab_gathered(parts)
    for k, v in g.fields.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{label}: non-finite {k}")
    sps = CHUNK * len(chunk_s[1:]) / sum(chunk_s[1:])
    print(f"[{label}] P={P} n={n} {SHORT_CMP} + {done} steps, launches "
          f"{tot} ({P} K1 and {P} K4 a step) | live contacts every step | "
          f"{sps:.2f} steps/s (chunk 2, with its redistribution), on {smi}",
          flush=True)
    tot = {k: launches.get(k, 0) + tot.get(k, 0) for k in launches}
    return dict(launches=launches, launches_long=tot, sps=sps, P=P)


# the coupling slab step's kernel launches a slab a step, by ordering
CPL_SLAB_KERNELS = dict(
    kdk=dict(pack_expand=2, fluid_rates=1, wall_bc=1, fluid_forces=1,
             contact=1),
    kdkf=dict(pack_expand=1, fluid_rates_wall=1, fluid_forces=1, contact=1))


def slab_grid_x(base, scene):
    """``base`` cut in x to the particles' extent plus two cells a side
    and the boundary ring: the scheme's grid pads 0.75 x the extent a
    side, which leaves the outer slabs of a decomposition of a tank empty
    (its particles stay inside their walls)."""
    import dataclasses

    x = scene.x[scene.active]
    lo = float(x.min()) - (2 + base.sub) * base.cell
    nx = int(np.ceil((float(x.max()) - lo) / base.cell)) + 2 + base.sub
    return dataclasses.replace(base, origin=(lo,) + tuple(base.origin[1:]),
                               dims=(nx,) + tuple(base.dims[1:]))


def _slab_cpl_kernels(scheme, s, e, d, lcfg, label, ordering):
    """K1, the ordering's fluid passes (kdk: B6a, B6b, B6c with bodies;
    kdkf: B4, B6c) and K2 on every slot of the contact pack
    (``coupling_contact_pack``) on slab d's extended scene ``e`` (local
    rows ``s``), against their plain versions, timed with their bounds."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as sl

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    lab = f"{label} slab {d}"
    S = e.meta.total_no_bodies
    init = 4.0 * e.meta.spacing0
    grid, pt, dfT = fk.pack_fluid_sorted(e, lcfg)
    check(not bool(grid.overflow), f"{lab}: grid overflow")
    k1 = {}
    pack_expand_check(pt, dfT, lcfg, lab, k1)
    names = (["fluid_rates", "wall_bc", "fluid_forces_rigid"]
             if ordering == "kdk" else
             ["fluid_rates_wall", "fluid_forces_rigid"])
    out, work, _ = fluid_pass_checks(
        fluid_calls(scheme, dfT, grid.nbr_slots, kernel, lcfg.radius, S,
                    init, names),
        dfT, grid.nbr_slots, pt, lcfg.radius, S, init,
        abs(scheme.fluid_alpha) > 1e-14, lab, True)
    cdfT = sl.coupling_contact_pack(dfT.clone(), grid, e, s.n,
                                    scheme.dim == 2)
    out["contact_all_slots"], n_pick = contact_all_slots(
        cdfT, grid, lcfg, kernel, S, init, lab, True)
    out["pack_expand"] = k1[lab]
    n_ghost_rigid = int((e.is_rigid[s.n:] & e.active[s.n:]).sum())
    print(f"[{label}] slab {d}: {int(e.active.sum())} active of {e.n} rows "
          f"({s.n} local, {e.n - s.n} ghost; {n_ghost_rigid} rigid ghosts), "
          f"NC {lcfg.NC_max}, query lanes "
          f"{int(pt.n_valid)}, pairs {work['in_range']}, K2 lanes with a "
          f"pick {n_pick} | max abs err " + ", ".join(
              f"{k} {v['err']:.3e}" for k, v in out.items()
              if "err" in v), flush=True)
    print_fluid_passes(label, f"slab {d}", out)
    return dict(slab=d, n=int(e.active.sum()), ghost_rigid=n_ghost_rigid,
                **out)


def phase_slab_coupling(smi, dev, ordering, dim, P, timings, long_steps=0,
                        single_steps=0, n_target=CPL_N):
    """The coupling slab step (``make_slab_coupling_step``) in
    ``ordering`` on P slabs of the card, the grid cut to the tank in x
    (``slab_grid_x``).  2D: phase 13's placement (the box of rho
    CPL_PARITY_RHO on the floor, pushed down and sideways); 3D: phase
    19's box (``n_target`` particles).  SHORT_CMP kernel slab steps
    against as many single-device steps of the ordering and plain slab
    steps, by gid
    (positions as their change, SLAB_ULPS; the 3D box's omega, which is
    rounding, printed only); P x the ordering's kernels a step and nothing
    else; each slab's K1, fluid passes and K2 against their plain
    versions, timed.  Then, with ``long_steps``, that many steps of the
    sinking box (phase 11's) in chunks of CHUNK with an on-device
    redistribution after each, under phase 11's gates, and with
    ``single_steps`` the steps/s of one slab.  Returns the numbers."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as sl
    from rigid_body_2d_3d_pysph_tpu_torch.parallel.mesh import make_mesh

    label = f"slab-coupling-{ordering}-{dim}d"
    t0 = time.perf_counter()
    if dim == 2:
        scheme, scene, dt = sinking_box_scene(dev, n_target, floor=True,
                                              rho_b=CPL_PARITY_RHO)
        scene = scene.replace(vcm=torch.tensor(
            [[0.05, -0.5, 0.0]], dtype=scene.dtype, device=dev))
    else:
        scheme, scene = sinking_box_scene_3d(dev, n_target)
        dt = 0.25 * scheme.h / (1.1 * scheme.c0)
    scheme.gtvf_ordering = ordering
    scene = sl.attach_gids(scene)
    kernel = get_kernel(scheme.kernel_name, dim)
    base = slab_grid_x(scheme.cell_config(scene, kernel), scene)
    print(f"[{label}] n={scene.n} dt={dt:.6g} ({time.perf_counter() - t0:.1f}"
          " s set-up)", flush=True)
    cfg = slab_config_for(scene, base, P, label)
    mesh = make_mesh(P, [dev] * P)
    per_step = {k: P * v for k, v in CPL_SLAB_KERNELS[ordering].items()}
    parts0 = sl.shard_slab_scene(sl.slab_decompose(scene, cfg, False), mesh)
    make = lambda plain=False: (lambda: sl.make_slab_coupling_step(
        scheme, parts0, mesh, cfg, plain=plain))
    a, launches, _, _ = _slab_steps(make(), parts0, SHORT_CMP, dt, label)
    _slab_launch_gate(label, launches, {k: v * SHORT_CMP
                                        for k, v in per_step.items()})
    b, _, _, _ = _slab_steps(make(True), parts0, SHORT_CMP, dt,
                             label + " plain")
    single = scene
    sstep = scheme.make_step(scene)
    for _ in range(SHORT_CMP):
        single = sstep(single, dt)
    torch.cuda.synchronize()
    check(not bool(single.nbr_overflow), f"{label}: single-device overflow")
    ga, ra = _slab_gathered(a)
    gb, rb = _slab_gathered(b)
    check(ra.shape[0] == scene.n, f"{label}: {ra.shape[0]} active rows for "
          f"{scene.n} particles")
    if dim == 2:
        for g, who in ((ga, "kernel"), (gb, "plain")):
            check(float(g.overlap.max()) > 0, f"{label}: the {who} slab run "
                  "ended out of contact")
    keys = ("x", "y", "z")[:dim] + ("u", "v", "w")[:dim] + ("rho", "p")
    # the 3D box does not turn: its omega (~1e-12) is the rounding of
    # the torque sums, printed and not gated
    body = ("xcm", "vcm", "omega") if dim == 2 else ("xcm", "vcm")
    x0 = {k: scene[k] for k in ("x", "y", "z")[:dim] + ("xcm",)}
    all_rows = torch.arange(scene.n, device=dev)
    w1 = _slab_compare(f"{label} vs single device", ga, ra, single, all_rows,
                       keys, body, x0, SLAB_ULPS)
    w2 = _slab_compare(f"{label} vs plain", ga, ra, gb, rb, keys, body, x0,
                       SLAB_ULPS)
    if dim == 3:
        w1 += _slab_compare(label, ga, ra, single, all_rows, (), ("omega",),
                            gate=False)
        w2 += _slab_compare(label, ga, ra, gb, rb, (), ("omega",),
                            gate=False)
    print(f"[{label}] {SHORT_CMP} slab steps vs {SHORT_CMP} "
          f"single-device steps: " + ", ".join(w1), flush=True)
    print(f"[{label}] {SHORT_CMP} kernel slab steps vs {SHORT_CMP} "
          f"plain slab steps: " + ", ".join(w2), flush=True)

    # the passes on the slabs' extended scenes of the comparisons' first
    # step (phases 10 and 14 hold the single-device passes on the
    # set-up state too: after 20 steps of the dense box driven into the
    # floor, B6c's float32 sums on an outer slab read 6.6e-5 of the
    # column's largest magnitude apart, over FLUID_SUM_RTOL)
    lcfg = sl.local_grid_config(cfg)
    locs, exts, _ = sl.make_slab_coupling_step(scheme, parts0, mesh,
                                               cfg).exchange(parts0, dt)
    per = []
    for d, (s, e) in enumerate(zip(locs, exts)):
        with sl.on_device(e.device):
            per.append(_slab_cpl_kernels(scheme, s, e, d, lcfg, label,
                                         ordering))
    check(any(t["ghost_rigid"] > 0 for t in per), f"{label}: no slab "
          "received rigid ghost rows")
    timings[label] = per
    res = dict(P=P, launches=launches)
    del a, b, ga, gb, parts0, single, locs, exts
    if long_steps or single_steps:
        lscheme, lscene, ldt = sinking_box_scene(dev, n_target)
        lscheme.gtvf_ordering = ordering
        lscene = sl.attach_gids(lscene)
        lbase = slab_grid_x(lscheme.cell_config(lscene, kernel), lscene)
    if long_steps:
        lcfg = slab_config_for(lscene, lbase, P, f"{label} long")
        res.update(slab_coupling_long(lscheme, lscene, smi, label, lcfg,
                                      mesh, ldt, long_steps, per_step))
    if single_steps:
        cfg1 = slab_config_for(lscene, lbase, 1, f"{label} P=1")
        res["sps_p1"] = slab_coupling_long(
            lscheme, lscene, smi, f"{label} P=1", cfg1, make_mesh(1, [dev]),
            ldt, single_steps,
            dict(CPL_SLAB_KERNELS[ordering]))["sps"]
    return res


def slab_coupling_long(scheme, scene, smi, label, cfg, mesh, dt, n_steps,
                       per_step):
    """``n_steps`` coupling slab steps in chunks of CHUNK with an
    on-device redistribution after each, under phase 11's gates (the
    launches a step, finiteness, no overflow, fluid rho within 5 % of
    rho0, the box lower at the end of a run of CPL_STEPS or more).
    Returns launches and steps/s."""
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as sl

    P = mesh.size
    parts = sl.shard_slab_scene(sl.slab_decompose(scene, cfg, False), mesh)
    redis = sl.make_slab_redistribute(parts, mesh, cfg)
    y0 = float(scene.xcm[0, 1])
    done, chunk_s, launches = 0, [], {}
    while done < n_steps:
        start = parts
        parts, lc, _, el = _slab_steps(
            lambda: sl.make_slab_coupling_step(scheme, start, mesh, cfg),
            start, CHUNK, dt, label)
        _slab_launch_gate(label, lc, {k: v * CHUNK
                                      for k, v in per_step.items()})
        for k, v in lc.items():
            launches[k] = launches.get(k, 0) + v
        t0 = time.perf_counter()
        parts = redis(parts)
        torch.cuda.synchronize()
        el_r = time.perf_counter() - t0
        check(not any(bool(p.nbr_overflow) for p in parts),
              f"{label}: overflow in the redistribution")
        chunk_s.append(el + el_r)
        done += CHUNK
        print(f"[{label}] steps {done - CHUNK}-{done}: {el:.3f} s + "
              f"redistribution {el_r * 1e3:.2f} ms", flush=True)
    g, _ = _slab_gathered(parts)
    for k, v in g.fields.items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"{label}: non-finite {k}")
    fl = g.is_fluid & g.active
    dev_rho = float((g.rho[fl] / scheme.rho0 - 1.0).abs().max())
    check(dev_rho < 0.05, f"{label}: fluid rho off rho0 by {dev_rho:.3e}")
    y1 = float(g.xcm[0, 1])
    if n_steps >= CPL_STEPS:
        # as in phase 11: at y = 3 the box's float32 COM moves once a
        # step's displacement passes half an ulp, after ~100 steps
        check(y1 < y0, f"{label}: the box did not sink ({y0:.7f} -> "
              f"{y1:.7f})")
    steady = chunk_s[1:] or chunk_s
    sps = CHUNK * len(steady) / sum(steady)
    print(f"[{label}] P={P} n={scene.n} steps={done} launches "
          + " ".join(f"{k}={v}" for k, v in launches.items() if v)
          + f" | max |rho/rho0 - 1| {dev_rho:.3e} | box COM y {y0:.7f} -> "
          f"{y1:.7f} | {sps:.2f} steps/s steady (chunks 2+, with the "
          f"redistributions), on {smi}", flush=True)
    return dict(launches_long=launches, sps=sps)


# ---------------------------------------------------------------------------
# the wide kernel instances (phases 44-46)
# ---------------------------------------------------------------------------

def _picks_past(out, S, init, first=64):
    """Query lanes of the K2 output ``out`` with a pick from an entity
    slot >= ``first`` (past the narrow instance's 64)."""
    return int((out[..., 5 * S + first:6 * S] < init).any(-1).sum())


def wide_k2_rows(scheme, scene, label):
    """K2 on every interesting row and on every slot of ``scene``'s pack
    (seeded random velocities) against its twin, both timed: (numbers of
    the rows, of every slot)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    kernel = get_kernel(scheme.kernel_name, scheme.dim)
    cfg = scheme.cell_config(scene, kernel)
    S = scene.meta.total_no_bodies
    init = 4.0 * scene.meta.spacing0
    check(tck.contact_instance(S)[0] == "wide", f"{label}: S={S} takes "
          "the narrow instance")
    grid, pt, dfT = tck.pack_scene(seeded_velocities(scene, scheme.dim, 7),
                                   cfg, want_dense_pos=True)
    check(not bool(grid.overflow), f"{label}: grid overflow")
    n_int = int(tck.select_queries(dfT, grid, pt, cfg, cfg.NC_max)[4])
    rows, out, _, valid = contact_rows(dfT, grid, pt, cfg, kernel, S, init,
                                       n_int, f"{label} rows", plain_reps=1)
    past = _picks_past(out[valid], S, init)
    check(past > 0, f"{label}: no pick from an entity past 64")
    del out
    slots, n_pick = contact_all_slots(dfT, grid, cfg, kernel, S, init,
                                      f"{label} every slot", timed=True,
                                      plain_reps=1)
    check(n_pick > 0, f"{label}: no pick on every slot")
    rows.update(S=S, n=scene.n, picks_past_64=past)
    slots.update(S=S, n=scene.n)
    return rows, slots


def phase_wide_rigid(dev, smi):
    """Phase 44: the 2D resting stack of WIDE_BLOCKS blocks (S = 129):
    K2's wide instance on every interesting row and on every slot against
    its twin, then the GTVF main path through ``make_multi_step`` in
    chunks of CHUNK (phase 4's gates; every K2 launch the wide
    instance), 20 kernel steps against 20 twin steps from its end with
    one K1 and one K2 a kernel step; then K2 at S = 300 (WIDE_300 blocks,
    set up for RK2: the full schema) on every interesting row and every
    slot.  Returns the numbers."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    out = {}
    t0 = time.perf_counter()
    scheme, scene, dx = contact_scene_2d(dev, n_bodies=WIDE_BLOCKS,
                                         cols=WIDE_COLS)
    print(f"[wide-setup] 2D stack: n={scene.n} S="
          f"{scene.meta.total_no_bodies} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    out["rows"], out["slots"] = wide_k2_rows(scheme, scene, "wide 2D S=129")
    end, launches, stats = phase_main_path(scheme, scene, dx, smi,
                                           "wide-rigid-2d", WIDE_STEPS,
                                           multi=True)
    check(launches.get("contact/wide", 0) == launches["contact"] > 0,
          f"wide-rigid-2d: {launches.get('contact/wide', 0)} wide K2 "
          f"launches of {launches['contact']}")
    _build.reset_launches()
    phase_step_parity(scheme, end, "wide-parity-2d")
    got = (_build.LAUNCHES["pack_expand"], _build.LAUNCHES["contact"],
           _build.LAUNCHES_INSTANCE.get("contact/wide", 0))
    check(got == (COMPARE_STEPS,) * 3, f"wide-parity-2d: K1, K2, wide K2 "
          f"launched {got} times in {COMPARE_STEPS} kernel steps")
    out.update(launches=launches, stats=stats)
    del scheme, scene, end
    t0 = time.perf_counter()
    scheme, scene, _ = contact_scene_2d(dev, n_bodies=WIDE_300,
                                        cols=WIDE_300_COLS, integrator="rk2")
    print(f"[wide-setup] 2D stack: n={scene.n} S="
          f"{scene.meta.total_no_bodies} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    out["rows_300"], out["slots_300"] = wide_k2_rows(scheme, scene,
                                                     "wide 2D S=300")
    return out


def phase_wide_3d_b5(dev, smi):
    """Phase 45: K2's wide instance on every slot of WIDE_CUBES cubes
    (S = 65; the leapfrog step's launch) against its twin, timed; B5 on
    the sinking box's tank with WIDE_BOX_ROWS x WIDE_BOX_COLS small boxes
    of rho CPL_BOX_RHO (S = 301; the scheme's default route, the compact
    store from 97 entities, so B5 writes its contact columns by query row
    at the light cull's slots) against its twin as in phase 10, timed,
    and the same at S = 129 (WIDE_BOX_129: 8 layers of 16 boxes); the
    kdkf main path at S = 301 for CHUNK steps with the overflow rule
    (phase 11's gates but the sinking: one K1, B4 and B5 a step, every B5
    launch by query row), steps/s; then from the set-up state, each layer
    pushed down 0.5 m/s faster than the one under it, 20 kdkf kernel
    steps against 20 twin steps (STEP_RTOL).  Returns the numbers."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    out = {}
    t0 = time.perf_counter()
    scheme, scene, dx = contact_scene_3d(dev, integrator="leapfrog",
                                         layout=WIDE_CUBES)
    S = scene.meta.total_no_bodies
    print(f"[wide-setup] 3D cubes {WIDE_CUBES}: n={scene.n} S={S} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    kernel = get_kernel(scheme.kernel_name, 3)
    cfg = scheme.cell_config(scene, kernel)
    grid, _, dfT = tck.pack_scene(seeded_velocities(scene, 3, 7), cfg,
                                   want_dense_pos=True)
    check(not bool(grid.overflow), "wide 3D: grid overflow")
    out["slots_3d"], n_pick = contact_all_slots(
        dfT, grid, cfg, kernel, S, 4.0 * dx, "wide 3D S=65 every slot",
        timed=True, plain_reps=1)
    check(n_pick > 0, "wide 3D: no pick on every slot")
    out["slots_3d"].update(S=S, n=scene.n)
    del scheme, scene, grid, dfT
    t0 = time.perf_counter()
    scheme, scene, dt = boxes_tank_scene(
        dev, 2, rows=WIDE_BOX_ROWS, cols=WIDE_BOX_COLS, side=WIDE_BOX_SIDE,
        compact=None, kr=WIDE_BOX_KR, min_overlap=WIDE_BOX_OVERLAP)
    route = "compact store" if "cl_pid" in scene else "full [N, S]"
    check(scene.meta.total_no_bodies >= 300 and "cl_pid" in scene,
          f"wide boxes: S={scene.meta.total_no_bodies}, {route} route")
    out["b5"] = wide_b5_kernel(scheme, scene, dt, "wide boxes", t0)
    t1 = time.perf_counter()
    s129, sc129, dt129 = boxes_tank_scene(dev, 2, rows=WIDE_BOX_129[0],
                                          cols=WIDE_BOX_129[1],
                                          side=WIDE_BOX_129[2], compact=None)
    check(sc129.meta.total_no_bodies == 129 and "cl_pid" in sc129,
          f"wide boxes S=129: S={sc129.meta.total_no_bodies}")
    out["b5_129"] = wide_b5_kernel(s129, sc129, dt129, "wide boxes S=129",
                                   t1)
    del s129, sc129
    stats = {}
    _, launches, sps = phase_coupling_main(
        scheme, scene, dt, CHUNK, "wide-kdkf", smi,
        dict(pack_expand=1, fluid_rates_wall=1, fluid_forces_contact=1),
        sink=False, stats=stats)
    check(launches.get("fluid_forces_contact/rows", 0)
          == launches["fluid_forces_contact"] > 0, "wide-kdkf: "
          f"{launches.get('fluid_forces_contact/rows', 0)} B5 launches by "
          f"query row of {launches['fluid_forces_contact']}")
    # the set-up state with the store widened by the run's rebuilds
    scene = scheme.adapt_scene(scene)
    nb, cols = scene.meta.nb, WIDE_BOX_COLS
    push = scene.vcm.clone()
    push[:, 1] -= 0.5 * (1 + torch.arange(nb, device=push.device) // cols
                         ).to(push.dtype)
    phase_coupling_parity(scheme, scene, dt, "wide-kdkf-parity", push=push)
    out.update(launches=launches, steps_per_s=sps, route=route, **stats)
    return out


def wide_b5_kernel(scheme, scene, dt, label, t0):
    """B5 on ``scene``'s coupling pack in its kdkf step's layout against
    its twin (phase 10's checks), timed with its bound: the numbers."""
    kernel, cfg, grid, pt, dfT, S, init = fluid_scene_pack(scheme, scene,
                                                           label, 13)
    print(f"[wide-setup] {label}: n={scene.n} S={S} dt={dt:.6g} NC="
          f"{cfg.NC_max} M={cfg.M} O={cfg.O}, "
          f"{'compact store' if 'cl_pid' in scene else 'full [N, S]'} route "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    b5, work, n_found = fluid_pass_checks(
        fluid_calls(scheme, dfT, grid.nbr_slots, kernel, cfg.radius, S,
                    init, ["fluid_forces_contact"],
                    b5_layout(scheme, scene, grid, pt, dfT, cfg)),
        dfT, grid.nbr_slots, pt, cfg.radius, S, init,
        abs(scheme.fluid_alpha) > 1e-14, label, timed=True)
    check(n_found > 0, f"{label}: no contact pick")
    t = b5["fluid_forces_contact"]
    print(f"[wide-kernels] {label}: query lanes {int(pt.n_valid)}, {work}, "
          f"contact rows with a pick {n_found} | max abs err "
          f"{t['err']:.3e}; bound before the redesign's count "
          f"{t['old_bound_ms']:.4f} ms", flush=True)
    print_fluid_passes("wide-kernels", label, b5)
    return dict(t, S=S, n=scene.n)


def phase_wide_dem(dev, smi):
    """Phase 46: the DEM kernels on the 3D column at the table widths of
    WIDE_DEM: K4 and K3 against their twins (phase 6's gates on the
    tables WIDE_DEM names; on the spill grid at L = 12 also the column
    crowded to DEM_CROWD: more gated partners than slots), timed, the
    narrow instance at L = 8 among them so that each wide width's
    increment over it is measured in the same call; each through a
    CHUNK-step main path at DEM_DT_3D (phase 7's gates, every launch the
    width's instance); at L = 12 on the spill grid 20 kernel steps
    against 20 twin steps with one K4 a kernel step.  Returns {(grid,
    L): numbers}."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk

    out = {}
    for grid, L, tables in WIDE_DEM:
        label = f"3D {grid} L={L}"
        kname = "dem_cell" if grid == "spill" else "dem_rowwin"
        inst = f"{kname}/{tdk.table_instance(L)[0]}"
        t0 = time.perf_counter()
        scheme, scene = dem_scene(dev, 3, grid, L=L)
        t = {}
        first = L == 12 and grid == "spill"
        t1 = time.perf_counter()
        phase_dem_kernels(scheme, scene, label, t, crowded=first,
                          cases_run=tables, plain_reps=1)
        t2 = time.perf_counter()
        _, launches, sps = phase_dem_main(scheme, scene, CHUNK,
                                          f"wide-dem-{grid}-L{L}", smi,
                                          DEM_DT_3D)
        t3 = time.perf_counter()
        check(launches.get(inst, 0) == launches[kname] == CHUNK,
              f"{label}: {launches.get(inst, 0)} launches of {inst}, "
              f"{launches[kname]} of {kname}")
        out[(grid, L)] = dict(t[label], instance=inst,
                              launches=launches.get(inst, 0), sps=sps,
                              n=scene.n)
        if first:
            _build.reset_launches()
            phase_dem_parity(scheme, scene, label="wide-dem-parity-L12",
                             dt=DEM_DT_3D)
            got = (_build.LAUNCHES[kname],
                   _build.LAUNCHES_INSTANCE.get(inst, 0))
            check(got == (COMPARE_STEPS,) * 2, f"wide-dem-parity-L12: "
                  f"{kname}, {inst} launched {got} times in "
                  f"{COMPARE_STEPS} kernel steps")
        print(f"[wide-dem] {label}: set-up {t1 - t0:.1f} s, kernels "
              f"{t2 - t1:.1f} s, main path {t3 - t2:.1f} s"
              + (f", parity {time.perf_counter() - t3:.1f} s" if first
                 else ""), flush=True)
        del scheme, scene
    return out


def wide_kernel_entries(kernels, wide_k2, wide_b5, wide_dem, src):
    """The JSON entries of the wide instances (phases 44-46), each with
    its narrow entry's ``replaces`` and its launches from its own main
    path."""
    out = []
    by_name = {kd["name"]: kd for kd in kernels}
    wr, ws = wide_k2["rows"], wide_k2["slots"]
    wl = wide_k2["launches"]
    out.append(dict(
        name="contact_sums/wide", route="cuda", source=src + "contact.cu",
        replaces=by_name["contact_sums"]["replaces"],
        launches=wl["contact/wide"],
        launches_by_path={"wide-rigid-2d": wl["contact/wide"]},
        max_abs_err=max(wr["err"], ws["err"], wide_k2["rows_300"]["err"],
                        wide_k2["slots_300"]["err"],
                        wide_b5["slots_3d"]["err"]),
        ms=wr["ms"], plain_ms=wr["plain_ms"], bound_ms=wr["bound"],
        bound_by=wr["bound_by"], library_ms=None, S=wr["S"],
        rows=wr["rows"], old_bound_ms=wr["old_bound"],
        all_slots_ms=ws["ms"],
        all_slots_plain_ms=ws["plain_ms"], all_slots_bound_ms=ws["bound_ms"],
        all_slots_bound_by=ws["bound_by"],
        all_slots_old_bound_ms=ws["old_bound_ms"],
        all_slots_rows_unpack_ms=ws["rows_unpack_ms"],
        s300_ms=wide_k2["rows_300"]["ms"],
        s300_plain_ms=wide_k2["rows_300"]["plain_ms"],
        s300_bound_ms=wide_k2["rows_300"]["bound"],
        s300_bound_by=wide_k2["rows_300"]["bound_by"],
        s300_old_bound_ms=wide_k2["rows_300"]["old_bound"],
        s300_rows=wide_k2["rows_300"]["rows"],
        s300_all_slots_ms=wide_k2["slots_300"]["ms"],
        s300_all_slots_plain_ms=wide_k2["slots_300"]["plain_ms"],
        s300_all_slots_bound_ms=wide_k2["slots_300"]["bound_ms"],
        s300_all_slots_old_bound_ms=wide_k2["slots_300"]["old_bound_ms"],
        s300_all_slots_rows_unpack_ms=wide_k2["slots_300"]["rows_unpack_ms"],
        all_slots_ms_3d_s65=wide_b5["slots_3d"]["ms"],
        all_slots_plain_ms_3d_s65=wide_b5["slots_3d"]["plain_ms"],
        all_slots_bound_ms_3d_s65=wide_b5["slots_3d"]["bound_ms"],
        all_slots_bound_by_3d_s65=wide_b5["slots_3d"]["bound_by"],
        all_slots_old_bound_ms_3d_s65=wide_b5["slots_3d"]["old_bound_ms"],
        steps_per_s=wide_k2["stats"]["steps_per_s"]))
    b5, b129 = wide_b5["b5"], wide_b5["b5_129"]
    out.append(dict(
        name="fluid_forces_contact/rows", route="cuda",
        source=src + "fluid.cu",
        replaces=by_name["fluid_forces_contact"]["replaces"],
        launches=wide_b5["launches"]["fluid_forces_contact/rows"],
        launches_by_path={"wide-kdkf":
                          wide_b5["launches"]["fluid_forces_contact/rows"]},
        max_abs_err=max(b5["err"], b129["err"]), ms=b5["ms"],
        plain_ms=b5["plain_ms"], bound_ms=b5["bound_ms"],
        bound_by=b5["bound_by"], library_ms=None, S=b5["S"], M=b5["M"],
        old_bound_ms=b5["old_bound_ms"], s129_ms=b129["ms"],
        s129_plain_ms=b129["plain_ms"], s129_bound_ms=b129["bound_ms"],
        s129_bound_by=b129["bound_by"],
        s129_old_bound_ms=b129["old_bound_ms"],
        coupling_route=wide_b5["route"],
        steps_per_s=wide_b5["steps_per_s"]))
    for kname in ("dem_cell", "dem_rowwin"):
        grid = "spill" if kname == "dem_cell" else "rowwin"
        narrow = wide_dem[(grid, 8)]
        rows = [v for (g, L), v in sorted(wide_dem.items())
                if g == grid and v["instance"] == f"{kname}/wide"]
        d = next(r for r in rows if r["L"] == 16)
        out.append(dict(
            name=f"{kname}/wide", route="cuda",
            source=src + "dem.cu", replaces=by_name[kname]["replaces"],
            launches=rows[0]["launches"],
            launches_by_path={f"wide-dem-{grid}-L{r['L']}":
                              r["launches"] for r in rows},
            max_abs_err=max(r["err"] for r in rows), ms=d["ms"],
            plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
            bound_by=d["bound_by"], library_ms=None, L=d["L"],
            narrow_L8_ms=narrow["ms"], narrow_L8_bound_ms=narrow["bound_ms"],
            narrow_L8_steps_per_s=narrow["sps"],
            by_L={str(r["L"]): dict(
                ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                increment_ms=r["ms"] - narrow["ms"],
                increment_bound_ms=r["bound_ms"] - narrow["bound_ms"],
                steps_per_s=r["sps"]) for r in rows}))
    return out


# ---------------------------------------------------------------------------
# the classic cell grid (phases 47-49)
# ---------------------------------------------------------------------------

# the rigid scenes' classic grids: the 2D stack's with lanes from
# occupancy (M 32, O 9) and on the sub = 2 stencil (M 8, O 25), the 3D
# cubes' (M 104, O 27)
CLASSIC_RIGID = (("stack", 2, dict(spill=False)),
                 ("stack-sub2", 2, dict(sub=2)),
                 ("cubes", 3, dict(spill=False)))
# the sinking box's: at its cutoff (3 dx, h = dx) the coupling's lane
# rule (occupancy_safety 2.6) gives 32 lanes in 2D and 80 in 3D.  The 3D
# box runs on its own grid (M 80); the 2D box at 48 lanes, and the 3D
# box's split passes also at 176 (the widths the rule gives at the rigid
# scenes' 3.9 dx), set explicitly, so the passes run past one warp a slot
CLASSIC_BOX = dict(spill=False, M=48)
CLASSIC_BOX_3D = dict(spill=False, occupancy_safety=2.6)
CLASSIC_BOX_3D_WIDE = dict(spill=False, M=176)
CLASSIC_STEPS = 100
CLASSIC_CPL_STEPS = 150
CLASSIC_CPL_3D_STEPS = 100
CLASSIC_SPLIT = ["fluid_rates", "fluid_rates_tait", "wall_bc",
                 "fluid_forces_rigid"]
CLASSIC_SPLIT_3D = ["fluid_rates", "wall_bc", "fluid_forces_rigid"]
# the kdkf step's passes (B5 by particle)
CLASSIC_FUSED = ["fluid_rates_wall", "fluid_forces_contact"]
# kdkf at CLASSIC_BOX_3D_WIDE: its steps under phase 11's gates, and the
# steps held against twin steps (few: a twin step there runs B4's and
# B5's plain versions at 176 lanes, seconds each on the card)
CLASSIC_WIDE_STEPS = CHUNK
CLASSIC_WIDE_CMP = 2


def phase_classic_rigid(dev, smi):
    """47. The rigid GTVF step on classic grids set before the set-up
    (the 2D stack with lanes from occupancy and on the sub = 2 stencil,
    the 3D cubes): K2 on every slot of the gathered pack against its
    twin (picks bit for bit, sums at phase 3's tolerance), timed with its
    bound; CLASSIC_STEPS steps under phase 4's gates (one K2 a step, no
    K1, the full [N, S] schema); 20 kernel steps against 20 twin steps
    (SHORT_CMP for the 3D cubes).  Returns {label: numbers}."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel

    out = {}
    for label, dim, grid in CLASSIC_RIGID:
        t0 = time.perf_counter()
        build = contact_scene_2d if dim == 2 else contact_scene_3d
        scheme, scene, dx = build(dev, grid=grid)
        kernel = get_kernel(scheme.kernel_name, dim)
        cfg = scheme.cell_config(scene, kernel)
        check(not cfg.spill and "cl_pid" not in scene,
              f"classic {label}: set up compact or on the spill grid")
        print(f"[classic-setup] {label}: n={scene.n} M={cfg.M} O={cfg.O} "
              f"NC={cfg.NC_max} sub={cfg.sub} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        S, init = scene.meta.total_no_bodies, 4.0 * scene.meta.spacing0
        cgrid, dfT = tck.pack_classic(seeded_velocities(scene, dim, 7), cfg)
        check(not bool(cgrid.overflow), f"classic {label}: grid overflow")
        k2, n_pick = contact_all_slots(dfT, cgrid, cfg, kernel, S, init,
                                       f"classic-{label}", timed=True)
        check(n_pick > 0, f"classic {label}: no contact pick")
        del cgrid, dfT
        end, launches, stats = phase_main_path(
            scheme, scene, dx, smi, f"classic-{label}", CLASSIC_STEPS)
        inst = f"contact/{tck.lanes_instance('narrow', cfg.M)}"
        check(launches.get(inst, 0) == launches["contact"],
              f"classic {label}: K2 ran another instance than {inst}")
        phase_step_parity(scheme, end, f"classic-{label}-parity",
                          SHORT_CMP if dim == 3 else COMPARE_STEPS)
        out[label] = dict(k2=k2, launches=launches, stats=stats, M=cfg.M,
                          O=cfg.O, NC=cfg.NC_max, inst=inst,
                          seconds=time.perf_counter() - t0)
        del scheme, scene, end
    return out


def phase_classic_coupling(dev, smi):
    """48. The kdk and kdkf coupling orderings on a classic grid of
    CLASSIC_BOX set before the set-up, on the sinking box: B6a (EDAC and
    Tait), B6b and B6c with bodies on the gathered pack and K2 on every
    slot of its contact pack against their twins, timed with their
    bounds; CLASSIC_CPL_STEPS kdk steps under phase 11's gates (B6a, B6b,
    B6c and K2 a step at the grid's width, no K1) and as many kdkf steps
    (B4 and B5 a step at the grid's width, B5's contact columns by
    particle, no K1); 20 kdk kernel steps against 20 twin steps with the
    dense box on the floor, then on that box's pack B4 and B5 against
    their twins, timed (gated contact pairs and picks required), and
    SHORT_CMP kdkf kernel steps against as many twin steps.
    49. The same orderings on the 3D sinking box's classic grid of the
    lane rule (CLASSIC_BOX_3D, set before the set-up; M 80, O 27): B6a,
    B6b, B6c, K2, B4 and B5 on its pack against their twins, timed;
    CLASSIC_CPL_3D_STEPS kdk and as many kdkf steps under phase 11's
    gates (each a step at the grid's width, no K1); SHORT_CMP kernel
    steps of each against as many twin steps from its end state.  Then
    at CLASSIC_BOX_3D_WIDE (176 lanes) on the same scene: B6a, B6b, B6c,
    B4 and B5 against their twins, timed; K2 refusing that width, as the
    reference's does; and CLASSIC_WIDE_STEPS kdkf steps there (B5 carries
    the contact) under phase 11's gates, CLASSIC_WIDE_CMP of them against
    as many twin steps.  Returns the numbers."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck
    from rigid_body_2d_3d_pysph_tpu_torch.ops import fluid_kernel as fk

    t0 = time.perf_counter()
    kdkf_step = dict(fluid_rates_wall=1, fluid_forces_contact=1)
    scheme, scene, dt = sinking_box_scene(dev, grid=CLASSIC_BOX)
    scheme.gtvf_ordering = "kdk"
    kernel, cfg, grid, pt, dfT, S, init = fluid_scene_pack(
        scheme, scene, "classic box", 17, p_fsi=True)
    print(f"[classic-setup] sinking box: n={scene.n} M={cfg.M} O={cfg.O} "
          f"NC={cfg.NC_max} ({time.perf_counter() - t0:.1f} s)", flush=True)
    split, work, _ = fluid_pass_checks(
        fluid_calls(scheme, dfT, grid.nbr_slots, kernel, cfg.radius, S,
                    init, CLASSIC_SPLIT),
        dfT, grid.nbr_slots, pt, cfg.radius, S, init,
        abs(scheme.fluid_alpha) > 1e-14, "classic box", True)
    print_fluid_passes("classic-kernels", "sinking box", split)
    split["contact_all_slots"], _ = contact_all_slots(
        tck.contact_pack(dfT, fk.UNION_LAYOUT, True), grid, cfg, kernel, S,
        init, "classic-box", timed=True)
    del grid, pt, dfT
    per_step = dict(fluid_rates=1, wall_bc=1, fluid_forces=1, contact=1)
    _, launches, sps = phase_coupling_main(
        scheme, scene, dt, CLASSIC_CPL_STEPS, "classic-cpl-kdk", smi,
        per_step)
    check_lanes_instances("classic kdk", launches, cfg.M)
    scheme.gtvf_ordering = "kdkf"
    _, launches_f, sps_f = phase_coupling_main(
        scheme, scene, dt, CLASSIC_CPL_STEPS, "classic-cpl-kdkf", smi,
        kdkf_step)
    check_kdkf_instances("classic kdkf", launches_f, cfg.M)
    del scheme, scene
    pscheme, pscene, pdt = sinking_box_scene(
        dev, floor=True, rho_b=CPL_PARITY_RHO, grid=CLASSIC_BOX)
    pscheme.gtvf_ordering = "kdk"
    phase_coupling_parity(pscheme, pscene, pdt, "classic-kdk-parity")
    pscheme.gtvf_ordering = "kdkf"
    b45 = classic_b4_b5(pscheme, pscene, "classic box on floor", True)
    phase_coupling_parity(pscheme, pscene, pdt, "classic-kdkf-parity",
                          n=SHORT_CMP)
    del pscheme, pscene
    print(f"[classic] phase 48 in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 49. the 3D box on the classic grid of the lane rule
    t1 = time.perf_counter()
    scheme3, scene3 = sinking_box_scene_3d(dev, grid=CLASSIC_BOX_3D)
    scheme3.gtvf_ordering = "kdk"
    kernel3, cfg3, grid3, pt3, dfT3, S3, init3 = fluid_scene_pack(
        scheme3, scene3, "classic 3D box", 19, p_fsi=True)
    print(f"[classic-setup] 3D box: n={scene3.n} M={cfg3.M} O={cfg3.O} "
          f"NC={cfg3.NC_max}", flush=True)
    split3, _, _ = fluid_pass_checks(
        fluid_calls(scheme3, dfT3, grid3.nbr_slots, kernel3, cfg3.radius,
                    S3, init3, CLASSIC_SPLIT_3D + CLASSIC_FUSED,
                    dict(lanes=tcell.lane_map(grid3, cfg3, scene3.n))),
        dfT3, grid3.nbr_slots, pt3, cfg3.radius, S3, init3,
        abs(scheme3.fluid_alpha) > 1e-14, "classic 3D box", True)
    print_fluid_passes("classic-kernels", "3D box", split3)
    split3["contact_all_slots"], _ = contact_all_slots(
        tck.contact_pack(dfT3, fk.UNION_LAYOUT, False), grid3, cfg3,
        kernel3, S3, init3, "classic-box-3d", timed=True)
    del grid3, pt3, dfT3
    dt3 = 0.25 * scheme3.h / (1.1 * scheme3.c0)
    end3, launches3, sps3 = phase_coupling_main(
        scheme3, scene3, dt3, CLASSIC_CPL_3D_STEPS, "classic-cpl-kdk-3d",
        smi, per_step)
    check_lanes_instances("classic kdk 3D", launches3, cfg3.M)
    phase_coupling_3d_parity(scheme3, end3, dt3, "classic-cpl-kdk-3d",
                             SHORT_CMP)
    del end3
    scheme3.gtvf_ordering = "kdkf"
    end3f, launches3f, sps3f = phase_coupling_main(
        scheme3, scene3, dt3, CLASSIC_CPL_3D_STEPS, "classic-cpl-kdkf-3d",
        smi, kdkf_step)
    check_kdkf_instances("classic kdkf 3D", launches3f, cfg3.M)
    phase_coupling_3d_parity(scheme3, end3f, dt3, "classic-cpl-kdkf-3d",
                             SHORT_CMP)
    del end3f

    # the passes at 176 lanes on the same scene; K2 refuses them, B5
    # carries the kdkf step's contact there
    wide = classic_config(scheme3, scene3, occupancy_safety=2.6,
                          **CLASSIC_BOX_3D_WIDE)
    kernel3, wide, gridw, ptw, dfTw, S3, init3 = fluid_scene_pack(
        scheme3, scene3, "classic 3D box, 176 lanes", 19, p_fsi=True,
        cfg=wide)
    try:
        tck.contact_sums(tck.contact_pack(dfTw, fk.UNION_LAYOUT, False),
                         torch.arange(wide.NC_max, device=dev),
                         gridw.nbr_slots, S3, wide.radius, init3, kernel3)
        check(False, f"K2 took {wide.M} lanes a slot")
    except ValueError as e:
        check(str(tck.MAX_LANES) in str(e), f"K2 at {wide.M} lanes: {e}")
    splitw, workw, _ = fluid_pass_checks(
        fluid_calls(scheme3, dfTw, gridw.nbr_slots, kernel3, wide.radius,
                    S3, init3, CLASSIC_SPLIT_3D + CLASSIC_FUSED,
                    dict(lanes=tcell.lane_map(gridw, wide, scene3.n))),
        dfTw, gridw.nbr_slots, ptw, wide.radius, S3, init3,
        abs(scheme3.fluid_alpha) > 1e-14, "classic 3D box, 176 lanes", True)
    print(f"[classic-kernels] 3D box: n={scene3.n} M={wide.M} O={wide.O} "
          f"NC={wide.NC_max} | {workw}", flush=True)
    print_fluid_passes("classic-kernels", "3D box, 176 lanes", splitw)
    del gridw, ptw, dfTw
    schemew = copy.copy(scheme3)
    schemew._cell_cfg = wide
    endw, launchesw, spsw = phase_coupling_main(
        schemew, scene3, dt3, CLASSIC_WIDE_STEPS, "classic-cpl-kdkf-3d-wide",
        smi, kdkf_step)
    check_kdkf_instances("classic kdkf 3D wide", launchesw, wide.M)
    phase_coupling_3d_parity(schemew, endw, dt3, "classic-cpl-kdkf-3d-wide",
                             CLASSIC_WIDE_CMP)
    print(f"[classic] phase 49 in {time.perf_counter() - t1:.1f} s",
          flush=True)
    return dict(split=split, launches=launches, sps=sps, M=cfg.M, O=cfg.O,
                launches_f=launches_f, sps_f=sps_f, b45=b45,
                split3=split3, launches3=launches3, sps3=sps3, M3=cfg3.M,
                O3=cfg3.O, launches3f=launches3f, sps3f=sps3f,
                splitw=splitw, Mw=wide.M, Ow=wide.O, launchesw=launchesw,
                spsw=spsw, seconds=time.perf_counter() - t0)


def classic_b4_b5(scheme, scene, label, contact):
    """B4 and B5 (by particle) on the scene's classic pack against their
    twins, timed with their bounds; with ``contact`` gated contact pairs
    and contact rows with a pick are required.  Returns the numbers."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell

    kernel, cfg, grid, pt, dfT, S, init = fluid_scene_pack(
        scheme, scene, label, 17, p_fsi=True)
    out, work, n_found = fluid_pass_checks(
        fluid_calls(scheme, dfT, grid.nbr_slots, kernel, cfg.radius, S,
                    init, CLASSIC_FUSED,
                    dict(lanes=tcell.lane_map(grid, cfg, scene.n))),
        dfT, grid.nbr_slots, pt, cfg.radius, S, init,
        abs(scheme.fluid_alpha) > 1e-14, label, True)
    if contact:
        check(work["gated"] > 0 and n_found > 0, f"{label}: {work['gated']} "
              f"gated pairs, {n_found} contact rows with a pick")
    print(f"[classic-kernels] {label}: n={scene.n} M={cfg.M} O={cfg.O} "
          f"NC={cfg.NC_max} | gated pairs {work['gated']}, contact rows "
          f"with a pick {n_found}", flush=True)
    print_fluid_passes("classic-kernels", label, out)
    return out


def check_kdkf_instances(label, launches, M):
    """Every B4 and B5 launch of a kdkf run went to the instance of the
    grid's M lanes (B5 writing its contact columns by particle)."""
    for k, inst in (("fluid_rates_wall", f"fluid_rates_wall/lanes{M}"),
                    ("fluid_forces_contact",
                     f"fluid_forces_contact/lanes/lanes{M}")):
        check(launches.get(inst, 0) == launches[k] > 0,
              f"{label}: {k} ran another instance than {inst}")


def check_lanes_instances(label, launches, M):
    """Every split pass and K2 launch of a classic kdk run went to the
    instance of the grid's M lanes."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck

    for k, inst in (("fluid_rates", f"fluid_rates/lanes{M}"),
                    ("wall_bc", f"wall_bc/lanes{M}"),
                    ("fluid_forces", f"fluid_forces/lanes{M}"),
                    ("contact",
                     f"contact/{tck.lanes_instance('narrow', M)}")):
        check(launches.get(inst, 0) == launches[k],
              f"{label}: {k} ran another instance than {inst}")


def classic_kernel_entries(kernels, rigid, cpl, src):
    """The JSON entries of the classic grid's instances (phases 47-49):
    K2 at each rigid grid's width and at the coupling grids' (2D box 48,
    3D box 80), the split passes at the coupling grids' (the 3D box's
    176-lane times beside its 80-lane ones), each with its launches from
    its own main path."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel as tck

    by_name = {kd["name"]: kd for kd in kernels}
    out = []
    k2 = {}
    for label, r in rigid.items():
        k2.setdefault(r["inst"], []).append((f"classic-{label}", r["k2"],
                                             r["launches"][r["inst"]], r))
    boxes = (("classic-cpl-kdk", cpl["split"], cpl["launches"], cpl["M"],
              cpl["O"]),
             ("classic-cpl-kdk-3d", cpl["split3"], cpl["launches3"],
              cpl["M3"], cpl["O3"]))
    for path, split, launches, M, O in boxes:
        inst = f"contact/{tck.lanes_instance('narrow', M)}"
        k2.setdefault(inst, []).append((path, split["contact_all_slots"],
                                        launches.get(inst, 0),
                                        dict(M=M, O=O)))
    for inst, rows in k2.items():
        path, t, n, r = rows[0]
        out.append(dict(
            name=inst.replace("contact/", "contact_sums/"), route="cuda",
            source=src + "contact.cu",
            replaces=by_name["contact_sums"]["replaces"], launches=n,
            launches_by_path={p: c for p, _, c, _ in rows},
            max_abs_err=max(x["err"] for _, x, _, _ in rows), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None, M=r["M"], O=r["O"],
            grid=path, by_path={p: dict(ms=x["ms"], plain_ms=x["plain_ms"],
                                        bound_ms=x["bound_ms"],
                                        bound_by=x["bound_by"])
                                for p, x, _, _ in rows}))
    for name, key in (("fluid_rates", "fluid_rates"), ("wall_bc", "wall_bc"),
                      ("fluid_forces", "fluid_forces_rigid")):
        for path, split, launches, M, O in boxes:
            t, inst = split[key], f"{name}/lanes{M}"
            entry = dict(
                name=inst, route="cuda", source=src + "fluid.cu",
                replaces=by_name[name]["replaces"],
                launches=launches.get(inst, 0),
                launches_by_path={path: launches.get(inst, 0)},
                max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=None, M=M, O=O, grid=path)
            if name == "fluid_rates" and "fluid_rates_tait" in split:
                tt = split["fluid_rates_tait"]
                entry.update(
                    max_abs_err=max(entry["max_abs_err"], tt["err"]),
                    tait_ms=tt["ms"], tait_plain_ms=tt["plain_ms"],
                    tait_bound_ms=tt["bound_ms"])
            if path.endswith("3d"):
                tw = cpl["splitw"][key]
                entry.update(
                    max_abs_err=max(entry["max_abs_err"], tw["err"]),
                    M_wide=cpl["Mw"], O_wide=cpl["Ow"], ms_wide=tw["ms"],
                    plain_ms_wide=tw["plain_ms"],
                    bound_ms_wide=tw["bound_ms"],
                    bound_by_wide=tw["bound_by"])
            out.append(entry)
    return out


# ---------------------------------------------------------------------------
# every lane width and the slab steps on a classic base (phases 50-52)
# ---------------------------------------------------------------------------

# the JAX sweep's wide DEM grid (models/dem.py: (cell_factor, M) = (8, 32))
DEM_LANES = (8.0, 32)
DEM_LANES_STEPS = 100
# K4 and K3 at these widths on one call each ((lanes, spill bin factor):
# a bin of 2 contact radii holds ~4 grains, so 4 lanes need no spill
# beyond max_spill slots a cell)
DEM_WIDTHS = ((4, 2.0), (24, 4.0), (64, 8.0), (128, 8.0))
# the row-window grid preset at this width runs a main path of CHUNK steps
DEM_ROWWIN_LANES = 24
CPL_LANES = 48             # the kdkf step on a spill grid of 48 lanes
CPL_LANES_3D = 64          # B4 and B5 on the 3D boxes at 64 lanes
SLAB_CLASSIC_STEPS = COMPARE_STEPS


def dem_pack_check(scheme, scene, cfg, label):
    """K1 on the DEM source pack of ``cfg`` (F = 13) against its twin, bit
    for bit, timed with its bound."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_cell as tdc
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
    from rigid_body_2d_3d_pysph_tpu_torch.ops import pack_expand as tpe
    from rigid_body_2d_3d_pysph_tpu_torch.ops.cellpairs import (
        build_cell_grid_packed)

    _, pt = build_cell_grid_packed(scene.x, scene.y, scene.z, scene.active,
                                   cfg, tdk.dem_payload(scene))
    sent = torch.tensor(tdc.SENT, dtype=scene.dtype, device=scene.device)
    args = (pt.sorted_fields, pt.base, pt.cnt, sent, cfg.M)
    got, ref = tpe.expand_slots(*args), tpe.expand_slots_reference(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), f"{label}: DEM pack expansion != twin")
    t = dict(ms=cuda_ms(lambda: tpe.expand_slots(*args)),
             plain_ms=cuda_ms(lambda: tpe.expand_slots_reference(*args)),
             err=0.0)
    t["bound_ms"], t["bound_by"] = bound(
        nbytes(pt.sorted_fields, pt.base, pt.cnt, sent, got), 0)
    print(f"[dem-lanes] {label}: K1 (F = {got.shape[1]}, M = {cfg.M}) "
          f"{t['ms']:.4f} ms (plain {t['plain_ms']:.4f} ms, bound "
          f"{t['bound_ms']:.4f} ms by {t['bound_by']}), bit for bit",
          flush=True)
    return t


def phase_dem_lanes(dev, smi):
    """50. The 2D DEM column on the spill grid of DEM_LANES (cell_factor,
    cell_M) set on the scheme, the JAX sweep's (8, 32): K4 (the filled
    table) and K1 at 32 lanes against their twins, timed; DEM_LANES_STEPS
    steps under phase 7's gates (one K1 and one K4 of the runtime-width
    instance a step); 20 kernel steps against 20 twin steps.  Then K4
    and K3 at each of DEM_WIDTHS against their twins on one call each
    (the filled table), timed.  Returns the numbers."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
    from rigid_body_2d_3d_pysph_tpu_torch.ops import dem_kernel as tdk
    from rigid_body_2d_3d_pysph_tpu_torch.ops import rowwin as trw

    t0 = time.perf_counter()
    scheme, scene = dem_scene(dev, 2)
    scheme.cell_factor, scheme.cell_M = DEM_LANES
    cfg = scheme.cell_config(scene)
    check(cfg.spill and cfg.M == DEM_LANES[1], f"phase 50: grid {cfg}")
    label = f"2D spill M={cfg.M}"
    t = {}
    phase_dem_kernels(scheme, scene, label, t, cases_run=("filled",),
                      plain_reps=1)
    k1 = dem_pack_check(scheme, scene, cfg, label)
    inst = f"dem_cell/{tdk.lanes_instance('l8', cfg.M)}"
    end, launches, sps = phase_dem_main(scheme, scene, DEM_LANES_STEPS,
                                        f"dem-lanes{cfg.M}", smi)
    check(launches.get(inst, 0) == launches["dem_cell"],
          f"phase 50: {launches['dem_cell']} K4 launches, "
          f"{launches.get(inst, 0)} of {inst}")
    phase_dem_parity(scheme, end, label=f"dem-lanes{cfg.M}-parity")
    out = dict(main=dict(t[label], M=cfg.M, O=cfg.O, NC=cfg.NC_max,
                         instance=inst, launches=launches.get(inst, 0),
                         sps=sps, k1=k1),
               widths={})
    print(f"[dem-lanes] phase 50 main path in {time.perf_counter() - t0:.1f}"
          " s", flush=True)
    host = lambda k: scene[k].detach().cpu().numpy()
    cutoff = scheme._contact_radius(scene)
    for M, factor in DEM_WIDTHS:
        for grid in ("spill", "rowwin"):
            wscheme = copy.copy(scheme)
            wscheme.dem_grid = grid
            if grid == "spill":
                # the plain version's chunks: ~4,096 query lanes a chunk
                wcfg = tcell.config_from_positions(
                    host("x"), host("y"), host("z"), cutoff, 2,
                    cell_factor=factor, M=M, spill=True,
                    cell_chunk=max(32, 4096 // M))
                wscheme._cell_cfg = wcfg
            else:
                wcfg = trw.rowwin_config_from_positions(
                    host("x"), host("y"), host("z"), cutoff, 2, M=M)
                wscheme._rowwin_cfg = wcfg
            wl = f"2D {grid} M={M}"
            tw = {}
            phase_dem_kernels(wscheme, scene, wl, tw, cases_run=("filled",),
                              plain_reps=1)
            kname = "dem_cell" if grid == "spill" else "dem_rowwin"
            out["widths"][(kname, M)] = dict(tw[wl], M=M, grid=grid)
            if grid == "rowwin" and M == DEM_ROWWIN_LANES:
                # the row-window grid preset at this width: a main path
                inst = f"dem_rowwin/{tdk.lanes_instance('l8', M)}"
                _, rl, rsps = phase_dem_main(wscheme, scene, CHUNK,
                                             f"dem-rowwin-lanes{M}", smi)
                check(rl.get(inst, 0) == rl["dem_rowwin"] > 0,
                      f"phase 50: {rl['dem_rowwin']} K3 launches, "
                      f"{rl.get(inst, 0)} of {inst}")
                out["rowwin_main"] = dict(M=M, launches=rl.get(inst, 0),
                                          sps=rsps, instance=inst)
    print(f"[dem-lanes] phase 50 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def phase_coupling_lanes(dev, smi):
    """51. The kdkf step on a spill grid of CPL_LANES set before the
    set-up: B4 and B5 (by particle) against their twins on the dense box
    resting GAP dx above the tank floor (gated contact pairs and picks
    required), timed, and 20 kernel steps against 20 twin steps from
    there; CPL_STEPS steps of the sinking box under phase 11's gates (K1,
    B4 and B5 a step, each of the width's instance; the box sinks); the
    compact store at that width: 20 kernel steps of the boxes in the tank
    (the compact route, B5 by query row) against 20 twin steps.  Then B4
    and B5 at CPL_LANES_3D against their twins on one call, timed, on the
    3D boxes resting on the tank floor (``boxes_tank_scene``, the full
    route: B5 by particle), gated pairs and picks required.  Returns the
    numbers."""
    t0 = time.perf_counter()
    grid = dict(spill=True, M=CPL_LANES)
    pscheme, pscene, pdt = sinking_box_scene(
        dev, floor=True, rho_b=CPL_PARITY_RHO, grid=grid)
    cfg = pscheme._cell_cfg
    check(cfg.spill and cfg.M == CPL_LANES, f"phase 51: grid {cfg}")
    label = f"box on floor M={cfg.M}"
    fl = {}
    gated, n_found = phase_fluid_kernels(pscheme, pscene, label, fl,
                                         timed=True)
    check(gated > 0 and n_found > 0, f"phase 51: {gated} gated pairs, "
          f"{n_found} contact rows with a pick on the floor")
    phase_coupling_parity(pscheme, pscene, pdt, f"kdkf-lanes{cfg.M}-parity")
    del pscheme, pscene
    scheme, scene, dt = sinking_box_scene(dev, grid=grid)
    per_step = dict(pack_expand=1, fluid_rates_wall=1,
                    fluid_forces_contact=1)
    _, launches, sps = phase_coupling_main(
        scheme, scene, dt, CPL_STEPS, f"kdkf-lanes{cfg.M}", smi, per_step)
    for k, inst in (("fluid_rates_wall", f"fluid_rates_wall/lanes{cfg.M}"),
                    ("fluid_forces_contact",
                     f"fluid_forces_contact/lanes/lanes{cfg.M}")):
        check(launches.get(inst, 0) == launches[k], f"phase 51: {k} ran "
              f"another instance than {inst}")
    del scheme, scene
    # the compact store at this width: the boxes in the tank
    cscheme, cscene, cdt = boxes_tank_scene(dev, 2, grid=grid)
    check("cl_pid" in cscene and cscheme._cell_cfg.M == CPL_LANES,
          "phase 51: the boxes' scene is not compact at the width")
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
    # pushed down as phase 42 pushes them (the top row at twice the speed)
    push = cscene.vcm.clone()
    nb = cscene.meta.nb
    push[:, 1] -= 0.5 * (1 + (torch.arange(nb, device=push.device)
                              >= nb // 2).to(push.dtype))
    _build.reset_launches()
    phase_coupling_parity(cscheme, cscene, cdt,
                          f"compact-lanes{cfg.M}-parity", push=push)
    rows_inst = f"fluid_forces_contact/rows/lanes{cfg.M}"
    check(_build.LAUNCHES_INSTANCE.get(rows_inst, 0) == COMPARE_STEPS,
          f"phase 51: {_build.LAUNCHES_INSTANCE.get(rows_inst, 0)} launches "
          f"of {rows_inst} in {COMPARE_STEPS} compact kernel steps")
    del cscheme, cscene
    # B4 and B5 at CPL_LANES_3D on the 3D boxes on the floor, one call each
    scheme3, scene3, _ = boxes_tank_scene(
        dev, 3, compact=False, grid=dict(spill=True, M=CPL_LANES_3D))
    l3 = f"3D boxes on floor M={CPL_LANES_3D}"
    kernel3, wide, grid3, pt3, dfT3, S3, init3 = fluid_scene_pack(
        scheme3, scene3, l3, 19, p_fsi=True)
    check(wide.spill and wide.M == CPL_LANES_3D, f"phase 51: 3D grid {wide}")
    out3, work3, n3 = fluid_pass_checks(
        fluid_calls(scheme3, dfT3, grid3.nbr_slots, kernel3, wide.radius,
                    S3, init3, ["fluid_rates_wall", "fluid_forces_contact"],
                    b5_layout(scheme3, scene3, grid3, pt3, dfT3, wide)),
        dfT3, grid3.nbr_slots, pt3, wide.radius, S3, init3,
        abs(scheme3.fluid_alpha) > 1e-14, l3, True)
    check(work3["gated"] > 0 and n3 > 0, f"phase 51: {work3['gated']} "
          f"gated pairs, {n3} contact rows with a pick on the 3D floor")
    print(f"[cpl-lanes] {l3}: n={scene3.n} S={S3} NC={wide.NC_max} "
          f"O={wide.O} | gated pairs {work3['gated']}, contact rows with a "
          f"pick {n3}", flush=True)
    print_fluid_passes("cpl-lanes", l3, out3)
    print(f"[cpl-lanes] phase 51 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return dict(fluid=fl[label], launches=launches, sps=sps, M=cfg.M,
                O=cfg.O, fluid3=out3, M3=wide.M, O3=wide.O,
                compact_launches=_build.LAUNCHES_INSTANCE.get(rows_inst, 0))


def _slab_classic_run(label, scheme, scene, dt, make, per_step, keys, body,
                      single=None, tables=False):
    """SLAB_CLASSIC_STEPS kernel slab steps of ``make(plain)`` from
    ``scene``'s slabs against ``single`` (single-device steps of the same
    grid; None: against as many plain slab steps), by gid (positions and
    xcm as their change, SLAB_ULPS); the launches a step are ``per_step``
    and nothing else; with ``tables`` the DEM tables as gid-keyed maps.
    Returns (launches, seconds a kernel step)."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

    parts0, mesh, cfg = make.parts, make.mesh, make.cfg
    P = len(parts0)
    n = SLAB_CLASSIC_STEPS
    a, launches, _, el = _slab_steps(lambda: make(False), parts0, n, dt,
                                     label)
    _slab_launch_gate(label, launches, {k: P * v * n
                                        for k, v in per_step.items()})
    launches.update(_build.LAUNCHES_INSTANCE)
    ga, ra = _slab_gathered(a)
    check(ra.shape[0] == scene.n, f"{label}: {ra.shape[0]} active rows for "
          f"{scene.n} particles")
    if single is None:
        b, _, _, _ = _slab_steps(lambda: make(True), parts0, n, dt,
                                 label + " plain")
        ref, rr = _slab_gathered(b)
        what = f"{n} plain slab steps"
    else:
        ref, rr = single, torch.arange(scene.n, device=scene.device)
        what = f"{n} single-device steps"
    x0 = {k: scene[k] for k in ("x", "y", "z")[:scheme.dim] + ("xcm",)
          if k in scene}
    w = _slab_compare(f"{label} vs {what}", ga, ra, ref, rr, keys, body, x0,
                      SLAB_ULPS)
    if tables:
        pick = lambda sc, rows: _sorted_tables(sc.with_fields(**{
            k: sc[k][rows] for k in ("tng_idx", "tng_idx_dem_id", "tng_x",
                                     "tng_y", "tng_z")}))
        (ka, sa), (kb, sb) = pick(ga, ra), pick(ref, rr)
        bad = int((ka != kb).any(1).sum())
        check(bad == 0, f"{label}: {bad} rows hold other contacts")
        d = (sa - sb).abs()
        check(bool((d <= STEP_RTOL * sb.abs()
                    + STEP_RTOL * float(sb.abs().max())).all()),
              f"{label}: springs off by {float(d.max()):.3e}")
        w.append(f"tables equal as gid-keyed maps (springs "
                 f"{float(d.max()):.3e})")
    a_step = {k: v / (P * n) for k, v in launches.items()
              if v and "/" not in k}
    print(f"[slab-classic] {label}: P={P} slab_cells {cfg.slab_cells}, M "
          f"{cfg.base.M}, O {cfg.base.O}: {n} kernel slab steps vs {what}: "
          + ", ".join(w) + f" | launches a slab a step {a_step} "
          f"({n / el:.2f} steps/s)", flush=True)
    return launches, el / n


def _slab_maker(scheme, scene, P, label, base, kind, n_global=None):
    """``make(plain)`` -> the slab step of ``kind`` on ``scene``'s slabs
    of ``base`` (P on the first card), with ``.parts``, ``.mesh`` and
    ``.cfg``."""
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as sl
    from rigid_body_2d_3d_pysph_tpu_torch.parallel.mesh import make_mesh

    cfg = slab_config_for(scene, base, P, label)
    mesh = make_mesh(P, [scene.device] * P)
    parts = sl.shard_slab_scene(sl.slab_decompose(
        scene, cfg, use_blob=False), mesh)

    def make(plain):
        if kind == "rigid":
            return sl.make_slab_step(scheme, parts, mesh, cfg, plain=plain)
        if kind == "dem":
            return sl.make_slab_dem_step(scheme, parts, mesh, cfg, n_global,
                                         plain=plain)
        return sl.make_slab_coupling_step(scheme, parts, mesh, cfg,
                                          plain=plain)

    make.parts, make.mesh, make.cfg = parts, mesh, cfg
    return make


def phase_slab_classic(dev, smi):
    """52. The slab steps on classic bases, SLAB_P slabs of the card, each
    SLAB_CLASSIC_STEPS steps: the 2D stack's rigid GTVF (full [N, S]
    route, K2 at the classic grid's width, no K1) against as many
    single-device steps on the same grid; the DEM column on a classic
    base (K4, no K1) against single-device steps of the same grid; the
    sinking box (the dense box pushed on the floor, CLASSIC_BOX) in kdk
    (B6a, B6b, B6c, K2) and in kdkf (B4, B6c, K2) against single-device
    steps of the ordering (the single-device kdkf: B4 and B5).  Returns
    {path: numbers}."""
    from rigid_body_2d_3d_pysph_tpu_torch.ops import cellpairs as tcell
    from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import slab as sl

    t0 = time.perf_counter()
    P, out = SLAB_P, {}
    # the rigid stack, its bodies sliding
    scheme, scene, _ = contact_scene_2d(dev, grid=dict(spill=False))
    kernel = get_kernel(scheme.kernel_name, 2)
    base = scheme.cell_config(scene, kernel)
    check(not base.spill, "phase 52: the stack's grid is not classic")
    scene = sl.attach_gids(scene)
    slide = np.random.default_rng(17).uniform(-SLAB_SLIDE, SLAB_SLIDE,
                                              (scene.meta.nb, 3))
    slide[:, 2] = 0.0
    scene = scheme.set_linear_velocity(scene, slide)
    single = _single_steps(scheme, scene, "slab-classic-rigid",
                           SLAB_CLASSIC_STEPS)
    make = _slab_maker(scheme, scene, P, "slab-classic-rigid", base, "rigid")
    launches, s = _slab_classic_run(
        "slab-classic-rigid", scheme, scene, DT, make, dict(contact=1),
        ("x", "y", "u", "v"), ("xcm", "vcm", "omega"), single)
    out["rigid"] = dict(launches=launches, s=s, M=base.M, O=base.O)
    del scheme, scene, single, make
    # the DEM column on a classic base of the contact radius
    scheme, scene = dem_scene(dev, 2)
    host = lambda k: scene[k].detach().cpu().numpy()
    scheme._cell_cfg = tcell.config_from_positions(
        host("x"), host("y"), host("z"), scheme._contact_radius(scene), 2,
        cell_factor=scheme.cell_factor, spill=False)
    base = scheme.cell_config(scene)
    check(not base.spill, "phase 52: the DEM grid is not classic")
    scene = sl.attach_gids(scene)
    single = scene
    sstep = scheme.make_step(scene)
    for _ in range(SLAB_CLASSIC_STEPS):
        single = sstep(single, DEM_DT)
    check(not bool(single.nbr_overflow), "phase 52: DEM single-device "
          "overflow")
    make = _slab_maker(scheme, scene, P, "slab-classic-dem", base, "dem",
                       scene.n)
    launches, s = _slab_classic_run(
        "slab-classic-dem", scheme, scene, DEM_DT, make, dict(dem_cell=1),
        ("x", "y", "u", "v", "wz", "fx", "fy", "torz"), (), single,
        tables=True)
    out["dem"] = dict(launches=launches, s=s, M=base.M, O=base.O)
    del scheme, scene, single, make
    # the sinking box, kdk and kdkf
    for ordering in ("kdk", "kdkf"):
        scheme, scene, dt = sinking_box_scene(
            dev, floor=True, rho_b=CPL_PARITY_RHO, grid=CLASSIC_BOX)
        scene = scene.replace(vcm=torch.tensor(
            [[0.05, -0.5, 0.0]], dtype=scene.dtype, device=dev))
        scheme.gtvf_ordering = ordering
        scene = sl.attach_gids(scene)
        kernel = get_kernel(scheme.kernel_name, 2)
        base = slab_grid_x(scheme.cell_config(scene, kernel), scene)
        check(not base.spill, "phase 52: the box's grid is not classic")
        single = scene
        sstep = scheme.make_step(scene)
        for _ in range(SLAB_CLASSIC_STEPS):
            single = sstep(single, dt)
        check(not bool(single.nbr_overflow), f"phase 52: {ordering} "
              "single-device overflow")
        label = f"slab-classic-{ordering}"
        make = _slab_maker(scheme, scene, P, label, base, "coupling")
        per_step = {k: v for k, v in CPL_SLAB_KERNELS[ordering].items()
                    if k != "pack_expand"}
        launches, s = _slab_classic_run(
            label, scheme, scene, dt, make, per_step,
            ("x", "y", "u", "v", "rho", "p"), ("xcm", "vcm", "omega"),
            single)
        check_lanes = {k: f"{k}/lanes{base.M}" for k in per_step
                       if k != "contact"}
        for k, inst in check_lanes.items():
            check(launches.get(inst, 0) == launches[k],
                  f"{label}: {k} ran another instance than {inst}")
        out[ordering] = dict(launches=launches, s=s, M=base.M, O=base.O)
        del scheme, scene, single, make
    print(f"[slab-classic] phase 52 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def lanes_kernel_entries(kernels, dem_lanes, cpl_lanes, src):
    """The JSON entries of the instances of phases 50-51: K4's and K3's
    runtime-width instance (K4 at 32 lanes on its main path, every width
    of DEM_WIDTHS beside it) and B4's and B5's instances of two warps a
    slot (48 lanes on the kdkf main path, 64 on the 3D boxes beside it),
    each with its launches from its own main path."""
    by_name = {kd["name"]: kd for kd in kernels}
    out = []
    m = dem_lanes["main"]
    for kname in ("dem_cell", "dem_rowwin"):
        rows = {M: v for (k, M), v in dem_lanes["widths"].items()
                if k == kname}
        first = m if kname == "dem_cell" else rows[max(rows)]
        rm = dem_lanes["rowwin_main"]
        launches = (m["launches"] if kname == "dem_cell"
                    else rm["launches"])
        path = (f"dem-lanes{m['M']}" if kname == "dem_cell"
                else f"dem-rowwin-lanes{rm['M']}")
        out.append(dict(
            name=f"{kname}/lanes", route="cuda", source=src + "dem.cu",
            replaces=by_name[kname]["replaces"],
            launches=launches, launches_by_path={path: launches},
            max_abs_err=max([first["err"]] + [v["err"] for v in
                                                rows.values()]),
            ms=first["ms"], plain_ms=first["plain_ms"],
            bound_ms=first["bound_ms"], bound_by=first["bound_by"],
            library_ms=None, M=first["M"],
            steps_per_s=m["sps"] if kname == "dem_cell" else rm["sps"],
            by_M={str(M): dict(ms=v["ms"], plain_ms=v["plain_ms"],
                               bound_ms=v["bound_ms"],
                               bound_by=v["bound_by"])
                  for M, v in sorted(rows.items())}))
    k1 = m["k1"]
    out.append(dict(
        name=f"pack_expand/dem_lanes{m['M']}", route="cuda",
        source=src + "pack_expand.cu",
        replaces=by_name["pack_expand"]["replaces"],
        launches=m["launches"], launches_by_path={
            f"dem-lanes{m['M']}": m["launches"]},
        max_abs_err=0.0, ms=k1["ms"], plain_ms=k1["plain_ms"],
        bound_ms=k1["bound_ms"], bound_by=k1["bound_by"], library_ms=None,
        M=m["M"]))
    c = cpl_lanes
    for name, inst in (("fluid_rates_wall",
                        f"fluid_rates_wall/lanes{c['M']}"),
                       ("fluid_forces_contact",
                        f"fluid_forces_contact/lanes/lanes{c['M']}")):
        t, t3 = c["fluid"][name], c["fluid3"][name]
        out.append(dict(
            name=inst, route="cuda", source=src + "fluid.cu",
            replaces=by_name[name]["replaces"],
            launches=c["launches"].get(inst, 0),
            launches_by_path={f"kdkf-lanes{c['M']}":
                              c["launches"].get(inst, 0)},
            max_abs_err=max(t["err"], t3["err"]), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=None, M=c["M"], O=c["O"],
            M_3d=c["M3"], O_3d=c["O3"], ms_3d=t3["ms"],
            plain_ms_3d=t3["plain_ms"], bound_ms_3d=t3["bound_ms"],
            bound_by_3d=t3["bound_by"],
            compact_rows_launches=c["compact_launches"]
            if name == "fluid_forces_contact" else None,
            steps_per_s=c["sps"]))
    return out


def classic_kdkf_entries(kernels, cpl, src):
    """B4's and B5's entries for the classic kdkf paths (phases 48-49):
    the 2D box's instance at CLASSIC_BOX's width (the entry of that
    instance, if phase 51's spill path made one, takes the classic
    numbers beside its own), the 3D box's at 80 and at 176 lanes, each
    with its launches from its own main path.  Returns the new
    entries."""
    by_name = {kd["name"]: kd for kd in kernels}
    out = []
    for name in CLASSIC_FUSED:
        for path, t, launches, M, O in (
                ("classic-cpl-kdkf", cpl["b45"][name], cpl["launches_f"],
                 cpl["M"], cpl["O"]),
                ("classic-cpl-kdkf-3d", cpl["split3"][name],
                 cpl["launches3f"], cpl["M3"], cpl["O3"]),
                ("classic-cpl-kdkf-3d-wide", cpl["splitw"][name],
                 cpl["launchesw"], cpl["Mw"], cpl["Ow"])):
            inst = (f"{name}/lanes{M}" if name == "fluid_rates_wall"
                    else f"{name}/lanes/lanes{M}")
            n = launches.get(inst, 0)
            if inst in by_name:
                kd = by_name[inst]
                kd["launches_by_path"][path] = n
                kd.update(max_abs_err=max(kd["max_abs_err"], t["err"]),
                          classic_ms=t["ms"], classic_plain_ms=t["plain_ms"],
                          classic_bound_ms=t["bound_ms"],
                          classic_bound_by=t["bound_by"], classic_O=O)
                continue
            kd = dict(name=inst, route="cuda", source=src + "fluid.cu",
                      replaces=by_name[name]["replaces"], launches=n,
                      launches_by_path={path: n}, max_abs_err=t["err"],
                      ms=t["ms"], plain_ms=t["plain_ms"],
                      bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                      library_ms=None, M=M, O=O, grid=path)
            by_name[inst] = kd
            out.append(kd)
    return out


# ---------------------------------------------------------------------------
# the row-sharded step (phase 53)
# ---------------------------------------------------------------------------

SHARDED_KERNELS = dict(
    rigid=dict(pack_expand=1, contact=1),
    dem=dict(pack_expand=1, dem_cell=1),
    kdkf=CPL_SLAB_KERNELS["kdkf"])


def _sharded_run(label, scheme, scene, dt, kind, keys, body, smi,
                 tables=False):
    """SHORT_CMP steps of ``parallel/sharded.py``'s step on SLAB_P row
    blocks of the card against as many single-device steps of the scheme
    on the padded scene (STEP_RTOL; positions and xcm as their change,
    SLAB_ULPS; with ``tables`` the DEM tables as (partner, dem) -> spring
    maps), the launches a block a step SHARDED_KERNELS[kind] and nothing
    else.  An overflow of the rigid compact route's capacity in the
    single-device run raises the scheme's capacity boost 1.5x and repeats
    both runs, as the Solver's rule does; each block's store has the
    single-device capacity and holds only its own rows' slots, so an
    overflow of the sharded run alone fails.  Returns the numbers, with
    ``retries``: the side that overflowed at each boost."""
    from rigid_body_2d_3d_pysph_tpu_torch.models import rigid_body as trb
    from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
    from rigid_body_2d_3d_pysph_tpu_torch.parallel import sharded as sh
    from rigid_body_2d_3d_pysph_tpu_torch.parallel.mesh import make_mesh

    P, n = SLAB_P, SHORT_CMP
    mesh = make_mesh(P, [scene.device] * P)
    padded = sh.pad_scene(scene, P)
    parts0 = sh.shard_scene(scene, mesh)
    check(sh.gather_scene(parts0).n == padded.n, f"{label}: blocks of "
          f"{parts0[0].n} rows for {padded.n}")

    def run(step, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state = step(state, dt)
        torch.cuda.synchronize()
        return state, n / (time.perf_counter() - t0)

    retries = []
    for attempt in range(5):
        if "cl_pid" in padded:
            padded = trb.fit_compact_store(padded, scheme._cell_cfg,
                                           scheme.capacity_boost)
        single, sps1 = run(scheme.make_step(padded), padded)
        step = sh.make_sharded_step(scheme, parts0, mesh)
        _build.reset_launches()
        parts, sps = run(step, parts0)
        launches = dict(_build.LAUNCHES)
        ovf1 = bool(single.nbr_overflow)
        ovf = any(bool(p.nbr_overflow) for p in parts)
        if not (ovf1 or ovf):
            break
        side = ("both" if ovf1 and ovf else
                "single-device" if ovf1 else "sharded")
        check(ovf1, f"{label}: the sharded step overflowed at boost "
              f"{scheme.capacity_boost:.3g}, the single-device step not")
        check(kind == "rigid" and attempt < 4, f"{label}: overflow")
        retries.append(f"{side} at boost {scheme.capacity_boost:.3g}")
        scheme.capacity_boost = float(scheme.capacity_boost) * 1.5
        print(f"[{label}] overflow ({side}): capacity boost raised to "
              f"{scheme.capacity_boost:.3g}, both runs repeated", flush=True)
    _slab_launch_gate(label, launches, {
        k: P * v * n for k, v in SHARDED_KERNELS[kind].items()})
    launches = check_instances(label, scheme.kernel_name, launches)
    g = sh.gather_scene(parts)
    rows = torch.arange(scene.n, device=scene.device)
    x0 = {k: scene[k] for k in ("x", "y", "z")[:scheme.dim] + ("xcm",)
          if k in scene}
    w = _slab_compare(label, g, rows, single, rows, keys, body, x0,
                      SLAB_ULPS)
    if tables:
        pick = lambda sc: _sorted_tables(sc.with_fields(**{
            k: sc[k][:scene.n] for k in ("tng_idx", "tng_idx_dem_id",
                                         "tng_x", "tng_y", "tng_z")}))
        (ka, sa), (kb, sb) = pick(g), pick(single)
        bad = int((ka != kb).any(1).sum())
        check(bad == 0, f"{label}: {bad} rows hold other contacts")
        d = (sa - sb).abs()
        check(bool((d <= STEP_RTOL * sb.abs()
                    + STEP_RTOL * float(sb.abs().max())).all()),
              f"{label}: springs off by {float(d.max()):.3e}")
        w.append(f"tables equal (springs {float(d.max()):.3e})")
    a_step = {k: v / (P * n) for k, v in launches.items()
              if v and "/" not in k and "[" not in k}
    print(f"[sharded] {label}: P={P} blocks of {parts[0].n} rows, n="
          f"{scene.n} (padded {padded.n}): {n} sharded steps vs {n} "
          "single-device steps on the padded scene: " + ", ".join(w)
          + f" | launches a block a step {a_step} | sharded {sps:.2f} "
          f"steps/s, single-device {sps1:.2f} steps/s (over {n} steps); "
          f"overflow retries: {'; '.join(retries) or 'none'}; on {smi}",
          flush=True)
    return dict(launches=launches, sps=sps, sps_single=sps1, n=scene.n,
                n_pad=padded.n, per_block_step=a_step, retries=retries)


def phase_sharded(dev, smi):
    """53. The row-sharded step (``parallel/sharded.py``: each block's
    rows the queries, every other block's rows source-only ghosts, the
    scheme's own grid on every block) on SLAB_P blocks of the card: the
    2D stack (phase 4's, the compact route through its ``slot_blob``, the
    bodies sliding), the DEM column (phase 7's) and the sinking box in
    kdkf (phase 11's), each as ``_sharded_run``.  Returns {path:
    numbers}."""
    t0 = time.perf_counter()
    out = {}
    scheme, scene, _ = contact_scene_2d(dev)
    check("cl_pid" in scene, "phase 53: the stack is not compact")
    slide = np.random.default_rng(17).uniform(-SLAB_SLIDE, SLAB_SLIDE,
                                              (scene.meta.nb, 3))
    slide[:, 2] = 0.0
    scene = scheme.set_linear_velocity(scene, slide)
    out["rigid"] = _sharded_run("sharded-rigid-2d", scheme, scene, DT,
                                "rigid", ("x", "y", "u", "v"),
                                ("xcm", "vcm", "omega"), smi)
    del scheme, scene
    scheme, scene = dem_scene(dev, 2)
    scheme.cell_config(scene)           # sized on the unpadded scene
    out["dem"] = _sharded_run(
        "sharded-dem-2d", scheme, scene, DEM_DT, "dem",
        ("x", "y", "u", "v", "wz", "fx", "fy", "torz"), (), smi,
        tables=True)
    del scheme, scene
    scheme, scene, dt = sinking_box_scene(dev)
    check(scheme.gtvf_ordering == "kdkf", "phase 53: not kdkf")
    out["kdkf"] = _sharded_run("sharded-coupling-kdkf-2d", scheme, scene,
                               dt, "kdkf", ("x", "y", "u", "v", "rho", "p"),
                               ("xcm", "vcm", "omega"), smi)
    print(f"[sharded] phase 53 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from rigid_body_2d_3d_pysph_tpu_torch import config
        from rigid_body_2d_3d_pysph_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}",
              file=sys.stderr)
        return 3

    try:
        # 1. environment
        smi = smi_line()
        print(f"[env] python {sys.version.split()[0]} torch "
              f"{torch.__version__} cuda {torch.version.cuda} "
              f"devices {torch.cuda.device_count()}", flush=True)
        print(f"[env] {smi}", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = config.device()

        # 2. build: one nvcc per source, all started together, the
        # non-quintic libraries of phase 39 with them
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        jobs = [(name, "quintic") for name in _build.SOURCES] + sph_jobs()
        with ThreadPoolExecutor(len(jobs)) as pool:
            all_built = list(pool.map(lambda j: _build.build(*j), jobs))
        build_wall = time.perf_counter() - t0
        built = dict(zip(_build.SOURCES, all_built))
        sph_built = all_built[len(_build.SOURCES):]
        for name, (path, sec) in built.items():
            print(f"[build] {name}: {sec:.2f} s -> "
                  f"{os.path.relpath(path, ROOT)}", flush=True)
            for line in _build.BUILD_LOG.get(name, "").splitlines():
                if "registers" in line or "spill" in line \
                        or "entry function" in line:
                    print(f"[build] {name}: {line.strip()}", flush=True)
        for k in _build.KERNELS:
            _build.load(k)
        print(f"[build] all sources and the {len(sph_built)} non-quintic "
              f"libraries in {build_wall:.2f} s wall", flush=True)

        print(f"[time] phase 3 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 3. kernels against twins
        t0 = time.perf_counter()
        scheme, scene, dx = contact_scene_2d(dev)
        cfg = scheme._cell_cfg
        print(f"[setup] 2D: n={scene.n} cfg={cfg} ni_max={scheme.ni_max(cfg)} "
              f"boundary particles {int(scene.is_boundary.sum())} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        timings = {}
        phase_kernels(scheme, scene, "2D", timings)
        t0 = time.perf_counter()
        scheme3, scene3, dx3 = contact_scene_3d(dev)
        print(f"[setup] 3D: n={scene3.n} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        phase_kernels(scheme3, scene3, "3D", timings)

        print(f"[time] phase 4 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 4. the main path
        end, launches, main_stats = phase_main_path(scheme, scene, dx, smi)

        print(f"[time] phase 5 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 5. kernel steps against twin steps; 34. against list steps
        phase_step_parity(scheme, end)
        phase_engine_parity_rigid(scheme, end, "engine-parity-2d")
        del scheme, scene, end

        # 5a. the 3D main path from the 3D scene's set-up state, 5b. its
        # kernel steps against twin steps
        end3, launches3, stats3 = phase_main_path(scheme3, scene3, dx3, smi,
                                                  "main-3d")
        phase_step_parity(scheme3, end3)
        del scheme3, scene3, end3

        print(f"[time] phase 6 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 6. DEM kernels against twins
        dem_t = {}
        for label, dim, grid in (("2D spill", 2, "spill"),
                                 ("3D spill", 3, "spill"),
                                 ("2D rowwin", 2, "rowwin"),
                                 ("3D rowwin", 3, "rowwin")):
            t0 = time.perf_counter()
            dscheme, dscene = dem_scene(dev, dim, grid)
            print(f"[dem-setup] {label}: n={dscene.n} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            phase_dem_kernels(dscheme, dscene, label, dem_t,
                              crowded=dim == 2)
            del dscheme, dscene

        print(f"[time] phase 7 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 7. the DEM main path (spill grid), 8. the row-window path
        dscheme, dscene = dem_scene(dev, 2)
        dend, dem_launches, dem_sps = phase_dem_main(
            dscheme, dscene, DEM_STEPS, "dem-main", smi)
        rscheme, rscene = dem_scene(dev, 2, "rowwin")
        _, rw_launches, rw_sps = phase_dem_main(
            rscheme, rscene, DEM_ROWWIN_STEPS, "dem-rowwin", smi)
        del rscheme, rscene

        print(f"[time] phase 9 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 9. DEM kernel steps against twin steps; 34. against list steps
        phase_dem_parity(dscheme, dend)
        phase_dem_parity(dscheme, dend, other=list_twin(dscheme),
                         label="dem-engine-parity")
        del dscheme, dend

        print(f"[time] phase 10 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 10. coupling kernels against twins: the main path's scene (timed)
        # and the contact placement; 14. the split passes on the same two
        fl_t, sp_t, k1_t = {}, {}, {}
        for label, floor in (("sinking box", False), ("box on floor", True)):
            t0 = time.perf_counter()
            cscheme, cscene, cdt = sinking_box_scene(dev, floor=floor)
            print(f"[cpl-setup] {label}: n={cscene.n} dt={cdt:.6g} "
                  f"cfg={cscheme._cell_cfg} boundary particles "
                  f"{int(cscene.is_boundary.sum())} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            gated, _ = phase_fluid_kernels(cscheme, cscene, label, fl_t,
                                        timed=not floor,
                                        k1=None if floor else k1_t)
            _, n_pick = phase_split_kernels(cscheme, cscene, label, sp_t,
                                            timed=not floor)
            if floor:
                check(gated > 0 and n_pick > 0,
                      "no gated contact pair on the floor")
            else:
                mscheme, mscene = cscheme, cscene
        del cscheme, cscene

        print(f"[time] phase 11 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 11. the coupling main path (the sinking box, fused kdkf)
        _, cpl_launches, cpl_sps = phase_coupling_main(
            mscheme, mscene, cdt, CPL_STEPS, "cpl-main", smi,
            dict(pack_expand=1, fluid_rates_wall=1, fluid_forces_contact=1))

        print(f"[time] phase 12 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 12. the fluid-only tank (no rigid body: B6c in B5's place): its
        # passes against their twins on its pack (timed), then its path
        tscheme, tscene, tdt = sinking_box_scene(dev, body=False)
        phase_fluid_kernels(tscheme, tscene, "tank", fl_t, timed=True)
        _, tank_launches, tank_sps = phase_coupling_main(
            tscheme, tscene, tdt, CPL_TANK_STEPS, "cpl-tank", smi,
            dict(pack_expand=1, fluid_rates_wall=1, fluid_forces=1))
        del tscheme, tscene

        print(f"[time] phase 13 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 13. coupling kernel steps against twin steps
        pscheme, pscene, pdt = sinking_box_scene(dev, floor=True,
                                                 rho_b=CPL_PARITY_RHO)
        phase_coupling_parity(pscheme, pscene, pdt)

        print(f"[time] phase 15 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 15. the kdk ordering, 16. the reference ordering, from the
        # sinking box's set-up state
        split = dict(fluid_rates=1, wall_bc=1, fluid_forces=1, contact=1)
        sps_by, launches_by = {}, {}
        for ordering, n_pack in (("kdk", 2), ("reference", 1)):
            mscheme.gtvf_ordering = ordering
            _, launches_by[ordering], sps_by[ordering] = phase_coupling_main(
                mscheme, mscene, cdt, CPL_STEPS, f"cpl-{ordering}", smi,
                dict(split, pack_expand=n_pack))
        del mscheme, mscene

        print(f"[time] phase 17 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 17. the no-fluid route on the resting stack
        t0 = time.perf_counter()
        nscheme, nscene, _ = contact_scene_2d(dev, coupling=True)
        print(f"[nofluid-setup] n={nscene.n} cfg={nscheme._cell_cfg} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        from rigid_body_2d_3d_pysph_tpu_torch.ops import contact_kernel
        from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel
        nkernel = get_kernel(nscheme.kernel_name, 2)
        ncfg = nscheme.cell_config(nscene, nkernel)
        ngrid, _, ndfT = contact_kernel.pack_scene(nscene, ncfg,
                                                     want_dense_pos=True)
        nf_k2, n_pick = contact_all_slots(
            ndfT, ngrid, ncfg, nkernel,
            nscene.meta.total_no_bodies, 4.0 * nscene.meta.spacing0,
            "stack (no fluid)", timed=True)
        check(n_pick > 0, "no contact pick on the stack")
        del ngrid, ndfT
        _, nf_launches, nf_sps = phase_coupling_main(
            nscheme, nscene, DT, CPL_NOFLUID_STEPS, "cpl-nofluid", smi,
            dict(pack_expand=1, contact=1))
        del nscheme, nscene

        print(f"[time] phase 18 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 18. kdk and reference kernel steps against twin steps; 34.
        # against list steps
        for ordering in ("kdk", "reference"):
            pscheme.gtvf_ordering = ordering
            phase_coupling_parity(pscheme, pscene, pdt, f"{ordering}-parity")
            phase_coupling_parity(pscheme, pscene, pdt,
                                  f"{ordering}-engine-parity",
                                  other=list_twin(pscheme))
        del pscheme, pscene

        print(f"[time] phase 19 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 19. every fluid pass on the 3D sinking box
        t0 = time.perf_counter()
        scheme3f, scene3f = sinking_box_scene_3d(dev)
        print(f"[cpl3d-setup] n={scene3f.n} cfg={scheme3f._cell_cfg} "
              f"boundary particles {int(scene3f.is_boundary.sum())} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        fl3_t = {}
        phase_fluid_3d(scheme3f, scene3f, fl3_t, k1_t)

        print(f"[time] phase 20 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 20. the 3D coupling step through the Solver, and its 20-step
        # parity; 21. benchmark 5 (2D, two cubes) to its tf with its gate;
        print(f"[time] phase 22 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 22. the sinking box at the case's size: snapshots, checkpoint,
        # resume bit for bit
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            cpl3d_launches, cpl3d_sps = phase_coupling_3d(
                scheme3f, scene3f, tmp, smi)
            del scheme3f, scene3f
            b5_launches, b5_sps = phase_benchmark_5(tmp, smi)
            sbr_launches, sbr_sps = phase_sinking_box_resume(tmp, smi)

        print(f"[time] phase 23 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 23. the rigid RK2 step on the resting stack, and its parity
        t0 = time.perf_counter()
        kscheme, kscene, kdx = contact_scene_2d(dev, integrator="rk2")
        print(f"[rk2-setup] n={kscene.n} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        kend, rk2_launches, rk2_stats = phase_main_path(
            kscheme, kscene, kdx, smi, "rigid-rk2", STEPPER_STEPS, evals=2)
        phase_step_parity(kscheme, kend, "rk2-parity")
        del kscheme, kscene, kend

        print(f"[time] phase 24 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 24. the leapfrog step on the 3D cubes, and its parity
        t0 = time.perf_counter()
        lscheme, lscene, ldx = contact_scene_3d(dev, integrator="leapfrog")
        print(f"[leapfrog-setup] n={lscene.n} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        lend, lf_launches, lf_stats = phase_main_path(
            lscheme, lscene, ldx, smi, "rigid-leapfrog", STEPPER_STEPS)
        phase_step_parity(lscheme, lend, "leapfrog-parity")
        del lscheme, lscene, lend

        print(f"[time] phase 25 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 25. the RK2 coupling step (Tait) on the sinking box, and its
        # parity on the contact placement
        rscheme, rscene, rdt = sinking_box_scene(dev)
        rscheme.edac, rscheme.fluid_stepper = False, "rk2"
        _, crk2_launches, crk2_sps = phase_coupling_main(
            rscheme, rscene, rdt, CPL_STEPS, "cpl-rk2", smi,
            dict(pack_expand=2, fluid_rates=2, wall_bc=2, fluid_forces=2,
                 contact=2))
        del rscheme, rscene
        pscheme, pscene, pdt = sinking_box_scene(dev, floor=True,
                                                 rho_b=CPL_PARITY_RHO)
        pscheme.edac, pscheme.fluid_stepper = False, "rk2"
        phase_coupling_parity(pscheme, pscene, pdt, "rk2-cpl-parity")
        del pscheme, pscene

        print(f"[time] phase 26 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 26. the LVCForce DEM step on the column
        fscheme, fscene = dem_scene(dev, 2, contact_model="LVCForce")
        _, lvcf_launches, lvcf_sps = phase_dem_main(
            fscheme, fscene, LVCF_STEPS, "dem-lvcforce", smi)
        del fscheme, fscene

        print(f"[time] phase 27 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 27. benchmark 2 to its tf through the Application
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            b2_launches, b2_sps = phase_benchmark_2(tmp, smi)

        print(f"[time] phase 28 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 28. the rigid slab step on phase 4's stack, SLAB_P slabs on the
        # card (blob route), its 200-step run with redistributions, and
        # the steps/s of one slab
        from rigid_body_2d_3d_pysph_tpu_torch.ops.kernels import get_kernel
        sscheme, sscene, sdx = contact_scene_2d(dev)
        slab2 = phase_slab_rigid(sscheme, sscene, sdx, smi, "slab-rigid-2d",
                                 SLAB_P, long_steps=N_STEPS,
                                 single_steps=2 * CHUNK)
        del sscheme, sscene

        print(f"[time] phase 29 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 29. the 3D cubes on the most slabs of at least 2 cell columns,
        # the blob and the full [N, S] routes
        s3scheme, s3scene, s3dx = contact_scene_3d(dev)
        P3 = largest_slab_count(s3scheme.cell_config(
            s3scene, get_kernel(s3scheme.kernel_name, 3)))
        slab3 = phase_slab_rigid(s3scheme, s3scene, s3dx, smi,
                                 "slab-rigid-3d", P3, routes=("blob", "full"),
                                 one_slab_ref=True)
        del s3scheme, s3scene

        print(f"[time] phase 30 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 30. the DEM slab step on phase 7's column
        slab_t = {}
        slabd = phase_slab_dem(smi, SLAB_P, dev, slab_t)

        print(f"[time] phase 31 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 31. the 2D rigid slab step with one slab a card
        n_cards = torch.cuda.device_count()
        slab_cards = None
        if n_cards >= 2:
            P_cards = min(n_cards, SLAB_P)
            cscheme, cscene, cdx = contact_scene_2d(dev)
            slab_cards = phase_slab_rigid(
                cscheme, cscene, cdx, smi, "slab-rigid-2d-cards", P_cards,
                devices=[torch.device("cuda", d) for d in range(P_cards)])
            del cscheme, cscene
        else:
            print("[slab-rigid-2d-cards] not run: one card on this machine "
                  "(the phase puts one slab on each of 2-4 cards)",
                  flush=True)

        print(f"[time] phase 32 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 32. the coupling slab step on the sinking box, kdk and kdkf on
        # SLAB_P slabs of the card, each with its 200-step run; 33. the
        # 3D box, kdkf
        cpl_slab_t = {}
        slabc = {o: phase_slab_coupling(
            smi, dev, o, 2, SLAB_P, cpl_slab_t, long_steps=N_STEPS,
            single_steps=2 * CHUNK if o == "kdkf" else 0)
            for o in ("kdk", "kdkf")}
        slabc3 = phase_slab_coupling(smi, dev, "kdkf", 3, SLAB_P, cpl_slab_t)

        print(f"[time] phase 35 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 35-38. the [N, K] list engine on the cell paths' scenes
        t_list = time.perf_counter()
        lists = {}
        t0 = time.perf_counter()
        lscheme, lscene, ldx = contact_scene_2d(dev, engine="nklist")
        print(f"[list-setup] 2D stack: n={lscene.n} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        lists["rigid-2d"] = phase_main_path(
            lscheme, lscene, ldx, smi, "list-rigid-2d", LIST_STEPS)[2]
        del lscheme, lscene
        for integ in ("gtvf", "leapfrog"):
            t0 = time.perf_counter()
            lscheme, lscene, ldx = contact_scene_3d(dev, integrator=integ,
                                                    engine="nklist")
            print(f"[list-setup] 3D cubes ({integ}): n={lscene.n} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            lists[f"rigid-3d-{integ}"] = phase_main_path(
                lscheme, lscene, ldx, smi, f"list-rigid-3d-{integ}",
                LIST_3D_STEPS)[2]
            del lscheme, lscene
        for model, n_list in (("LVCDisplacement", LIST_STEPS),
                              ("LVCForce", COMPARE_STEPS)):
            lscheme, lscene = dem_scene(dev, 2, contact_model=model,
                                        engine="nklist")
            lists[f"dem-{model}"] = phase_dem_main(
                lscheme, lscene, n_list, f"list-dem-{model}", smi)[2]
            del lscheme, lscene
        lscheme, lscene, ldt = sinking_box_scene(dev, engine="nklist")
        for ordering in ("kdk", "reference"):
            lscheme.gtvf_ordering = ordering
            lists[f"coupling-{ordering}"] = phase_coupling_main(
                lscheme, lscene, ldt, CPL_STEPS, f"list-cpl-{ordering}",
                smi, {})[2]
        del lscheme, lscene
        print(f"[list] phases 35-38 in {time.perf_counter() - t_list:.1f} "
              "s", flush=True)

        print(f"[time] phase 39 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 39. the non-quintic SPH kernels' K2 and fluid instances against
        # their twins (their libraries built first, all together); 40.
        # the main paths with each of them; 41. the Verlet skin
        t_sph = time.perf_counter()
        sph_build, sph_build_s = build_sph_instances(sph_built, build_wall)
        sph_t = {}
        phase_sph_kernels(dev, sph_t)
        sph_paths = phase_sph_main_paths(dev, smi)
        skin_launches, skin_stats = phase_skin(dev, smi)
        print(f"[sph] phases 39-41 in {time.perf_counter() - t_sph:.1f} s",
              flush=True)

        print(f"[time] phase 42 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 42. the compact store on the 2D boxes' scene, 43. in 3D
        t_cc = time.perf_counter()
        cc2_launches, cc2 = phase_coupling_compact(dev, 2, CPL_BOXES_STEPS,
                                                   smi)
        cc3_launches, cc3 = phase_coupling_compact(
            dev, 3, CPL_BOXES_3D_STEPS, smi)
        print(f"[compact] phases 42-43 in {time.perf_counter() - t_cc:.1f} "
              "s", flush=True)
        print(f"[time] phase 44 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 44. K2's wide instance on the 2D stack of 128 blocks and at S =
        # 300; 45. on every slot of 64 cubes, and B5 by query row at S =
        # 301 and 129; 46. the DEM kernels' wide tables
        t_w = time.perf_counter()
        wide_k2 = phase_wide_rigid(dev, smi)
        wide_b5 = phase_wide_3d_b5(dev, smi)
        wide_dem = phase_wide_dem(dev, smi)
        print(f"[wide] phases 44-46 in {time.perf_counter() - t_w:.1f} s",
              flush=True)
        print(f"[time] phase 47 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 47. the rigid GTVF step on classic grids (2D stack, its sub = 2
        # stencil, 3D cubes); 48. the kdk coupling ordering on one; 49.
        # kdk on the 3D box's classic grid, its split passes also at 176
        # lanes
        t_c = time.perf_counter()
        classic_rigid = phase_classic_rigid(dev, smi)
        print(f"[time] phase 48 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        classic_cpl = phase_classic_coupling(dev, smi)
        print(f"[classic] phases 47-49 in {time.perf_counter() - t_c:.1f} "
              "s", flush=True)
        print(f"[time] phase 50 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 50. the DEM column at (8, 32) and K4 / K3 at 4, 24, 64, 128
        # lanes; 51. kdkf on a 48-lane spill grid (and its compact store),
        # B4 and B5 on the 3D boxes at 64; 52. the slab steps on classic
        # bases
        t_l = time.perf_counter()
        dem_lanes = phase_dem_lanes(dev, smi)
        print(f"[time] phase 51 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        cpl_lanes = phase_coupling_lanes(dev, smi)
        print(f"[time] phase 52 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        slab_classic = phase_slab_classic(dev, smi)
        print(f"[lanes] phases 50-52 in {time.perf_counter() - t_l:.1f} s",
              flush=True)
        print(f"[time] phase 53 from "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        # 53. the row-sharded step: the stack, the DEM column and the
        # sinking box (kdkf) on SLAB_P blocks of the card
        sharded = phase_sharded(dev, smi)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    t2, t3 = timings["2D"], timings["3D"]
    errs = lambda k: max(timings[lab][k] for lab in timings)
    src = "rigid_body_2d_3d_pysph_tpu_torch/csrc/"
    # each path's launches, read from its own counts (reset just before it)
    by_path = lambda k: {p: c[k] for p, c in (
        ("rigid", launches), ("rigid-3d", launches3),
        ("dem-main", dem_launches),
        ("dem-rowwin", rw_launches), ("coupling", cpl_launches),
        ("coupling-tank", tank_launches),
        ("coupling-kdk", launches_by["kdk"]),
        ("coupling-reference", launches_by["reference"]),
        ("coupling-nofluid", nf_launches), ("coupling-3d", cpl3d_launches),
        ("benchmark-5-2d", b5_launches),
        ("sinking-box-case", sbr_launches), ("rigid-rk2", rk2_launches),
        ("rigid-leapfrog", lf_launches), ("coupling-rk2", crk2_launches),
        ("dem-lvcforce", lvcf_launches), ("benchmark-2", b2_launches),
        ("slab-rigid-2d", slab2["launches_long"]),
        ("slab-rigid-3d", {q: slab3["launches"]["blob"][q]
                           + slab3["launches"]["full"][q]
                           for q in slab3["launches"]["blob"]}),
        ("slab-dem-2d", slabd["launches_long"]),
        ("slab-coupling-kdk-2d", slabc["kdk"]["launches_long"]),
        ("slab-coupling-kdkf-2d", slabc["kdkf"]["launches_long"]),
        ("slab-coupling-kdkf-3d", slabc3["launches"]),
        ("coupling-compact-2d", cc2_launches),
        ("coupling-compact-3d", cc3_launches),
        ("classic-cpl-kdkf", classic_cpl["launches_f"]),
        ("classic-cpl-kdkf-3d", classic_cpl["launches3f"]),
        ("classic-cpl-kdkf-3d-wide", classic_cpl["launchesw"]),
        ("sharded-rigid-2d", sharded["rigid"]["launches"]),
        ("sharded-dem-2d", sharded["dem"]["launches"]),
        ("sharded-coupling-kdkf-2d", sharded["kdkf"]["launches"]))
        + ((("slab-rigid-2d-cards", slab_cards["launches"]["blob"]),)
           if slab_cards else ())
        if c.get(k)}
    fluid_err = lambda k: max(fl_t[lab][k]["err"] for lab in fl_t
                              if k in fl_t[lab])
    split_err = lambda k: max(sp_t[lab][k]["err"] for lab in sp_t)
    sb = sp_t["sinking box"]
    k2all = sb["contact_all_slots"]
    kernels = [
        dict(name="pack_expand", route="cuda", source=src + "pack_expand.cu",
             replaces="rigid_body_2d_3d_pysph_tpu/ops/pallas_pack.py:47",
             launches=launches["pack_expand"],
             launches_by_path=by_path("pack_expand"),
             max_abs_err=errs("pack_err"),
             ms=t2["pack_ms"], plain_ms=t2["pack_plain_ms"],
             bound_ms=t2["pack_bound"], bound_by=t2["pack_bound_by"],
             library_ms=None,
             # the 3D rigid pack (F = 9); the coupling packs (F = 14) of
             # the sinking box and of the 3D box
             ms_3d=t3["pack_ms"], plain_ms_3d=t3["pack_plain_ms"],
             bound_ms_3d=t3["pack_bound"],
             coupling_ms=k1_t["sinking box"]["ms"],
             coupling_plain_ms=k1_t["sinking box"]["plain_ms"],
             coupling_bound_ms=k1_t["sinking box"]["bound_ms"],
             coupling_3d_ms=k1_t["3D box"]["ms"],
             coupling_3d_bound_ms=k1_t["3D box"]["bound_ms"]),
        dict(name="contact_sums", route="cuda", source=src + "contact.cu",
             replaces="rigid_body_2d_3d_pysph_tpu/ops/pallas_contact.py:96",
             launches=launches["contact"],
             launches_by_path=by_path("contact"),
             max_abs_err=max(errs("contact_err"), split_err(
                 "contact_all_slots"), nf_k2["err"]),
             ms=t2["contact_ms"], plain_ms=t2["contact_plain_ms"],
             bound_ms=t2["contact_bound"],
             bound_by=t2["contact_bound_by"], library_ms=None,
             old_bound_ms=t2["contact_old_bound"],
             # 3D: at the 3D scene's set-up ni_max, and on every
             # interesting row (the rows the 3D path runs after its
             # overflow rebuilds)
             ms_3d=t3["contact_ms"], plain_ms_3d=t3["contact_plain_ms"],
             bound_ms_3d=t3["contact_bound"],
             ms_3d_all_rows=t3["contact_all_rows_ms"],
             plain_ms_3d_all_rows=t3["contact_all_rows_plain_ms"],
             bound_ms_3d_all_rows=t3["contact_all_rows_bound"],
             rows_3d_all_rows=t3["contact_all_rows"],
             # on every slot: the coupling orderings' cell pipeline
             all_slots_ms=k2all["ms"], all_slots_plain_ms=k2all["plain_ms"],
             all_slots_bound_ms=k2all["bound_ms"],
             all_slots_bound_by=k2all["bound_by"],
             all_slots_old_bound_ms=k2all["old_bound_ms"],
             all_slots_rows_unpack_ms=k2all["rows_unpack_ms"],
             nofluid_all_slots_ms=nf_k2["ms"],
             nofluid_all_slots_bound_ms=nf_k2["bound_ms"],
             # on every slot of the 3D pack: the leapfrog path's
             all_slots_ms_3d=t3["contact_all_slots_ms"],
             all_slots_plain_ms_3d=t3["contact_all_slots_plain_ms"],
             all_slots_bound_ms_3d=t3["contact_all_slots_bound"]),
    ]
    # each timed on its main path's 2D scene, the 3D scene beside it
    for name, line, path_launches, grid in (
            ("dem_cell", 340, dem_launches, "spill"),
            ("dem_rowwin", 546, rw_launches, "rowwin")):
        d2, d3 = dem_t[f"2D {grid}"], dem_t[f"3D {grid}"]
        kernels.append(dict(
            name=name, route="cuda", source=src + "dem.cu",
            replaces=f"rigid_body_2d_3d_pysph_tpu/ops/pallas_dem.py:{line}",
            launches=path_launches[name], launches_by_path=by_path(name),
            max_abs_err=max(d2["err"], d3["err"]), ms=d2["ms"],
            plain_ms=d2["plain_ms"], bound_ms=d2["bound_ms"],
            bound_by=d2["bound_by"], library_ms=None, ms_3d=d3["ms"],
            plain_ms_3d=d3["plain_ms"], bound_ms_3d=d3["bound_ms"],
            bound_by_3d=d3["bound_by"]))
    # each timed on its first main path's scene, the 3D box beside it
    f3 = fl3_t["3D box"]
    at_3d = lambda k, pre="": {f"{pre}ms_3d": f3[k]["ms"],
                               f"{pre}plain_ms_3d": f3[k]["plain_ms"],
                               f"{pre}bound_ms_3d": f3[k]["bound_ms"],
                               f"{pre}bound_by_3d": f3[k]["bound_by"]}
    for name, line, path_launches, lab in (
            ("fluid_rates_wall", 364, cpl_launches, "sinking box"),
            ("fluid_forces_contact", 590, cpl_launches, "sinking box"),
            ("fluid_forces", 562, tank_launches, "tank")):
        fm = fl_t[lab][name]
        kernels.append(dict(
            name=name, route="cuda", source=src + "fluid.cu",
            replaces=f"rigid_body_2d_3d_pysph_tpu/ops/pallas_fluid.py:{line}",
            launches=path_launches[name], launches_by_path=by_path(name),
            max_abs_err=max(fluid_err(name), f3[name]["err"]), ms=fm["ms"],
            plain_ms=fm["plain_ms"], bound_ms=fm["bound_ms"],
            bound_by=fm["bound_by"], library_ms=None, **at_3d(name),
            **({k: fm[k] for k in ("layout", "old_bound_ms")}
               if name == "fluid_forces_contact" else {})))
    # B4's no-body instance (the fluid-only tank)
    ft = fl_t["tank"]["fluid_rates_wall"]
    kernels[-3].update(
        tank_ms=ft["ms"], tank_plain_ms=ft["plain_ms"],
        tank_bound_ms=ft["bound_ms"], tank_bound_by=ft["bound_by"])
    # B6c's rigid instance (the kdk and reference orderings) beside the
    # tank's no-body one
    fr = sb["fluid_forces_rigid"]
    kernels[-1].update(
        max_abs_err=max(kernels[-1]["max_abs_err"],
                        split_err("fluid_forces_rigid"),
                        f3["fluid_forces_rigid"]["err"]),
        rigid_ms=fr["ms"], rigid_plain_ms=fr["plain_ms"],
        rigid_bound_ms=fr["bound_ms"], rigid_bound_by=fr["bound_by"],
        **at_3d("fluid_forces_rigid", "rigid_"))
    # the templates' resources, the 2D instances these paths launch: B4
    # with and without bodies (EDAC), B5, B6c without and with bodies (with
    # viscosity)
    for k, pre, res in (
            (-3, "", rates_resources(True, True, 0,
                                     fl_t["sinking box"]["fluid_rates_wall"])),
            (-3, "tank_", rates_resources(True, False, 0, ft)),
            (-2, "", forces_resources(
                True, True, fl_t["sinking box"]["fluid_forces_contact"])),
            (-1, "", forces_resources(False, False,
                                      fl_t["tank"]["fluid_forces"])),
            (-1, "rigid_", forces_resources(True, False, fr))):
        kernels[k].update({pre + key: v for key, v in res.items()})
    for name, line, mode in (("fluid_rates", 302, 1), ("wall_bc", 460, 2)):
        fm = sb[name]
        entry = dict(
            name=name, route="cuda", source=src + "fluid.cu",
            replaces=f"rigid_body_2d_3d_pysph_tpu/ops/pallas_fluid.py:{line}",
            launches=launches_by["kdk"][name], launches_by_path=by_path(name),
            max_abs_err=max(split_err(name), f3[name]["err"]),
            ms=fm["ms"], plain_ms=fm["plain_ms"], bound_ms=fm["bound_ms"],
            bound_by=fm["bound_by"], library_ms=None, **at_3d(name),
            **rates_resources(mode == 1, mode == 1, mode, fm))
        if mode == 1:
            ft = sb["fluid_rates_tait"]
            entry.update(
                max_abs_err=max(entry["max_abs_err"],
                                split_err("fluid_rates_tait"),
                                f3["fluid_rates_tait"]["err"]),
                tait_ms=ft["ms"], tait_plain_ms=ft["plain_ms"],
                tait_bound_ms=ft["bound_ms"], tait_bound_by=ft["bound_by"],
                **at_3d("fluid_rates_tait", "tait_"),
                **{"tait_" + k: v for k, v in rates_resources(
                    False, True, 1, ft).items()})
        kernels.append(entry)
    # the slab paths' kernels, slab by slab (phases 28-30)
    cols = ("slab", "n", "n_int", "ms", "plain_ms", "bound", "bound_by",
            "err")
    per = lambda rows, ks=cols: [{k: r[k] for k in ks} for r in rows]
    by_name = {kd["name"]: kd for kd in kernels}
    slab_k2 = slab2["k2"]["blob"] + slab3["k2"]["blob"] + slab3["k2"]["full"]
    by_name["pack_expand"].update(
        slab_rigid_2d_ms=[r["pack_ms"] for r in slab2["k2"]["blob"]],
        slab_rigid_3d_ms=[r["pack_ms"] for r in slab3["k2"]["blob"]])
    by_name["contact_sums"].update(
        max_abs_err=max([by_name["contact_sums"]["max_abs_err"]]
                        + [r["err"] for r in slab_k2]),
        slab_rigid_2d=per(slab2["k2"]["blob"]),
        slab_rigid_3d=per(slab3["k2"]["blob"]),
        slab_rigid_3d_all_slots=per(slab3["k2"]["full"]))
    sd = slab_t["slab-dem-2d"]
    by_name["dem_cell"].update(
        max_abs_err=max([by_name["dem_cell"]["max_abs_err"]]
                        + [r["err"] for r in sd]),
        slab_dem_2d=per(sd, ("slab", "n", "gated", "ms", "plain_ms",
                             "bound_ms", "bound_by", "err")))
    # the coupling slab paths' kernels, slab by slab (phases 32-33)
    ccols = ("slab", "n", "ms", "plain_ms", "bound_ms", "bound_by", "err")
    for name, key in (("pack_expand", "pack_expand"),
                      ("contact_sums", "contact_all_slots"),
                      ("fluid_rates", "fluid_rates"),
                      ("wall_bc", "wall_bc"),
                      ("fluid_rates_wall", "fluid_rates_wall"),
                      ("fluid_forces", "fluid_forces_rigid")):
        kd = by_name[name]
        for path, rows in cpl_slab_t.items():
            got = [dict(slab=r["slab"], n=r["n"],
                        **{c: r[key][c] for c in ccols[2:] if c in r[key]})
                   for r in rows if key in r]
            if got:
                kd[path.replace("-", "_")] = got
                kd["max_abs_err"] = max([kd["max_abs_err"]]
                                        + [r["err"] for r in got
                                           if "err" in r])
    # the non-quintic SPH kernels' instances (phases 39-40): K2 timed on
    # the 2D stack's culled rows, beside it on every slot of the 3D cubes;
    # the fluid passes on the 2D sinking box; launches from the kernel's
    # own main paths (the stack's GTVF, the box's kdkf and kdk)
    for k in SPH_NAMES:
        sk, mp = sph_t[k], sph_paths[k]
        k2, k3 = sk["k2"], sk["k2_3d"]
        kernels.append(dict(
            name=f"contact_sums[{k}]", route="cuda",
            source=src + "contact.cu",
            replaces="rigid_body_2d_3d_pysph_tpu/ops/pallas_contact.py:96",
            launches=mp["rigid"][f"contact[{k}]"],
            launches_by_path={p: mp[p].get(f"contact[{k}]", 0)
                              for p in ("rigid", "kdk")},
            max_abs_err=max(k2["err"], k3["err"], sk["floor_err"]),
            ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound"],
            bound_by=k2["bound_by"], library_ms=None,
            all_slots_ms_3d=k3["ms"], all_slots_plain_ms_3d=k3["plain_ms"],
            all_slots_bound_ms_3d=k3["bound_ms"],
            all_slots_bound_by_3d=k3["bound_by"],
            **contact_resources(k),
            library_seconds=sph_build[f"contact_{k}"]["seconds"]))
        for name, key, line, path, res in (
                ("fluid_rates_wall", "fluid_rates_wall", 364, "kdkf",
                 lambda t: rates_resources(True, True, 0, t, k)),
                ("fluid_forces_contact", "fluid_forces_contact", 590,
                 "kdkf", lambda t: forces_resources(True, True, t, k)),
                ("fluid_rates", "fluid_rates", 302, "kdk",
                 lambda t: rates_resources(True, True, 1, t, k)),
                ("wall_bc", "wall_bc", 460, "kdk",
                 lambda t: rates_resources(False, False, 2, t, k)),
                ("fluid_forces", "fluid_forces_rigid", 562, "kdk",
                 lambda t: forces_resources(True, False, t, k))):
            fm = sk["fluid"][key]
            kernels.append(dict(
                name=f"{name}[{k}]", route="cuda", source=src + "fluid.cu",
                replaces="rigid_body_2d_3d_pysph_tpu/ops/pallas_fluid.py:"
                         f"{line}",
                launches=mp[path][f"{name}[{k}]"],
                launches_by_path={path: mp[path][f"{name}[{k}]"]},
                max_abs_err=max(fm["err"], sk["floor_err"])
                if name == "fluid_forces_contact" else fm["err"],
                ms=fm["ms"], plain_ms=fm["plain_ms"],
                bound_ms=fm["bound_ms"], bound_by=fm["bound_by"],
                library_ms=None, **res(fm),
                library_seconds=sph_build[f"fluid_{k}"]["seconds"]))
    kernels += wide_kernel_entries(kernels, wide_k2, wide_b5, wide_dem,
                                   src)
    kernels += classic_kernel_entries(kernels, classic_rigid, classic_cpl,
                                      src)
    kernels += lanes_kernel_entries(kernels, dem_lanes, cpl_lanes, src)
    kernels += classic_kdkf_entries(kernels, classic_cpl, src)
    dm = dem_lanes["main"]
    print(f"[done] lane widths: DEM M={dm['M']} K4 {dm['ms']:.4f} ms "
          f"(bound {dm['bound_ms']:.4f}), {dm['sps']:.2f} steps/s; K4 / K3 "
          + ", ".join(f"{k} M={M} {v['ms']:.4f} ms" for (k, M), v in
                      sorted(dem_lanes["widths"].items()))
          + f"; kdkf M={cpl_lanes['M']} {cpl_lanes['sps']:.2f} steps/s, "
          + ", ".join(f"{k} {v['ms']:.4f} ms" for k, v in
                      cpl_lanes["fluid"].items())
          + f"; 3D M={cpl_lanes['M3']} " + ", ".join(
              f"{k} {v['ms']:.4f} ms" for k, v in cpl_lanes["fluid3"].items())
          + "; slab steps on classic bases (P = " + str(SLAB_P) + "): "
          + ", ".join(f"{k} M={v['M']} {1.0 / v['s']:.2f} steps/s"
                      for k, v in slab_classic.items()) + f"; on {smi}",
          flush=True)
    print("[done] classic grid: " + "; ".join(
        f"{k} M={r['M']} O={r['O']} K2 {r['k2']['ms']:.4f} ms (bound "
        f"{r['k2']['bound_ms']:.4f}), GTVF "
        f"{r['stats']['steps_per_s']:.2f} steps/s"
        for k, r in classic_rigid.items()) + f"; sinking box kdk M="
        f"{classic_cpl['M']} {classic_cpl['sps']:.2f} steps/s, " + ", ".join(
            f"{k} {v['ms']:.4f} ms" for k, v in classic_cpl["split"].items())
        + f"; 3D box kdk M={classic_cpl['M3']} {classic_cpl['sps3']:.2f} "
        "steps/s, " + ", ".join(
            f"{k} {v['ms']:.4f} ms" for k, v in
            classic_cpl["split3"].items())
        + f"; 3D box M={classic_cpl['Mw']} " + ", ".join(
            f"{k} {v['ms']:.4f} ms" for k, v in
            classic_cpl["splitw"].items()) + f"; on {smi}", flush=True)
    wr, ws, b5 = wide_k2["rows"], wide_k2["slots"], wide_b5["b5"]
    print(f"[done] wide instances: K2 S={wr['S']} {wr['ms']:.4f} ms on "
          f"{wr['rows']} rows, {ws['ms']:.4f} ms on every slot, S=300 "
          f"{wide_k2['rows_300']['ms']:.4f} / "
          f"{wide_k2['slots_300']['ms']:.4f} ms, 3D S=65 every slot "
          f"{wide_b5['slots_3d']['ms']:.4f} ms; GTVF S={wr['S']} "
          f"{wide_k2['stats']['steps_per_s']:.2f} steps/s; B5 S={b5['S']} "
          f"{b5['ms']:.4f} ms, S=129 {wide_b5['b5_129']['ms']:.4f} ms, "
          f"kdkf ({wide_b5['route']}) "
          f"{wide_b5['steps_per_s']:.2f} steps/s; DEM " + ", ".join(
              f"{g} L={L} {v['ms']:.4f} ms ({v['sps']:.2f} steps/s)"
              for (g, L), v in sorted(wide_dem.items()))
          + f"; on {smi}", flush=True)
    print(f"[done] SPH kernels: {len(sph_build)} libraries built with the "
          f"quintic sources in {sph_build_s:.2f} s wall; " + "; ".join(
              f"{k} K2 {sph_t[k]['k2']['ms']:.4f} ms, B4 "
              f"{sph_t[k]['fluid']['fluid_rates_wall']['ms']:.4f} ms, B5 "
              f"{sph_t[k]['fluid']['fluid_forces_contact']['ms']:.4f} ms"
              for k in SPH_NAMES) + f"; skin: "
          f"{skin_stats['steps_per_s']:.2f} steps/s, "
          f"{skin_stats['grid_builds']} grid rebuilds in "
          f"{skin_stats['steps']} steps, K2 {skin_launches['contact']} and "
          f"K1 {skin_launches['pack_expand']} launches; on {smi}",
          flush=True)
    print("[done] compact coupling store (S = 9): " + "; ".join(
        f"{d}D n={c['n']} {c['steps_per_s']:.2f} steps/s over "
        f"{c['steps_run']} steps run, n_interesting {c['n_interesting']} "
        f"of ni_max {c['ni_max']}, rebuilds {c['rebuilds']}, "
        f"{c['engaged']} engaged slots and {c['springs']} spring lanes at "
        f"the end, 20-step steps/s compact {c['route_sps']['compact']:.2f} "
        f"vs full route {c['route_sps']['full']:.2f}"
        for d, c in ((2, cc2), (3, cc3))) + f"; on {smi}", flush=True)
    print(f"[done] slab coupling: 2D kdk P={SLAB_P} "
          f"{slabc['kdk']['sps']:.2f} steps/s, kdkf P={SLAB_P} "
          f"{slabc['kdkf']['sps']:.2f} steps/s, P=1 "
          f"{slabc['kdkf']['sps_p1']:.2f} steps/s; 3D kdkf P={slabc3['P']}; "
          f"on {smi}", flush=True)
    print(f"[done] slab: rigid 2D P={SLAB_P} {slab2['sps']:.2f} steps/s, "
          f"P=1 {slab2['sps_p1']:.2f} steps/s; 3D P={slab3['P']}; DEM 2D "
          f"P={SLAB_P} {slabd['sps']:.2f} steps/s; on {smi}", flush=True)
    print(f"[done] rigid {main_stats['steps_per_s']:.2f} steps/s at "
          f"n={main_stats['n']}, 3D {stats3['steps_per_s']:.2f} steps/s at "
          f"n={stats3['n']}; DEM spill {dem_sps:.2f} steps/s, row-window "
          f"{rw_sps:.2f} steps/s; coupling kdkf {cpl_sps:.2f} steps/s, "
          f"fluid-only tank {tank_sps:.2f} steps/s, kdk "
          f"{sps_by['kdk']:.2f} steps/s, reference "
          f"{sps_by['reference']:.2f} steps/s, no fluid {nf_sps:.2f} "
          f"steps/s, 3D kdkf {cpl3d_sps:.2f} steps/s; benchmark 5 2D "
          f"{b5_sps:.2f} steps/s, sinking box (case size) {sbr_sps:.2f} "
          f"steps/s; rigid RK2 {rk2_stats['steps_per_s']:.2f} steps/s, "
          f"leapfrog 3D {lf_stats['steps_per_s']:.2f} steps/s, coupling RK2 {crk2_sps:.2f} steps/s, DEM "
          f"LVCForce {lvcf_sps:.2f} steps/s, benchmark 2 {b2_sps:.2f} "
          f"steps/s; on {smi}", flush=True)
    sps_of = lambda v: v["steps_per_s"] if isinstance(v, dict) else v
    print("[done] list engine: " + ", ".join(
        f"{k} {sps_of(v):.2f} steps/s" for k, v in lists.items())
        + f"; on {smi}", flush=True)
    print("[done] classic kdkf: 2D box M=" + str(classic_cpl["M"]) + " "
          f"{classic_cpl['sps_f']:.2f} steps/s, 3D box M={classic_cpl['M3']} "
          f"{classic_cpl['sps3f']:.2f} steps/s, M={classic_cpl['Mw']} "
          f"{classic_cpl['spsw']:.2f} steps/s; " + "; ".join(
              f"{lab} " + ", ".join(f"{k} {v['ms']:.4f} ms" for k, v in
                                    t.items() if k in CLASSIC_FUSED)
              for lab, t in (("2D", classic_cpl["b45"]),
                             ("3D", classic_cpl["split3"]),
                             ("3D wide", classic_cpl["splitw"])))
          + f"; on {smi}", flush=True)
    print(f"[done] sharded (P = {SLAB_P}): " + "; ".join(
        f"{k} n={v['n']} {v['sps']:.2f} steps/s against single-device "
        f"{v['sps_single']:.2f}, launches a block a step "
        f"{v['per_block_step']}" for k, v in sharded.items())
        + f"; on {smi}", flush=True)
    print(f"[done] scenes: {scene_build_line()}", flush=True)
    print(f"[done] chip_smoke.py in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
