"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<source>.cu`` has a plain C interface (one or more entry
points, ``KERNELS``) and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``<repo>/build/torch_kernels/``, then loaded with ``ctypes``.  The
sources whose kernels evaluate an SPH kernel (``SPH_SOURCES``) are built
once per SPH kernel (``-DRB_SPH_KERNEL=<Kernel.device_id>``; the
quintic's library takes the source's flags alone), each instance at its
first launch.  The
library's file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.  The build
uses only sources in this package and needs no network.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time

from .kernels import KERNELS as SPH_KERNELS

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source extra flags: the contact, DEM and fluid kernels must not
# contract a*b + c into an FMA, or their pair distances drift an ulp from
# the plain versions' and a tie in the closest-source pick, or a gate
# that decides contact-table membership, can flip
EXTRA_FLAGS = {"pack_expand": [], "contact": ["--fmad=false"],
               "dem": ["--fmad=false"], "fluid": ["--fmad=false"]}
SOURCES = tuple(EXTRA_FLAGS)
# the sources built once per SPH kernel (csrc/sph_kernels.cuh)
SPH_SOURCES = ("contact", "fluid")

# kernel -> (source, C entry point, argument types): every pointer and
# the stream are void*, sizes are int
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "pack_expand": ("pack_expand", "pack_expand",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "contact": ("contact", "contact_sums",
                [_P] * 4 + [_I] * 7 + [_F] * 4 + [_P]),
    "dem_cell": ("dem", "dem_cell",
                 [_P] * 12 + [_I] * 6 + [_F, _F, _P]),
    "dem_rowwin": ("dem", "dem_rowwin",
                   [_P] * 13 + [_I] * 6 + [_F, _F, _P]),
    "fluid_rates_wall": ("fluid", "fluid_rates_wall",
                         [_P] * 3 + [_I] * 7 + [_F] * 8 + [_P]),
    "fluid_forces_contact": ("fluid", "fluid_forces_contact",
                             [_P] * 3 + [_I] * 7 + [_F] * 5 + [_P]),
    "fluid_forces": ("fluid", "fluid_forces",
                     [_P] * 3 + [_I] * 7 + [_F] * 4 + [_P]),
    "fluid_rates": ("fluid", "fluid_rates",
                    [_P] * 3 + [_I] * 7 + [_F] * 5 + [_P]),
    "wall_bc": ("fluid", "wall_bc", [_P] * 3 + [_I] * 5 + [_F] * 6 + [_P]),
}
# entry points that launch nothing: the dynamic shared memory (bytes) a
# block of a fluid template takes at (M lanes a slot, W output columns)
HELPERS = {
    "fluid_forces_smem": ("fluid", "fluid_forces_smem", [_I, _I]),
    "fluid_rates_wall_smem": ("fluid", "fluid_rates_wall_smem", [_I, _I]),
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


BUILD_LOG: dict = {}


def instance(name: str, sph: str = "quintic") -> str:
    """The library of source ``name`` for SPH kernel ``sph``: the
    source's name for the quintic, ``<source>_<kernel>`` for another
    (the key of ``BUILD_LOG``)."""
    if sph not in SPH_KERNELS:
        raise ValueError(f"unknown SPH kernel {sph!r}")
    if sph == "quintic":
        return name
    if name not in SPH_SOURCES:
        raise ValueError(f"csrc/{name}.cu evaluates no SPH kernel")
    return f"{name}_{sph}"


def _flags(name: str, sph: str) -> list:
    flags = BASE_FLAGS + EXTRA_FLAGS[name]
    if sph != "quintic":
        flags = flags + [f"-DRB_SPH_KERNEL={SPH_KERNELS[sph].device_id}"]
    return flags


def library_path(name: str, sph: str = "quintic") -> str:
    flags = _flags(name, sph)
    h = hashlib.sha1(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{instance(name, sph)}-{digest}.so")


def build(name: str, sph: str = "quintic") -> tuple[str, float]:
    """Compile ``csrc/<name>.cu`` for SPH kernel ``sph`` unless an
    up-to-date library exists; returns (path, seconds spent compiling).
    The compiler's report (registers, shared memory, spills per kernel)
    goes to ``BUILD_LOG[instance(name, sph)]``, and beside the library
    (``<library>.ptxas``) so that a build reused later still has it."""
    key = instance(name, sph)
    out = library_path(name, sph)
    if os.path.exists(out):
        if key not in BUILD_LOG and os.path.exists(out + ".ptxas"):
            with open(out + ".ptxas") as f:
                BUILD_LOG[key] = f.read()
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_flags(name, sph), "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {key} ({name}.cu):\n"
                           f"{res.stderr}")
    with open(f"{tmp}.ptxas", "w") as f:
        f.write(res.stderr)
    os.replace(f"{tmp}.ptxas", out + ".ptxas")
    os.replace(tmp, out)   # atomic: concurrent builders never see half
    BUILD_LOG[key] = res.stderr
    return out, time.perf_counter() - t0


def ptxas_usage(report: str) -> dict:
    """ptxas's ``-v`` report -> {entry function: {registers, smem (static
    bytes), spill_stores, spill_loads}}."""
    usage, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            usage[entry] = dict(registers=0, smem=0, spill_stores=0,
                                spill_loads=0)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[entry].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[entry]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            usage[entry]["smem"] = int(m.group(1)) if m else 0
    return usage


@functools.lru_cache(maxsize=None)
def load(kernel: str, sph: str = "quintic"):
    """The ctypes function of ``kernel`` (or of a ``HELPERS`` entry) in
    the library of SPH kernel ``sph``, built if needed."""
    source, fname, argtypes = KERNELS.get(kernel) or HELPERS[kernel]
    path, _ = build(source, sph)
    fn = getattr(ctypes.CDLL(path), fname)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


# launches per kernel, counted by the wrappers where they launch (and
# nowhere else), and per (kernel, SPH kernel) as "<kernel>[<sph>]"; a run
# resets them to read how often its path launched
LAUNCHES = {k: 0 for k in KERNELS}
LAUNCHES_SPH: dict = {}


def count(kernel: str, sph: str = "quintic") -> None:
    """One launch of ``kernel`` (of its SPH kernel ``sph`` instance)."""
    LAUNCHES[kernel] += 1
    key = f"{kernel}[{sph}]"
    LAUNCHES_SPH[key] = LAUNCHES_SPH.get(key, 0) + 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_SPH.clear()


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
