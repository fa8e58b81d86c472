"""The kernel table of ``ops/_build.py`` (and its table of helper
entries) against the C entry points of ``csrc/*.cu``: every entry's
argument types, in order, are those of its ``extern "C"`` signature (a
pointer or the stream as ``void*``, ``int``, ``float``).  ``ctypes``
only finds a mismatch at the first launch on the card; this finds it
here."""

import ctypes
import os
import re

import pytest

from rigid_body_2d_3d_pysph_tpu_torch.ops import _build

_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
          "int": ctypes.c_int, "float": ctypes.c_float}


def _signatures(source):
    with open(os.path.join(_build.CSRC, f"{source}.cu")) as f:
        text = f.read()
    sigs = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        types = []
        for p in params.split(","):
            decl = " ".join(p.split())
            types.append(_TYPES[decl.rsplit(" ", 1)[0].replace(" *", "*")])
        sigs[name] = types
    return sigs


@pytest.mark.parametrize("kernel", sorted(_build.KERNELS)
                         + sorted(_build.HELPERS))
def test_kernel_table_matches_the_c_entry_point(kernel):
    source, entry, argtypes = (_build.KERNELS.get(kernel)
                               or _build.HELPERS[kernel])
    assert source in _build.SOURCES
    sigs = _signatures(source)
    assert entry in sigs, f"{entry} not in csrc/{source}.cu"
    assert argtypes == sigs[entry]


@pytest.mark.parametrize("source,const,module,attr", [
    ("dem", "MAX_M", "dem_kernel", "MAX_LANES"),
    ("fluid", "kMaxLanes", "fluid_kernel", "MAX_LANES"),
    ("dem", "MAX_WIDE_L", "dem_kernel", "MAX_TABLE_WIDTH"),
])
def test_lane_and_table_limits_match_the_sources(source, const, module,
                                                 attr):
    """The wrappers' limits (they raise past them on the card) are the
    kernels' own: every width below is dispatched, so no width the
    wrapper takes can come back refused at launch."""
    import importlib

    with open(os.path.join(_build.CSRC, f"{source}.cu")) as f:
        text = f.read()
    m = re.search(rf"constexpr int {const} = (\d+);", text)
    assert m, f"{const} not in csrc/{source}.cu"
    mod = importlib.import_module(
        f"rigid_body_2d_3d_pysph_tpu_torch.ops.{module}")
    assert int(m.group(1)) == getattr(mod, attr)
