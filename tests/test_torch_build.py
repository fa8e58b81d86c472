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
