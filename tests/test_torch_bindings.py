"""The ctypes bindings of the port's CUDA sources, checked without a
compiler: every ``extern "C"`` entry point of ``src/repro_torch/csrc/*.cu``
has an ``argtypes`` table in its wrapper module with the same arity and
types (``c_void_p`` for each pointer and the stream, ``c_int`` for an
``int``, ``c_float`` for a ``float``).  A wrong entry would cut a pointer
to 32 bits or shift every argument, and only on the card."""

import ctypes
import os
import re

import pytest

from repro_torch.kernels import _build, codec, flash_decode, kv_write, \
    quire_dot, rmmec_matmul

TABLES = {**codec._ARGTYPES, **flash_decode._ARGTYPES, **kv_write._ARGTYPES,
          **quire_dot._ARGTYPES, **rmmec_matmul._ARGTYPES}
CTYPE = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
         "float": ctypes.c_float}
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _entry_points():
    """(source file, function name, [C parameter types]) of every
    ``extern "C"`` function of the CUDA sources."""
    found = []
    for name in _build.SOURCES:
        with open(os.path.join(_build.CSRC_DIR, name + ".cu")) as f:
            text = f.read()
        for fn, params in _ENTRY.findall(text):
            types = []
            for p in params.split(","):
                decl = re.sub(r"\bconst\b", "", p)
                decl = re.sub(r"\s*\*\s*", "* ", decl).split()
                types.append("".join(decl[:-1]))
            found.append((name + ".cu", fn, types))
    return found


ENTRIES = _entry_points()


def test_every_source_has_entry_points_and_every_table_a_source():
    assert {src for src, _, _ in ENTRIES} == {
        n + ".cu" for n in _build.SOURCES}
    assert sorted(TABLES) == sorted(fn for _, fn, _ in ENTRIES)


@pytest.mark.parametrize("source,fn,types", ENTRIES,
                         ids=[f"{s}:{f}" for s, f, _ in ENTRIES])
def test_argtypes_match_c_signature(source, fn, types):
    assert fn in TABLES, f"{source}: {fn} has no argtypes table"
    want = [CTYPE[t] for t in types]
    assert TABLES[fn] == want, (
        f"{source}: {fn}({', '.join(types)}) is bound as "
        f"{[t.__name__ for t in TABLES[fn]]}")
    assert types[-1] == "void*", f"{fn}: the stream is the last argument"
