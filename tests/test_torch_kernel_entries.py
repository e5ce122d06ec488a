"""The ctypes declarations of the CUDA kernels' C entries against the C
signatures in ``csrc/``.

Every module of ``ops/cuda`` hands ``build.load(name, entries)`` a map from
each ``extern "C"`` entry of ``csrc/<name>.cu`` to its ``argtypes``. A
mismatch (a pointer declared as ``c_int``, an argument too few) truncates
pointers or shifts arguments on the card and is invisible on the CPU,
where no kernel runs. One case per kernel library: the argument count and
the kind of each argument (pointer, int, unsigned, float) must agree, and
every entry of the source must be declared.
"""

import ctypes
import importlib
import pkgutil
import re

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu_torch.ops import cuda as cuda_ops  # noqa: E402
from graphneuralnetwork_tpu_torch.ops.cuda import build  # noqa: E402

_LOAD = re.compile(r'\bload\(\s*"(\w+)"\s*,\s*(\w+)\s*\)')
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)
_CTYPES = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
           ctypes.c_uint32: "unsigned", ctypes.c_float: "float"}


def _entry_maps() -> dict[str, dict]:
    """{library name: the entries map handed to ``build.load``}, read from
    every ``load("<name>", <map>)`` call in ``ops/cuda``."""
    maps = {}
    for info in pkgutil.iter_modules(cuda_ops.__path__):
        module = importlib.import_module(f"{cuda_ops.__name__}.{info.name}")
        with open(module.__file__) as fh:
            source = fh.read()
        for name, var in _LOAD.findall(source):
            entries = getattr(module, var)
            assert maps.setdefault(name, entries) == entries, name
    return maps


def _kind(param: str) -> str:
    param = param.strip()
    if "*" in param:
        return "pointer"
    words = param.split()[:-1]
    if "float" in words:
        return "float"
    if "unsigned" in words or "uint32_t" in words:
        return "unsigned"
    if "int" in words:
        return "int"
    raise AssertionError(f"unknown C parameter kind: {param!r}")


def _c_entries(name: str) -> dict[str, list[str]]:
    source = (build.CSRC_DIR / f"{name}.cu").read_text()
    return {entry: [_kind(p) for p in params.split(",")]
            for entry, params in _ENTRY.findall(source)}


MAPS = _entry_maps()


def test_every_library_is_loaded_with_an_entries_map():
    assert sorted(MAPS) == build.kernel_names()


@pytest.mark.parametrize("name", build.kernel_names())
def test_argtypes_match_c_signatures(name):
    c_entries = _c_entries(name)
    assert c_entries, f"no extern \"C\" int entry in csrc/{name}.cu"
    declared = MAPS[name]
    assert sorted(declared) == sorted(c_entries)
    for entry, argtypes in declared.items():
        kinds = [_CTYPES[t] for t in argtypes]
        assert kinds == c_entries[entry], entry
