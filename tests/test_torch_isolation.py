"""The PyTorch port, chip_smoke.py, profile_torch.py and soak_tiles.py stand
alone: importing them loads neither JAX nor the JAX package, and no source
of theirs imports either."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "graphneuralnetwork_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "graphneuralnetwork_tpu")
SCRIPTS = ("chip_smoke", "profile_torch", "soak_tiles")


def _port_modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / f"{s}.py" for s in SCRIPTS]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_do_not_import_jax_or_the_jax_package():
    bad = [(str(p.relative_to(ROOT)), m) for p in _sources()
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    modules = list(_port_modules()) + list(SCRIPTS)
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in modules]
        + ["bad = sorted(m for m in sys.modules",
           f"             if m.split('.')[0] in {FORBIDDEN!r})",
           "assert not bad, bad",
           "print(len(sys.modules))"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 20


def _code_strings(path: Path):
    """The string constants of ``path`` that are not docstrings (docstrings
    name the JAX files a module ports; code strings are what it uses)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    getattr(first, "value", None), ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


def test_the_port_uses_no_file_of_the_jax_package():
    """No code of the port names a path under ``graphneuralnetwork_tpu/``:
    no string of its Python code, no ``#include`` of its C++ and CUDA
    sources; and no file of the port or of the scripts names the JAX
    engine's directory or library, so the port's engine builds from,
    loads and writes only its own files."""
    jax_pkg = "graphneuralnetwork_tpu/"
    native = [p for ext in ("*.cpp", "*.cu", "*.cuh")
              for p in PKG.rglob(ext)]
    assert {p.name for p in native} >= {"walker.cpp", "graphbuild.cpp"}
    bad = [(str(p.relative_to(ROOT)), s) for p in sorted(PKG.rglob("*.py"))
           for s in _code_strings(p) if jax_pkg in s]
    bad += [(str(p.relative_to(ROOT)), ln) for p in native
            for ln in p.read_text().splitlines()
            if ln.lstrip().startswith("#include") and jax_pkg in ln]
    bad += [(str(p.relative_to(ROOT)), name) for p in _sources() + native
            for name in (jax_pkg + "native", "libgnnwalker")
            if name in p.read_text()]
    assert not bad, bad


def test_the_parallel_package_and_its_gloo_worker_stand_alone():
    """``parallel/`` is among the modules checked above, and the worker
    that the gloo tests spawn (``tests/torch_world.py``) imports neither
    JAX nor the JAX package: its ranks run the port alone."""
    modules = set(_port_modules())
    assert {f"graphneuralnetwork_tpu_torch.parallel.{m}" for m in (
        "multihost", "collectives", "sharded", "halo", "halo_attention",
        "dp", "dryrun")} <= modules
    worker = ROOT / "tests" / "torch_world.py"
    assert not [m for m in _imported_roots(worker) if m in FORBIDDEN]
