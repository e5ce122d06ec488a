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
