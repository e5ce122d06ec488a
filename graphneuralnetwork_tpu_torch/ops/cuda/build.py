"""Build the CUDA C++ sources in ``csrc/`` with nvcc; load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/torch_kernels/<name>-<hash>.so`` at the repository root,
keyed by a hash of the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source is rebuilt
and an unchanged one is reused. ``build()`` starts one ``nvcc`` per source,
all at once, and waits for all of them. A failed build raises; nothing
falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
            "kernels of graphneuralnetwork_tpu_torch are built with it")
    return path


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    """The library's path, keyed by its source, the shared headers and the
    flags."""
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (default: all of ``csrc/*.cu``) that is
    not built yet, in parallel. Returns ``{name: compiler output}`` for the
    sources compiled now (ptxas prints registers and spills); raises
    ``RuntimeError`` with the compiler output if any build fails."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        jobs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, errors = {}, []
    for name, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            errors.append(f"[{name}] nvcc exited {proc.returncode}:\n{log}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader never
            #                        sees a half-written library
    if errors:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(errors))
    return logs


def load(name: str, entries: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    ``entries`` maps each C entry to its ``argtypes``; every entry returns
    a ``cudaError_t`` as ``int``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.gnn_error_string.argtypes = [ctypes.c_int]
            lib.gnn_error_string.restype = ctypes.c_char_p
            for entry, argtypes in entries.items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero ``cudaError_t``."""
    if err:
        msg = lib.gnn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
