"""ctypes loader for the host engine of ``native/`` (C++ and OpenMP).

Port of the JAX package's ``sampling/native.py``: uniform and alias walks,
fanout neighbour draws, Struc2Vec's ring distances, the numeric edge-list
parser, the graph build (stable receiver sort, padding, chunk spans) and
the ``sym``/``row`` edge normalisations, over caller-owned numpy buffers.
The same inputs and seed give the arrays of JAX's engine.

The library is compiled at first use with JAX's flags (``g++ -O3
-march=native -fopenmp -shared -fPIC``) into ``build/torch_native/`` at the
repository root, keyed by a hash of the sources, the flags and the host's
CPU (``-march=native`` code built on one CPU can stop with SIGILL on
another). The compiler writes to a name of its own process, the result is
moved into place with ``os.replace``, and a file lock around the build
keeps concurrent processes (test workers) from building it twice. A
missing ``g++``, a failed build or a missing symbol raises with the cause;
nothing falls back to the numpy paths. Two returns are results, not
failures: ``parse_edgelist_native`` gives ``None`` for a file with a token
that is not a plain integer (the caller reads it as strings), and an index
out of range raises ``IndexError`` where the C side returns -1.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
SOURCES = tuple(sorted(NATIVE_DIR.glob("*.cpp")))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_F32 = ctypes.POINTER(ctypes.c_float)
_F64 = ctypes.POINTER(ctypes.c_double)
_INT64, _U64 = ctypes.c_int64, ctypes.c_uint64
#: (restype, argtypes) of every entry of the library.
_ENTRIES = {
    "uniform_walks": (None, [_I64, _I32, _I64, _INT64, _INT64, _U64, _I32]),
    "alias_walks": (None, [_I64, _I32, _F32, _I32, _I64, _INT64, _INT64,
                           _U64, _I32]),
    "sample_neighbors": (None, [_I64, _I32, _I64, _INT64, _INT64, _U64,
                                _I32]),
    "struc2vec_pair_distances": (None, [_I64, _I32, _INT64, _INT64, _I32,
                                        _I32, _INT64, _F64, _I32]),
    "parse_numeric_edgelist": (_INT64, [ctypes.c_char_p, _INT64,
                                        ctypes.c_int, _I64, _I64, _F32]),
    "build_graph_csr": (_INT64, [_I32, _I32, _F32, _INT64, _INT64, _INT64,
                                 _INT64, _INT64, _I32, _I32, _F32, _I32,
                                 _I32]),
    "normalize_edge_weights": (_INT64, [_I32, _I32, _F32, _INT64, _INT64,
                                        ctypes.c_int]),
    "num_threads": (ctypes.c_int, []),
}


def host_cpu() -> tuple[str, str]:
    """(model name, instruction-set flags) of the host CPU from
    ``/proc/cpuinfo``: what ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            first = f.read().split("\n\n", 1)[0]
    except OSError:
        return platform.processor() or platform.machine(), ""
    fields = {}
    for line in first.splitlines():
        key, _, value = line.partition(":")
        fields[key.strip()] = value.strip()
    return (fields.get("model name", platform.machine()),
            fields.get("flags", fields.get("Features", "")))


def library_path() -> Path:
    """The library's path, keyed by the sources, the flags and the host
    CPU."""
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in SOURCES)
        + " ".join((*CXX_FLAGS, *host_cpu())).encode()).hexdigest()
    return BUILD_DIR / f"libgnnengine-{digest[:16]}.so"


def build() -> Optional[str]:
    """Compile the engine unless its library is built already; returns the
    compiler's output when it compiled now, else ``None``. Raises
    ``RuntimeError`` if ``g++`` is missing or fails."""
    out = library_path()
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if out.exists():                   # another process built it
            return None
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found on PATH; the host engine of "
                               "graphneuralnetwork_tpu_torch is built with it")
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"host engine build failed: g++ exited {proc.returncode}:\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)   # atomic: a loader never sees half a library
        return proc.stdout + proc.stderr


def get_lib() -> ctypes.CDLL:
    """The loaded engine, built first if needed (raises if it cannot be
    built or lacks an entry)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            for name, (restype, argtypes) in _ENTRIES.items():
                try:
                    fn = getattr(lib, name)
                except AttributeError as e:
                    raise RuntimeError(
                        f"host engine {library_path()} has no entry "
                        f"{name!r}") from e
                fn.restype, fn.argtypes = restype, argtypes
            _LIB = lib
    return _LIB


def available() -> bool:
    """True once the engine is loaded (it raises where JAX's returns
    False)."""
    return get_lib() is not None


def num_threads() -> int:
    """OpenMP's thread count for the engine's parallel loops."""
    return int(get_lib().num_threads())


def _p(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _check_ids(ids: np.ndarray, n: int, what: str) -> None:
    if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise IndexError(f"{what} out of range [0, {n})")


def _walk_args(indptr, indices, starts, length: int):
    if length < 1:
        raise ValueError(f"walk length must be at least 1, got {length}")
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    starts = np.ascontiguousarray(starts, np.int64).ravel()
    _check_ids(starts, len(indptr) - 1, "walk start")
    return indptr, indices, starts


def uniform_walks_native(indptr, indices, starts, length: int,
                         seed: int) -> np.ndarray:
    """[len(starts), length] int32 uniform walks; a walker at a node
    without neighbours stays there."""
    lib = get_lib()
    indptr, indices, starts = _walk_args(indptr, indices, starts, length)
    out = np.empty((len(starts), length), np.int32)
    lib.uniform_walks(_p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int32),
                      _p(starts, ctypes.c_int64), len(starts), length,
                      seed & 0xFFFFFFFFFFFFFFFF, _p(out, ctypes.c_int32))
    return out


def alias_walks_native(indptr, indices, accept, alias, starts, length: int,
                       seed: int) -> np.ndarray:
    """Weighted walks over per-node alias tables laid out on the CSR edge
    positions (``accept``/``alias`` local to each node's segment)."""
    lib = get_lib()
    indptr, indices, starts = _walk_args(indptr, indices, starts, length)
    accept = np.ascontiguousarray(accept, np.float32)
    alias = np.ascontiguousarray(alias, np.int32)
    if len(accept) != len(indices) or len(alias) != len(indices):
        raise ValueError("accept and alias need one entry per CSR edge")
    out = np.empty((len(starts), length), np.int32)
    lib.alias_walks(_p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int32),
                    _p(accept, ctypes.c_float), _p(alias, ctypes.c_int32),
                    _p(starts, ctypes.c_int64), len(starts), length,
                    seed & 0xFFFFFFFFFFFFFFFF, _p(out, ctypes.c_int32))
    return out


def struc2vec_distances_native(indptr, indices, n_nodes: int, k_max: int,
                               pu, pv) -> tuple:
    """Cumulative per-layer DTW distances of the pairs (pu[p], pv[p]):
    (f [P, k_max+1] float64 with -1 past the pair's layers, n_layers [P]
    int32)."""
    lib = get_lib()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    pu = np.ascontiguousarray(pu, np.int32)
    pv = np.ascontiguousarray(pv, np.int32)
    _check_ids(pu, n_nodes, "pair node")
    _check_ids(pv, n_nodes, "pair node")
    P = len(pu)
    f = np.empty((P, k_max + 1), np.float64)
    nl = np.empty(P, np.int32)
    lib.struc2vec_pair_distances(
        _p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int32),
        n_nodes, k_max, _p(pu, ctypes.c_int32), _p(pv, ctypes.c_int32),
        P, _p(f, ctypes.c_double), _p(nl, ctypes.c_int32))
    return f, nl


def parse_edgelist_native(path: str, weighted: bool = False
                          ) -> Optional[tuple]:
    """(src int64[E], dst int64[E], w float32[E]) of a whitespace edge list
    whose node tokens are all plain integers; ``None`` when a token is not
    (the caller reads the file as strings)."""
    lib = get_lib()
    with open(path, "rb") as f:
        buf = f.read()
    max_edges = buf.count(b"\n") + 1
    src = np.empty(max_edges, np.int64)
    dst = np.empty(max_edges, np.int64)
    w = np.empty(max_edges, np.float32)
    n = lib.parse_numeric_edgelist(
        buf, len(buf), 1 if weighted else 0,
        _p(src, ctypes.c_int64), _p(dst, ctypes.c_int64),
        _p(w, ctypes.c_float))
    if n < 0:
        return None
    return src[:n], dst[:n], w[:n]


def sample_neighbors_native(indptr, indices, nodes, fanout: int,
                            seed: int) -> np.ndarray:
    """[len(nodes) * fanout] int32 neighbours drawn with replacement; a
    node without neighbours repeats itself."""
    lib = get_lib()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    nodes = np.ascontiguousarray(nodes, np.int64).ravel()
    _check_ids(nodes, len(indptr) - 1, "node")
    out = np.empty(len(nodes) * fanout, np.int32)
    lib.sample_neighbors(_p(indptr, ctypes.c_int64),
                         _p(indices, ctypes.c_int32),
                         _p(nodes, ctypes.c_int64), len(nodes), fanout,
                         seed & 0xFFFFFFFFFFFFFFFF, _p(out, ctypes.c_int32))
    return out


def build_graph_native(senders, receivers, edge_weight, n_nodes: int,
                       e_pad: int, row_block: int, edge_chunk: int) -> tuple:
    """Stable receiver sort, padding to ``e_pad`` (zero-weight self loops
    on node ``n_nodes-1``) and the per-``row_block`` chunk spans, byte-exact
    with the numpy build: (s, r, w, chunk_off, chunk_cnt, max_chunks)."""
    lib = get_lib()
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    n_edges = len(senders)
    w_in = (np.ascontiguousarray(edge_weight, np.float32)
            if edge_weight is not None else None)
    s = np.empty(e_pad, np.int32)
    r = np.empty(e_pad, np.int32)
    w = np.empty(e_pad, np.float32)
    n_row_blocks = -(-max(n_nodes, 1) // row_block)
    off = np.empty(n_row_blocks, np.int32)
    cnt = np.empty(n_row_blocks, np.int32)
    max_chunks = lib.build_graph_csr(
        _p(senders, ctypes.c_int32), _p(receivers, ctypes.c_int32),
        _p(w_in, ctypes.c_float) if w_in is not None else None,
        n_edges, n_nodes, e_pad, row_block, edge_chunk,
        _p(s, ctypes.c_int32), _p(r, ctypes.c_int32), _p(w, ctypes.c_float),
        _p(off, ctypes.c_int32), _p(cnt, ctypes.c_int32))
    if max_chunks < 0:
        raise IndexError(
            f"graph build rejected: a receiver outside [0, {n_nodes}) or a "
            f"padding of {e_pad} edges that is not a multiple of "
            f"{edge_chunk} at least {n_edges}")
    return s, r, w, off, cnt, int(max_chunks)


def normalize_edge_weights_native(senders, receivers, edge_weight,
                                  n_nodes: int, mode: str) -> np.ndarray:
    """Degree accumulation over receivers and per-edge normalisation in one
    pass: ``mode`` ``"sym"`` is D^-1/2 A D^-1/2, ``"row"`` D^-1 A over
    incoming edges. Raises ``IndexError`` for an index outside
    [0, n_nodes), as the numpy path does."""
    lib = get_lib()
    senders = np.ascontiguousarray(senders, np.int32)
    receivers = np.ascontiguousarray(receivers, np.int32)
    w = np.array(edge_weight, np.float32, copy=True) \
        if edge_weight is not None else np.ones(len(senders), np.float32)
    rc = lib.normalize_edge_weights(
        _p(senders, ctypes.c_int32), _p(receivers, ctypes.c_int32),
        _p(w, ctypes.c_float), len(senders), n_nodes,
        0 if mode == "sym" else 1)
    if rc < 0:
        raise IndexError(f"an edge index lies outside [0, {n_nodes})")
    return w
