"""The port's host engine (``graphneuralnetwork_tpu_torch/sampling/native.py``
over its copy of ``native/*.cpp``) against the JAX package's on the CPU.

JAX's ``tests/test_native.py`` cases run through the port: walks follow
edges and repeat for a seed; alias walks follow edges; the samplers take
the engine by default; the Struc2Vec distances, the edge-list parser, the
graph build and the normalisations equal the port's numpy paths. The
port's engine gives JAX's engine's arrays for the same inputs and seed:
exactly for walks, alias walks, neighbours, distances, parsed edge lists
and builds, within ``NORM_RTOL`` for the normalisations (their degree
sums run in an order set by the thread count). At the defaults the port's
DeepWalk corpus is JAX's. A compiler that fails or is missing raises, an
index out of range raises ``IndexError``, and a file with string tokens
takes the Python reader.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from graphneuralnetwork_tpu.core import graph as j_graph  # noqa: E402
from graphneuralnetwork_tpu.data import edgelist as j_edgelist  # noqa: E402
from graphneuralnetwork_tpu.models import embedding as j_emb  # noqa: E402
from graphneuralnetwork_tpu.sampling import native as j_native  # noqa: E402
from graphneuralnetwork_tpu.sampling import struc2vec as j_s2v  # noqa: E402
from graphneuralnetwork_tpu_torch.core import graph as t_graph  # noqa: E402
from graphneuralnetwork_tpu_torch.data import edgelist as t_edgelist  # noqa: E402
from graphneuralnetwork_tpu_torch.models import embedding as t_emb  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import native  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import neighbor as t_neighbor  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import struc2vec as t_s2v  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import walks as t_walks  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling.alias import (  # noqa: E402
    build_alias_table)

#: the normalisations' degree sums run in a thread-count order
NORM_RTOL = 1e-6


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def csr():
    rng = np.random.default_rng(42)
    n = 200
    s = rng.integers(0, n, 1500)
    r = rng.integers(0, n, 1500)
    return t_walks.csr_from_edges(s, r, n), n


def test_native_builds():
    assert native.available()
    assert native.library_path().exists()
    assert native.library_path().parent == native.BUILD_DIR
    assert native.num_threads() >= 1


def test_sources_are_the_ports_own():
    assert [p.name for p in native.SOURCES] == ["graphbuild.cpp",
                                                "walker.cpp"]
    assert all(p.parent == native.NATIVE_DIR for p in native.SOURCES)
    assert native.NATIVE_DIR.parent.name == "graphneuralnetwork_tpu_torch"


def test_native_walks_follow_edges(csr):
    (indptr, indices, _), n = csr
    w = native.uniform_walks_native(indptr, indices, np.arange(n), 8, seed=7)
    assert w.shape == (n, 8) and w.dtype == np.int32
    for i in range(n):
        for t in range(7):
            nb = indices[indptr[w[i, t]]:indptr[w[i, t] + 1]]
            assert (w[i, t + 1] in nb) or (len(nb) == 0
                                           and w[i, t + 1] == w[i, t])


def test_native_deterministic_per_seed(csr):
    (indptr, indices, _), n = csr
    starts = np.arange(n, dtype=np.int64)
    w1 = native.uniform_walks_native(indptr, indices, starts, 6, seed=3)
    w2 = native.uniform_walks_native(indptr, indices, starts, 6, seed=3)
    w3 = native.uniform_walks_native(indptr, indices, starts, 6, seed=4)
    _same(w1, w2)
    assert (w1 != w3).any()


def _alias_on_edges(indptr, n, weights):
    accept = np.zeros(indptr[-1], np.float32)
    alias = np.zeros(indptr[-1], np.int32)
    for v in range(n):
        lo, hi = indptr[v], indptr[v + 1]
        if hi > lo:
            accept[lo:hi], alias[lo:hi] = build_alias_table(weights[lo:hi])
    return accept, alias


def test_alias_walks_native_follow_edges(csr):
    (indptr, indices, _), n = csr
    accept, alias = _alias_on_edges(indptr, n, np.ones(len(indices)))
    starts = np.repeat(np.arange(n, dtype=np.int64), 4)
    out = native.alias_walks_native(indptr, indices, accept, alias, starts,
                                    6, seed=9)
    assert out.shape == (4 * n, 6)
    for i in range(0, len(out), 37):
        for t in range(5):
            nb = indices[indptr[out[i, t]]:indptr[out[i, t] + 1]]
            assert (out[i, t + 1] in nb) or (len(nb) == 0)


def test_python_wrappers_use_native(csr, monkeypatch):
    (indptr, indices, _), n = csr
    calls = []
    for name in ("uniform_walks_native", "sample_neighbors_native"):
        monkeypatch.setattr(native, name, functools.partial(
            lambda fn, name, *a: calls.append(name) or fn(*a),
            getattr(native, name), name))
    rng = np.random.default_rng(0)
    assert t_walks.uniform_walks(indptr, indices, np.arange(n), 5,
                                 rng).shape == (n, 5)
    assert t_neighbor.sample_neighbors(np.arange(10), 4, indptr, indices,
                                       rng).shape == (40,)
    assert calls == ["uniform_walks_native", "sample_neighbors_native"]


@pytest.mark.parametrize("length", [1, 8])
def test_walks_equal_jax_engine(csr, length):
    (indptr, indices, w), n = csr
    starts = np.tile(np.arange(n), 3)
    a, b = np.random.default_rng(1), np.random.default_rng(1)
    _same(t_walks.uniform_walks(indptr, indices, starts, length, a),
          j_native.uniform_walks_native(indptr, indices, starts, length,
                                        int(b.integers(0, 2**62))))
    assert a.random() == b.random()
    accept, alias = _alias_on_edges(indptr, n, 0.1 + w)
    _same(native.alias_walks_native(indptr, indices, accept, alias, starts,
                                    length, seed=5),
          j_native.alias_walks_native(indptr, indices, accept, alias, starts,
                                      length, seed=5))


@pytest.mark.parametrize("fanout", [1, 10])
def test_neighbors_equal_jax_engine(csr, fanout):
    from graphneuralnetwork_tpu.sampling import neighbor as j_neighbor
    (indptr, indices, _), n = csr
    nodes = np.random.default_rng(3).integers(0, n, 64)
    a, b = np.random.default_rng(2), np.random.default_rng(2)
    _same(t_neighbor.sample_neighbors(nodes, fanout, indptr, indices, a),
          j_neighbor.sample_neighbors(nodes, fanout, indptr, indices, b))
    assert a.random() == b.random()


def _s2v_graph(seed=0, n=60, e=240):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, e), rng.integers(0, n, e)
    indptr, indices, _ = t_walks.csr_from_edges(
        np.concatenate([s, r]), np.concatenate([r, s]), n)
    return indptr, indices, n, rng


@pytest.mark.parametrize("k_max", [1, 3])
def test_struc2vec_native_matches_numpy_and_jax(k_max):
    """The engine's cumulative ring distances: within 1e-9 of the port's
    numpy DTW (and of JAX's per-pair ``dtw_distance``), exactly JAX's
    engine's, with the same layer counts."""
    indptr, indices, n, rng = _s2v_graph()
    pu = rng.integers(0, n, 50).astype(np.int32)
    pv = rng.integers(0, n, 50).astype(np.int32)
    f, nl = native.struc2vec_distances_native(indptr, indices, n, k_max,
                                              pu, pv)
    f_np, nl_np = t_s2v._numpy_distances(indptr, indices, n, k_max, pu, pv)
    _same(nl, nl_np)
    np.testing.assert_allclose(f, f_np, rtol=1e-9)
    jf, jnl = j_native.struc2vec_distances_native(indptr, indices, n, k_max,
                                                  pu, pv)
    _same(nl, jnl)
    _same(f, jf)
    rings = j_s2v.degree_rings(indptr, indices, n, k_max)
    for p in range(len(pu)):
        a, b = int(pu[p]), int(pv[p])
        acc = 0.0
        for k in range(nl[p]):
            acc += j_s2v.dtw_distance(rings[a][k], rings[b][k])
            np.testing.assert_allclose(f[p, k], acc, rtol=1e-9)
        assert (f[p, nl[p]:] == -1).all()


def test_multilayer_graph_on_the_engines_equals_jax():
    indptr, indices, n, _ = _s2v_graph(seed=1)
    assert (t_s2v.build_multilayer_graph(indptr, indices, n)
            == j_s2v.build_multilayer_graph(indptr, indices, n))


def _edgelist_file(tmp_path):
    rng = np.random.default_rng(0)
    lines = [f"{a} {b} {rng.random():.4f}"
             for a, b in rng.integers(0, 80, (500, 2))]
    lines.insert(3, "")          # blank line skipped
    lines.insert(7, "42")        # single-token line skipped
    p = tmp_path / "g.txt"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_native_edgelist_parser_matches_python(tmp_path, monkeypatch):
    """Numeric files: the engine's parse gives the ids and vocabulary of
    the Python path; non-numeric files take the Python path."""
    path = _edgelist_file(tmp_path)
    got = t_edgelist.read_edgelist(path, weighted=True)
    with monkeypatch.context() as m:
        m.setattr(native, "parse_edgelist_native", lambda *a, **k: None)
        want = t_edgelist.read_edgelist(path, weighted=True)
    assert got.n_nodes == want.n_nodes
    _same(got.senders, want.senders)
    _same(got.receivers, want.receivers)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-6)
    assert got.vocab.idx_to_token == want.vocab.idx_to_token

    # string tokens: the engine declines, the Python path reads the file
    p2 = tmp_path / "s.txt"
    p2.write_text("alpha beta\nbeta gamma\nalpha gamma\n")
    assert native.parse_edgelist_native(str(p2)) is None
    d = t_edgelist.read_edgelist(str(p2))
    assert d.n_nodes == 4 and d.vocab.idx_to_token[1:] == ["alpha", "beta",
                                                           "gamma"]
    # leading zeros are not plain integers: the Python path, as strings
    p3 = tmp_path / "z.txt"
    p3.write_text("01 2\n2 3\n")
    assert native.parse_edgelist_native(str(p3)) is None
    assert "01" in t_edgelist.read_edgelist(str(p3)).vocab.idx_to_token


@pytest.mark.parametrize("weighted", [False, True])
def test_parsed_edgelists_equal_jax_engine(tmp_path, weighted):
    path = _edgelist_file(tmp_path)
    for g, w in zip(native.parse_edgelist_native(path, weighted),
                    j_native.parse_edgelist_native(path, weighted)):
        _same(g, w)
    got = t_edgelist.read_edgelist(path, weighted=weighted)
    want = j_edgelist.read_edgelist(path, weighted=weighted)
    for name in ("senders", "receivers", "weights"):
        _same(getattr(got, name), getattr(want, name))
    assert got.vocab.idx_to_token == want.vocab.idx_to_token


@pytest.mark.parametrize("n,e,weighted", [(777, 20000, True),
                                          (4096, 16384, False),
                                          (130, 40000, True)])
def test_native_graph_build_matches_numpy_and_jax(n, e, weighted):
    """The engine's build is byte-exact with the port's numpy build and
    with JAX's engine; ``build_graph`` takes it from 16,384 edges and
    gives JAX's arrays."""
    rng = np.random.default_rng(e)
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32) if weighted else None
    e_pad = -(-e // t_graph.EDGE_BLOCK) * t_graph.EDGE_BLOCK
    w_in = w if weighted else np.ones(e, np.float32)
    built = native.build_graph_native(s, r, w_in, n, e_pad,
                                      t_graph.ROW_BLOCK, t_graph.EDGE_BLOCK)
    numpy_built = t_graph._build_arrays(s, r, w_in, n, e_pad)
    jax_built = j_native.build_graph_native(
        s, r, w_in, n, e_pad, t_graph.ROW_BLOCK, t_graph.EDGE_BLOCK)
    for a, b, c in zip(built[:5], numpy_built[:5], jax_built[:5]):
        _same(a, b)
        _same(a, c)
    assert built[5] == numpy_built[5] == jax_built[5]
    g = t_graph.build_graph(s, r, n, w, device="cpu")
    jg = j_graph.build_graph(s, r, n, w)
    for name in ("senders", "receivers", "edge_weight", "chunk_off",
                 "chunk_cnt"):
        _same(getattr(g, name).numpy(), np.asarray(getattr(jg, name)))
    assert (g.max_chunks, g.n_edge_pad) == (jg.max_chunks, jg.n_edge_pad)
    _same(g.row_ptr.numpy(), t_graph.csr_offsets(built[1][:e], n))


@pytest.mark.parametrize("mode", ["sym", "row"])
def test_native_normalize_matches_numpy_and_jax(mode):
    rng = np.random.default_rng(0)
    n, e = 500, 20000
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    got = native.normalize_edge_weights_native(s, r, w, n, mode)
    np.testing.assert_allclose(
        got, t_graph._normalized(s, r, w, n, mode), rtol=NORM_RTOL,
        atol=1e-9)
    np.testing.assert_allclose(
        got, j_native.normalize_edge_weights_native(s, r, w, n, mode),
        rtol=NORM_RTOL)
    fn = {"sym": "sym_normalize_weights", "row": "row_normalize_weights"}[
        mode]
    np.testing.assert_allclose(getattr(t_graph, fn)(s, r, n, w),
                               getattr(j_graph, fn)(s, r, n, w),
                               rtol=NORM_RTOL)
    # unit weights (every CLI graph): exact against the numpy path
    ones = np.ones(e, np.float32)
    _same(native.normalize_edge_weights_native(s, r, ones, n, mode),
          t_graph._normalized(s, r, ones, n, mode))


def test_out_of_range_indices_raise():
    n, e = 50, 20000
    s = np.zeros(e, np.int32)
    r = np.zeros(e, np.int32)
    r[7] = n
    with pytest.raises(IndexError):
        t_graph.sym_normalize_weights(s, r, n)
    with pytest.raises(IndexError):
        t_graph.row_normalize_weights(r, s, n)
    with pytest.raises(IndexError):
        t_graph.build_graph(s, r, n, device="cpu")
    indptr, indices, _ = t_walks.csr_from_edges([0, 1], [1, 0], 2)
    with pytest.raises(IndexError):
        native.uniform_walks_native(indptr, indices, [0, 2], 3, seed=0)
    with pytest.raises(IndexError):
        native.sample_neighbors_native(indptr, indices, [-1], 3, seed=0)
    with pytest.raises(IndexError):
        native.struc2vec_distances_native(indptr, indices, 2, 1, [0], [5])


def _fresh_build(monkeypatch, tmp_path):
    """Point the loader at an empty build directory, unloaded."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)


def test_a_failing_compiler_raises(monkeypatch, tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "g++"
    fake.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}"
                       + os.environ.get("PATH", ""))
    _fresh_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="g\\+\\+ exited 1"):
        t_walks.uniform_walks(np.array([0, 0]), np.zeros(0, np.int32), [0],
                              2, np.random.default_rng(0))
    assert not list((tmp_path / "build").glob("*.so"))


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    _fresh_build(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.get_lib()


def test_the_library_is_keyed_by_sources_flags_and_cpu(monkeypatch):
    path = native.library_path()
    monkeypatch.setattr(native, "host_cpu", lambda: ("another CPU", "avx"))
    assert native.library_path() != path
    monkeypatch.undo()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != path


def test_deepwalk_corpus_on_the_engines_equals_jax(monkeypatch):
    """``run_deepwalk`` at its defaults (the 500-node small world, 80 walks
    of 10 a node, subsampled): the corpus each package hands its trainer,
    array for array."""
    seen = {}

    def capture(key):
        def fn(model, arrays, **kw):
            seen[key] = arrays
            raise StopIteration
        return fn

    monkeypatch.setattr(j_emb, "train_skipgram", capture("jax"))
    monkeypatch.setattr(t_emb, "train_skipgram", capture("torch"))
    with pytest.raises(StopIteration):
        j_emb.run_deepwalk()
    with pytest.raises(StopIteration):
        t_emb.run_deepwalk(device="cpu")
    assert len(seen["torch"]) == len(seen["jax"])
    for g, w in zip(seen["torch"], seen["jax"]):
        _same(g, w)
