"""The centrality toolkit of the PyTorch port (``analysis/``) against the
JAX package and networkx on the CPU.

Every metric on the Basis demo's graph, a random graph, a directed graph
and a two-component graph: floats within ``TOL`` of JAX's (the power
iterations stop on JAX's tolerance tests, so both take the same number of
iterations) and integers (distances, components, diameter, degrees)
equal; against networkx at ``tests/test_analysis.py``'s tolerances. The
adjacency of a port ``Graph`` equals JAX's of the same edges; the
``basis`` CLI prints JAX's JSON line.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu import analysis as JA  # noqa: E402
from graphneuralnetwork_tpu import cli as jcli  # noqa: E402
from graphneuralnetwork_tpu.analysis.demo import basis_demo as j_demo  # noqa: E402
from graphneuralnetwork_tpu.core.graph import build_graph as j_build  # noqa: E402
from graphneuralnetwork_tpu_torch import analysis as TA  # noqa: E402
from graphneuralnetwork_tpu_torch import cli as tcli  # noqa: E402
from graphneuralnetwork_tpu_torch.analysis import centrality  # noqa: E402
from graphneuralnetwork_tpu_torch.analysis.demo import (  # noqa: E402
    basis_adjacency, basis_demo)
from graphneuralnetwork_tpu_torch.core.graph import build_graph  # noqa: E402

TOL = 1e-5
FLOATS = ("degree_centrality", "eigenvector_centrality", "pagerank",
          "closeness_centrality", "betweenness_centrality")
INTS = ("bfs_distances", "connected_components")


def _random(seed, n=40, p=0.12, directed=False):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < p).astype(np.float32)
    if not directed:
        a = np.maximum(a, a.T)
    np.fill_diagonal(a, 0.0)
    return a


def _two_components():
    a = np.zeros((5, 5), np.float32)
    for i, j in [(0, 1), (2, 3), (3, 4)]:
        a[i, j] = a[j, i] = 1.0
    return a


GRAPHS = {"basis": basis_adjacency, "random": lambda: _random(1),
          "directed": lambda: _random(2, n=30, p=0.1, directed=True),
          "two_components": _two_components}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_every_metric_follows_jax(graph):
    a = GRAPHS[graph]()
    for name in FLOATS:
        got = getattr(TA, name)(a, device="cpu")
        want = np.asarray(getattr(JA, name)(a))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL,
                                   err_msg=name)
    for name in INTS:
        got = getattr(TA, name)(a, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            getattr(JA, name)(a)), err_msg=name)
        assert got.dtype == torch.int32
    for got, want in zip(TA.hits(a, device="cpu"), JA.hits(a)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(
        TA.betweenness_centrality(a, normalized=False, device="cpu").numpy(),
        np.asarray(JA.betweenness_centrality(a, normalized=False)), rtol=0,
        atol=TOL * max(1.0, float(np.asarray(
            JA.betweenness_centrality(a, normalized=False)).max())))
    if graph in ("basis", "random"):
        assert TA.diameter(a, device="cpu") == JA.diameter(a)
    else:
        with pytest.raises(ValueError, match="not connected"):
            TA.diameter(a, device="cpu")


def test_tensor_inputs_stay_on_their_device():
    a = torch.from_numpy(_random(3))
    assert TA.pagerank(a).device == a.device
    np.testing.assert_allclose(TA.pagerank(a).numpy(),
                               np.asarray(JA.pagerank(a.numpy())), atol=TOL)


def test_numpy_inputs_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.degree_centrality(_random(3))


def test_products_run_in_full_float32(monkeypatch):
    """The toolkit runs its products without TF32 and leaves the caller's
    setting as it was."""
    seen = []
    as_dense = centrality._as_dense

    def record(*args):
        seen.append(torch.get_float32_matmul_precision())
        return as_dense(*args)

    monkeypatch.setattr(centrality, "_as_dense", record)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        a = torch.from_numpy(_random(4))
        for name in ("eigenvector_centrality", "pagerank", "hits",
                     "bfs_distances", "betweenness_centrality"):
            getattr(TA, name)(a)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert set(seen) == {"highest"}


def test_dense_adjacency_from_graph():
    src = np.array([0, 1, 2, 2, 2], np.int32)
    dst = np.array([1, 2, 0, 3, 3], np.int32)
    w = np.array([1.0, 2.0, 3.0, 4.0, 0.5], np.float32)
    got = TA.to_dense_adjacency(build_graph(src, dst, 4, w, device="cpu"))
    want = np.asarray(JA.to_dense_adjacency(j_build(src, dst, 4,
                                                    edge_weight=w)))
    np.testing.assert_array_equal(got.numpy(), want)
    sym = TA.to_dense_adjacency(build_graph(src, dst, 4, w, device="cpu"),
                                symmetrize=True)
    np.testing.assert_array_equal(sym.numpy(), np.maximum(want, want.T))
    g = build_graph(src, dst, 4, w, device="cpu")
    np.testing.assert_allclose(TA.pagerank(g).numpy(),
                               np.asarray(JA.pagerank(want)), atol=TOL)


def _same_demo(got, want):
    assert set(got) >= set(want)
    for k, v in want.items():
        if k in ("model", "degree", "connected_components", "diameter"):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=TOL,
                                       err_msg=k)


def test_basis_demo_follows_jax():
    _same_demo(basis_demo("cpu"), j_demo())


def test_cli_basis_follows_jax(capsys):
    jcli.main(["--model", "basis"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tcli.main(["--model", "basis", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["model"] == want["model"] == "basis"
    assert got["device"] == "cpu"
    _same_demo(got, want)


def test_metrics_match_networkx():
    """The port against networkx's own routines at
    ``tests/test_analysis.py``'s tolerances."""
    nx = pytest.importorskip("networkx")
    for a in (basis_adjacency(), _random(5)):
        g = nx.from_numpy_array(a)
        n = a.shape[0]

        def vals(d):
            return np.array([d[i] for i in range(n)])

        def port(name, **kw):
            return getattr(TA, name)(a, device="cpu", **kw).numpy()

        np.testing.assert_allclose(port("degree_centrality"),
                                   vals(nx.degree_centrality(g)), atol=1e-6)
        np.testing.assert_allclose(
            port("eigenvector_centrality"),
            vals(nx.eigenvector_centrality(g, max_iter=1000, tol=1e-10)),
            atol=1e-4)
        np.testing.assert_allclose(port("betweenness_centrality"),
                                   vals(nx.betweenness_centrality(g)),
                                   atol=1e-5)
        np.testing.assert_allclose(
            port("betweenness_centrality", normalized=False),
            vals(nx.betweenness_centrality(g, normalized=False)), atol=1e-5)
        np.testing.assert_allclose(port("closeness_centrality"),
                                   vals(nx.closeness_centrality(g)),
                                   atol=1e-6)
        np.testing.assert_allclose(
            port("pagerank"), vals(nx.pagerank(g, tol=1e-12, max_iter=1000)),
            atol=1e-6)
        hubs, auths = TA.hits(a, device="cpu")
        nxh, nxa = nx.hits(g, tol=1e-10, max_iter=500)
        np.testing.assert_allclose(hubs.numpy(), vals(nxh), atol=1e-4)
        np.testing.assert_allclose(auths.numpy(), vals(nxa), atol=1e-4)
        if nx.is_connected(g):
            assert TA.diameter(a, device="cpu") == nx.diameter(g)
        comps = TA.connected_components(a, device="cpu").numpy()
        for c in nx.connected_components(g):
            assert len({comps[i] for i in c}) == 1
            assert comps[min(c)] == min(c)
