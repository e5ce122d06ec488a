"""Parity of the PyTorch port's host builders with the JAX package: graph
layout arrays, the synthetic Cora stream and the auto layout decision are
equal, not close."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core import graph as jgraph  # noqa: E402
from graphneuralnetwork_tpu.core.layout import (  # noqa: E402
    choose_layout as j_choose_layout)
from graphneuralnetwork_tpu.data.planetoid import (  # noqa: E402
    synthetic_citation_graph as j_synthetic)
from graphneuralnetwork_tpu_torch.core import graph as tgraph  # noqa: E402
from graphneuralnetwork_tpu_torch.core.layout import (  # noqa: E402
    choose_layout as t_choose_layout)
from graphneuralnetwork_tpu_torch.data.planetoid import (  # noqa: E402
    synthetic_citation_graph as t_synthetic)

LAYOUT_ARRAYS = ("senders", "receivers", "edge_weight", "chunk_off",
                 "chunk_cnt")


@pytest.fixture(scope="module")
def cora_arrays():
    return j_synthetic(seed=0)


def _random_graph(n=300, e=1500, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32), n)


def _assert_same_graph(jg, tg):
    for name in LAYOUT_ARRAYS:
        a = np.asarray(getattr(jg, name))
        b = getattr(tg, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("n_nodes", "n_edges", "n_node_pad", "max_chunks"):
        assert getattr(jg, name) == getattr(tg, name), name
    np.testing.assert_array_equal(np.asarray(jg.edge_mask),
                                  tg.edge_mask.numpy())


@pytest.mark.parametrize("which", ["cora", "random"])
def test_gcn_graph_arrays_equal(which, cora_arrays):
    if which == "cora":
        feats, _, s, r = cora_arrays
        n = feats.shape[0]
    else:
        s, r, n = _random_graph()
    jg = jgraph.gcn_graph(s, r, n)
    tg = tgraph.gcn_graph(s, r, n, device="cpu")
    _assert_same_graph(jg, tg)
    # row_ptr spans the real edges of the same receivers; the padding
    # edges (zero values) lie in no row's span
    np.testing.assert_array_equal(
        tg.row_ptr.numpy(),
        jgraph.csr_offsets(np.asarray(jg.receivers)[:jg.n_edges], n))
    assert tg.row_ptr.dtype == torch.int32
    assert int(tg.row_ptr[-1]) == tg.n_edges


def test_build_graph_unweighted_and_empty_rows():
    """Nodes without incoming edges give empty row_ptr segments."""
    s = np.array([0, 1, 2, 2], np.int32)
    r = np.array([1, 1, 3, 0], np.int32)
    jg = jgraph.build_graph(s, r, 6)
    tg = tgraph.build_graph(s, r, 6, device="cpu")
    _assert_same_graph(jg, tg)
    counts = np.diff(tg.row_ptr.numpy())
    np.testing.assert_array_equal(counts[:5], [1, 2, 0, 1, 0])


@pytest.mark.parametrize("fn", ["sym_normalize_weights",
                                "row_normalize_weights"])
def test_normalisations_equal(fn):
    s, r, n = _random_graph(seed=5)
    s, r = jgraph.add_self_loops(*jgraph.symmetrize(s, r), n)
    np.testing.assert_array_equal(getattr(jgraph, fn)(s, r, n),
                                  getattr(tgraph, fn)(s, r, n))


def test_synthetic_citation_graph_byte_equal(cora_arrays):
    for a, b in zip(cora_arrays, t_synthetic(seed=0)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_row_normalize_features_equal(cora_arrays):
    feats = cora_arrays[0]
    assert (jgraph.row_normalize_features(feats).tobytes()
            == tgraph.row_normalize_features(feats).tobytes())


@pytest.mark.parametrize("objective", ["spmm", "attention"])
def test_choose_layout_same_decision(objective, cora_arrays):
    feats, _, s, r = cora_arrays
    n = feats.shape[0]
    s, r = jgraph.add_self_loops(*jgraph.symmetrize(s, r), n)
    j_layout, j_ratio, j_perm = j_choose_layout(s, r, n, objective=objective)
    t_layout, t_ratio, t_perm = t_choose_layout(s, r, n, objective=objective)
    assert (t_layout, t_ratio) == (j_layout, j_ratio)
    np.testing.assert_array_equal(t_perm, j_perm)
    # the Cora-shaped synthetic: GCN stays on COO, GAT would go hybrid
    assert j_layout == {"spmm": "coo", "attention": "hybrid"}[objective]
