"""The heterogeneous containers and the HAN loaders of the PyTorch port
against the JAX package: ``HeteroGraph`` (relations, ``neighbors``,
``compose``, ``metapath_graph``), ``Vocab``, ``BipartiteGraph``,
``dense_adj``, ``synthetic_acm``, ``load_acm_han`` and ``load_imdb_han``
under the ``coo``, ``hybrid`` and ``auto`` layouts (and from an ACM.mat).

Every layout array is held exactly: both packages build them with the same
numpy code from the same numpy seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core import graph as jgraph  # noqa: E402
from graphneuralnetwork_tpu.core import hetero as jhetero  # noqa: E402
from graphneuralnetwork_tpu.data import acm as jacm  # noqa: E402
from graphneuralnetwork_tpu_torch.core import graph as tgraph  # noqa: E402
from graphneuralnetwork_tpu_torch.core import hetero as thetero  # noqa: E402
from graphneuralnetwork_tpu_torch.core.bcsr import HybridGraph  # noqa: E402
from graphneuralnetwork_tpu_torch.data import acm as tacm  # noqa: E402
from test_real_formats import write_acm_mat  # noqa: E402
from test_torch_bcsr import (  # noqa: E402
    assert_graph_equal, assert_hybrid_equal)

PAP = (("paper", "pa", "author"), ("author", "ap", "paper"))
PLP = (("paper", "pl", "subject"), ("subject", "lp", "paper"))


def _acm(n_papers, seed=0):
    kw = dict(seed=seed, n_papers=n_papers, n_authors=n_papers // 2,
              n_subjects=max(20, n_papers // 30))
    return jacm.synthetic_acm(**kw), tacm.synthetic_acm(**kw)


def _assert_edges_equal(t, j, what):
    assert len(t) == len(j), what
    for a, b in zip(t, j):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_synthetic_acm_equal_jax():
    (jhg, jf, jl), (thg, tf, tl) = _acm(240, seed=3)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tl, jl)
    assert thg.node_counts == jhg.node_counts
    assert sorted(thg.relations) == sorted(jhg.relations)
    for key in jhg.relations:
        _assert_edges_equal(thg.relations[key], jhg.relations[key], key)


@pytest.mark.parametrize("binarize", [True, False])
@pytest.mark.parametrize("keys", [PAP, PLP, PAP[:1] + ((
    "author", "ap", "paper"),) + PLP])
def test_compose_equal_jax(keys, binarize):
    """Metapaths of two and four relations, path counts kept or not."""
    (jhg, _, _), (thg, _, _) = _acm(200)
    _assert_edges_equal(thg.compose(list(keys), binarize=binarize),
                        jhg.compose(list(keys), binarize=binarize), keys)


@pytest.mark.parametrize("normalize,self_loops,binarize", [
    ("sym", True, True), ("row", True, True), ("sym", False, True),
    ("row", True, False), (None, False, False)])
def test_metapath_graph_equal_jax(normalize, self_loops, binarize):
    (jhg, _, _), (thg, _, _) = _acm(200)
    for keys in (PAP, PLP):
        j = jhg.metapath_graph(list(keys), normalize=normalize,
                               self_loops=self_loops, binarize=binarize)
        t = thg.metapath_graph(list(keys), normalize=normalize,
                               self_loops=self_loops, binarize=binarize,
                               device="cpu")
        assert_graph_equal(t, j, f"{keys} {normalize}")


def test_neighbors_and_reverse_relations_equal_jax():
    (jhg, _, _), (thg, _, _) = _acm(120)
    for hg in (jhg, thg):
        hg.relations.pop(PAP[1])
        hg.add_reverse_relations()
    assert sorted(thg.relations) == sorted(jhg.relations)
    rkey = thg.reverse(PAP[0])
    assert rkey == jhg.reverse(PAP[0]) == ("author", "pa_rev", "paper")
    _assert_edges_equal(thg.relations[rkey], jhg.relations[rkey], rkey)
    for key in (PAP[0], PLP[1]):
        tn, jn = thg.neighbors(key), jhg.neighbors(key)
        assert sorted(tn) == sorted(jn)
        for node, nbrs in jn.items():
            np.testing.assert_array_equal(tn[node], nbrs)
        assert thg.neighbors(key) is tn   # cached


def test_vocab_equal_jax():
    lines = [["a", "b", "a"], ["c", "a", "b"], ["d"]]
    for tokens, kw in ((lines, dict(min_freq=2)),
                       (["x", "y", "x", "z"], dict(reserved_tokens=["<s>"])),
                       (None, {})):
        j, t = jhetero.Vocab(tokens, **kw), thetero.Vocab(tokens, **kw)
        assert len(t) == len(j) and t.unk == j.unk == 0
        assert t.idx_to_token == j.idx_to_token
        assert t.token_to_idx == j.token_to_idx
        assert t.token_freqs == j.token_freqs
        probe = ["a", "b", "q", "x", "<s>"]
        assert t[probe] == j[probe] and t["zz"] == j["zz"]
        assert t.to_tokens(list(range(len(j)))) == j.to_tokens(
            list(range(len(j))))


def test_bipartite_projection_equal_jax():
    rng = np.random.default_rng(5)
    u = rng.integers(0, 30, 200)
    v = rng.integers(0, 20, 200)
    w = rng.random(200).astype(np.float32)
    jb = jhetero.BipartiteGraph(30, 20, u, v, w)
    tb = thetero.BipartiteGraph(30, 20, u, v, w)
    for key in jb.relations:
        _assert_edges_equal(tb.relations[key], jb.relations[key], key)
    for node_type in ("u", "v"):
        t = tb.homogeneous_projection(node_type, device="cpu")
        assert_graph_equal(t, jb.homogeneous_projection(node_type),
                           node_type)
        s, r = t.senders[:t.n_edges], t.receivers[:t.n_edges]
        assert bool((s != r).all())


def test_dense_adj_equal_jax():
    """Duplicate edges sum; the padding adds nothing."""
    rng = np.random.default_rng(1)
    s = rng.integers(0, 40, 300).astype(np.int32)
    r = rng.integers(0, 40, 300).astype(np.int32)
    w = rng.random(300).astype(np.float32)
    t = tgraph.dense_adj(tgraph.build_graph(s, r, 40, w, device="cpu"))
    j = np.asarray(jgraph.dense_adj(jgraph.build_graph(s, r, 40, w)))
    assert t.shape == (40, 40) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=0)
    want = np.zeros((40, 40), np.float64)
    np.add.at(want, (r, s), w)
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=0)


def _assert_han_data_equal(t, j):
    """Every array of two ``HeteroNodeData``, graphs included."""
    np.testing.assert_array_equal(t.features.numpy(), np.asarray(j.features))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    for split in ("train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(t, split).numpy(),
                                      np.asarray(getattr(j, split)), split)
    assert t.num_classes == j.num_classes
    assert len(t.graphs) == len(j.graphs) == 2
    for tg, jg in zip(t.graphs, j.graphs):
        assert isinstance(tg, HybridGraph) == hasattr(jg, "bcsr")
        if isinstance(tg, HybridGraph):
            assert_hybrid_equal(tg, jg)
            assert tg.bcsr.tiles.dtype == torch.float32
        else:
            assert_graph_equal(tg, jg, "metapath")


@pytest.mark.parametrize("layout", ["coo", "hybrid", "auto"])
@pytest.mark.parametrize("n_papers", [200, 300])
def test_load_acm_han_equal_jax(layout, n_papers):
    """At 200 papers both hybrid remainders are empty (every metapath edge
    lies in a dense tile); ``auto`` picks the hybrid layout at both
    sizes."""
    t = tacm.load_acm_han(seed=1, layout=layout, n_papers=n_papers,
                          device="cpu")
    j = jacm.load_acm_han(seed=1, layout=layout, n_papers=n_papers)
    _assert_han_data_equal(t, j)
    if layout != "coo":
        assert all(isinstance(g, HybridGraph) for g in t.graphs)
    if layout == "hybrid" and n_papers == 200:
        assert [g.rem.n_edges for g in t.graphs] == [0, 0]
        assert all(int(g.rem.row_ptr.abs().sum()) == 0 for g in t.graphs)


@pytest.mark.parametrize("layout", ["coo", "hybrid"])
def test_load_imdb_han_equal_jax(layout):
    t = tacm.load_imdb_han(seed=2, layout=layout, device="cpu")
    j = jacm.load_imdb_han(seed=2, layout=layout)
    _assert_han_data_equal(t, j)
    assert t.features.shape == (900, 128)


def test_hybrid_metapath_perm_equal_jax():
    """The clustering permutation, with and without a probe's."""
    (jhg, _, _), (thg, _, _) = _acm(300)
    jg, jperm = jacm._hybrid_metapath_graphs(jhg, 300, jacm._ACM_METAPATHS,
                                             64)
    tg, tperm = tacm._hybrid_metapath_graphs(thg, 300, tacm._ACM_METAPATHS,
                                             64, device="cpu")
    np.testing.assert_array_equal(tperm, jperm)
    for a, b in zip(tg, jg):
        assert_hybrid_equal(a, b)
    given = np.random.default_rng(0).permutation(300)
    tg, tperm = tacm._hybrid_metapath_graphs(thg, 300, tacm._ACM_METAPATHS,
                                             64, perm=given, device="cpu")
    jg, _ = jacm._hybrid_metapath_graphs(jhg, 300, jacm._ACM_METAPATHS, 64,
                                         perm=given)
    assert tperm is given
    for a, b in zip(tg, jg):
        assert_hybrid_equal(a, b)


@pytest.mark.parametrize("layout", ["coo", "hybrid"])
def test_acm_mat_loaders_equal_jax(tmp_path, layout):
    """The reference's ACM.mat (PvsL, PvsA, PvsT, PvsC) through both
    loaders; the IMDB loader reads the same format."""
    mat = str(tmp_path / "ACM.mat")
    write_acm_mat(mat)
    jhg, jf, jl = jacm._load_acm_mat(mat)
    thg, tf, tl = tacm._load_acm_mat(mat)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tl, jl)
    assert thg.node_counts == jhg.node_counts
    for key in jhg.relations:
        _assert_edges_equal(thg.relations[key], jhg.relations[key], key)
    for t_load, j_load in ((tacm.load_acm_han, jacm.load_acm_han),
                           (tacm.load_imdb_han, jacm.load_imdb_han)):
        _assert_han_data_equal(
            t_load(path=mat, layout=layout, min_edges_per_tile=8,
                   device="cpu"),
            j_load(path=mat, layout=layout, min_edges_per_tile=8))


def test_loaders_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (tacm.load_acm_han, tacm.load_imdb_han):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load(seed=0)
    (_, _, _), (thg, _, _) = _acm(120)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thg.metapath_graph(list(PAP))
