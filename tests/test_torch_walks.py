"""The walk embedders' host builders and device walkers
(``graphneuralnetwork_tpu_torch/sampling/``, ``data/edgelist.py``,
``models/embedding.py``'s LINE corpus) against the JAX package on the
CPU.

The host builders are numpy in both packages: with the same inputs and a
``default_rng`` of the same seed they must give the same arrays bit for
bit and leave the generator in the same state. Both packages' Struc2Vec
distances come from their C++ engines (held against each other in
``test_torch_native.py``); here JAX's engine is replaced by its documented
"unavailable" value (``None``), so that JAX takes its numpy path, and the
port's by its numpy distances (``struc2vec._numpy_distances``). The
device walkers draw from a ``torch.Generator`` (JAX's threefry keys
cannot be reproduced): their tables must equal JAX's, and their walks are
checked for their semantics on a CPU generator, including node2vec's
first-hop and edge-transition frequencies against the tables'
probabilities.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.core.hetero import HeteroGraph as JHetero  # noqa: E402
from graphneuralnetwork_tpu.data import edgelist as j_edgelist  # noqa: E402
from graphneuralnetwork_tpu.models import embedding as j_emb  # noqa: E402
from graphneuralnetwork_tpu.sampling import alias as j_alias  # noqa: E402
from graphneuralnetwork_tpu.sampling import device_walks as j_dw  # noqa: E402
from graphneuralnetwork_tpu.sampling import native as j_native  # noqa: E402
from graphneuralnetwork_tpu.sampling import skipgram as j_sg  # noqa: E402
from graphneuralnetwork_tpu.sampling import struc2vec as j_s2v  # noqa: E402
from graphneuralnetwork_tpu.sampling import walks as j_walks  # noqa: E402
from graphneuralnetwork_tpu_torch.core.hetero import HeteroGraph as THetero  # noqa: E402
from graphneuralnetwork_tpu_torch.data import edgelist as t_edgelist  # noqa: E402
from graphneuralnetwork_tpu_torch.models import embedding as t_emb  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import alias as t_alias  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import device_walks as t_dw  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import skipgram as t_sg  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import struc2vec as t_s2v  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import walks as t_walks  # noqa: E402

N, E = 60, 300


def _rngs(seed=3):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _same(got, want):
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, want)


def _same_state(a, b):
    assert a.random() == b.random()


@pytest.fixture(scope="module")
def graph():
    """A random directed weighted graph in which nodes 20-24 send no edge
    (dead ends), with duplicate edges, as CSR."""
    rng = np.random.default_rng(7)
    s = rng.integers(0, N - 5, E)
    s = np.where(s >= 20, s + 5, s).astype(np.int32)
    r = rng.integers(0, N, E).astype(np.int32)
    w = (0.1 + rng.random(E)).astype(np.float32)
    return t_walks.csr_from_edges(s, r, N, w)


@pytest.fixture(scope="module")
def smallworld():
    d = t_edgelist.synthetic_smallworld(n_nodes=N, seed=2)
    return d, t_walks.csr_from_edges(d.senders, d.receivers, N)


@pytest.fixture
def numpy_engine(monkeypatch):
    """JAX's C++ engine reported unavailable, and the port's Struc2Vec
    distances taken in numpy: both packages' numpy paths."""
    for name in ("struc2vec_distances_native", "uniform_walks_native",
                 "parse_edgelist_native"):
        monkeypatch.setattr(j_native, name, lambda *a, **k: None)
    monkeypatch.setattr(t_s2v.native, "struc2vec_distances_native",
                        t_s2v._numpy_distances)


@pytest.mark.parametrize("n_nodes,k,seed", [(500, 6, 0), (60, 4, 2),
                                            (2405, 14, 0)])
def test_synthetic_smallworld_equals_jax(n_nodes, k, seed):
    got = t_edgelist.synthetic_smallworld(n_nodes=n_nodes, k=k, seed=seed)
    want = j_edgelist.synthetic_smallworld(n_nodes=n_nodes, k=k, seed=seed)
    assert got.n_nodes == want.n_nodes
    for name in ("senders", "receivers", "weights"):
        _same(getattr(got, name), getattr(want, name))
    if (n_nodes, k) == (2405, 14):
        assert len(got.senders) == 33670


def test_concat_alias_tables_equal_jax(graph):
    indptr, _, w = graph
    tables = [w[indptr[v]:indptr[v + 1]] for v in range(N)]
    got, want = t_alias.ConcatAliasTables(tables), \
        j_alias.ConcatAliasTables(tables)
    for name in ("sizes", "offsets", "accept", "alias"):
        _same(getattr(got, name), getattr(want, name))
    live = np.flatnonzero(got.sizes > 0)
    t_idx = np.random.default_rng(0).choice(live, 2000)
    a, b = _rngs()
    _same(got.draw(t_idx, a), want.draw(t_idx, b))
    _same_state(a, b)


def test_weighted_walks_equal_jax(graph):
    indptr, indices, w = graph
    starts = np.tile(np.arange(N), 4)
    a, b = _rngs()
    got = t_walks.weighted_walks(indptr, indices, w, starts, 7, a)
    _same(got, j_walks.weighted_walks(indptr, indices, w, starts, 7, b))
    _same_state(a, b)
    dead = np.isin(got[:, :-1], np.arange(20, 25))
    assert (got[:, 1:][dead] == got[:, :-1][dead]).all()


@pytest.mark.parametrize("p,q", [(0.25, 2.0), (1.0, 1.0), (4.0, 0.5)])
def test_node2vec_walker_equals_jax(graph, p, q):
    indptr, indices, w = graph
    got = t_walks.Node2VecWalker(indptr, indices, p=p, q=q, weights=w)
    want = j_walks.Node2VecWalker(indptr, indices, p=p, q=q, weights=w)
    for part in ("node_tables", "edge_tables"):
        for name in ("sizes", "offsets", "accept", "alias"):
            _same(getattr(getattr(got, part), name),
                  getattr(getattr(want, part), name))
    starts = np.tile(np.arange(N), 3)
    a, b = _rngs()
    _same(got.walk(starts, 8, a), want.walk(starts, 8, b))
    _same_state(a, b)


def _hetero(cls, seed=1, nu=30, ni=20, e=150):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, nu - 3, e)
    u = np.where(u >= 10, u + 3, u)     # users 10-12 rate nothing
    i = rng.integers(0, ni, e)
    g = cls({"u": nu, "i": ni})
    g.add_relation(("u", "ui", "i"), u, i)
    g.add_relation(("i", "iu", "u"), i, u)
    return g, [("u", "ui", "i"), ("i", "iu", "u")]


def test_metapath_walks_equal_jax():
    (tg, path), (jg, _) = _hetero(THetero), _hetero(JHetero)
    starts = np.tile(np.arange(30), 5)
    a, b = _rngs()
    got = t_walks.metapath_walks(tg, path, starts, 9, a)
    _same(got, j_walks.metapath_walks(jg, path, starts, 9, b))
    _same_state(a, b)


def test_dtw_many_equals_dtw_distance():
    rng = np.random.default_rng(5)
    seqs = [np.sort(rng.integers(1, 12, rng.integers(1, 15)))
            for _ in range(41)]
    a, b = seqs[:-1], seqs[1:]
    got = t_s2v._dtw_many(a, b, chunk=8)
    want = np.array([j_s2v.dtw_distance(x, y) for x, y in zip(a, b)])
    _same(got, want)
    _same(np.array([t_s2v.dtw_distance(x, y) for x, y in zip(a, b)]), want)


@pytest.mark.parametrize("k_max", [2, 3])
def test_multilayer_graph_and_struc2vec_walks_equal_jax(
        smallworld, numpy_engine, k_max):
    _, (indptr, indices, _) = smallworld
    got = t_s2v.build_multilayer_graph(indptr, indices, N, k_max=k_max)
    want = j_s2v.build_multilayer_graph(indptr, indices, N, k_max=k_max)
    assert got == want
    _same(t_s2v.degree_rings(indptr, indices, N, k_max)[7][-1],
          j_s2v.degree_rings(indptr, indices, N, k_max)[7][-1])
    tw, jw = t_s2v.Struc2VecWalker(got), j_s2v.Struc2VecWalker(want)
    starts = np.tile(np.arange(N), 4)
    a, b = _rngs()
    _same(tw.walk(starts, 10, a), jw.walk(starts, 10, b))
    _same_state(a, b)


def _walks(seed=4, n=200, length=8, vocab=N):
    """Walks over ``vocab`` tokens, some tokens frequent."""
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.6, (n, length)) % vocab).astype(np.int32)


def test_subsample_and_contexts_equal_jax():
    walks = _walks()
    a, b = _rngs()
    ts, js = t_sg.subsample(walks, N, a, 1e-2), j_sg.subsample(walks, N, b,
                                                             1e-2)
    _same(ts, js)
    assert (ts == -1).any() and (ts >= 0).any()
    _same(t_sg.token_frequencies(ts, N), j_sg.token_frequencies(js, N))
    for got, want in zip(t_sg.centers_and_contexts(ts, 3, a),
                         j_sg.centers_and_contexts(js, 3, b)):
        _same(got, want)
    _same_state(a, b)


@pytest.mark.parametrize("typed,subsample_t",
                         [(False, 1e-2), (False, None), (True, 2e-2)])
def test_skipgram_dataset_equals_jax(typed, subsample_t):
    walks = _walks(n=120)
    types = (np.arange(N) >= 35).astype(np.int64) if typed else None
    a, b = _rngs()
    got = t_sg.skipgram_dataset(walks, N, window=3, num_negatives=4, rng=a,
                                subsample_t=subsample_t, token_types=types)
    want = j_sg.skipgram_dataset(walks, N, window=3, num_negatives=4, rng=b,
                                 subsample_t=subsample_t, token_types=types)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _same(g, w)
    _same_state(a, b)
    a, b = _rngs(9)
    tbs, jbs = (list(t_sg.minibatches(got, 16, a)),
                list(j_sg.minibatches(want, 16, b)))
    assert len(tbs) == len(jbs) >= 1
    for tb, jb in zip(tbs, jbs):
        for g, w in zip(tb, jb):
            _same(g, w)
    _same_state(a, b)


def test_line_corpus_and_pagerank_equal_jax(smallworld, monkeypatch):
    """JAX builds LINE's corpus inside ``run_line``: its arrays are read
    off the arguments it hands ``train_skipgram``."""
    data, (indptr, indices, _) = smallworld
    seen = {}

    def capture(model, arrays, **kw):
        seen["arrays"], seen["extra"] = arrays, kw["extra_batch_arrays"]
        raise StopIteration

    monkeypatch.setattr(j_emb, "train_skipgram", capture)
    jdata = j_edgelist.synthetic_smallworld(n_nodes=N, seed=2)
    with pytest.raises(StopIteration):
        j_emb.run_line(jdata, j_emb.LINEConfig(num_negatives=3, seed=1))
    rng = np.random.default_rng(1)
    got = t_emb.line_corpus(indptr, indices, N, 3, rng)
    for g, w in zip(got, seen["arrays"]):
        _same(g, w)
    _same(t_emb.pagerank(indptr, indices, N).astype(np.float32),
          seen["extra"][0])


@pytest.mark.parametrize("p,q", [(0.25, 2.0), (1.0, 1.0)])
def test_node2vec_tables_equal_jax(graph, p, q):
    indptr, indices, w = graph
    t = t_dw.build_node2vec_tables(indptr, indices, p=p, q=q, weights=w,
                                   device="cpu")
    j = j_dw.build_node2vec_tables(indptr, indices, p=p, q=q, weights=w)
    md = j.md
    assert t.md == md
    node, edge = np.asarray(j.node_pack), np.asarray(j.edge_pack)
    _same(t.node_cum.numpy(), node[:, :md])
    _same(t.edge_cum.numpy(), edge[:, :md])
    np.testing.assert_array_equal(t.nbr.numpy(), node[:, md:2 * md])
    np.testing.assert_array_equal(t.deg.numpy(), node[:, 2 * md])
    np.testing.assert_array_equal(t.row_start.numpy(), node[:, 2 * md + 1])
    v = t.edge_dst.numpy()
    np.testing.assert_array_equal(t.nbr.numpy()[v], edge[:, md:2 * md])
    np.testing.assert_array_equal(t.deg.numpy()[v], edge[:, 2 * md])
    np.testing.assert_array_equal(t.row_start.numpy()[v],
                                  edge[:, 2 * md + 1])
    _same(t.deg.numpy(), (indptr[1:] - indptr[:-1]).astype(np.int64))


def test_metapath_tables_equal_jax():
    (tg, path), (jg, _) = _hetero(THetero), _hetero(JHetero)
    got = t_dw.build_metapath_tables(tg, path, device="cpu")
    want = j_dw.build_metapath_tables(jg, path)
    assert len(got) == len(want) == 2
    for (tt, td), (jt, jd) in zip(got, want):
        _same(tt.numpy(), np.asarray(jt))
        _same(td.numpy(), np.asarray(jd))


def _edges(indptr, indices):
    src = np.repeat(np.arange(len(indptr) - 1), indptr[1:] - indptr[:-1])
    return set(zip(src.tolist(), indices.tolist()))


def test_device_node2vec_walks_follow_edges(graph):
    indptr, indices, w = graph
    t = t_dw.build_node2vec_tables(indptr, indices, p=0.25, q=2.0,
                                   weights=w, device="cpu")
    gen = torch.Generator().manual_seed(0)
    walks = t_dw.device_node2vec_walks(
        gen, torch.arange(N).repeat(5), 9, t).numpy()
    assert walks.shape == (5 * N, 9) and walks.dtype == np.int32
    edges, dead = _edges(indptr, indices), set(range(20, 25))
    for row in walks:
        for a, b in zip(row[:-1], row[1:]):
            if a in dead:
                assert b == a
            else:
                assert (a, b) in edges
    # a walker that reached a dead end stays there
    hit = np.isin(walks, list(dead))
    for row, h in zip(walks, hit):
        if h.any():
            assert (row[h.argmax():] == row[h.argmax()]).all()
    one = t_dw.device_node2vec_walks(gen, torch.arange(N), 1, t)
    assert one.shape == (N, 1)


def test_device_node2vec_frequencies_match_tables():
    """Over a fixed seed, the first hop's slot frequencies and the second
    hop's frequencies given the first edge are within 5 binomial standard
    deviations (+1e-3) of the tables' probabilities."""
    rng = np.random.default_rng(11)
    n = 8
    s = rng.integers(0, n, 30).astype(np.int32)
    r = rng.integers(0, n, 30).astype(np.int32)
    keep = s != r
    indptr, indices, w = t_walks.csr_from_edges(
        s[keep], r[keep], n, (0.2 + rng.random(30)).astype(np.float32)[keep])
    t = t_dw.build_node2vec_tables(indptr, indices, p=0.5, q=3.0,
                                   weights=w, device="cpu")
    live = np.flatnonzero(indptr[1:] > indptr[:-1])
    reps = 6000
    starts = torch.from_numpy(np.repeat(live, reps))
    walks = t_dw.device_node2vec_walks(torch.Generator().manual_seed(3),
                                       starts, 3, t).numpy()

    def probs(cum, d):
        c = cum[:d].astype(np.float64)
        return np.diff(np.concatenate([[0.0], c]))

    def check(counts, p):
        total = counts.sum()
        freq = counts / total
        bound = 5 * np.sqrt(p * (1 - p) / total) + 1e-3
        assert (np.abs(freq - p) <= bound).all(), (freq, p)

    node_cum, edge_cum = t.node_cum.numpy(), t.edge_cum.numpy()
    for v in live:
        rows = walks[walks[:, 0] == v]
        nb = indices[indptr[v]:indptr[v + 1]]
        d = len(nb)
        # the slot of each first hop (a repeated neighbour id: its first)
        slots = np.array([np.flatnonzero(nb == x)[0] for x in rows[:, 1]])
        counts = np.bincount(slots, minlength=d).astype(np.float64)
        p = probs(node_cum[v], d)
        merged = np.array([p[nb == nb[j]].sum() if j == np.flatnonzero(
            nb == nb[j])[0] else 0.0 for j in range(d)])
        check(counts, merged)
        # second hop given the first edge (v -> x) at its first slot
        for j in np.unique(slots):
            e = indptr[v] + j
            x = indices[e]
            nx = indices[indptr[x]:indptr[x + 1]]
            sub = rows[slots == j]
            if len(nx) == 0 or len(sub) < 500:
                continue
            s2 = np.array([np.flatnonzero(nx == y)[0] for y in sub[:, 2]])
            c2 = np.bincount(s2, minlength=len(nx)).astype(np.float64)
            p2 = probs(edge_cum[e], len(nx))
            m2 = np.array([p2[nx == nx[k]].sum() if k == np.flatnonzero(
                nx == nx[k])[0] else 0.0 for k in range(len(nx))])
            check(c2, m2)


def test_device_metapath_walks_keep_types():
    tg, path = _hetero(THetero)
    legs = t_dw.build_metapath_tables(tg, path, device="cpu")
    walks = t_dw.device_metapath_walks(
        torch.Generator().manual_seed(0), torch.arange(30).repeat(4), 9,
        legs).numpy()
    assert walks.shape == (120, 9) and walks.dtype == np.int32
    ui = set(zip(*(a.tolist() for a in tg.relations[path[0]][:2])))
    iu = set(zip(*(a.tolist() for a in tg.relations[path[1]][:2])))
    for row in walks:
        stuck = False
        for t in range(1, 9):
            a, b = row[t - 1], row[t]
            rel = ui if t % 2 == 1 else iu
            stuck = stuck or (a not in {x for x, _ in rel})
            if stuck:       # a walker without a next hop stays put
                assert b == a
            else:
                assert (a, b) in rel
        # users at even positions lie below 30, items at odd below 20
        if not stuck:
            assert (row[1::2] < 20).all()
    dead = (walks[:, 0] >= 10) & (walks[:, 0] <= 12)
    assert dead.sum() == 12
    assert (walks[dead] == walks[dead][:, :1]).all()


def test_device_uniform_walks_for_deepwalk(smallworld):
    """``run_deepwalk``'s device walks: every hop an edge of the graph."""
    from graphneuralnetwork_tpu_torch.sampling.device_neighbor import (
        build_device_neighbor_table, device_uniform_walks)
    _, (indptr, indices, _) = smallworld
    table, deg = build_device_neighbor_table(indptr, indices, device="cpu")
    walks = device_uniform_walks(torch.Generator().manual_seed(1),
                                 torch.arange(N), 10, table, deg).numpy()
    edges = _edges(indptr, indices)
    assert all((a, b) in edges for row in walks
               for a, b in zip(row[:-1], row[1:]))


def test_metapath2vec_global_ids_equal_jax(monkeypatch):
    """``run_metapath2vec``'s walks in global ids, its corpus and typed
    negatives, up to training: JAX's arguments to ``train_skipgram``."""
    seen = {}

    def capture(key):
        def fn(model, arrays, **kw):
            seen[key] = (arrays, kw)
            raise StopIteration
        return fn

    monkeypatch.setattr(j_emb, "train_skipgram", capture("jax"))
    monkeypatch.setattr(t_emb, "train_skipgram", capture("torch"))
    cfg = dict(window=4, num_negatives=4, batch_size=512, num_walks=3,
               epochs=1)
    for run, mod in ((j_emb.run_metapath2vec, j_emb),
                     (functools.partial(t_emb.run_metapath2vec,
                                        device="cpu"), t_emb)):
        with pytest.raises(StopIteration):
            run(cfg=mod.WalkEmbedConfig(**cfg))
    (ta, tkw), (ja, jkw) = seen["torch"], seen["jax"]
    for g, w in zip(ta, ja):
        _same(g, w)
    assert tkw["lr"] == 2e-3 and tkw["batch_size"] == 512
