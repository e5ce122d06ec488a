"""The host side of GATNE and BiNE and the ``GATNE`` encoder of the PyTorch
port against the JAX package on the CPU.

Equal, array for array: the link-prediction metrics on the same
embeddings (bit for bit: both are the same numpy), the multiplex loaders
(``synthetic_multiplex``; ``read_multiplex_dir`` on files the test
writes), ``CachedWeightedSampler`` and ``bine_walks`` draw for draw from
the same numpy seed, GATNE's neighbour tables, walks, pairs and padded
pairs (both packages' ``uniform_walks`` on their numpy paths,
``use_native=False``, and at the defaults on their C++ engines: 365,992
pairs), and a walk cache written by the JAX package
read by the port. ``GATNE``'s forward and gradients from flax's
parameters (``params.from_flax``) in T and I mode under both aggregators,
within ``SCALE_TOL`` of each output's largest entry (float32 sums in
other orders), and the ``{"model", "ctx"|"decoder"}`` tree loading into
``GATNEParams``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from graphneuralnetwork_tpu.data import edgelist as j_edgelist  # noqa: E402
from graphneuralnetwork_tpu.models import gatne as j_gatne  # noqa: E402
from graphneuralnetwork_tpu.nn import embed as j_nn  # noqa: E402
from graphneuralnetwork_tpu.sampling import alias as j_alias  # noqa: E402
from graphneuralnetwork_tpu.sampling import walks as j_walks  # noqa: E402
from graphneuralnetwork_tpu.train import linkpred as j_linkpred  # noqa: E402
from graphneuralnetwork_tpu_torch.data import edgelist as t_edgelist  # noqa: E402
from graphneuralnetwork_tpu_torch.models import gatne as t_gatne  # noqa: E402
from graphneuralnetwork_tpu_torch.nn import embed as t_nn  # noqa: E402
from graphneuralnetwork_tpu_torch.params import from_flax  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import alias as t_alias  # noqa: E402
from graphneuralnetwork_tpu_torch.sampling import walks as t_walks  # noqa: E402
from graphneuralnetwork_tpu_torch.train import linkpred as t_linkpred  # noqa: E402

#: forwards and gradients: max |port - JAX| over the output's max |JAX|
SCALE_TOL = 1e-5
#: GATNE's pipeline at the tests' size
SMALL = dict(num_walks=2, walk_length=5, window=3, neighbor_samples=4)


@pytest.fixture
def numpy_walks(monkeypatch):
    """Both packages' GATNE walks on the numpy walker (their defaults draw
    on the C++ engines)."""
    for mod in (j_gatne, t_gatne):
        monkeypatch.setattr(mod, "uniform_walks", functools.partial(
            mod.uniform_walks, use_native=False))


def _close(got, want, tol=SCALE_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max() / scale)


def _same_multiplex(got, want):
    assert got.n_nodes == want.n_nodes
    assert got.edge_types == want.edge_types
    for field in ("train_edges", "valid_true", "valid_false", "test_true",
                  "test_false"):
        a, b = getattr(got, field), getattr(want, field)
        assert sorted(a) == sorted(b), field
        for k in b:
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
    if want.features is None:
        assert got.features is None
    else:
        np.testing.assert_array_equal(got.features, want.features)
    if want.vocab is not None:
        assert got.vocab.idx_to_token == want.vocab.idx_to_token


@pytest.mark.parametrize("threshold", [None, 0.3])
def test_link_prediction_metrics_bit_equal(threshold):
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(60, 8)).astype(np.float32)
    emb[5] = emb[4]            # a tie in the scores, for the rank AUC
    t = (rng.integers(0, 60, 40), rng.integers(0, 60, 40))
    f = (rng.integers(0, 60, 40), rng.integers(0, 60, 40))
    t[0][0], t[1][0], f[0][0], f[1][0] = 4, 7, 5, 7
    got = t_linkpred.link_prediction_metrics(emb, t, f, threshold)
    want = j_linkpred.link_prediction_metrics(emb, t, f, threshold)
    assert got == want
    assert t_linkpred.auc_score(np.array([]), np.ones(3)) != \
        t_linkpred.auc_score(np.array([]), np.ones(3))    # nan, as JAX's


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, n_nodes=90,
                                                   n_types=3, avg_deg=4)])
def test_synthetic_multiplex_equal(kw):
    _same_multiplex(t_edgelist.synthetic_multiplex(**kw),
                    j_edgelist.synthetic_multiplex(**kw))


def test_read_multiplex_dir_equal(tmp_path):
    rng = np.random.default_rng(1)
    names = [f"n{i}" for i in range(30)]

    def lines(k, label):
        out = []
        for _ in range(k):
            a, b = rng.choice(names, 2)
            ty = rng.choice(["r", "s", "t"])
            out.append(f"{ty} {a} {b}" + (f" {rng.integers(0, 2)}"
                                          if label else ""))
        return out + ["", "x y"]

    for name, label in (("train.txt", False), ("valid.txt", True),
                        ("test.txt", True)):
        (tmp_path / name).write_text("\n".join(lines(80, label)) + "\n")
    _same_multiplex(t_edgelist.read_multiplex_dir(str(tmp_path)),
                    j_edgelist.read_multiplex_dir(str(tmp_path)))
    _same_multiplex(t_edgelist.load_multiplex(str(tmp_path)),
                    j_edgelist.load_multiplex(str(tmp_path)))
    _same_multiplex(t_edgelist.load_multiplex(str(tmp_path / "none"), 2),
                    j_edgelist.synthetic_multiplex(seed=2))


def test_cached_weighted_sampler_draw_for_draw():
    w = np.random.default_rng(0).random(17) ** 3
    got = t_alias.CachedWeightedSampler(w, np.random.default_rng(5), 7)
    want = j_alias.CachedWeightedSampler(w, np.random.default_rng(5), 7)
    assert [got.draw() for _ in range(20)] == [want.draw() for _ in range(20)]
    np.testing.assert_array_equal(got.draw_batch(50), want.draw_batch(50))
    assert [got.draw() for _ in range(9)] == [want.draw() for _ in range(9)]


@pytest.mark.parametrize("kw", [{}, dict(percent=0.5, max_t=6, min_t=2,
                                         p_stop=0.4)])
def test_bine_walks_draw_for_draw(kw):
    rng = np.random.default_rng(2)
    n = 25
    s, r = rng.integers(0, n, 90), rng.integers(0, n, 90)
    w = rng.random(90).astype(np.float32) + 0.1
    indptr, indices, ws = t_walks.csr_from_edges(s, r, n, w)
    cent = rng.random(n)
    got = t_walks.bine_walks(indptr, indices, ws, cent,
                             np.random.default_rng(9), **kw)
    want = j_walks.bine_walks(indptr, indices, ws, cent,
                              np.random.default_rng(9), **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _configs(loss="nsloss", **kw):
    return (t_gatne.GATNEConfig(loss=loss, **SMALL, **kw),
            j_gatne.GATNEConfig(loss=loss, **SMALL, **kw))


def test_neighbor_tables_equal():
    data = j_edgelist.synthetic_multiplex(seed=1)
    got = t_gatne.build_neighbor_tables(data, 6, np.random.default_rng(4))
    want = j_gatne.build_neighbor_tables(data, 6, np.random.default_rng(4))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_neighbor_tables_fill_isolated_nodes():
    """Isolated nodes (here the last two, whose rows lie at the end of the
    CSR) take themselves as every neighbour."""
    e = (np.array([0, 1, 2], np.int32), np.array([1, 2, 3], np.int32))
    data = t_edgelist.MultiplexData(6, ["a"], {"a": e}, {}, {}, {}, {})
    tab = t_gatne.build_neighbor_tables(data, 5, np.random.default_rng(0))
    np.testing.assert_array_equal(tab[4:, 0], [[4] * 5, [5] * 5])
    assert set(tab[0, 0]) == {1} and set(tab[1, 0]) <= {0, 2}


@pytest.mark.parametrize("padded", [False, True])
def test_pairs_equal(padded, numpy_walks):
    data = j_edgelist.synthetic_multiplex(seed=0)
    t_cfg, j_cfg = _configs()
    fn = "generate_padded_pairs" if padded else "generate_pairs"
    t_rng, j_rng = np.random.default_rng(7), np.random.default_rng(7)
    got = getattr(t_gatne, fn)(data, t_cfg, t_rng)
    want = getattr(j_gatne, fn)(data, j_cfg, j_rng)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert t_rng.random() == j_rng.random()


@pytest.mark.parametrize("padded", [False, True])
def test_default_pairs_on_the_engines_equal(padded):
    """``train_gatne``'s draws at the defaults (the neighbour tables, then
    the pairs from the same rng) on both C++ engines: 365,992 pairs."""
    data = j_edgelist.synthetic_multiplex(seed=0)
    fn = "generate_padded_pairs" if padded else "generate_pairs"
    out = []
    for mod in (t_gatne, j_gatne):
        cfg = mod.GATNEConfig()
        rng = np.random.default_rng(cfg.seed)
        mod.build_neighbor_tables(data, cfg.neighbor_samples, rng)
        out.append(getattr(mod, fn)(data, cfg, rng))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    if not padded:
        assert len(out[0][0]) == 365992


def test_walk_cache_written_by_jax_reads_unchanged(tmp_path, numpy_walks):
    """JAX's ``.npz`` walk cache is the port's: the port reads JAX's file
    (and draws nothing for the walks: its rng then differs from a fresh
    run's), and the pairs built from it are JAX's."""
    data = j_edgelist.synthetic_multiplex(seed=0)
    t_cfg, j_cfg = _configs(cache_dir=str(tmp_path))
    want = j_gatne.generate_pairs(data, j_cfg, np.random.default_rng(1))
    cached = j_gatne._generate_walks(data, j_cfg, None)
    assert len(list(tmp_path.iterdir())) == 1
    got_walks = t_gatne._generate_walks(data, t_cfg, None)
    assert sorted(got_walks) == sorted(cached)
    for k in cached:
        np.testing.assert_array_equal(got_walks[k], cached[k])
    # a cached run draws no walks: both continue from the same rng state
    t_rng = np.random.default_rng(11)
    j_rng = np.random.default_rng(11)
    for a, b in zip(t_gatne.generate_pairs(data, t_cfg, t_rng),
                    j_gatne.generate_pairs(data, j_cfg, j_rng)):
        np.testing.assert_array_equal(a, b)
    assert len(want[0]) > 0


def test_walk_cache_written_by_the_port_reads_in_jax(tmp_path, numpy_walks):
    data = j_edgelist.synthetic_multiplex(seed=0)
    t_cfg, j_cfg = _configs(cache_dir=str(tmp_path))
    written = t_gatne._generate_walks(data, t_cfg, np.random.default_rng(3))
    read = j_gatne._generate_walks(data, j_cfg, None)
    for k in written:
        np.testing.assert_array_equal(written[k], read[k])


def _gatne_case(inductive, aggregator, seed=0):
    rng = np.random.default_rng(seed)
    N, T, S, B, F = 50, 3, 4, 16, 7
    feats = rng.normal(size=(N, F)).astype(np.float32)
    batch = (rng.integers(0, N, B).astype(np.int32),
             rng.integers(0, T, B).astype(np.int32),
             rng.integers(0, N, (B, T, S)).astype(np.int32))
    dims = dict(embed_dim=8, edge_embed_dim=5, attn_dim=6,
                inductive=inductive,
                feature_dim=F if inductive else None, aggregator=aggregator)
    jm = j_nn.GATNE(vocab_size=N, num_edge_types=T, **dims)
    fj = jnp.asarray(feats) if inductive else None
    params = jm.init(jax.random.PRNGKey(seed),
                     *map(jnp.asarray, batch), fj)["params"]
    tm = t_nn.GATNE(N, T, **dims)
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    ft = torch.from_numpy(feats) if inductive else None
    return jm, params, fj, tm, ft, batch


@pytest.mark.parametrize("inductive", [False, True])
@pytest.mark.parametrize("aggregator", ["mean", "sum"])
def test_gatne_forward_and_gradients(inductive, aggregator):
    jm, params, fj, tm, ft, batch = _gatne_case(inductive, aggregator)
    weights = np.random.default_rng(1).normal(size=(16, 8)).astype(
        np.float32)

    def j_loss(p):
        out = jm.apply({"params": p}, *map(jnp.asarray, batch), fj)
        return jnp.sum(out * weights), out

    (_, want), grads = jax.value_and_grad(j_loss, has_aux=True)(params)
    got = tm(*(torch.from_numpy(a) for a in batch), ft)
    (got * torch.from_numpy(weights)).sum().backward()
    _close(got.detach(), want)
    want_g = from_flax(jax.tree.map(np.asarray, grads))
    assert set(want_g) == {k for k, _ in tm.named_parameters()}
    for k, p in tm.named_parameters():
        _close(p.grad, want_g[k])


def test_gatne_rejects_unknown_aggregator_and_missing_features():
    with pytest.raises(ValueError, match="aggregator"):
        t_nn.GATNE(10, 2, aggregator="max")
    with pytest.raises(ValueError, match="feature_dim"):
        t_nn.GATNE(10, 2, inductive=True)


@pytest.mark.parametrize("loss", ["nsloss", "masked_bce"])
@pytest.mark.parametrize("inductive", [False, True])
def test_gatne_params_load_the_flax_tree(loss, inductive):
    """JAX's ``{"model": ..., "ctx"|"decoder": ...}`` tree loads into
    ``GATNEParams`` through ``from_flax``, key for key; the port's own
    initial values follow flax's initialisers' scales."""
    data = t_edgelist.synthetic_multiplex(seed=0)
    cfg = t_gatne.GATNEConfig(loss=loss, inductive=inductive, embed_dim=16)
    jm = j_nn.GATNE(vocab_size=400, num_edge_types=2, embed_dim=16,
                    edge_embed_dim=16, attn_dim=32, inductive=inductive,
                    feature_dim=32 if inductive else None)
    nb = jnp.zeros((2, 2, 10), jnp.int32)
    model = jm.init(jax.random.PRNGKey(0), jnp.zeros((2,), jnp.int32),
                    jnp.zeros((2,), jnp.int32), nb,
                    jnp.asarray(data.features) if inductive else None)
    table = "decoder" if loss == "masked_bce" else "ctx"
    tree = {"model": model["params"], table: np.ones((400, 16), np.float32)}
    params = t_gatne.GATNEParams(data, cfg)
    params.load_state_dict(from_flax(jax.tree.map(np.asarray, tree)))
    assert params.table_name == table
    assert (params.features is not None) == inductive
    t_gatne._init_params(params, 0)
    std = {"ctx": 0.01, "model.w_att": 0.2, "model.trans": 0.2}
    for k, v in params.state_dict().items():
        if k in std:
            assert abs(float(v.std()) - std[k]) < 0.2 * std[k], k
    if table == "decoder":
        lim = np.sqrt(6.0 / 416)
        assert float(params.decoder.detach().abs().max()) <= lim


def test_type_pick_equals_the_index_gather():
    """``_by_type``'s one-hot product picks exactly ``table[types]``, and
    its backward sums each type's rows as the gather's does."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(3, 4, 5, generator=gen, requires_grad=True)
    types = torch.randint(0, 3, (40,), generator=gen)
    pick = torch.nn.functional.one_hot(types, 3).float()
    got = t_nn._by_type(pick, table)
    assert torch.equal(got, table[types])
    up = torch.randn(40, 4, 5, generator=gen)
    (grad,) = torch.autograd.grad((got * up).sum(), table)
    (want,) = torch.autograd.grad((table[types] * up).sum(), table)
    _close(grad, want, 1e-6)


def test_isolation_covers_the_linkpred_modules():
    """``test_torch_isolation`` walks every module of the port; this
    slice's are among them."""
    from tests.test_torch_isolation import _port_modules
    modules = set(_port_modules())
    pkg = "graphneuralnetwork_tpu_torch"
    for name in ("analysis", "analysis.centrality", "analysis.demo",
                 "models.bine", "models.gatne", "tools.gatne_step",
                 "train.linkpred", "utils", "utils.tb"):
        assert f"{pkg}.{name}" in modules
